"""Smoke-size cells for the CPU tests: each real cell's files with the
model narrowed to the port's smoke width, the lengths and the batch cut
down, and ``strict`` off (the sizes then differ from the registry's)."""

from __future__ import annotations

import copy

from portbench.lib import spec

# A cell whose files are kept under portbench/ but which BENCHMARK.json
# does not list (PERF.md, Open questions), tested here all the same.
KEPT = {"configs": [{"name": "deepseek-v2-lite-16b",
                     "file": "portbench/configs/deepseek-v2-lite-16b.json"}],
        "workloads": [{"name": "deepseek-v2-lite-16b.oversub",
                       "config": "deepseek-v2-lite-16b",
                       "traffic": "oversub", "chips": 1}]}

SMOKE_DENSE = {"hidden_size": 64, "num_attention_heads": 4,
               "num_key_value_heads": 2, "intermediate_size": 128,
               "vocab_size": 512, "num_hidden_layers": 2}
SMOKE_MLA = {"hidden_size": 64, "num_attention_heads": 4,
             "num_key_value_heads": 4, "intermediate_size": 96,
             "vocab_size": 512, "num_hidden_layers": 3,
             "moe_intermediate_size": 32, "n_routed_experts": 4,
             "num_experts_per_tok": 2, "n_shared_experts": 1,
             "kv_lora_rank": 32, "qk_nope_head_dim": 16,
             "qk_rope_head_dim": 8, "v_head_dim": 16, "capacity_factor": 1.0}


def smoke_cell(workload: str) -> spec.Cell:
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    for key, extra in KEPT.items():
        bench[key] += extra
    cell = copy.deepcopy(spec.load(workload, bench))
    conf = cell.conf
    conf.update(SMOKE_MLA if conf["reference"] == "mla_moe" else SMOKE_DENSE)
    t = cell.traffic
    t["block"] = 8
    for ten in t["tenants"]:
        if ten["prefix_tokens"]:
            ten["prefix_tokens"] = 32
    t["prompt"] = [dict(s, min=max(8, s["min"] // 32),
                        max=max(16, s["max"] // 32)) for s in t["prompt"]]
    t["output"] = dict(t["output"], min=4, max=12)
    # Two queued requests to a slot, so the smoke pool sees preemptions
    # and fault-ins.
    t["queued_per_slot"] = 2
    c = cell.cell
    c.update(strict=False, page_tokens=16, frame_pages=4, max_batch=4,
             max_seq=384)
    # The smoke width's own limit: its logits are smaller than the cells'
    # (64 wide, 512 tokens); sound smoke runs read gaps up to ~0.04.
    c["limits"] = {"gap_max": 0.1}
    c["oversubscription"] = 3.0
    c["pool_pages"] = 40      # the engine's sizing of 4 rows of 384 tokens, / 3
    return cell
