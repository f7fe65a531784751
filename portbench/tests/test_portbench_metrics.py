"""Hand-worked cases of the roofline and MFU counts, the trace reduction,
the window's rates and the metric readers."""

import pytest

from portbench.lib import harness, roofline, spec
from portbench.lib.trace import Slice
from portbench.refs import dense, mla_moe


def test_qwen_counts():
    conf = spec.load_json(spec.BENCH / "configs" / "qwen2.5-3b.json")
    c = dense.counts(conf)
    attn = 2048 * 2048 + 2 * 2048 * 256 + 2048 * 2048
    assert c["layer_params"] == 36 * (attn + 3 * 2048 * 11008)
    assert c["layer_params"] == 2_774_532_096
    assert c["head_params"] == 2048 * 151936
    assert c["kv_bytes_per_token"] == 36_864


def test_deepseek_counts():
    conf = spec.load_json(spec.BENCH / "configs" /
                          "deepseek-v2-lite-16b.json")
    c = mla_moe.counts(conf)
    assert c["kv_bytes_per_token"] == 31_104          # 27 x 576 x 2 B
    attn = (2048 * 16 * 192 + 2048 * 512 + 2048 * 64 + 512 * 16 * 128 * 2
            + 16 * 128 * 2048)
    moe = 3 * 2048 * 1408 * 8 + 2048 * 64
    assert c["layer_params"] == 27 * attn + 3 * 2048 * 10944 + 26 * moe


def test_token_flops_hand_worked():
    c = {"layer_params": 10, "head_params": 3, "layers": 2, "heads": 4,
         "qk_dim": 8, "v_dim": 8}
    # 3 new tokens after 5 cached: pairs 3*5 + 6 = 21.
    assert roofline.token_flops(c, 3, 5, 1) == \
        2 * 10 * 3 + 2 * 2 * 4 * 21 * 16 + 2 * 3


def test_flash_work_and_bound():
    b, f = roofline.flash_fwd_work(4, 2, H=2, n_kv=1, dq=8, dv=8)
    pairs = 4 * 2 + 10
    assert f == 2 * 2 * pairs * 16
    assert b == 2 * 4 * 2 * 16 + 2 * 6 * 1 * 16 + 4 * 2 * 4
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 989e12) == pytest.approx(1.0)


def test_trace_busy_and_gaps():
    s = Slice()
    s.device = [(0.0, 1.0, "k1"), (0.5, 2.5, "k2"), (3.0, 3.5, "k1")]
    s.host = [(2.0, 3.0, "aten::mm"), (2.6, 2.7, "cudaLaunchKernel")]
    s.window_s = 4.0
    assert s.busy_s() == pytest.approx(3.0)
    assert s.kernel_s(("k1",)) == pytest.approx(1.5)
    assert s.top_ops()[0] == ["k2", 2.0]
    # The gap's midpoint (2.75) lies in aten::mm alone.
    assert s.idle_gaps() == [["aten::mm", pytest.approx(0.5)]]


READINGS = {
    "window_s": 10.0, "engine_steps": 50, "out_tokens": 2000,
    "out_tok_s": 200.0,
    "max_batch": 100, "peak_flops": 1e15, "model_flops": 1e15,
    "stats": {"decode_tokens": 3000, "decode_steps": 50, "h2d_bytes": 4e9,
              "h2d_s": 2.0, "faults": 500, "swaps_out": 10},
    "trace": {"busy_s": 1.0, "window_s": 4.0, "paged_kernel_s": 0.5,
              "paged_least_s": 0.05},
}
EXPECTED = {
    "engine.out_tok_s.batch": 200.0,
    "engine.step_ms.batch": 200.0, "engine.batch_fill.batch": 60.0,
    "paging.h2d_gbps.batch": 2.0, "paging.faults_per_ktok.batch": 250.0,
    "manager.preempt_per_ktok.batch": 5.0, "mfu.batch": 10.0,
    "paged_attention_roofline.batch": 10.0, "device.idle_share.batch": 75.0,
}


def test_every_per_layer_metric_has_a_reader():
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    assert {m["name"] for m in bench["per_layer"]} == set(EXPECTED)
    # One reader a quantity, shared by its cells' metrics.
    files = {p.stem for p in (spec.BENCH / "metrics").glob("*.py")}
    assert files == {n.rsplit(".", 1)[0] for n in EXPECTED}
    assert all(harness.reader_path(n).exists() for n in EXPECTED)


def test_reader_of_a_new_cells_metric():
    """A metric of a later cell finds its quantity's reader by name."""
    assert harness.reader_path("engine.step_ms.chat") == \
        spec.BENCH / "metrics" / "engine.step_ms.py"


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_hand_worked(name):
    assert harness.reader(name)(READINGS) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing_returns_none(name):
    empty = {"window_s": 1.0, "engine_steps": 0, "out_tokens": 0,
             "out_tok_s": 0.0,
             "max_batch": 1, "peak_flops": 1.0, "model_flops": None,
             "stats": {k: 0 for k in READINGS["stats"]}}
    assert harness.reader(name)(empty) is None


def test_memory_peak_in_gib():
    """The end-to-end peak is the allocator's bytes in GiB, and absent
    where no card was read."""
    cell = spec.load("qwen2.5-3b.oversub")
    r = {"memory_peak_bytes": 13579117056, "setup_s": 30.0}
    m = harness.metrics_of(cell, r, trace=False)
    assert m["memory_peak_gib"] == {"value": pytest.approx(12.6465382576),
                                    "unit": "GiB"}
    assert "memory_peak_gib" not in harness.metrics_of(
        cell, {**r, "memory_peak_bytes": 0}, trace=False)
