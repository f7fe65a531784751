"""Serving cells: the window drives ``ServingEngine.submit`` / ``step``.

Set-up builds the kernels (cached in the checkout after the first run),
the port's ``LM`` with the seed's weights, and the engine with the cell's
settings, then warms the paths the window uses: a shortest and a longest
prompt of the mix, a decode batch, a preemption and its fault-in, and
(with the prefix cache) a cache-hit admission.  Last, it fills the pool
from the backlog: engine steps until one admits no request, so the window
starts from the saturated engine the cell measures.

The mix is a backlog (``portbench/lib/traffic.py``): before every step
the queue is topped up to ``queued_per_slot`` x ``max_batch`` requests, so
the engine always has more work than the pool holds.  The window is every
step that starts before it closes; ``out_tok_s`` is every token those
steps produced (first tokens included) over their wall time, read per
layer as ``engine.out_tok_s``.

With ``--trace 1`` a slice of the window (``TRACE_FROM`` of it in, for
``TRACE_S`` seconds) runs under ``torch.profiler``.  After the window the
program is freed and the served tokens of a sample of the requests are
held against the plain reference (``portbench/lib/correct.py``).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.lib import correct, port, roofline, traffic as tr
from portbench.lib.trace import Slice

STATS = ("prefill_tokens", "decode_tokens", "decode_steps", "swaps_out",
         "swaps_in", "faults", "h2d_bytes", "h2d_s", "d2h_bytes", "d2h_s",
         "prefill_s", "decode_s", "prefix_reused_tokens", "prefix_hits",
         "compaction_copies")
PAGED_KERNELS = ("paged_partial_kernel", "paged_mla_partial_kernel",
                 "paged_combine_kernel")
WARM_RID = 10 ** 9
TRACE_FROM = 0.4        # the traced slice starts this share into the window
TRACE_S = 6.0           # and lasts this long
SAMPLE_TOKENS = 384     # served tokens the comparison wants at least
SAMPLE_REQUESTS = 12    # requests it compares at most
FILL_STEPS = 16         # set-up's fill stops earlier once a step admits none


def stats_of(engine) -> Dict[str, float]:
    return {k: getattr(engine.stats, k) for k in STATS}


class Book:
    """What the harness sees of each request and step, from outside the
    engine: tokens as they appear and the requests that finish."""

    def __init__(self, page_tokens: int, prefix_on: bool):
        self.ptok = page_tokens
        self.prefix_on = prefix_on
        self.live: Dict[int, list] = {}     # rid -> [req, tokens seen]
        self.specs: Dict[int, tr.Spec] = {}
        self.reqs: Dict[int, object] = {}
        self.steps: List[dict] = []
        self.parked_tenants: set = set()
        self.resumed_made: Dict[int, int] = {}   # tokens after a preemption

    def add(self, req, spec) -> None:
        self.live[req.rid] = [req, 0]
        self.specs[req.rid] = spec
        self.reqs[req.rid] = req

    def record(self, now: float, traced: bool) -> dict:
        """Tokens the last step produced: (rid, index in out) pairs."""
        made, finished = [], []
        for rid, item in self.live.items():
            req, seen = item
            n = len(req.out)
            if n > seen:
                made.extend((rid, j) for j in range(seen, n))
                if req.preemptions:
                    self.resumed_made[rid] = \
                        self.resumed_made.get(rid, 0) + n - seen
                item[1] = n
            if req.done:
                finished.append(rid)
        step = {"t": now, "made": made, "traced": traced,
                "parked": set(self.parked_tenants), "finished": finished}
        for rid in finished:
            del self.live[rid]
            self.parked_tenants.add(self.specs[rid].tenant)
        self.steps.append(step)
        return step

    def reused(self, rid: int, parked: set) -> int:
        """Prompt tokens the prefix cache serves at this admission: the
        tenant's page-aligned shared prefix, once a request of the tenant
        has finished (and parked it), capped a page short of the prompt."""
        s = self.specs[rid]
        if not self.prefix_on or not s.prefix_tokens \
                or s.tenant not in parked:
            return 0
        T = len(s.prompt)
        return min(s.prefix_tokens // self.ptok, (T - 1) // self.ptok) \
            * self.ptok


def warm_up(engine, cell: dict, traffic: dict, vocab: int, seed: int) -> None:
    """Runs the paths the window will use once, then leaves the engine
    empty: prefill at the mix's shortest and longest prompt, decode, a
    preemption with its fault-in and, with the prefix cache, a hit."""
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng([seed, 1])
    n = traffic["block"]
    pre = max(t["prefix_tokens"] for t in traffic["tenants"])
    lens = sum(tr.quantiles(s, n) for s in traffic["prompt"]) + pre
    rid = WARM_RID

    def req(T, new=4):
        nonlocal rid
        rid += 1
        return Request(rid=rid, tenant=0, max_new=new,
                       prompt=rng.integers(0, vocab, T).astype(np.int32))

    for T in (int(lens.min()), int(lens.max())):
        engine.submit(req(T))
    engine.run_until_drained()
    a, b = req(int(lens.min()), 8), req(int(lens.min()), 8)
    engine.submit(a)
    engine.submit(b)
    engine.step()
    engine.preempt(a.rid)
    engine.run_until_drained()
    if engine.prefix is not None and pre:
        ptok = engine.geo.page_tokens
        shared = rng.integers(0, vocab, pre + ptok).astype(np.int32)
        for _ in range(2):
            r = req(int(lens.min()))
            r.prompt = np.concatenate([shared, r.prompt[:len(r.prompt) - pre]])
            engine.submit(r)
            engine.run_until_drained()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()


def build(cell, seed: int, device: str):
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.serving.engine import ServingEngine
    c = cell.cell
    cfg = port.model_config(cell.conf, cell.ref, strict=c.get("strict", True))
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.kernels.build import build_all, library
        for name in build_all():
            library(name)
    lm = port.build_lm(cfg, cell.conf, cell.ref, seed, dev)
    engine = ServingEngine(
        cfg, geometry=PoolGeometry(page_tokens=c["page_tokens"],
                                   frame_pages=c["frame_pages"]),
        max_batch=c["max_batch"], max_seq=c["max_seq"],
        manager_kind=c["manager"], params=lm,
        oversubscription=c["oversubscription"], fault_mode=c["fault_mode"],
        prefix_cache=c["prefix_cache"], device=dev)
    return cfg, engine


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", control: bool = False) -> dict:
    """One run of a serving cell; ``control`` also puts the precision
    control through the comparison (``portbench/tools/readings.py``)."""
    from repro_torch.serving.engine import Request
    c, traffic = cell.cell, cell.traffic
    cfg, engine = build(cell, seed, device)
    pool = engine.cache.pages_per_shard * engine.cache.S
    if pool != c["pool_pages"]:
        raise SystemExit(f"{cell.name}: the engine's pool holds {pool} "
                         f"pages, the cell states {c['pool_pages']}")
    warm_up(engine, c, traffic, cfg.vocab_size, seed)
    cuda = engine.device.type == "cuda"
    gen = tr.stream(traffic, seed, cfg.vocab_size)
    book = Book(c["page_tokens"], engine.prefix is not None)
    target = round(traffic["queued_per_slot"] * c["max_batch"])
    prof = Slice() if trace and cuda else None
    tracing = False

    def top_up():
        while len(engine.queue) < target:
            spec = next(gen)
            r = Request(rid=spec.index, tenant=spec.tenant,
                        prompt=spec.prompt, max_new=spec.max_new,
                        priority=spec.priority)
            book.add(r, spec)
            engine.submit(r)

    # A saturated engine is the cell's starting state: set-up fills the
    # pool from the backlog, step by step, until a step admits no request.
    for _ in range(FILL_STEPS):
        top_up()
        engine.step()
        step = book.record(time.perf_counter(), False)
        if not any(j == 0 for _rid, j in step["made"]):
            break
    book.steps.clear()
    s0 = stats_of(engine)
    setup_s = time.perf_counter() - t0
    start = time.perf_counter()
    end = start + seconds
    while True:
        now = time.perf_counter()
        if now >= end:
            # The window is every step that started before it closed.
            window_end = book.steps[-1]["t"] if book.steps else now
            break
        top_up()
        if prof is not None:
            if not tracing and prof.window_s == 0 \
                    and now - start >= seconds * TRACE_FROM:
                prof.start()
                tracing, trace_t = True, time.perf_counter()
            elif tracing and now - trace_t >= TRACE_S:
                prof.stop()
                tracing = False
        engine.step()
        book.record(time.perf_counter(), tracing)
    n_steps, s1 = len(book.steps), stats_of(engine)
    if tracing:
        prof.stop()
    window_s = window_end - start
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    counts = cell.ref.counts(cell.conf)
    out = summarize(book, c, counts, s0, s1, n_steps, window_s)
    out["setup_s"] = setup_s
    out["memory_peak_bytes"] = peak
    if prof is not None and prof.window_s > 0:
        prof.reduce()
        out["trace"] = trace_readings(prof, book, counts)
    # Every request's tokens served by the close, finished or in flight.
    served = [(rid, book.specs[rid].prompt, list(book.reqs[rid].out),
               book.resumed_made.get(rid, 0))
              for rid in sorted(book.reqs) if book.reqs[rid].out]
    engine.pools = None
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    picked = correct.sample(served, seed, SAMPLE_TOKENS, SAMPLE_REQUESTS)
    out["check"] = correct.check(cell.conf, cell.ref, seed, picked,
                                 c["page_tokens"], device, c["limits"],
                                 control=control)
    return out


def summarize(book: Book, c: dict, counts: dict, s0: dict, s1: dict,
              n_steps: int, window_s: float) -> dict:
    """End-to-end and per-layer readings of the window's steps."""
    steps = book.steps[:n_steps]
    d = {k: s1[k] - s0[k] for k in s0}
    tokens = sum(len(s["made"]) for s in steps)
    flops, reused = 0.0, 0
    for s in steps:
        for rid, j in s["made"]:
            T = len(book.specs[rid].prompt)
            if j == 0:
                P = book.reused(rid, s["parked"])
                reused += P
                flops += roofline.token_flops(counts, T - P, P, 1)
            else:
                flops += roofline.token_flops(counts, 1, T + j - 1, 1)
    served = len({rid for s in steps for rid, _j in s["made"]})
    return {"window_s": window_s, "engine_steps": n_steps,
            "out_tokens": tokens, "stats": d, "max_batch": c["max_batch"],
            "admitted": sum(1 for s in steps for _rid, j in s["made"]
                            if j == 0),
            "finished": sum(len(s["finished"]) for s in steps),
            "out_tok_s": tokens / window_s,
            "attempted": served, "failed": 0,
            # The prefix reuse the FLOPs assume must be the engine's count.
            "model_flops": flops if reused == d["prefix_reused_tokens"]
            else None,
            "peak_flops": roofline.BF16_FLOPS}


def trace_readings(prof: Slice, book: Book, counts: dict) -> dict:
    """What the slice's kernels did against what their shapes need."""
    kv_bytes = 0.0
    for s in book.steps:
        if not s["traced"]:
            continue
        for rid, j in s["made"]:
            if j > 0:
                T = len(book.specs[rid].prompt)
                kv_bytes += (T + j) * counts["kv_bytes_per_token"]
    return {"busy_s": prof.busy_s(), "window_s": prof.window_s,
            "paged_kernel_s": prof.kernel_s(PAGED_KERNELS),
            "paged_least_s": kv_bytes / roofline.HBM_BYTES_PER_S,
            "breakdown": {"device_ops": prof.top_ops(),
                          "idle_gaps": prof.idle_gaps()}}
