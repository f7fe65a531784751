#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each synchronised; any failure exits non-zero):

1. environment: the card's name and power limit, torch version; TF32 off;
2. build: every ``csrc/*.cu`` with nvcc for sm_90a, one nvcc per source;
3. kernel checks at the serving path's shapes: each CUDA kernel against its
   plain PyTorch version on the card (paged attention, both granularities,
   with holes and partial pages; fused gather-attend with about half the
   pages staged, and bit for bit against the page kernel where it reads
   the same bytes; gather / scatter / compact exactly), and their times
   (CUDA-graph replay for kernels and library calls, CUDA events for the
   plain versions) beside the bytes bound at 3.35 TB/s;
4. main path: qwen2.5-3b at its published width, bf16, random weights from
   a seed, served by ``ServingEngine`` (mosaic, 2x oversubscribed) over a
   seeded stream with staggered priority arrivals, three times on the same
   weights: sync, async and fused fault-in (async and fused leave
   ``decode_window_us`` unset, so their modeled clock follows the measured
   decode time).  During each run one dual-granularity attention call
   reads the engine's pool through ``pack_dual`` frame tables, and a
   partial deallocation of one request's pages makes CAC plan copies that
   the engine executes.  Launch counters are reset before and read after
   each run: every kernel of that mode's path must have launched, the
   counts must account for every decode layer, landing and fused step, and
   the three modes must emit identical tokens;
5. agreement on a small input: a narrow model served on the card (kernels)
   and on the CPU (plain versions), in fused mode, emits the same greedy
   tokens;
6. application transparency: the stream without oversubscription under
   mosaic and gpu-mmu — same batches, identical tokens;
7. paging round trip: a held preemption's host payloads come back into the
   pool bit for bit.

Ends with a JSON line of per-kernel numbers (launches summed over the
three main-path runs) and, last, the ok line.  No phase is cut in depth.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "qwen2.5-3b"
MAX_BATCH, MAX_SEQ, OVERSUB = 4, 2048, 2.0
ARRIVE_STEP = 10        # the two priority-1 requests arrive here
PROBE_STEP = 3          # dual-granularity attention over the engine's pool
TRIM_STEP = 6           # partial deallocation of request 0's pages
TRIM_VPNS = range(2, 14)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
ATTN_TOL = dict(rtol=2e-2, atol=2e-2)   # bf16 inputs (tests/test_kernels.py)
ML_TOL = dict(rtol=1e-5, atol=1e-5)     # f32 accumulators, other sum order

MODES = ("sync", "async", "fused")
REPLACES = {
    "paged_attention.page": "src/repro/kernels/paged_attention.py:106",
    "paged_attention.frame": "src/repro/kernels/paged_attention.py:106",
    "paged_attention.fused": "src/repro/kernels/paged_attention.py:293",
    "page_gather": "src/repro/kernels/page_compact.py:92",
    "page_scatter": "src/repro/kernels/page_compact.py:128",
    "page_compact": "src/repro/kernels/page_compact.py:40",
}
SOURCES = {
    "paged_attention.page": "src/repro_torch/csrc/paged_attention.cu",
    "paged_attention.frame": "src/repro_torch/csrc/paged_attention.cu",
    "paged_attention.fused": "src/repro_torch/csrc/paged_attention.cu",
    "page_gather": "src/repro_torch/csrc/page_copy.cu",
    "page_scatter": "src/repro_torch/csrc/page_copy.cu",
    "page_compact": "src/repro_torch/csrc/page_copy.cu",
}


class SmokeFailure(RuntimeError):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------- workload


def make_stream(vocab: int, seed: int = 0):
    """[(arrival_step, Request)]: 8 requests over 3 tenants.

    Request 0 (priority 2) has a 1100-token prompt, so it spans one full,
    coalesced 16-page frame plus a partial one; requests 1-5 (priority 0)
    have 128-768-token prompts; requests 6-7 (priority 1) arrive at
    ``ARRIVE_STEP`` and displace lower-priority work.  Lengths are drawn
    before tokens, so the schedule (which depends on lengths only) is the
    same at every model width.
    """
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    lens = ([1100] + [int(rng.integers(128, 769)) for _ in range(5)]
            + [int(rng.integers(384, 769)) for _ in range(2)])
    news = [64] + [int(rng.integers(32, 65)) for _ in range(7)]
    prio = [2, 0, 0, 0, 0, 0, 1, 1]
    arrive = [0] * 6 + [ARRIVE_STEP] * 2
    return [(arrive[i], Request(
        rid=i, tenant=i % 3, priority=prio[i], max_new=news[i],
        prompt=rng.integers(0, vocab, lens[i]).astype(np.int32)))
        for i in range(8)]


def drive(eng, stream, hook=None, max_steps: int = 4000):
    """Submit each request at its arrival step; step until drained.

    ``hook(step, eng)`` runs before each step.  Returns the decode batch
    (the rids that gained a token) of every step.
    """
    pending = sorted(stream, key=lambda a: a[0])
    reqs = [r for _, r in stream]
    batches = []
    step = 0
    while pending or eng.queue or eng.active or eng.preempted:
        require(step < max_steps, f"engine not drained in {max_steps} steps")
        while pending and pending[0][0] <= step:
            eng.submit(pending.pop(0)[1])
        if hook is not None:
            hook(step, eng)
        before = [len(r.out) for r in reqs]
        eng.step()
        batches.append(tuple(r.rid for r, n in zip(reqs, before)
                             if len(r.out) > n))
        step += 1
    return batches


class MainPathEvents:
    """Step hook of the main path (device-agnostic, also run on the CPU).

    At ``PROBE_STEP``: dual-granularity attention (frames + pages, the
    port's kernels on CUDA tensors) over layer 0 of the engine's pool,
    through ``pack_dual`` tables of the active requests, held against the
    plain page-only version over the same sequences.  At ``TRIM_STEP``:
    partial deallocation of request 0's pages ``TRIM_VPNS``
    (``MosaicManager.free_pages``, the paper's partial-deallocation path):
    the frame loses its coalesced bit and CAC plans copies out of the
    owner's fragmented frames, which the engine executes with page_compact
    in its next step.  One step later every surviving page of request 0
    must hold its bytes at its (possibly new) physical page.
    """

    def __init__(self, cfg):
        self.cfg = cfg
        self.probe_frames = 0
        self.probe_err = float("nan")
        self.cac_checked = False
        self._snap = {}
        self._tokens = 0

    def __call__(self, step, eng):
        if step == PROBE_STEP:
            self._probe(eng)
        elif step == TRIM_STEP:
            self._trim(eng)
        elif step == TRIM_STEP + 1:
            self._check_cac(eng)

    def _probe(self, eng):
        import torch
        from repro_torch.kernels import ops, ref
        cfg, fp = self.cfg, eng.geo.frame_pages
        seqs = [r.rid for r in eng.active]
        ft, fn, pt, pn = eng.cache.pack_dual(
            seqs, 0, max_frames=eng.mpps // fp, max_pages=eng.mpps,
            device=eng.device)
        ctx = eng.cache.pack_ctx(seqs, eng.mpps, device=eng.device)
        gen = torch.Generator(device=eng.device).manual_seed(2)
        q = torch.randn((len(seqs), cfg.n_heads, cfg.resolved_head_dim),
                        generator=gen, device=eng.device).to(torch.bfloat16)
        scale = cfg.resolved_head_dim ** -0.5
        k, v = eng.pools
        dual = ops.paged_attention_dual(q, k[0], v[0], ft, fn, pt, pn,
                                        frame_pages=fp, scale=scale)
        plain = ref.paged_attention_full_ref(
            q, k[0], v[0], ctx.tables.reshape(len(seqs), -1),
            ctx.ntok.reshape(len(seqs), -1), scale=scale)
        torch.testing.assert_close(dual, plain, **ATTN_TOL)
        self.probe_frames = int((ft >= 0).sum())
        self.probe_err = float((dual - plain).abs().max())

    def _trim(self, eng):
        mgr = eng.cache.mgrs[0]
        table = mgr.tables.get(0)
        require(table is not None and len(table.ppn) > eng.geo.frame_pages
                and table.coalesced[0],
                "request 0 must hold a coalesced frame and a partial one")
        k, v = eng.pools
        self._snap = {vpn: (k[:, ppn].clone(), v[:, ppn].clone())
                      for vpn, ppn in enumerate(table.ppn)
                      if vpn not in TRIM_VPNS}
        self._tokens = eng.cache.seq_tokens[0]
        mgr.free_pages(0, list(TRIM_VPNS))

    def _check_cac(self, eng):
        import torch
        table = eng.cache.mgrs[0].tables.get(0)
        require(table is not None, "request 0 left the pool before the check")
        ptok = eng.geo.page_tokens
        k, v = eng.pools
        for vpn, (kp, vp) in self._snap.items():
            n = min(ptok, self._tokens - vpn * ptok)
            ppn = table.ppn[vpn]
            require(torch.equal(k[:, ppn, :n], kp[:, :n])
                    and torch.equal(v[:, ppn, :n], vp[:, :n]),
                    f"CAC moved page {vpn} of request 0 incoherently")
        self.cac_checked = True


# ---------------------------------------------------------------- timing


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device ms per call: ``reps`` calls captured in one CUDA graph,
    replayed; launch overhead is outside the measurement."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (reps * replays)


def eager_ms(fn, iters: int = 20) -> float:
    """Wall ms per call on the card's clock (CUDA events), after warm-up;
    includes the host work between launches."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def cycling(fn, arg_sets):
    """A callable that applies ``fn`` to each argument tuple in turn."""
    it = itertools.cycle(arg_sets)
    return lambda: fn(*next(it))


def bound_ms(nbytes: float, flops: float = 0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phases


def phase_env():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    print(f"[build] {build.BUILD_INFO['built']} sources in "
          f"{time.perf_counter() - t0:.1f}s -> {build.BUILD_INFO['directory']}")
    for name, log in build.BUILD_INFO["ptxas"].items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def _tables(rng, B, n_blocks, n_entries, tokens_per_block, *, holes=True):
    """Random block tables with holes and partial last blocks."""
    tables = np.full((B, n_blocks), -1, np.int32)
    ntok = np.zeros((B, n_blocks), np.int32)
    for b in range(B):
        used = int(rng.integers(1, n_blocks + 1))
        ids = rng.permutation(n_entries)[:used]
        slots = np.sort(rng.permutation(n_blocks)[:used]) if holes \
            else np.arange(used)
        for j, (slot, e) in enumerate(zip(slots, ids)):
            tables[b, slot] = e
            ntok[b, slot] = tokens_per_block if j < used - 1 else int(
                rng.integers(1, tokens_per_block + 1))
    return tables, ntok


def phase_kernels(cfg, results):
    """Each kernel against its plain version at the serving shapes."""
    import torch
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    geo = PoolGeometry()
    ptok, fp = geo.page_tokens, geo.frame_pages
    n_kv, dh, H = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_heads
    L = cfg.n_layers
    NP = 80                       # the main path's pool: 2x oversubscribed
    mpps = MAX_SEQ // ptok        # page-table width at max_seq
    rng = np.random.default_rng(1)
    gen = torch.Generator(device=dev).manual_seed(1)
    scale = dh ** -0.5

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    pool_k, pool_v = randn(NP, ptok, n_kv, dh), randn(NP, ptok, n_kv, dh)
    kall, vall = randn(L, NP, ptok, n_kv, dh), randn(L, NP, ptok, n_kv, dh)

    def t(a):
        return torch.from_numpy(a).to(dev)

    # Paged attention, both granularities, B in {1, 4, 8}.
    for gran, n_blocks, n_entries, tpb in (
            ("page", mpps, NP, ptok), ("frame", mpps // fp, NP // fp,
                                       fp * ptok)):
        name = f"paged_attention.{gran}"
        errs = []
        for B in (1, 4, 8):
            q = randn(B, H, dh)
            tb, nt = _tables(rng, B, n_blocks, n_entries, tpb)
            if B == 8:
                tb[-1], nt[-1] = -1, 0          # a row made only of holes
            tb, nt = t(tb), t(nt)
            o, m, l = ops.paged_attention_kernel(
                q, pool_k, pool_v, tb, nt, granularity=gran,
                frame_pages=fp, scale=scale)
            o_r, m_r, l_r = ref.paged_attention_ref(
                q, pool_k, pool_v, tb, nt, scale=scale,
                frame_pages=fp if gran == "frame" else 1)
            torch.cuda.synchronize()
            on = o / torch.clamp(l[..., None], min=1e-30)
            on_r = o_r / torch.clamp(l_r[..., None], min=1e-30)
            torch.testing.assert_close(on, on_r, **ATTN_TOL)
            torch.testing.assert_close(m, m_r, **ML_TOL)
            torch.testing.assert_close(l, l_r, **ML_TOL)
            require(bool(torch.isfinite(on).all()), f"{name}: non-finite")
            if B == 8:
                require(bool((m[-1] == -1e30).all() and (l[-1] == 0).all()
                             and (o[-1] == 0).all()),
                        f"{name}: all-hole row must give m=-1e30, l=0, o=0")
            errs.append(float((on - on_r).abs().max()))
            if B == MAX_BATCH:
                # Timed over all L layers' pools in turn, as decode reads
                # them: 2 x 94 MB, beyond the 50 MB L2.
                tokens = int(nt.sum())
                nbytes = (2 * tokens * n_kv * dh * 2 + q.numel() * 2
                          + 2 * tb.numel() * 4 + B * H * (dh + 2) * 4)
                b_ms, b_by = bound_ms(nbytes, 4 * H * dh * tokens)
                layers = [(q, kall[i], vall[i], tb, nt) for i in range(L)]
                kw = dict(scale=scale)
                timing = dict(
                    ms=graph_ms(cycling(functools.partial(
                        ops.paged_attention_kernel, granularity=gran,
                        frame_pages=fp, **kw), layers)),
                    plain_ms=eager_ms(cycling(functools.partial(
                        ref.paged_attention_ref,
                        frame_pages=fp if gran == "frame" else 1, **kw),
                        layers)),
                    bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    shape=f"B={B} H={H} n_kv={n_kv} dh={dh} "
                          f"blocks={n_blocks} tokens={tokens}")
        results[name] = dict(max_abs_err=max(errs), **timing)
        print(f"[kernel] {name}: max_abs_err {max(errs):.3g} | "
              f"kernel_ms {timing['ms']:.4f} plain_ms "
              f"{timing['plain_ms']:.4f} bound_ms {timing['bound_ms']:.5f} "
              f"library_ms none (no single PyTorch call computes paged "
              f"attention) | {timing['shape']}")

    # Frames combined with pages == page-only over the same sequences.
    B = MAX_BATCH
    q = randn(B, H, dh)
    ft, fn = _tables(rng, B, 2, NP // fp, fp * ptok, holes=False)
    fn[:] = fp * ptok                              # coalesced frames are full
    pages = np.full((B, mpps), -1, np.int32)
    pn = np.zeros((B, mpps), np.int32)
    perm = rng.permutation(NP)
    for b in range(B):
        n = int(rng.integers(1, 9))
        pages[b, :n] = perm[b * 8:b * 8 + n]
        pn[b, :n] = ptok
        pn[b, n - 1] = int(rng.integers(1, ptok + 1))
    dual = ops.paged_attention_dual(q, pool_k, pool_v, t(ft), t(fn),
                                    t(pages), t(pn), frame_pages=fp,
                                    scale=scale)
    ft_pages, fn_pages = ref.frames_to_pages(t(ft), t(fn), frame_pages=fp,
                                             page_tokens=ptok)
    o, m, l = ops.paged_attention_kernel(
        q, pool_k, pool_v, torch.cat([ft_pages, t(pages)], 1).contiguous(),
        torch.cat([fn_pages, t(pn)], 1).contiguous(), granularity="page",
        scale=scale)
    torch.testing.assert_close(dual, o / l[..., None], **ATTN_TOL)
    print("[kernel] frames+pages == page-only on the same sequences: ok")

    # Fused gather-attend at the page kernel's shapes, about half of the
    # valid pages staged.  The stage holds each staged page's bytes; the
    # pool copies are overwritten, so reading the wrong source shows.
    name = "paged_attention.fused"
    q = randn(B, H, dh)
    tb, nt = _tables(rng, B, mpps, NP, ptok)
    late = (tb >= 0) & (rng.random(tb.shape) < 0.5)
    n_staged = int(late.sum())
    require(0 < n_staged < int((tb >= 0).sum()), "fused case stages no page")
    slots = np.full(tb.shape, -1, np.int32)
    slots[late] = np.arange(n_staged, dtype=np.int32)
    ids = t(tb[late]).long()
    tb, nt, sl = t(tb), t(nt), t(slots)
    st_k, st_v = kall[:, ids].contiguous(), vall[:, ids].contiguous()
    pk0, pv0 = kall[0].clone(), vall[0].clone()
    pk0[ids], pv0[ids] = randn(n_staged, ptok, n_kv, dh), \
        randn(n_staged, ptok, n_kv, dh)
    args = (q, pk0, pv0, st_k[0], st_v[0], tb, sl, nt)
    o, m, l = ops.fused_paged_attention_kernel(*args, scale=scale)
    o_r, m_r, l_r = ref.fused_paged_attention_ref(*args, scale=scale)
    torch.cuda.synchronize()
    on, on_r = o / l[..., None], o_r / l_r[..., None]
    torch.testing.assert_close(on, on_r, **ATTN_TOL)
    torch.testing.assert_close(m, m_r, **ML_TOL)
    torch.testing.assert_close(l, l_r, **ML_TOL)
    require(bool(torch.isfinite(on).all()), f"{name}: non-finite")
    # Same bytes as the page kernel reads: bit for bit, staged or not.
    base = ops.paged_attention_kernel(q, kall[0], vall[0], tb, nt,
                                      granularity="page", scale=scale)
    for sl_case in (sl, torch.full_like(sl, -1)):
        got = ops.fused_paged_attention_kernel(
            q, kall[0], vall[0], st_k[0], st_v[0], tb, sl_case, nt,
            scale=scale)
        require(all(torch.equal(a, b) for a, b in zip(got, base)),
                f"{name}: not bitwise the page kernel on the same bytes")
    tokens = int(nt.sum())
    nbytes = (2 * tokens * n_kv * dh * 2 + q.numel() * 2
              + 3 * tb.numel() * 4 + B * H * (dh + 2) * 4)
    b_ms, b_by = bound_ms(nbytes, 4 * H * dh * tokens)
    # Timed over all L layers' pools and stages in turn, as decode reads
    # them: 2 x 94 MB of pools plus the stages, beyond the 50 MB L2.
    layers = [(q, kall[i], vall[i], st_k[i], st_v[i], tb, sl, nt)
              for i in range(L)]
    results[name] = dict(
        max_abs_err=float((on - on_r).abs().max()),
        ms=graph_ms(cycling(functools.partial(
            ops.fused_paged_attention_kernel, scale=scale), layers)),
        plain_ms=eager_ms(cycling(functools.partial(
            ref.fused_paged_attention_ref, scale=scale), layers)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"B={B} H={H} n_kv={n_kv} dh={dh} blocks={mpps} "
              f"tokens={tokens} staged={n_staged}/{int((tb >= 0).sum())}")
    r = results[name]
    print(f"[kernel] {name}: max_abs_err {r['max_abs_err']:.3g}, bitwise "
          f"== page kernel on the same bytes | kernel_ms {r['ms']:.4f} "
          f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
          f"library_ms none (no single PyTorch call computes it) | "
          f"{r['shape']}")

    # Copies on the engine's stacked pools [L, NP, ptok, n_kv, dh].
    pool = randn(L, NP, ptok, n_kv, dh)
    n_pages = 13                  # a 768-token prompt + 64 new tokens
    perm = rng.permutation(NP)
    idx = perm[:n_pages].astype(np.int32)
    idx[3] = -1                                   # a hole
    idx_t = t(idx)
    got = ops.page_gather(pool, idx_t)
    require(torch.equal(got, ref.page_gather_ref(pool, idx_t)),
            "page_gather != plain")
    require(torch.equal(ops.page_gather(pool, t(np.full(4, -1, np.int32))),
                        pool[:, [0, 0, 0, 0]]), "page_gather all-hole")
    page_bytes = ptok * n_kv * dh * 2
    n_valid = int((idx >= 0).sum())
    # Timed calls cycle over disjoint page sets covering the whole pool
    # (94 MB, beyond the 50 MB L2), as evictions and faults find it cold.
    idx_sets = [perm[i * n_pages:(i + 1) * n_pages].astype(np.int32)
                for i in range(NP // n_pages)]
    for s_ in idx_sets:
        s_[3] = -1
    idx_sets = [t(s_) for s_ in idx_sets]
    b_ms, b_by = bound_ms(2 * L * n_pages * page_bytes)
    results["page_gather"] = dict(
        max_abs_err=0.0,
        ms=graph_ms(cycling(ops.page_gather, [(pool, i) for i in idx_sets])),
        plain_ms=eager_ms(cycling(ref.page_gather_ref,
                                  [(pool, i) for i in idx_sets])),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(cycling(
            torch.index_select, [(pool, 1, i.clamp(min=0))
                                 for i in idx_sets])),
        shape=f"L={L} n={n_pages} page={page_bytes}B")

    pages_in = randn(L, n_pages, ptok, n_kv, dh)
    a, b_ = pool.clone(), pool.clone()
    ops.page_scatter(a, idx_t, pages_in)
    ref.page_scatter_ref(b_, idx_t, pages_in)
    require(torch.equal(a, b_), "page_scatter != plain")
    c = pool.clone()
    ops.page_scatter(c, t(np.full(5, -1, np.int32)),
                     pages_in[:, :5].contiguous())
    require(torch.equal(c, pool), "page_scatter all-hole must be a no-op")
    page_sets = [randn(L, n_pages, ptok, n_kv, dh) for _ in idx_sets]
    keep_col = torch.arange(n_pages, device=dev) != 3
    b_ms, b_by = bound_ms(2 * L * n_valid * page_bytes)
    results["page_scatter"] = dict(
        max_abs_err=0.0,
        ms=graph_ms(cycling(ops.page_scatter,
                            [(a, i, pg) for i, pg in zip(idx_sets,
                                                         page_sets)])),
        plain_ms=eager_ms(cycling(ref.page_scatter_ref,
                                  [(b_, i, pg) for i, pg in zip(idx_sets,
                                                                page_sets)])),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(cycling(
            a.index_copy_, [(1, i[keep_col].long(),
                             pg[:, keep_col].contiguous())
                            for i, pg in zip(idx_sets, page_sets)])),
        shape=f"L={L} n={n_pages} ({n_valid} valid) page={page_bytes}B")

    n_copy = 4
    src = perm[n_pages:n_pages + n_copy].astype(np.int32)
    dst = perm[n_pages + n_copy:n_pages + 2 * n_copy].astype(np.int32)
    src[1] = dst[2] = -1
    src_t, dst_t = t(src), t(dst)
    a, b_ = pool.clone(), pool.clone()
    ops.page_compact(a, src_t, dst_t)
    ref.page_compact_ref(b_, src_t, dst_t)
    require(torch.equal(a, b_), "page_compact != plain")
    c = pool.clone()
    ops.page_compact(c, t(np.full(3, -1, np.int32)),
                     t(np.full(3, -1, np.int32)))
    require(torch.equal(c, pool), "page_compact all-hole must be a no-op")
    n_ok = int(((src >= 0) & (dst >= 0)).sum())
    pairs = []
    for i in range(NP // (2 * n_copy)):
        chunk = perm[i * 2 * n_copy:(i + 1) * 2 * n_copy].astype(np.int32)
        s_, d_ = chunk[:n_copy].copy(), chunk[n_copy:].copy()
        s_[1] = d_[2] = -1
        pairs.append((t(s_), t(d_)))
    ok_col = torch.tensor([0, 3], device=dev)

    def lib_compact(s_, d_):
        a[:, d_] = a[:, s_]
    b_ms, b_by = bound_ms(2 * L * n_ok * page_bytes)
    results["page_compact"] = dict(
        max_abs_err=0.0,
        ms=graph_ms(cycling(ops.page_compact, [(a, s_, d_)
                                               for s_, d_ in pairs])),
        plain_ms=eager_ms(cycling(ref.page_compact_ref,
                                  [(b_, s_, d_) for s_, d_ in pairs])),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(cycling(lib_compact, [
            (s_[ok_col].long(), d_[ok_col].long()) for s_, d_ in pairs])),
        shape=f"L={L} n={n_copy} ({n_ok} valid) page={page_bytes}B")
    for name in ("page_gather", "page_scatter", "page_compact"):
        r = results[name]
        print(f"[kernel] {name}: exact | kernel_ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.5f} library_ms "
              f"{r['library_ms']:.4f} | {r['shape']}")
    torch.cuda.synchronize()


def serve_mode(cfg, mode, params=None, device=None):
    """One main-path run: the stream served in ``mode`` with the step
    hook, launch counters reset just before and read just after.
    Returns (engine, stream, events, launch counts, wall seconds)."""
    import torch
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, geometry=PoolGeometry(), max_batch=MAX_BATCH,
                        max_seq=MAX_SEQ, manager_kind="mosaic",
                        oversubscription=OVERSUB, fault_mode=mode, seed=0,
                        params=params, device=device)
    stream = make_stream(cfg.vocab_size)
    events = MainPathEvents(cfg)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    drive(eng, stream, events)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, stream, events, ops.launch_counts(), wall


def check_mode_run(cfg, mode, eng, stream, events, counts):
    """What every main-path run must show, on the card or (counts all 0)
    rehearsed on the CPU."""
    s = eng.stats
    require(all(r.done for _, r in stream), f"{mode}: not every request "
            f"completed")
    for _, r in stream:
        require(len(r.out) == r.max_new
                and all(0 <= tok < cfg.vocab_size for tok in r.out),
                f"{mode}: request {r.rid}: bad output {r.out[:8]}...")
    require(s.swaps_out >= 1 and s.faults >= 1 and s.compaction_copies >= 1,
            f"{mode}: paging not exercised: swaps {s.swaps_out} faults "
            f"{s.faults} CAC copies {s.compaction_copies}")
    require(events.cac_checked, f"{mode}: CAC coherence not checked")
    require(events.probe_frames >= 1, f"{mode}: no coalesced frame in the "
            f"probe")
    require(s.h2d_bytes == s.faults * eng.page_bytes,
            f"{mode}: {s.h2d_bytes} B copied to the card for {s.faults} "
            f"faulted pages of {eng.page_bytes} B")
    if mode == "sync":
        require(s.landings == s.fault_steps, "sync: one landing per fault "
                "batch")
    if mode == "async":
        require(s.prefetch_hits > 0, "async: the stream made no prefetch "
                "hit")
    if mode == "fused":
        require(s.fused_steps > 0
                and s.fused_ready_pages + s.fused_drained_pages > 0,
                "fused: no decode step read a staged page")
    if eng.device.type != "cuda":
        return
    path = [k for k in counts if k != "paged_attention.fused"
            or mode == "fused"]
    require(all(counts[k] > 0 for k in path),
            f"{mode}: a kernel of the path never launched: {counts}")
    # Every decode layer's attention went through a kernel (the fused one
    # on steps that read staged pages; +1: the dual probe's page partial),
    # and every landing launched the scatter for the K and V pools.
    L = cfg.n_layers
    require(counts["paged_attention.page"]
            == L * (s.decode_steps - s.fused_steps) + 1
            and counts["paged_attention.fused"] == L * s.fused_steps
            and counts["page_scatter"] == 2 * s.landings
            and counts["page_gather"] <= 2 * s.swaps_out,
            f"{mode}: launches {counts} do not account for "
            f"{s.decode_steps} decode steps ({s.fused_steps} fused), "
            f"{s.landings} landings, {s.swaps_out} evictions")


def phase_main_path(cfg):
    """Full-width serving runs in the three fault modes; returns (launch
    counts summed over the runs, the weights)."""
    import torch
    params = None
    tokens, total = {}, {}
    for mode in MODES:
        t0 = time.perf_counter()
        eng, stream, events, counts, wall = serve_mode(cfg, mode, params)
        if params is None:
            print(f"[engine] built full-width {cfg.name} ({cfg.n_layers} "
                  f"layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
                  f"{cfg.dtype}); pool {eng.cache.pages_per_shard} pages x "
                  f"{eng.page_bytes} B")
            params = dict(eng.lm.state_dict())
        check_mode_run(cfg, mode, eng, stream, events, counts)
        tokens[mode] = {r.rid: list(r.out) for _, r in stream}
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        s = eng.stats
        print(f"[engine:{mode}] {s.summary()}")
        print(f"[engine:{mode}] measured: wall {wall:.2f}s (with build "
              f"{time.perf_counter() - t0:.2f}s) | decode {s.decode_tokens} "
              f"tok in {s.decode_steps} steps: "
              f"{s.decode_tokens / s.decode_s:.1f} tok/s, "
              f"{s.decode_s / s.decode_steps * 1e3:.2f} ms/step | prefill "
              f"{s.prefill_tokens} tok: "
              f"{s.prefill_s / s.prefill_tokens * 1e3:.3f} ms/token | PCIe "
              f"out {s.d2h_bytes} B in {s.d2h_s:.4f}s, in {s.h2d_bytes} B "
              f"in {s.h2d_s:.4f}s | {s.fused_steps} fused steps | dual "
              f"probe {events.probe_frames} frames, max_abs_err "
              f"{events.probe_err:.3g}")
        print(f"[engine:{mode}] modeled (link model, clock = measured "
              f"decode): faults {s.faults} in {s.fault_dmas} DMAs, "
              f"transfer {s.transfer_us:.1f}us, hidden "
              f"{s.fault_hidden_us:.1f}us, exposed {s.fault_exposed_us:.1f}"
              f"us, prefetch hit/miss/wasted {s.prefetch_hits}/"
              f"{s.prefetch_misses}/{s.prefetch_wasted}, evict "
              f"{s.evict_pages} pages {s.evict_us:.1f}us, fused ready/"
              f"drained {s.fused_ready_pages}/{s.fused_drained_pages}, "
              f"tail {s.fused_tail_us:.1f}us")
        print(f"[engine:{mode}] launches: {json.dumps(counts)}")
        del eng
        torch.cuda.empty_cache()
    diff = [m for m in MODES if tokens[m] != tokens["sync"]]
    require(not diff, f"tokens differ from sync in {diff}")
    print(f"[engine] sync == async == fused on every greedy token")
    return total, params


def phase_small_agreement(cfg_full):
    """A narrow model (head_dim 32) on the card vs the same on the CPU."""
    import torch
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.serving.engine import ServingEngine
    cfg = dataclasses.replace(cfg_full, n_layers=2, d_model=128, n_heads=4,
                              n_kv_heads=2, d_ff=256, vocab_size=512,
                              dtype="float32")
    outs = {}
    params = None
    for dev in ("cuda", "cpu"):
        eng = ServingEngine(cfg, geometry=PoolGeometry(), max_batch=MAX_BATCH,
                            max_seq=MAX_SEQ, oversubscription=OVERSUB,
                            fault_mode="fused", seed=0, params=params,
                            device=dev)
        if params is None:
            params = {k: v.cpu() for k, v in eng.lm.state_dict().items()}
        stream = make_stream(cfg.vocab_size)
        drive(eng, stream)
        outs[dev] = {r.rid: list(r.out) for _, r in stream}
        if dev == "cuda":
            torch.cuda.synchronize()
    diff = [rid for rid in outs["cpu"] if outs["cpu"][rid] != outs["cuda"][rid]]
    require(not diff, f"small model: card and CPU tokens differ for {diff}")
    print("[small] narrow model, same weights, fused mode: card (kernels) "
          "== CPU (plain versions) on every greedy token")


def phase_transparency(cfg, params):
    """mosaic vs gpu-mmu without oversubscription: same batches, same
    tokens; then a held-preemption round trip on a third engine."""
    import torch
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.serving.engine import ServingEngine
    runs = {}
    for kind in ("mosaic", "gpu-mmu"):
        eng = ServingEngine(cfg, geometry=PoolGeometry(),
                            max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                            manager_kind=kind, params=params)
        stream = make_stream(cfg.vocab_size)
        batches = drive(eng, stream)
        runs[kind] = (batches, {r.rid: list(r.out) for _, r in stream})
        del eng
        torch.cuda.empty_cache()
    require(runs["mosaic"][0] == runs["gpu-mmu"][0],
            "batches differ between managers: tokens not comparable")
    require(runs["mosaic"][1] == runs["gpu-mmu"][1],
            "mosaic and gpu-mmu emitted different tokens")
    print(f"[transparency] mosaic == gpu-mmu: {len(runs['mosaic'][0])} "
          f"identical batches, identical greedy tokens")

    eng = ServingEngine(cfg, geometry=PoolGeometry(), max_batch=MAX_BATCH,
                        max_seq=MAX_SEQ, manager_kind="mosaic", params=params)
    stream = make_stream(cfg.vocab_size)
    for _, r in stream[:6]:
        eng.submit(r)
    for _ in range(5):
        eng.step()
    rid = eng.active[0].rid
    tokens = eng.cache.seq_tokens[rid]
    require(eng.preempt(rid, hold=True), "preempt failed")
    saved = {key: eng.host.peek(*key) for key in eng.host.seq_pages(rid)}
    require(saved, "held request parked no pages")
    require(eng.release(rid), "release failed")
    eng.step()
    require(rid in [r.rid for r in eng.active], "released request not resumed")
    ptok = eng.geo.page_tokens
    pps = eng.cache.pages_per_shard
    for (_, s, vpn), (kp, vp) in saved.items():
        ppn = s * pps + eng.cache.mgrs[s].tables[rid].ppn[vpn]
        n = min(ptok, tokens - vpn * ptok)
        require(torch.equal(eng.pools[0][:, ppn, :n].cpu(), kp[:, :n])
                and torch.equal(eng.pools[1][:, ppn, :n].cpu(), vp[:, :n]),
                f"round trip: page {vpn} of request {rid} differs")
    print(f"[roundtrip] request {rid}: {len(saved)} pages out to host and "
          f"back, bit-identical")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    phase_env()
    phase_build()
    results = {}
    phase_kernels(cfg, results)
    counts, params = phase_main_path(cfg)
    torch.cuda.empty_cache()
    phase_small_agreement(cfg)
    phase_transparency(cfg, params)
    line = [dict(name=name, route="cuda", source=SOURCES[name],
                 replaces=REPLACES[name], launches=counts[name],
                 max_abs_err=r["max_abs_err"], ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                 bound_by=r["bound_by"], library_ms=r["library_ms"])
            for name, r in results.items()]
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
