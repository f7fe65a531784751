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
   the same bytes; gather / scatter / compact exactly; prefill flash
   attention on a full 1152-token prompt and on its suffix from position
   576, whose rows must equal the full call's bit for bit; the SSD scan at
   zamba2-1.2b's prefill shape with its one B/C group, the main path's
   call, and head-expanded, at mamba2-1.3b's, and with a carried initial
   state over 192-row chunks), and their times (CUDA-graph replay for kernels and library calls, CUDA events for
   the plain versions) beside their bound: bytes at 3.35 TB/s or bf16
   operations at 989 TFLOP/s, whichever is larger.  Paged attention is
   also timed at B = 1, and flash and paged attention at zamba2-1.2b's
   shared-block shapes (H = n_kv = 32, dh = 64: one query head per KV
   head) and dbrx-132b's (H = 48 over n_kv = 8, dh = 128: six query heads
   per KV head), with the page copies at their page sizes; each [kernel]
   line names the split count or tile shape.  At
   deepseek-v2-lite's MLA shapes (entries ``<kernel>.mla`` of the kernels
   line): paged attention over latent pools (16 query heads on one KV
   head, K 576 / V 512, page and frame, B = 4 and 1) and flash attention
   at dh 192 / dh_v 128 (full prompt and its suffix, bitwise), and the
   page copies on the latent pools.  At the shapes of phases 4g-4i
   (entries ``<kernel>.<tag>``): flash attention, each also timed beside
   ``scaled_dot_product_attention`` and with queries at 3x unit scale so
   that outputs are O(1), non-causal for seamless-m4t's encoder over 4096
   frames (``.encoder``), its cross-attention of a 1152-row prompt over
   them (``.cross_prefill``) and of one row per sequence at B = 4, cycling
   its 24 layers' cross K/V (``.cross_decode``), causal for llava's 2880
   image + 1152 prompt rows (``.vlm``) and phi3's 1152-token prompt at
   head dim 96 (``.phi3``); paged attention at g = 4 / dh 128
   (``.g4d128``, page and frame) and g = 1 / dh 96 (``.g1d96``), its o / l
   at the f32 tolerance; fused gather-attend at llava's g = 4 / dh 128
   (``.g4d128``) and seamless's g = 1 / dh 64 (``.g1d64``), each also bit
   for bit the page kernel on the same bytes; the page copies at phi3's
   393,216-byte page;
4. main path: qwen2.5-3b at its published width, bf16, random weights from
   a seed, served by ``ServingEngine`` (mosaic, 2x oversubscribed) over a
   seeded stream with staggered priority arrivals, three times on the same
   weights: sync, async and fused fault-in (async and fused leave
   ``decode_window_us`` unset, so their modeled clock follows the measured
   decode time), each with the prefix cache on (the default; the stream
   shares no prefix, so admissions miss and completions park).  During
   each run one dual-granularity attention call reads the engine's pool
   through ``pack_dual`` frame tables, and a partial deallocation of one
   request's pages makes CAC plan copies that the engine executes.  Launch
   counters are reset before and read after each run: every kernel of that
   mode's path must have launched, the counts must account for every
   prefill layer, decode layer, landing, eviction, park and fused step, and
   the three modes must emit identical tokens;
4b. prefix cache at full width, same weights.  First a probe, printed and
   not checked: whether 64 rows of a bf16 product over the FFN's inputs
   get the same bits alone as inside a 576-row product (the reason prefill
   runs on fixed row blocks).  Then six requests over three
   tenants share a 512-token system prompt, two arrive first and four
   after those drain; served in sync, async and fused with the cache on and
   in async with it off.  The four runs must emit identical tokens, the
   cache must hit at least four times and cut prefill tokens by exactly
   the reused tokens, and each run's launches must account for every
   prefill layer (full or suffix) as above;
4c. hybrid main path: zamba2-1.2b at its published width (38 Mamba-2
   layers, one shared attention block invoked 6 times, bf16, random
   weights from a seed), same pool geometry and stream, sync, async and
   fused.  Tokens identical across the modes; at least one swap and one
   fault; launches account for 38 SSD scans and 6 flash attentions per
   admission, 6 paged (or fused) attentions per decode step, and every
   gather and landing;
4d. ssm path: mamba2-1.3b at its published width (48 layers, d_state 128,
   no KV pool), the stream's first four requests, sync and async: tokens
   identical, 48 SSD scans per admission, no attention or page launch;
5. agreement on a small input: a narrow model served on the card (kernels)
   and on the CPU (plain versions), in fused mode, emits the same greedy
   tokens;
6. application transparency: the stream without oversubscription under
   mosaic and gpu-mmu — same batches, identical tokens;
7. paging round trip: a held preemption's host payloads come back into the
   pool bit for bit;
8. the cluster tier at full width (after 7, once phase 4's copy of
   qwen2.5-3b's weights has left the card): ``ServingCluster`` of two
   ``ServingEngine`` replicas sharing one LM (weights drawn anew from seed
   0: the same weights, one copy on the card, which the memory
   high-water mark must show), phase 4's pool per engine, async fault-in,
   a shared host tier bounded at ``CLUSTER_FRAMES`` frames over a spill
   directory, the shared prefix index, work-stealing migration,
   pre-staging, the radix translation meter and ``decode_window_us`` set
   (the router's costs, and so the schedule, come from the modeled
   clock).  Traffic: phase 4b's waves (the first pinned to engine 0, the
   second routed), then phase 4's stream pinned to engine 0, whose
   priority arrivals make it preempt while engine 1 has room.
   8a: served twice; the two runs give identical tokens, router
   decisions, frame-table, tier, spill and translation counters; both
   engines dispatched; at least one migration with a whole-frame owner
   flip and every migrated request's pages in the destination pool bit
   for bit the payloads the source gathered; one admission (one flash
   launch per layer) per request: a migration re-prefills nothing;
   engine 1 hits the prefix engine 0 parked, landed by page_scatter;
   frames spilled and promoted back; ``check_invariants()`` after every
   router step; lookups on both engines.  Router-step and engine-step ms
   (host clock), promote time (host clock and modeled) and the memory
   high-water mark are printed.
   8b: a seeded ``FaultPlan``: engine 1 dies ``CRASH_AFTER`` router steps
   into the stream, disk reads fail transiently (the tier retries), and
   the first request frame written to disk is corrupted: every request
   completes, the dead engine holds no host frame after the crash (its
   preempted request re-leased whole to the survivor) while the prefix
   frames survive, at least one retry, one quarantine and one
   lost-payload restart, invariants after every step.
   8c: phase 4's stream on one engine in sync without oversubscription,
   the translation meter off, flat and radix, and radix under gpu-mmu:
   the same batches and tokens, equal lookups for flat and radix, radix
   walks <= flat walks; mosaic's and gpu-mmu's walks printed.
   8d: 8a and 8b with the narrow f32 model of phase 5 on the card and on
   the CPU: identical tokens, router decisions, tier counters and
   injector log.
4e. (after 8) deepseek-v2-lite
   at its published width cut to 2 layers (the dense one and one MoE
   layer) on the card against the same weights on the CPU (plain
   versions, the card's expert choices replayed): logits and latent pools
   of a prefill and two decode steps within 2e-2 of their scale; then at
   its published width and depth (27 layers, MLA over latent pools,
   one dense-FFN layer then 64 routed experts top-6 + 2 shared, bf16,
   ~15.7 G parameters from a seed) through phase 4's stream and step hook
   in sync and async: fused is refused (as the reference), tokens
   identical, at least one swap, fault and CAC copy, 27 flash calls per
   admission and 27 paged calls per decode step, no prefix cache;
4f. dbrx-132b at its published widths, depth-cut to its first 8 of 40
   layers (~52 GB of bf16; all 40 would not fit the card), the stream's
   first four requests in sync: 8 flash calls per admission, 8 paged calls
   per step, and the card's memory high-water mark;
4g. llava-next-mistral-7b at its published width and depth (32 layers,
   32 heads over 8 KV heads of 128, 2880 image tokens from the engine's
   zero stub in front of each prompt, bf16, ~7.3 G parameters from a
   seed) through phase 4's stream and step hook at max_seq 4096, in sync,
   async and fused: tokens identical, at least one swap, fault and CAC
   copy, request 0 holding its 2880 image tokens and its prompt, 32 flash
   calls per admission (over 2880 + the padded prompt's rows) and 32
   paged (or fused) per step, no prefix cache; then cut to 2 layers on
   the card against the CPU (in float32) with random image embeddings;
4h. seamless-m4t-large-v2 at its published width and depth (24 encoder +
   24 decoder layers, 16 heads of 64, source_len 4096 zero frames from the
   stub, vocab 256206, bf16) through the same stream and hook in sync,
   async and fused: tokens identical, at least one swap and fault, 72
   flash calls per admission (24 encoder, 24 self-, 24 cross-attention)
   and per step 24 paged (or fused) and 24 cross-attention flash calls,
   the encoder's and the cross-attention's as the wrapper counts them by
   call site;
   then cut to 2 + 2 layers on the card against the CPU with random
   source frames (logits, pools and cross K/V);
4i. llama3-8b, phi3-mini-3.8b and qwen3-8b at their published widths and
   depths, one after another, the stream's first four requests in sync,
   launches accounted for per layer; qwen3-8b (qk-norm) also cut to 2
   layers on the card against the CPU.

Ends with the script's total time, a JSON line of per-kernel numbers and,
last, the ok line.  Launches of an entry: those of its kernel at the
entry's shapes in the serving runs (``family_entries``): ``.mla`` from
phase 4e, ``.vlm`` and ``.g4d128`` from 4g and 4i, ``.phi3`` and
``.g1d96`` from phi3's run, ``.g1d64`` and the flash kernel's counts by
call site (``.encoder`` / ``.cross_prefill`` / ``.cross_decode``) from
4h; every other launch of phases 4, 4c, 4d, 4f-4i and 8a-8c under its
kernel's own entry.  Of the serving phases only 4f is cut in depth.
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
HYBRID_ARCH, SSM_ARCH = "zamba2-1.2b", "mamba2-1.3b"
MLA_ARCH, MOE_ARCH = "deepseek-v2-lite-16b", "dbrx-132b"
VLM_ARCH, ENCDEC_ARCH = "llava-next-mistral-7b", "seamless-m4t-large-v2"
DENSE_ARCHS = ("llama3-8b", "phi3-mini-3.8b", "qwen3-8b")   # phase 4i
DENSE_REQUESTS = 4      # phase 4i serves the stream's first four requests
VLM_MAX_SEQ = 4096      # 2880 image tokens + a 1100-token prompt + decode
SSM_REQUESTS = 4        # phase 4d serves the stream's first four requests
MOE_REQUESTS = 4        # and phase 4f too
MOE_LAYERS = 8          # phase 4f: dbrx's first 8 of 40 layers (52 GB)
MAX_BATCH, MAX_SEQ, OVERSUB = 4, 2048, 2.0
ARRIVE_STEP = 10        # the two priority-1 requests arrive here
PROBE_STEP = 3          # dual-granularity attention over the engine's pool
TRIM_STEP = 6           # partial deallocation of request 0's pages
TRIM_VPNS = range(2, 14)
FLASH_T, FLASH_P = 1152, 576   # phase 3: full prompt, cached prefix length
PREFIX_TOKENS, PREFIX_NEW = 512, 16      # phase 4b: system prompt, max_new
CLUSTER_ENGINES = 2     # phase 8: replicas sharing one LM on the card
CLUSTER_FRAMES = 2      # host DRAM bound: 2 frames of 16 pages (~75 MB)
CLUSTER_WINDOW_US = 50_000.0   # modeled decode window, about the step
CLUSTER_RID = 100       # the stream's rids follow the waves' 0-5
CRASH_AFTER = 12        # phase 8b: engine 1's crash, in steps into the stream
READ_ERROR_RATE = 0.5   # phase 8b: transient disk-read errors per read
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
ATTN_TOL = dict(rtol=2e-2, atol=2e-2)   # bf16 inputs (tests/test_kernels.py)
SSD_TOL = dict(rtol=3e-2, atol=3e-2)    # bf16 inputs (tests/test_kernels.py)
ML_TOL = dict(rtol=1e-5, atol=1e-5)     # f32 accumulators, other sum order
# Query scale of phase 3's flash checks at the new families' shapes.  At
# unit scale the softmax over thousands of keys is near uniform and every
# output is a mean of ~Tk values (about 0.03), under ATTN_TOL; at 3 the
# scores are N(0, 9), a few keys carry each row, the outputs are O(1), and
# a skipped or mis-masked key tile moves rows by far more than ATTN_TOL.
PEAK_Q = 3.0

MODES = ("sync", "async", "fused")
SSM_MODES = ("sync", "async")
REPLACES = {
    "paged_attention.page": "src/repro/kernels/paged_attention.py:106",
    "paged_attention.frame": "src/repro/kernels/paged_attention.py:106",
    "paged_attention.fused": "src/repro/kernels/paged_attention.py:293",
    "page_gather": "src/repro/kernels/page_compact.py:92",
    "page_scatter": "src/repro/kernels/page_compact.py:128",
    "page_compact": "src/repro/kernels/page_compact.py:40",
    "flash_attention": "src/repro/kernels/flash_attention.py:82",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:73",
}
SOURCES = {
    "paged_attention.page": "src/repro_torch/csrc/paged_attention.cu",
    "paged_attention.frame": "src/repro_torch/csrc/paged_attention.cu",
    "paged_attention.fused": "src/repro_torch/csrc/paged_attention.cu",
    "page_gather": "src/repro_torch/csrc/page_copy.cu",
    "page_scatter": "src/repro_torch/csrc/page_copy.cu",
    "page_compact": "src/repro_torch/csrc/page_copy.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu",
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


def make_prefix_waves(vocab: int, seed: int = 1):
    """Phase 4b's requests as two waves: six requests over three tenants,
    each a shared ``PREFIX_TOKENS``-token system prompt followed by its own
    64-256-token suffix (distinct lengths), ``PREFIX_NEW`` new tokens."""
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, PREFIX_TOKENS).astype(np.int32)
    lens = rng.permutation(np.arange(64, 257))[:6]
    reqs = [Request(rid=i, tenant=i % 3, max_new=PREFIX_NEW,
                    prompt=np.concatenate([shared, rng.integers(
                        0, vocab, int(n)).astype(np.int32)]))
            for i, n in enumerate(lens)]
    return reqs[:2], reqs[2:]


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
        self.first_len = None     # request 0's pool tokens at step 1
        self.probe_frames = 0
        self.probe_err = float("nan")
        self.cac_checked = False
        self._snap = {}
        self._tokens = 0

    def __call__(self, step, eng):
        if step == 1:
            self.first_len = eng.cache.seq_tokens.get(0)
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
        k, v = eng.pools
        # The query is as wide as the K pool (MLA: latent + rope).
        q = torch.randn((len(seqs), cfg.n_heads, k.shape[-1]),
                        generator=gen, device=eng.device).to(torch.bfloat16)
        scale = k.shape[-1] ** -0.5
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


SMI = "card not read"     # phase_env's nvidia-smi name, power limit


def phase_env():
    global SMI
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    SMI = smi.stdout.strip().splitlines()[0]
    print(SMI)
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
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.hybrid import n_invocations
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

    def t(a):
        return torch.from_numpy(a).to(dev)

    paged_entries(results, H, n_kv, dh, L, "", rng, randn)

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

    fused_entry(results, H, n_kv, dh, L, "", rng, randn)

    # Prefill flash attention at the path's shapes: (a) a full FLASH_T-token
    # prompt, (b) its suffix from position FLASH_P over all FLASH_T keys (a
    # cache hit on a FLASH_P-token prefix).  Compute-bound: its bound is
    # the bf16 operations of the causal pairs at the tensor-core peak.
    import torch.nn.functional as F
    name = "flash_attention"
    T, P = FLASH_T, FLASH_P
    q, k, v = randn(1, T, H, dh), randn(1, T, n_kv, dh), randn(1, T, n_kv, dh)
    qs = q[:, P:].contiguous()
    full = ops.flash_attention(q, k, v)
    suffix = ops.flash_attention(qs, k, v, q_offset=P)
    plain_full = ref.flash_attention_ref(q, k, v, causal=True)
    plain_suffix = ref.flash_attention_ref(qs, k, v, causal=True, q_offset=P)
    torch.cuda.synchronize()
    errs = []
    for got, want in ((full, plain_full), (suffix, plain_suffix)):
        torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL)
        require(bool(torch.isfinite(got.float()).all()), f"{name}: "
                f"non-finite")
        errs.append(float((got.float() - want.float()).abs().max()))
    require(torch.equal(suffix, full[:, P:]), f"{name}: suffix rows are not "
            f"the full call's bit for bit")

    def flash_bound(tq):
        """Bytes (q, k, v read once, o written once) and operations (QK^T
        and PV over the causal pairs) of queries T - tq .. T - 1."""
        pairs = sum(range(T - tq + 1, T + 1))
        return bound_ms(2 * (2 * tq * H + 2 * T * n_kv) * dh,
                        4 * H * dh * pairs)
    b_ms, b_by = flash_bound(T)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    results[name] = dict(
        max_abs_err=max(errs),
        ms=graph_ms(lambda: ops.flash_attention(q, k, v)),
        plain_ms=eager_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                          causal=True)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        shape=f"B=1 H={H} n_kv={n_kv} dh={dh} T={T} causal")
    r = results[name]
    sb_ms, _ = flash_bound(T - P)
    s_ms = graph_ms(lambda: ops.flash_attention(qs, k, v, q_offset=P))
    print(f"[kernel] {name}: max_abs_err {r['max_abs_err']:.3g}, suffix "
          f"rows bitwise == full | (a) full: kernel_ms {r['ms']:.4f} "
          f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
          f"({r['bound_by']}) library_ms {r['library_ms']:.4f} "
          f"(scaled_dot_product_attention) | (b) suffix Tq={T - P} "
          f"q_offset={P}: kernel_ms {s_ms:.4f} bound_ms {sb_ms:.5f} | "
          f"{r['shape']} | {flash_tiles(H, n_kv, T)}")
    hyb = get_config(HYBRID_ARCH)
    phase_attention_at(gen, hyb, n_invocations(hyb), "zamba2 shared block")
    phase_attention_at(gen, get_config(MOE_ARCH), MOE_LAYERS, "dbrx")

    # Copies on the engine's stacked pools [L, NP, ptok, n_kv, dh].
    pool = randn(L, NP, ptok, n_kv, dh)
    check_copies(pool, rng, randn, "qwen2.5-3b")
    n_pages = 13                  # a 768-token prompt + 64 new tokens
    perm = rng.permutation(NP)
    page_bytes = ptok * n_kv * dh * 2
    n_valid = n_pages - 1         # every timed set has one hole
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

    a, b_ = pool.clone(), pool.clone()
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

    n_copy, n_ok = 4, 2           # every timed plan has two holes
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


def paged_entries(results, H, n_kv, dh, L, suffix, rng, randn,
                  grans=("page", "frame")):
    """Paged attention at ``grans`` granularities, B in {1, 4, 8}, over an
    80-page pool with holes and partial last blocks (B = 8: a row made only
    of holes), against its plain version (o / l, m and l: f32 accumulators
    in another order, so at ML_TOL, far below the outputs' scale); timed at
    B = MAX_BATCH and B = 1 cycling over ``L`` layers' pools as decode
    reads them (beyond the 50 MB L2).  Stores ``paged_attention.<granularity><suffix>`` in ``results``
    and prints a [kernel] line for each."""
    import torch
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    geo = PoolGeometry()
    ptok, fp = geo.page_tokens, geo.frame_pages
    NP, mpps = 80, MAX_SEQ // ptok
    scale = dh ** -0.5
    kall, vall = randn(L, NP, ptok, n_kv, dh), randn(L, NP, ptok, n_kv, dh)
    pool_k, pool_v = kall[0], vall[0]

    def t(a):
        return torch.from_numpy(a).to(kall.device)
    for gran, n_blocks, n_entries, tpb in (
            ("page", mpps, NP, ptok), ("frame", mpps // fp, NP // fp,
                                       fp * ptok)):
        if gran not in grans:
            continue
        name = f"paged_attention.{gran}{suffix}"
        errs, o_scale = [], 0.0
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
            torch.testing.assert_close(on, on_r, **ML_TOL)
            torch.testing.assert_close(m, m_r, **ML_TOL)
            torch.testing.assert_close(l, l_r, **ML_TOL)
            require(bool(torch.isfinite(on).all()), f"{name}: non-finite")
            if B == 8:
                require(bool((m[-1] == -1e30).all() and (l[-1] == 0).all()
                             and (o[-1] == 0).all()),
                        f"{name}: all-hole row must give m=-1e30, l=0, o=0")
            errs.append(float((on - on_r).abs().max()))
            o_scale = max(o_scale, float(on_r.abs().max()))
            if B == 1:
                # A lone decoding request, over all L layers' pools in turn.
                b1_ms = graph_ms(cycling(functools.partial(
                    ops.paged_attention_kernel, granularity=gran,
                    frame_pages=fp, scale=scale),
                    [(q, kall[i], vall[i], tb, nt) for i in range(L)]))
                b1_tokens = int(nt.sum())
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
        print(f"[kernel] {name}: max_abs_err {max(errs):.3g} (output scale "
              f"{o_scale:.3g}) | kernel_ms {timing['ms']:.4f} plain_ms "
              f"{timing['plain_ms']:.4f} bound_ms {timing['bound_ms']:.5f} "
              f"library_ms none (no single PyTorch call computes paged "
              f"attention) | {timing['shape']} | splits "
              f"{pa.split_count(n_blocks, tpb)} of {pa.SPLIT_TOKENS} "
              f"positions, grid {pa.split_count(n_blocks, tpb)}x{n_kv}x"
              f"{MAX_BATCH} + combine | B=1 ({b1_tokens} tokens): kernel_ms "
              f"{b1_ms:.4f}")


def fused_entry(results, H, n_kv, dh, L, suffix, rng, randn,
                max_seq=MAX_SEQ):
    """Fused gather-attend at B = MAX_BATCH over an 80-page pool with
    about half of the valid pages staged and page tables as wide as
    ``max_seq``, against its plain version (o / l and m, l at the f32
    tolerance) and bit for bit against the page kernel where it reads the
    same bytes, staged or not; timed cycling over ``L`` layers' pools and
    stages as decode reads them.  Stores ``paged_attention.fused<suffix>``
    in ``results``."""
    import torch
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    name = f"paged_attention.fused{suffix}"
    NP, ptok, B = 80, PoolGeometry().page_tokens, MAX_BATCH
    n_blocks = max_seq // ptok
    scale = dh ** -0.5
    kall, vall = randn(L, NP, ptok, n_kv, dh), randn(L, NP, ptok, n_kv, dh)

    def t(a):
        return torch.from_numpy(a).to(kall.device)
    # The stage holds each staged page's bytes; the pool copies are
    # overwritten, so reading the wrong source shows.
    q = randn(B, H, dh)
    tb, nt = _tables(rng, B, n_blocks, NP, ptok)
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
    torch.testing.assert_close(on, on_r, **ML_TOL)
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
    # them, beyond the 50 MB L2.
    layers = [(q, kall[i], vall[i], st_k[i], st_v[i], tb, sl, nt)
              for i in range(L)]
    results[name] = dict(
        max_abs_err=float((on - on_r).abs().max()),
        ms=graph_ms(cycling(functools.partial(
            ops.fused_paged_attention_kernel, scale=scale), layers)),
        plain_ms=eager_ms(cycling(functools.partial(
            ref.fused_paged_attention_ref, scale=scale), layers)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"B={B} H={H} n_kv={n_kv} dh={dh} blocks={n_blocks} "
              f"tokens={tokens} staged={n_staged}/{int((tb >= 0).sum())}")
    r = results[name]
    print(f"[kernel] {name}: max_abs_err {r['max_abs_err']:.3g} (output "
          f"scale {float(on_r.abs().max()):.3g}), bitwise == page kernel on "
          f"the same bytes | kernel_ms {r['ms']:.4f} plain_ms "
          f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.5f} library_ms none "
          f"(no single PyTorch call computes it) | {r['shape']} | splits "
          f"{pa.split_count(n_blocks, ptok)} of {pa.SPLIT_TOKENS} positions "
          f"+ combine")


def flash_tiles(H, n_kv, T):
    """The flash kernel's tiling for one T-token prompt (B = 1), for the
    [kernel] lines."""
    g = H // n_kv
    bq = 64 // g
    return (f"tiles 64 rows ({g} heads x {bq} positions) x 64 keys, "
            f"mma.sync m16n8k16 bf16, grid {-(-T // bq)}x{n_kv}x1")


def check_copies(pool, rng, randn, label):
    """page_gather, page_scatter and page_compact on the stacked pool
    ``pool`` [L, NP, ...] against their plain versions, exactly: 13 pages
    with a hole, 4 copies with a hole on each side, and all-hole calls,
    which must copy nothing."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = pool.device

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    perm = rng.permutation(pool.shape[1])
    idx = perm[:13].copy()
    idx[3] = -1
    require(torch.equal(ops.page_gather(pool, t(idx)),
                        ref.page_gather_ref(pool, t(idx))),
            f"page_gather != plain ({label})")
    require(torch.equal(ops.page_gather(pool, t(np.full(4, -1))),
                        pool[:, [0, 0, 0, 0]]), f"page_gather all-hole "
            f"({label})")
    pages = randn(pool.shape[0], 13, *pool.shape[2:])
    a, b = pool.clone(), pool.clone()
    ops.page_scatter(a, t(idx), pages)
    ref.page_scatter_ref(b, t(idx), pages)
    require(torch.equal(a, b), f"page_scatter != plain ({label})")
    ops.page_scatter(a, t(np.full(5, -1)), pages[:, :5].contiguous())
    require(torch.equal(a, b), f"page_scatter all-hole must be a no-op "
            f"({label})")
    src, dst = perm[13:17].copy(), perm[17:21].copy()
    src[1] = dst[2] = -1
    ops.page_compact(a, t(src), t(dst))
    ref.page_compact_ref(b, t(src), t(dst))
    require(torch.equal(a, b), f"page_compact != plain ({label})")
    ops.page_compact(a, t(np.full(3, -1)), t(np.full(3, -1)))
    require(torch.equal(a, b), f"page_compact all-hole must be a no-op "
            f"({label})")
    page = pool[0, 0].numel() * pool.element_size()
    print(f"[kernel] page_gather / page_scatter / page_compact ({label}): "
          f"exact | L={pool.shape[0]} page={page}B")


def phase_attention_at(gen, cfg, n_slices, label):
    """Flash and paged attention at ``cfg``'s attention shapes, against
    their plain versions and timed beside their bounds: flash on a
    FLASH_T-token prompt and its suffix from FLASH_P (rows bitwise the full
    call's); paged (page granularity) at B = 1 and B = MAX_BATCH over the
    main path's table width, timed cycling over ``n_slices`` pool slices
    (zamba2's 6 shared-block invocations, dbrx's 8 layers) as a decode
    step does; then the page copies on those slices.  Printed only: the
    kernels JSON line keeps the serving shapes of qwen2.5-3b."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    dev = torch.device("cuda")
    H, n_kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    geo = PoolGeometry()
    ptok = geo.page_tokens
    NP, mpps, T, P = 80, MAX_SEQ // ptok, FLASH_T, FLASH_P
    scale = dh ** -0.5

    def randn(*shape):
        return torch.randn(shape, generator=gen,
                           device=dev).to(torch.bfloat16)
    q, k, v = randn(1, T, H, dh), randn(1, T, n_kv, dh), randn(1, T, n_kv, dh)
    qs = q[:, P:].contiguous()
    got = ops.flash_attention(q, k, v)
    suffix = ops.flash_attention(qs, k, v, q_offset=P)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL)
    require(torch.equal(suffix, got[:, P:]), f"flash_attention ({label}): "
            f"suffix rows are not the full call's bit for bit")
    err = float((got.float() - want.float()).abs().max())
    pairs = T * (T + 1) // 2
    b_ms, b_by = bound_ms(2 * (2 * T * H + 2 * T * n_kv) * dh,
                          4 * H * dh * pairs)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms = graph_ms(lambda: ops.flash_attention(q, k, v))
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    print(f"[kernel] flash_attention ({label}): max_abs_err {err:.3g}, "
          f"suffix rows bitwise == full | kernel_ms {ms:.4f} bound_ms "
          f"{b_ms:.5f} ({b_by}) library_ms {lib_ms:.4f} "
          f"(scaled_dot_product_attention) | B=1 H={H} n_kv={n_kv} dh={dh} "
          f"T={T} causal | {flash_tiles(H, n_kv, T)}")

    rng = np.random.default_rng(4)
    kall, vall = (randn(n_slices, NP, ptok, n_kv, dh) for _ in range(2))
    errs = []
    for B in (1, MAX_BATCH):
        qd = randn(B, H, dh)
        tb, nt = (torch.from_numpy(a).to(dev)
                  for a in _tables(rng, B, mpps, NP, ptok))
        o, m, l = ops.paged_attention_kernel(qd, kall[0], vall[0], tb, nt,
                                             granularity="page", scale=scale)
        o_r, m_r, l_r = ref.paged_attention_ref(qd, kall[0], vall[0], tb, nt,
                                                scale=scale)
        torch.cuda.synchronize()
        on, on_r = o / l[..., None], o_r / l_r[..., None]
        torch.testing.assert_close(on, on_r, **ATTN_TOL)
        torch.testing.assert_close(m, m_r, **ML_TOL)
        torch.testing.assert_close(l, l_r, **ML_TOL)
        errs.append(float((on - on_r).abs().max()))
    tokens = int(nt.sum())
    b_ms, b_by = bound_ms(2 * tokens * n_kv * dh * 2 + qd.numel() * 2
                          + 2 * tb.numel() * 4 + B * H * (dh + 2) * 4,
                          4 * H * dh * tokens)
    ms = graph_ms(cycling(functools.partial(
        ops.paged_attention_kernel, granularity="page", scale=scale),
        [(qd, kall[i], vall[i], tb, nt) for i in range(n_slices)]))
    ns = pa.split_count(mpps, ptok)
    print(f"[kernel] paged_attention.page ({label}): max_abs_err "
          f"{max(errs):.3g} (B = 1 and {B}) | kernel_ms {ms:.4f} bound_ms "
          f"{b_ms:.5f} ({b_by}) | B={B} H={H} n_kv={n_kv} dh={dh} "
          f"blocks={mpps} tokens={tokens}, cycling {n_slices} pool slices | "
          f"splits {ns} of {pa.SPLIT_TOKENS} positions, grid "
          f"{ns}x{n_kv}x{B} + combine")
    check_copies(kall, rng, randn, label)


def phase_mla_kernels(results):
    """Paged and flash attention at deepseek-v2-lite's MLA shapes, against
    their plain versions and timed beside their bounds.  Paged (absorbed
    decode): 16 query heads on one latent KV head, K 576 / V 512, bf16,
    64-token pages, 32 pages (2 frames) per row, holes and partial pages,
    at B = MAX_BATCH and B = 1, cycling over the 27 layers' pools as a
    decode step reads them (300 MB, beyond the 50 MB L2).  Flash (expanded
    prefill): H = n_kv = 16, dh 192 / dh_v 128, a FLASH_T-token causal
    prompt, and its suffix from FLASH_P, whose rows must equal the full
    call's bit for bit.  Each becomes its own entry of the kernels line
    (``<kernel>.mla``), launches counted in phase 4e.  Then the page copies
    on the stacked latent pools (K pages of 73,728 B, V of 65,536 B)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    dev = torch.device("cuda")
    mcfg = get_config(MLA_ARCH)
    m = mcfg.mla
    H, L = mcfg.n_heads, mcfg.n_layers
    dk, dv = m.kv_lora_rank + m.qk_rope_head_dim, m.kv_lora_rank
    dq = m.qk_nope_head_dim + m.qk_rope_head_dim
    scale = dq ** -0.5
    geo = PoolGeometry()
    ptok, fp = geo.page_tokens, geo.frame_pages
    NP, mpps = 80, MAX_SEQ // ptok
    rng = np.random.default_rng(5)
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen,
                           device=dev).to(torch.bfloat16)

    def t(a):
        return torch.from_numpy(a).to(dev)
    kall, vall = randn(L, NP, ptok, 1, dk), randn(L, NP, ptok, 1, dv)
    pools = [(kall[i], vall[i]) for i in range(L)]
    for gran, n_blocks, n_entries, tpb in (
            ("page", mpps, NP, ptok), ("frame", mpps // fp, NP // fp,
                                       fp * ptok)):
        name = f"paged_attention.{gran}.mla"
        fpk = fp if gran == "frame" else 1
        errs, times = [], {}
        for B in (1, MAX_BATCH):
            q = randn(B, H, dk)
            tb, nt = _tables(rng, B, n_blocks, n_entries, tpb)
            if B == MAX_BATCH:
                tb[-1], nt[-1] = -1, 0          # a row made only of holes
            tb, nt = t(tb), t(nt)
            o, m_, l = ops.paged_attention_kernel(
                q, *pools[0], tb, nt, granularity=gran, frame_pages=fp,
                scale=scale)
            o_r, m_r, l_r = ref.paged_attention_ref(
                q, *pools[0], tb, nt, scale=scale, frame_pages=fpk)
            torch.cuda.synchronize()
            on = o / torch.clamp(l[..., None], min=1e-30)
            on_r = o_r / torch.clamp(l_r[..., None], min=1e-30)
            torch.testing.assert_close(on, on_r, **ATTN_TOL)
            torch.testing.assert_close(m_, m_r, **ML_TOL)
            torch.testing.assert_close(l, l_r, **ML_TOL)
            require(bool(torch.isfinite(on).all()), f"{name}: non-finite")
            if B == MAX_BATCH:
                require(bool((m_[-1] == -1e30).all() and (l[-1] == 0).all()
                             and (o[-1] == 0).all()),
                        f"{name}: all-hole row must give m=-1e30, l=0, o=0")
            errs.append(float((on - on_r).abs().max()))
            layers = [(q, pk, pv, tb, nt) for pk, pv in pools]
            kw = dict(scale=scale)
            tokens = int(nt.sum())
            times[B] = (graph_ms(cycling(functools.partial(
                ops.paged_attention_kernel, granularity=gran,
                frame_pages=fp, **kw), layers)), tokens)
            if B == MAX_BATCH:
                nbytes = (tokens * (dk + dv) * 2 + q.numel() * 2
                          + 2 * tb.numel() * 4 + B * H * (dv + 2) * 4)
                b_ms, b_by = bound_ms(nbytes, 2 * H * (dk + dv) * tokens)
                results[name] = dict(
                    ms=times[B][0],
                    plain_ms=eager_ms(cycling(functools.partial(
                        ref.paged_attention_ref, frame_pages=fpk, **kw),
                        layers)),
                    bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    shape=f"B={B} H={H} n_kv=1 dh={dk} dh_v={dv} "
                          f"blocks={n_blocks} tokens={tokens}")
        r = results[name]
        r["max_abs_err"] = max(errs)
        ns = pa.split_count(n_blocks, tpb)
        print(f"[kernel] {name}: max_abs_err {max(errs):.3g} | kernel_ms "
              f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
              f"{r['bound_ms']:.5f} ({r['bound_by']}) library_ms none (no "
              f"single PyTorch call computes paged attention) | "
              f"{r['shape']} | splits {ns} of {pa.SPLIT_TOKENS} positions, "
              f"grid {ns}x1x{MAX_BATCH} (16 heads a CTA, mma.sync) + "
              f"combine | B=1 ({times[1][1]} tokens): kernel_ms "
              f"{times[1][0]:.4f}")

    name = "flash_attention.mla"
    T, P = FLASH_T, FLASH_P
    q, k, v = randn(1, T, H, dq), randn(1, T, H, dq), randn(1, T, H, 128)
    qs = q[:, P:].contiguous()
    kw = dict(scale=scale)
    full = ops.flash_attention(q, k, v, **kw)
    suffix = ops.flash_attention(qs, k, v, q_offset=P, **kw)
    plain_full = ref.flash_attention_ref(q, k, v, causal=True, **kw)
    plain_suffix = ref.flash_attention_ref(qs, k, v, causal=True,
                                           q_offset=P, **kw)
    torch.cuda.synchronize()
    errs = []
    for got, want in ((full, plain_full), (suffix, plain_suffix)):
        torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL)
        require(bool(torch.isfinite(got.float()).all()), f"{name}: "
                f"non-finite")
        errs.append(float((got.float() - want.float()).abs().max()))
    require(torch.equal(suffix, full[:, P:]), f"{name}: suffix rows are not "
            f"the full call's bit for bit")
    dvh = v.shape[-1]
    pairs = T * (T + 1) // 2
    b_ms, b_by = bound_ms(2 * T * H * (2 * dq + 2 * dvh),
                          2 * H * (dq + dvh) * pairs)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              scale=scale)
    try:                  # a yardstick only: the port never calls it
        sdpa()
        torch.cuda.synchronize()
        lib_ms, lib_note = -1.0, "scaled_dot_product_attention"
    except RuntimeError as exc:
        lib_ms, lib_note = None, f"none (SDPA refused: {str(exc)[:80]})"
    if lib_ms is not None:
        lib_ms = graph_ms(sdpa)
    results[name] = dict(
        max_abs_err=max(errs),
        ms=graph_ms(lambda: ops.flash_attention(q, k, v, **kw)),
        plain_ms=eager_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=True, **kw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape=f"B=1 H={H} n_kv={H} dh={dq} dh_v={dvh} T={T} causal")
    r = results[name]
    s_ms = graph_ms(lambda: ops.flash_attention(qs, k, v, q_offset=P, **kw))
    lib = "none" if lib_ms is None else f"{lib_ms:.4f}"
    print(f"[kernel] {name}: max_abs_err {r['max_abs_err']:.3g}, suffix "
          f"rows bitwise == full | (a) full: kernel_ms {r['ms']:.4f} "
          f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
          f"({r['bound_by']}) library_ms {lib} ({lib_note}) | (b) suffix "
          f"Tq={T - P} q_offset={P}: kernel_ms {s_ms:.4f} | {r['shape']} | "
          f"{flash_tiles(H, H, T)}")
    check_copies(kall, rng, randn, "deepseek latent K")
    check_copies(vall, rng, randn, "deepseek latent V")


def flash_entry(results, name, B, Tq, Tk, H, n_kv, dh, causal, randn,
                n_sets=1, what=""):
    """Flash attention at one shape of the path (q [B, Tq, H, dh] over k, v
    [B, Tk, n_kv, dh], bf16; causal calls have Tq == Tk) against its plain
    version, with queries drawn at PEAK_Q times the unit scale so that each
    row's output is O(1) and ATTN_TOL judges it, timed beside its bound and
    beside
    ``scaled_dot_product_attention`` at the same shape (a yardstick: the
    port never calls it).  ``n_sets`` > 1 cycles the timed calls over that
    many K/V sets (decode's cross-attention reads every decoder layer's
    cross K/V in turn, beyond the 50 MB L2).  Stores ``name`` in
    ``results``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    q = randn(B, Tq, H, dh) * PEAK_Q
    kvs = [(randn(B, Tk, n_kv, dh), randn(B, Tk, n_kv, dh))
           for _ in range(n_sets)]
    k, v = kvs[0]
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL)
    require(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
    pairs = Tq * (Tq + 1) // 2 if causal else Tq * Tk
    b_ms, b_by = bound_ms(2 * (2 * B * Tq * H * dh + 2 * B * Tk * n_kv * dh),
                          4 * B * H * dh * pairs)
    qt = q.transpose(1, 2).contiguous()
    kvt = [tuple(x.transpose(1, 2).contiguous() for x in kv) for kv in kvs]
    results[name] = dict(
        max_abs_err=float((got.float() - want.float()).abs().max()),
        ms=graph_ms(cycling(functools.partial(ops.flash_attention,
                                              causal=causal),
                            [(q, *kv) for kv in kvs])),
        plain_ms=eager_ms(cycling(functools.partial(
            ref.flash_attention_ref, causal=causal),
            [(q, *kv) for kv in kvs])),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(cycling(functools.partial(
            F.scaled_dot_product_attention, is_causal=causal,
            enable_gqa=True), [(qt, *kv) for kv in kvt])),
        shape=f"B={B} Tq={Tq} Tk={Tk} H={H} n_kv={n_kv} dh={dh} "
              f"{'causal' if causal else 'non-causal'}")
    r = results[name]
    g = H // n_kv
    print(f"[kernel] {name} ({what}): max_abs_err {r['max_abs_err']:.3g} "
          f"(output scale {float(want.float().abs().max()):.3g}) | "
          f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
          f"{r['bound_ms']:.5f} ({r['bound_by']}) library_ms "
          f"{r['library_ms']:.4f} (scaled_dot_product_attention) | "
          f"{r['shape']} | tiles 64 rows ({g} heads x {64 // g} positions) x "
          f"64 keys, grid {-(-Tq // (64 // g))}x{n_kv}x{B}"
          f"{f', cycling {n_sets} K/V sets' if n_sets > 1 else ''}")


def time_copies(pool, rng, label):
    """page_gather, page_scatter and page_compact on the stacked pool
    ``pool`` [L, NP, ...], timed cycling over disjoint page sets that cover
    the pool (13 pages with a hole; 4 copies with a hole on each side)
    beside their bounds; printed."""
    import torch
    from repro_torch.kernels import ops
    L, NP = pool.shape[:2]
    dev = pool.device
    page = pool[0, 0].numel() * pool.element_size()
    perm = rng.permutation(NP).astype(np.int32)
    sets = [perm[i * 13:(i + 1) * 13].copy() for i in range(NP // 13)]
    for s_ in sets:
        s_[3] = -1
    sets = [torch.from_numpy(s_).to(dev) for s_ in sets]
    pages = pool[:, :13].clone()
    plans = []
    for i in range(NP // 8):
        c = perm[i * 8:(i + 1) * 8].copy()
        src, dst = c[:4].copy(), c[4:].copy()
        src[1] = dst[2] = -1
        plans.append(tuple(torch.from_numpy(a).to(dev) for a in (src, dst)))
    a = pool.clone()
    parts = []
    for name, fn, args, n_valid in (
            ("page_gather", ops.page_gather, [(pool, i) for i in sets], 12),
            ("page_scatter", ops.page_scatter, [(a, i, pages) for i in sets],
             12),
            ("page_compact", ops.page_compact, [(a, s_, d_)
                                                for s_, d_ in plans], 2)):
        b_ms, _ = bound_ms(2 * L * n_valid * page)
        parts.append(f"{name} kernel_ms {graph_ms(cycling(fn, args)):.4f} "
                     f"bound_ms {b_ms:.5f}")
    print(f"[kernel] page copies ({label}, L={L} page={page}B): "
          f"{' | '.join(parts)} (bytes)")


def phase_family_kernels(results):
    """Phase 3 at the shapes of phases 4g-4i (see the module doc): flash
    attention for seamless's encoder (e), its cross-attention at prefill
    (x) and at decode (d), llava's prefill over the image and the prompt
    (v) and phi3's prefill (p); paged attention at g = 4 / dh 128 (llama3,
    qwen3, llava) and g = 1 / dh 96 (phi3); fused gather-attend at llava's
    g = 4 / dh 128 and seamless's g = 1 / dh 64 (its two fused paths); the
    page copies at phi3's 393,216-byte page.  Entries ``<kernel>.<tag>`` of
    the kernels line."""
    import torch
    from repro_torch.configs import get_config
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    rng = np.random.default_rng(6)

    def randn(*shape):
        return torch.randn(shape, generator=gen,
                           device=dev).to(torch.bfloat16)
    sm = get_config(ENCDEC_ARCH)
    S, Ld = sm.encdec.source_len, sm.encdec.dec_layers
    H, dh = sm.n_heads, sm.resolved_head_dim
    flash_entry(results, "flash_attention.encoder", 1, S, S, H,
                sm.n_kv_heads, dh, False, randn, what="seamless encoder")
    flash_entry(results, "flash_attention.cross_prefill", 1, FLASH_T, S, H,
                sm.n_kv_heads, dh, False, randn,
                what="seamless cross-attention at prefill")
    flash_entry(results, "flash_attention.cross_decode", MAX_BATCH, 1, S, H,
                sm.n_kv_heads, dh, False, randn, n_sets=Ld,
                what="seamless cross-attention at decode")
    lv = get_config(VLM_ARCH)
    T = lv.frontend_tokens + FLASH_T
    flash_entry(results, "flash_attention.vlm", 1, T, T, lv.n_heads,
                lv.n_kv_heads, lv.resolved_head_dim, True, randn,
                what="llava prefill, image + prompt")
    ph = get_config("phi3-mini-3.8b")
    flash_entry(results, "flash_attention.phi3", 1, FLASH_T, FLASH_T,
                ph.n_heads, ph.n_kv_heads, ph.resolved_head_dim, True, randn,
                what="phi3 prefill")
    paged_entries(results, lv.n_heads, lv.n_kv_heads, lv.resolved_head_dim,
                  lv.n_layers, ".g4d128", rng, randn)
    paged_entries(results, ph.n_heads, ph.n_kv_heads, ph.resolved_head_dim,
                  ph.n_layers, ".g1d96", rng, randn, grans=("page",))
    fused_entry(results, lv.n_heads, lv.n_kv_heads, lv.resolved_head_dim,
                lv.n_layers, ".g4d128", rng, randn, max_seq=VLM_MAX_SEQ)
    fused_entry(results, H, sm.n_kv_heads, dh, Ld, ".g1d64", rng, randn)
    pool = randn(ph.n_layers, 80, 64, ph.n_kv_heads, ph.resolved_head_dim)
    check_copies(pool, rng, randn, "phi3-mini-3.8b")
    time_copies(pool, rng, "phi3-mini-3.8b")
    del pool
    torch.cuda.empty_cache()


def ssd_bound(B, T, nh, hd, N, Q, with_h0, G):
    """Bytes (x in bf16 and B, C at their G groups in bf16, dt and A in f32
    read once; y and the final state in f32 written once; h0 read once)
    and operations (C B^T and the scores times dt x over each chunk's
    causal pairs, the carried term and the state update) of one SSD-scan
    call."""
    nbytes = (2 * B * T * (nh * hd + 2 * G * N) + 4 * B * T * nh + 4 * nh
              + 4 * B * T * nh * hd + 4 * B * nh * hd * N * (1 + with_h0))
    pairs = Q * (Q + 1) // 2 * (T // Q)
    flops = B * nh * (2 * pairs * (N + hd) + 4 * T * N * hd)
    return bound_ms(nbytes, flops)


def phase_ssd_kernel(results):
    """The SSD scan against its plain version at the prefill shapes of the
    recurrent families' main paths (``repro_torch.launch.ssd_phases.cases``):
    (a') zamba2-1.2b with its one B/C group, the main path's call, timed
    with its plain version for the kernels line; (a) the same head-expanded
    (G = 64, the first port's interface); (b) mamba2-1.3b (N = 128, one
    group); (c) zamba2 with an initial state carried in over 192-row
    chunks.  Each is timed beside its bound."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.ssd_phases import cases as ssd_cases
    name = "ssd_scan"
    cases = ssd_cases(torch.device("cuda"))
    errs, times = {}, {}
    for key, (args, kw, shape) in cases.items():
        y, h = ops.ssd_scan(*args, **kw)
        y_r, h_r = ref.ssd_scan_ref(*args, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, y_r, **SSD_TOL)
        torch.testing.assert_close(h, h_r, **SSD_TOL)
        require(bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
                f"{name} ({key}): non-finite")
        errs[key] = max(float((y - y_r).abs().max()),
                        float((h - h_r).abs().max()))
        times[key] = graph_ms(lambda: ops.ssd_scan(*args, **kw))
    args, kw, shape = cases["a'"]
    b_ms, b_by = ssd_bound(*shape)
    results[name] = dict(
        max_abs_err=max(errs.values()), ms=times["a'"],
        plain_ms=eager_ms(lambda: ref.ssd_scan_ref(*args, **kw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape="B={} T={} nh={} hd={} N={} Q={} h0={} G={} bf16".format(
            *shape))
    r = results[name]
    err_a = errs["a'"]
    rest = " | ".join(
        f"({key}) {cases[key][2]}: kernel_ms {times[key]:.4f} bound_ms "
        f"{ssd_bound(*cases[key][2])[0]:.5f} max_abs_err {errs[key]:.3g}"
        for key in ("a", "b", "c"))
    print(f"[kernel] {name}: (a') zamba2 prefill, grouped: max_abs_err "
          f"{err_a:.3g} | kernel_ms {r['ms']:.4f} plain_ms "
          f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
          f"({r['bound_by']}) library_ms none (no "
          f"single PyTorch call computes an SSD scan) | {r['shape']} | "
          f"{rest} (B, T, nh, hd, N, Q, h0, G)")


def read_counts():
    """Every kernel's launch count and the flash kernel's by call site
    (``flash_attention.<site>``), as the wrappers counted them."""
    from repro_torch.kernels import ops
    return {**ops.launch_counts(), **ops.flash_site_counts()}


def serve_mode(cfg, mode, params=None, device=None, max_seq=MAX_SEQ):
    """One main-path run: the stream served in ``mode`` with the step
    hook, launch counters reset just before and read just after.
    Returns (engine, stream, events, launch counts, wall seconds)."""
    import torch
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, geometry=PoolGeometry(), max_batch=MAX_BATCH,
                        max_seq=max_seq, manager_kind="mosaic",
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
    return eng, stream, events, read_counts(), wall


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
    n_prefix = cfg.frontend_tokens if cfg.family == "vlm" else 0
    require(events.first_len == n_prefix + len(stream[0][1].prompt) + 1,
            f"{mode}: request 0 holds {events.first_len} pool tokens after "
            f"its first decode step, not its {n_prefix} frontend tokens + "
            f"its prompt + 1")
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
    check_prefix_state(cfg, mode, eng, stream)
    if eng.device.type != "cuda":
        return
    path = [k for k in counts if k != "ssd_scan" and (
        k != "paged_attention.fused" or mode == "fused") and (
        cfg.family == "encdec" or not k.startswith("flash_attention."))]
    require(all(counts[k] > 0 for k in path),
            f"{mode}: a kernel of the path never launched: {counts}")
    check_launches(cfg, mode, s, counts, probes=1)


def check_prefix_state(cfg, label, eng, stream):
    """The dense family's prefix cache misses (the stream shares no
    prefix) and parks every completion; the moe family has none (as the
    reference: MoE capacity and MLA latents do not replay bitwise)."""
    s = eng.stats
    if cfg.family == "dense":
        require(s.prefix_misses == len(stream) and s.prefix_parked_pages > 0,
                f"{label}: the prefix cache did not miss and park as "
                f"expected ({s.prefix_misses} misses, "
                f"{s.prefix_parked_pages} parked)")
    else:
        require(eng.prefix is None and not eng.prefix_supported
                and s.prefix_hits == s.prefix_parked_pages == 0,
                f"{label}: the {cfg.family} family must not use the prefix "
                f"cache ({s.prefix_hits} hits, {s.prefix_parked_pages} "
                f"parked)")


def path_launches(cfg):
    """Launches of one prefill and of one decode step of ``cfg``: (flash
    attentions and SSD scans per prefill, paged (or fused) attentions and
    flash attentions per decode step).  Dense, vlm and moe stacks: one
    flash per layer at prefill, one paged per layer at decode; hybrid: its
    shared-block invocations and its Mamba-2 layers; ssm: its layers'
    scans; encdec: the encoder's layers plus the decoder's self- and
    cross-attention at prefill, and per decode step the decoder's paged
    self-attention and flash cross-attention."""
    from repro_torch.models.hybrid import n_invocations
    if cfg.family == "ssm":
        return 0, cfg.n_layers, 0, 0
    if cfg.family == "hybrid":
        return n_invocations(cfg), cfg.n_layers, n_invocations(cfg), 0
    if cfg.family == "encdec":
        e = cfg.encdec
        return e.enc_layers + 2 * e.dec_layers, 0, e.dec_layers, e.dec_layers
    return cfg.n_layers, 0, cfg.n_layers, 0


def site_launches(cfg, admissions, steps):
    """The flash kernel's launches by call site over ``admissions``
    prefills and ``steps`` decode steps: encdec's encoder layers and its
    cross-attention layers at prefill and at each decode step; none for
    the other families."""
    enc = dec = 0
    if cfg.family == "encdec":
        enc, dec = cfg.encdec.enc_layers, cfg.encdec.dec_layers
    return {"flash_attention.encoder": enc * admissions,
            "flash_attention.cross_prefill": dec * admissions,
            "flash_attention.cross_decode": dec * steps}


def check_launches(cfg, label, s, counts, probes=0):
    """Every prefill attention (full or suffix) ran the flash kernel and
    every prefill Mamba-2 layer the SSD scan, every decode self-attention a
    paged kernel (the fused one on steps that read staged pages;
    ``probes``: extra page-kernel calls of the dual probe) and every decode
    cross-attention the flash kernel, every landing the scatter and every
    eviction or park the gather, each for the K and V pools; the flash
    launches of each encdec call site as ``site_launches``."""
    f_pre, ssd_pre, p_step, f_step = path_launches(cfg)
    admissions = s.admit_colds + s.admit_hits
    sites = site_launches(cfg, admissions, s.decode_steps)
    require(all(counts[k] == n for k, n in sites.items())
            and counts["flash_attention"]
            == f_pre * admissions + f_step * s.decode_steps
            and counts["ssd_scan"] == ssd_pre * admissions
            and counts["paged_attention.page"]
            == p_step * (s.decode_steps - s.fused_steps) + probes
            and counts["paged_attention.fused"] == p_step * s.fused_steps
            and counts["page_scatter"] == 2 * s.landings
            and counts["page_gather"] == 2 * s.gathers,
            f"{label}: launches {counts} do not account for "
            f"{s.admit_colds} + {s.admit_hits} prefills (cold + suffix), "
            f"{s.decode_steps} decode steps ({s.fused_steps} fused), "
            f"{s.landings} landings, {s.gathers} gathers ({s.swaps_out} "
            f"evictions, {s.prefix_parked_pages} pages parked)")


def phase_main_path(cfg, modes=MODES, tag="engine", max_seq=MAX_SEQ):
    """Full-width serving runs in each fault mode of ``modes`` on the same
    weights; returns (launch counts summed over the runs, the weights)."""
    import torch
    params = None
    tokens, total = {}, {}
    for mode in modes:
        t0 = time.perf_counter()
        eng, stream, events, counts, wall = serve_mode(cfg, mode, params,
                                                       max_seq=max_seq)
        if params is None:
            n_par = sum(p.numel() for p in eng.lm.parameters())
            print(f"[{tag}] built {describe(cfg, n_par)}; max_seq "
                  f"{max_seq}, pool {eng.cache.pages_per_shard} pages x "
                  f"{eng.page_bytes} B")
            params = dict(eng.lm.state_dict())
        check_mode_run(cfg, mode, eng, stream, events, counts)
        tokens[mode] = {r.rid: list(r.out) for _, r in stream}
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        s = eng.stats
        print(f"[{tag}:{mode}] {s.summary()}")
        print(f"[{tag}:{mode}] measured ({SMI}): wall {wall:.2f}s (with "
              f"build {time.perf_counter() - t0:.2f}s) | decode "
              f"{s.decode_tokens} "
              f"tok in {s.decode_steps} steps: "
              f"{s.decode_tokens / s.decode_s:.1f} tok/s, "
              f"{s.decode_s / s.decode_steps * 1e3:.2f} ms/step | prefill "
              f"{s.prefill_tokens} tok: "
              f"{s.prefill_s / s.prefill_tokens * 1e3:.3f} ms/token | PCIe "
              f"out {s.d2h_bytes} B in {s.d2h_s:.4f}s, in {s.h2d_bytes} B "
              f"in {s.h2d_s:.4f}s | {s.fused_steps} fused steps | dual "
              f"probe {events.probe_frames} frames, max_abs_err "
              f"{events.probe_err:.3g}")
        print(f"[{tag}:{mode}] modeled (link model, clock = measured "
              f"decode): faults {s.faults} in {s.fault_dmas} DMAs, "
              f"transfer {s.transfer_us:.1f}us, hidden "
              f"{s.fault_hidden_us:.1f}us, exposed {s.fault_exposed_us:.1f}"
              f"us, prefetch hit/miss/wasted {s.prefetch_hits}/"
              f"{s.prefetch_misses}/{s.prefetch_wasted}, out (evict + "
              f"park) {s.evict_pages} pages {s.evict_us:.1f}us, fused ready/"
              f"drained {s.fused_ready_pages}/{s.fused_drained_pages}, "
              f"tail {s.fused_tail_us:.1f}us")
        print(f"[{tag}:{mode}] launches: {json.dumps(counts)}")
        del eng
        torch.cuda.empty_cache()
    diff = [m for m in modes if tokens[m] != tokens["sync"]]
    require(not diff, f"{tag}: tokens differ from sync in {diff}")
    print(f"[{tag}] {' == '.join(modes)} on every greedy token")
    return total, params


def lm_agreement(cfg, dev, ref_dev="cpu", ref_dtype=None):
    """``cfg``'s LM on ``dev`` (the kernels, on the card) against the same
    weights on ``ref_dev`` (the plain versions, on the CPU; in
    ``ref_dtype`` where given, so that a long prefill stays quick there):
    prefill of a 100-token prompt padded to two 64-token pages, then two
    decode steps.  vlm prefills random image embeddings (``patch_embeds``,
    from a seed) in front of the prompt, encdec encodes random source
    frames (``src_embeds``): the engine's zero stubs would leave the
    cross-attention nothing to hold.  The reference run takes ``dev``'s
    expert choices (``moe.top_k`` replays them): a router near-tie that
    the two devices break apart would move that token's output far beyond
    any rounding, so the choices are counted instead and at least 90 % of
    the tokens must get the same experts from both.  Logits, both pools
    (MLA: the latent pools) and the decode state (encdec: cross K/V) must
    agree to 2e-2 of their scale, as the bf16 MoE block's card test.
    Returns (share of tokens with the same experts, tokens routed, the
    largest error relative to its scale)."""
    import torch
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.models import moe
    from repro_torch.models.lm import LM
    from repro_torch.serving.kv_cache import ShardedKVCache
    lm = LM(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(0))
    ref_cfg = cfg if ref_dtype is None else dataclasses.replace(
        cfg, dtype=ref_dtype)
    ref_lm = LM(ref_cfg, device=ref_dev)
    ref_lm.load_state_dict({k: v.to(ref_dev)
                            for k, v in lm.state_dict().items()})
    geo = PoolGeometry()
    ptok, fp, T = geo.page_tokens, geo.frame_pages, 100
    n_prefix = cfg.frontend_tokens if cfg.family == "vlm" else 0
    mpps = max(4, -(-(n_prefix + 2 * ptok) // ptok))
    NP = max(2, -(-mpps // fp)) * fp
    rng = np.random.default_rng(9)
    toks = np.zeros((1, 2 * ptok), np.int32)
    toks[0, :T] = rng.integers(0, cfg.vocab_size, T)
    new = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (1, n_prefix, cfg.d_model), dtype=np.float32)
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.standard_normal(
            (1, cfg.encdec.source_len, cfg.d_model), dtype=np.float32)
    choices, same = [], []
    top_k = moe.top_k

    def record(probs, k):
        vals, idx = top_k(probs, k)
        choices.append(idx)
        return vals, idx

    def replay(probs, k):
        idx = choices[len(same)].to(probs.device)
        own = top_k(probs, k)[1]
        same.append((own.sort(-1).values == idx.sort(-1).values)
                    .all(-1).reshape(-1))
        return torch.gather(probs, -1, idx), idx
    runs = []
    for d, model, hook in ((dev, lm, record), (ref_dev, ref_lm, replay)):
        cache = ShardedKVCache(geo, NP, 1)
        cache.allocate(0, n_prefix + T)
        pools = tuple(torch.zeros(sh, dtype=dt, device=d) for sh, dt in
                      model.pool_shapes(NP, ptok, dtype=getattr(
                          torch, model.cfg.dtype)))
        moe.top_k = hook
        try:
            logits, pools, state = model.prefill(
                {k: torch.from_numpy(v).to(d) for k, v in batch.items()},
                pools, cache.pack_ctx([0], mpps, device=d),
                last_pos=torch.tensor([T - 1], device=d))
            out = [logits]
            for i in range(2):
                cache.append(0)
                logits, pools, state = model.decode_step(
                    torch.from_numpy(new[i:i + 1]).to(d),
                    torch.tensor([n_prefix + T + i], device=d), pools,
                    cache.pack_ctx([0], mpps, device=d), state)
                out.append(logits)
        finally:
            moe.top_k = top_k
        runs.append((out, pools, [state[k] for k in sorted(state)]))
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    agree = float(torch.cat(same).float().mean()) if same else 1.0
    require(agree >= 0.9, f"agreement: the two devices route only "
            f"{agree:.1%} of the tokens to the same experts")
    errs = []
    for what, got, want in (
            [(f"logits {i}", a, b)
             for i, (a, b) in enumerate(zip(runs[0][0], runs[1][0]))]
            + [(f"pool {i}", a, b)
               for i, (a, b) in enumerate(zip(runs[0][1], runs[1][1]))]
            + [(f"state {i}", a, b)
               for i, (a, b) in enumerate(zip(runs[0][2], runs[1][2]))]):
        got, want = got.to(ref_dev).float(), want.float()
        require(bool(torch.isfinite(got).all()) and got.shape == want.shape,
                f"agreement: {what}: non-finite or shape {got.shape}")
        err, scale = (float((got - want).abs().max()),
                      float(want.abs().max()))
        require(err <= 2e-2 * scale, f"agreement: {what}: max_abs_err "
                f"{err:.3g} beyond 2e-2 of its scale {scale:.3g}")
        errs.append(err / scale)
    layers = (f"{cfg.encdec.enc_layers} + {cfg.encdec.dec_layers} layers"
              if cfg.family == "encdec" else f"{cfg.n_layers} layers")
    print(f"[agreement] {cfg.name} ({layers}, d_model {cfg.d_model}, "
          f"{cfg.dtype}) on {dev} vs the plain versions on {ref_dev} "
          f"({ref_cfg.dtype}): prefill of {n_prefix} image + {T} prompt "
          f"tokens, 2 decode steps: logits, pools"
          f"{' and cross K/V' if runs[0][2] else ''} within {max(errs):.3g} "
          f"of their scale; same experts for {agree:.1%} of "
          f"{sum(len(x) for x in same)} routed tokens")
    return agree, sum(len(x) for x in same), max(errs)


def check_agreement(cut, ref_dtype=None):
    """``lm_agreement`` of ``cut`` on the card, with its launches: one
    prefill and two decode steps of ``path_launches``."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    lm_agreement(cut, "cuda", ref_dtype=ref_dtype)
    n = read_counts()
    f_pre, _, p_step, f_step = path_launches(cut)
    sites = site_launches(cut, 1, 2)
    require(n["flash_attention"] == f_pre + 2 * f_step
            and n["paged_attention.page"] == 2 * p_step
            and all(n[k] == m for k, m in sites.items()),
            f"agreement: launches {n}, not {f_pre} + 2 x {f_step} flash "
            f"({sites} by site) and 2 x {p_step} paged")
    torch.cuda.empty_cache()


def phase_mla_serving():
    """Phase 4e: deepseek-v2-lite at full width cut to 2 layers, on the
    card against the CPU (``lm_agreement``); then at its published width
    and depth (MLA over latent pools, 64-expert MoE after one dense-FFN
    layer) through phase 4's stream and step hook, in sync and async;
    fused is refused, as in the reference.  Returns the summed launch
    counts of the serving runs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config(MLA_ARCH)
    # The whole model at full width, cut to its dense layer and one MoE
    # layer, on the card against the CPU's plain versions.
    check_agreement(dataclasses.replace(cfg, n_layers=2))
    try:
        ServingEngine(cfg, geometry=PoolGeometry(), max_batch=MAX_BATCH,
                      max_seq=MAX_SEQ, fault_mode="fused")
    except ValueError as exc:
        print(f"[mla] fault_mode='fused' refused: {exc}")
    else:
        raise SmokeFailure("mla: fault_mode='fused' was not refused")
    total, params = phase_main_path(cfg, SSM_MODES, tag="mla")
    del params
    torch.cuda.empty_cache()
    return total


def serve_prefix(cfg, mode, prefix_cache, params=None, device=None):
    """One phase-4b run: the two waves served in ``mode``, the second
    submitted once the first has drained, launch counters reset just
    before and read just after.  Returns (engine, requests, launch counts,
    wall seconds)."""
    import torch
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, geometry=PoolGeometry(), max_batch=MAX_BATCH,
                        max_seq=MAX_SEQ, fault_mode=mode,
                        prefix_cache=prefix_cache, seed=0, params=params,
                        device=device)
    waves = make_prefix_waves(cfg.vocab_size)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for wave in waves:
        for r in wave:
            eng.submit(r)
        eng.run_until_drained(max_steps=400)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, waves[0] + waves[1], read_counts(), wall


def check_prefix_run(cfg, label, eng, reqs, counts):
    """What every phase-4b run must show, on the card or (counts all 0)
    rehearsed on the CPU."""
    s = eng.stats
    require(all(r.done and len(r.out) == r.max_new
                and all(0 <= t < cfg.vocab_size for t in r.out)
                for r in reqs), f"{label}: a request did not complete")
    eng.cache.check_invariants()
    require(s.admit_hits + s.admit_colds == len(reqs),
            f"{label}: {s.admit_hits} + {s.admit_colds} admissions for "
            f"{len(reqs)} requests")
    require(s.h2d_bytes == s.faults * eng.page_bytes,
            f"{label}: {s.h2d_bytes} B copied to the card for {s.faults} "
            f"faulted pages")
    if eng.prefix is not None:
        require(s.prefix_hits >= 4 and s.admit_hits == s.prefix_hits,
                f"{label}: {s.prefix_hits} prefix hits, expected >= 4")
        require(s.faults >= s.prefix_reused_tokens // eng.geo.page_tokens,
                f"{label}: reused pages did not fault in")
        require(s.prefix_h2d_bytes == s.prefix_reused_tokens
                // eng.geo.page_tokens * eng.page_bytes,
                f"{label}: cached prefix uploaded {s.prefix_h2d_bytes} B")
    if eng.device.type != "cuda":
        return
    require(counts["flash_attention"] > 0 and counts["paged_attention.page"]
            > 0 and (eng.prefix is None or counts["page_scatter"] > 0
                     and counts["page_gather"] > 0),
            f"{label}: a kernel of the path never launched: {counts}")
    check_launches(cfg, label, s, counts)


def serve_stream(cfg, mode, n_requests=8, params=None, device=None):
    """One phase-4c/4d/4f run: the first ``n_requests`` of the main path's
    stream served by ``cfg`` (hybrid, ssm or moe) in ``mode`` with phase
    4's pool and no step hook, launch counters reset just before and read
    just after.  Returns (engine, stream, launch counts, wall seconds)."""
    import torch
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, geometry=PoolGeometry(), max_batch=MAX_BATCH,
                        max_seq=MAX_SEQ, manager_kind="mosaic",
                        oversubscription=OVERSUB, fault_mode=mode, seed=0,
                        params=params, device=device)
    stream = make_stream(cfg.vocab_size)[:n_requests]
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    drive(eng, stream)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, stream, read_counts(), wall


def check_stream_run(cfg, label, eng, stream, counts):
    """What every phase-4c/4d/4f run must show, on the card or (counts
    all 0) rehearsed on the CPU."""
    s = eng.stats
    require(all(r.done for _, r in stream), f"{label}: not every request "
            f"completed")
    for _, r in stream:
        require(len(r.out) == r.max_new
                and all(0 <= tok < cfg.vocab_size for tok in r.out),
                f"{label}: request {r.rid}: bad output {r.out[:8]}...")
    require(not eng.states, f"{label}: recurrent state of finished "
            f"requests was kept: {sorted(eng.states)}")
    check_prefix_state(cfg, label, eng, stream)
    if cfg.family == "ssm":
        require(eng.pools is None and s.h2d_bytes == s.d2h_bytes == 0,
                f"{label}: the ssm family moved KV bytes")
    else:
        require(s.h2d_bytes == s.faults * eng.page_bytes,
                f"{label}: {s.h2d_bytes} B copied to the card for "
                f"{s.faults} faulted pages of {eng.page_bytes} B")
    if cfg.family == "hybrid":
        require(s.swaps_out >= 1 and s.faults >= 1,
                f"{label}: paging not exercised: swaps {s.swaps_out} "
                f"faults {s.faults}")
    if eng.device.type != "cuda":
        return
    path = {"ssm": ["ssd_scan"],
            "hybrid": ["ssd_scan", "flash_attention", "paged_attention.page",
                       "page_gather", "page_scatter"],
            "moe": ["flash_attention", "paged_attention.page"],
            "dense": ["flash_attention", "paged_attention.page"]}[cfg.family]
    require(all(counts[k] > 0 for k in path),
            f"{label}: a kernel of the path never launched: {counts}")
    check_launches(cfg, label, s, counts)


def describe(cfg, n_par):
    """The [<tag>] built line's model: published widths, depth (and its
    cut), parameters."""
    from repro_torch.configs import get_config
    full = get_config(cfg.name).n_layers
    depth = (f"{cfg.n_layers} layers" if cfg.n_layers == full else
             f"depth-cut to {cfg.n_layers} of {full} layers")
    if cfg.family == "moe":
        mo = cfg.moe
        body = (f"{mo.n_experts} experts top-{mo.top_k} of {mo.d_expert}"
                f"{f' + {mo.n_shared} shared' if mo.n_shared else ''}")
    elif cfg.family in ("ssm", "hybrid"):
        body = f"Mamba-2, d_state {cfg.ssm.d_state}"
    else:
        body = (f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of "
                f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}"
                f"{', qk-norm' if cfg.qk_norm else ''}")
        if cfg.family == "vlm":
            body += f", {cfg.frontend_tokens} image tokens"
        if cfg.family == "encdec":
            e = cfg.encdec
            depth = (f"{e.enc_layers} encoder + {e.dec_layers} decoder "
                     f"layers")
            body += f", source_len {e.source_len}"
    return (f"{cfg.name} at its published widths ({depth}, d_model "
            f"{cfg.d_model}, {body}, vocab {cfg.vocab_size}, {cfg.dtype}, "
            f"{n_par / 1e9:.3f} G parameters)")


def phase_stream(cfg, modes, n_requests, tag=None):
    """Phases 4c (hybrid), 4d (ssm), 4f (moe) and 4i (dense): ``cfg``
    served in each of ``modes`` on the same weights, with the card's
    memory high-water mark of each run; returns the launch counts summed
    over the runs."""
    import torch
    tag = tag or cfg.family
    params = None
    tokens, total = {}, {}
    for mode in modes:
        torch.cuda.reset_peak_memory_stats()
        eng, stream, counts, wall = serve_stream(cfg, mode, n_requests,
                                                 params)
        if params is None:
            pool = ("no KV pool" if eng.pools is None else
                    f"pool {eng.cache.pages_per_shard} pages x "
                    f"{eng.page_bytes} B")
            n_par = sum(p.numel() for p in eng.lm.parameters())
            print(f"[{tag}] built {describe(cfg, n_par)}; {pool}")
            params = dict(eng.lm.state_dict())
        label = f"{tag}:{mode}"
        check_stream_run(cfg, label, eng, stream, counts)
        tokens[mode] = {r.rid: list(r.out) for _, r in stream}
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        s = eng.stats
        print(f"[{label}] {s.summary()}")
        print(f"[{label}] measured ({SMI}): wall {wall:.2f}s | decode "
              f"{s.decode_tokens} tok in {s.decode_steps} steps: "
              f"{s.decode_s / s.decode_steps * 1e3:.2f} ms/step | prefill "
              f"{s.prefill_tokens} tok in {s.admit_colds} admissions: "
              f"{s.prefill_s / s.prefill_tokens * 1e3:.4f} ms per prompt "
              f"token | PCIe out {s.d2h_bytes} B in {s.d2h_s:.4f}s, in "
              f"{s.h2d_bytes} B in {s.h2d_s:.4f}s | {s.fused_steps} fused "
              f"steps | card memory high-water mark "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        print(f"[{label}] launches: {json.dumps(counts)}")
        del eng
        torch.cuda.empty_cache()
    diff = [m for m in modes if tokens[m] != tokens[modes[0]]]
    require(not diff, f"{tag}: tokens differ from {modes[0]} in {diff}")
    print(f"[{tag}] {' == '.join(modes)} on every greedy token")
    return total


def row_probe(cfg):
    """The reason prefill runs on fixed row blocks (``PREFILL_ROWS``): the
    last 64 rows of a 576-row bf16 product over the FFN's d_ff inputs,
    against the same 64 rows multiplied alone.  Prints whether the library
    gave them the same bits; checks nothing."""
    import torch
    from repro_torch.models.transformer import PREFILL_ROWS
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((576, cfg.d_ff), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = torch.randn((cfg.d_ff, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    whole, alone = (x @ w)[512:], x[512:] @ w
    torch.cuda.synchronize()
    diff = float((whole.float() - alone.float()).abs().max())
    print(f"[prefix] row invariance of a bf16 product over {cfg.d_ff} "
          f"inputs: rows 512..575 of a 576-row product vs the same 64 rows "
          f"alone: bitwise {torch.equal(whole, alone)}, max abs diff "
          f"{diff:.4g} (prefill therefore multiplies fixed "
          f"{PREFILL_ROWS}-row blocks)")


def phase_prefix(cfg, params):
    """Phase 4b: the prefix cache at full width (see the module doc)."""
    import torch
    row_probe(cfg)
    runs = [("sync", True), ("async", True), ("fused", True),
            ("async", False)]
    tokens, stats = {}, {}
    for mode, on in runs:
        label = f"prefix:{mode}:{'on' if on else 'off'}"
        eng, reqs, counts, wall = serve_prefix(cfg, mode, on, params)
        check_prefix_run(cfg, label, eng, reqs, counts)
        s = eng.stats
        tokens[label] = {r.rid: list(r.out) for r in reqs}
        stats[on] = s
        prompt = sum(len(r.prompt) for r in reqs)
        print(f"[{label}] {s.summary()}")
        print(f"[{label}] measured: wall {wall:.2f}s | prefill "
              f"{s.prefill_tokens} of {prompt} prompt tok in "
              f"{s.prefill_s:.3f}s + cached prefix upload "
              f"{s.prefix_h2d_bytes} B in {s.prefix_h2d_s:.4f}s: "
              f"{(s.prefill_s + s.prefix_h2d_s) / prompt * 1e3:.4f} ms per "
              f"prompt token | admissions {s.admit_colds} cold "
              f"{s.admit_cold_mean_us() / 1e3:.1f} ms, {s.admit_hits} hit "
              f"{s.admit_hit_mean_us() / 1e3:.1f} ms mean | decode "
              f"{s.decode_s / s.decode_steps * 1e3:.2f} ms/step")
        print(f"[{label}] launches: {json.dumps(counts)}")
        del eng
        torch.cuda.empty_cache()
    first = next(iter(tokens.values()))
    diff = [k for k, t in tokens.items() if t != first]
    require(not diff, f"prefix cache: tokens differ in {diff}")
    on, off = stats[True], stats[False]
    require(on.prefill_tokens == off.prefill_tokens
            - on.prefix_reused_tokens,
            f"prefix cache: prefill tokens {on.prefill_tokens} (on) != "
            f"{off.prefill_tokens} (off) - {on.prefix_reused_tokens} reused")
    print(f"[prefix] cache on (sync, async, fused) == off on every greedy "
          f"token; {on.prefix_hits} hits reused {on.prefix_reused_tokens} "
          f"tokens: prefill {on.prefill_tokens} vs {off.prefill_tokens} "
          f"tokens")


def narrow_config(cfg_full):
    """Phases 5 and 8d: a narrow f32 model (2 layers, head dim 32, which
    the card's kernels take)."""
    return dataclasses.replace(cfg_full, n_layers=2, d_model=128, n_heads=4,
                               n_kv_heads=2, d_ff=256, vocab_size=512,
                               dtype="float32")


def phase_small_agreement(cfg_full):
    """A narrow model (head_dim 32) on the card vs the same on the CPU."""
    import torch
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.serving.engine import ServingEngine
    cfg = narrow_config(cfg_full)
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


# ---------------------------------------------------------------- cluster


def cluster_requests(vocab: int):
    """Phase 8's traffic: phase 4b's two shared-prefix waves (rids 0-5),
    then phase 4's stream with its rids moved up by ``CLUSTER_RID`` (rids
    are unique cluster-wide).  Returns (wave 1, wave 2, stream)."""
    wave1, wave2 = make_prefix_waves(vocab)
    stream = make_stream(vocab)
    for _, r in stream:
        r.rid += CLUSTER_RID
    return wave1, wave2, stream


def fault_injector(plan):
    """A ``FaultInjector`` running ``plan``, plus one on-disk bit flip in
    the first frame of engine 0's domain (a request frame) that the tier
    writes: its id is known only once the run spills it.  The flipped byte
    comes from the plan's seeded RNG, as for the plan's own
    ``corrupt_frames``; ``tier`` is set once the cluster exists."""
    from repro_torch.serving.faults import FaultInjector

    class RequestFrameCorruption(FaultInjector):
        tier = None

        def corrupt_written(self, frame, blob):
            if (not self.plan.corrupt_frames and self.tier is not None
                    and self.tier.frames._frame_owner.get(frame) == 0):
                self.plan = dataclasses.replace(self.plan,
                                                corrupt_frames=(frame,))
            return super().corrupt_written(frame, blob)

    return RequestFrameCorruption(plan)


class ClusterRun:
    """Runs one ``ServingCluster`` through phase 8 (device-agnostic, also
    run on the CPU).  Each router step is timed on the host clock and
    followed by ``check_invariants()``.  Each work-stealing migration
    snapshots the host payloads the source engine gathered; once the
    request has decoded on the destination, its pages in the destination's
    pool must hold those bytes (as phase 7's round trip).  Promotes from
    the spill tier are timed on the host clock (disk read and checksum)."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.step_s = []
        self.promote_s = 0.0
        self.pending = []     # (rid, dst, payloads, tokens, outputs so far)
        self.landed = []      # (rid, pages) whose landing was checked
        self.stream_start = 0
        self.after_crash = None   # the host tier's leases after a crash
        self.built_bytes = 0      # card memory once the cluster is built
        self.e1_parked_before_wave2 = 0
        self.e1_hits_wave2 = 0
        migrate = cluster.router._migrate
        promote = cluster.tier._promote_frame

        def _migrate(rid, src, dst):
            migrate(rid, src, dst)
            store = cluster.tier.store
            req = next(r for r in dst.preempted if r.rid == rid)
            self.pending = [p for p in self.pending if p[0] != rid]
            self.pending.append((rid, dst, {k: store.peek(*k) for k in
                                            cluster.tier.seq_pages(rid)},
                                 dst._saved_tokens[rid], len(req.out)))

        def _promote_frame(f):
            t0 = time.perf_counter()
            try:
                return promote(f)
            finally:
                self.promote_s += time.perf_counter() - t0

        cluster.router._migrate = _migrate
        cluster.tier._promote_frame = _promote_frame

    def busy(self) -> bool:
        router = self.cluster.router
        return bool(router.pending) or any(router._busy(e)
                                           for e in self.cluster.engines)

    def step(self) -> None:
        from repro_torch.serving.cluster import PREFIX_DOMAIN
        router, frames = self.cluster.router, self.cluster.tier.frames
        crashes = router.stats.crashes
        t0 = time.perf_counter()
        self.cluster.step()
        self.step_s.append(time.perf_counter() - t0)
        self.cluster.check_invariants()
        if router.stats.crashes > crashes:
            dead = [e.engine_id for e in self.cluster.engines if not e.alive]
            self.after_crash = {
                "dead_engine_frames": sum(frames.frames_of(d) for d in dead),
                "prefix_frames": frames.frames_of(PREFIX_DOMAIN),
                "recovered_bundles": router.stats.recovered_bundles}
        self._check_landings()

    def drain(self, max_steps: int = 2000) -> None:
        for _ in range(max_steps):
            if not self.busy():
                break
            self.step()
        require(not self.busy(), f"cluster not drained in {max_steps} steps")
        self.cluster.run_until_drained()    # settles the DMA lanes only

    def _check_landings(self) -> None:
        import torch
        for item in list(self.pending):
            rid, dst, snap, tokens, n_out = item
            if not dst.alive:
                self.pending.remove(item)
                continue
            req = next((r for r in dst.active if r.rid == rid), None)
            if req is None or len(req.out) <= n_out:
                continue
            ptok, pps = dst.geo.page_tokens, dst.cache.pages_per_shard
            for (_o, s, vpn), (kp, vp) in snap.items():
                ppn = s * pps + dst.cache.mgrs[s].tables[rid].ppn[vpn]
                n = min(ptok, tokens - vpn * ptok)
                require(torch.equal(dst.pools[0][:, ppn, :n].cpu(), kp[:, :n])
                        and torch.equal(dst.pools[1][:, ppn, :n].cpu(),
                                        vp[:, :n]),
                        f"migration: page {vpn} of request {rid} landed on "
                        f"engine {dst.engine_id} differs from the payload "
                        f"the source gathered")
            self.landed.append((rid, len(snap)))
            self.pending.remove(item)


def serve_cluster(cfg, device=None, plan=None, weights=None):
    """One phase-8 run: ``CLUSTER_ENGINES`` replicas sharing one LM
    (weights from seed 0), a shared host tier of ``CLUSTER_FRAMES`` frames
    over a disk spill directory, the shared prefix index, migration,
    pre-staging and the radix translation meter, async fault-in, phase 4's
    pool per engine and ``decode_window_us`` = ``CLUSTER_WINDOW_US`` (the
    router's costs come from the modeled clock).  Wave 1 is pinned to
    engine 0; wave 2 is routed once wave 1 has drained; then the stream,
    pinned to engine 0 (it preempts under the priority arrivals while
    engine 1 has room, so engine 1 steals).  ``plan``: a ``FaultPlan``
    run by :func:`fault_injector`.  ``weights``: a state dict loaded into
    the replicas' one LM in place of the seed's.  Launch counters are
    reset just before the traffic and read just after.  Returns (run,
    requests, launch counts, wall seconds)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.kernels import ops
    from repro_torch.serving.cluster import ServingCluster
    inj = None if plan is None else fault_injector(plan)
    spill_dir = tempfile.mkdtemp(prefix="chip-smoke-spill-")
    try:
        cluster = ServingCluster(
            cfg, geometry=PoolGeometry(), n_engines=CLUSTER_ENGINES,
            max_batch=MAX_BATCH, max_seq=MAX_SEQ, manager_kind="mosaic",
            seed=0, share_host=True, share_prefix=True, migrate=True,
            router_prestage=True, capacity_frames=CLUSTER_FRAMES,
            spill_dir=spill_dir, fault_injector=inj,
            oversubscription=OVERSUB, decode_window_us=CLUSTER_WINDOW_US,
            translation="radix", device=device)
        if inj is not None:
            inj.tier = cluster.tier
        if weights is not None:
            cluster.engines[0].lm.load_state_dict(weights)
        run = ClusterRun(cluster)
        if cluster.engines[0].device.type == "cuda":
            # Weights and pools are in place: what the card holds now, and
            # the high-water mark of serving from here on.
            torch.cuda.synchronize()
            run.built_bytes = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        wave1, wave2, stream = cluster_requests(cfg.vocab_size)
        e1 = cluster.engines[1]
        if device is None or torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for r in wave1:
            cluster.submit(r, engine=0)
        run.drain()
        run.e1_parked_before_wave2 = e1.stats.prefix_parked_pages
        for r in wave2:
            cluster.submit(r)
        run.drain()
        run.e1_hits_wave2 = e1.stats.prefix_hits
        run.stream_start = cluster.router._step_no
        pending = sorted(stream, key=lambda a: a[0])
        step = 0
        while pending or run.busy():
            require(step < 2000, "cluster: the stream did not drain")
            while pending and pending[0][0] <= step:
                cluster.submit(pending.pop(0)[1], engine=0)
            run.step()
            step += 1
        run.drain()
        if device is None or torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        cluster.tier.spill_store.close()
    finally:
        shutil.rmtree(spill_dir, ignore_errors=True)
    return run, wave1 + wave2 + [r for _, r in stream], counts, wall


def cluster_signature(run, reqs):
    """What two runs of one phase-8 configuration must reproduce: tokens
    per request, the router's decisions, the frame table's, the tier's and
    the spill store's counters, each engine's translation counters and
    the injector's log."""
    c = run.cluster
    inj = c.fault_injector
    return {
        "tokens": {r.rid: list(r.out) for r in reqs},
        "router": dataclasses.asdict(c.router.stats),
        "frames": dict(c.tier.frames.stats),
        "tier": dict(c.tier.stats),
        "spill": dict(c.tier.spill_store.stats),
        "translation": [(e.stats.translation_lookups,
                         e.stats.translation_tlb_hits,
                         e.stats.translation_walks,
                         e.stats.translation_walk_cycles,
                         e.stats.translation_queue_cycles,
                         e.stats.translation_us) for e in c.engines],
        "injector": None if inj is None else list(inj.log),
    }


def check_cluster_run(cfg, label, run, reqs, counts, faulted=False):
    """What every phase-8 run must show, on the card or (counts all 0)
    rehearsed on the CPU: 8a's gates, or 8b's with ``faulted``."""
    c = run.cluster
    r, tier, ts = c.router.stats, c.tier, c.tier.stats
    t = c.stats().totals
    for q in reqs:
        require(q.done and len(q.out) == q.max_new
                and all(0 <= tok < cfg.vocab_size for tok in q.out),
                f"{label}: request {q.rid} did not complete its "
                f"{q.max_new} tokens")
    require(all(e.lm is c.engines[0].lm for e in c.engines),
            f"{label}: the replicas do not share one LM")
    require(all(r.dispatched.get(i, 0) > 0 for i in range(len(c.engines))),
            f"{label}: not every engine was dispatched to: {r.dispatched}")
    require(all(e.stats.translation_lookups > 0 for e in c.engines),
            f"{label}: an engine's translation meter saw no lookup")
    require(ts["spilled_frames"] >= 1 and (
        faulted or ts["promoted_frames"] >= 1),
            f"{label}: {ts['spilled_frames']} frames spilled, "
            f"{ts['promoted_frames']} promoted back")
    require(run.e1_parked_before_wave2 == 0 and run.e1_hits_wave2 >= 1
            and c.engines[1].stats.landings >= 1,
            f"{label}: engine 1 parked {run.e1_parked_before_wave2} pages "
            f"before wave 2 and hit the shared index {run.e1_hits_wave2} "
            f"times in it: no cross-engine prefix reuse")
    admissions = t.admit_colds + t.admit_hits
    if not faulted:
        require(r.migrations >= 1 and r.migrated_pages > 0
                and tier.frames.stats["whole_frame_moves"] >= 1,
                f"{label}: {r.migrations} migrations ({r.migrated_pages} "
                f"pages, {tier.frames.stats['whole_frame_moves']} "
                f"whole-frame owner flips)")
        require(run.landed and not run.pending,
                f"{label}: migrated pages not checked on the destination: "
                f"{[p[0] for p in run.pending]}")
        require(admissions == len(reqs) and t.lost_restarts == 0,
                f"{label}: {admissions} admissions for {len(reqs)} "
                f"requests: a migration re-prefilled")
    else:
        dead = [e.engine_id for e in c.engines if not e.alive]
        require(r.crashes == 1 and dead == [1]
                and run.stream_start < c.fault_injector.plan.engine_crashes[
                    0][0],
                f"{label}: crashes {r.crashes}, dead engines {dead}")
        after = run.after_crash
        require(after is not None and after["dead_engine_frames"] == 0
                and after["prefix_frames"] >= 1
                and after["recovered_bundles"] >= 1
                and tier.frames.frames_of(1) == 0,
                f"{label}: after the crash {after}: the dead engine must "
                f"hold no host frame (its preempted requests re-leased "
                f"whole to the survivor, the rest reclaimed) while the "
                f"prefix frames survive")
        require(ts["disk_retries"] >= 1 and ts["frames_quarantined"] >= 1
                and t.lost_restarts >= 1,
                f"{label}: {ts['disk_retries']} retries, "
                f"{ts['frames_quarantined']} quarantined frames, "
                f"{t.lost_restarts} lost-payload restarts")
    if counts.get("flash_attention", 0) == 0 and not counts.get(
            "paged_attention.page"):
        return                                  # rehearsed on the CPU
    require(all(counts[k] > 0 for k in (
        "flash_attention", "paged_attention.page", "page_gather",
        "page_scatter")), f"{label}: a kernel of the path never launched: "
            f"{counts}")
    check_launches(cfg, label, t, counts)


def print_cluster_run(label, run, wall):
    import torch
    c = run.cluster
    for line in c.stats().summary().splitlines():
        print(f"[{label}] {line}")
    ms = np.asarray(run.step_s) * 1e3
    engines = " | ".join(
        f"engine {e.engine_id}: {e.stats.decode_steps} decode steps, "
        f"{e.stats.wall_s / max(e.stats.decode_steps, 1) * 1e3:.2f} ms/step "
        f"(decode {e.stats.decode_s / max(e.stats.decode_steps, 1) * 1e3:.2f})"
        for e in c.engines)
    mem = (f" | card memory high-water mark "
           f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
           if c.engines[0].device.type == "cuda" else "")
    print(f"[{label}] measured ({SMI}): wall {wall:.2f}s | {len(ms)} router "
          f"steps: {ms.mean():.2f} ms mean, {ms.max():.2f} max (host clock) "
          f"| {engines} | promotes {c.tier.stats['promoted_frames']}, "
          f"quarantined {c.tier.stats['frames_quarantined']}: frame reads "
          f"{run.promote_s * 1e3:.1f} ms (host clock), promote stall "
          f"{c.tier.stats['promote_us']:.0f} us (modeled){mem}")
    meters = [(e.stats.translation_lookups, e.stats.translation_walks)
              for e in c.engines]
    print(f"[{label}] migrations checked on the destination: "
          f"{run.landed}; translation per engine (lookups, walks): {meters}")


def check_one_copy(label, run, w_bytes):
    """The replicas hold one copy of the weights: the card's memory once
    the cluster is built, and its high-water mark while serving, stay
    below what a second copy would take."""
    import torch
    peak = torch.cuda.max_memory_allocated()
    require(run.built_bytes < 1.5 * w_bytes and peak < 2 * w_bytes,
            f"{label}: card memory {run.built_bytes / 2**30:.2f} GiB once "
            f"built, {peak / 2**30:.2f} GiB at most while serving: more "
            f"than one weight copy of {w_bytes / 2**30:.2f} GiB")


def free_cluster(run):
    """Drop a run's cluster (``ClusterRun`` wraps its router and tier in
    closures that refer back to it, so only the collector frees it) and
    return its memory to the card."""
    import gc
    import torch
    run.cluster = None
    gc.collect()
    torch.cuda.empty_cache()


def crash_plan(stream_start):
    """Phase 8b's seeded plan: engine 1 dies ``CRASH_AFTER`` router steps
    into the stream, and disk reads fail transiently at
    ``READ_ERROR_RATE`` (the tier retries); ``fault_injector`` adds the
    corrupted request frame."""
    from repro_torch.serving.faults import FaultPlan
    return FaultPlan(seed=0,
                     engine_crashes=((stream_start + CRASH_AFTER, 1),),
                     disk_read_error_rate=READ_ERROR_RATE)


def phase_cluster(cfg):
    """Phase 8a-8b at full width; returns the summed launch counts."""
    import torch
    total = {}
    sigs = []
    for i in range(2):
        run, reqs, counts, wall = serve_cluster(cfg)
        label = f"cluster:a{i + 1}"
        if i == 0:
            params = list(run.cluster.engines[0].lm.parameters())
            n_par = sum(p.numel() for p in params)
            w_bytes = sum(p.numel() * p.element_size() for p in params)
            del params
            peak = torch.cuda.max_memory_allocated()
            print(f"[cluster] built {describe(cfg, n_par)}; "
                  f"{CLUSTER_ENGINES} engines on one LM "
                  f"({w_bytes / 2**30:.2f} GiB of weights), each a pool of "
                  f"{run.cluster.engines[0].cache.pages_per_shard} pages x "
                  f"{run.cluster.engines[0].page_bytes} B; host tier "
                  f"{CLUSTER_FRAMES} frames over a spill directory; card "
                  f"memory {run.built_bytes / 2**30:.2f} GiB once built, "
                  f"high-water mark {peak / 2**30:.2f} GiB while serving")
        check_one_copy(label, run, w_bytes)
        check_cluster_run(cfg, label, run, reqs, counts)
        print_cluster_run(label, run, wall)
        print(f"[{label}] launches: {json.dumps(counts)}")
        sigs.append(cluster_signature(run, reqs))
        stream_start = run.stream_start
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        free_cluster(run)
        del run
    diff = [k for k in sigs[0] if sigs[0][k] != sigs[1][k]]
    require(not diff, f"cluster: two runs differ in {diff}")
    print("[cluster] two runs: identical tokens, router decisions, frame "
          "table, tier, spill and translation counters")
    plan = crash_plan(stream_start)
    run, reqs, counts, wall = serve_cluster(cfg, plan=plan)
    check_one_copy("cluster:b", run, w_bytes)
    check_cluster_run(cfg, "cluster:b", run, reqs, counts, faulted=True)
    print_cluster_run("cluster:b", run, wall)
    inj = run.cluster.fault_injector
    print(f"[cluster:b] plan {inj.plan} | injector {inj.stats} | tier "
          f"retries {run.cluster.tier.stats['disk_retries']}, quarantined "
          f"{run.cluster.tier.stats['frames_quarantined']}, reclaimed "
          f"{run.cluster.tier.stats['reclaimed_frames']} | lost-payload "
          f"restarts {run.cluster.stats().totals.lost_restarts}")
    print(f"[cluster:b] launches: {json.dumps(counts)}")
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n
    free_cluster(run)
    return total


def serve_translation(cfg, translation, manager_kind="mosaic", params=None,
                      device=None):
    """One phase-8c run: phase 4's stream in sync mode without
    oversubscription (so every run forms the same batches) and without the
    step hook, the translation meter in ``translation``.  Returns (engine,
    stream, batches, launch counts)."""
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, geometry=PoolGeometry(), max_batch=MAX_BATCH,
                        max_seq=MAX_SEQ, manager_kind=manager_kind,
                        fault_mode="sync", seed=0, params=params,
                        device=device, translation=translation)
    stream = make_stream(cfg.vocab_size)
    ops.reset_launch_counts()
    batches = drive(eng, stream)
    return eng, stream, batches, read_counts()


def check_translation_runs(runs):
    """Phase 8c's gates over {label: (engine, stream, batches)} for
    ``mosaic:off``, ``mosaic:flat``, ``mosaic:radix`` and
    ``gpu-mmu:radix``; returns the printed line."""
    first = runs["mosaic:off"]
    toks = {k: {r.rid: list(r.out) for _, r in v[1]} for k, v in runs.items()}
    require(all(v[2] == first[2] for v in runs.values()),
            "translation: the runs formed different batches")
    require(all(t == toks["mosaic:off"] for t in toks.values()),
            "translation: the meter changed a token")
    off, flat, radix, gmmu = (runs[k][0].stats for k in (
        "mosaic:off", "mosaic:flat", "mosaic:radix", "gpu-mmu:radix"))
    require(off.translation_lookups == 0
            and flat.translation_lookups == radix.translation_lookups > 0
            and radix.translation_walks <= flat.translation_walks,
            f"translation: lookups off/flat/radix {off.translation_lookups}"
            f"/{flat.translation_lookups}/{radix.translation_lookups}, walks "
            f"flat {flat.translation_walks} radix {radix.translation_walks}")
    return (f"[translation] off == flat == radix == gpu-mmu radix on every "
            f"batch and token; mosaic lookups {radix.translation_lookups}: "
            f"walks flat {flat.translation_walks}, radix "
            f"{radix.translation_walks} ({radix.translation_us:.0f} us "
            f"modeled); gpu-mmu radix: {gmmu.translation_lookups} lookups, "
            f"{gmmu.translation_walks} walks ({gmmu.translation_us:.0f} us "
            f"modeled)")


def phase_translation(cfg):
    """Phase 8c: the translation meter A/B on one engine at full width;
    returns the summed launch counts."""
    import torch
    total, runs = {}, {}
    lm = None
    for kind, tr in (("mosaic", "off"), ("mosaic", "flat"),
                     ("mosaic", "radix"), ("gpu-mmu", "radix")):
        eng, stream, batches, counts = serve_translation(cfg, tr, kind, lm)
        lm = eng.lm
        runs[f"{kind}:{tr}"] = (eng, stream, batches)
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        print(f"[translation:{kind}:{tr}] {eng.stats.summary()}")
    print(check_translation_runs(runs))
    del runs, lm, eng
    torch.cuda.empty_cache()
    return total


def phase_cluster_agreement(cfg_full):
    """Phase 8d: phases 8a and 8b at the narrow f32 width on the card
    (kernels) and on the CPU (plain versions): identical tokens, router
    decisions, tier counters and injector log."""
    import torch
    cfg = narrow_config(cfg_full)
    sigs = {}
    weights = None
    for dev in ("cuda", "cpu"):
        run, reqs, _c, _w = serve_cluster(cfg, device=dev, weights=weights)
        if weights is None:
            weights = {k: v.cpu() for k, v in
                       run.cluster.engines[0].lm.state_dict().items()}
        sig_a = cluster_signature(run, reqs)
        run, reqs, _c, _w = serve_cluster(
            cfg, device=dev, plan=crash_plan(run.stream_start),
            weights=weights)
        sigs[dev] = (sig_a, cluster_signature(run, reqs))
        if dev == "cuda":
            free_cluster(run)
    for i, tag in enumerate(("8a", "8b")):
        diff = [k for k in sigs["cpu"][i]
                if sigs["cpu"][i][k] != sigs["cuda"][i][k]]
        require(not diff, f"cluster agreement ({tag}): card and CPU differ "
                f"in {diff}")
    print("[cluster] narrow model, same weights, 8a and 8b: card (kernels) "
          "== CPU (plain versions) on tokens, router decisions, tier "
          "counters and the injector log")


def phase_vlm():
    """Phase 4g: llava-next-mistral-7b at its published width and depth
    through phase 4's stream and step hook at max_seq VLM_MAX_SEQ, in
    sync, async and fused; then cut to 2 layers on the card against the
    CPU with random image embeddings.  Returns the summed launch counts of
    the serving runs."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(VLM_ARCH)
    total, params = phase_main_path(cfg, MODES, tag="vlm",
                                       max_seq=VLM_MAX_SEQ)
    del params                  # llava's weights leave the card
    torch.cuda.empty_cache()
    check_agreement(dataclasses.replace(cfg, n_layers=2), "float32")
    return total


def phase_encdec():
    """Phase 4h: seamless-m4t-large-v2 at its published width and depth
    through phase 4's stream and step hook, in sync, async and fused; then
    cut to 2 + 2 layers on the card against the CPU with random source
    frames.  Returns the summed launch counts of the serving runs."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(ENCDEC_ARCH)
    total, params = phase_main_path(cfg, MODES, tag="encdec")
    del params
    torch.cuda.empty_cache()
    check_agreement(dataclasses.replace(cfg, encdec=dataclasses.replace(
        cfg.encdec, enc_layers=2, dec_layers=2)), "float32")
    return total


def phase_dense_archs():
    """Phase 4i: llama3-8b, phi3-mini-3.8b and qwen3-8b at their published
    widths and depths, one after another, the stream's first
    DENSE_REQUESTS requests in sync; qwen3-8b (qk-norm) also cut to 2
    layers on the card against the CPU.  Returns {arch: launch counts}."""
    import torch
    from repro_torch.configs import get_config
    out = {}
    for arch in DENSE_ARCHS:
        cfg = get_config(arch)
        out[arch] = phase_stream(cfg, ("sync",), DENSE_REQUESTS,
                                 tag=f"dense:{arch}")
        torch.cuda.empty_cache()
        if cfg.qk_norm:
            check_agreement(dataclasses.replace(cfg, n_layers=2), "float32")
    return out


def family_entries(vlm, encdec, dense):
    """Launch counts of the kernels line's entries from phases 4g-4i, each
    at the shapes its entry times: llava's prefill flash
    (``flash_attention.vlm``), the g = 4 / dh 128 paged calls of llava,
    llama3 and qwen3 and llava's fused calls (``.g4d128``), phi3's flash
    and paged calls (``.phi3``, ``.g1d96``), seamless's fused calls
    (``.g1d64``) and its flash calls by site (``flash_attention.encoder``,
    ``.cross_prefill``, ``.cross_decode``, as the wrapper counted them).
    Every other launch of those phases counts under its kernel's own
    entry."""
    sites = ("flash_attention.encoder", "flash_attention.cross_prefill",
             "flash_attention.cross_decode")
    tagged = {
        "flash_attention.vlm": vlm.pop("flash_attention"),
        "paged_attention.page.g4d128": vlm.pop("paged_attention.page"),
        "paged_attention.frame.g4d128": vlm.pop("paged_attention.frame"),
        "paged_attention.fused.g4d128": vlm.pop("paged_attention.fused"),
        "flash_attention.phi3": dense["phi3-mini-3.8b"].pop(
            "flash_attention"),
        "paged_attention.page.g1d96": dense["phi3-mini-3.8b"].pop(
            "paged_attention.page"),
        "paged_attention.fused.g1d64": encdec.pop("paged_attention.fused"),
    }
    for k in sites:
        tagged[k] = encdec.pop(k)
        encdec["flash_attention"] -= tagged[k]
    for arch in ("llama3-8b", "qwen3-8b"):
        tagged["paged_attention.page.g4d128"] += dense[arch].pop(
            "paged_attention.page")
    rest = {}
    for c in [vlm, encdec, *dense.values()]:
        for k, n in c.items():
            if k not in sites:
                rest[k] = rest.get(k, 0) + n
    return tagged, rest


def entry_kernel(name):
    """The kernel of a kernels-line entry: ``paged_attention.page.g4d128``
    -> ``paged_attention.page``, ``flash_attention.encoder`` ->
    ``flash_attention``."""
    return max((k for k in REPLACES if name == k or name.startswith(k + ".")),
               key=len)


def main() -> int:
    t_start = time.perf_counter()
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
    phase_mla_kernels(results)
    phase_ssd_kernel(results)
    phase_family_kernels(results)
    counts, params = phase_main_path(cfg)
    torch.cuda.empty_cache()
    phase_prefix(cfg, params)
    for arch, modes, n in ((HYBRID_ARCH, MODES, 8),
                           (SSM_ARCH, SSM_MODES, SSM_REQUESTS)):
        for k, n_launch in phase_stream(get_config(arch), modes, n).items():
            counts[k] = counts.get(k, 0) + n_launch
    phase_small_agreement(cfg)
    phase_transparency(cfg, params)
    del params                  # phase 4's copy of qwen2.5-3b leaves the card
    torch.cuda.empty_cache()
    for phase in (phase_cluster, phase_translation):
        for k, n_launch in phase(cfg).items():
            counts[k] = counts.get(k, 0) + n_launch
    phase_cluster_agreement(cfg)
    mla_counts = phase_mla_serving()
    dbrx = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    for k, n_launch in phase_stream(dbrx, ("sync",), MOE_REQUESTS).items():
        counts[k] = counts.get(k, 0) + n_launch
    for k, n_launch in mla_counts.items():
        counts[f"{k}.mla"] = n_launch
    tagged, rest = family_entries(phase_vlm(), phase_encdec(),
                                  phase_dense_archs())
    counts.update(tagged)
    for k, n_launch in rest.items():
        counts[k] = counts.get(k, 0) + n_launch
    line = [dict(name=name, route="cuda",
                 source=SOURCES[entry_kernel(name)],
                 replaces=REPLACES[entry_kernel(name)],
                 launches=counts[name],
                 max_abs_err=r["max_abs_err"], ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                 bound_by=r["bound_by"], library_ms=r["library_ms"])
            for name, r in results.items()]
    require(all(e["launches"] > 0 for e in line),
            f"an entry's kernel never launched on its path: "
            f"{[e['name'] for e in line if not e['launches']]}")
    print(f"[total] chip_smoke.py ran {time.perf_counter() - t_start:.1f}s "
          f"({SMI})")
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
