"""Times layout variants of the split-KV paged-attention kernel on the card.

    PYTHONPATH=src python -m repro_torch.launch.paged_variants

Each variant is a copy of ``csrc/paged_attention.cu`` with its layout
constants edited (``kSpan`` table positions per split, ``kChunk`` positions
staged per step, ``kWarps`` warps per CTA, ``HB`` query heads per register
pass), built with the package's nvcc flags into
``build/kernels/variants/``, checked against the plain version (m and l at
1e-5) and timed by CUDA-graph replay at the shapes of ``chip_smoke.py``'s
phase 3: qwen2.5-3b at B = 4 and B = 1 (16 heads over 2 KV heads, head dim
128, 32 pages of 64 tokens per row, cycling 36 layers' pools) and
zamba2-1.2b's shared block at B = 4 (32 heads = 32 KV heads, head dim 64,
cycling 6 pool slices).  Variants run in turn, twice; one line per
(variant, shape).  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import itertools
import re
import subprocess

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import paged_attention as pa

# name: (kSpan, kChunk, kWarps, HB); the first is the shipped layout.
VARIANTS = {
    "s64c64w8h4": (64, 64, 8, 4),
    "s64c32w8h4": (64, 32, 8, 4),
    "s32c32w8h4": (32, 32, 8, 4),
    "s64c32w8h2": (64, 32, 8, 2),
    "s128c32w8h4": (128, 32, 8, 4),
    "s64c32w4h4": (64, 32, 4, 4),
    "s128c32w4h8": (128, 32, 4, 8),
}
SHAPES = {  # label: (H, n_kv, dh, B, pools cycled)
    "qwen2.5-3b B=4": (16, 2, 128, 4, 36),
    "qwen2.5-3b B=1": (16, 2, 128, 1, 36),
    "zamba2-1.2b B=4": (32, 32, 64, 4, 6),
}
PATTERNS = {
    "kSpan": r"constexpr int kSpan = \d+;",
    "kChunk": r"constexpr int kChunk = \d+;",
    "kWarps": r"constexpr int kWarps = \d+;",
    "HB": r"constexpr int HB = \d+;",
}


def variant_source(src: str, span: int, chunk: int, warps: int,
                   hb: int) -> str:
    """The kernel source with its layout constants replaced."""
    for (name, pat), value in zip(PATTERNS.items(),
                                  (span, chunk, warps, hb)):
        src, n = re.subn(pat, pat.split(" = ")[0].replace("\\", "")
                         + f" = {value};", src)
        if n != 1:
            raise RuntimeError(f"{name} not found once in the source")
    return src


def build_variants(names):
    """Compile each variant (one nvcc each, all at once); name -> CDLL."""
    out = build.BUILD_ROOT / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "paged_attention.cu").read_text()
    procs = {}
    for name in names:
        cu = out / f"{name}.cu"
        cu.write_text(variant_source(src, *VARIANTS[name]))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_fwd.argtypes = [P, I, P, P, P, P, P, P, P, P, I,
                                            I, I, I, I, I, I, I,
                                            ctypes.c_float, P]
        lib.paged_attention_fwd.restype = I
        libs[name] = lib
    return libs


def tables(rng, B, n_blocks, n_entries, tokens_per_block):
    """Random page tables with holes and partial last pages, as
    ``chip_smoke.py`` draws them."""
    tb = np.full((B, n_blocks), -1, np.int32)
    nt = np.zeros((B, n_blocks), np.int32)
    for b in range(B):
        used = int(rng.integers(1, n_blocks + 1))
        ids = rng.permutation(n_entries)[:used]
        slots = np.sort(rng.permutation(n_blocks)[:used])
        for j, (slot, e) in enumerate(zip(slots, ids)):
            tb[b, slot] = e
            nt[b, slot] = tokens_per_block if j < used - 1 else int(
                rng.integers(1, tokens_per_block + 1))
    return tb, nt


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device ms per call: ``reps`` calls in one CUDA graph, replayed."""
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    libs = build_variants(args.variants)
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen,
                           device=dev).to(torch.bfloat16)
    cases = {}
    for label, (H, n_kv, dh, B, n_pools) in SHAPES.items():
        tb, nt = (torch.from_numpy(a).to(dev)
                  for a in tables(np.random.default_rng(1), B, 32, 80, 64))
        pools = [(randn(80, 64, n_kv, dh), randn(80, 64, n_kv, dh))
                 for _ in range(n_pools)]
        cases[label] = (randn(B, H, dh), pools, tb, nt, dh ** -0.5)
    times = {}
    saved = pa._lib, pa.SPLIT_TOKENS
    try:
        for _rep, name in itertools.product(range(2), args.variants):
            pa._lib = functools.partial(lambda lib: lib, libs[name])
            pa.SPLIT_TOKENS = VARIANTS[name][0]
            for label, (q, pools, tb, nt, scale) in cases.items():
                kw = dict(granularity="page", scale=scale)
                got = pa.paged_attention_kernel(q, *pools[0], tb, nt, **kw)
                want = ref.paged_attention_ref(q, *pools[0], tb, nt,
                                               scale=scale)
                torch.cuda.synchronize()
                for a, b in zip(got[1:], want[1:]):
                    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
                times.setdefault((name, label), []).append(graph_ms(
                    lambda: [pa.paged_attention_kernel(q, pk, pv, tb, nt,
                                                       **kw)
                             for pk, pv in pools]) / len(pools))
    finally:
        pa._lib, pa.SPLIT_TOKENS = saved
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    for (name, label), ms in times.items():
        span, chunk, warps, hb = VARIANTS[name]
        print(f"[variant] {name} (kSpan {span}, kChunk {chunk}, kWarps "
              f"{warps}, HB {hb}) {label}: ms "
              + " ".join(f"{t:.4f}" for t in ms))


if __name__ == "__main__":
    main()
