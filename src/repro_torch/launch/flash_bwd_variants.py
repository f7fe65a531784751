"""Times variants of the flash-attention backward's head split on the card.

    PYTHONPATH=src python -m repro_torch.launch.flash_bwd_variants

Each variant is a copy of ``csrc/flash_attention_bwd.cu`` with
``kMaxCluster`` edited: the dK / dV launch splits the g query heads of a
KV head over c = min(g, kMaxCluster) CTAs of a cluster per key tile (4
is shipped; 8 is Hopper's portable cluster size; 1 walks all g heads in
one CTA), built with the package's nvcc flags into
``build/kernels/variants/``.  Each is held against the plain version (2e-2
of each gradient's scale) and against itself (two calls bitwise), then
timed by CUDA-graph replay at the training shape of ``chip_smoke.py``'s
phase 9a (B 2, T 2048, 16 heads over 2 KV heads of 128, causal, bf16), in
turn and then in reverse order, and traced once with ``torch.profiler``
for the device time of each of its two kernels.  Prints the card's name
and power limit, one line per variant and a JSON object as its last line.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import re
import subprocess

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.paged_variants import graph_ms

# name: kMaxCluster; the first is the shipped value.
VARIANTS = {"c4": 4, "c8": 8, "c2": 2, "c1": 1}
PATTERN = r"constexpr int kMaxCluster = \d+;"
SHAPE = (2, 2048, 16, 2, 128)          # B, T, H, n_kv, dh
KERNELS = ("bwd_dkdv", "bwd_dq")


def variant_source(src: str, max_cluster: int) -> str:
    """The kernel source with ``kMaxCluster`` replaced."""
    src, n = re.subn(PATTERN, f"constexpr int kMaxCluster = {max_cluster};",
                     src)
    if n != 1:
        raise RuntimeError("kMaxCluster not found once in the source")
    return src


def build_variants(names):
    """Compile each variant (one nvcc each, all at once); name -> CDLL."""
    out = build.BUILD_ROOT / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    procs = {}
    for name in names:
        cu = out / f"bwd_{name}.cu"
        cu.write_text(variant_source(src, VARIANTS[name]))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             str(out / f"bwd_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, spills = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        spills[name] = sorted({line.strip() for line in log.splitlines()
                               if "spill" in line and " 0 bytes spill"
                               not in line})
        lib = ctypes.CDLL(str(out / f"bwd_{name}.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_bwd.argtypes = [P] * 10 + [I] * 8 + [
            ctypes.c_float, P]
        lib.flash_attention_bwd.restype = I
        libs[name] = lib
    return libs, spills


def kernel_ms(fn, calls: int = 10):
    """Device ms per call of each backward kernel (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(KERNELS, 0.0)
    for ev in prof.key_averages():
        for key in KERNELS:
            if key in ev.key:
                out[key] += ev.device_time_total / 1e3 / calls
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_variants: needs a CUDA device")
    dev = torch.device("cuda")
    libs, spills = build_variants(args.variants)
    B, T, H, n_kv, dh = SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    q, do = (torch.randn((B, T, H, dh), generator=gen, device=dev)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, T, n_kv, dh), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    o, lse = fa.flash_attention_lse(q, k, v)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse)
    call = functools.partial(fa.flash_attention_bwd, q, k, v, o, do, lse)
    times, split = {}, {}
    saved = fa._bwd_lib
    try:
        order = args.variants + args.variants[::-1]
        for name in order:
            fa._bwd_lib = functools.partial(lambda lib: lib, libs[name])
            if name not in split:
                got, again = call(), call()
                torch.cuda.synchronize()
                for g, g2, w in zip(got, again, want):
                    scale = float(w.float().abs().max())
                    err = float((g.float() - w.float()).abs().max())
                    if err > 2e-2 * scale or not torch.equal(g, g2):
                        raise RuntimeError(f"variant {name}: off its plain "
                                           f"version by {err:.3g} (scale "
                                           f"{scale:.3g}) or not bitwise "
                                           f"stable")
                split[name] = kernel_ms(call)
            times.setdefault(name, []).append(graph_ms(call))
    finally:
        fa._bwd_lib = saved
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    for name in args.variants:
        print(f"[variant] {name} (kMaxCluster {VARIANTS[name]}): ms "
              + " ".join(f"{t:.4f}" for t in times[name]) + " | "
              + " ".join(f"{key} {ms:.4f}" for key, ms in split[name].items())
              + (f" | spills: {spills[name]}" if spills[name] else ""))
    print(json.dumps({"card": smi, "shape": dict(zip(
        ("B", "T", "H", "n_kv", "dh"), SHAPE)), "ms": times,
        "kernel_ms": split}))


if __name__ == "__main__":
    main()
