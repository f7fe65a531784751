"""Times the SSD-scan backward's launches on the card.

    PYTHONPATH=src python -m repro_torch.launch.ssd_bwd_phases
        [--heads 4 2 1] [--variants rows3]

At the training shapes of ``chip_smoke.py``'s phase 9a (mamba2-1.3b: B 2,
T 2048, 64 heads, hd 64, N 128, one B/C group, Q 256, bf16; zamba2-1.2b:
the same at N 64), each call is held against the plain version (2e-2 of
each gradient's scale) and against itself (two calls bitwise), then timed
by CUDA-graph replay, and traced with ``torch.profiler`` for each
launch's mean device µs.  ``--heads`` sets how many heads of a group a CTA
of the bf16 pair passes walks (``ssd_scan.BWD_MAX_HEADS``; 8 is shipped);
``--variants`` rebuilds edited copies of ``csrc/ssd_scan_bwd.cu``
(:data:`EDITS`) into ``build/kernels/variants/``.  Variants and head
counts run in turn, then once more in reverse order.  Only the public
``ssd_scan_bwd`` is called, so a copy of this file run with
``PYTHONPATH=<checkout>/src`` (no ``--heads`` or ``--variants``) times an
older checkout's kernel.
Prints the card's name and power limit, one line per (shape, build) and
a JSON object as its last line.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch.paged_variants import graph_ms

# (label, (B, T, nh, hd, N, G, Q)): chip_smoke.py's phase 9a shapes.
SHAPES = (("mamba2-1.3b", (2, 2048, 64, 64, 128, 1, 256)),
          ("zamba2-1.2b", (2, 2048, 64, 64, 64, 1, 256)))
# name: (text in the shipped source, its replacement)
EDITS = {
    "rows3": ("__launch_bounds__(kTcThreads, 2)\nssd_bwd_rows_wg_kernel",
              "__launch_bounds__(kTcThreads, 3)\nssd_bwd_rows_wg_kernel"),
}
TOL = 2e-2


def inputs(shape, seed: int = 3):
    """bf16 x, B, C and f32 dt in [0.01, 0.2], A in [-2, -0.5], dy ~ N(0,
    1), drawn on the card from ``seed``."""
    B, T, nh, hd, N, G, Q = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*s, dtype=torch.float32):
        return torch.randn(s, generator=gen, device="cuda").to(dtype)
    x = randn(B, T, nh, hd, dtype=torch.bfloat16)
    Bm, Cm = (randn(B, T, G, N, dtype=torch.bfloat16) for _ in range(2))
    dt = 0.01 + 0.19 * torch.rand((B, T, nh), generator=gen, device="cuda")
    A = -(0.5 + 1.5 * torch.rand((nh,), generator=gen, device="cuda"))
    return (x, dt, A, Bm, Cm), randn(B, T, nh, hd), Q


def check(args, dy, Q, what: str) -> None:
    """Raise unless the call is within TOL of the plain version at each
    gradient's scale and two calls agree bit for bit."""
    got = ssd.ssd_scan_bwd(*args, dy, chunk=Q)
    again = ssd.ssd_scan_bwd(*args, dy, chunk=Q)
    want = ref.ssd_scan_bwd_ref(*args, dy, chunk=Q)
    torch.cuda.synchronize()
    for name, g, g2, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, again,
                              want):
        err = float((g.float() - w.float()).abs().max())
        scale = float(w.float().abs().max())
        if err > TOL * scale or not torch.equal(g, g2):
            raise RuntimeError(f"{what}: {name} off its plain version by "
                               f"{err:.3g} (scale {scale:.3g}) or not "
                               f"bitwise stable")


def launch_us(fn, calls: int = 10):
    """Mean device µs per call of each backward kernel (torch.profiler),
    keyed by the kernel's name up to its template arguments."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if "ssd_bwd_" in ev.key:
            name = "ssd_bwd_" + ev.key.split("ssd_bwd_")[1].split("<")[0]
            name = name.split("(")[0]
            out[name] = out.get(name, 0.0) + ev.device_time_total / calls
    return out


def build_variant(name: str) -> ctypes.CDLL:
    """``csrc/ssd_scan_bwd.cu`` with ``EDITS[name]`` applied, built and
    bound."""
    src = (build.CSRC / "ssd_scan_bwd.cu").read_text()
    old, new = EDITS[name]
    if src.count(old) != 1:
        raise RuntimeError(f"{name}: the edited text is not in the source "
                           f"once")
    out = build.BUILD_ROOT / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"ssd_bwd_{name}.cu", out / f"ssd_bwd_{name}.so"
    cu.write_text(src.replace(old, new))
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name} failed to build:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_bwd.argtypes = [P] * 24 + [I] * 9 + [P]
    lib.ssd_scan_bwd.restype = I
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--heads", nargs="*", type=int, default=[])
    ap.add_argument("--variants", nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ssd_bwd_phases: needs a CUDA device")
    builds = {"shipped": None}
    builds.update({f"heads{k}": None for k in args.heads})
    builds.update({name: build_variant(name) for name in args.variants})
    cases = {label: inputs(shape) for label, shape in SHAPES}
    saved_lib = ssd._bwd_lib
    saved_heads = getattr(ssd, "BWD_MAX_HEADS", None)
    ms, split = {}, {}
    try:
        order = list(builds) + list(builds)[::-1]
        for name in order:
            lib = builds[name]
            ssd._bwd_lib = saved_lib if lib is None else (
                functools.partial(lambda lib: lib, lib))
            if name.startswith("heads"):
                ssd.BWD_MAX_HEADS = int(name[5:])
            elif saved_heads is not None:
                ssd.BWD_MAX_HEADS = saved_heads
            for label, (xs, dy, Q) in cases.items():
                key = f"{label} {name}"
                call = functools.partial(ssd.ssd_scan_bwd, *xs, dy, chunk=Q)
                if key not in split:
                    check(xs, dy, Q, key)
                    split[key] = launch_us(call)
                ms.setdefault(key, []).append(graph_ms(call, reps=5,
                                                       replays=3))
    finally:
        ssd._bwd_lib = saved_lib
        if saved_heads is not None:
            ssd.BWD_MAX_HEADS = saved_heads
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    for key in ms:
        print(f"[ssd_bwd] {key}: ms " + " ".join(f"{t:.4f}" for t in ms[key])
              + " | " + " ".join(f"{k[8:]} {us:.1f} us"
                                 for k, us in split[key].items()))
    print(json.dumps({"card": smi, "shapes": dict(SHAPES), "ms": ms,
                      "launch_us": split}))


if __name__ == "__main__":
    main()
