"""Times the SSD scan's phases and two build variants on the card.

    PYTHONPATH=src python -m repro_torch.launch.ssd_phases

At the shapes of ``chip_smoke.py``'s phase 3 (:func:`cases`, which the
script also uses), for the shipped ``csrc/ssd_scan.cu`` and for copies of
it rebuilt with one edit each: ``serial``, programmatic dependent launch
off (the three phases run one after another), and ``out3``, the output
phase built for three CTAs per SM at hd = 64, N = 32 and 64 instead of
four (a register cap of 168 instead of 128).  Per build, the output
phase's instances that spill (ptxas); for each (call, build): the CUDA-graph replay ms of the call and each phase's mean device µs from
``torch.profiler`` (with the dependent launch the phases overlap, so those
sum to more than the call).  Each build is checked against the plain
version first.  Two rounds.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import re
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.kernels import build, ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch.paged_variants import graph_ms
from repro_torch.models.mamba2 import dims

# name: (text in the shipped source, its replacement)
EDITS = {
    "serial": ("attr[0].val.programmaticStreamSerializationAllowed = 1;",
               "attr[0].val.programmaticStreamSerializationAllowed = 0;"),
    "out3": ("return HD > 64 ? 2 : HD * N <= 64 * 64 ? 4 : 3;",
             "return HD > 64 ? 2 : HD == 64 && N >= 32 ? 3 : 4;"),
}
PHASES = ("ssd_states_kernel", "ssd_pass_kernel", "ssd_out_kernel")
TOL = dict(rtol=3e-2, atol=3e-2)    # bf16 inputs (tests/test_kernels.py)


def cases(dev, seed: int = 3):
    """The SSD calls of ``chip_smoke.py``'s phase 3, bf16, for the
    1100-token prompt (1152 tokens at 64-token pages, padded to five
    256-row chunks): label -> (args, kwargs, (B, T, nh, hd, N, Q, h0, G)).
    (a') zamba2-1.2b with its one B/C group, the main path's call; (a) the
    same head-expanded (G = 64); (b) mamba2-1.3b (N = 128, one group);
    (c) zamba2 with an initial state carried in over 192-row chunks."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def case(arch, T, Q, with_h0, expand=False):
        cfg = get_config(arch)
        _d_in, nh, _ = dims(cfg)
        hd, N, G = cfg.ssm.head_dim, cfg.ssm.d_state, cfg.ssm.n_groups

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        x = randn(1, T, nh, hd).to(torch.bfloat16)
        dt = torch.rand((1, T, nh), generator=gen, device=dev) * 0.19 + 0.01
        A = -torch.linspace(1.0, 16.0, nh, device=dev)
        Bm, Cm = (randn(1, T, G, N).to(torch.bfloat16) for _ in range(2))
        if expand:
            Bm, Cm = (t.repeat_interleave(nh // G, dim=2) for t in (Bm, Cm))
            G = nh
        h0 = randn(1, nh, hd, N) if with_h0 else None
        return ((x, dt, A, Bm, Cm), dict(chunk=Q, h0=h0),
                (1, T, nh, hd, N, Q, with_h0, G))

    return {"a'": case("zamba2-1.2b", 1280, 256, False),
            "a": case("zamba2-1.2b", 1280, 256, False, expand=True),
            "b": case("mamba2-1.3b", 1280, 256, False),
            "c": case("zamba2-1.2b", 1152, 192, True)}


def out_spills(log: str) -> str:
    """The output phase's instances that spill, from a ptxas report."""
    found = re.findall(r"properties for \S*ssd_out_kernelILi(\d+)ELi(\d+)E\S*"
                       r"\s+\d+ bytes stack frame, (\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads", log)
    return ", ".join(f"<{hd},{n}> {st}/{ld} B" for hd, n, st, ld in found
                     if st != "0" or ld != "0") or "none"


def build_variant(name: str):
    """``csrc/ssd_scan.cu`` with ``EDITS[name]`` applied, built and bound;
    returns (library, ptxas report)."""
    old, new = EDITS[name]
    src = (build.CSRC / "ssd_scan.cu").read_text()
    if src.count(old) != 1:
        raise RuntimeError(f"{name}: the edited text is not in the source "
                           f"once")
    out = build.BUILD_ROOT / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"ssd_{name}.cu", out / f"ssd_{name}.so"
    cu.write_text(src.replace(old, new))
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name} failed to build:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ssd.bind(ctypes.CDLL(str(so))), proc.stdout + proc.stderr


def phase_us(fn, iters: int = 20):
    """Mean device µs of each phase's kernel over ``iters`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {name: e.device_time for e in prof.key_averages()
            for name in PHASES if name in e.key and e.count}


def main():
    dev = torch.device("cuda")
    libs = {"shipped": ssd._lib()}
    logs = {"shipped": (build.BUILD_ROOT / build._key()
                        / "ssd_scan.log").read_text()}
    for name in EDITS:
        libs[name], logs[name] = build_variant(name)
    calls = cases(dev)
    lines = [f"[ssd] {name}: output phase spills {out_spills(log)}"
             for name, log in logs.items()]
    saved = ssd._lib
    try:
        for rnd in range(2):
            for label, (args, kw, _shape) in calls.items():
                for name, lib in libs.items():
                    ssd._lib = lambda lib=lib: lib

                    def fn(args=args, kw=kw):
                        return ssd.ssd_scan(*args, **kw)
                    if rnd == 0:
                        y, h = fn()
                        y_r, h_r = ref.ssd_scan_ref(*args, **kw)
                        torch.cuda.synchronize()
                        torch.testing.assert_close(y, y_r, **TOL)
                        torch.testing.assert_close(h, h_r, **TOL)
                    ms = graph_ms(fn)
                    phases = phase_us(fn)
                    lines.append(
                        f"[ssd] ({label}) {name}: ms {ms:.4f} | phases "
                        + " ".join(f"{p.split('_')[1]} {phases[p]:.2f} us"
                                   for p in PHASES if p in phases))
    finally:
        ssd._lib = saved
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    print("\n".join(lines))


if __name__ == "__main__":
    main()
