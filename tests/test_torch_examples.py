"""The port's four examples (``examples/torch_*.py``) against the
reference's (``examples/{quickstart,long_context,serve_multitenant,
train_lm}.py``, loaded by path and left as they are), on the CPU.

* The host-side examples print the reference's stdout line for line: both
  packages' ``core`` managers make the same decisions.
* The serving example, on the reference's flag set ``--requests 6
  --oversubscribe 2 --shared-prefix 40 --engines 2`` for both managers:
  every modeled counter of each engine and of the cluster equals the
  reference's f32 run's, the port's run in f32 and at the example's own
  bf16; each request's tokens equal in f32, where both start from the
  reference's weights (the port's through the bridge; cross-framework
  greedy equality holds only in f32).  Excluded, measured on the host
  clock: ``wall_s``, ``admit_hit_us`` and ``admit_cold_us`` (so tok/s
  and the admission ms).  The example sets no ``decode_window_us``, so
  the engines' modeled clock advances by each decode's measured time, and
  the µs that are differences on that clock (hidden and exposed fault
  µs) agree to its rounding only: floats within 1e-9 relative, every
  count exact.
* The training example's tiny model in f32 from the reference Trainer's
  initial weights: its first three logged losses within 1e-4 of the
  reference ``Trainer``'s at the same batch and length; a run resumed at
  its step-2 checkpoint ends bit for bit where the uninterrupted run does.
* Without a card, ``--device cuda`` raises; ``chip_smoke.py``'s phase 11
  rehearsed on the CPU.  (That no example loads JAX or the reference is
  ``tests/test_torch_import.py``'s.)

The reference's serving and training run in a process of their own,
started before the first test, while the port's runs go on here.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models.lm import LM as JLM
from repro.serving.engine import EngineStats as JStats
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config as t_smoke

ROOT = Path(__file__).resolve().parents[1]
TESTS = str(ROOT / "tests")
EXAMPLES = ROOT / "examples"
SERVE_FLAGS = dict(n_requests=6, seed=0, oversubscribe=2.0,
                   shared_prefix=40, n_engines=2)
HOST_CLOCK = ("wall_s", "admit_hit_us", "admit_cold_us")
# The reference's field that the port's EngineStats does not keep: the
# pool occupancy summed over steps, which nothing reads.
NOT_KEPT = {"occupancy_sum"}
TRAIN_STEPS, TRAIN_B, TRAIN_T = 20, 4, 32
sys.path.insert(0, TESTS)
try:
    from torch_reference_run import ReferenceRun
finally:
    sys.path.remove(TESTS)

# The reference's examples in a process of their own (one host device, as
# the port's runs here), while this file's port runs go on: its serving
# example's run() in f32 for both managers (its module's get_smoke_config
# patched), and the reference Trainer on the training example's --tiny
# model in f32, the state of each written to ref.json.
_REFERENCE = r"""
import dataclasses, importlib.util, json, sys
import jax
from repro.configs import get_smoke_config
from repro.configs.base import TrainHParams
from repro.launch.mesh import make_host_mesh
from repro.train.trainer import Trainer

out_dir, flags, train = sys.argv[1], json.loads(sys.argv[2]), json.loads(
    sys.argv[3])
host_clock = ("wall_s", "admit_hit_us", "admit_cold_us")
spec = importlib.util.spec_from_file_location(
    "serve_multitenant", "examples/serve_multitenant.py")
ref = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ref)
cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"), dtype="float32")
ref.get_smoke_config = lambda arch: cfg

def fields(s):
    return {f.name: getattr(s, f.name) for f in dataclasses.fields(s)
            if f.name not in host_clock}

out = {"serve": {}}
for kind in ("mosaic", "gpu-mmu"):
    eng, reqs, steps = ref.run(kind, **flags)
    out["serve"][kind] = {
        "steps": steps, "engines": [fields(e.stats) for e in eng.engines],
        "totals": fields(eng.stats().totals),
        "tokens": {str(r.rid): list(r.out) for r in reqs}}
hp = TrainHParams(lr=3e-4, warmup_steps=20, total_steps=train["steps"],
                  microbatch=2, remat="block")
tr = Trainer(dataclasses.replace(get_smoke_config("llama3-8b"),
                                 dtype="float32"), hp, make_host_mesh(),
             batch_per_step=train["B"], seq_len=train["T"], ckpt_every=0)
out["train"] = tr.run(train["steps"], log_every=10)
with open(f"{out_dir}/ref.json", "w") as f:
    json.dump(out, f)
"""


def _load(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return buf.getvalue(), out


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _reference_run(tmp_path_factory):
    """The reference's process, started before this file's first test."""
    d = tmp_path_factory.mktemp("examples")
    run = ReferenceRun(_REFERENCE, [
        d, json.dumps(SERVE_FLAGS),
        json.dumps({"steps": TRAIN_STEPS, "B": TRAIN_B, "T": TRAIN_T})],
        d, devices=1, fast=False)
    yield d, run
    run.close()


@pytest.fixture(scope="module")
def reference(_reference_run):
    d, run = _reference_run
    run.wait()
    return json.loads((d / "ref.json").read_text())


# ---------------------------------------------------------------- host


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []), ("long_context", []),
    ("long_context", ["--ctx", "1000", "--frame-pages", "8"])])
def test_host_examples_print_the_references_lines(name, argv, monkeypatch):
    """The reference's ``main()`` reads ``sys.argv``; the port's takes
    ``argv``."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    want, _ = _stdout(_load(name).main)
    got, _ = _stdout(_load(f"torch_{name}").main, argv)
    assert want.splitlines() and got.splitlines() == want.splitlines()


# ------------------------------------------- while the reference runs


def test_chip_smoke_phase_11_rehearsed_on_the_cpu():
    """chip_smoke.py's phase 11 with the examples on the CPU at smoke
    size (one serving command line; the training runs on ``--tiny``)."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    out = chip_smoke.phase_examples("cpu")
    assert out["resumed"] == 50 and out["same_losses"] >= 3


def test_train_lm_resume_is_bitwise(tmp_path, monkeypatch):
    """The example's own ``--tiny`` model: 20 steps checkpointing every 2
    (every checkpoint kept), and the same command resumed from a copy of
    its step-2 checkpoint: steps 10 and 20 log the uninterrupted run's
    losses bit for bit.  (The resumed run goes on to step 22: the example
    runs ``--steps`` more steps, on the schedule of ``--steps``, as the
    reference's.)"""
    from repro_torch.train import checkpoint
    monkeypatch.setattr(checkpoint, "prune", lambda *a, **k: None)
    port = _load("torch_train_lm")
    kw = dict(batch=4, seq=32, tiny=True, device="cpu", ckpt_every=2)
    _, (a, _) = _stdout(port.run, 20, ckpt_dir=str(tmp_path / "a"), **kw)
    shutil.copytree(tmp_path / "a" / "step_00000002",
                    tmp_path / "b" / "step_00000002")
    text, (b, _) = _stdout(port.run, 20, ckpt_dir=str(tmp_path / "b"),
                           resume=True, **kw)
    assert "resuming from step 2" in text.splitlines()
    assert b.start_step == 2
    want = {r["step"]: r["loss"] for r in a.log}
    got = {r["step"]: r["loss"] for r in b.log}
    assert sorted(got) == [3, 10, 20] and sorted(want) == [1, 10, 20]
    assert got[10] == want[10] and got[20] == want[20]


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal where no card is visible")
def test_card_bound_examples_raise_without_a_card(tmp_path):
    """Both default to ``--device cuda`` and raise the engine's or the
    trainer's own error: nothing continues on the CPU."""
    with pytest.raises(RuntimeError, match="CUDA"):
        _stdout(_load("torch_serve_multitenant").main, ["--requests", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        _stdout(_load("torch_train_lm").main,
                ["--tiny", "--steps", "1", "--ckpt-dir", str(tmp_path)])


# ---------------------------------------------------------------- serving


def _serve_state(eng, reqs, steps):
    """Every engine's stats and the cluster's totals (the reference's
    fields), the engine steps and each request's tokens, as the
    reference's process writes them."""
    names = [f.name for f in dataclasses.fields(JStats)
             if f.name not in HOST_CLOCK and f.name not in NOT_KEPT]

    def fields(s):
        return {k: getattr(s, k) for k in names}
    return {"steps": steps, "engines": [fields(e.stats) for e in eng.engines],
            "totals": fields(eng.stats().totals),
            "tokens": {str(r.rid): list(r.out) for r in reqs}}


@pytest.fixture(scope="module")
def serving(reference):
    """The reference's runs (its process's), and the port's on the same
    weights in f32 and at the example's bf16 on its own, for both
    managers."""
    port = _load("torch_serve_multitenant")
    jcfg = dataclasses.replace(j_smoke("qwen2.5-3b"), dtype="float32")
    tcfg = dataclasses.replace(t_smoke("qwen2.5-3b"), dtype="float32")
    params = params_from_jax(jax.tree.map(np.asarray, JLM(jcfg).init(
        jax.random.PRNGKey(SERVE_FLAGS["seed"]))))
    out = {}
    for kind in ("mosaic", "gpu-mmu"):
        out["ref", kind] = reference["serve"][kind]
        out["f32", kind] = _serve_state(*port.run(
            kind, **SERVE_FLAGS, device="cpu", params=params, cfg=tcfg))
        out["bf16", kind] = _serve_state(*port.run(
            kind, **SERVE_FLAGS, device="cpu"))
    return out


@pytest.mark.parametrize("kind", ["mosaic", "gpu-mmu"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_serving_example_gives_the_references_counters(dtype, kind,
                                                       serving):
    """Engine steps, swaps, faults and their DMAs, bytes in and out,
    transfer / hidden / exposed µs, prefix hits / misses / reused tokens,
    CAC copies, the coalesced sum and every other modeled field, per
    engine and in total.  The schedule has no EOS, so the counters depend
    on the requests' lengths, not on the tokens: the bf16 run, on the
    port's own weights, gives them too."""
    ref, got = serving["ref", kind], serving[dtype, kind]
    assert got["steps"] == ref["steps"]
    assert len(got["engines"]) == len(ref["engines"]) == 2
    for a, b in zip([got["totals"], *got["engines"]],
                    [ref["totals"], *ref["engines"]]):
        assert set(a) == set(b) - NOT_KEPT
        for k in a:
            v = b[k]
            if isinstance(v, float):
                assert a[k] == pytest.approx(v, rel=1e-9, abs=1e-9), k
            else:
                assert a[k] == v, k
    assert ref["totals"]["prefix_hits"] > 0 and ref["totals"]["faults"] > 0


@pytest.mark.parametrize("kind", ["mosaic", "gpu-mmu"])
def test_serving_example_gives_the_references_tokens_in_f32(kind, serving):
    assert serving["f32", kind]["tokens"] == serving["ref", kind]["tokens"]
    assert serving["bf16", kind]["tokens"] == serving["bf16", "mosaic"][
        "tokens"]


# ---------------------------------------------------------------- training


def test_train_lm_tiny_matches_the_reference_trainer(reference):
    """``--tiny`` (the smoke llama3-8b) in f32 from the reference Trainer's
    initial weights (its ``LM.init`` at seed 0), batch 4 x 32, 20 steps
    logged every 10: the logged losses (steps 1, 10 and 20) within 1e-4 of
    the reference Trainer's."""
    jcfg = dataclasses.replace(j_smoke("llama3-8b"), dtype="float32")
    params = params_from_jax(jax.tree.map(np.asarray, JLM(jcfg).init(
        jax.random.PRNGKey(0))))
    port = _load("torch_train_lm")
    text, (tr, got) = _stdout(
        port.run, TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_T, tiny=True,
        device="cpu", params=params,
        cfg=dataclasses.replace(t_smoke("llama3-8b"), dtype="float32"),
        ckpt_every=0)
    want = [tuple(h) for h in reference["train"]]
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 10, 20]
    for (_, a), (_, b) in zip(got, want):
        assert a == pytest.approx(b, rel=1e-4), (got, want)
    assert text.splitlines()[:2] == ["model: llama3-8b (0.1M params)",
                                     "mesh: {'data': 1, 'model': 1}"]
