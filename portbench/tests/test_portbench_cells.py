"""Each cell end to end at smoke size on the port's plain (CPU) paths:
the window, the metrics and the comparison with the plain reference; the
comparison fails when a served token is altered where it is produced; the
precision control (the reference in fp8), put in the program's place,
fails the same comparison."""

import time

import pytest
import torch

from portbench.lib import drive_serve, harness
from portbench.tests.smoke import smoke_cell

CELLS = ("qwen2.5-3b.oversub", "deepseek-v2-lite-16b.oversub")
SEED = 2 ** 33 + 7


ALL = (10 ** 6, 10 ** 6)      # every request served is compared


def run(workload, monkeypatch, sample=(24, 3), **kw):
    cell = smoke_cell(workload)
    monkeypatch.setattr(drive_serve, "SAMPLE_TOKENS", sample[0])
    monkeypatch.setattr(drive_serve, "SAMPLE_REQUESTS", sample[1])
    return cell, drive_serve.run(cell, SEED, 5.0, False,
                                 time.perf_counter(), device="cpu", **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_end_to_end(workload, monkeypatch):
    cell, r = run(workload, monkeypatch)
    assert r["check"]["correct"], r["check"]
    assert r["check"]["info"]["tokens"] >= 5
    m = harness.metrics_of(cell, r, trace=False)
    # Off the card there is no allocator peak to report.
    assert set(m) == {e["name"] for e in cell.end_to_end} \
        - {"memory_peak_gib"}
    assert all(v["value"] > 0 for v in m.values())
    assert r["stats"]["swaps_out"] > 0 and r["finished"] > 0
    # The prefix reuse the harness infers is the engine's count.
    assert r["model_flops"] is not None


@pytest.mark.parametrize("workload", CELLS)
def test_altered_token_fails(workload, monkeypatch):
    """The first decode step after set-up's warm-up gives each of its rows
    a token the model did not choose."""
    from repro_torch.models.lm import LM
    real_decode, real_warm = LM.decode_step, drive_serve.warm_up
    calls = {"n": None}

    def warm(*a, **k):
        real_warm(*a, **k)
        calls["n"] = 0

    def altered(self, toks, pos, *a, **k):
        logits, pools, state = real_decode(self, toks, pos, *a, **k)
        if calls["n"] is not None:
            calls["n"] += 1
            if calls["n"] == 1:
                logits = logits.clone()
                rows = torch.arange(logits.shape[0])
                logits[rows, logits.argmin(-1)] = \
                    logits.max(-1).values + 1.0
        return logits, pools, state

    monkeypatch.setattr(LM, "decode_step", altered)
    monkeypatch.setattr(drive_serve, "warm_up", warm)
    # Every finished request is compared, so the altered ones are in.
    _cell, r = run(workload, monkeypatch, sample=ALL)
    assert calls["n"] > 1
    assert not r["check"]["correct"], r["check"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload, monkeypatch):
    """The fp8 control through the comparison and limits the program's
    tokens pass."""
    _cell, r = run(workload, monkeypatch, control=True, sample=ALL)
    c = r["check"]
    assert c["correct"], c
    assert not c["control"]["correct"], c["control"]
    assert c["control"]["numbers"]["gap_mean"] > c["numbers"]["gap_mean"]


def test_no_card_means_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = harness.main("qwen2.5-3b.oversub", 1, 1, False, time.perf_counter())
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
