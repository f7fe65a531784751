"""The port's vlm family (llava-next-mistral-7b) vs the reference's.

The vision tower is a stub in both packages: the model takes patch
embeddings [B, P, d], projects them (``frontend_proj``) and runs them in
front of the prompt's tokens through the dense stack, so a request's pool
holds P + T tokens and decode positions count the patches.  Weights come
from the reference's ``LM.init`` bridged into the port; inputs, the patch
embeddings included, are drawn with numpy from a seed.  Float32 at
rtol/atol 1e-4 (tests/test_torch_models.py); engine tokens and counters
exact.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import PoolGeometry as TGeo
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

from test_torch_parity_helpers import (
    ENGINE_KW,
    GEO_KW,
    bridged,
    check_engine_matches_reference,
    check_lm_matches_reference,
)

ARCH = "llava-next-mistral-7b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions' tiny tensors otherwise
    spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_lm_prefill_and_decode_match_reference():
    """Random patch embeddings in front of a 13-token prompt, then two
    decode steps: logits and both pools (patches included) against the
    reference's; the projection is in the weight tree."""
    tlm = check_lm_matches_reference(ARCH)
    d = tlm.cfg.d_model
    assert tuple(tlm.frontend_proj.shape) == (d, d)


def test_patch_embeddings_move_the_logits():
    """The image reaches the prompt: other patch embeddings, other
    logits (zero patches, the engine's stub, are a valid input)."""
    _jcfg, _jlm, _jp, tlm = bridged(ARCH)
    cfg = tlm.cfg
    P = cfg.frontend_tokens
    from repro_torch.serving.kv_cache import ShardedKVCache
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 8))
                            .astype(np.int32))
    outs = []
    for pe in (torch.zeros((1, P, cfg.d_model)),
               torch.from_numpy(rng.normal(size=(1, P, cfg.d_model))
                                .astype(np.float32))):
        cache = ShardedKVCache(TGeo(**GEO_KW), 16, 1)
        cache.allocate(0, P + 8)
        pools = tuple(torch.zeros(s) for s, _ in tlm.pool_shapes(
            16, GEO_KW["page_tokens"]))
        logits, _, state = tlm.prefill(
            {"tokens": toks, "patch_embeds": pe}, pools,
            cache.pack_ctx([0], 8))
        assert state == {} and bool(torch.isfinite(logits).all())
        outs.append(logits)
    assert not torch.allclose(outs[0], outs[1])


@pytest.mark.parametrize("mode", ["sync", "async", "fused"])
def test_vlm_engine_matches_reference(mode):
    """The reference serves vlm in all three modes (its dense stack slices
    the staged pages per layer); no prefix cache."""
    check_engine_matches_reference(ARCH, mode)


def test_engine_allocates_the_frontend_tokens():
    """Admission maps P + T tokens (the image, then the prompt), and the
    first decode step writes position P + T."""
    _jcfg, _jlm, _jp, tlm = bridged(ARCH)
    cfg = tlm.cfg
    eng = TEngine(cfg, geometry=TGeo(**GEO_KW), params=tlm.state_dict(),
                  device="cpu", **ENGINE_KW)
    assert eng.prefix is None and not eng.prefix_supported
    r = TRequest(rid=0, tenant=0, max_new=3,
                 prompt=np.arange(21, dtype=np.int32))
    eng.submit(r)
    eng.step()
    assert eng.cache.seq_tokens[0] == cfg.frontend_tokens + 21 + 1
    eng.run_until_drained()
    assert r.done and len(r.out) == 3


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def test_chip_smoke_vlm_phase_on_cpu():
    """chip_smoke.py's phase 4g rehearsed on the CPU (plain versions) at
    smoke width with llava's 2880 image tokens, so the schedule is the
    card's: the stream and step hook at max_seq 4096 in sync, async and
    fused, each run swapping, faulting and compacting, with identical
    tokens."""
    chip_smoke = _chip_smoke()
    cfg = dataclasses.replace(t_smoke(ARCH), dtype="float32",
                              frontend_tokens=2880)
    tokens = {}
    for mode in chip_smoke.MODES:
        eng, stream, events, counts, _wall = chip_smoke.serve_mode(
            cfg, mode, device="cpu", max_seq=chip_smoke.VLM_MAX_SEQ)
        chip_smoke.check_mode_run(cfg, mode, eng, stream, events, counts)
        assert all(v == 0 for v in counts.values())
        tokens[mode] = [list(r.out) for _, r in stream]
    assert tokens["async"] == tokens["sync"] == tokens["fused"]


def test_chip_smoke_vlm_agreement_on_cpu():
    """Phase 4g's card-vs-CPU check rehearsed with both runs on the CPU:
    random image embeddings of 2880 patches in front of the prompt."""
    chip_smoke = _chip_smoke()
    cfg = dataclasses.replace(t_smoke(ARCH), dtype="bfloat16",
                              frontend_tokens=2880)
    agree, routed, err = chip_smoke.lm_agreement(cfg, "cpu",
                                                 ref_dtype="float32")
    assert agree == 1.0 and routed == 0 and err <= 2e-2
