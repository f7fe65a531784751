"""The port's encdec family (seamless-m4t-large-v2) vs the reference's.

The speech frontend is a stub in both packages: the encoder takes frame
embeddings [B, S, d] (projected by ``frontend_proj``), runs bidirectional
attention over them, and the decoder cross-attends to its memory.  Cross
K/V are decode state [L, B, S, n_kv, dh], kept densely.  Weights come
from the reference's ``LM.init`` bridged into the port; inputs, the
source frames included, are drawn with numpy from a seed.  Float32 at
rtol/atol 1e-4 (tests/test_torch_models.py); engine tokens and counters
exact.

One reference fault is pinned: its encdec decode hands every layer the
whole layer-stacked stage (``repro/models/encdec.py:150-151``), so its
fused mode fails once a step stages pages; the port slices per layer and
its fused tokens equal its sync tokens (and the reference's).
"""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jed
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models import encdec as ted

from test_torch_parity_helpers import (
    bridged,
    check_engine_matches_reference,
    check_lm_matches_reference,
    close,
    serve,
)

ARCH = "seamless-m4t-large-v2"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions' tiny tensors otherwise
    spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _src(cfg, B=2, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, cfg.encdec.source_len,
                            cfg.d_model)).astype(np.float32)


def test_encoder_apply_matches_reference():
    """The bidirectional encoder over random frames, with its final norm:
    every position sees every other (non-causal flash, plain version)."""
    jcfg, _jlm, jparams, tlm = bridged(ARCH)
    src = _src(jcfg)
    want = jed.encoder_apply(jcfg, jparams, jnp.asarray(src), remat=False)
    layers = [tlm.encoder.layer(l) for l in range(tlm.encoder.n_layers)]
    got = ted.encoder_apply(tlm.cfg, layers, tlm.enc_norm,
                            torch.from_numpy(src))
    close(got, want)
    # Non-causal: the first position depends on the last frame.
    src2 = src.copy()
    src2[:, -1] += 1.0
    moved = ted.encoder_apply(tlm.cfg, layers, tlm.enc_norm,
                              torch.from_numpy(src2))
    assert not torch.allclose(moved[:, 0], got[:, 0])


@pytest.mark.parametrize("T", [1, 24, 100])
def test_cross_attention_matches_reference(T):
    """One decoder layer's cross K/V from a random memory and its
    cross-attention of T query rows (1: a decode step; 100: more rows than
    the 64-frame memory) against the reference's."""
    jcfg, _jlm, jparams, tlm = bridged(ARCH)
    cp_j = {k: v[0] for k, v in jparams["decoder"]["cross"].items()}
    cp_t = tlm.decoder.layer(0)["cross"]
    rng = np.random.default_rng(T)
    memory = _src(jcfg, seed=T + 1)
    h = rng.normal(size=(2, T, jcfg.d_model)).astype(np.float32)
    ckj, cvj = jed._cross_kv(jcfg, cp_j, jnp.asarray(memory))
    ckt, cvt = ted.cross_kv(cp_t, torch.from_numpy(memory))
    close(ckt, ckj)
    close(cvt, cvj)
    close(ted.cross_attend(cp_t, torch.from_numpy(h), ckt, cvt),
          jed._cross_attend(jcfg, cp_j, jnp.asarray(h), ckj, cvj))


def test_lm_prefill_and_decode_match_reference():
    """Random source frames and a 13-token prompt, then two decode steps:
    logits, the paged self-attention pools and the cross K/V state against
    the reference's; the pools hold the decoder's layers only."""
    tlm = check_lm_matches_reference(ARCH)
    cfg = tlm.cfg
    assert tlm.kv_layers() == cfg.encdec.dec_layers
    shapes = tlm.init_state_shapes(3, cfg.encdec.source_len)
    assert sorted(shapes) == ["cross_k", "cross_v"]
    assert shapes["cross_k"][0] == (cfg.encdec.dec_layers, 3,
                                    cfg.encdec.source_len, cfg.n_kv_heads,
                                    cfg.resolved_head_dim)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_encdec_engine_matches_reference(mode):
    """Greedy tokens and the modeled counters equal the reference's; each
    request's cross K/V rides preemption on the device; no prefix cache."""
    check_engine_matches_reference(ARCH, mode)


def test_fused_fails_on_encdec_in_the_reference_and_not_in_the_port():
    """The reference's fused encdec decode reads the whole layer-stacked
    stage in each layer and fails on the first step that stages pages
    (a shape error); the port's runs those steps, and its tokens equal
    the reference's sync tokens."""
    with pytest.raises((ValueError, TypeError)):
        serve("jax", ARCH, "fused")
    tokens, stats = serve("torch", ARCH, "fused")
    assert stats.fused_steps > 0 \
        and stats.fused_ready_pages + stats.fused_drained_pages > 0
    assert tokens == serve("jax", ARCH, "sync")[0]


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def test_chip_smoke_encdec_phase_on_cpu():
    """chip_smoke.py's phase 4h rehearsed on the CPU (plain versions) at
    smoke width (its 64-frame source: the schedule does not depend on the
    source length, which pages nothing): the stream and step hook in sync,
    async and fused, each run swapping, faulting and compacting, with
    identical tokens."""
    chip_smoke = _chip_smoke()
    cfg = dataclasses.replace(t_smoke(ARCH), dtype="float32")
    tokens = {}
    for mode in chip_smoke.MODES:
        eng, stream, events, counts, _wall = chip_smoke.serve_mode(
            cfg, mode, device="cpu")
        chip_smoke.check_mode_run(cfg, mode, eng, stream, events, counts)
        assert all(v == 0 for v in counts.values())
        assert not eng.states
        tokens[mode] = [list(r.out) for _, r in stream]
    assert tokens["async"] == tokens["sync"] == tokens["fused"]


def test_chip_smoke_encdec_agreement_on_cpu():
    """Phase 4h's card-vs-CPU check rehearsed with both runs on the CPU:
    random source frames, logits, pools and cross K/V."""
    chip_smoke = _chip_smoke()
    cfg = dataclasses.replace(t_smoke(ARCH), dtype="bfloat16")
    agree, routed, err = chip_smoke.lm_agreement(cfg, "cpu",
                                                 ref_dtype="float32")
    assert agree == 1.0 and routed == 0 and err <= 2e-2


def test_flash_sites_are_checked_and_counted_per_family():
    """The flash wrapper takes only its named call sites, and chip_smoke.py
    expects seamless's encoder and cross-attention launches by site (24
    each per admission, 24 cross-attention per decode step) and none of
    the other families'."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    q = torch.zeros((1, 4, 2, 32))
    with pytest.raises(ValueError, match="site"):
        ops.flash_attention(q, q, q, site="decoder")
    ops.reset_launch_counts()
    ops.flash_attention(q, q, q, causal=False, site="encoder")
    assert all(n == 0 for n in ops.flash_site_counts().values())
    chip_smoke = _chip_smoke()
    assert chip_smoke.site_launches(get_config(ARCH), 3, 5) == {
        "flash_attention.encoder": 72,
        "flash_attention.cross_prefill": 72,
        "flash_attention.cross_decode": 120}
    assert set(chip_smoke.site_launches(get_config("llava-next-mistral-7b"),
                                        3, 5).values()) == {0}
