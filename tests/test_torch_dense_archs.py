"""The port's dense trio (llama3-8b, phi3-mini-3.8b, qwen3-8b) vs the
reference's, and every architecture of the registry.

Weights come from the reference's ``LM.init`` bridged into the port
(``params_from_jax``); inputs are drawn with numpy from a seed.  Float32
at rtol/atol 1e-4, as tests/test_torch_models.py (another framework sums
in another order); engine tokens and counters exact.  qwen3-8b is the
port's first qk-norm model: each head of q and k is RMS-normed before
RoPE, with its own weights.  llama3-8b (g = 4 at dh 128 at full width)
and phi3-mini (g = 1 at dh 96) take the dense stack as it was.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import transformer as jtr
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import list_archs
from repro_torch.models import transformer as ttr
from repro_torch.models.transformer import AttnParams

from test_torch_parity_helpers import (
    check_engine_matches_reference,
    check_lm_matches_reference,
    close,
    serve,
)

DENSE_TRIO = ("llama3-8b", "phi3-mini-3.8b", "qwen3-8b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions' tiny tensors otherwise
    spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registry_serves_the_references_ten_archs():
    """The port's registry lists the reference's ids in its order, and
    each config module is a copy: the published and the smoke configs
    equal the reference's field for field."""
    from repro.configs import get_config as j_config
    from repro.configs import list_archs as j_archs
    from repro_torch.configs import get_config as t_config
    assert list_archs() == j_archs()
    for arch in list_archs():
        for t, j in ((t_config, j_config), (t_smoke, j_smoke)):
            assert dataclasses.asdict(t(arch)) == dataclasses.asdict(j(arch))


def test_qk_norm_attention_block_matches_reference():
    """qwen3's attention block (prefill, causal) with random q_norm /
    k_norm weights: output and the roped K/V it writes."""
    cfg = dataclasses.replace(t_smoke("qwen3-8b"), dtype="float32")
    jcfg = dataclasses.replace(j_smoke("qwen3-8b"), dtype="float32")
    rng = np.random.default_rng(4)
    p = {k: np.array(v)[0] for k, v in jax.tree.map(
        np.asarray, jtr.init_attn_params(jax.random.PRNGKey(3), jcfg,
                                         1)).items()}
    for name in ("q_norm", "k_norm"):
        p[name] = rng.uniform(0.5, 1.5, p[name].shape).astype(np.float32)
    x = rng.normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11), (2, 11)).astype(np.int32)
    oj, kj, vj = jtr.attn_block_train(
        jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(pos))
    ot, kt, vt = ttr.attn_block_prefill(
        cfg, {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(x), torch.from_numpy(pos))
    for got, want in ((ot, oj), (kt, kj), (vt, vj)):
        close(got, want)


def test_qk_norm_weights_are_in_the_tree_and_start_at_one():
    params = AttnParams(t_smoke("qwen3-8b"), 3, torch.float32, "cpu")
    params.init_(torch.Generator().manual_seed(0))
    dh = t_smoke("qwen3-8b").resolved_head_dim
    assert params.q_norm.shape == params.k_norm.shape == (3, dh)
    assert bool((params.q_norm == 1).all() and (params.k_norm == 1).all())
    assert not hasattr(AttnParams(t_smoke("llama3-8b"), 3, torch.float32,
                                  "cpu"), "q_norm")


@pytest.mark.parametrize("arch", DENSE_TRIO)
def test_lm_prefill_and_decode_match_reference(arch):
    """Prefill of a 13-token prompt padded to two pages, then two decode
    steps: logits and both pools against the reference's."""
    tlm = check_lm_matches_reference(arch)
    assert hasattr(tlm.decoder.attn, "q_norm") == (arch == "qwen3-8b")


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_qwen3_engine_matches_reference(mode):
    check_engine_matches_reference("qwen3-8b", mode)


def test_qwen3_fused_engine_equals_reference_and_sync():
    """The reference's dense stack slices its staged pages per layer, so
    its fused mode runs; the port's equals it and its own sync tokens."""
    assert check_engine_matches_reference("qwen3-8b", "fused") \
        == serve("torch", "qwen3-8b", "sync")[0]


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def test_chip_smoke_dense_trio_phase_on_cpu():
    """chip_smoke.py's phase 4i rehearsed at smoke width on the CPU (plain
    versions): each of the three serves the stream's first four requests
    in sync, with the prefix cache missing and parking."""
    chip_smoke = _chip_smoke()
    for arch in chip_smoke.DENSE_ARCHS:
        cfg = dataclasses.replace(t_smoke(arch), dtype="float32")
        eng, stream, counts, _wall = chip_smoke.serve_stream(
            cfg, "sync", chip_smoke.DENSE_REQUESTS, device="cpu")
        assert len(stream) == chip_smoke.DENSE_REQUESTS
        chip_smoke.check_stream_run(cfg, f"dense:{arch}:sync", eng, stream,
                                    counts)
        assert all(v == 0 for v in counts.values())


def test_chip_smoke_qk_norm_agreement_on_cpu():
    """Phase 4i's card-vs-CPU check of qwen3-8b rehearsed with both runs
    on the CPU (the reference run in float32, as on the card)."""
    chip_smoke = _chip_smoke()
    cfg = dataclasses.replace(t_smoke("qwen3-8b"), dtype="bfloat16")
    agree, routed, err = chip_smoke.lm_agreement(cfg, "cpu",
                                                 ref_dtype="float32")
    assert agree == 1.0 and routed == 0 and err <= 2e-2


def test_path_launches_count_every_attention_of_each_family():
    """chip_smoke.py's launch identity at the published configs: (flash
    per prefill, SSD scans per prefill, paged per decode step, flash per
    decode step); seamless runs 24 encoder, 24 self- and 24 cross-attention
    flash calls per admission and 24 cross-attention ones per step."""
    from repro_torch.configs import get_config
    chip_smoke = _chip_smoke()
    want = {"llava-next-mistral-7b": (32, 0, 32, 0),
            "seamless-m4t-large-v2": (72, 0, 24, 24),
            "qwen3-8b": (36, 0, 36, 0), "phi3-mini-3.8b": (32, 0, 32, 0),
            "zamba2-1.2b": (6, 38, 6, 0), "mamba2-1.3b": (0, 48, 0, 0),
            "deepseek-v2-lite-16b": (27, 0, 27, 0)}
    for arch, counts in want.items():
        assert chip_smoke.path_launches(get_config(arch)) == counts, arch

