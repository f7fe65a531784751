"""The port's ssm (mamba2-1.3b) and hybrid (zamba2-1.2b) families vs the
reference's.

Smoke configs in float32, weights from the reference's ``LM.init`` bridged
into the port (``load_state_dict(strict=True)``), inputs drawn with numpy
from a seed.  Tolerances: rtol/atol 1e-4 for logits, states and pools (the
same math in another framework sums the matmuls, einsums and the scan in
another order: f32 rounding ~1e-7 relative, amplified through the layers
and the recurrence); engine tokens and modeled counters exact.  The port
runs its kernels' plain versions here (CPU tensors).

Two behaviours of the reference are pinned rather than copied blindly:
the engine prefills a prompt right-padded to a page multiple and the
recurrent state absorbs the pad tokens (reproduced on purpose, so the
port's tokens stay the reference's), and the reference's fused decode of
the hybrid family fails once a step stages pages (not reproduced: the
port's fused tokens equal sync's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import PoolGeometry as JGeo
from repro.models import mamba2 as jm2
from repro.models.lm import LM as JLM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.kv_cache import ShardedKVCache as JCache
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import PoolGeometry as TGeo
from repro_torch.kernels import ops
from repro_torch.models import mamba2 as tm2
from repro_torch.models.lm import LM as TLM
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.kv_cache import ShardedKVCache as TCache

F32 = dict(rtol=1e-4, atol=1e-4)
GEO_KW = dict(page_tokens=8, frame_pages=4)
NP, MPPS, PTOK = 32, 12, 8
# (arch, config overrides): the two smoke configs and a hybrid whose last
# Mamba-2 layer forms a trailing group (5 layers, period 2).
VARIANTS = {"mamba2": ("mamba2-1.3b", {}), "zamba2": ("zamba2-1.2b", {}),
            "zamba2_tail": ("zamba2-1.2b", dict(n_layers=5))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions' tiny tensors otherwise
    spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_BRIDGED = {}


def _bridged(variant):
    """(reference cfg, reference LM, its params, port LM on the same
    weights), built once per variant."""
    if variant not in _BRIDGED:
        arch, kw = VARIANTS[variant]
        jcfg = dataclasses.replace(j_smoke(arch), dtype="float32", **kw)
        tcfg = dataclasses.replace(t_smoke(arch), dtype="float32", **kw)
        params = jax.tree.map(np.asarray,
                              JLM(jcfg).init(jax.random.PRNGKey(0)))
        tlm = TLM(tcfg)
        tlm.load_state_dict(params_from_jax(params), strict=True)
        _BRIDGED[variant] = (jcfg, JLM(jcfg),
                             jax.tree.map(jnp.asarray, params), tlm)
    return _BRIDGED[variant]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or F32))


# ------------------------------------------------------------------ blocks


@pytest.mark.parametrize("variant", ["mamba2", "zamba2"])
def test_mamba_block_prefill_and_decode_match_reference(variant):
    """One Mamba-2 block: the chunked prefill (T = 45, padded to the
    32-row chunk with inert dt = 0 rows) with its final state and conv
    tail, then two recurrent decode steps from that state."""
    jcfg, _jlm, jparams, tlm = _bridged(variant)
    tree = jparams["decoder"]["mamba"]
    lead = (0,) if variant == "mamba2" else (0, 0)
    jp = jax.tree.map(lambda a: a[lead], tree)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 45, jcfg.d_model)).astype(np.float32)
    yj, (hj, cj) = jm2.mamba_block_train(jcfg, jp, jnp.asarray(x),
                                         return_state=True)
    yt, (ht, ct) = tm2.mamba_block_train(tlm.cfg, tp, torch.from_numpy(x),
                                         return_state=True)
    _close(yt, yj)
    _close(ht, hj)
    _close(ct, cj)
    for i in range(2):
        xi = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        yj, hj, cj = jm2.mamba_block_decode(jcfg, jp, jnp.asarray(xi), hj,
                                            cj)
        yt, ht, ct = tm2.mamba_block_decode(tlm.cfg, tp, torch.from_numpy(xi),
                                            ht, ct)
        _close(yt, yj)
        _close(ht, hj)
        _close(ct, cj)


# ------------------------------------------------------------------ LM


def _pools(lm, package):
    shapes = lm.pool_shapes(NP, PTOK)
    if shapes is None:
        return None
    shape = shapes[0][0] if package == "torch" else shapes[0].shape
    if package == "torch":
        return (torch.zeros(shape), torch.zeros(shape))
    return (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_lm_prefill_and_decode_match_reference(variant):
    """Prefill of a 13-token prompt padded to two pages, then two decode
    steps: logits, the KV pools (hybrid) and the ssm / conv state against
    the reference's; pool and state shapes are the reference's."""
    jcfg, jlm, jparams, tlm = _bridged(variant)
    pj, pt = _pools(jlm, "jax"), _pools(tlm, "torch")
    if pt is None:
        assert jlm.pool_shapes(NP, PTOK) is None and tlm.kv_layers() == 0
    else:
        assert pt[0].shape == pj[0].shape
        assert tlm.kv_layers() == jlm.kv_layers()
    jshapes = jlm.init_state_shapes(1, dtype=jnp.float32)
    for k, (shape, dtype) in tlm.init_state_shapes(1).items():
        assert shape == jshapes[k].shape, k
        assert dtype == (torch.float32 if k == "ssm"
                         else getattr(torch, tlm.cfg.dtype))
    jc, tc = (JCache(JGeo(**GEO_KW), NP, 1), TCache(TGeo(**GEO_KW), NP, 1))
    rng = np.random.default_rng(2)
    T = 13
    for c in (jc, tc):
        c.allocate(0, T)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :T] = rng.integers(0, jcfg.vocab_size, T)
    lj, pj, sj = jlm.prefill(jparams, {"tokens": jnp.asarray(toks)}, pj,
                             jc.pack_ctx([0], MPPS),
                             last_pos=jnp.asarray([T - 1]))
    lt, pt, st = tlm.prefill({"tokens": torch.from_numpy(toks)}, pt,
                             tc.pack_ctx([0], MPPS),
                             last_pos=torch.tensor([T - 1]))
    _close(lt, lj)
    assert set(st) == set(sj) == {"ssm", "conv"}
    for k in st:
        assert tuple(st[k].shape) == sj[k].shape
        _close(st[k], sj[k])
    nxt = int(np.argmax(_np(lj)[0]))
    for _ in range(2):
        for c in (jc, tc):
            c.append(0)
        pos = np.array([jc.seq_tokens[0] - 1], np.int32)
        lj, pj, sj = jlm.decode_step(jparams, jnp.asarray([nxt]),
                                     jnp.asarray(pos), pj,
                                     jc.pack_ctx([0], MPPS), sj)
        lt, pt, st = tlm.decode_step(torch.tensor([nxt], dtype=torch.int32),
                                     torch.from_numpy(pos), pt,
                                     tc.pack_ctx([0], MPPS), st)
        _close(lt, lj)
        for k in st:
            _close(st[k], sj[k])
        nxt = int(np.argmax(_np(lj)[0]))
    if pt is not None:
        for a, b in zip(pt, pj):
            _close(a, b)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_after_prefill_matches_full_forward(variant):
    """test_smoke_archs' check in the port: prefill T tokens, then decode
    two, gives the logits of one prefill over all T + 2 tokens at its last
    real position (the recurrent state and the paged KV carry everything).
    Pool writes take whole pages, so T is a page multiple and the full
    prefill is right-padded to one; the pad after the last real token
    cannot reach that row's logits."""
    _jcfg, _jlm, _jparams, tlm = _bridged(variant)
    cfg = tlm.cfg
    rng = np.random.default_rng(3)
    T, B = 24, 2
    toks = rng.integers(0, cfg.vocab_size, (B, T + 2)).astype(np.int32)
    cache = TCache(TGeo(**GEO_KW), NP, 1)
    for b in range(B):
        cache.allocate(b, T)
    pools = _pools(tlm, "torch")
    _, pools, state = tlm.prefill({"tokens": torch.from_numpy(toks[:, :T])},
                                  pools, cache.pack_ctx([0, 1], MPPS))
    for i in range(2):
        for b in range(B):
            cache.append(b)
        logits, pools, state = tlm.decode_step(
            torch.from_numpy(toks[:, T + i]), torch.full((B,), T + i),
            pools, cache.pack_ctx([0, 1], MPPS), state)
    full_cache = TCache(TGeo(**GEO_KW), NP, 1)
    for b in range(B):
        full_cache.allocate(b, T + 2)
    padded = np.zeros((B, T + PTOK), np.int32)
    padded[:, :T + 2] = toks
    full, _, _ = tlm.prefill(
        {"tokens": torch.from_numpy(padded)}, _pools(tlm, "torch"),
        full_cache.pack_ctx([0, 1], MPPS), last_pos=torch.full((B,), T + 1))
    torch.testing.assert_close(logits, full, **F32)


def test_page_padding_enters_the_recurrent_state_in_both_packages():
    """The reference's engine prefills a prompt right-padded with token 0
    to a page multiple (``repro/serving/engine.py:1619-1627``), and its
    ssm / hybrid prefill folds the pad tokens into the state: ``last_pos``
    only picks the logits row.  The port reproduces that on purpose.  A
    13-token prompt padded to 16: the first-token logits equal the
    unpadded prompt's, the states do not; both packages agree on the
    padded state."""
    jcfg, jlm, jparams, tlm = _bridged("mamba2")
    rng = np.random.default_rng(4)
    prompt = rng.integers(1, jcfg.vocab_size, 13).astype(np.int32)
    padded = np.zeros((1, 16), np.int32)
    padded[0, :13] = prompt
    runs = {}
    for name, toks in (("padded", padded), ("exact", prompt[None])):
        lj, _, sj = jlm.prefill(jparams, {"tokens": jnp.asarray(toks)}, None,
                                None, last_pos=jnp.asarray([12]))
        lt, _, st = tlm.prefill({"tokens": torch.from_numpy(toks)}, None,
                                None, last_pos=torch.tensor([12]))
        _close(lt, lj)
        for k in st:
            _close(st[k], sj[k])
        runs[name] = (lt, st)
    _close(runs["padded"][0], runs["exact"][0])
    for k in ("ssm", "conv"):
        diff = float((runs["padded"][1][k] - runs["exact"][1][k]).abs().max())
        assert diff > 1e-2, (k, diff)
    # The port's engine takes its state after the padded prompt.
    eng = TEngine(tlm.cfg, geometry=TGeo(**GEO_KW), max_batch=1, max_seq=64,
                  params=tlm.state_dict(), device="cpu")
    eng.submit(TRequest(rid=0, tenant=0, prompt=prompt, max_new=4))
    eng._admit()
    for k in ("ssm", "conv"):
        assert torch.equal(eng.states[0][k], runs["padded"][1][k])


# ------------------------------------------------------------------ engine


COUNTERS = ("faults", "fault_dmas", "bytes_in", "transfer_us",
            "fault_exposed_us", "fault_hidden_us", "prefetch_hits",
            "prefetch_misses", "prefetch_wasted", "evict_pages", "evict_dmas",
            "bytes_out", "evict_us", "swaps_out", "swaps_in",
            "compaction_copies", "prefill_tokens", "decode_tokens",
            "decode_steps")
ENGINE_KW = dict(max_batch=3, max_seq=160, oversubscription=3.0,
                 decode_window_us=50.0)


def _serve(package, variant, mode, manager="mosaic"):
    """Six requests (prompts of 40 + 11 i tokens, request 4 at priority 1);
    four arrive first, two at step 3.  Returns (tokens, stats)."""
    jcfg, _jlm, jparams, tlm = _bridged(variant)
    if package == "jax":
        eng = JEngine(jcfg, geometry=JGeo(**GEO_KW), manager_kind=manager,
                      params=jparams, fault_mode=mode, **ENGINE_KW)
        R = JRequest
    else:
        eng = TEngine(tlm.cfg, geometry=TGeo(**GEO_KW), manager_kind=manager,
                      params=tlm.state_dict(), fault_mode=mode, device="cpu",
                      **ENGINE_KW)
        R = TRequest
    rng = np.random.default_rng(0)
    reqs = [R(rid=i, tenant=i % 3, max_new=12, priority=int(i == 4),
              prompt=rng.integers(0, jcfg.vocab_size, 40 + 11 * i)
              .astype(np.int32)) for i in range(6)]
    for r in reqs[:4]:
        eng.submit(r)
    for step in range(400):
        if step == 3:
            for r in reqs[4:]:
                eng.submit(r)
        eng.step()
        if all(r.done for r in reqs):
            break
    assert all(r.done for r in reqs)
    if package == "torch":
        assert not eng.states             # dropped at completion
    return [list(r.out) for r in reqs], eng.stats


@pytest.fixture(scope="module")
def zamba2_runs():
    runs = {("jax", m): _serve("jax", "zamba2", m) for m in ("sync", "async")}
    runs.update({("torch", m): _serve("torch", "zamba2", m)
                 for m in ("sync", "async", "fused")})
    return runs


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_zamba2_engine_matches_reference(zamba2_runs, mode):
    """Greedy tokens and the modeled counters equal the reference's; the
    stream swaps out and faults its shared-block KV pages back in."""
    tok_j, st_j = zamba2_runs[("jax", mode)]
    tok_t, st_t = zamba2_runs[("torch", mode)]
    assert tok_t == tok_j
    for c in COUNTERS:
        assert getattr(st_t, c) == getattr(st_j, c), c
    assert st_t.swaps_out >= 1 and st_t.faults >= 1
    if mode == "async":
        assert st_t.prefetch_hits > 0


def test_zamba2_fused_engine_equals_sync(zamba2_runs):
    """The port's fused decode reads staged pages through each shared-block
    invocation's own stage slice and emits sync's tokens (the reference's
    fused run fails there: ROADMAP.md, Queue 3)."""
    tok_f, st_f = zamba2_runs[("torch", "fused")]
    assert st_f.fused_steps > 0
    assert st_f.fused_ready_pages + st_f.fused_drained_pages > 0
    assert tok_f == zamba2_runs[("torch", "sync")][0]
    assert tok_f == zamba2_runs[("jax", "sync")][0]


def test_mamba2_engine_matches_reference_in_sync():
    """The ssm family has no KV pool: pages are bookkeeping only, swaps
    move no bytes, and the recurrent state stays put across preemption."""
    tok_j, st_j = _serve("jax", "mamba2", "sync")
    tok_t, st_t = _serve("torch", "mamba2", "sync")
    assert tok_t == tok_j
    for c in COUNTERS:
        assert getattr(st_t, c) == getattr(st_j, c), c
    assert st_t.swaps_out >= 1
    assert st_t.faults == st_t.h2d_bytes == st_t.d2h_bytes == 0


def test_mamba2_port_modes_agree():
    """The port's async and fused engines emit sync's tokens on the ssm
    family.  (The reference's async engine fails at the first preemption
    here, ROADMAP.md Queue 3, so the port is held to its own sync run.)"""
    sync = _serve("torch", "mamba2", "sync")[0]
    for mode in ("async", "fused"):
        assert _serve("torch", "mamba2", mode)[0] == sync


def test_prefix_cache_stays_off_for_recurrent_families():
    """As the reference: cached KV cannot restore recurrent state, so no
    prefix index is built and nothing parks."""
    for variant in ("mamba2", "zamba2"):
        tlm = _bridged(variant)[3]
        eng = TEngine(tlm.cfg, geometry=TGeo(**GEO_KW), max_batch=2,
                      max_seq=64, params=tlm.state_dict(), device="cpu")
        assert not eng.prefix_supported and eng.prefix is None
        assert (eng.pools is None) == (variant == "mamba2")
        # K and V of G = 2 invocations, 4 KV heads of 16, bf16 pools.
        assert eng.page_bytes == (0 if variant == "mamba2" else
                                  2 * 2 * PTOK * 4 * 16 * 2)


def test_chip_smoke_recurrent_phases_on_cpu():
    """chip_smoke.py's phases 4c and 4d rehearsed at smoke width on the
    CPU (plain versions): the stream completes, the hybrid swaps and
    faults, and the modes agree on every token."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    for arch, modes, n in ((chip_smoke.HYBRID_ARCH, chip_smoke.MODES, 8),
                           (chip_smoke.SSM_ARCH, chip_smoke.SSM_MODES,
                            chip_smoke.SSM_REQUESTS)):
        cfg = dataclasses.replace(t_smoke(arch), dtype="float32")
        tokens = {}
        for mode in modes:
            eng, stream, counts, _wall = chip_smoke.serve_stream(
                cfg, mode, n, device="cpu")
            chip_smoke.check_stream_run(cfg, mode, eng, stream, counts)
            assert all(v == 0 for v in counts.values())
            tokens[mode] = [r.out for _, r in stream]
        assert all(tokens[m] == tokens[modes[0]] for m in modes)
    assert ops.launch_counts()["ssd_scan"] == 0
