"""Helpers shared by the cluster-tier parity tests (test_torch_cluster.py,
test_torch_router.py, test_torch_faults.py); the module holds no tests.

``make_cluster`` builds the reference's ``ServingCluster`` or the port's on
the f32 smoke config with the same weights (the reference's ``LM.init``,
bridged into the port's one shared LM), with the reference tests' pool
geometry.  ``cluster_state`` is what a run of either must reproduce: the
router's decisions, the frame table's, the tier's, the store's and the
spill store's counters, and each engine's modeled counters and clock.
Wall-clock fields, and the port's measured-transfer fields that the
reference has not, are left out.
"""

import dataclasses

import numpy as np
import torch

from repro.configs.base import PoolGeometry as JGeo
from repro.serving.cluster import ServingCluster as JCluster
from repro.serving.engine import EngineStats as JStats
from repro.serving.engine import Request as JRequest
from repro.serving.faults import FaultInjector as JInjector
from repro.serving.faults import FaultPlan as JPlan
from repro_torch.configs.base import PoolGeometry as TGeo
from repro_torch.serving.cluster import ServingCluster as TCluster
from repro_torch.serving.engine import EngineStats as TStats
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.faults import FaultInjector as TInjector
from repro_torch.serving.faults import FaultPlan as TPlan
from test_torch_parity_helpers import bridged

GEO_KW = dict(page_tokens=8, frame_pages=4, compact_threshold=0.4)
PTOK = GEO_KW["page_tokens"]
WALL = {"wall_s", "admit_hit_us", "admit_cold_us"}
ENGINE_FIELDS = sorted(
    {f.name for f in dataclasses.fields(JStats)}
    & {f.name for f in dataclasses.fields(TStats)} - WALL)
PACKAGES = ("jax", "torch")


def chip_smoke():
    """The ``chip_smoke`` module at the repository's root."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(root)
    return cs


def request_cls(package):
    return JRequest if package == "jax" else TRequest


def fault_injector(package, **plan):
    """A ``FaultInjector`` of ``package`` running ``FaultPlan(**plan)``."""
    if package == "jax":
        return JInjector(JPlan(**plan))
    return TInjector(TPlan(**plan))


def make_cluster(package, arch="qwen2.5-3b", **kw):
    """A ``ServingCluster`` of ``package`` on the f32 smoke config of
    ``arch`` with bridged weights, the reference tests' geometry and
    ``kw``; the port's runs its kernels' plain versions (CPU)."""
    jcfg, _jlm, jparams, tlm = bridged(arch)
    if package == "jax":
        cluster = JCluster(jcfg, geometry=JGeo(**GEO_KW), **kw)
        for e in cluster.engines:
            e.params = jparams
        return cluster
    cluster = TCluster(tlm.cfg, geometry=TGeo(**GEO_KW), device="cpu", **kw)
    cluster.engines[0].lm.load_state_dict(tlm.state_dict())
    return cluster


def prompt(rng, vocab, n):
    return rng.integers(0, vocab, n).astype(np.int32)


def engine_state(e):
    return {f: getattr(e.stats, f) for f in ENGINE_FIELDS} | {
        "clock_us": e._clock_us, "alive": e.alive,
        "backlog_us": e.translation_backlog_us()}


def cluster_state(cluster):
    """Everything a run of either package must reproduce (see the module
    doc)."""
    out = {"router": dataclasses.asdict(cluster.router.stats),
           "engines": [engine_state(e) for e in cluster.engines]}
    tier = cluster.tier
    if tier is not None:
        out |= {"frames": dict(tier.frames.stats), "tier": dict(tier.stats),
                "store": dict(tier.store.stats),
                "host_keys": sorted(tier.store._pages),
                "spilled_keys": sorted(tier._spilled)}
        if tier.spill_store is not None:
            out["spill"] = dict(tier.spill_store.stats)
    inj = cluster.fault_injector
    if inj is not None:
        out |= {"injector": dict(inj.stats), "log": list(inj.log)}
    return out


def assert_same_run(runs):
    """``runs``: {package: (cluster, tokens)}; the port's tokens and state
    equal the reference's."""
    (cj, tj), (ct, tt) = runs["jax"], runs["torch"]
    assert tt == tj
    sj, st = cluster_state(cj), cluster_state(ct)
    assert st.keys() == sj.keys()
    for k in sj:
        assert st[k] == sj[k], k


def payload(package, tag, shape=(1, PTOK, 1, 4)):
    """A (k, v) page payload in ``package``'s type: numpy for the
    reference, CPU torch tensors for the port."""
    k = np.full(shape, tag, np.float32)
    if package == "jax":
        return k, -k
    return torch.from_numpy(k), torch.from_numpy(-k)
