"""The PyTorch port stands alone: no JAX, nothing of the reference package.

Every ``repro_torch`` module is imported in a fresh interpreter with
``jax`` blocked; afterwards no ``jax`` or ``repro`` module may be loaded.
The sources of the port and of ``chip_smoke.py`` must not import either.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "repro" or m.startswith("repro.")
             or (m.startswith("jax") and sys.modules[m] is not None))
print(len(names), "modules")
print("BAD", bad)
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 38, out.stdout
    assert out.stdout.strip().endswith("BAD []"), out.stdout


_NAMED = r"""
import sys
sys.modules["jax"] = None
from repro_torch.serving.dma import AsyncDMAEngine, Prefetcher, StagingBuffer
from repro_torch.serving.engine import ServingEngine
from repro_torch.kernels.ops import KERNELS, fused_paged_attention_kernel
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.serving.host_tier import PrefixIndex, PrefixPage
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.mamba2 import MambaParams, ssm_stack_prefill
from repro_torch.models.hybrid import HybridParams, hybrid_stack_decode
from repro_torch.models.moe import MoEParams, moe_block
from repro_torch.models.mla import MLAParams, mla_block_decode
from repro_torch.models.page_ops import PageCtx, paged_attn_op
from repro_torch.kernels.paged_attention import MLA_DIMS
from repro_torch.models.encdec import CrossDecoderParams, encoder_apply
from repro_torch.models.lm import FAMILIES, LM
from repro_torch.configs import get_config, list_archs
assert "paged_attention.fused" in KERNELS and "flash_attention" in KERNELS
assert "ssd_scan" in KERNELS
assert get_config("zamba2-1.2b").family == "hybrid"
assert get_config("mamba2-1.3b").family == "ssm"
assert get_config("deepseek-v2-lite-16b").mla is not None
assert get_config("dbrx-132b").moe.n_experts == 16
assert {"deepseek-v2-lite-16b", "dbrx-132b"} <= set(list_archs())
assert MLA_DIMS == (576, 512)
assert len(list_archs()) == 10 and set(FAMILIES) == {
    get_config(a).family for a in list_archs()}
assert get_config("seamless-m4t-large-v2").encdec.source_len == 4096
assert get_config("llava-next-mistral-7b").frontend_tokens == 2880
assert get_config("qwen3-8b").qk_norm
assert ServingEngine.__init__.__kwdefaults__["fault_mode"] == "async"
assert ServingEngine.__init__.__kwdefaults__["prefix_cache"] is True
print("BAD", sorted(m for m in sys.modules
                    if m == "repro" or m.startswith("repro.")
                    or (m.startswith("jax") and sys.modules[m] is not None)))
"""


def test_async_pipeline_and_fused_kernel_import_without_jax():
    """The modules the slices add or extend (async and fused fault-in,
    the prefix cache, the flash-attention kernel, the SSD-scan kernel, the
    Mamba-2 and hybrid models, the MoE and MLA models, the encoder-decoder
    model, and their configs: all ten architectures), imported by name."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _NAMED], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "BAD []", out.stdout


_CLUSTER = r"""
import sys
sys.modules["jax"] = None
from repro_torch.core.ptw import CoalescedTLB, RadixWalker, TranslationMeter
from repro_torch.core.tlb_sim import LRU, AppTrace, Link, SimConfig, TranslationSim
from repro_torch.core.workloads import build_workload, homogeneous_names
from repro_torch.serving.faults import (FaultInjector, FaultPlan,
                                        SpillCorruptionError, SpillIOError)
from repro_torch.serving.host_tier import SpillStore
from repro_torch.serving.router import RequestRouter, RouterStats
from repro_torch.serving.cluster import (HostFrameTable, LeasedStoreView,
                                         ServingCluster, SharedHostTier)
from repro_torch.serving.engine import EngineStats, ServingEngine
from repro_torch.serving.kv_cache import ShardedKVCache
import repro_torch.launch.serve
assert ServingEngine.__init__.__kwdefaults__["translation"] == "off"
assert hasattr(ShardedKVCache, "pages_needed")
assert {"migrations_in", "promotions", "translation_walks",
        "prestage_hits", "lost_restarts"} <= set(EngineStats.__dataclass_fields__)
print("BAD", sorted(m for m in sys.modules
                    if m == "repro" or m.startswith("repro.")
                    or (m.startswith("jax") and sys.modules[m] is not None)))
"""


def test_cluster_tier_imports_without_jax():
    """The cluster slice's modules (translation model, faults, spill
    store, router, cluster, the serve CLI), imported by name."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _CLUSTER], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "BAD []", out.stdout


_TRAIN = r"""
import sys
sys.modules["jax"] = None
from repro_torch.train.trainer import Trainer, make_train_step
from repro_torch.train.optimizer import (adamw_init, adamw_update,
                                         global_norm, lr_schedule)
from repro_torch.train.checkpoint import latest_step, prune, restore, save
from repro_torch.train.grad_compress import BLOCK, _quant, pad_to_block
from repro_torch.data.pipeline import MemmapCorpus, Prefetcher, SyntheticLM
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention_bwd,
                                                 flash_attention_lse)
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_lse_ref)
from repro_torch.models.transformer import decoder_stack_train
import repro_torch.launch.train
assert BLOCK == 256
print("BAD", sorted(m for m in sys.modules
                    if m == "repro" or m.startswith("repro.")
                    or (m.startswith("jax") and sys.modules[m] is not None)))
"""


def test_training_path_imports_without_jax():
    """The training slice's modules (trainer, optimizer, checkpoints,
    gradient quantizer, data pipeline, the flash backward and the training
    CLI), imported by name."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _TRAIN], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "BAD []", out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)"
    r"|from\s+repro(\.|\s))", re.M)


def test_port_sources_never_import_jax_or_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _FORBIDDEN.search(f.read_text())]
    assert offenders == []


_MESH = r"""
import sys
sys.modules["jax"] = None
import repro_torch.launch.specs, repro_torch.launch.dryrun
from repro_torch.launch.specs import GEO, ServePlan, build_cell, serve_plan
from repro_torch.launch.sharding import serving_lm, serving_shard, shard_shape
from repro_torch.models.common import ParallelCtx, serving_ctx
from repro_torch.models.moe import ep2d_geometry
from repro_torch.models.paged import combine_partials
from repro_torch.bridge import serving_shard_from_jax
assert GEO.page_tokens == 64 and GEO.frame_pages == 16
print("BAD", sorted(m for m in sys.modules
                    if m == "repro" or m.startswith("repro.")
                    or (m.startswith("jax") and sys.modules[m] is not None)))
"""


def test_serving_mesh_and_dry_run_import_without_jax():
    """The serving-over-a-mesh slice's modules (``launch/specs.py``,
    ``launch/dryrun.py``, the serving shard and context, the 2-D EP
    geometry, the cross-rank combine), imported by name."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _MESH], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "BAD []", out.stdout
