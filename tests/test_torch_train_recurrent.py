"""The port's ``Trainer`` on the ssm and hybrid families against the
reference's, and ``chip_smoke.py``'s phases 9d-9h rehearsed on the CPU.

mamba2-1.3b and zamba2-1.2b (f32 smoke configs) train from the same
weights (``bridge.params_from_jax`` of the reference's ``LM.init``) on the
same ``SyntheticLM`` batches in both packages: the first three steps'
losses within 1e-4 relative (f32, other summation order through a few
layers and the optimizer), as tests/test_torch_train.py holds the dense
family's ``Trainer``.  The rehearsals run each phase's code with the card's
run on the CPU (launch counts all 0) at smoke width.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import TrainHParams as JHP
from repro.launch.mesh import make_host_mesh
from repro.models.lm import LM as JLM
from repro.train.trainer import Trainer as JTrainer
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainHParams
from repro_torch.train.trainer import Trainer

HP = dict(lr=1e-3, warmup_steps=2, total_steps=50, microbatch=0,
          remat="block", grad_compress=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Plain versions on tiny tensors: one intra-op thread, so that
    workers running side by side do not spin against each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def chip_smoke():
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_trainer_on_cpu_matches_the_reference(arch, tmp_path):
    """Three steps of the port's Trainer and the reference's on the same
    weights and data: every loss within 1e-4 relative, all finite."""
    jcfg = dataclasses.replace(j_smoke(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jparams = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(0)))
    tr = Trainer(cfg, TrainHParams(**HP), batch_per_step=2, seq_len=64,
                 ckpt_dir=str(tmp_path / "p"), ckpt_every=0, device="cpu",
                 params=params_from_jax(jparams))
    hist = tr.run(3, log_every=1)
    jtr = JTrainer(jcfg, JHP(**HP), make_host_mesh(), batch_per_step=2,
                   seq_len=64, ckpt_dir=str(tmp_path / "j"), ckpt_every=0)
    jhist = jtr.run(3, log_every=1)
    assert [s for s, _ in hist] == [s for s, _ in jhist] == [1, 2, 3]
    for (_, got), (_, want) in zip(hist, jhist):
        assert np.isfinite(got)
        assert got == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b",
                                  "seamless-m4t-large-v2", "mamba2-1.3b",
                                  "zamba2-1.2b"])
def test_chip_smoke_phase_9h_rehearsed_on_the_cpu(chip_smoke, arch):
    """Phase 9h's narrow f32 model of each family, the card's run on the
    CPU: the code path, the narrow configs' shapes and the agreement
    check."""
    chip_smoke.family_train_agreement(arch, "cpu", steps=2)


@pytest.mark.parametrize("arch,B,T,n_front", [
    ("seamless-m4t-large-v2", 2, 32, 64),
    ("llava-next-mistral-7b", 1, 32, 16),
])
def test_chip_smoke_phases_9d_9e_rehearsed_on_the_cpu(chip_smoke, arch, B,
                                                      T, n_front):
    """Phases 9d and 9e at smoke width with bf16 compute, the card's run
    on the CPU: three steps, finite, the last batch's loss falls after its
    update."""
    cfg = get_smoke_config(arch)
    counts = chip_smoke.phase_train_frontend(cfg, cfg.family, B, T, n_front,
                                             dev="cpu")
    assert not any(counts.values())


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_chip_smoke_phases_9f_9g_rehearsed_on_the_cpu(chip_smoke, arch):
    """Phases 9f and 9g at smoke width (bf16 compute, remat block), the
    card's run on the CPU."""
    cfg = get_smoke_config(arch)
    counts = chip_smoke.phase_train_recurrent(cfg, cfg.family, "block", B=2,
                                              T=64, dev="cpu")
    assert not any(counts.values())


def test_chip_smoke_train_launches_account_for_every_layer(chip_smoke):
    """The launches phases 9d-9h expect at full size: per step 72 flash
    forwards-and-backwards for seamless's 24 encoder, 24 self- and 24
    cross-attention layers (forwards twice under remat), the encoder's
    and the cross-attention's also by site, 48 SSD scans for mamba2 (twice
    under remat), 38 SSD scans and 6 shared-block calls for zamba2
    whatever remat says; and the kernels line's entries take each
    family's launches at its own shape, seamless's by site."""
    from repro_torch.configs import get_config
    enc = get_config("seamless-m4t-large-v2")
    no_site = {f"{k}.{s}": 0 for k in ("flash_attention.train",
                                       "flash_attention_bwd")
               for s in ("encoder", "cross_prefill", "cross_decode")}
    assert chip_smoke.train_launches(enc, 3) == {
        **no_site, "flash_attention.train": 432, "flash_attention_bwd": 216,
        "ssd_scan_bwd": 0, "ssd_scan": 0,
        "flash_attention.train.encoder": 144,
        "flash_attention.train.cross_prefill": 144,
        "flash_attention_bwd.encoder": 72,
        "flash_attention_bwd.cross_prefill": 72}
    assert chip_smoke.train_launches(get_config("mamba2-1.3b"), 3) == {
        **no_site, "flash_attention.train": 0, "flash_attention_bwd": 0,
        "ssd_scan_bwd": 144, "ssd_scan": 288}
    for remat in (True, False):
        assert chip_smoke.train_launches(get_config("zamba2-1.2b"), 3,
                                         remat) == {
            **no_site, "flash_attention.train": 18,
            "flash_attention_bwd": 18, "ssd_scan_bwd": 114, "ssd_scan": 114}
    vlm = dataclasses.replace(get_config("llava-next-mistral-7b"),
                              n_layers=chip_smoke.VLM_TRAIN_LAYERS)
    runs = {"encdec": chip_smoke.train_launches(enc, 3),
            "vlm": chip_smoke.train_launches(vlm, 3),
            "ssm": chip_smoke.train_launches(get_config("mamba2-1.3b"), 3),
            "hybrid": chip_smoke.train_launches(get_config("zamba2-1.2b"),
                                                3)}
    assert chip_smoke.train_entries(runs) == {
        "flash_attention_bwd.encoder": 72, "flash_attention_bwd.cross": 72,
        "flash_attention_bwd.decoder": 72, "flash_attention_bwd.vlm": 24,
        "flash_attention_bwd.hybrid": 18,
        "flash_attention.train.encoder": 144,
        "flash_attention.train.cross": 144,
        "flash_attention.train.decoder": 144,
        "flash_attention.train.vlm": 48, "flash_attention.train.hybrid": 18,
        "ssd_scan_bwd": 144, "ssd_scan_bwd.hybrid": 114,
        "ssd_scan.train": 288, "ssd_scan.train.hybrid": 114}
    # The flash entries' tags are the shapes phase 9a times.
    tags = {t[0] for t in chip_smoke.FLASH_BWD_SHAPES}
    assert tags == {"vlm", "encoder", "cross", "decoder", "hybrid"}
