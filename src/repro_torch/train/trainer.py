"""Training step builder and fault-tolerant loop on one device.

Counterpart of the reference's ``train/trainer.py`` without its mesh:

``make_train_step`` builds one optimizer step on an :class:`LM`'s fp32
master weights:
  * gradient accumulation over ``hp.microbatch`` sequential microbatches
    (activation memory = one microbatch), summed in f32 and averaged;
  * per-layer remat (``hp.remat``, see :func:`decoder_stack_train`);
  * global-norm clipping and AdamW (:mod:`repro_torch.train.optimizer`).

``Trainer`` runs the loop with atomic checkpoints every ``ckpt_every``
steps, ``resume=True`` restoring the newest complete one, and SIGTERM
handling (finish the current step, checkpoint, stop).

ZeRO-1, tensor parallelism, FSDP and the int8 compressed all-reduce are
multi-device features and wait for ROADMAP Queue 1 item 6: ``parallelism``
other than "megatron" (which on one device is plain data parallelism over
one rank) and ``grad_compress=True`` raise.
"""

from __future__ import annotations

import signal
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainHParams
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.models.lm import LM
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import adamw_init, adamw_update

_MULTI_DEVICE = "waits for multi-device training (ROADMAP Queue 1 item 6)"


def make_train_step(lm: LM, hp: TrainHParams) -> Callable:
    """Returns ``step(opt_state, batch) -> (opt_state, metrics)``: one
    optimizer step on ``lm``'s master weights, updated in place; ``batch``
    maps names to tensors or arrays with the batch on dim 0 (``tokens``,
    and vlm's ``patch_embeds`` or encdec's ``src_embeds``); metrics hold
    0-d tensors ``loss``, ``nll``, ``aux``, ``grad_norm`` and ``lr``."""
    if hp.grad_compress:
        raise NotImplementedError(f"grad_compress {_MULTI_DEVICE}")
    if hp.parallelism != "megatron":
        raise NotImplementedError(f"parallelism={hp.parallelism!r} "
                                  f"{_MULTI_DEVICE}")
    remat = {"none": False, "block": True}.get(hp.remat, hp.remat)
    params = dict(lm.named_parameters())
    n_micro = hp.microbatch if hp.microbatch and hp.microbatch > 1 else 1

    def train_step(opt, batch):
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        B = batch["tokens"].shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} "
                             f"microbatches")
        mb = B // n_micro
        for p in params.values():
            p.grad = None
        lsum = None
        for i in range(n_micro):
            # Every key of the batch (tokens, patch_embeds, src_embeds) is
            # cut along dim 0, as the reference's _accum_grads does.
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, aux = lm.loss(micro, remat=remat)
            loss.backward()     # the f32 grads accumulate across micros
            lsum = loss.detach() if lsum is None else lsum + loss.detach()
        grads = {n: p.grad for n, p in params.items()}
        if n_micro > 1:
            for g in grads.values():
                g.div_(n_micro)
        _, opt, om = adamw_update(params, grads, opt, hp)
        for p in params.values():
            p.grad = None
        return opt, {"loss": lsum / n_micro, "nll": aux["nll"].detach(),
                     "aux": aux["aux"].detach(), **om}

    return train_step


class Trainer:
    """Fault-tolerant training loop on one device (``cuda`` unless the
    caller asks for the CPU).

    Weights: ``params`` (a state_dict, e.g. ``bridge.params_from_jax`` of
    the reference's ``LM.init``) or drawn from ``generator`` (default: a
    generator on ``device`` seeded with ``seed``).  Data: ``SyntheticLM``
    from ``seed``, as the reference's: tokens only, so the families that
    also take frontend embeddings (vlm, encdec) train through
    :func:`make_train_step` on batches their caller builds, as the
    reference trains them through ``LM.loss``.
    """

    def __init__(self, cfg: ModelConfig, hp: TrainHParams,
                 batch_per_step: int, seq_len: int, *,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 resume: bool = False, seed: int = 0, device="cuda",
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device (pass device='cpu' "
                               "to train on the CPU)")
        self.cfg, self.hp = cfg, hp
        self.lm = LM(cfg, device=self.device, master=True)
        if params is not None:
            self.lm.load_state_dict(params)
        else:
            self.lm.init_weights(
                generator if generator is not None
                else torch.Generator(device=self.device).manual_seed(seed))
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self._preempted = False
        self.data = SyntheticLM(cfg.vocab_size, seq_len, batch_per_step,
                                seed=seed)
        self.params = dict(self.lm.named_parameters())
        self.opt = adamw_init(self.params)
        self.step_fn = make_train_step(self.lm, hp)
        self.log: List[Dict[str, float]] = []
        self.start_step = 0
        if resume and ckpt_dir:
            s = ckpt.latest_step(ckpt_dir)
            if s is not None:
                state, _ = ckpt.restore(ckpt_dir, s, self._state())
                with torch.no_grad():
                    for n, p in self.params.items():
                        p.copy_(state["params"][n])
                        self.opt["mu"][n].copy_(state["opt"]["mu"][n])
                        self.opt["nu"][n].copy_(state["opt"]["nu"][n])
                self.opt["step"] = state["opt"]["step"]
                self.start_step = s

    def _state(self):
        return {"params": self.params, "opt": self.opt}

    def _on_preempt(self, *_):
        self._preempted = True

    def save(self, step: int):
        if self.ckpt_dir:
            ckpt.save(self.ckpt_dir, step, self._state(),
                      extra={"data": self.data.state(step)})
            ckpt.prune(self.ckpt_dir)

    def run(self, n_steps: int, log_every: int = 10
            ) -> List[Tuple[int, float]]:
        """``n_steps`` steps from ``start_step``; returns the (step, loss)
        history of the logged steps (every ``log_every``-th and the first).
        Each logged step also goes to ``self.log`` with its grad norm, its
        MoE load-balance ``aux`` (summed over the layers; 0 without MoE) and
        ``ms``: host time from the step's start until its loss was read
        (with ``log_every=1``, the step's own time).  SIGTERM during the
        loop checkpoints after the current step and stops."""
        history = []
        pf = Prefetcher(self.data, start_step=self.start_step)
        prev = signal.signal(signal.SIGTERM, self._on_preempt)
        try:
            t0 = time.perf_counter()
            for i in range(self.start_step, self.start_step + n_steps):
                t_step = time.perf_counter()
                _, batch = next(pf)
                self.opt, m = self.step_fn(self.opt, batch)
                if (i + 1) % log_every == 0 or i == self.start_step:
                    loss = float(m["loss"])          # waits for the step
                    gn = float(m["grad_norm"])
                    now = time.perf_counter()
                    dt = (now - t0) / max(1, i + 1 - self.start_step)
                    history.append((i + 1, loss))
                    self.log.append(dict(step=i + 1, loss=loss, grad_norm=gn,
                                         aux=float(m["aux"]),
                                         ms=(now - t_step) * 1e3))
                    print(f"step {i+1}: loss={loss:.4f} gnorm={gn:.3f} "
                          f"{dt*1e3:.0f} ms/step", flush=True)
                if self.ckpt_every and (i + 1) % self.ckpt_every == 0:
                    self.save(i + 1)
                if self._preempted:
                    self.save(i + 1)
                    print(f"preempted at step {i+1}; checkpointed.",
                          flush=True)
                    break
        finally:
            signal.signal(signal.SIGTERM, prev)
            pf.stop()
        return history
