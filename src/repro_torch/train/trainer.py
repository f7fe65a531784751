"""Training step builder and fault-tolerant loop, on one device or over
ranks: data parallelism, and tensor / expert parallelism over ``model``.

Counterpart of the reference's ``train/trainer.py`` over a
:class:`~repro_torch.launch.mesh.Mesh` of ``torch.distributed`` ranks.
``make_train_step`` builds one optimizer step on an :class:`LM`'s fp32
master weights, in the reference's order of operations:
  * each batch rank takes its rows of the global batch and accumulates its
    gradient over ``hp.microbatch`` sequential microbatches (activation
    memory = one microbatch), summed in f32 and averaged, with one
    reduction a step;
  * per-layer remat (``hp.remat``, see :func:`decoder_stack_train`);
  * optionally the int8 ring all-reduce with error feedback
    (``hp.grad_compress``) in place of the f32 reduction: each rank feeds
    it its own gradient (the reference's documented intent; its trainer
    feeds the ring an already all-reduced gradient, see
    :mod:`repro_torch.train.grad_compress`);
  * the reduction to each leaf's optimizer layout, global-norm clipping and
    AdamW (:mod:`repro_torch.train.optimizer`) on this rank's shards.

``hp.parallelism``:
  * ``megatron``: data parallelism over pod and data plus ZeRO-1, and over
    a ``model`` axis > 1 the reference's explicit tensor / expert-parallel
    blocks (:class:`~repro_torch.models.common.ParallelCtx`).  Each leaf
    the reference splits over ``model`` (``param_specs``) is held as this
    rank's model shard: the f32 master of that shard stays whole over the
    data ranks, each gradient is reduce-scattered over the data group only
    to its ``zero1_specs`` shard (all-reduced where that leaves it whole;
    the ``model`` sums happened inside the blocks), AdamW's moments live
    only as shards, the update runs on the shard and the new params are
    all-gathered over data.  (The reference also stores its f32 masters at
    the ZeRO-1 layout and gathers their bf16 copy once a step.)  A
    ``model``-split leaf that no explicit block takes at its shard (MLA,
    Mamba-2, the embeddings, encdec's cross-attention) is gathered over
    ``model`` where the loss casts it (:mod:`repro_torch.train.layout`'s
    three rules).  The grad norm sums every model shard's squares once.
  * ``auto``: the same layouts with no explicit block: every
    ``model``-split leaf is gathered and each model rank computes the
    whole model (the reference leaves it to GSPMD).
  * ``fsdp``: every mesh axis carries batch rows; the f32 params, their
    gradients and the moments are all ``fsdp_specs`` shards.  The loss
    gathers each sharded weight where it casts it to the compute dtype
    (:func:`~repro_torch.models.common.train_weight`), so the bf16 copy is
    whole during a step; the gather's backward reduce-scatters the f32
    gradient.

On one rank every collective is skipped: ``mesh=None`` is a (1, 1) mesh
and trains on one device, with ``grad_compress`` (``Q(g + e)``, no wire)
and ``fsdp`` (nothing to shard) as the reference runs them on its
one-device host mesh.

``Trainer`` runs the loop with atomic checkpoints every ``ckpt_every``
steps (each sharded leaf gathered over both axes to its full value, rank 0
writing), and ``resume=True`` restoring the newest complete one onto this
run's ranks, whatever the (data, model) mesh that wrote it.  The error
feedback of ``grad_compress`` is not saved, as in the reference: a resumed
run restarts it at zero.  SIGTERM on any rank finishes the current step
on every rank, checkpoints and stops.
"""

from __future__ import annotations

import functools
import math
import signal
import time
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import ModelConfig, TrainHParams
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharding import fsdp_specs, param_specs, zero1_specs
from repro_torch.models.common import ParallelCtx
from repro_torch.models.lm import LM
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.grad_compress import (
    BLOCK,
    compressed_allreduce_flat,
    pad_to_block,
    padded_size,
)
from repro_torch.train.layout import GatherFn, Placement, batch_axes, chunk_of
from repro_torch.train.optimizer import adamw_init, adamw_update


def configure_parallelism(hp: TrainHParams, mesh) -> Tuple[str, ...]:
    """The mesh's batch axes under ``hp.parallelism`` (megatron / auto:
    pod and data, ``model`` carrying tensor / expert parallelism; fsdp:
    every axis)."""
    return batch_axes(hp.parallelism, mesh)


def batch_spec(mesh, hp: TrainHParams):
    """The global batch's spec: dim 0 over the batch axes (one axis by its
    name, as a ``PartitionSpec`` normalises it)."""
    dp = batch_axes(hp.parallelism, mesh)
    return (dp if len(dp) > 1 else dp[0] if dp else None,)


def state_specs(params: Mapping, hp: TrainHParams, mesh):
    """(param specs, optimizer-moment specs) for the chosen parallelism:
    fsdp shards both; ZeRO-1 keeps the params at their tensor-parallel
    specs and shards the moments."""
    if hp.parallelism == "fsdp":
        f = fsdp_specs(params, mesh)
        return f, f
    return param_specs(params, mesh), zero1_specs(params, mesh)


def _keep_local(store: Dict[str, torch.Tensor], name: str,
                grad: torch.Tensor) -> None:
    """GatherFn's reduce under compression: keep the whole local gradient
    (summed over microbatches) for the ring; the shard gets none."""
    store[name] = grad if name not in store else store[name].add_(grad)


def _gather(gather, reduce, shard, dtype):
    return GatherFn.apply(shard, dtype, gather, reduce)


class TrainStep:
    """``step(opt_state, batch) -> (opt_state, metrics)``: one optimizer
    step on ``lm``'s master weights (see the module docstring).  ``batch``
    maps names to tensors or arrays with the global batch on dim 0
    (``tokens``, and vlm's ``patch_embeds`` or encdec's ``src_embeds``);
    every rank passes the same batch and trains on its rows (the model
    ranks of a data rank on the same ones).  metrics hold 0-d tensors
    ``loss``, ``nll``, ``aux`` (means over the batch ranks), ``grad_norm``
    and ``lr``.

    ``init_opt()`` makes the AdamW state at this rank's shards; ``shards()``
    are this rank's shards of the master weights (views); ``param_places``
    and ``places`` the leaves' :class:`Placement` as held (the model
    shard; fsdp's shard) and as the optimizer keeps them; ``par`` the
    forward's :class:`ParallelCtx`; ``ef`` the per-leaf error-feedback
    buffers under ``grad_compress``.  The LM's sharded parameters are
    replaced by their shards."""

    def __init__(self, lm: LM, hp: TrainHParams, mesh: Optional[Mesh] = None):
        self.lm, self.hp = lm, hp
        self.mesh = mesh if mesh is not None else Mesh((1, 1),
                                                       ("data", "model"))
        batch = configure_parallelism(hp, self.mesh)
        if self.mesh.size > 1:
            self.mesh.device_mesh()     # raises without a group of its size
        on_cuda = next(lm.parameters()).device.type == "cuda"
        if (dist.is_initialized() and dist.get_world_size() == self.mesh.size
                and dist.get_backend() == "nccl" and not on_cuda):
            raise RuntimeError(f"NCCL process group for weights on "
                               f"{next(lm.parameters()).device}: NCCL needs "
                               f"them on cuda (gloo for the CPU)")
        rank = dist.get_rank() if self.mesh.size > 1 else 0
        self.D = math.prod(self.mesh.shape[a] for a in batch)
        coords = self.mesh.coords(rank)
        self.data_rank = 0
        for a in batch:
            self.data_rank = self.data_rank * self.mesh.shape[a] + coords[a]
        self.group = self.mesh.group(batch)
        model_axes = tuple(a for a in self.mesh.axis_names if a not in batch)
        model_rank = 0
        for a in model_axes:
            model_rank = model_rank * self.mesh.shape[a] + coords[a]
        self.par = ParallelCtx(
            dp_group=self.group, model_group=self.mesh.group(model_axes),
            tp=math.prod(self.mesh.shape[a] for a in model_axes),
            model_rank=model_rank,
            mode="auto" if hp.parallelism == "auto" else "megatron")
        # The grad norm sums over every rank of the mesh.
        self.norm_group = self.mesh.group(self.mesh.axis_names)
        self.remat = {"none": False, "block": True}.get(hp.remat, hp.remat)
        self.n_micro = hp.microbatch if hp.microbatch and hp.microbatch > 1 \
            else 1
        self.fsdp = hp.parallelism == "fsdp"
        params = dict(lm.named_parameters())
        pspecs, mspecs = state_specs(params, hp, self.mesh)
        self.param_places = {n: Placement(p.shape, pspecs[n], self.mesh,
                                          batch, rank)
                             for n, p in params.items()}
        self.places = {n: Placement(p.shape, mspecs[n], self.mesh, batch,
                                    rank)
                       for n, p in params.items()}
        self.counted = {n for n, pl in self.places.items() if pl.counts}
        self._local: Dict[str, torch.Tensor] = {}
        self._shard_params()
        self.params = dict(lm.named_parameters())
        self.ef = None
        if hp.grad_compress:
            self.ef = {n: torch.zeros(
                padded_size(math.prod(self.places[n].model_shape), self.D),
                dtype=torch.float32, device=p.device)
                for n, p in self.params.items()}

    def _shard_params(self) -> None:
        """Replace each sharded parameter by the shard this rank holds:
        fsdp's, which the loss gathers whole (``train_gather``); or its
        model shard, gathered over ``model`` where no explicit block takes
        it at its shard (the layout's rule 3)."""
        for name, place in self.param_places.items():
            if not place.sharded:
                continue
            owner, _, leaf = name.rpartition(".")
            mod = self.lm.get_submodule(owner)
            full = getattr(mod, leaf)
            shard = nn.Parameter(place.take(full.detach()).clone(),
                                 requires_grad=full.requires_grad)
            if self.fsdp:
                reduce = (functools.partial(_keep_local, self._local, name)
                          if self.hp.grad_compress else place.reduce)
                shard.train_gather = functools.partial(_gather, place.gather,
                                                       reduce)
            elif not self.lm.model_local(name, self.par):
                shard.train_gather = functools.partial(
                    _gather, place.gather, chunk_of(place))
            setattr(mod, leaf, shard)
        for name in self.param_places:
            if self.lm.model_local(name, self.par) \
                    and self.param_places[name].model is None:
                raise ValueError(f"{name} enters an explicit block at its "
                                 f"model shard, but its spec does not split "
                                 f"it over model={self.par.tp}")

    def shards(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() if self.fsdp
                else self.places[n].take_data(p.detach())
                for n, p in self.params.items()}

    def init_opt(self):
        return adamw_init(self.shards())

    def _rows(self, batch):
        """This rank's rows of the global batch: for microbatch i, the
        rank's contiguous part of the global microbatch i (the reference's
        microbatch over the data-sharded batch)."""
        B = batch["tokens"].shape[0]
        k, D = self.n_micro, self.D
        if B % (k * D):
            raise ValueError(f"batch {B} does not split into {k} "
                             f"microbatches over {D} batch ranks")
        if D == 1:
            return batch
        return {key: v.reshape(k, D, B // (k * D), *v.shape[1:])
                [:, self.data_rank].reshape(B // D, *v.shape[1:])
                for key, v in batch.items()}

    def _compress(self, name: str, g: torch.Tensor, place: Placement):
        """The mean of every batch rank's ``g`` (this rank's model shard's
        gradient) through the int8 ring over the data group; this rank's
        shard of it, equal across the leaf's replicas."""
        flat, numel = pad_to_block(g, BLOCK * self.D)
        mean, self.ef[name] = compressed_allreduce_flat(flat, self.ef[name],
                                                        self.group)
        shard = place.take_data(mean[:numel].view(place.model_shape))
        return place.agree(shard.contiguous())

    def _reduce_grads(self) -> Dict[str, torch.Tensor]:
        """Each leaf's mean gradient over the microbatches and the batch
        ranks, at this rank's shard; frees the parameters' grads."""
        grads = {}
        for n, p in self.params.items():
            place = self.places[n]
            g = self._local.pop(n, None)
            if g is None:
                g = p.grad
            p.grad = None
            if self.n_micro > 1:
                g.div_(self.n_micro)
            if self.hp.grad_compress:
                g = self._compress(n, g, place)
            elif self.D > 1:
                # An fsdp shard's gradient was summed by GatherFn.
                if not (self.fsdp and place.sharded):
                    g = place.reduce(g)
                g.div_(self.D)
            grads[n] = g
        return grads

    @torch.no_grad()
    def _gather_params(self) -> None:
        """ZeRO-1: every batch rank's updated shard into the whole master
        of this rank's model shard."""
        for n, p in self.params.items():
            place = self.places[n]
            if place.data is not None:
                p.copy_(place.gather_data(place.take_data(p.detach())))

    def _mean(self, *values):
        """0-d tensors averaged over the batch ranks."""
        if self.group is None:
            return values
        means = torch.stack(values)
        dist.all_reduce(means, group=self.group)
        return tuple(means.div_(self.D).unbind(0))

    def __call__(self, opt, batch):
        batch = self._rows({k: torch.as_tensor(v) for k, v in batch.items()})
        mb = batch["tokens"].shape[0] // self.n_micro
        for p in self.params.values():
            p.grad = None
        lsum = None
        for i in range(self.n_micro):
            # Every key of the batch (tokens, patch_embeds, src_embeds) is
            # cut along dim 0, as the reference's _accum_grads does.
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, aux = self.lm.loss(micro, remat=self.remat, par=self.par)
            loss.backward()     # the f32 grads accumulate across micros
            lsum = loss.detach() if lsum is None else lsum + loss.detach()
        grads = self._reduce_grads()
        _, opt, om = adamw_update(
            self.shards(), grads, opt, self.hp,
            counted=self.counted if self.norm_group is not None else None,
            group=self.norm_group)
        del grads
        if not self.fsdp:
            self._gather_params()
        loss, nll, a = self._mean(lsum / self.n_micro, aux["nll"].detach(),
                                  aux["aux"].detach())
        return opt, {"loss": loss, "nll": nll, "aux": a, **om}

    @torch.no_grad()
    def loss(self, batch) -> float:
        """The current weights' loss on the global ``batch`` (no update):
        the mean over the batch ranks of their rows' total loss."""
        batch = self._rows({k: torch.as_tensor(v) for k, v in batch.items()})
        return float(self._mean(self.lm.loss(batch, remat=False,
                                             par=self.par)[0])[0])


def make_train_step(lm: LM, hp: TrainHParams,
                    mesh: Optional[Mesh] = None) -> TrainStep:
    """The step of ``lm`` under ``hp`` over ``mesh`` (None: one device)."""
    return TrainStep(lm, hp, mesh)


class Trainer:
    """Fault-tolerant training loop over ``mesh``'s ranks (None: one
    device), on ``device`` (``cuda`` unless the caller asks for the CPU;
    under a mesh, this rank's device).

    Weights: ``params`` (a state_dict of full arrays, e.g.
    ``bridge.params_from_jax`` of the reference's ``LM.init``) or drawn
    from ``generator`` (default: a generator on ``device`` seeded with
    ``seed``); every rank must start from the same weights, of which it
    keeps its shards.  Data: ``SyntheticLM`` from ``seed`` drawing
    the global batch (its rank 0 stream, as the reference's), of which each
    batch rank trains on its rows: tokens only, so the families that also
    take frontend embeddings (vlm, encdec) train through
    :func:`make_train_step` on batches their caller builds, as the
    reference trains them through ``LM.loss``.
    """

    def __init__(self, cfg: ModelConfig, hp: TrainHParams,
                 batch_per_step: int, seq_len: int, *,
                 mesh: Optional[Mesh] = None,
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
        self.step_fn = make_train_step(self.lm, hp, mesh)
        self.mesh = self.step_fn.mesh
        self.rank = dist.get_rank() if self.mesh.size > 1 else 0
        self.params = self.step_fn.params
        self.opt = self.step_fn.init_opt()
        self.log: List[Dict[str, float]] = []
        self.start_step = 0
        if resume and ckpt_dir:
            s = ckpt.latest_step(ckpt_dir)
            if s is not None:
                state, _ = ckpt.restore(ckpt_dir, s, self._state(),
                                        places=self._places())
                with torch.no_grad():
                    for n, p in self.params.items():
                        p.copy_(state["params"][n])
                        self.opt["mu"][n].copy_(state["opt"]["mu"][n])
                        self.opt["nu"][n].copy_(state["opt"]["nu"][n])
                self.opt["step"] = state["opt"]["step"]
                self.start_step = s

    def _state(self):
        return {"params": self.params, "opt": self.opt}

    def _places(self) -> Dict[str, Placement]:
        """Checkpoint path -> placement of every leaf held as a shard."""
        out = {}
        st = self.step_fn
        for n, place in st.places.items():
            if place.sharded:
                out[f"opt/mu/{n}"] = out[f"opt/nu/{n}"] = place
            if st.param_places[n].sharded:
                out[f"params/{n}"] = st.param_places[n]
        return out

    def _on_preempt(self, *_):
        self._preempted = True

    def _stop(self) -> bool:
        """Whether any rank was preempted (an all-reduce of the flags, so
        that every rank stops after the same step)."""
        if not (dist.is_initialized()
                and dist.get_world_size() == self.mesh.size):
            return self._preempted
        flag = torch.tensor([int(self._preempted)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def save(self, step: int):
        """Checkpoint ``step`` (collective: every rank calls it)."""
        if self.ckpt_dir:
            ckpt.save(self.ckpt_dir, step, self._state(),
                      extra={"data": self.data.state(step)},
                      places=self._places())
            ckpt.prune(self.ckpt_dir)

    def run(self, n_steps: int, log_every: int = 10
            ) -> List[Tuple[int, float]]:
        """``n_steps`` steps from ``start_step``; returns the (step, loss)
        history of the logged steps (every ``log_every``-th and the first).
        Each logged step also goes to ``self.log`` with its grad norm, its
        MoE load-balance ``aux`` (summed over the layers; 0 without MoE) and
        ``ms``: host time from the step's start until its loss was read
        (with ``log_every=1``, the step's own time).  SIGTERM on any rank
        during the loop checkpoints after the current step and stops every
        rank there.  Rank 0 prints."""
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
                    if self.rank == 0:
                        print(f"step {i+1}: loss={loss:.4f} gnorm={gn:.3f} "
                              f"{dt*1e3:.0f} ms/step", flush=True)
                if self.ckpt_every and (i + 1) % self.ckpt_every == 0:
                    self.save(i + 1)
                if self._stop():
                    self.save(i + 1)
                    print(f"rank {self.rank}: preempted at step {i+1}; "
                          f"checkpointed.", flush=True)
                    break
        finally:
            signal.signal(signal.SIGTERM, prev)
            pf.stop()
        return history
