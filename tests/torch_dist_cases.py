"""Rank functions of the port's data-, tensor- and expert-parallel tests.

Each runs on every rank of a gloo group started by
``repro_torch.launch.spawn.run_ranks`` (see
``tests/test_torch_train_dist.py`` and ``tests/test_torch_train_tp.py``)
and returns tensors, numbers and strings.  No JAX here: the ranks import
only torch and the port.
"""

import contextlib
import dataclasses
import os
import shutil
import signal
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainHParams
from repro_torch.launch.mesh import Mesh
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import grad_compress as gc
from repro_torch.train.trainer import Trainer

HP = dict(lr=1e-3, warmup_steps=2, total_steps=50, microbatch=0,
          remat="none", grad_compress=False)


def ring(path):
    """The ring and the compressed all-reduce on this rank's rows of the
    inputs at ``path`` (x, g, e: [world, n])."""
    torch.set_num_threads(1)
    r, world = dist.get_rank(), dist.get_world_size()
    data = np.load(path)
    x, g, e = (torch.from_numpy(data[k][r].copy()) for k in ("x", "g", "e"))
    group = dist.group.WORLD
    mean, err = gc.compressed_allreduce_flat(g, e, group)
    return {"ring": gc._ring_allreduce_q(x, group), "mean": mean,
            "err": err}


class Collectives:
    """Counts the collectives issued while active: (op, dtype, numel of
    the first tensor argument, ranks n of the group; a point-to-point op
    n = 2)."""

    OPS = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor",
           "broadcast")

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self.saved = {op: getattr(dist, op) for op in self.OPS}
        self.saved["batch_isend_irecv"] = dist.batch_isend_irecv
        for op in self.OPS:
            setattr(dist, op, self._wrap(op))

        def p2p(ops):
            for o in ops:
                self.calls.append((o.op.__name__, str(o.tensor.dtype),
                                   o.tensor.numel(), 2))
            return self.saved["batch_isend_irecv"](ops)
        dist.batch_isend_irecv = p2p
        return self

    def _wrap(self, op):
        fn = self.saved[op]

        def wrapped(t, *a, **kw):
            self.calls.append((op, str(t.dtype), t.numel(),
                               dist.get_world_size(kw.get("group"))))
            return fn(t, *a, **kw)
        return wrapped

    def __exit__(self, *exc):
        for op, fn in self.saved.items():
            setattr(dist, op, fn)

    def sent(self):
        """{kind: bytes this rank sent} and their total, as a ring moves
        them over a group of n ranks (``launch/dryrun.py``'s convention):
        (n - 1) / n of a gathered output or a scattered input (n times the
        recorded output shard), 2 (n - 1) / n of an all-reduced tensor; a
        broadcast or a send counts its whole tensor."""
        kinds = {"all_reduce": "all_reduce",
                 "all_gather_into_tensor": "all_gather",
                 "reduce_scatter_tensor": "reduce_scatter",
                 "broadcast": "broadcast", "isend": "p2p"}
        out = {}
        for op, dtype, numel, n in self.calls:
            if op not in kinds or n == 1:
                continue
            nbytes = numel * getattr(torch, dtype.split(".")[-1]).itemsize
            f = {"all_reduce": 2 * (n - 1) / n,
                 "all_gather_into_tensor": (n - 1) / n,
                 "reduce_scatter_tensor": n - 1}.get(op, 1)
            out[kinds[op]] = out.get(kinds[op], 0.0) + nbytes * f
        out["total"] = sum(out.values())
        return out


class FirstGrads:
    """Keeps the gradients the first AdamW update receives while active
    (this rank's shards, before the update scales them in place)."""

    def __enter__(self):
        from repro_torch.train import trainer
        self.module, self.update = trainer, trainer.adamw_update
        self.grads = None

        def update(params, grads, *a, **kw):
            if self.grads is None:
                self.grads = {n: g.clone() for n, g in grads.items()}
            return self.update(params, grads, *a, **kw)
        trainer.adamw_update = update
        return self

    def __exit__(self, *exc):
        self.module.adamw_update = self.update


class ModelAllReduces:
    """Counts, while active, the all-reduces issued over ``group``."""

    def __init__(self, group):
        self.group, self.n = group, 0

    def __enter__(self):
        self.saved = dist.all_reduce

        def all_reduce(t, *a, group=None, **kw):
            self.n += group is self.group
            return self.saved(t, *a, group=group, **kw)
        dist.all_reduce = all_reduce
        return self

    def __exit__(self, *exc):
        dist.all_reduce = self.saved


class RingInputs:
    """Keeps, for the first step's compressed reduction of each leaf, the
    ring's inputs (the local gradient, padded flat, and the error feedback
    before it) and its output mean, while active."""

    def __enter__(self):
        from repro_torch.train import trainer
        self.module, self.fn = trainer, trainer.compressed_allreduce_flat
        self.seen = {}
        self.name = None
        step = trainer.TrainStep
        self.step, self.compress = step, step._compress

        def compress(st, name, g, place):
            self.name = name
            return self.compress(st, name, g, place)

        def ring(flat, err, group):
            g, e = flat.clone(), err.clone()
            mean, new_err = self.fn(flat, err, group)
            if self.name not in self.seen:
                self.seen[self.name] = {"g": g, "e": e, "mean": mean.clone()}
            return mean, new_err
        step._compress = compress
        trainer.compressed_allreduce_flat = ring
        return self

    def __exit__(self, *exc):
        self.step._compress = self.compress
        self.module.compressed_allreduce_flat = self.fn


def _summary(tr, calls=None, grads=None):
    """The run's losses and the trainer's state as full arrays (shards
    gathered over every axis), with each moment shard's size against its
    leaf's; the first update's gradients, gathered, where ``grads`` kept
    them."""
    st = tr.step_fn
    out = {"loss": [r["loss"] for r in tr.log],
           "aux": [r["aux"] for r in tr.log],
           "grad_norm": [r["grad_norm"] for r in tr.log],
           "start": tr.start_step, "step": int(tr.opt["step"]),
           "params": {}, "mu": {}, "nu": {}, "n": {}, "shard": {}}
    for name, p in tr.params.items():
        place = st.places[name]
        full = st.param_places[name].gather(p.detach().contiguous())
        out["params"][name] = full.detach().clone()
        out["mu"][name] = place.gather(tr.opt["mu"][name]).clone()
        out["nu"][name] = place.gather(tr.opt["nu"][name]).clone()
        out["n"][name] = place.n
        out["shard"][name] = tr.opt["mu"][name].numel()
    if grads is not None:
        out["grads"] = {n: st.places[n].gather(g) for n, g in grads.items()}
    if st.ef is not None:
        out["ef"] = {n: e.clone() for n, e in st.ef.items()}
    if calls is not None:
        out["calls"] = [list(c) for c in calls]
    return out


def _trainer(spec, **kw):
    cfg = dataclasses.replace(get_smoke_config(spec["arch"]),
                              dtype="float32")
    kw.setdefault("ckpt_dir", spec.get("ckpt_dir"))
    hp = TrainHParams(**{**HP, **spec.get("hp", {})})
    return Trainer(cfg, hp, spec.get("B", 4), spec.get("T", 32),
                   mesh=Mesh(spec["mesh"], ("data", "model")), device="cpu",
                   params=torch.load(spec["params"], weights_only=True),
                   ckpt_every=spec.get("ckpt_every", 0), **kw)


def train(spec):
    """``spec["steps"]`` steps of a Trainer on ``spec["mesh"]``, keeping
    the first update's gradients; with ``count``, the collectives issued
    during the steps, the all-reduces over ``model`` among them
    (``model_all_reduces``) and the bytes they send (``sent``); with
    ``ring``, the compressed reduction's
    inputs and outputs of the first step (``RingInputs``)."""
    torch.set_num_threads(1)
    tr = _trainer(spec, resume=spec.get("resume", False))
    ring = RingInputs() if spec.get("ring") else contextlib.nullcontext()
    with Collectives() as c, FirstGrads() as g, ModelAllReduces(
            tr.step_fn.par.model_group) as m, ring:
        tr.run(spec["steps"], log_every=1)
    out = _summary(tr, c.calls if spec.get("count") else None, g.grads)
    out["model_all_reduces"] = m.n
    out["sent"] = c.sent()
    if spec.get("ring"):
        out["ring"] = ring.seen
    return out


def train_batches(spec):
    """``spec["steps"]`` steps of ``make_train_step`` over ``spec["mesh"]``
    on batches that carry frontend embeddings (encdec's ``src_embeds``:
    ``SyntheticLM``'s tokens and N(0, 1) frames from numpy seed [0, step],
    as the reference's test draws them); the losses, grad norms and the
    first update's gradients, gathered."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.lm import LM
    from repro_torch.train.trainer import make_train_step
    torch.set_num_threads(1)
    cfg = dataclasses.replace(get_smoke_config(spec["arch"]),
                              dtype="float32")
    lm = LM(cfg, master=True)
    lm.load_state_dict(torch.load(spec["params"], weights_only=True))
    step = make_train_step(lm, TrainHParams(**{**HP, **spec.get("hp", {})}),
                           Mesh(spec["mesh"], ("data", "model")))
    opt, data = step.init_opt(), SyntheticLM(cfg.vocab_size, 32, 4, seed=0)
    logs = []
    with FirstGrads() as g:
        for i in range(spec["steps"]):
            batch = dict(data.batch_at(i))
            batch["src_embeds"] = np.random.default_rng([0, i]).standard_normal(
                (4, cfg.encdec.source_len, cfg.d_model), dtype=np.float32)
            opt, m = step(opt, batch)
            logs.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return {"loss": [r["loss"] for r in logs],
            "grad_norm": [r["grad_norm"] for r in logs],
            "grads": {n: step.places[n].gather(t)
                      for n, t in g.grads.items()}}


def train_and_resume(spec):
    """4 steps with a checkpoint every 2 into ``ckpt_dir``; then a fresh
    Trainer resumed from a copy of the step-2 checkpoint runs steps 3-4.
    Returns both summaries."""
    torch.set_num_threads(1)
    d = spec["ckpt_dir"]
    first = _trainer(dict(spec, ckpt_every=2), ckpt_dir=d)
    with FirstGrads() as g:
        first.run(4, log_every=1)
    straight = _summary(first, grads=g.grads)
    del first
    again = d + ".resume"
    if dist.get_rank() == 0:
        shutil.rmtree(again, ignore_errors=True)
        shutil.copytree(os.path.join(d, "step_00000002"),
                        os.path.join(again, "step_00000002"))
    dist.barrier()
    second = _trainer(spec, ckpt_dir=again, resume=True)
    ef = second.step_fn.ef
    ef_zero = None if ef is None else all(not e.any() for e in ef.values())
    second.run(2, log_every=1)
    return {"straight": straight, "resumed": _summary(second),
            "ef_zero_at_resume": ef_zero}


def restored(spec):
    """A Trainer resumed from ``ckpt_dir``'s newest checkpoint, before any
    step: its state gathered to full arrays."""
    torch.set_num_threads(1)
    return _summary(_trainer(spec, resume=True))


def preempt(spec):
    """Rank 1 sends itself SIGTERM once it has logged two steps; every
    rank must stop after one same step and checkpoint it."""
    torch.set_num_threads(1)
    tr = _trainer(spec, ckpt_dir=spec["ckpt_dir"])
    if dist.get_rank() == 1:
        def shoot():
            while len(tr.log) < 2:
                time.sleep(0.001)
            os.kill(os.getpid(), signal.SIGTERM)
        threading.Thread(target=shoot, daemon=True).start()
    hist = tr.run(200, log_every=1)
    return {"stopped": hist[-1][0],
            "latest": ckpt.latest_step(spec["ckpt_dir"])}


def launcher(spec):
    """``launch/train.py``'s main on this group's ranks with its defaults
    (megatron over ``make_host_mesh()``): the smoke qwen2.5-3b on the CPU
    for ``spec["steps"]`` steps; the mesh and the logged losses."""
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    hist = launch.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
                        "--steps", str(spec["steps"]), "--batch", "4",
                        "--seq", "32"])
    return {"mesh": make_host_mesh().shape, "loss": [l for _, l in hist],
            "parallelism": TrainHParams().parallelism}


def suite(specs):
    """Several cases in one group: {name: (function name, argument)}."""
    return {name: globals()[fn](arg) for name, (fn, arg) in specs.items()}
