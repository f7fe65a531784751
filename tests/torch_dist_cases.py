"""Rank functions of the port's data-parallel tests.

Each runs on every rank of a gloo group started by
``repro_torch.launch.spawn.run_ranks`` (see
``tests/test_torch_train_dist.py``) and returns tensors, numbers and
strings.  No JAX here: the ranks import only torch and the port.
"""

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
    """Counts the collectives issued while active: (op, dtype, numel)."""

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
                                   o.tensor.numel()))
            return self.saved["batch_isend_irecv"](ops)
        dist.batch_isend_irecv = p2p
        return self

    def _wrap(self, op):
        fn = self.saved[op]

        def wrapped(t, *a, **kw):
            self.calls.append((op, str(t.dtype), t.numel()))
            return fn(t, *a, **kw)
        return wrapped

    def __exit__(self, *exc):
        for op, fn in self.saved.items():
            setattr(dist, op, fn)


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


def _summary(tr, calls=None, grads=None):
    """The run's losses and the trainer's state as full arrays (shards
    gathered), with each moment shard's size against its leaf's; the first
    update's gradients, gathered, where ``grads`` kept them."""
    st = tr.step_fn
    out = {"loss": [r["loss"] for r in tr.log],
           "aux": [r["aux"] for r in tr.log],
           "grad_norm": [r["grad_norm"] for r in tr.log],
           "start": tr.start_step, "step": int(tr.opt["step"]),
           "params": {}, "mu": {}, "nu": {}, "n": {}, "shard": {}}
    for name, p in tr.params.items():
        place = st.places[name]
        full = place.gather(p.detach().contiguous()) if st.fsdp else p
        out["params"][name] = full.detach().clone()
        out["mu"][name] = place.gather(tr.opt["mu"][name])
        out["nu"][name] = place.gather(tr.opt["nu"][name])
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
    hp = TrainHParams(**{**HP, **spec.get("hp", {})})
    return Trainer(cfg, hp, spec.get("B", 4), spec.get("T", 32),
                   mesh=Mesh(spec["mesh"], ("data", "model")), device="cpu",
                   params=torch.load(spec["params"], weights_only=True),
                   ckpt_every=spec.get("ckpt_every", 0), **kw)


def train(spec):
    """``spec["steps"]`` steps of a Trainer on ``spec["mesh"]``, keeping
    the first update's gradients; with ``count``, the collectives issued
    during the steps."""
    torch.set_num_threads(1)
    tr = _trainer(spec, ckpt_dir=spec.get("ckpt_dir"),
                  resume=spec.get("resume", False))
    with Collectives() as c, FirstGrads() as g:
        tr.run(spec["steps"], log_every=1)
    return _summary(tr, c.calls if spec.get("count") else None, g.grads)


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
    second.run(2, log_every=1)
    return {"straight": straight, "resumed": _summary(second)}


def restored(spec):
    """A Trainer resumed from ``ckpt_dir``'s newest checkpoint, before any
    step: its state gathered to full arrays."""
    torch.set_num_threads(1)
    return _summary(_trainer(spec, ckpt_dir=spec["ckpt_dir"], resume=True))


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


def suite(specs):
    """Several cases in one group: {name: (function name, argument)}."""
    return {name: globals()[fn](arg) for name, (fn, arg) in specs.items()}
