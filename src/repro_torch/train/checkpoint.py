"""Atomic checkpoints of a tree of tensors (no external deps).

Counterpart of the reference's ``train/checkpoint.py``, with its on-disk
layout::

    <dir>/step_000123/
        meta.json            # step, extra, one entry per leaf (path, shape, dtype)
        arrays/<idx>.npy     # one file per leaf, its full logical value
        _COMPLETE            # commit marker

The tree is nested dicts of tensors (a ``state_dict`` under each key);
a leaf's path joins its keys with ``/``, over sorted keys as the
reference's tree flattening orders them.  Fault tolerance as the reference:

  * atomic: written to ``step_X.tmp`` and renamed; readers trust only
    directories holding ``_COMPLETE``, so a preempted writer never corrupts
    the latest checkpoint;
  * self-describing: ``restore`` looks leaves up by path and raises on a
    missing leaf or a shape mismatch;
  * elastic: every leaf is saved as its full logical value, so a one-device
    checkpoint and a D-rank one are the same files.  Under data
    parallelism ``save`` gathers each sharded leaf (``places``: path ->
    :class:`~repro_torch.train.layout.Placement`), rank 0 writes and every
    rank then meets at a barrier; ``restore`` reads the full arrays on
    every rank and takes this rank's shard, whatever the world size that
    saved them.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _flatten(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    out = []
    for key in sorted(tree):
        val = tree[key]
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.extend(_flatten(val, path + "/"))
        else:
            out.append((path, val))
    return out


def _unflatten_like(tree, values: Dict[str, torch.Tensor], prefix: str = ""):
    return {key: (_unflatten_like(val, values, f"{prefix}{key}/")
                  if isinstance(val, Mapping) else values[f"{prefix}{key}"])
            for key, val in tree.items()}


def _distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _writer() -> bool:
    """Whether this process writes: rank 0, or the only process."""
    return not _distributed() or dist.get_rank() == 0


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None,
         places: Optional[Mapping] = None) -> str:
    """Atomically save ``tree`` as ``<ckpt_dir>/step_<step>``.  ``places``
    (path -> placement) marks the leaves that are this rank's shards: each
    is gathered to its full value, so every rank must call ``save``; rank 0
    writes, then all ranks wait at a barrier for the commit."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    writer = _writer()
    if writer:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(os.path.join(tmp, "arrays"), exist_ok=True)
    meta = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (p, v) in enumerate(_flatten(tree)):
        if places and p in places:
            v = places[p].gather(v.detach().contiguous())
        if not writer:
            continue
        arr = v.detach().cpu().numpy()
        np.save(os.path.join(tmp, "arrays", f"{i}.npy"), arr)
        meta["leaves"].append({
            "path": p, "idx": i, "shape": list(arr.shape),
            "dtype": str(arr.dtype), "shard_of": None,
        })
    if writer:
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "_COMPLETE"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    if _distributed():
        dist.barrier()
    return final


def _complete_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, d, "_COMPLETE")))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete checkpoint's step, or None."""
    steps = _complete_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like_tree,
            places: Optional[Mapping] = None) -> Tuple[Any, Dict]:
    """Load step ``step`` into the structure of ``like_tree``: each leaf a
    new tensor on the device of ``like_tree``'s leaf at its path; where
    ``places`` has the path, this rank's shard of the saved full array
    (the elastic reshard).  Returns (tree, extra); raises ValueError on a
    missing leaf or another full shape."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    want = _flatten(like_tree)
    by_path = {l["path"]: l for l in meta["leaves"]}
    missing = [p for p, _ in want if p not in by_path]
    if missing:
        raise ValueError(f"checkpoint missing leaves: {missing[:5]}...")
    values = {}
    for p, like in want:
        arr = np.load(os.path.join(d, "arrays", f"{by_path[p]['idx']}.npy"))
        place = places.get(p) if places else None
        shape = tuple(place.shape if place is not None else like.shape)
        if tuple(arr.shape) != shape:
            raise ValueError(f"{p}: shape {arr.shape} != expected {shape}")
        t = torch.from_numpy(arr)
        if place is not None:       # a copy: not a view of the whole array
            t = place.take(t).to(like.device, copy=True).contiguous()
        values[p] = t.to(like.device)
    return _unflatten_like(like_tree, values), meta["extra"]


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Keep the newest ``keep`` complete checkpoints (rank 0 deletes)."""
    if not _writer():
        return
    for s in _complete_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
