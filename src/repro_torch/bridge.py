"""Weight bridge from the reference package's parameter tree.

``params_from_jax(tree)`` maps the nested dict that the reference's
``LM(cfg).init(PRNGKey(seed))`` returns, with every leaf converted by
``np.asarray``, onto a ``state_dict`` for :class:`repro_torch.models.lm.LM`.
Names join the tree's keys with dots; shapes are the reference's own.
``LM.load_state_dict`` then casts each tensor once into ``cfg.dtype``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten ``tree`` (nested dicts of numpy arrays) to a state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(params_from_jax(val, prefix=name + "."))
        else:
            out[name] = torch.from_numpy(np.array(val, copy=True))
    return out
