"""Weight bridge: the JAX package's parameter tree into the port's.

The JAX tree (``repro.models.init_params``) is nested dicts and lists with
layer groups stacked on dim 0; the port keeps exactly that tree with
torch tensors at the leaves.  The caller hands the leaves over as numpy
arrays (``jax.tree.map(np.asarray, params)``), so this module needs
nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device="cpu"):
    """Convert a tree of array-likes (numpy arrays) into torch tensors on
    ``device``, keeping structure, shapes and dtypes."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
