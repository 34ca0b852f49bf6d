"""Parameter initialization from spec trees, drawn from a
``torch.Generator``.

Same tree, shapes and init styles as the JAX package's ``models/init.py``;
the numbers differ (threefry against PyTorch's generator), so tests that
compare the two sides load one set of weights into both
(``repro_torch.weights.params_from_jax``).  :func:`abstract_params` is
the tree on the ``meta`` device (the dry run's stand-in for JAX's
``ShapeDtypeStruct`` tree).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.spec import ParamSpec, model_spec

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _init_leaf(gen, ps: ParamSpec, dtype, device) -> torch.Tensor:
    if ps.init == "zeros":
        return torch.zeros(ps.shape, dtype=dtype, device=device)
    if ps.init == "ones":
        return torch.ones(ps.shape, dtype=dtype, device=device)
    if ps.init == "a_log":
        # A in [1, 16], stored as log (Mamba-2 convention)
        u = torch.empty(ps.shape, device=device).uniform_(1.0, 16.0,
                                                          generator=gen)
        return u.log().to(dtype)
    if ps.init == "dt_bias":
        # dt ~ uniform in [1e-3, 1e-1], stored pre-softplus
        u = torch.empty(ps.shape, device=device).uniform_(1e-3, 1e-1,
                                                          generator=gen)
        return torch.log(torch.expm1(u)).to(dtype)
    scale = ps.scale if ps.scale is not None else 0.02
    w = torch.randn(ps.shape, generator=gen, device=device)
    return w.mul_(scale).to(dtype)


def init_params(cfg: ModelConfig, seed: int = 0, device=None, keep=None):
    """Materialize the parameter tree for ``cfg`` on ``device`` (CUDA
    unless the caller asks for another), in ``cfg.param_dtype``.

    ``keep(path, leaf)`` (``path`` the leaf's ``keystr`` name, as
    ``repro_torch.tree`` names it) replaces each leaf as soon as it is
    drawn, before the next: a rank keeps its shard of each and never
    holds the whole tree.  The numbers drawn do not depend on it."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def build(tree, path):
        if isinstance(tree, ParamSpec):
            leaf = _init_leaf(gen, tree, dtype, dev)
            return leaf if keep is None else keep(path, leaf)
        if isinstance(tree, dict):
            return {k: build(v, f"{path}[{k!r}]") for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(v, f"{path}[{i}]") for i, v in enumerate(tree)]
        raise TypeError(type(tree))

    return build(model_spec(cfg), "")


def abstract_params(cfg: ModelConfig):
    """The parameter tree on the ``meta`` device: the shapes and dtype of
    :func:`init_params`, no storage (the dry run's arguments)."""
    dtype = torch_dtype(cfg.param_dtype)

    def build(tree):
        if isinstance(tree, ParamSpec):
            return torch.empty(tree.shape, dtype=dtype, device="meta")
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(v) for v in tree]
        raise TypeError(type(tree))

    return build(model_spec(cfg))
