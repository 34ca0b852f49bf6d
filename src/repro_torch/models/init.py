"""Parameter initialization from spec trees, drawn from a
``torch.Generator``.

Same tree, shapes and init styles as the JAX package's ``models/init.py``;
the numbers differ (threefry against PyTorch's generator), so tests that
compare the two sides load one set of weights into both
(``repro_torch.weights.params_from_jax``).
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


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Materialize the parameter tree for ``cfg`` on ``device`` (CUDA
    unless the caller asks for another), in ``cfg.param_dtype``."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def build(tree):
        if isinstance(tree, ParamSpec):
            return _init_leaf(gen, tree, dtype, dev)
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(v) for v in tree]
        raise TypeError(type(tree))

    return build(model_spec(cfg))
