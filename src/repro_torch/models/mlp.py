"""Dense FFN variants: SwiGLU (llama-family), GELU (starcoder2/musicgen),
squared-ReLU (nemotron/minitron), and RMSNorm — the port of the JAX
package's ``models/mlp.py``.  Under serving tensor parallelism a shard
holds a slice of d_ff and the down-projection is a reduction point."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.actshard import maybe_psum, tp_will_reduce


def mlp_apply(p: dict, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    dtype = x.dtype
    h = x @ p["w1"].to(dtype)
    if mlp_type == "swiglu":
        h = F.silu(h) * (x @ p["w3"].to(dtype))
    elif mlp_type == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    elif mlp_type == "relu2":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(mlp_type)
    # contracts d_ff — under serving TP (w1/w3 column- and w2 row-sharded)
    # each shard holds a partial sum here, kept f32 through the reduction
    # and rounded once (see attention.out_proj)
    w2 = p["w2"].to(dtype)
    if tp_will_reduce("mlp_out"):
        part = h.float() @ w2.float()
        return maybe_psum(part, "mlp_out").to(dtype)
    return h @ w2


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Computed in f32 and cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)
