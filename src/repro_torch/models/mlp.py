"""Dense FFN variants: SwiGLU (llama-family), GELU (starcoder2/musicgen),
squared-ReLU (nemotron/minitron), and RMSNorm — the port of the JAX
package's ``models/mlp.py`` without tensor parallelism."""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
    return h @ p["w2"].to(dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Computed in f32 and cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)
