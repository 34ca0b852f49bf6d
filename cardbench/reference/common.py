"""Pieces the families share: RMSNorm, rotary positions, the masked
cross entropy, the weight rounding of the lower-precision control, and
AdamW with global-norm clipping (a frozen copy of the published
algorithm: warm-up then cosine learning rate, decoupled weight decay on
leaves of two or more dimensions)."""
from __future__ import annotations

import math

import torch

f32 = torch.float32
#: largest finite magnitude of float8 e4m3
FP8_MAX = 448.0


def no_tf32() -> None:
    """Full float32 matrix products on the card (TF32 keeps ~3 digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Exact:
    """The reference's products: every operand as it is."""

    @staticmethod
    def w(w, k: int = 1):
        return w

    @staticmethod
    def x(x, k: int = 1):
        return x


class Fp8:
    """The control's products: both operands rounded to float8 e4m3, each
    with one scale a row of what it contracts: a weight (its first ``k``
    dimensions contracted) one scale an output column, an activation (its
    last ``k`` dimensions contracted) one scale a token.  Gradients go
    straight through the rounding.  The operands of the attention
    products (q, k, v) and the residual stream between layers are
    rounded as activations (the program keeps both in bfloat16); norms,
    softmax, the token lookup and accumulation stay in float32."""

    @staticmethod
    def _round(t, amax):
        scale = amax.clamp(min=1e-12) / FP8_MAX
        q = (t.detach() / scale).to(torch.float8_e4m3fn).to(f32) * scale
        return t + (q - t).detach()

    def w(self, w, k: int = 1):
        m = w.reshape(math.prod(w.shape[:k]), -1)
        return self._round(m, m.detach().abs().amax(dim=0)).reshape(w.shape)

    def x(self, x, k: int = 1):
        m = x.reshape(*x.shape[:x.ndim - k], -1)
        amax = m.detach().abs().amax(dim=-1, keepdim=True)
        return self._round(m, amax).reshape(x.shape)


exact = Exact()
fp8 = Fp8()


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x, positions, theta: float):
    """Rotary positions on every channel of the head, split halves
    (x: (..., S, H, Dh); positions: (S,))."""
    dh = x.shape[-1]
    freqs = theta ** (-torch.arange(0, dh, 2, dtype=f32, device=x.device)
                      / dh)
    ang = positions.to(f32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def xent_sum(logits, labels, mask):
    """Sum of the masked token cross entropies (divide by the count)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.sum((lse - ll) * mask)


def learning_rate(step: int, opt: dict) -> float:
    peak, warm = opt["peak_lr"], opt["warmup_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    prog = min(max((step - warm) / max(opt["decay_steps"] - warm, 1), 0.0),
               1.0)
    lo = opt["min_lr_ratio"]
    return peak * (lo + (1 - lo) * 0.5 * (1 + math.cos(math.pi * prog)))


@torch.no_grad()
def adamw(params: dict, grads: dict, m: dict, v: dict, step: int,
          opt: dict) -> dict:
    """One AdamW step in place; returns the clipped gradients' per-leaf
    norms (the gradient as the update sees it)."""
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.clamp(opt["clip_norm"] / (gnorm + 1e-9), max=1.0)
    lr = learning_rate(step, opt)
    b1, b2 = opt["b1"], opt["b2"]
    b1c, b2c = 1 - b1 ** step, 1 - b2 ** step
    norms = {}
    for k, p in params.items():
        g = grads[k] * scale
        norms[k] = float(torch.linalg.vector_norm(g))
        m[k].mul_(b1).add_(g, alpha=1 - b1)
        v[k].mul_(b2).add_(g * g, alpha=1 - b2)
        delta = (m[k] / b1c) / (torch.sqrt(v[k] / b2c) + opt["eps"])
        if p.ndim >= 2:
            delta = delta + opt["weight_decay"] * p
        p.sub_(lr * delta)
    return norms
