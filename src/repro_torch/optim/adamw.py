"""AdamW from scratch with global-norm clipping and a warmup + cosine
schedule — the port of the JAX package's ``optim/adamw.py``, with the same
arithmetic in f32.

The port updates parameters and moments **in place** under
``torch.no_grad()`` (JAX returns new trees): at full width a second copy
of the parameters and of both moments would cost three times the weights
in device memory.  ``adamw_update`` still returns the (same) trees, so
callers read like the JAX ones.

Over a mesh of ranks (``training.train_step``) each rank passes the
slices of the optimizer layout it updates; the clipping norm is then the
norm of the global gradient (:func:`global_norm` with ``owned`` and
``group``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.monitoring.trace import scoped
from repro_torch.tree import leaves, tree_map

f32 = torch.float32
#: elements a slice of :func:`adamw_update` holds at most (64 MiB in f32)
_SLICE_ELEMS = 1 << 24
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"


def lr_schedule(step: torch.Tensor, opt: OptimizerConfig) -> torch.Tensor:
    """Learning rate at ``step`` (an integer tensor), in f32."""
    step = step.to(f32)
    warm = opt.peak_lr * step / max(opt.warmup_steps, 1)
    prog = torch.clamp((step - opt.warmup_steps)
                       / max(opt.decay_steps - opt.warmup_steps, 1), 0.0, 1.0)
    cos = opt.min_lr_ratio + (1 - opt.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < opt.warmup_steps, warm, opt.peak_lr * cos)


def init_opt_state(params, opt: OptimizerConfig):
    """``{"m", "v"}`` zero trees in ``opt.state_dtype`` beside ``params``
    and an int32 ``step`` on the parameters' device."""
    dt = _DTYPES[opt.state_dtype]

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves(params)[0].device)}


def global_norm(tree, owned=None, group=None) -> torch.Tensor:
    """The L2 norm of a gradient tree.  Over ranks, each rank holds slices
    of it: ``owned`` (one bool a leaf) says which of this rank's slices
    it counts, so that a slice held by several ranks counts once, and the
    squares are summed over ``group``."""
    gs = leaves(tree)
    if owned is None and group is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.to(f32)))
                              for g in gs))
    sq = torch.zeros((), dtype=f32, device=gs[0].device)
    for g, own in zip(gs, owned or [True] * len(gs)):
        if own:
            sq = sq + torch.sum(torch.square(g.to(f32)))
    if group is not None:
        dist.all_reduce(sq, group=group)
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(params, grads, state, opt: OptimizerConfig, owned=None,
                 group=None):
    """One AdamW step, in place on ``params`` and ``state``.  Returns
    (params, state, metrics) with ``metrics = {"grad_norm", "lr"}``.
    ``owned``/``group``: see :func:`global_norm`."""
    step = state["step"] + 1
    with scoped("grad_norm", "train"):
        gnorm = global_norm(grads, owned, group)
    scale = torch.clamp(opt.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(step, opt)
    stepf = step.to(f32)
    b1c = 1 - torch.pow(torch.tensor(opt.b1, dtype=f32,
                                     device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(opt.b2, dtype=f32,
                                     device=stepf.device), stepf)
    for leaf in zip(leaves(params), leaves(grads), leaves(state["m"]),
                    leaves(state["v"])):
        # the update is elementwise: slices along dim 0 keep its f32
        # temporaries to one slice's size (a stacked leaf's would
        # otherwise take five times the leaf)
        rows = leaf[0].shape[0] if leaf[0].ndim else 1
        per_row = leaf[0].numel() // max(rows, 1)
        step_rows = max(1, _SLICE_ELEMS // max(per_row, 1))
        for r in range(0, rows, step_rows):
            p, g, m, v = (t.narrow(0, r, min(step_rows, rows - r))
                          if t.ndim else t for t in leaf)
            g = g.to(f32) * scale
            m32 = m.to(f32) * opt.b1 + g * (1 - opt.b1)
            v32 = v.to(f32) * opt.b2 + torch.square(g) * (1 - opt.b2)
            delta = (m32 / b1c) / (torch.sqrt(v32 / b2c) + opt.eps)
            # decoupled weight decay on matrices only (ndim >= 2)
            if p.ndim >= 2:
                delta = delta + opt.weight_decay * p.to(f32)
            p.copy_(p.to(f32) - lr * delta)
            m.copy_(m32)
            v.copy_(v32)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
