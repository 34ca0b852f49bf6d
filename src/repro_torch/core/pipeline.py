"""Pipeline parallelism (paper §7.1 "PipelineParallel") — the GPipe-style
microbatch schedule of the JAX package's ``core/pipeline.py``, over a
``pipe`` axis of ranks.

The model's stacked layer groups are split contiguously across stages
(vertical split, the paper's "the model is split up vertically
(layer-level) across multiple GPUs").  Each tick every stage runs its
slice on one microbatch (masked out during the fill and drain bubbles)
and passes its activations to the next stage with ``torch.distributed``
point-to-point sends (``batch_isend_irecv``, the ring JAX's ``ppermute``
describes).  The send/receive is an autograd function whose backward
sends the gradient the other way, and the last stage's buffer reaches
every stage through a reduction whose backward hands the last stage the
gradient, so training works through the schedule end to end.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import leaves, tree_map


def split_stages(stacked, n_stages: int):
    """Check the stacked-layer-group tree divides across stages."""
    for x in leaves(stacked):
        assert x.shape[0] % n_stages == 0, (
            f"layer groups {x.shape[0]} not divisible by {n_stages} stages")
    return stacked


@dataclass(frozen=True)
class PipeMesh:
    """A ``pipe`` axis of ranks seen from one of them."""
    devices: np.ndarray
    index: int
    group: object = None
    axis_names: tuple = ("pipe",)

    @property
    def shape(self) -> dict:
        return {"pipe": len(self.devices)}


def make_pipeline_mesh(n_stages: int, devices=None) -> PipeMesh:
    """The pipeline mesh of the calling rank: ``torch.distributed``
    initialised over ``n_stages`` ranks (rank r is stage r), on
    ``devices`` (default: each rank's current device)."""
    if not dist.is_initialized() or dist.get_world_size() != n_stages:
        raise RuntimeError(f"make_pipeline_mesh: torch.distributed must be "
                           f"initialised with world size {n_stages} first")
    grid = np.empty(n_stages, dtype=object)
    grid[:] = [torch.device(d) for d in devices] if devices is not None \
        else [None] * n_stages
    group = dist.new_group(list(range(n_stages)))
    return PipeMesh(grid, dist.get_rank(), group)


def _ring(x: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    """Send ``x`` to rank ``to`` and receive the same shape from ``frm``.
    gloo sends and receives host memory only (it would read a CUDA
    tensor's device pointer as a host address), so over gloo a CUDA
    tensor goes through a host copy each way."""
    staged = x.device.type == "cuda" and dist.get_backend(group) == "gloo"
    send = x.detach().cpu() if staged else x.contiguous()
    out = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, to, group),
           dist.P2POp(dist.irecv, out, frm, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out.to(x.device) if staged else out


class _PPermute(torch.autograd.Function):
    """Stage i hands its activations to stage i + 1 (mod n); the backward
    hands the gradient from i + 1 back to i."""

    @staticmethod
    def forward(ctx, y, nxt, prev, group):
        ctx.nxt, ctx.prev, ctx.group = nxt, prev, group
        return _ring(y, nxt, prev, group)

    @staticmethod
    def backward(ctx, g):
        return _ring(g, ctx.prev, ctx.nxt, ctx.group), None, None, None


class _FromLast(torch.autograd.Function):
    """Sum over the stages of a buffer that is zero except on the last
    (JAX's masked ``psum``); the backward keeps each stage's own gradient,
    which reaches parameters only on the last stage.  The hand-offs
    (``carries``) ride along with zero gradients, so that every stage's
    backward pass reaches all of its receives: each answers the send of
    the next stage, whose parameters are elsewhere."""

    @staticmethod
    def forward(ctx, x, group, *carries):
        ctx.like = [(c.shape, c.dtype, c.device) for c in carries]
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return (g, None, *[torch.zeros(s, dtype=d, device=dev)
                           for s, d, dev in ctx.like])


def pipeline_apply(stage_fn, stacked_params, x_micro, mesh: PipeMesh,
                   axis: str = "pipe"):
    """Run microbatches through the pipeline.

    stage_fn(stage_params, x) -> y          (one stage's layer slice)
    stacked_params: leaves (n_groups, ...)  — whole; each stage takes its
                                              contiguous slice of dim 0
    x_micro: (n_micro, mb, ...)             — the same on every stage
    Returns (n_micro, mb, ...) from the last stage, on every stage.  The
    gradient of ``stacked_params`` on a stage is nonzero on its own slice
    only: the whole gradient is their sum over the stages.
    """
    n_stages = mesh.shape[axis]
    n_micro = x_micro.shape[0]
    split_stages(stacked_params, n_stages)
    my = mesh.index
    per = leaves(stacked_params)[0].shape[0] // n_stages
    local = tree_map(lambda p: p[my * per:(my + 1) * per], stacked_params)
    group = mesh.group
    nxt, prev = (my + 1) % n_stages, (my - 1) % n_stages
    is_first = torch.tensor(my == 0)
    is_last = my == n_stages - 1
    carry = torch.zeros_like(x_micro[0])
    outs = [torch.zeros_like(x_micro[0]) for _ in range(n_micro)]
    carries = []
    ticks = n_micro + n_stages - 1
    for t in range(ticks):
        mb = t - my                                   # my microbatch index
        active = 0 <= mb < n_micro
        mb_c = min(max(mb, 0), n_micro - 1)
        inp = torch.where(is_first, x_micro[mb_c], carry)
        y = stage_fn(local, inp)
        y = torch.where(torch.tensor(active), y, torch.zeros_like(y))
        if is_last and active:
            outs[mb_c] = y                 # the last stage keeps its result
        if t < ticks - 1:                  # the last hand-off feeds nothing
            carry = _PPermute.apply(y, nxt, prev, group)
            carries.append(carry)
    return _FromLast.apply(torch.stack(outs), group, *carries)
