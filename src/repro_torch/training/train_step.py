"""Train-step builder: loss + gradients (+ microbatch accumulation, the
paper's gradient-accumulation knob), the ZeRO gradient layouts and AdamW
on a mesh of ranks — the port of the JAX package's
``training/train_step.py`` in eager SPMD.

Each rank of the ``(data, model)`` mesh (``launch.mesh.make_mesh``) runs
the same step on its shard of the state, and the collectives GSPMD would
insert are written out: the rank's batch rows (``batch_partition``), the
tensor-parallel points of the model code (``core.actshard``), the ZeRO-3
gathers at use and the gradient reductions (``core.zero``), and the norm
of the global gradient (``optim.adamw.global_norm``).  On a one-cell mesh
none of them does anything and the step is the one-device step.  It runs
eagerly; the optimizer updates the parameters and its state in place.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import InputShape, ModelConfig, RunConfig
from repro_torch.core.actshard import param_use_scope, tp_train_scope
from repro_torch.core.zero import Layout
from repro_torch.models.model import AUX_KEYS, hidden_len, loss_fn
from repro_torch.monitoring.trace import scoped, span_scope
from repro_torch.optim.adamw import OptimizerConfig, adamw_update
from repro_torch.tree import leaves, unflatten

METRIC_KEYS = ("loss", "xent", "moe_balance_loss", "moe_z_loss",
               "grad_norm", "lr")


def init_opt_state_sharded(params, opt: OptimizerConfig, layout: Layout):
    """AdamW state of this rank's optimizer-layout slices of ``params`` (a
    tree of parameter-layout shards)."""
    from repro_torch.optim import init_opt_state

    views = [layout.opt_view(leaf, p)
             for leaf, p in zip(layout.leaves, leaves(params))]
    return init_opt_state(unflatten(params, views), opt)


def make_train_step(cfg: ModelConfig, run: RunConfig, mesh,
                    opt: OptimizerConfig, local_batch: bool = False,
                    tracer=None):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``params`` and ``opt_state`` are this rank's shards (the
    whole trees on a one-cell mesh), ``batch`` the global batch: (B, ...)
    tensors on the rank's device.  With ``run.microbatches = n``
    microbatch i is rows ``[i * B/n, (i+1) * B/n)`` (the JAX ``reshape(n,
    B/n, ...)``), of which the rank takes its block; the gradients are
    summed into an f32 accumulator (bf16 under ``grad_reduce_bf16``) in
    the ZeRO gradient layout and, like the metrics, averaged over the
    microbatches.

    ``local_batch`` makes ``batch`` this rank's rows as JAX's
    ``batch_shardings`` lays the global batch out (``Layout.batch_rows``,
    the dry run's arguments); microbatch i is then its rows ``[i * b/n,
    (i+1) * b/n)``.  The collectives are the same as the global batch's,
    and so is the step's sum over the global batch; only which rows share
    a microbatch differs.

    ``tracer`` (a ``monitoring.Tracer``) makes each step a ``train_step``
    span with device-timed children ``forward``, ``backward`` (the
    attention kernel's recomputed backward, ``attention_bwd``, inside),
    ``reduce`` (each microbatch) and ``optimizer`` (``grad_norm``
    inside); each step reads the device times of the steps before, and
    re-anchors the device's clock, at its start, which follows the
    caller's synchronize."""
    layout = Layout(cfg, mesh, run)
    n = run.microbatches
    # JAX casts in the microbatch loop only
    red_dtype = torch.bfloat16 if (run.grad_reduce_bf16 and n > 1) else None
    use = layout.param_use(grad_dtype=red_dtype)
    world = layout.world > 1
    data_group = layout.batch_group
    keys = ("loss", "xent") + AUX_KEYS
    owned = [layout.owned(leaf) for leaf in layout.leaves] if world else None
    norm_group = dist.group.WORLD if world else None

    def rank_rows(batch, rows: int):
        if local_batch:
            return batch
        start, count = layout.batch_rows(rows)
        if count == rows:
            return batch
        if cfg.moe is not None:
            S = batch["labels"].shape[1]
            gs = min(cfg.moe.group_size, rows * S)
            if (count * S) % gs:
                raise ValueError(
                    f"MoE token groups of {gs} straddle the data ranks' "
                    f"rows ({count} x {S} tokens a rank): the aux losses "
                    "are means over groups that must lie in one rank")
        return {k: v[start:start + count] for k, v in batch.items()}

    def grads_of(params, batch, rows: int):
        xs = [p.detach().requires_grad_(True) for p in leaves(params)]
        with tp_train_scope(layout.tp), param_use_scope(use):
            with scoped("forward", "train"):
                loss, metrics = loss_fn(unflatten(params, xs),
                                        rank_rows(batch, rows), cfg, run,
                                        group=data_group)
            # a leaf the forward does not read (the token table of an audio
            # stub's batch of frame embeddings) gets zeros, as jax.grad
            # gives
            with scoped("backward", "train"):
                grads = torch.autograd.grad(loss, xs, allow_unused=True,
                                            materialize_grads=True)
        with scoped("reduce", "train"):
            grads = layout.reduce_grads(
                list(grads), dtype=red_dtype,
                seq=layout.seq_rows(hidden_len(batch)))
        if data_group is None:
            return grads, {k: v.detach() for k, v in metrics.items()}
        # each rank's metrics are its share of the global ones
        vec = torch.stack([metrics[k].detach().to(torch.float32)
                           for k in keys])
        dist.all_reduce(vec, group=data_group)
        return grads, dict(zip(keys, vec.unbind()))

    def step(params, opt_state, batch):
        if tracer is None:
            return update(params, opt_state, batch)
        device = leaves(params)[0].device
        tracer.sync_point(device)
        with span_scope(tracer, device, "train_step", cat="train",
                        track=("training", "step")):
            return update(params, opt_state, batch)

    def update(params, opt_state, batch):
        B = next(iter(batch.values())).shape[0]
        if n == 1:
            grads, metrics = grads_of(params, batch, B)
        else:
            if B % n:
                raise ValueError(f"batch {B} does not split into {n} "
                                 "microbatches")
            b = B // n
            acc_dt = torch.bfloat16 if red_dtype is not None \
                else torch.float32
            grads, metrics = None, None
            for i in range(n):
                g, m = grads_of(params, {k: v[i * b:(i + 1) * b]
                                         for k, v in batch.items()}, b)
                if grads is None:
                    grads, metrics = [x.to(acc_dt) for x in g], m
                else:
                    for acc, x in zip(grads, g):
                        acc.add_(x.to(acc_dt))
                    metrics = {k: metrics[k] + m[k] for k in metrics}
                del g
            for g in grads:
                g.div_(n)
            metrics = {k: v / n for k, v in metrics.items()}
        ps = leaves(params)
        views = [layout.opt_view(leaf, p) for leaf, p in
                 zip(layout.leaves, ps)]
        with scoped("optimizer", "train"):
            _, opt_state, opt_metrics = adamw_update(
                unflatten(params, views),
                unflatten(params, layout.to_opt_layout(grads)), opt_state,
                opt, owned=owned, group=norm_group)
            layout.regather_params(ps)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    step.layout = layout
    # one batch's gradients as the step reduces them (ZeRO gradient
    # layout) and its metrics, without an update
    step.grads = lambda params, batch: grads_of(
        params, batch, next(iter(batch.values())).shape[0])
    return step


def train_step_lowering_args(cfg: ModelConfig, run: RunConfig, mesh,
                             shape: InputShape, opt: OptimizerConfig):
    """This rank's (params, opt_state, batch) on the ``meta`` device: its
    parameter shards, its optimizer-layout moments and its rows of the
    batch (``make_train_step(..., local_batch=True)``) — the dry run's
    counterpart of JAX's abstract arguments."""
    from repro_torch.core import sharding as shd
    from repro_torch.models.init import abstract_params
    from repro_torch.models.inputs import train_input_specs

    layout = Layout(cfg, mesh, run)
    params = layout.local_meta(abstract_params(cfg),
                               shd.param_shardings(cfg, mesh, run))
    opt_state = init_opt_state_sharded(params, opt, layout)
    rows = layout.batch_rows(shape.global_batch)[1]
    batch = {k: torch.empty((rows,) + tuple(v.shape[1:]), dtype=v.dtype,
                            device="meta")
             for k, v in train_input_specs(cfg, shape).items()}
    return params, opt_state, batch
