"""Train-step builder: loss + gradients (+ microbatch accumulation, the
paper's gradient-accumulation knob) + AdamW — the port of the JAX
package's ``training/train_step.py`` for one device.

The mesh, the ZeRO gradient constraints and the ``gather_bf16`` /
``grad_reduce_bf16`` options of the JAX step wait for the multi-device
slice (ROADMAP A4): here the whole batch and every parameter sit on one
device.  The step runs eagerly; the optimizer updates the parameters and
its state in place (``optim.adamw``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.model import loss_fn
from repro_torch.optim.adamw import OptimizerConfig, adamw_update
from repro_torch.tree import leaves, unflatten

METRIC_KEYS = ("loss", "xent", "moe_balance_loss", "moe_z_loss",
               "grad_norm", "lr")


def make_train_step(cfg: ModelConfig, run: RunConfig, opt: OptimizerConfig):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``batch`` leaves are (B, ...) tensors on the parameters'
    device; with ``run.microbatches = n`` microbatch i is rows
    ``[i * B/n, (i+1) * B/n)`` (the JAX ``reshape(n, B/n, ...)``), the
    gradients are summed into an f32 accumulator and, like the metrics,
    averaged over the microbatches."""

    def grads_of(params, batch):
        xs = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss, metrics = loss_fn(unflatten(params, xs), batch, cfg, run)
        # a leaf the forward does not read (the token table of an audio
        # stub's batch of frame embeddings) gets zeros, as jax.grad gives
        grads = torch.autograd.grad(loss, xs, allow_unused=True,
                                    materialize_grads=True)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def step(params, opt_state, batch):
        n = run.microbatches
        if n == 1:
            grads, metrics = grads_of(params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % n:
                raise ValueError(f"batch {B} does not split into {n} "
                                 "microbatches")
            b = B // n
            grads, metrics = None, None
            for i in range(n):
                g, m = grads_of(params, {k: v[i * b:(i + 1) * b]
                                         for k, v in batch.items()})
                if grads is None:
                    grads, metrics = [x.to(torch.float32) for x in g], m
                else:
                    for acc, x in zip(grads, g):
                        acc.add_(x)
                    metrics = {k: metrics[k] + m[k] for k in metrics}
                del g
            for g in grads:
                g.div_(n)
            metrics = {k: v / n for k, v in metrics.items()}
        params, opt_state, opt_metrics = adamw_update(
            params, unflatten(params, grads), opt_state, opt)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return step

