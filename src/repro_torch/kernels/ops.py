"""Model-layout entry points of the kernels.

The contract is that of the JAX package's ``kernels/ops.py``:
``flash_attention``, ``flash_decode(window=)``, ``flash_decode_paged`` and
``ssd_scan`` take model-layout tensors and return model-layout outputs;
the attention entry points take the logits' ``scale`` (None: ``Dh **
-0.5``).  ``ssd_decode_step``, the port's own, has no TPU kernel behind
it: it is the SSD recurrence's one-token step of serving.
Dispatch goes by the tensors' device: a CUDA tensor launches the
hand-written kernel (which reads the model layout through strides, so no
transpose is materialised); a CPU tensor runs the kernel's plain version.
Nothing falls back: a kernel that fails to build or launch raises.

The TPU kernels were forward-only.  Training differentiates
``flash_attention`` and ``ssd_scan`` through an autograd function whose
forward launches the kernel.  Attention's backward routes by dtype: in
bfloat16 it launches the port's own backward kernel
(``attention_bwd.py``); in float32 it recomputes the plain version under
autograd and backpropagates through it, as ``ssd_scan``'s backward does
in both dtypes.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import attention_bwd as _fa_bwd
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_decode as _ssd_step
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.monitoring.trace import SPANS


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no attention kernel and no SSD-scan kernel for "
                     f"device {t.device}")


def _recompute_grads(ctx, plain, grad_out, *static):
    """Gradients of a kernel's inputs: the plain version rerun on the
    saved inputs under autograd, backpropagated from ``grad_out``."""
    saved = ctx.saved_tensors    # unpack once: checkpointing allows no more
    need = ctx.needs_input_grad[:len(saved)]
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        out = plain(*ins, *static)
    wanted = [t for t, n in zip(ins, need) if n]
    grads = iter(torch.autograd.grad(out, wanted, grad_out)
                 if wanted else ())
    return tuple(next(grads) if n else None for n in need)


class _FlashAttention(torch.autograd.Function):
    """Kernel forward; backward by the backward kernel in bfloat16, through
    :func:`ref.attention_ref` in float32."""

    @staticmethod
    def forward(ctx, q, k, v, window, scale=None):
        ctx.save_for_backward(q, k, v)
        ctx.window, ctx.scale = window, scale
        # a traced step's span scope: the backward runs on autograd's own
        # thread, where it is not set
        ctx.spans = SPANS.get()
        return _fa.flash_attention_bshd(q, k, v, window=window,
                                        scale=scale)

    @staticmethod
    def backward(ctx, grad_o):
        sc = ctx.spans
        with (sc.span("attention_bwd", "kernel") if sc is not None
              else contextlib.nullcontext()):
            if grad_o.dtype == torch.bfloat16:
                q, k, v = ctx.saved_tensors
                grads = tuple(
                    g if n else None for g, n in zip(
                        _fa_bwd.attention_bwd_bshd(
                            q, k, v, grad_o, window=ctx.window,
                            scale=ctx.scale),
                        ctx.needs_input_grad))
            else:
                grads = _recompute_grads(ctx, ref.attention_ref, grad_o,
                                         ctx.window, ctx.scale)
            return grads + (None,) * (len(ctx.needs_input_grad) - 3)


class _SSDScan(torch.autograd.Function):
    """Kernel forward; backward through :func:`ref.ssd_scan_ref`."""

    @staticmethod
    def forward(ctx, x, dt, a, Bm, Cm, chunk):
        ctx.save_for_backward(x, dt, a, Bm, Cm)
        ctx.chunk = chunk
        return _ssd.ssd_scan_bshp(x, dt, a, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, grad_y):
        return _recompute_grads(ctx, ref.ssd_scan_ref, grad_y,
                                ctx.chunk) + (None,)


def flash_attention(q, k, v, window=None, scale=None):
    """q: (B, S, H, Dh); k/v: (B, S, K, Dh) -> (B, S, H, Dh).  Causal."""
    if _on_card(q):
        return _FlashAttention.apply(q, k, v, window, scale)
    return ref.attention_ref(q, k, v, window=window, scale=scale)


def flash_decode(q, k, v, pos, window=None, scale=None):
    """q: (B, 1, H, Dh) roped query; k/v: (B, S, K, Dh) KV cache; pos:
    (B,) int32 — attends slots [0, pos_b], or the ring's wrapped slots
    under ``window``.  Returns (B, 1, H, Dh)."""
    if _on_card(q):
        return _fd.flash_decode_bshd(q, k, v, pos, window=window,
                                     scale=scale)
    return ref.decode_attention_ref(q, k, v, pos, window=window,
                                    scale=scale)


def flash_decode_paged(q, k, v, page_table, pos, scale=None):
    """q: (B, 1, H, Dh); k/v: (num_pages, page_size, K, Dh) pool;
    page_table: (B, n_pages) int32; pos: (B,) int32 — attends logical
    positions [0, pos_b].  Returns (B, 1, H, Dh)."""
    if _on_card(q):
        return _fd.flash_decode_paged_bshd(q, k, v, page_table, pos,
                                           scale=scale)
    return ref.paged_decode_attention_ref(q, k, v, page_table, pos,
                                          scale=scale)


def _pick_block(S: int, target: int) -> int:
    """Largest divisor of S that is <= target (the JAX ``ops._pick_block``:
    chunk boundaries match the reference's)."""
    b = min(target, S)
    while S % b:
        b -= 1
    return b


def ssd_scan(x, dt, A, Bm, Cm, chunk: int = 256):
    """x: (B, S, H, P); dt: (B, S, H); A: (H,); Bm/Cm: (B, S, N) ->
    y: (B, S, H, P) in x's dtype.  The chunk is the largest divisor of S
    that is <= ``chunk``.  ``a = dt * A`` is formed here in f32, so
    autograd carries its gradient back to ``dt`` and ``A``."""
    Q = _pick_block(x.shape[1], chunk)
    dtf = dt.to(torch.float32)
    a = dtf * A.to(torch.float32)[None, None, :]
    if _on_card(x):
        return _SSDScan.apply(x, dtf, a, Bm, Cm, Q)
    return ref.ssd_scan_ref(x, dtf, a, Bm, Cm, Q)


def ssd_decode_step(state, x, dt, A, D, Bm, Cm):
    """One token of the SSD recurrence.  state: (B, H, P, N) float32,
    updated in place; x: (B, H, P); dt: (B, H) float32 after the
    softplus; A, D: (H,) float32; Bm/Cm: (B, N).  Returns y (B, H, P) in
    x's dtype."""
    if _on_card(x):
        return _ssd_step.ssd_decode_step_bhpn(state, x, dt, A, D, Bm, Cm)
    return ref.ssd_decode_step_ref(state, x, dt, A, D, Bm, Cm)


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launch_counts`, by entry
    point (``attention_bwd`` and ``ssd_scan``: wrapper calls, whatever
    number of launches a call makes)."""
    return dict(build.launches)


def reset_launch_counts():
    for name in build.launches:
        build.launches[name] = 0


def add_launch_counts(counts: dict, times: int = 1):
    """Add ``times`` x ``counts`` (a :func:`launch_counts` difference) to
    the counters: a CUDA graph's replay launches what its capture counted,
    and the capture itself launches nothing (``times=-1``)."""
    for name in build.launches:
        build.launches[name] += times * counts.get(name, 0)
