"""Activation sharding hooks of the model code — the port of the JAX
package's ``core/actshard.py``, plus the points where eager SPMD writes
out the collectives GSPMD would insert.

Model code stays mesh-agnostic: it calls ``constrain(x, "<logical
name>")``, the tensor-parallel points below and ``use_params``, and the
caller decides what they do; outside every scope each is the identity.

**Activation rules.**  :func:`activation_sharding` installs the rules of
``core.sharding.make_activation_rules`` and :func:`activation_spec` reads
them.  :func:`constrain` stays a value identity, as JAX's is outside a
trace: under GSPMD a constraint tells the partitioner where to put a
value, but here each rank computes only its own part, and every
activation already lives where the parameter layout puts it (the batch
rows of the rank's ``data`` index, the heads or FFN columns of its
``model`` index).  So the train step installs no rules: no model code
reads a spec, and the rules serve a caller that asks where an
activation would live.

**Serving tensor-parallel reductions.**  Serving TP runs one process per
shard (``serving/tp.py``); each holds a slice of the attention heads and
of the FFN hidden dim, so attention's output projection and the MLP
down-projection leave a partial sum on every shard.  Both call
``maybe_psum(x, kind)``; inside :func:`tp_reduce_scope` that is one
``torch.distributed.all_reduce`` over the scope's process group, gated per
kind (``"attn_out"`` | ``"mlp_out"``) and counted.  It is forward-only.

**Training tensor parallelism** (Megatron-style, inside
:func:`tp_train_scope`) needs the conjugate pair of autograd functions:
:func:`tp_copy` (forward identity, backward all-reduce) at the input of
a column-parallel product and :func:`tp_reduce` (forward all-reduce,
backward identity) after a row-parallel one; :func:`tp_gather_last`
gathers vocab-parallel logits.  :func:`tp_sum` all-reduces both ways
(a statistic each rank reads for its own slice, such as the gated
norm's sum of squares over a sharded ``d_inner``).

Under the ``seq_parallel`` layout the residual stream between blocks
holds this rank's rows of the sequence (Megatron-SP):
:func:`seq_gather` (all-gather, backward reduce-scatter) enters a
block, :func:`seq_scatter` (reduce-scatter, backward all-gather) leaves
a block whose weights are sharded and :func:`seq_slice` (this rank's
rows, backward zero-pad) one whose weights are replicated.

A block that runs between an entry and an exit point
(:func:`tp_enter`, :func:`tp_exit`) sees, in the backward pass, a
*share* of each gradient on every rank: the entry sums the ranks'
shares, so a leaf the block holds whole (model-replicated) gets a
share too, which ``core.zero`` sums over the ``model`` ranks.  A value
the block computes whole on every rank (the MoE aux losses, the output
of a replicated part) turns its whole gradient into a share through
:func:`tp_share`.

:func:`use_params` is the ZeRO-3 point: the train step installs a
function (``core.zero``) that all-gathers the data-sharded parameters
where the model uses them.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.monitoring.trace import SPANS

Rules = Callable[[str, tuple], Optional[tuple]]   # (name, shape) -> spec

_RULES: contextvars.ContextVar[Optional[Rules]] = contextvars.ContextVar(
    "repro_torch_act_sharding_rules", default=None)

#: (process group, reduce "attn_out"?, reduce "mlp_out"?, counts or None)
_TP_REDUCE: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "repro_torch_tp_reduce", default=None)


@contextlib.contextmanager
def activation_sharding(rules: Optional[Rules]):
    """Install activation-sharding rules for model code run inside the
    block."""
    tok = _RULES.set(rules)
    try:
        yield
    finally:
        _RULES.reset(tok)


def activation_spec(name: str, shape: tuple) -> Optional[tuple]:
    """The installed rules' spec for a logical activation, or None (no
    rules, or no rule for ``name``)."""
    rules = _RULES.get()
    return None if rules is None else rules(name, tuple(shape))


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    """The identity, with or without rules (see the module docstring)."""
    return x


@contextlib.contextmanager
def tp_reduce_scope(group, attn: bool, mlp: bool, counts=None):
    """Install cross-shard reductions for model code run inside the block.

    ``group`` is the ``model`` axis's process group.  ``attn``/``mlp`` gate
    the two reduction points independently: a block whose dimension does
    not divide the shard count keeps its weights replicated, and a
    reduction there would multiply its complete result by the shard count.
    ``counts`` (optional dict) accumulates ``{"attn_out": n, "mlp_out":
    m}``, one per all-reduce issued."""
    tok = _TP_REDUCE.set((group, attn, mlp, counts))
    try:
        yield
    finally:
        _TP_REDUCE.reset(tok)


def tp_will_reduce(kind: str) -> bool:
    """True when :func:`maybe_psum` would reduce at this point.  Call sites
    use it to keep the partial contraction in float32 through the
    reduction: summing already-rounded bf16 partials rounds twice, and the
    extra half-ulp can flip a near-tie greedy argmax against the one-shard
    contraction, which rounds its f32 accumulator once."""
    spec = _TP_REDUCE.get()
    if spec is None:
        return False
    _, attn, mlp, _ = spec
    return attn if kind == "attn_out" else mlp


def maybe_psum(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Sum a partial over the scope's shards at a named reduction point
    (``"attn_out"`` | ``"mlp_out"``), in place; the identity outside
    :func:`tp_reduce_scope` or where the point's block is replicated."""
    spec = _TP_REDUCE.get()
    if spec is None:
        return x
    group, attn, mlp, counts = spec
    if (kind == "attn_out" and not attn) or (kind == "mlp_out" and not mlp):
        return x
    if counts is not None:
        counts[kind] = counts.get(kind, 0) + 1
    x = x.contiguous()             # einsum may return a permuted view
    dist.all_reduce(x, group=group)
    return x


# -------------------------------------------- training tensor parallelism ----

@dataclass(frozen=True)
class TrainTP:
    """What the ``model`` axis shards in one training run, seen from one
    rank: ``index`` of ``size`` ranks in ``group``.  ``attn``: query heads
    (and ``kv`` when the kv heads divide too; otherwise each rank slices
    the kv heads its query heads use from the replicated ``wk``/``wv``);
    ``mlp``: the FFN hidden dim; ``vocab``: the embedding table's and the
    LM head's rows; ``ssm``: the SSD heads (and with them the inner dim);
    ``ssm_inner``: the inner dim (``wz``/``wx``/``norm_scale``/``wo``),
    also where the heads do not divide; ``experts``: the routed experts
    (expert parallelism); ``expert_ffn``: each expert's ``d_ff``
    (TP-in-expert, where the expert count does not divide); ``shared``:
    the shared experts' ``d_ff``.  ``seq_parallel`` is the run's knob;
    ``seq`` is set for one forward pass whose sequence divides ``size``
    (:meth:`seq_rows`): the residual stream then holds this rank's
    rows."""
    group: object
    index: int
    size: int
    attn: bool = False
    kv: bool = False
    mlp: bool = False
    vocab: bool = False
    ssm: bool = False
    ssm_inner: bool = False
    experts: bool = False
    expert_ffn: bool = False
    shared: bool = False
    seq_parallel: bool = False
    seq: bool = False

    def seq_rows(self, S: int) -> bool:
        """Whether a sequence of ``S`` positions is sharded over the
        ranks under ``seq_parallel`` (the JAX rules' ``seq()``: when
        ``S`` divides)."""
        return self.seq_parallel and S % self.size == 0 and S >= self.size


_TRAIN_TP: contextvars.ContextVar[Optional[TrainTP]] = contextvars.ContextVar(
    "repro_torch_train_tp", default=None)


@contextlib.contextmanager
def tp_train_scope(plan: Optional[TrainTP]):
    """Install a training tensor-parallel plan for model code run inside
    the block (None: no tensor parallelism)."""
    tok = _TRAIN_TP.set(plan)
    try:
        yield
    finally:
        _TRAIN_TP.reset(tok)


def tp_train() -> Optional[TrainTP]:
    return _TRAIN_TP.get()


#: whether the decode KV cache holds this rank's block of its lines (the
#: serve step's layout where the kv heads do not divide the ``model``
#: ranks of the installed training plan, as JAX's cache rules place it)
_SEQ_KV: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_seq_kv", default=False)


@contextlib.contextmanager
def seq_kv_scope(on: bool):
    """Mark the decode KV cache as sharded on its lines over the training
    plan's ranks (``models.attention.attention_decode``) for model code
    run inside the block."""
    tok = _SEQ_KV.set(on)
    try:
        yield
    finally:
        _SEQ_KV.reset(tok)


def seq_kv() -> bool:
    return _SEQ_KV.get()


def collectives_scoped() -> bool:
    """Whether model code run here may issue a collective: a serving
    reduction scope, a training tensor-parallel plan or a ZeRO-3 gather is
    installed."""
    return (_TP_REDUCE.get() is not None or _TRAIN_TP.get() is not None
            or _PARAM_USE.get() is not None)


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: the sum of ``x`` over ``group``, reduced in f32 and
    returned in ``x``'s dtype."""
    y = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, size):
        ctx.index, ctx.n = index, x.shape[-1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.index * ctx.n, ctx.n), None, None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


class _Share(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size):
        ctx.size = size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


def _gather_dim(x: torch.Tensor, dim: int, group, size: int):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _scatter_dim_f32(x: torch.Tensor, dim: int, group, size: int):
    """This rank's block along ``dim`` of the sum over ``group``, reduced
    in f32 and returned in ``x``'s dtype."""
    chunks = [c.to(torch.float32).contiguous()
              for c in x.chunk(size, dim=dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out.to(x.dtype)


class _GatherSum(torch.autograd.Function):
    """All-gather along ``dim``; the backward reduce-scatters."""

    @staticmethod
    def forward(ctx, x, dim, group, size):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        return _gather_dim(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return (_scatter_dim_f32(g, ctx.dim, ctx.group, ctx.size), None,
                None, None)


class _ScatterSum(torch.autograd.Function):
    """Reduce-scatter along ``dim``; the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, dim, group, size):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        return _scatter_dim_f32(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.dim, ctx.group, ctx.size), None, None, None


def tp_copy(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel product: the identity forward; the
    backward sums the input's gradient over the ``model`` ranks, each of
    which holds the part its columns contribute."""
    plan = _TRAIN_TP.get()
    return x if plan is None else _Copy.apply(x, plan.group)


def tp_reduce(x: torch.Tensor) -> torch.Tensor:
    """The output of a row-parallel product: all-reduce the partial sums
    over the ``model`` ranks (in f32, rounded once to ``x``'s dtype); the
    backward hands each rank the whole gradient, as it is."""
    plan = _TRAIN_TP.get()
    return x if plan is None else _Reduce.apply(x, plan.group)


def tp_gather_last(x: torch.Tensor) -> torch.Tensor:
    """Concatenate the ``model`` ranks' slices of the last dim in rank
    order (vocab-parallel logits); the backward keeps this rank's slice
    of the gradient."""
    plan = _TRAIN_TP.get()
    if plan is None:
        return x
    return _GatherLast.apply(x, plan.group, plan.index, plan.size)


def tp_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ``model`` ranks (in f32), forward and backward:
    for a value every rank reads for its own slice, whose gradient each
    rank therefore holds in part."""
    plan = _TRAIN_TP.get()
    return x if plan is None else _Sum.apply(x, plan.group)


def tp_share(x: torch.Tensor) -> torch.Tensor:
    """The identity forward; the backward divides the gradient by the
    rank count: a value computed whole on every rank inside a block whose
    gradients are shares (module docstring)."""
    plan = _TRAIN_TP.get()
    return x if plan is None else _Share.apply(x, plan.size)


def tp_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole of a leaf sharded on ``dim`` over the ``model`` ranks,
    for a block that runs it whole; the backward sums the ranks' shares
    of its gradient and keeps this rank's block (a reduce-scatter)."""
    plan = _TRAIN_TP.get()
    if plan is None:
        return x
    return _GatherSum.apply(x, dim, plan.group, plan.size)


def seq_gather(x: torch.Tensor) -> torch.Tensor:
    """(B, S/m, ...) rows of every rank -> (B, S, ...) in rank order; the
    backward reduce-scatters (sums the ranks' parts of the gradient and
    keeps this rank's rows).  The identity unless the stream is
    sequence-sharded."""
    plan = _TRAIN_TP.get()
    if plan is None or not plan.seq:
        return x
    return _GatherSum.apply(x, 1, plan.group, plan.size)


def seq_scatter(x: torch.Tensor) -> torch.Tensor:
    """A partial (B, S, ...) summed over the ranks, of which this rank
    keeps its rows (a reduce-scatter in f32); the backward all-gathers.
    The identity unless the stream is sequence-sharded."""
    plan = _TRAIN_TP.get()
    if plan is None or not plan.seq:
        return x
    return _ScatterSum.apply(x, 1, plan.group, plan.size)


def seq_slice(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a (B, S, ...) value every rank holds whole;
    the backward zero-pads (the entry's reduce-scatter sums the ranks'
    rows).  The identity unless the stream is sequence-sharded."""
    plan = _TRAIN_TP.get()
    if plan is None or not plan.seq:
        return x
    n = x.shape[1] // plan.size
    return x.narrow(1, plan.index * n, n)


def tp_enter(x: torch.Tensor) -> torch.Tensor:
    """The entry of a block run between points: :func:`seq_gather` on a
    sequence-sharded stream, else :func:`tp_copy`."""
    plan = _TRAIN_TP.get()
    if plan is None:
        return x
    return seq_gather(x) if plan.seq else _Copy.apply(x, plan.group)


def tp_exit(x: torch.Tensor, partial: bool) -> torch.Tensor:
    """The exit of a block run between points: a ``partial`` output (the
    ranks' shards summed) through :func:`seq_scatter` or
    :func:`tp_reduce`; a whole one (every rank computed all of it)
    through :func:`seq_slice` or :func:`tp_share`."""
    plan = _TRAIN_TP.get()
    if plan is None:
        return x
    if partial:
        return seq_scatter(x) if plan.seq else _Reduce.apply(x, plan.group)
    return seq_slice(x) if plan.seq else _Share.apply(x, plan.size)


# ------------------------------------------------------- ZeRO-3 gathers ----

_PARAM_USE: contextvars.ContextVar[Optional[Callable]] = \
    contextvars.ContextVar("repro_torch_param_use", default=None)


@contextlib.contextmanager
def param_use_scope(fn: Optional[Callable]):
    """Install ``fn(tree, which) -> tree``, which :func:`use_params` calls
    where the model reads its parameters."""
    tok = _PARAM_USE.set(fn)
    try:
        yield
    finally:
        _PARAM_USE.reset(tok)


def use_params(tree, which: str):
    """The parameters as the model uses them: ``which`` is ``"root"``
    (the whole tree, of which the leaves outside ``layers`` are read) or
    ``"layers"`` (one layer group's list of sublayer trees, taken from
    the stacked leaves).  The identity outside :func:`param_use_scope`;
    under ZeRO-3 the installed function all-gathers the data shards."""
    fn = _PARAM_USE.get()
    return tree if fn is None else fn(tree, which)


def snapshot():
    """A context manager factory that installs, wherever it is entered,
    the rules, plans and hooks installed here now, and the traced call's
    span scope (``monitoring.trace.SPANS``).  Recomputation under
    ``torch.utils.checkpoint`` reruns a body inside the backward pass,
    which on a CUDA device runs on autograd's own thread, where the
    caller's context variables are not set."""
    saved = [(var, var.get()) for var in (_RULES, _TP_REDUCE, _TRAIN_TP,
                                          _PARAM_USE, SPANS)]

    @contextlib.contextmanager
    def scope():
        toks = [(var, var.set(value)) for var, value in saved]
        try:
            yield
        finally:
            for var, tok in reversed(toks):
                var.reset(tok)

    return scope
