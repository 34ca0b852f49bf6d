"""ZeRO stage semantics (paper §7.2) in eager SPMD — the port of the JAX
package's ``core/zero.py``.

Under GSPMD the stages fall out of *where tensors live*; here each rank
holds its own shard of every leaf and the collectives are written out
where GSPMD would insert them:

  stage 1 — optimizer state sharded on `data`; params + grads replicated
            across `data` (modulo TP).  Gradients are all-reduced over
            `data`, each rank updates its optimizer-layout slice, and the
            new params are all-gathered back.
  stage 2 — + gradients reduce-scattered into the optimizer layout.
  stage 3 — + parameters sharded (FSDP, strategies ``fsdp`` and
            ``fsdp_tp``): weights are all-gathered at use, per layer
            group, inside the recomputed body
            (:meth:`Layout.param_use`); the gather's backward
            reduce-scatters their gradients.

``core.sharding`` gives the specs (``param_shardings``, ``opt_shardings``);
:class:`Layout` reads them for one rank of a ``launch.mesh.Mesh`` and
slices, gathers and reduces by them.  On a one-cell mesh every operation
here is the identity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import sharding as shd
from repro_torch.core.actshard import TrainTP
from repro_torch.core.parallelism import get_strategy
from repro_torch.tree import leaves_with_path, unflatten


#: elements of a whole leaf that one gather of :meth:`Layout.gather_slices`
#: moves at most (64 MiB in f32)
SLICE_ELEMS = 1 << 24


def grad_shardings(cfg: ModelConfig, mesh, run: RunConfig):
    """Spec tree of the gradients: the optimizer layout from ZeRO stage 2,
    the parameter layout below it."""
    if run.zero_stage >= 2:
        return shd.opt_shardings(cfg, mesh, run)
    return shd.param_shardings(cfg, mesh, run)


def _dim(spec: tuple, axis: str) -> Optional[int]:
    """The dimension a spec shards on ``axis`` (None: replicated)."""
    for i, e in enumerate(spec):
        if e == axis or (isinstance(e, tuple) and axis in e):
            return i
    return None


def _data_entry(spec: tuple):
    """The spec's entry on the batch axes: ``"data"``, ``("pod",
    "data")`` (a multi-pod mesh where the joint product divides), or None
    (replicated there)."""
    dim = _dim(spec, "data")
    return None if dim is None else spec[dim]


@dataclass(frozen=True)
class Leaf:
    """One parameter leaf's placement on the mesh."""
    path: str
    shape: tuple                 # the whole leaf
    param: tuple                 # spec in the parameter layout
    opt: tuple                   # spec in the optimizer (and ZeRO-2 grad)
    partial_model: bool = False  # its gradient is partial over `model`
    partial_seq: bool = False    # ... when the sequence is sharded there

    @property
    def data_dim(self) -> Optional[int]:
        """The dim ZeRO-3 shards the parameter itself on."""
        return _dim(self.param, "data")

    @property
    def opt_data_dim(self) -> Optional[int]:
        """The dim the optimizer slice takes of a data-replicated param."""
        return None if self.data_dim is not None else _dim(self.opt, "data")


class Layout:
    """Where every leaf of a training run lives, seen from one rank.

    ``mesh`` is a ``launch.mesh.Mesh`` (its coordinates and groups):
    ``(data, model)``, or ``(pod, data, model)``, where a leaf's batch-axis
    entry is ``("pod", "data")`` when the joint product divides its dim
    and ``"data"`` alone otherwise (replicated over ``pod``, as JAX lays
    it out).  Slices, gathers and reductions go over the entry's own
    group; the gradient of a leaf held whole on each pod is then summed
    over ``pod`` too.  Leaves are listed in ``repro_torch.tree.leaves``
    order."""

    def __init__(self, cfg: ModelConfig, mesh, run: RunConfig):
        self.cfg, self.mesh, self.run = cfg, mesh, run
        self.strategy = get_strategy(run.strategy)
        sizes = mesh.shape
        self.n_pod = sizes.get("pod", 1)
        self.n_data = sizes["data"]
        self.n_model = sizes["model"]
        coord = dict(zip(mesh.axis_names, mesh.coords))
        self.p, self.d, self.m = (coord.get("pod", 0), coord["data"],
                                  coord["model"])
        p_specs = shd.param_shardings(cfg, mesh, run)
        o_specs = shd.opt_shardings(cfg, mesh, run)
        from repro_torch.models.spec import model_spec
        shapes = [ps.shape for _, ps in _ps_leaves(model_spec(cfg))]
        pl, ol = shd.spec_leaves(p_specs), shd.spec_leaves(o_specs)
        self.tp = self._tp_plan(p_specs)
        partial = self._partial_leaves(p_specs, seq=False)
        partial_seq = self._partial_leaves(p_specs, seq=True)
        self.leaves = [Leaf(path, shape, p, o, path in partial,
                            path in partial_seq)
                       for (path, p), (_, o), shape in zip(pl, ol, shapes)]

    # ------------------------------------------------------------ plans ----
    def _tp_plan(self, p_specs) -> Optional[TrainTP]:
        """What the model axis shards, read from the parameter specs of
        the first sublayer of each kind (stacked: the layers dim first)."""
        if self.n_model <= 1 or not self.strategy.tp:
            return None
        on = {}
        for sub in p_specs["layers"]:
            if "attn" in sub:
                on.setdefault("attn", "model" in sub["attn"]["wq"])
                on.setdefault("kv", "model" in sub["attn"]["wk"])
            if "mlp" in sub:
                on.setdefault("mlp", "model" in sub["mlp"]["w1"])
            if "ssm" in sub:
                on.setdefault("ssm", "model" in sub["ssm"]["wdt"])
                on.setdefault("ssm_inner", "model" in sub["ssm"]["wx"])
            if "moe" in sub:
                w1 = sub["moe"]["w1"]              # (layers, E, d, f)
                on.setdefault("experts", _dim(w1, "model") == 1)
                on.setdefault("expert_ffn", _dim(w1, "model") == 3)
                if "shared" in sub["moe"]:
                    on.setdefault("shared",
                                  "model" in sub["moe"]["shared"]["w1"])
        return TrainTP(self.mesh.group("model"), self.m, self.n_model,
                       vocab="model" in p_specs["embed"]["tok"],
                       seq_parallel=self.run.seq_parallel, **on)

    def _partial_leaves(self, p_specs, seq: bool) -> set:
        """Leaves whose gradient each model rank holds only in part (a
        share, ``core.actshard``): the model-replicated leaves of every
        block that runs between points — one that shards any of its
        weights (the replicated kv projections of head-sharded attention;
        the SSD block's ``wB``/``wC`` and conv, which every head shard
        reads whole; the MoE router) — and, with the sequence sharded
        (``seq``), every model-replicated leaf: the blocks, the norm
        scales, a replicated embedding and head.  A leaf outside them (a
        norm scale without ``seq``) gets its whole gradient on every
        rank."""
        if self.tp is None or (seq and not self.tp.seq_parallel):
            return set()

        def replicated(tree, path):
            if isinstance(tree, dict):
                return [x for k in tree
                        for x in replicated(tree[k], f"{path}[{k!r}]")]
            return [] if "model" in tree else [path]

        out = set()
        for i, sub in enumerate(p_specs["layers"]):
            for block, tree in sub.items():
                if block.startswith("norm"):
                    share = seq
                else:
                    share = seq or any("model" in spec for _, spec in
                                       shd.spec_leaves(tree))
                if share:
                    out.update(replicated(tree, f"['layers'][{i}][{block!r}]"))
        if seq:
            for k in p_specs:
                if k != "layers":
                    out.update(replicated(p_specs[k], f"[{k!r}]"))
        return out

    @property
    def world(self) -> int:
        return self.n_pod * self.n_data * self.n_model

    @property
    def batch_group(self):
        """The group of the ranks that share this rank's ``model`` index:
        the batch's ranks (``("pod", "data")`` on a pod mesh)."""
        if self.n_pod > 1:
            return self.mesh.group(("pod", "data"))
        return self.mesh.group("data")

    def batch_rows(self, rows: int) -> tuple[int, int]:
        """(start, count) of this rank's rows of a ``rows``-row batch
        (``sharding.batch_partition``): a block of the batch axes, or all
        of them when the batch does not divide."""
        axes = shd.batch_partition(self.mesh, rows, self.strategy)
        if not axes:
            return 0, rows
        i, n = self._index(shd._entry(axes))
        if n == 1:
            return 0, rows
        return i * (rows // n), rows // n

    # ------------------------------------------------------------ slices ----
    def _index(self, entry) -> tuple[int, int]:
        """(this rank's index, the rank count) along a spec entry."""
        if entry == "model":
            return self.m, self.n_model
        if entry == "data":
            return self.d, self.n_data
        if entry == ("pod", "data"):
            return self.p * self.n_data + self.d, self.n_pod * self.n_data
        raise ValueError(f"spec entry {entry!r}")

    def local(self, full: torch.Tensor, spec: tuple) -> torch.Tensor:
        """This rank's block of a whole leaf under ``spec`` (a view)."""
        out = full
        for dim, e in enumerate(spec):
            if e is not None:
                i, n = self._index(e)
                size = full.shape[dim] // n
                out = out.narrow(dim, i * size, size)
        return out

    def _sharded(self, spec: tuple) -> list:
        """``[(dim, entry)]`` of a spec's sharded dims: the batch axes'
        first, then ``model``'s (the order of the gathers)."""
        out = []
        for axis in ("data", "model"):
            dim = _dim(spec, axis)
            if dim is not None:
                out.append((dim, spec[dim]))
        return out

    def local_meta(self, tree, specs):
        """``meta`` tensors of this rank's blocks of a tree of whole leaves
        under a spec tree (the dry run's arguments: shapes, no storage)."""
        spec_list = [s for _, s in shd.spec_leaves(specs)]
        return unflatten(tree, [
            torch.empty(tuple(self.local(t, s).shape), dtype=t.dtype,
                        device="meta")
            for (_, t), s in zip(leaves_with_path(tree), spec_list)])

    def gather(self, local: torch.Tensor, spec: tuple) -> torch.Tensor:
        """The whole leaf from every rank's block (collective)."""
        out = local
        for dim, e in self._sharded(spec):
            out = _all_gather_dim(out, dim, self.mesh.group(e),
                                  self._index(e)[1])
        return out

    def shard(self, tree, specs_of: str = "param"):
        """Contiguous copies of this rank's blocks of a tree of whole
        leaves, in the parameter (``"param"``) or optimizer layout."""
        out = []
        for leaf, (_, t) in zip(self.leaves, leaves_with_path(tree)):
            spec = leaf.param if specs_of == "param" else leaf.opt
            out.append(self.local(t, spec).clone())
        return unflatten(tree, out)

    def gather_tree(self, tree, specs_of: str = "param"):
        """The whole leaves of a tree of this rank's blocks (collective)."""
        out = []
        for leaf, (_, t) in zip(self.leaves, leaves_with_path(tree)):
            out.append(self.gather(t, leaf.param if specs_of == "param"
                                   else leaf.opt))
        return unflatten(tree, out)

    def gather_slices(self, local: torch.Tensor, spec: tuple):
        """The whole leaf of this rank's block under ``spec``, a slice at
        a time (collective, a gather a slice): yields ``(index, part)``,
        ``part`` the whole leaf's block at ``index`` (a tuple of slices),
        cut along its first unsharded dimension so that each holds about
        ``SLICE_ELEMS`` elements at most; every rank gets every part."""
        free = [d for d in range(local.ndim)
                if local.shape[d] > 1 and spec[d] is None]
        if not free:
            yield (), self.gather(local, spec)
            return
        dim = free[0]
        rows = local.shape[dim]
        whole = local.numel() * self.world // max(
            1, self._copies(spec))
        step = max(1, SLICE_ELEMS // max(1, whole // rows))
        for r in range(0, rows, step):
            n = min(step, rows - r)
            index = (slice(None),) * dim + (slice(r, r + n),)
            yield index, self.gather(local.narrow(dim, r, n), spec)

    def _copies(self, spec: tuple) -> int:
        """How many ranks hold each block of a leaf under ``spec``."""
        blocks = 1
        for _, e in self._sharded(spec):
            blocks *= self._index(e)[1]
        return self.world // blocks

    def opt_view(self, leaf: Leaf, t: torch.Tensor) -> torch.Tensor:
        """The optimizer-layout slice of a parameter-layout tensor (a view
        of it; the tensor itself where the two layouts agree)."""
        dim = leaf.opt_data_dim
        if dim is None:
            return t
        i, n = self._index(leaf.opt[dim])
        if n == 1:
            return t
        size = t.shape[dim] // n
        return t.narrow(dim, i * size, size)

    def owned(self, leaf: Leaf) -> bool:
        """Whether this rank counts ``leaf``'s optimizer slice in a sum
        over the world: once per distinct slice."""
        o = leaf.opt
        e = _data_entry(o)
        on_pod = e == ("pod", "data") or self.p == 0
        return ((e is not None or self.d == 0) and on_pod
                and (_dim(o, "model") is not None or self.m == 0))

    # --------------------------------------------------------- gradients ----
    def seq_rows(self, S: int) -> bool:
        """Whether a forward pass of ``S`` positions shards the sequence
        over the model ranks (``TrainTP.seq_rows``)."""
        return self.tp is not None and self.tp.seq_rows(S)

    def reduce_grads(self, grads: list, dtype=None, seq: bool = False) -> list:
        """The gradient side of the JAX ``constrain_grads``: one backward
        pass's gradients (parameter layout; a ZeRO-3 leaf's already summed
        over its batch-axis entry by its gather) -> the ZeRO gradient
        layout (``grad_shardings``), summed over the batch's ranks and, for
        the partial leaves (of a pass with the sequence sharded: ``seq``),
        over the model ranks.  ``dtype`` (bf16 under
        ``grad_reduce_bf16``) is cast to before any reduction."""
        out = []
        split = self.n_pod * self.n_data > 1
        for leaf, g in zip(self.leaves, grads):
            if dtype is not None:
                g = g.to(dtype)
            if leaf.partial_seq if seq else leaf.partial_model:
                g = g.contiguous()
                dist.all_reduce(g, group=self.mesh.group("model"))
            if split and leaf.data_dim is None:
                dim = leaf.opt_data_dim
                if self.run.zero_stage >= 2 and dim is not None:
                    e = leaf.opt[dim]
                    g = _reduce_scatter_dim(g, dim, self.mesh.group(e),
                                            self._index(e)[1])
                    g = self._pod_sum(g, e)
                else:
                    g = g.contiguous()
                    dist.all_reduce(g, group=self.batch_group)
            elif split:
                g = self._pod_sum(g, _data_entry(leaf.param))
            out.append(g)
        return out

    def _pod_sum(self, g: torch.Tensor, entry) -> torch.Tensor:
        """The sum over ``pod`` of a gradient that a reduction over
        ``entry`` has summed over ``data`` only (a leaf held whole on each
        pod)."""
        if entry == "data" and self.n_pod > 1:
            g = g.contiguous()
            dist.all_reduce(g, group=self.mesh.group("pod"))
        return g

    def to_opt_layout(self, grads: list) -> list:
        """Gradients in the ZeRO gradient layout -> the optimizer layout
        (ZeRO 1 keeps whole gradients: take this rank's slice)."""
        if self.run.zero_stage >= 2:
            return grads
        return [self.opt_view(leaf, g) for leaf, g in zip(self.leaves, grads)]

    def regather_params(self, params: list) -> None:
        """After an update of each rank's optimizer slice, all-gather the
        slices of data-replicated parameters back into place."""
        if self.n_pod * self.n_data == 1:
            return
        for leaf, p in zip(self.leaves, params):
            dim = leaf.opt_data_dim
            if dim is None:
                continue
            e = leaf.opt[dim]
            i, k = self._index(e)
            n = p.shape[dim] // k
            parts = [torch.empty_like(p.narrow(dim, 0, n), memory_format=
                                      torch.contiguous_format)
                     for _ in range(k)]
            dist.all_gather(parts, p.narrow(dim, i * n, n).contiguous(),
                            group=self.mesh.group(e))
            for j, part in enumerate(parts):
                if j != i:
                    p.narrow(dim, j * n, n).copy_(part)

    # ------------------------------------------------------------ ZeRO-3 ----
    def param_use(self, grad_dtype=None):
        """The function ``core.actshard.use_params`` calls: all-gather the
        data-sharded leaves where the model reads them (casting f32 leaves
        to bf16 first under ``run.gather_bf16``), or None when the run
        gathers nothing and casts nothing.  ``grad_dtype`` is what the
        gathers' backward reduce-scatters in (None: the gradient's
        own)."""
        bf16 = self.run.gather_bf16
        dims = {leaf.path: leaf.data_dim for leaf in self.leaves}
        entries = {leaf.path: _data_entry(leaf.param) for leaf in self.leaves}
        if not bf16 and all(d is None for d in dims.values()):
            return None

        def use(t, dim, entry):
            if bf16 and t.dtype == torch.float32:
                t = t.to(torch.bfloat16)
            if dim is None:
                return t
            i, n = self._index(entry)
            if n == 1:
                return t
            return _GatherData.apply(t, dim, self.mesh.group(entry), n, i,
                                     grad_dtype)

        def walk(tree, path, drop):
            if isinstance(tree, dict):
                return {k: walk(v, f"{path}[{k!r}]", drop)
                        for k, v in tree.items()}
            if isinstance(tree, list):
                return [walk(v, f"{path}[{i}]", drop)
                        for i, v in enumerate(tree)]
            dim = dims[path]
            return use(tree, None if dim is None else dim - drop,
                       entries[path])

        def fn(tree, which):
            if which == "layers":      # one group's sublayers, layers dim off
                return [walk(sub, f"['layers'][{i}]", 1)
                        for i, sub in enumerate(tree)]
            return {k: (v if k == "layers" else walk(v, f"[{k!r}]", 0))
                    for k, v in tree.items()}

        return fn


def _ps_leaves(tree, path: str = ""):
    """``[(keystr path, ParamSpec)]`` of a parameter spec tree."""
    from repro_torch.models.spec import ParamSpec
    if isinstance(tree, ParamSpec):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _ps_leaves(tree[k], f"{path}[{k!r}]")]
    return [x for i, v in enumerate(tree)
            for x in _ps_leaves(v, f"{path}[{i}]")]


def _all_gather_dim(t: torch.Tensor, dim: int, group, n: int):
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter_dim(t: torch.Tensor, dim: int, group, n: int):
    chunks = [c.contiguous() for c in t.chunk(n, dim=dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out


class _GatherData(torch.autograd.Function):
    """ZeRO-3 at use: all-gather a data-sharded leaf along ``dim`` in the
    forward; reduce-scatter its gradient (in ``grad_dtype`` when given)
    in the backward, which sums the ranks' batch rows and hands each rank
    the gradient of its own shard."""

    @staticmethod
    def forward(ctx, shard, dim, group, n, index, grad_dtype):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        ctx.grad_dtype, ctx.dtype = grad_dtype, shard.dtype
        return _all_gather_dim(shard, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_dtype is not None:
            g = g.to(ctx.grad_dtype)
        out = _reduce_scatter_dim(g, ctx.dim, ctx.group, ctx.n)
        return out.to(ctx.dtype), None, None, None, None, None

