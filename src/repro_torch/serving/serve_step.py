"""Serve-step builders: the decode analogue of ``training.train_step`` —
the port of the JAX package's ``serving/serve_step.py``.

``decode_32k`` / ``long_500k`` dry-run shapes run exactly
:func:`make_serve_step`'s step — ONE new token against a ``seq_len`` KV
cache.  :func:`make_fused_serve_step` is the engine's fused chunk
(``models.model.decode_n``: N tokens a call, sampling and stop masking
on the device), and :func:`make_chunked_serve_step` the budgeted
engine's mixed step: a prefill chunk (``models.model.prefill_chunk``)
written into the shared paged pool, then a ``decode_n`` over every lane.

A step is a plain callable on this rank's shards, with no compilation:
the weights lie as the training layout lays them out
(``core.sharding.param_shardings``, the JAX step's ``in_shardings``), and
the cache as ``core.sharding.cache_shardings`` lays it out (batch over the
batch axes, kv heads or SSD heads over ``model``).  So, as under JAX, a
ZeRO-3 layout gathers its data-sharded weights at use on every step
(``core.zero.Layout.param_use`` through ``core.actshard.use_params``), and
a tensor-parallel one reduces at attention-out and MLP-down
(``core.actshard.tp_reduce_scope``), its vocab-parallel embedding and head
going through the training plan's points.  The cache is updated in place,
as the engine's is (JAX donates it).  The token vectors and the outputs
are this rank's rows, the rows its cache holds, as JAX's partitioner
lays them out beside a batch-sharded cache; the chunked step's pool has
no batch dim, so every rank runs every lane there.

Where the kv heads do not divide the ``model`` ranks, JAX shards the
decode cache on its lines there; each rank then scores every query head
against its lines and the softmax is combined over the ranks
(``models.attention._decode_seq_sharded``).  Prefill slices the kv heads
its query heads read, as training does.  An SSD block runs on the
rank's heads as in training (``models.ssm``), its conv window whole on
every rank.  The builders refuse a paged pool sharded on its lines.

The ``*_lowering_args`` are this rank's arguments on the ``meta`` device
(local shard shapes; the dry run's counterpart of JAX's
``ShapeDtypeStruct`` arguments).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig, RunConfig
from repro_torch.core import sharding as shd
from repro_torch.core.actshard import (
    param_use_scope, seq_kv_scope, tp_reduce_scope, tp_train_scope,
)
from repro_torch.core.zero import Layout
from repro_torch.models.attention import _kv_of_local_heads
from repro_torch.models.init import abstract_params
from repro_torch.models.model import (
    cache_logical_axes, decode_n, decode_step, init_cache, prefill,
    prefill_chunk,
)
from repro_torch.models.paging import PagedKVConfig


class ServeLayout:
    """Where a serve step's weights and cache live, seen from one rank,
    and the scopes its model code runs in.  ``counts`` (a dict, or None)
    accumulates the attention-out and MLP-down all-reduces by kind, as
    the engine's TP scope counts them."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, mesh, batch: int,
                 cache_len: int, paging: Optional[PagedKVConfig] = None,
                 kind: str = "decode"):
        self.cfg, self.run, self.mesh, self.paging = cfg, run, mesh, paging
        self.layout = layout = Layout(cfg, mesh, run)
        plan = self.plan = layout.tp
        if plan is not None and plan.mlp and cfg.moe is not None \
                and cfg.moe.num_shared:
            raise NotImplementedError(
                f"{cfg.name}: dense MLPs sharded beside shared experts")
        self.cache_abs, self.seq_kv = None, False
        if kind == "decode":
            self.cache_abs = init_cache(cfg, batch, cache_len, abstract=True,
                                        paging=paging)
            self.cache_specs = shd.cache_shardings(
                cfg, mesh, run, self.cache_abs, paging=paging is not None)
            axes = [ax for _, ax in shd.spec_leaves(cache_logical_axes(
                cfg, paging=paging is not None))]
            self.seq_kv = any("cache_seq" in ax and spec[ax.index(
                "cache_seq")] for (_, spec), ax in zip(
                    shd.spec_leaves(self.cache_specs), axes))
            if self.seq_kv and paging is not None:
                raise NotImplementedError(
                    f"{cfg.name}: {cfg.num_kv_heads} kv heads over model "
                    f"{layout.n_model} shard the paged pool's lines, which "
                    "the chunked step does not run")
            if plan is not None and plan.attn and not plan.kv \
                    and not self.seq_kv:
                raise NotImplementedError(
                    f"{cfg.name}: query heads sharded over a cache that "
                    "holds every line and kv head")
        base = layout.param_use()
        # prefill computes the kv heads its query heads read, as training
        # does; a sequence-sharded decode cache holds every kv head
        slice_kv = plan is not None and plan.attn and not plan.kv \
            and kind == "prefill"
        if base is None and not slice_kv:
            self.use = None
        else:
            def use(tree, which):
                if base is not None:
                    tree = base(tree, which)
                if which == "layers" and slice_kv:
                    tree = [dict(sub, attn=_kv_of_local_heads(
                        sub["attn"], cfg, plan.index)) if "attn" in sub
                        else sub for sub in tree]
                return tree
            self.use = use
        self.rows = layout.batch_rows(batch)

    @contextlib.contextmanager
    def scope(self, counts=None):
        """Install the ZeRO-3 gathers at use and the tensor-parallel
        points for model code run inside the block."""
        plan = self.plan
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.no_grad())
            stack.enter_context(param_use_scope(self.use))
            if plan is not None:
                stack.enter_context(tp_train_scope(plan))
                stack.enter_context(tp_reduce_scope(
                    plan.group, attn=plan.attn, mlp=plan.mlp, counts=counts))
                stack.enter_context(seq_kv_scope(self.seq_kv))
            yield

    @property
    def local_batch(self) -> int:
        """The rows of the batch this rank serves."""
        return self.rows[1]

    def params(self):
        """This rank's parameter shards on ``meta``."""
        return self.layout.local_meta(
            abstract_params(self.cfg),
            shd.param_shardings(self.cfg, self.mesh, self.run))

    def cache(self):
        """This rank's block of the cache on ``meta``."""
        return self.layout.local_meta(self.cache_abs, self.cache_specs)


def make_prefill_step(cfg: ModelConfig, run: RunConfig, mesh, batch: int,
                      seq_len: int):
    """Returns ``f(params, batch) -> (logits, cache slice)``: the model's
    ``prefill`` of this rank's rows of a ``batch``-row batch under the
    training layout, as the JAX dry run lowers it for prefill shapes."""
    lay = ServeLayout(cfg, run, mesh, batch, seq_len, kind="prefill")

    def step(params, rows):
        with lay.scope():
            return prefill(params, rows, cfg, run)

    step.layout = lay
    return step


def make_serve_step(cfg: ModelConfig, run: RunConfig, mesh, batch: int,
                    cache_len: int, counts=None):
    """Returns ``f(params, cache, token, pos) -> (logits, cache)``: one
    decode step of this rank's rows of the ``batch`` slots (``token`` (b,
    1), ``pos`` a scalar), the cache written in place.  ``counts``: see
    :class:`ServeLayout`."""
    lay = ServeLayout(cfg, run, mesh, batch, cache_len)

    def step(params, cache, token, pos):
        with lay.scope(counts):
            return decode_step(params, cache, token, pos, cfg, run)

    step.layout = lay
    return step


def serve_step_lowering_args(cfg: ModelConfig, run: RunConfig, mesh,
                             shape: InputShape):
    """This rank's (params, cache, token, pos) on ``meta``."""
    lay = ServeLayout(cfg, run, mesh, shape.global_batch, shape.seq_len)
    token = torch.empty((lay.local_batch, 1), dtype=torch.int32,
                        device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    return lay.params(), lay.cache(), token, pos


def make_fused_serve_step(cfg: ModelConfig, run: RunConfig, mesh,
                          batch: int, cache_len: int, num_tokens: int = 8,
                          counts=None):
    """Returns the fused chunk the engine dispatches: ``f(params, cache,
    token, pos, remaining, done, eos, temps, key) -> (tokens, cache,
    token, pos, remaining, done, key)``, the (b,) vectors this rank's
    rows.  ``key`` is the sampler's ``torch.Generator`` (advanced in
    place; None on ``meta``, where no number is drawn)."""
    lay = ServeLayout(cfg, run, mesh, batch, cache_len)

    def step(params, cache, token, pos, remaining, done, eos, temps, key):
        with lay.scope(counts):
            return decode_n(params, cache, token, pos, remaining, done, eos,
                            temps, key, cfg, run, num_tokens,
                            cache_len) + (key,)

    step.layout = lay
    return step


def fused_serve_step_lowering_args(cfg: ModelConfig, run: RunConfig, mesh,
                                   shape: InputShape):
    """This rank's arguments of :func:`make_fused_serve_step` on
    ``meta``."""
    lay = ServeLayout(cfg, run, mesh, shape.global_batch, shape.seq_len)

    def vec(dt):
        return torch.empty((lay.local_batch,), dtype=dt, device="meta")

    return (lay.params(), lay.cache(), vec(torch.int32), vec(torch.int32),
            vec(torch.int32), vec(torch.bool), vec(torch.int32),
            vec(torch.float32), None)


def _chunked_paging(cache_len: int, batch: int,
                    page_size: int) -> PagedKVConfig:
    """The pool layout the budgeted engine defaults to: one dense HBM
    budget's worth of pages (batch * cache_len lines) plus the null page."""
    return PagedKVConfig.for_budget(batch * cache_len, page_size, cache_len)


def make_chunked_serve_step(cfg: ModelConfig, run: RunConfig, mesh,
                            batch: int, cache_len: int, page_size: int = 16,
                            num_tokens: int = 8, counts=None):
    """Returns the budgeted engine's mixed step: ``f(params, cache, token,
    pos, remaining, done, eos, temps, key, page_table, limit, c_tokens,
    c_row, c_start, c_last, c_pages, c_offs) -> (tokens, cache, token,
    pos, remaining, done, key, c_logits)`` — a prefill chunk of one
    request (``c_tokens`` (1, C); ``c_start``, ``c_last`` ints) written
    line by line at ``(c_pages, c_offs)``, then a ``num_tokens``-token
    decode over every lane, both against the shared paged pool.  The pool
    has no batch dim, so every rank runs every lane."""
    paging = _chunked_paging(cache_len, batch, page_size)
    lay = ServeLayout(cfg, run, mesh, batch, cache_len, paging=paging)

    def step(params, cache, token, pos, remaining, done, eos, temps, key,
             page_table, limit, c_tokens, c_row, c_start, c_last,
             c_pages, c_offs):
        with lay.scope(counts):
            c_logits, c_slices = prefill_chunk(
                params, {"tokens": c_tokens}, cache, c_row, c_start, cfg,
                run, last_pos=c_last)
            pages, offs = c_pages.to(torch.int64), c_offs.to(torch.int64)
            for dst, src in zip(cache["layers"], c_slices["layers"]):
                for name in ("k", "v"):
                    dst[name][:, pages, offs] = src[name][:, 0].to(
                        dst[name].dtype)
            out = decode_n(params, cache, token, pos, remaining, done, eos,
                           temps, key, cfg, run, num_tokens, cache_len,
                           page_table=page_table, limit=limit)
            return out + (key, c_logits)

    step.layout = lay
    return step


def chunked_serve_step_lowering_args(cfg: ModelConfig, run: RunConfig,
                                     mesh, shape: InputShape,
                                     chunk: int = 64, page_size: int = 16):
    """This rank's arguments of :func:`make_chunked_serve_step` on
    ``meta`` (``c_start`` and ``c_last`` are ints: the port's chunk
    prefill takes them from the host)."""
    B = shape.global_batch
    paging = _chunked_paging(shape.seq_len, B, page_size)
    lay = ServeLayout(cfg, run, mesh, B, shape.seq_len, paging=paging)

    def meta(shp, dt=torch.int32):
        return torch.empty(shp, dtype=dt, device="meta")

    vec = meta((B,))
    return (lay.params(), lay.cache(), vec, meta((B,)), meta((B,)),
            meta((B,), torch.bool), meta((B,)), meta((B,), torch.float32),
            None, meta((B, paging.pages_per_seq)), meta((B,)),
            meta((1, chunk)), meta((1, paging.pages_per_seq)), 0, chunk - 1,
            meta((chunk,)), meta((chunk,)))
