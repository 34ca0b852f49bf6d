"""Batched decode engine — the port of the JAX package's
``serving/engine.py::DecodeEngine`` for one card.

A fixed number of *slots* share one batched KV cache.  Requests queue
behind the multi-tenant :class:`~repro_torch.serving.admission.
AdmissionController`; when a slot frees, the next request is chosen by the
``2^(-usage/shares)`` fair-share priority, prefilled (its KV lines written
into the cache at the slot, or into its pages), and joins the batched
decode loop.  Finished requests free their slot at once.

The decode loop runs on the device: one call of ``models.model.decode_n``
generates ``decode_chunk`` tokens per slot with sampling and stop masking
on the device, and the host syncs ``tokens/pos/remaining/done`` once per
chunk, then does admission, ledger and metrics work — so QOS preemption
and fair-share picks happen at chunk boundaries.  On the card the token
steps replay CUDA graphs (``models.model.DecodeGraphs``, one per batch
and page-table width) outside a tensor-parallel scope.  ``fused=False``
keeps the per-token host loop (one ``decode_step`` and one host sample per
token), the reference the fused path is held to.

Prefill is **bucketed** when ``prefill_buckets`` is set: prompts pad at the
tail to the next bucket length (causal masking keeps the pad out of the
real positions).  The KV lines are written into the cache in place.

**Paged KV cache** (``kv_page_size > 0``): all slots share one device page
pool (``models.paging``).  A request holds ``ceil(tokens/page_size)``
pages, grows at decode-time page boundaries (the host pre-allocates each
chunk's worth before the call), and frees everything on finish or
eviction.  Admission is page-budget aware, GrpTRES can cap ``kv_pages``
per tenant, and the ledger bills page residency.  Pool exhaustion at
growth evicts one scavenger victim; if nothing is evictable the starved
slot requeues with its output kept.  In a hybrid (SSM and attention
sublayers) only the attention sublayers page; each SSM sublayer keeps its
state and conv window in per-slot rows, which an admission overwrites
whole with the prefill's (a prefill's state starts from zero, so nothing
of the slot's last request reaches the new one).

**Prefix cache** (``prefix_cache=True``, needs paging): a radix index
(``serving.prefix``) maps complete prompt pages to physical pages.  An
admitted request maps the longest cached prefix read-only and prefills
only its suffix (``models.model.prefill_suffix``); its complete prompt
pages join the index.  Under pool pressure the index LRU-evicts unpinned
prefixes before the scavenger path fires.  Shared pages bill once,
amortized over their holders.

**Token-budgeted chunked prefill** (``max_batch_tokens``, needs paging
and the fused loop): each iteration spends one token budget on decode
lanes first, then on prefill *chunks* of admitted prompts (QOS rank, then
shortest remaining): the head chunk runs in the same Python call as the
decode lanes (``prefill_chunk``, its lines written line by line, then
``decode_n``), the rest of the budget in standalone chunks.  A partial
prefill holds exactly the pages its written lines need, bills them chunk
by chunk, and is preemptible at chunk boundaries.

**Speculative decoding** (``speculate=k``, needs paging and the fused
loop): per live lane a draft source (``serving.spec``: prompt-lookup
n-grams, or a small draft model with its own dense cache) proposes up to
k tokens, one ``verify_tokens`` call scores them all, and the host
accepts the longest agreeing run (greedy) or rejection-samples
(temperature), replaying ``decode_n``'s stop walk.  Greedy output equals
plain decoding.

**Tracing** (``tracer``): request root spans with SUBMIT/ADMIT/
first_token/PREEMPT/RESUME/STARVED/FINISH events, PREFILL spans, one
DECODE span per slot residency and a span per decode or verify call,
plus the SLO series (``monitoring.trace``); the admission controller
adds the QUEUED spans.

**Tensor parallelism** (``mesh``, a ``launch.mesh.Mesh`` whose ``model``
axis has ``tp`` ranks): every rank runs this engine on the same requests
(``serving.tp.launch``); the plan (``serving.tp.plan_tp``) shards the
attention heads and the FFN hidden dim, each rank keeps its slice of the
weights and a KV cache of ``K/tp`` heads, and the model's two reduction
points all-reduce f32 partials.  Page ids stay one host-side space
(``pool_view`` has one budget vector entry a shard).  The ranks stay in
lockstep: the ledger's wall clock is rank 0's, and every decode call
first compares a hash of its plan across the ranks.

The KV cache is written in place (``index_put_``) where the JAX engine
threads a new cache through donated programs; every write below happens
in the order the JAX programs compute them (a chunk reads the pool
before its own lines and the decode lanes' are written; verify writes
its lines before reading).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.actshard import tp_reduce_scope
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import Mesh
from repro_torch.models.model import (
    DecodeGraphs, cast_for_compute, compute_dtype, decode_n, decode_step,
    init_cache, prefill, prefill_chunk, prefill_suffix, sample_tokens,
    verify_tokens,
)
from repro_torch.models.paging import (
    NULL_PAGE, PageAllocator, PagedKVConfig, ShardedAllocatorView,
    TwoLevelPageTable, pages_for,
)
from repro_torch.monitoring import MetricsRegistry, Tracer
from repro_torch.monitoring.trace import SPANS, SpanScope, span_scope
from repro_torch.monitoring.metrics import (
    METRIC_SERVE_KV_PAGES_IN_USE, METRIC_SERVE_PREEMPTIONS,
    METRIC_SERVE_PREFIX_EVICTIONS, METRIC_SERVE_PREFIX_HITS,
    METRIC_SERVE_PREFIX_MISSES, METRIC_SERVE_PREFIX_REUSED_TOKENS,
    METRIC_SERVE_SSM_STATE_BYTES,
    METRIC_SERVE_TENANT_ADMITTED, METRIC_SERVE_TENANT_TOKENS,
    METRIC_SPEC_ACCEPT_RATE, METRIC_SPEC_ACCEPTED, METRIC_SPEC_PROPOSED,
)
from repro_torch.serving.admission import (
    SERVING_TRES_WEIGHTS, AdmissionController,
)
from repro_torch.serving.prefix import PrefixCache
from repro_torch.serving.spec import (
    ModelDraftSource, NgramDraftSource, draft_config, rejection_sample,
)
from repro_torch.serving.tp import (
    LockstepClock, check_lockstep, plan_tp, shard_params,
)

@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (P,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    temperature: float = 0.0           # 0 => greedy
    tenant: str = "default"            # account in the shared ledger
    qos: str = "normal"                # service tier (see repro_torch.policy.qos)
    user: str = ""                     # optional tenant/user leaf association
    # filled by the engine
    output: list = field(default_factory=list)
    done: bool = False
    preemptions: int = 0               # times evicted mid-decode
    _seq: int = field(default=0, repr=False)   # admission arrival order
    _slot: int = field(default=-1, repr=False)  # current decode slot (-1 = none)
    _est_pages: int = field(default=0, repr=False)  # paged: worst-case pages
    # budgeted mode bills TRUE holdings, grown chunk by chunk, instead of
    # the classic worst-case reservation
    _held_pages: int = field(default=0, repr=False)
    # lifecycle tracing (populated only when the engine has a tracer)
    _trace: dict = field(default_factory=dict, repr=False)  # open spans
    _t_submit: Optional[float] = field(default=None, repr=False)
    _t_admit: Optional[float] = field(default=None, repr=False)
    _t_last: Optional[float] = field(default=None, repr=False)  # last token


@dataclass
class _PartialPrefill:
    """An admitted request whose prompt is not fully prefilled yet.  It
    owns a decode slot (so eviction and requeue ride the existing paths)
    but its decode lane stays frozen — its page-table row is all null
    until promotion — while ``pos_filled`` advances one chunk at a time."""
    req: Request
    toks: np.ndarray                    # full resume/prefill token sequence
    slot: int
    pos_filled: int = 0                 # prompt lines already in the pool
    pages: list = field(default_factory=list)   # pages covering pos_filled
    n_shared: int = 0                   # leading prefix-cache pages
    chunks: int = 0                     # chunks run so far
    span: object = None                 # open PREFILL trace span


@dataclass
class _ChunkPlan:
    """One planned prefill chunk: bucketed tokens plus the per-line page
    write targets."""
    part: _PartialPrefill
    bucket: int                         # padded chunk length (power of two)
    real: int                           # real tokens in the chunk
    start: int                          # == part.pos_filled at plan time
    tokens: np.ndarray                  # (bucket,) int32, zero-padded
    row: np.ndarray                     # (pages_per_seq,) page-table row
    pages: np.ndarray                   # (real,) target page of each line
    offs: np.ndarray                    # (real,) offset in that page


class DecodeEngine:
    def __init__(self, cfg: ModelConfig, params, num_slots: int = 8,
                 cache_len: int = 1024, run: Optional[RunConfig] = None,
                 metrics: Optional[MetricsRegistry] = None, seed: int = 0,
                 admission: Optional[AdmissionController] = None,
                 decode_chunk: int = 1, fused: bool = True,
                 prefill_buckets: Union[None, str, Sequence[int]] = None,
                 kv_page_size: int = 0,
                 kv_pages: Optional[int] = None,
                 prefix_cache: bool = False,
                 max_batch_tokens: Optional[int] = None,
                 tracer: Optional[Tracer] = None,
                 speculate: int = 0,
                 spec_source: str = "ngram",
                 draft_model: Optional[ModelConfig] = None,
                 index_generated: Optional[bool] = None,
                 mesh=None,
                 device=None):
        # ---- tensor parallelism (mesh=None -> one shard, nothing
        # changes).  Resolved first: the device, the weights, the cache
        # and the pool view depend on the plan
        if mesh is not None and not isinstance(mesh, Mesh):
            raise NotImplementedError(
                f"DecodeEngine(mesh={type(mesh).__name__}): the port serves "
                "tensor-parallel from one process a shard — pass this "
                "rank's repro_torch.launch.mesh.Mesh (serving.tp.launch "
                "builds it); one process driving a grid of devices is not "
                "implemented")
        self.mesh = mesh
        self.tp = plan_tp(cfg, mesh)
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"DecodeEngine: device {device} is not "
                                 f"this rank's mesh device {mesh.device}")
            device = mesh.device
            if mesh.rank == 0:
                for note in self.tp.notices:
                    print(f"[serve] tp: {note}")
        #: ranks running this engine side by side, kept in lockstep
        self._lockstep = mesh is not None and self.tp.tp > 1
        #: all-reduces issued by the model calls, by reduction point
        self.tp_counts = {"attn_out": 0, "mlp_out": 0}
        self.device = resolve_device(device)
        self.cfg = cfg
        # the serving entry points run attention through the kernels
        self.run = run or RunConfig(use_kernels=True)
        self.params = cast_for_compute(params, compute_dtype(cfg))
        if self.tp.active:
            # this rank's slice of the attention heads and of d_ff; the
            # embedding, LM head and norms stay whole, so every rank
            # computes full logits
            self.params = shard_params(self.params, cfg, self.tp,
                                       mesh.coords[1])
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.metrics = metrics or MetricsRegistry()
        self.admission = admission if admission is not None \
            else AdmissionController()
        # request-lifecycle tracer (opt-in; None = nothing recorded).  The
        # admission controller writes QUEUED spans into the same tracer
        # unless it already has its own.
        self.tracer = tracer
        if tracer is not None and self.admission.tracer is None:
            self.admission.tracer = tracer
        #: rank 0's clock, broadcast each step, when the ledger decays on
        #: a wall clock: the ranks' own clocks could order a fair-share
        #: near-tie differently
        self._clock = None
        tree = self.admission.tree
        if self._lockstep and tree._clock is not None:
            self._clock = LockstepClock(tree._clock, mesh.cpu_group,
                                        src=mesh.model_ranks()[0])
            tree.enable_wallclock_decay(self._clock)   # one epoch for all
        self.decode_chunk = max(1, int(decode_chunk))
        self.fused = fused
        self.paging = self._resolve_paging(kv_page_size, kv_pages)
        if self.paging is not None:
            # one page bills like the lines it holds, keeping fair-share
            # comparable across page sizes and with dense engines on the
            # same ledger; setdefault so an operator-set weight wins
            w = self.admission.tree.tres_weights
            w.setdefault("gres/kv_page", self.paging.page_size *
                         w.get("gres/kv_token",
                               SERVING_TRES_WEIGHTS["gres/kv_token"]))
            self.allocator = PageAllocator(self.paging.num_pages)
            # one logical page id = one page slice per shard (TP shards
            # the pool along kv heads); the router's per-replica page
            # gauge and tp_stats read the per-shard vectors
            self.pool_view = ShardedAllocatorView(
                self.allocator,
                shards=self.tp.tp if self.tp.shard_attn else 1)
            # two-level (directory, leaf) page map: host memory scales
            # with pages actually mapped, not slots * pages_per_seq
            self._ptab = TwoLevelPageTable(num_slots,
                                           self.paging.pages_per_seq)
            #: dispatch-width bucket of the page table (grows
            #: monotonically in powers of two)
            self._table_width = 1
            self._slot_pages: list[list[int]] = [[] for _ in
                                                 range(num_slots)]
        self.prefix: Optional[PrefixCache] = None
        if prefix_cache:
            if self.paging is None:
                raise ValueError(
                    "prefix_cache=True needs the paged KV cache: pass "
                    "kv_page_size > 0 (CLI: --prefix-cache implies "
                    "--kv-paging)")
            if cfg.ssm is not None:
                raise ValueError(
                    f"prefix_cache=True: cfg.ssm={cfg.ssm!r} — a shared "
                    "prefix would need the SSM state at its last page, "
                    "which the engine does not keep")
            self.prefix = PrefixCache(self.allocator, self.paging.page_size)
            # live holders per physical page, for amortized residency
            # billing (a page shared by h requests bills 1/h to each)
            self._page_holders: dict[int, int] = {}
            # radix tie-break: when fair-share priorities tie exactly,
            # admission prefers the head whose prompt hits the index.  A
            # controller the caller pre-wired keeps its own probe.
            if self.admission.radix_probe is None:
                self.admission.radix_probe = (
                    lambda r: bool(self.prefix.match(
                        self._resume_tokens(r))))
        self.cache = init_cache(
            cfg, num_slots, cache_len, device=self.device,
            paging=self.paging,
            kv_heads=(cfg.num_kv_heads // self.tp.tp if self.tp.shard_attn
                      else None))
        #: the cache's SSM sublayers (per-slot ``state`` and ``conv``
        #: rows, in the dense and the paged layout alike)
        self._ssm_layers = [c for c in self.cache["layers"] if "state" in c]
        if self._ssm_layers:
            self.metrics.gauge(
                METRIC_SERVE_SSM_STATE_BYTES,
                "SSM state and conv bytes held").set(sum(
                    t.numel() * t.element_size()
                    for c in self._ssm_layers for t in c.values()))
        self.slots: list[Optional[Request]] = [None] * num_slots
        self.pos = np.zeros(num_slots, np.int64)       # next position per slot
        self.last_tok = np.zeros(num_slots, np.int32)
        self.remaining = np.zeros(num_slots, np.int64)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        #: the fused path's CUDA graphs of the token step (used where
        #: ``models.model.graph_eligible`` allows: on the card, outside a
        #: tensor-parallel scope)
        self.graphs = DecodeGraphs(self.metrics)
        self._buckets = self._resolve_buckets(prefill_buckets)
        #: bucket lengths prefilled so far (the JAX engine's per-bucket
        #: compilations; eager PyTorch compiles nothing)
        self.prefill_lengths: set = set()
        # ---- token-budgeted serve step (empty in classic mode, so the
        # shared eviction and step paths need no mode guards) ----
        self._partials: list[_PartialPrefill] = []
        self._prefill_slots: dict[int, _PartialPrefill] = {}
        #: per-iteration counters of the budgeted serve step
        self.serve_stats = {"iterations": 0, "decode_tokens": 0,
                            "prefill_tokens": 0, "prefill_chunks": 0}
        #: chunk bucket lengths run so far (the JAX engine's chunk
        #: programs)
        self.chunk_lengths: set = set()
        self.max_batch_tokens: Optional[int] = None
        if max_batch_tokens is not None:
            if self.paging is None:
                raise ValueError(
                    "max_batch_tokens: chunked prefill needs the paged KV "
                    "cache — a partial prefill holds ceil(pos_filled/page) "
                    "pages, which the dense per-slot layout cannot "
                    "express.  Pass kv_page_size > 0 (CLI: "
                    "--max-batch-tokens implies --kv-paging)")
            if not fused:
                raise ValueError(
                    "max_batch_tokens: the token-budgeted serve step runs "
                    "decode lanes and prefill chunks together, which needs "
                    "fused=True (the per-token host loop has no budgeted "
                    "form)")
            if cfg.ssm is not None:
                raise ValueError(
                    f"max_batch_tokens: cfg.ssm={cfg.ssm!r} — a prefill "
                    "chunk reads the prompt's earlier lines from the pool, "
                    "and an SSM sublayer has no lines to read")
            self.max_batch_tokens = int(max_batch_tokens)
            assert self.max_batch_tokens >= 1, max_batch_tokens
            b, buckets = 1, []
            while b <= self.max_batch_tokens:
                buckets.append(b)
                b *= 2
            # ascending: _plan_chunk picks the smallest bucket covering
            # the remaining prompt that still fits the budget
            self.chunk_buckets = tuple(buckets)
        # ---- speculative decoding ----
        self.speculate = int(speculate)
        self.spec = None
        #: per-round speculation counters (rounds = verify calls; accepted
        #: counts draft tokens the target agreed with)
        self.spec_stats = {"rounds": 0, "proposed": 0, "accepted": 0,
                           "emitted": 0, "proposed_by": {}}
        # rejection sampling draws from numpy, as the JAX engine does
        self._spec_rng = np.random.default_rng(seed)
        if self.speculate:
            if self.paging is None:
                raise ValueError(
                    "speculate: draft-and-verify writes each proposal's "
                    "KV line through per-line (page, offset) targets and "
                    "relies on rejected lines dying on the null page — "
                    "pass kv_page_size > 0 (CLI: --speculate implies "
                    "--kv-paging)")
            if not fused:
                raise ValueError(
                    "speculate: verification is one batched call over the "
                    "fused decode lanes, which needs fused=True")
            if cfg.ssm is not None:
                raise ValueError(
                    f"speculate: cfg.ssm={cfg.ssm!r} — a rejected draft "
                    "would have to roll the SSM state back, which the "
                    "engine does not keep")
            if spec_source == "model":
                dcfg = draft_model if draft_model is not None \
                    else draft_config(cfg)
                self.spec = ModelDraftSource(dcfg, num_slots, cache_len,
                                             seed=seed, run=self.run,
                                             device=self.device)
            elif spec_source == "ngram":
                self.spec = NgramDraftSource()
            else:
                raise ValueError(f"unknown spec_source {spec_source!r} "
                                 "(expected 'ngram' or 'model')")
        #: index finished requests' complete generated-token pages into
        #: the radix trie; on by default exactly when speculation can mine
        #: them
        if index_generated is None:
            index_generated = bool(self.speculate) \
                and self.prefix is not None
        self.index_generated = bool(index_generated)

    def _resolve_paging(self, kv_page_size: int,
                        kv_pages: Optional[int]) -> Optional[PagedKVConfig]:
        """Paged layout, or None (dense default).  Paging needs attention
        sublayers and no sliding-window ring; in a hybrid the attention
        sublayers' lines live in the pool and each SSM sublayer's state
        and conv window in per-slot tensors (``models.model.init_cache``).
        ``kv_pages`` overrides the pool size; the default matches the
        dense budget (num_slots * cache_len lines) plus the null page."""
        if not kv_page_size:
            return None
        # name the offending config field: "full-attention only" alone
        # sends operators hunting through the whole ModelConfig
        if self.cfg.attn_every == 0:
            raise ValueError(
                "kv_page_size: paged KV cache needs attention sublayers, "
                f"but cfg.ssm={self.cfg.ssm!r} with attn_every=0 has none "
                "— SSM recurrent state is not line-addressable, so it "
                "cannot be paged")
        if self.cfg.attn_every != 1 and self.cfg.ssm is None:
            raise ValueError(
                "kv_page_size: paged KV cache needs every sublayer's "
                f"state to have a layout, but cfg.attn_every="
                f"{self.cfg.attn_every} interleaves non-attention "
                "sublayers and cfg.ssm is None")
        if self.cfg.sliding_window is not None:
            raise ValueError(
                "kv_page_size: paged KV cache does not support "
                f"cfg.sliding_window={self.cfg.sliding_window} — the "
                "windowed ring cache's wrapped slot layout has no "
                "page-table equivalent yet")
        assert self.cache_len % kv_page_size == 0, \
            (self.cache_len, kv_page_size)
        if kv_pages is not None:
            assert kv_pages >= 2, "pool needs the null page + 1 usable page"
            return PagedKVConfig(page_size=kv_page_size, num_pages=kv_pages,
                                 pages_per_seq=self.cache_len // kv_page_size)
        return PagedKVConfig.for_budget(self.num_slots * self.cache_len,
                                        kv_page_size, self.cache_len)

    # -------------------------------------------------------- page table ----
    def _dispatch_table(self) -> np.ndarray:
        """The page table a decode or verify call sees.  Budgeted mode
        keeps the full ``pages_per_seq`` width, as the JAX engine does;
        classic paged mode buckets the width to a monotonically growing
        power of two covering every live mapping, so short requests
        gather small tables."""
        if self.max_batch_tokens is not None:
            return self._ptab.dense()
        w = max(self._ptab.max_width(), 1)
        while self._table_width < w:
            self._table_width *= 2
        self._table_width = min(self._table_width,
                                self.paging.pages_per_seq)
        return self._ptab.dense(self._table_width)

    def _resolve_buckets(self, spec):
        """Power-of-two prompt-length buckets, or None (exact-length
        prefill).  Full-attention configs pad the prompt TAIL (causal
        masking keeps pads out of real state).  SSM and hybrid configs
        pad the FRONT instead (``models.model.prefill``'s front-pad
        mode): the pad lands at a chunk-aligned offset whose masked
        positions are the SSD scan's identity.  Refused (exact prefill)
        for sliding-window ring caches (the wrapped slot layout has no pad
        region), and for SSM and hybrid configs under sinusoidal
        embeddings (added before the front shift is known) or
        ``run.use_kernels`` (the flash kernel takes no validity mask) —
        the JAX engine's rule for ``run.use_pallas``."""
        self._front_pad = False
        if not spec:
            return None
        if self.cfg.sliding_window is not None:
            return None
        if not (self.cfg.attn_every == 1 and self.cfg.ssm is None):
            if self.cfg.pos_embedding == "sinusoidal" or \
                    self.run.use_kernels:
                return None
            self._front_pad = True
        if spec == "auto":
            out, b = [], 32
            while b < self.cache_len:
                out.append(b)
                b *= 2
            out.append(self.cache_len)
            return tuple(out)
        out = tuple(sorted({int(b) for b in spec}))
        assert out and 0 < out[0] and out[-1] <= self.cache_len, out
        if out[-1] < self.cache_len:       # any resume prompt must fit
            out = out + (self.cache_len,)
        return out

    @property
    def prefill_buckets(self):
        return self._buckets

    def tp_stats(self) -> dict:
        """Tensor-parallel shard stats behind ``sdiag``'s TP section: the
        resolved plan, per-shard page-pool occupancy, and the cross-shard
        reductions one decode token pays."""
        plan = self.tp
        out = {"tp": plan.tp,
               "active": plan.active,
               "plan": plan.describe(self.cfg),
               "devices": [str(d) for d in plan.devices()],
               "notices": list(plan.notices),
               "psums_per_token": plan.psums_per_token(self.cfg)}
        if self.paging is not None:
            out["kv_pages_in_use"] = [
                int(n) for n in self.pool_view.in_use_vector()]
            out["kv_pages_total"] = self.paging.usable_pages
        return out

    def tp_scope(self):
        """The reduction scope of this engine's model calls: the ``model``
        axis's all-reduces where the plan shards, counted into
        ``tp_counts``; nothing for a one-shard engine."""
        if not self.tp.active:
            return contextlib.nullcontext()
        return tp_reduce_scope(self.mesh.group("model"), self.tp.shard_attn,
                               self.tp.shard_mlp, counts=self.tp_counts)

    def _check_lockstep(self, what: str, *extra):
        """Under TP, raise unless every rank is about to make the same
        call: slot -> request, positions, and ``extra`` (the tokens a lane
        and the page-table width)."""
        if self._lockstep:
            rids = tuple(-1 if r is None else r.rid for r in self.slots)
            check_lockstep(self.mesh.cpu_group, what,
                           (rids, tuple(int(p) for p in self.pos), *extra))

    def _update_pool_gauges(self):
        """Per-device ``serve_kv_pages_in_use`` gauges (one series per
        shard; a one-shard engine reports its device)."""
        if self.paging is None:
            return
        g = self.metrics.gauge(
            METRIC_SERVE_KV_PAGES_IN_USE,
            "KV pages with >= 1 holder, per device")
        devs = self.tp.devices() or [self.device]
        for k, n in enumerate(self.pool_view.in_use_vector()):
            dev = devs[k] if k < len(devs) else f"shard{k}"
            g.set(int(n), device=str(dev))

    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ----------------------------------------------------------- tracing ----
    @staticmethod
    def _trace_root(req: Request):
        trace = getattr(req, "_trace", None)
        return trace.get("root") if trace else None

    def _trace_decode_end(self, req: Request, reason: Optional[str] = None):
        """Close the request's current DECODE span (finish, preemption or
        page starvation); ``reason`` also lands as a root-span event."""
        tr = self.tracer
        if tr is None:
            return
        trace = getattr(req, "_trace", None)
        if not trace:
            return
        dec = trace.pop("decode", None)
        if dec is not None:
            tr.end(dec, tokens=len(req.output),
                   **({"stop": reason} if reason else {}))
        root = trace.get("root")
        if root is not None and reason:
            tr.event(reason, root)

    def _trace_first_decode(self, req: Request, slot: int, resume: bool,
                            now: float):
        """After a prefill that ended at ``now``: RESUME or first_token
        (with the TTFT sample) and the residency's DECODE span."""
        tr = self.tracer
        root = self._trace_root(req)
        if resume:
            if root is not None:
                tr.event("RESUME", root, slot=slot)
        else:
            # the first output token comes from the prefill's argmax, so
            # TTFT = admit -> the prefill's sync (a resume produced its
            # first token before the eviction)
            if root is not None:
                tr.event("first_token", root)
            if req._t_admit is not None:
                tr.slo.ttft(now - req._t_admit, req.tenant, req.qos)
        req._t_last = now
        req._trace["decode"] = tr.begin("DECODE", cat="decode", parent=root,
                                        slot=slot)

    # ------------------------------------------------------------ public ----
    def submit(self, req: Request):
        # generation past the cache boundary truncates in _maybe_finish,
        # which also guarantees a preemption victim's resume prefill
        # (prompt + partial output) still fits the cache
        assert len(req.prompt) < self.cache_len, "prompt exceeds cache"
        tr = self.tracer
        if tr is not None:
            req._t_submit = tr.clock()
            root = tr.begin(
                f"request {req.rid}", cat="request",
                track=(f"serving:{req.tenant}", f"req {req.rid}"),
                rid=req.rid, tenant=req.tenant, qos=req.qos,
                prompt_tokens=len(req.prompt),
                max_new_tokens=req.max_new_tokens)
            req._trace = {"root": root}
            tr.event("SUBMIT", root)
        if self.paging is not None:
            # worst-case page footprint, for GrpTRES kv_pages caps
            req._est_pages = pages_for(
                min(len(req.prompt) + req.max_new_tokens + 1,
                    self.cache_len), self.paging.page_size)
            # a footprint the pool can never hold would queue forever
            assert req._est_pages <= self.paging.usable_pages, \
                (f"request {req.rid}: needs {req._est_pages} pages, pool "
                 f"has {self.paging.usable_pages}")
        self.admission.submit(req)

    def active(self) -> int:
        """Requests currently holding a decode slot."""
        return sum(r is not None for r in self.slots)

    def pending(self) -> int:
        return self.admission.pending()

    def load(self) -> int:
        """Queue depth: slot holders plus queued requests — the router's
        spill signal and the autoscaler's emptiest-replica criterion."""
        return self.active() + self.pending()

    def radix_occupancy(self) -> dict:
        """Prefix-index occupancy for the router/sdiag surface: cached
        pages currently indexed and how many of them are evictable."""
        if self.prefix is None:
            return {"nodes": 0, "evictable_pages": 0}
        return {"nodes": self.prefix.nodes,
                "evictable_pages": self.prefix.evictable_pages()}

    def drain(self) -> list:
        """Evict everything and hand it back: each slot holder leaves
        through the preemption path (pages released, slot hold returned,
        partial output retained — mid-prefill partials included, since
        they hold their slot too), then every queued request is popped.
        Returns all of them in arrival order, ready to resubmit elsewhere;
        greedy decode is batch-independent, so a drained request goes on
        with the tokens an undisturbed run gives (up to rounding ties)."""
        for req in [r for r in self.slots if r is not None]:
            self._evict(req)
        drained = []
        for t in self.admission.tenants.values():
            drained.extend(t.queue)
            t.queue.clear()
        drained.sort(key=lambda r: r._seq)
        return drained

    @property
    def queue(self) -> list:
        """Flattened view of all tenant queues (compat/diagnostics)."""
        return [r for t in self.admission.tenants.values() for r in t.queue]

    def _capacity(self, slot: int) -> int:
        """KV lines slot may write before growing (paged) / cache_len."""
        if self.paging is None:
            return self.cache_len
        return len(self._slot_pages[slot]) * self.paging.page_size

    def _resume_tokens(self, req) -> np.ndarray:
        """The token sequence a (possibly resumed) request prefills:
        prompt plus retained partial output, minus the last token (which
        re-decodes)."""
        if req.output:
            return np.concatenate(
                [req.prompt, np.asarray(req.output[:-1], np.int32)])
        return np.asarray(req.prompt, np.int32)

    def _fits_pages(self, req) -> bool:
        """Page-budget admission predicate: the resume/prefill pages must
        fit the free pool right now (decode growth is handled later).
        With the prefix cache, matched pages cost nothing and evictable
        cached pages count as free — excluding the match itself, which
        placement pins before it evicts."""
        toks = self._resume_tokens(req)
        need = pages_for(len(toks), self.paging.page_size)
        budget = self.allocator.available()
        if self.prefix is not None and need > budget:
            matched = len(self.prefix.match(toks))
            need -= matched
            budget += max(self.prefix.evictable_pages() - matched, 0)
        return need <= budget

    def _free_slots(self):
        return [i for i, r in enumerate(self.slots) if r is None]

    def _admit(self) -> int:
        """Fill free slots from the admission controller; then let blocked
        high-QOS requests preempt one preemptable slot each.  In paged
        mode the pick is additionally gated on the prefill fitting the
        free page pool.  Returns how many requests were placed."""
        eligible = self._fits_pages if self.paging is not None else None
        placed = 0
        for slot in self._free_slots():
            req = self.admission.next_request(eligible=eligible)
            if req is None:
                return placed
            self._place(slot, req)
            placed += 1
        # QOS preemption: each blocked preempting request evicts exactly
        # one victim slot (bounded per pass against cyclic QOS tables)
        for _ in range(self.num_slots):
            running = [r for r in self.slots if r is not None]
            pick = self.admission.next_preempting(running)
            if pick is None:
                return placed
            req, victim = pick
            slot = self._evict(victim)
            self._place(slot, req)
            placed += 1
        return placed

    def _place(self, slot: int, req: Request):
        """Budgeted mode queues a partial prefill (chunked across
        iterations); classic mode prefills the whole prompt now."""
        if self.max_batch_tokens is not None:
            self._start_prefill(slot, req)
        else:
            self._prefill_into(slot, req)

    def _alloc_or_evict(self, need: int):
        """Allocate ``need`` pages, LRU-evicting unpinned cached prefixes
        when the free pool is short (the valve that fires before
        scavenger preemption)."""
        got = self.allocator.alloc(need)
        if got is None and self.prefix is not None:
            freed = self.prefix.evict(need - self.allocator.available())
            if freed:
                self.metrics.counter(
                    METRIC_SERVE_PREFIX_EVICTIONS,
                    "cached prefix pages LRU-evicted").inc(freed)
                got = self.allocator.alloc(need)
        return got

    def _add_holders(self, pages):
        if self.prefix is not None:
            for p in pages:
                self._page_holders[p] = self._page_holders.get(p, 0) + 1

    def _drop_holders(self, pages):
        if self.prefix is not None:
            for p in pages:
                h = self._page_holders.get(p, 0) - 1
                if h > 0:
                    self._page_holders[p] = h
                else:
                    self._page_holders.pop(p, None)

    def _count_prefix(self, n_shared: int):
        """Hit/miss counters of one placed admission."""
        if n_shared:
            self.metrics.counter(
                METRIC_SERVE_PREFIX_HITS,
                "admissions reusing cached prefix pages").inc()
            self.metrics.counter(
                METRIC_SERVE_PREFIX_REUSED_TOKENS,
                "prompt tokens served from cached pages").inc(
                n_shared * self.paging.page_size)
        else:
            self.metrics.counter(
                METRIC_SERVE_PREFIX_MISSES,
                "admissions with no cached prefix").inc()

    def _prefill_into(self, slot: int, req: Request):
        """Prefill a request into a free slot.  A preempted request
        resumes: its prompt *and* retained partial output are prefilled,
        so decode continues from exactly where the eviction stopped.

        Paged mode allocates exactly ``ceil(len(toks)/page_size)`` pages
        first (the bucketed pad tail allocates nothing) and bails back to
        the queue if the pool cannot hold the prefill.  With the prefix
        cache, the longest cached prefix maps read-only (one allocator
        ref per page), only the suffix allocates and prefills, and the
        request's complete prompt pages join the radix index."""
        toks = self._resume_tokens(req)
        tr = self.tracer
        root = self._trace_root(req)
        resume = bool(req.output)
        psp = None
        if tr is not None:
            if root is not None:
                tr.event("ADMIT", root, slot=slot)
            psp = tr.begin("PREFILL", cat="prefill", parent=root,
                           tokens=len(toks), resume=resume)
        shared, priv = [], None
        if self.paging is not None:
            ps = self.paging.page_size
            if self.prefix is not None:
                # acquire BEFORE the private alloc: matched pages are
                # unpinned until then, and the eviction below must not
                # free what we are about to map
                shared = self.prefix.acquire(self.prefix.match(toks)) or []
            priv = self._alloc_or_evict(pages_for(len(toks), ps)
                                        - len(shared))
            if priv is None and shared:
                # the shortfall may only be coverable by the matched pages
                # themselves: abandon the reuse (unpin, making the match
                # eviction fodder) and retry as a plain prefill
                self.allocator.free(shared)
                shared = []
                priv = self._alloc_or_evict(pages_for(len(toks), ps))
            if priv is None:
                # preemption admitted past the page gate but the pool
                # still can't hold the prefill: back to the queue
                if shared:
                    self.allocator.free(shared)
                if psp is not None:
                    tr.end(psp, aborted=True)
                self.admission.release(req)
                self.admission.requeue(req)
                return
            if self.prefix is not None:
                self._count_prefix(len(shared))
        sc = SPANS.get() if psp is not None else None
        with self.metrics.timer("serve_prefill_seconds", "prefill latency"):
            with torch.no_grad(), self.tp_scope(), \
                    (sc.under(psp) if sc is not None
                     else contextlib.nullcontext()):
                if shared:
                    logits, cache1, L = self._prefill_suffix(toks, shared)
                else:
                    P = len(toks)
                    L = P if self._buckets is None else next(
                        b for b in self._buckets if b >= P)
                    f, front = 0, {}
                    if self._front_pad:
                        # SSM/hybrid: pad the FRONT, at a chunk-aligned
                        # offset so the real tokens' SSD chunk boundaries
                        # match the unpadded run's
                        Q = self.cfg.ssm.chunk if self.cfg.ssm else 1
                        f = ((L - P) // Q) * Q
                        front = dict(front_pad=f, num_real=P)
                    padded = np.zeros(L, np.int32)
                    padded[f:f + P] = toks
                    logits, cache1 = prefill(
                        self.params, {"tokens": self._put(padded)[None]},
                        self.cfg, self.run,
                        cache_len=None if self.paging is not None
                        else self.cache_len,
                        last_pos=f + P - 1, **front)
                    self.prefill_lengths.add(L)
            # sync inside the timed region: the launches are asynchronous
            self._sync()
        if self.paging is not None:
            # the prefilled lines go into the private pages only (the
            # suffix on a prefix hit): shared pages are never written
            self._insert_pages(cache1, priv, slot)
            pages = shared + priv
            self._ptab.clear(slot)
            self._ptab.set_range(slot, 0, pages)
            self._slot_pages[slot] = pages
            if self.prefix is not None:
                # donate the complete prompt pages to the radix index (it
                # takes its own refs) and register this request as a
                # holder of everything it maps
                self.prefix.insert(toks, pages)
                self._add_holders(pages)
            # GrpTRES holds the request's WORST-CASE footprint for its
            # whole residency (SLURM-style reservation): decode growth
            # then cannot push a tenant past its kv_pages cap
            self.admission.adjust_pages(req, req._est_pages)
        else:
            self._insert_dense(cache1, slot)
        if resume:
            tok = int(req.output[-1])      # resume: last token re-decodes
        else:
            tok = int(torch.argmax(logits[0, -1]))
            req.output.append(tok)
        self.slots[slot] = req
        req._slot = slot
        self.pos[slot] = len(toks)
        self.last_tok[slot] = tok
        self.remaining[slot] = req.max_new_tokens - len(req.output)
        if self.spec is not None:
            # full context with the pending last token (resume-safe: toks
            # is prompt+output[:-1], tok the re-decoding last)
            self.spec.begin(slot, np.append(toks, np.int32(tok)))
        # the prefilled KV residency the tenant pays for: dense lines, or
        # (paged) the pages pinned, amortized over their holders
        if self.paging is not None:
            self.admission.charge(req, kv_pages=self._billed_pages(slot))
        else:
            self.admission.charge(req, kv_tokens=len(toks))
        self.metrics.counter("serve_requests_admitted").inc()
        self.metrics.counter(
            METRIC_SERVE_TENANT_ADMITTED,
            "admissions per tenant").inc(tenant=req.tenant)
        if tr is not None:
            attrs = {"bucket": int(L)}
            if self.paging is not None:
                attrs.update(prefix_pages=len(shared),
                             pages_allocated=len(priv))
            now = tr.clock()
            tr.end(psp, ts=now, **attrs)
            self._trace_first_decode(req, slot, resume, now)
        self._maybe_finish(slot)

    def _prefill_suffix(self, toks: np.ndarray, shared: list):
        """Prefix hit: prefill only the suffix, attending to the shared
        pages through a prefix-only page-table row whose width buckets to
        the next power of two >= the match depth, so the gather scales
        with the actual prefix, not cache_len.  Returns (logits, suffix
        lines, suffix bucket)."""
        ps = self.paging.page_size
        n_shared = len(shared)
        start = n_shared * ps
        suffix = toks[start:]
        P = len(suffix)
        L = P if self._buckets is None else next(
            b for b in self._buckets if b >= P)
        padded = np.zeros(L, np.int32)
        padded[:P] = suffix
        pb = 1
        while pb < n_shared:
            pb *= 2
        row = np.full(pb, NULL_PAGE, np.int32)
        row[:n_shared] = shared
        logits, cache1 = prefill_suffix(
            self.params, {"tokens": self._put(padded)[None]}, self.cache,
            self._put(row)[None], start, self.cfg, self.run,
            last_pos=P - 1)
        return logits, cache1, L

    def _insert_dense(self, cache1, slot: int):
        """Write a prefilled slice into the slot's row, in place: an
        attention sublayer's lines (G, 1, n, K, Dh) into lines ``[0,
        n)`` (lines past n keep stale contents, masked at decode until
        overwritten), an SSM sublayer's ``state`` and ``conv`` rows
        whole."""
        for dst, src in zip(self.cache["layers"], cache1["layers"]):
            for name, leaf in src.items():
                n = leaf.shape[2]
                dst[name][:, slot, :n].copy_(leaf[:, 0])

    def _insert_pages(self, cache1, pages: list, slot: int):
        """Write a prefilled slice's lines into ``pages`` (whole pages from
        the slice's first line), in place.  Only the given pages are
        written: the bucketed pad lines past them belong to no page.  An
        SSM sublayer's ``state`` and ``conv`` go into the slot's rows."""
        ps = self.paging.page_size
        n = len(pages)
        idx = torch.tensor(pages, dtype=torch.int64, device=self.device)
        for dst, src in zip(self.cache["layers"], cache1["layers"]):
            if "state" in src:
                for name, leaf in src.items():
                    dst[name][:, slot].copy_(leaf[:, 0])
                continue
            if n == 0:
                continue
            for name in ("k", "v"):
                lines = src[name][:, 0]                  # (G, L, K, Dh)
                g, length = lines.shape[:2]
                if n * ps > length:
                    lines = torch.nn.functional.pad(
                        lines, (0, 0, 0, 0, 0, n * ps - length))
                lines = lines[:, :n * ps].reshape(g, n, ps,
                                                  *lines.shape[2:])
                dst[name][:, idx] = lines.to(dst[name].dtype)

    def _hold_pages(self, req: Request, delta: int):
        """Budgeted mode: move the request's GrpTRES kv_pages hold by
        ``delta`` (true holdings, chunk by chunk).  No-op in classic mode,
        where ``_prefill_into`` reserves ``_est_pages`` up front."""
        if self.max_batch_tokens is None or delta == 0:
            return
        self.admission.adjust_pages(req, delta)
        req._held_pages += delta

    def _billed_pages(self, slot: int) -> float:
        """KV-page residency this slot bills per step: each page costs
        ``1 / holders``, so a prefix page shared by N live requests bills
        once across them (without the prefix cache: the page count)."""
        if self.prefix is None:
            return len(self._slot_pages[slot])
        return sum(1.0 / self._page_holders[p]
                   for p in self._slot_pages[slot])

    def _release_pages(self, slot: int, req: Request):
        """Paged mode: drop the slot's page references (private pages
        return to the pool; shared prefix pages survive in the index) and
        return the GrpTRES hold."""
        if self.paging is None:
            return
        pages = self._slot_pages[slot]
        if pages:
            self.allocator.free(pages)
            self._drop_holders(pages)
        if self.max_batch_tokens is not None:
            self.admission.adjust_pages(req, -req._held_pages)
            req._held_pages = 0
        else:
            self.admission.adjust_pages(req, -req._est_pages)
        self._slot_pages[slot] = []
        self._ptab.clear(slot)

    def _vacate(self, victim: Request) -> int:
        """Shared eviction bookkeeping: clear the slot, free its pages,
        return the slot/page holds, and requeue the request with partial
        output retained.  Returns the freed slot index."""
        slot = victim._slot
        assert slot >= 0 and self.slots[slot] is victim, (slot, victim.rid)
        if self.spec is not None:
            self.spec.release(slot)
        self.slots[slot] = None
        victim._slot = -1
        self._release_pages(slot, victim)
        self.admission.release(victim)
        self.admission.requeue(victim)
        return slot

    def _evict(self, victim: Request) -> int:
        """Evict a running request from its slot; it requeues at the head
        of its QOS class in its tenant queue with partial output kept.  A
        mid-prefill partial lands at a chunk boundary: its pages free and
        the resume prefill replays the prompt."""
        victim.preemptions += 1
        self.metrics.counter(
            METRIC_SERVE_PREEMPTIONS, "evicted decode slots").inc()
        part = self._prefill_slots.get(victim._slot)
        if part is not None and part.req is victim:
            slot = victim._slot
            self._requeue_partial(part, "PREEMPT")
            return slot
        self._trace_decode_end(victim, "PREEMPT")
        return self._vacate(victim)

    def _finish(self, slot: int):
        req = self.slots[slot]
        req.done = True
        if self.spec is not None or self.index_generated:
            seq = np.concatenate([np.asarray(req.prompt, np.int32),
                                  np.asarray(req.output, np.int32)])
            if self.spec is not None:
                self.spec.release(slot)
                self.spec.observe(seq)
            if self.index_generated and self.prefix is not None:
                # KV lines exist for every token but the last, so index
                # seq[:-1]; pages past the prompt carry generated tokens
                self.prefix.insert(seq[:-1], self._slot_pages[slot],
                                   generated_from=len(req.prompt))
        self.slots[slot] = None
        req._slot = -1
        self._release_pages(slot, req)
        self.admission.release(req)
        self.metrics.counter("serve_requests_completed").inc()
        tr = self.tracer
        if tr is not None:
            self._trace_decode_end(req)
            root = req._trace.pop("root", None) if req._trace else None
            if root is not None:
                tr.event("FINISH", root)
                tr.end(root, tokens=len(req.output))
            if req._t_submit is not None:
                tr.slo.e2e(tr.clock() - req._t_submit, req.tenant, req.qos)

    def _maybe_finish(self, slot: int):
        req = self.slots[slot]
        if req is None:
            return
        if (req.eos_id is not None and req.output
                and req.output[-1] == req.eos_id) or self.remaining[slot] <= 0 \
                or self.pos[slot] >= self.cache_len - 1:
            self._finish(slot)

    # ------------------------------------------------------- page growth ----
    def _reclaim_one_victim(self, requester: Request) -> bool:
        """Pool-exhaustion scavenger reclaim: evict ONE running request
        the requester's QOS may preempt (the victim rule admission
        preemption uses).  Returns whether a victim was evicted."""
        qos = self.admission.qos_table.get(requester.qos)
        if qos is None:
            return False
        victims = [r for r in self.slots
                   if r is not None and r is not requester
                   and qos.can_preempt(r.qos)]
        if not victims:
            return False
        self._evict(self.admission.pick_victim(victims))
        return True

    def _requeue_starved(self, slot: int):
        """A slot the pool starved out goes back to its tenant queue with
        partial output retained (resume-exact, like a preemption victim)."""
        self._trace_decode_end(self.slots[slot], "STARVED")
        self._vacate(self.slots[slot])
        self.metrics.counter(
            "serve_page_starvations",
            "slots requeued on page-pool exhaustion").inc()

    def _ensure_pages(self, active: list, steps: Optional[int] = None):
        """Grow each live slot's allocation to cover the coming ``steps``
        tokens (default: the decode chunk).  The +2 headroom keeps the
        slot's freeze boundary strictly beyond the chunk, so a fully-grown
        paged slot freezes exactly where the dense cache would.  Pressure
        relief in order: LRU-evict cached prefixes, then reclaim one
        scavenger victim; a slot that still cannot cover its current
        position requeues starved."""
        ps = self.paging.page_size
        steps_cap = self.decode_chunk if steps is None else steps
        for i in list(active):
            req = self.slots[i]
            if req is None:                    # evicted by a reclaim below
                active.remove(i)
                continue
            # a nearly-finished slot only needs pages for the tokens it
            # may still generate
            steps_i = min(steps_cap, max(int(self.remaining[i]), 1))
            target = min(int(self.pos[i]) + steps_i + 2, self.cache_len)
            need = pages_for(target, ps) - len(self._slot_pages[i])
            if need <= 0:
                continue
            got = self._alloc_or_evict(need)
            if got is None and self._reclaim_one_victim(req):
                got = self._alloc_or_evict(need)
            if got is None:                    # partial growth: best effort
                got = self.allocator.alloc(
                    min(need, self.allocator.available()))
            if got:
                self._add_holders(got)
                # classic mode reserved the worst case at admission (a
                # no-op there); budgeted mode grows the true hold
                self._hold_pages(req, len(got))
                n0 = len(self._slot_pages[i])
                self._slot_pages[i].extend(got)
                self._ptab.set_range(i, n0, got)
            if self._capacity(i) <= int(self.pos[i]):
                # starved: not even the current token's page
                self._requeue_starved(i)
                active.remove(i)

    # --------------------------------------- chunked prefill (budgeted) ----
    def _start_prefill(self, slot: int, req: Request):
        """Admit a request as a partial prefill: it takes the slot (so the
        eviction and requeue paths see it) but decodes nothing until its
        whole prompt has gone through chunks.  With the prefix cache,
        matched pages map read-only at once and ``pos_filled`` starts past
        them."""
        toks = self._resume_tokens(req)
        tr = self.tracer
        root = self._trace_root(req)
        span = None
        if tr is not None:
            if root is not None:
                tr.event("ADMIT", root, slot=slot)
            span = tr.begin("PREFILL", cat="prefill", parent=root,
                            tokens=len(toks), resume=bool(req.output),
                            chunked=True)
        shared = []
        if self.prefix is not None:
            # reuse is decided (and counted) at admission: chunks allocate
            # one bucket's worth at a time, so the all-or-nothing shortfall
            # that makes the classic path abandon a match cannot arise
            shared = self.prefix.acquire(self.prefix.match(toks)) or []
            self._count_prefix(len(shared))
            self._add_holders(shared)
        self.slots[slot] = req
        req._slot = slot
        self.pos[slot] = 0
        self.last_tok[slot] = 0
        self.remaining[slot] = 0       # frozen until promotion
        part = _PartialPrefill(
            req=req, toks=toks, slot=slot,
            pos_filled=len(shared) * self.paging.page_size,
            pages=list(shared), n_shared=len(shared), span=span)
        self._hold_pages(req, len(shared))
        self._partials.append(part)
        self._prefill_slots[slot] = part

    def _pack_order(self) -> list:
        """Chunk-packing order: QOS rank first, then shortest remaining
        prefill, then arrival — a short interactive prompt finishes in
        one chunk even when a long batch prompt arrived first."""
        qos_t = self.admission.qos_table

        def rank(part):
            q = qos_t.get(part.req.qos)
            prio = q.priority if q is not None else 0
            return (-prio, len(part.toks) - part.pos_filled,
                    part.req._seq)

        return sorted(self._partials, key=rank)

    def _plan_chunk(self, part: _PartialPrefill, budget: int,
                    min_bucket: int = 1) -> Optional[_ChunkPlan]:
        """Pick the next chunk's bucket, grow the partial's pages to cover
        it, and lay out the per-line write targets.  Returns None when no
        bucket fits the budget, or when the pool starves the partial back
        to its tenant queue.  ``min_bucket`` declines chunks that neither
        reach that size nor finish the prompt."""
        rem = len(part.toks) - part.pos_filled
        assert rem > 0, (part.req.rid, part.pos_filled)
        bucket = 0
        for b in self.chunk_buckets:
            if b > budget:
                break
            bucket = b
            if b >= rem:                # smallest bucket covering the rest
                break
        if bucket == 0 or (bucket < min_bucket and bucket < rem):
            return None
        real = min(rem, bucket)
        start = part.pos_filled
        ps = self.paging.page_size
        need = pages_for(start + real, ps) - len(part.pages)
        if need > 0:
            got = self._alloc_or_evict(need)
            if got is None and self._reclaim_one_victim(part.req):
                got = self._alloc_or_evict(need)
            if got is None:
                # pool exhausted mid-prefill: starve the partial back to
                # the queue (page-budget admission re-admits it later)
                self._requeue_partial(part, "STARVED")
                self.metrics.counter(
                    "serve_page_starvations",
                    "slots requeued on page-pool exhaustion").inc()
                return None
            self._add_holders(got)
            part.pages.extend(got)
            self._hold_pages(part.req, len(got))
        row = np.full(self.paging.pages_per_seq, NULL_PAGE, np.int32)
        row[:len(part.pages)] = part.pages
        tokens = np.zeros(bucket, np.int32)
        tokens[:real] = part.toks[start:start + real]
        lines = np.arange(start, start + real)
        pages = np.asarray(part.pages, np.int32)[lines // ps]
        offs = (lines % ps).astype(np.int32)
        return _ChunkPlan(part=part, bucket=bucket, real=real, start=start,
                          tokens=tokens, row=row, pages=pages, offs=offs)

    def _run_chunk(self, plan: _ChunkPlan):
        """One prefill chunk: attend to the lines already in the pool,
        then write the chunk's real lines at their (page, offset) targets
        — line by line, since a chunk may start and end mid-page.  The
        pad lines of the bucket are not written at all.  Returns the last
        real token's logits."""
        self.chunk_lengths.add(plan.bucket)
        with torch.no_grad(), self.tp_scope():
            logits, slices = prefill_chunk(
                self.params, {"tokens": self._put(plan.tokens)[None]},
                self.cache, self._put(plan.row)[None], plan.start, self.cfg,
                self.run, last_pos=plan.real - 1)
            pages = self._put(plan.pages.astype(np.int64))
            offs = self._put(plan.offs.astype(np.int64))
            for dst, src in zip(self.cache["layers"], slices["layers"]):
                for name in ("k", "v"):
                    lines = src[name][:, 0, :plan.real]     # (G, real, K, Dh)
                    dst[name][:, pages, offs] = lines.to(dst[name].dtype)
        return logits

    def _dispatch_chunk(self, plan: _ChunkPlan):
        """Standalone chunk call (no decode lanes to run beside).  Not
        synced: a non-final chunk's outputs feed only its own line writes,
        so the host keeps planning while the device works; the promotion
        argmax syncs the final chunk.  The prefill histogram therefore
        times submission here; the PREFILL span holds admit -> promotion."""
        with self.metrics.timer("serve_prefill_seconds", "prefill latency"):
            return self._run_chunk(plan)

    def _finish_chunk(self, plan: _ChunkPlan, logits):
        """Advance the partial past a chunk that ran; the final chunk
        promotes the request to a live decode lane."""
        part = plan.part
        part.pos_filled = plan.start + plan.real
        part.chunks += 1
        self.serve_stats["prefill_tokens"] += plan.real
        self.serve_stats["prefill_chunks"] += 1
        if part.pos_filled >= len(part.toks):
            self._partials.remove(part)
            self._promote(part, logits)

    def _promote(self, part: _PartialPrefill, logits):
        """Last chunk done: unfreeze the slot into a decode lane.  Its
        first output token is the final chunk's last-position argmax —
        the whole-prompt prefill's."""
        req, slot = part.req, part.slot
        tr = self.tracer
        if part.span is not None:
            tr.end(part.span, ts=tr.clock(), chunks=part.chunks,
                   pos_filled=part.pos_filled, prefix_pages=part.n_shared,
                   pages_allocated=len(part.pages) - part.n_shared)
        self._ptab.clear(slot)
        self._ptab.set_range(slot, 0, part.pages)
        self._slot_pages[slot] = part.pages
        if self.prefix is not None:
            # donate the complete prompt pages to the radix index; holder
            # refs were registered page by page as the chunks grew
            self.prefix.insert(part.toks, part.pages)
        resume = bool(req.output)
        if resume:
            tok = int(req.output[-1])      # resume: last token re-decodes
        else:
            tok = int(torch.argmax(logits[0, -1]))
            req.output.append(tok)
        self.pos[slot] = len(part.toks)
        self.last_tok[slot] = tok
        self.remaining[slot] = req.max_new_tokens - len(req.output)
        if self.spec is not None:
            self.spec.begin(slot, np.append(part.toks, np.int32(tok)))
        self.admission.charge(req, kv_pages=self._billed_pages(slot))
        self.metrics.counter("serve_requests_admitted").inc()
        self.metrics.counter(
            METRIC_SERVE_TENANT_ADMITTED,
            "admissions per tenant").inc(tenant=req.tenant)
        if tr is not None:
            self._trace_first_decode(req, slot, resume, tr.clock())
        del self._prefill_slots[slot]
        self._maybe_finish(slot)

    def _requeue_partial(self, part: _PartialPrefill, reason: str):
        """Abort a mid-prefill partial at a chunk boundary (preemption or
        page starvation): free its pages, return its holdings, clear the
        slot and requeue — the resume prefill replays prompt + retained
        output exactly like a decode victim's."""
        req, slot = part.req, part.slot
        tr = self.tracer
        if part.span is not None:
            tr.end(part.span, aborted=True, chunks=part.chunks,
                   pos_filled=part.pos_filled)
        root = self._trace_root(req)
        if tr is not None and root is not None:
            tr.event(reason, root)
        if part.pages:
            self.allocator.free(part.pages)
            self._drop_holders(part.pages)
        self._hold_pages(req, -req._held_pages)
        self.slots[slot] = None
        req._slot = -1
        self._slot_pages[slot] = []
        self._ptab.clear(slot)
        self._partials.remove(part)
        del self._prefill_slots[slot]
        self.admission.release(req)
        self.admission.requeue(req)

    def _decode_active(self) -> list:
        """Slots with a live decode lane (occupied, not mid-prefill)."""
        return [i for i, r in enumerate(self.slots)
                if r is not None and i not in self._prefill_slots]

    def _step_budgeted(self) -> int:
        """One token-budgeted iteration: decode lanes claim budget first
        (``decode_chunk`` tokens each, dropping to 1 when that alone would
        exceed the budget; k+1 under speculation), then prefill chunks
        pack into the rest — the head chunk in the same call as the decode
        lanes, any leftover budget through standalone chunks."""
        st = self.serve_stats
        st["iterations"] += 1
        T = self.max_batch_tokens
        decode_active = self._decode_active()
        d = self.decode_chunk
        spec = self.speculate > 0
        lane = (self.speculate + 1) if spec else d
        if (self._partials and decode_active
                and lane * len(decode_active) > T):
            d, spec, lane = 1, False, 1
        if decode_active:
            self._ensure_pages(decode_active, steps=lane)
            decode_active = self._decode_active()
        budget = T
        head_plan = None
        if self._partials and decode_active:
            budget -= lane * len(decode_active)
            for part in self._pack_order():
                if budget < 1:
                    break
                if self._prefill_slots.get(part.slot) is not part:
                    continue            # starved away by an earlier plan
                head_plan = self._plan_chunk(part, budget)
                if head_plan is not None:
                    budget -= head_plan.bucket
                    break
            # planning may have reclaim-evicted a decode slot
            decode_active = self._decode_active()
        if decode_active:
            if spec:
                total, chunk_out = self._step_spec(decode_active,
                                                   chunk_plan=head_plan)
                st["decode_tokens"] += total
                if head_plan is not None:
                    self._finish_chunk(head_plan, chunk_out)
            elif head_plan is not None and d == self.decode_chunk:
                total, chunk_out = self._step_fused(
                    decode_active, num_tokens=d, chunk_plan=head_plan)
                st["decode_tokens"] += total
                self._finish_chunk(head_plan, chunk_out)
            else:
                # the chunk runs first, then the 1-token decode; the chunk
                # finishes after it — promotion before the decode would
                # unfreeze a lane the decode call treats as done
                c_logits = (self._dispatch_chunk(head_plan)
                            if head_plan is not None else None)
                total, _ = self._step_fused(decode_active, num_tokens=d)
                st["decode_tokens"] += total
                if head_plan is not None:
                    self._finish_chunk(head_plan, c_logits)
        elif head_plan is not None:
            # the planned chunk's decode companions vanished (reclaimed)
            self._finish_chunk(head_plan, self._dispatch_chunk(head_plan))
        # drain the remaining budget with standalone chunks (declining
        # runt chunks that don't finish a prompt)
        min_bucket = max(1, self.chunk_buckets[-1] // 4)
        while budget >= 1 and self._partials:
            progressed = False
            for part in self._pack_order():
                if budget < 1:
                    break
                if self._prefill_slots.get(part.slot) is not part:
                    continue
                plan = self._plan_chunk(part, budget,
                                        min_bucket=min_bucket)
                if plan is None:
                    continue
                self._finish_chunk(plan, self._dispatch_chunk(plan))
                budget -= plan.bucket
                progressed = True
            if not progressed:
                break
        return self.load()

    # -------------------------------------------------------------- step ----
    def step(self) -> int:
        """Admit + one batched decode call (``decode_chunk`` tokens per
        slot on the fused path, one on the host loop, a verify round under
        speculation; the budgeted iteration with ``max_batch_tokens``).
        Returns #active + #queued.

        Traced, the call is a ``step`` span with children ``admit``
        (device-timed; the PREFILL spans run inside it), ``pages`` and,
        on the fused path, ``decode_chunk`` (``stage``, ``launch``,
        ``wait``) and ``book``; ``launch`` says whether the chunk
        replayed graphs (``graphed``, ``replayed`` token steps), in which
        case the model opens no spans under it."""
        if self._clock is not None:
            self._clock.tick()
        tr = self.tracer
        if tr is None:
            return self._step(None)
        with span_scope(tr, self.device, "step", cat="step",
                        track=("serving:engine", "step")) as sc:
            try:
                return self._step(sc)
            finally:
                # the chunk's .cpu() wait has synchronized: read the
                # step's device times and re-anchor
                tr.sync_point(self.device)

    def _step(self, sc: Optional[SpanScope]) -> int:
        if sc is None:
            self._admit()
        else:
            with sc.span("admit", "step") as sp:
                sp.attrs["admitted"] = self._admit()
        pages = sc.begin("pages", "step", timed=False) \
            if sc is not None else None
        self._update_pool_gauges()
        if self.max_batch_tokens is not None:
            if pages is not None:
                sc.end(pages)
            return self._step_budgeted()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if self.paging is not None and active:
            # a speculative round may advance a lane by up to k+1 and falls
            # back to the plain fused chunk when no lane has drafts: grow
            # pages for whichever runs
            self._ensure_pages(
                active, steps=(max(self.decode_chunk, self.speculate + 1)
                               if self.speculate else None))
            # growth may have evicted/requeued slots at ANY index (a
            # reclaim victim can precede its requester) — rebuild
            active = [i for i, r in enumerate(self.slots) if r is not None]
        if pages is not None:
            sc.end(pages)
        if not active:
            return self.admission.pending()
        if self.speculate:
            self._step_spec(active)
        elif self.fused:
            self._step_fused(active)
        else:
            self._step_host(active)
        return self.load()

    def _lane_vectors(self):
        """(done, eos, temps) per slot; mid-prefill slots count as done."""
        done = np.array([self.slots[i] is None or i in self._prefill_slots
                         for i in range(self.num_slots)])
        eos = np.array([
            (r.eos_id if r is not None and r.eos_id is not None else -1)
            for r in self.slots], np.int32)
        temps = np.array([(r.temperature if r else 0.0)
                          for r in self.slots], np.float32)
        return done, eos, temps

    def _book_tokens(self, charges, tenant_tokens, total):
        """Bill a call's tokens (``charges`` None: already charged one by
        one) and count them, per tenant too."""
        if charges is not None:
            self.admission.charge_bulk(charges)
        self.metrics.counter("serve_tokens_generated").inc(total)
        tok_counter = self.metrics.counter(
            METRIC_SERVE_TENANT_TOKENS, "generated tokens per tenant")
        for tenant, n in tenant_tokens.items():
            tok_counter.inc(n, tenant=tenant)

    def _stop(self, i: int, req: Request):
        """A lane froze: a real stop finishes the request; a freeze at
        the allocation boundary (partial growth ran out of pages) requeues
        it starved."""
        hit_eos = (req.eos_id is not None and req.output
                   and req.output[-1] == req.eos_id)
        if (self.paging is not None and not hit_eos
                and self.remaining[i] > 0
                and self._capacity(i) < self.cache_len):
            self._requeue_starved(i)
        else:
            self._finish(i)

    def _step_fused(self, active: list, num_tokens: Optional[int] = None,
                    chunk_plan: Optional[_ChunkPlan] = None):
        """One device-resident chunk: one call, one host sync.

        Budgeted mode passes ``num_tokens`` (tokens per lane this
        iteration) and optionally ``chunk_plan`` — a prefill chunk run
        first in the same call: it reads the pool before its own lines and
        the lanes' are written, and its pages are disjoint from the
        lanes'.  Returns ``(generated_tokens, chunk_logits_or_None)``."""
        n = self.decode_chunk if num_tokens is None else num_tokens
        tr = self.tracer
        sc = SPANS.get() if tr is not None else None
        csp = None
        if tr is not None:
            # the batch's make-up: lanes (``active``), token steps, the
            # lines the lanes hold at the start, the longest, and (below)
            # the page table's width
            ctx = [int(self.pos[i]) for i in active]
            csp = tr.begin(
                "decode_chunk", cat="engine",
                track=("serving:engine", "dispatch"),
                parent=sc.stack[-1] if sc is not None else None,
                active=len(active), decode_tokens=n,
                live_lines=sum(ctx), max_context=max(ctx, default=0),
                table_width=0)
        part = sc.under(csp) if sc is not None else contextlib.nullcontext()
        with part, torch.no_grad(), self.tp_scope():
            stage = sc.begin("stage", "step", timed=False) \
                if sc is not None else None
            done, eos, temps = self._lane_vectors()
            page_table = limit = None
            if self.paging is not None:
                limit = self._put(np.array([
                    self._capacity(i) if self.slots[i] is not None
                    else self.cache_len
                    for i in range(self.num_slots)], np.int32))
                page_table = self._put(self._dispatch_table())
                if csp is not None:
                    csp.attrs["table_width"] = int(page_table.shape[1])
            self._check_lockstep(
                "decode", n,
                None if page_table is None else page_table.shape[1],
                None if chunk_plan is None else (chunk_plan.part.req.rid,
                                                 chunk_plan.start))
            lanes = [self._put(a) for a in (
                self.last_tok, self.pos.astype(np.int32),
                self.remaining.astype(np.int32), done, eos, temps)]
            if stage is not None:
                sc.end(stage)
            t0 = time.perf_counter()
            launch = sc.begin("launch", "step") if sc is not None else None
            chunk_out = None
            if chunk_plan is not None:
                chunk_out = self._run_chunk(chunk_plan)
            toks, self.cache, token, pos, remaining, done_d = decode_n(
                self.params, self.cache, *lanes, self._gen, self.cfg,
                self.run, n, self.cache_len,
                page_table=page_table, limit=limit, graphs=self.graphs)
            if launch is not None:
                # a graphed chunk has no layer spans: no Python runs a layer
                sc.end(launch, graphed=self.graphs.replayed > 0,
                       replayed=self.graphs.replayed)
                wait = sc.begin("wait", "step", timed=False)
            # ONE sync per chunk: everything below is host-side numpy
            toks, pos, token, remaining, done_d = (
                t.cpu().numpy() for t in (toks, pos, token, remaining,
                                          done_d))
            if launch is not None:
                sc.end(wait)
        self.metrics.histogram("serve_decode_seconds",
                               "batched decode-step latency").observe(
            time.perf_counter() - t0)
        ts_sync = tr.clock() if tr is not None else 0.0
        # the JAX engine's decode_chunk ends at the sync: booking follows
        book = sc.begin("book", "step", timed=False) \
            if sc is not None else None
        charges = []
        tenant_tokens: dict[str, int] = {}
        total = 0
        for i in active:
            req = self.slots[i]
            n_gen = int(pos[i]) - int(self.pos[i])
            if n_gen:
                req.output.extend(int(t) for t in toks[i, :n_gen])
                if self.paging is not None:
                    # paged rent: pages pinned (amortized) x steps
                    charges.append(
                        (req, n_gen, 0, self._billed_pages(i) * n_gen))
                else:
                    # per-chunk charge: n tokens + KV-line rent summed over
                    # the chunk's steps (sum_{j=1..n} pos0+j)
                    kv = n_gen * int(self.pos[i]) + n_gen * (n_gen + 1) // 2
                    charges.append((req, n_gen, kv))
                tenant_tokens[req.tenant] = \
                    tenant_tokens.get(req.tenant, 0) + n_gen
                total += n_gen
                if tr is not None and req._t_last is not None:
                    # one host sync per chunk: spread the chunk's wall
                    # time evenly over its tokens (token-weighted)
                    tr.slo.itl((ts_sync - req._t_last) / n_gen,
                               req.tenant, req.qos, n=n_gen)
            if tr is not None:
                req._t_last = ts_sync
            self.pos[i] = pos[i]
            self.last_tok[i] = token[i]
            self.remaining[i] = remaining[i]
            if self.spec is not None and n_gen:
                # keep draft contexts in sync when this chunk ran as the
                # empty-draft fallback of the speculative step
                self.spec.advance(i, toks[i, :n_gen].astype(np.int32))
            if done_d[i]:
                self._stop(i, req)
        if csp is not None:
            tr.end(csp, ts=ts_sync, tokens=total)
        self._book_tokens(charges, tenant_tokens, total)
        if book is not None:
            sc.end(book)
        return total, chunk_out

    def _step_spec(self, active: list,
                   chunk_plan: Optional[_ChunkPlan] = None):
        """One speculative draft-and-verify round (paged + fused only).

        Per live lane the draft source proposes up to ``speculate``
        tokens; one ``verify_tokens`` call scores ``last_tok`` plus all
        drafts, then the host accepts the longest agreeing run under
        greedy — or rejection-samples under temperature — and replays
        ``decode_n``'s stop walk over the emitted run (EOS / budget /
        allocation boundary).  Rejected proposals' KV lines are dead on
        arrival: ``pos`` only advances past accepted lines, and the next
        round overwrites them before any query reads past its position.
        With no draft in any lane, falls back to the plain fused chunk
        (1-token lanes in budgeted mode).  Returns ``(generated_tokens,
        chunk_logits_or_None)`` like ``_step_fused``."""
        k = self.speculate
        S = k + 1
        ps = self.paging.page_size
        drafts: dict[int, np.ndarray] = {}
        kinds: dict[int, str] = {}
        for i in active:
            d = np.asarray(self.spec.draft(i, k), np.int32).ravel()[:k]
            kinds[i] = getattr(self.spec, "last_kind", self.spec.kind)
            # drop drafts the lane has no room to verify: every used
            # verify row must read only lines inside the allocation
            room = self._capacity(i) - 1 - int(self.pos[i])
            if len(d) > room:
                d = d[:max(room, 0)]
            drafts[i] = d
        if chunk_plan is None and all(len(drafts[i]) == 0 for i in active):
            if self.max_batch_tokens is not None:
                return self._step_fused(active, num_tokens=1)
            return self._step_fused(active)
        st = self.spec_stats
        proposed = sum(len(drafts[i]) for i in active)
        tokens = np.zeros((self.num_slots, S), np.int32)
        pos0 = np.zeros(self.num_slots, np.int64)
        pages = np.full((self.num_slots, S), NULL_PAGE, np.int64)
        offs = np.zeros((self.num_slots, S), np.int64)
        for i in active:
            p0 = int(self.pos[i])
            di = drafts[i]
            tokens[i, 0] = self.last_tok[i]
            tokens[i, 1:1 + len(di)] = di
            pos0[i] = p0
            sp = self._slot_pages[i]
            cap = len(sp) * ps
            for j in range(S):
                if p0 + j < cap:
                    pages[i, j] = sp[(p0 + j) // ps]
                    offs[i, j] = (p0 + j) % ps
            # columns past the allocation (and every column of frozen /
            # empty / mid-prefill lanes) write the null page
        any_temp = any(self.slots[i].temperature > 0 for i in active)
        table = self._dispatch_table()
        self._check_lockstep(
            "verify", tuple(tuple(int(t) for t in drafts[i]) for i in active),
            table.shape[1],
            None if chunk_plan is None else (chunk_plan.part.req.rid,
                                             chunk_plan.start))
        tr = self.tracer
        csp = tr.begin("SPECULATE", cat="engine",
                       track=("serving:engine", "dispatch"),
                       active=len(active), k=k,
                       proposed=proposed) if tr is not None else None
        t0 = time.perf_counter()
        chunk_out = None
        if chunk_plan is not None:
            # the chunk first: it reads the pool before verify writes
            chunk_out = self._run_chunk(chunk_plan)
        with torch.no_grad(), self.tp_scope():
            logits, self.cache = verify_tokens(
                self.params, self.cache, self._put(tokens), self._put(pos0),
                self._put(pages), self._put(offs), self._put(table),
                self.cfg, self.run)
            # ONE host sync per round; the logits come over only under
            # temperature (greedy needs just the argmax)
            greedy = torch.argmax(logits, dim=-1).cpu().numpy()
            logits_np = (logits.float().cpu().numpy() if any_temp
                         else None)
        self.metrics.histogram("serve_decode_seconds",
                               "batched decode-step latency").observe(
            time.perf_counter() - t0)
        ts_sync = tr.clock() if tr is not None else 0.0
        charges = []
        tenant_tokens: dict[str, int] = {}
        total = 0
        accepted_total = 0
        for i in active:
            req = self.slots[i]
            di = drafts[i]
            nd = len(di)
            if req.temperature > 0:
                t = max(req.temperature, 1e-4)
                rows = logits_np[i, :nd + 1] / t
                rows = rows - rows.max(axis=-1, keepdims=True)
                p = np.exp(rows)
                p /= p.sum(axis=-1, keepdims=True)
                cand = rejection_sample(self._spec_rng, p, di)
            else:
                tg = greedy[i]
                m = 0
                while m < nd and tg[m] == di[m]:
                    m += 1
                cand = tg[:m + 1]
            accepted_total += len(cand) - 1
            st["proposed_by"][kinds[i]] = \
                st["proposed_by"].get(kinds[i], 0) + nd
            # decode_n's stop walk, host-side: emit the token, then freeze
            # on EOS / remaining / allocation boundary
            boundary = self._capacity(i) - 1
            p0 = int(self.pos[i])
            rem = int(self.remaining[i])
            emitted = []
            stopped = False
            for tkn in cand:
                emitted.append(int(tkn))
                rem -= 1
                if ((req.eos_id is not None
                     and emitted[-1] == req.eos_id) or rem <= 0
                        or p0 + len(emitted) >= boundary):
                    stopped = True
                    break
            n_gen = len(emitted)
            req.output.extend(emitted)
            charges.append(
                (req, n_gen, 0, self._billed_pages(i) * n_gen))
            tenant_tokens[req.tenant] = \
                tenant_tokens.get(req.tenant, 0) + n_gen
            total += n_gen
            if tr is not None:
                if req._t_last is not None:
                    tr.slo.itl((ts_sync - req._t_last) / n_gen,
                               req.tenant, req.qos, n=n_gen)
                req._t_last = ts_sync
            self.pos[i] = p0 + n_gen
            self.last_tok[i] = emitted[-1]
            self.remaining[i] = rem
            self.spec.advance(i, np.asarray(emitted, np.int32))
            if n_gen == k + 1 and hasattr(self.spec, "set_pending"):
                # fully accepted round: the model draft's k-step loop never
                # wrote draft k-1's own KV line — catch up later
                self.spec.set_pending(i, int(di[k - 1]))
            if stopped:
                self._stop(i, req)
        if csp is not None:
            tr.end(csp, ts=ts_sync, tokens=total, accepted=accepted_total)
        self._book_tokens(charges, tenant_tokens, total)
        st["rounds"] += 1
        st["proposed"] += proposed
        st["accepted"] += accepted_total
        st["emitted"] += total
        self.metrics.counter(
            METRIC_SPEC_PROPOSED, "draft tokens proposed").inc(proposed)
        self.metrics.counter(
            METRIC_SPEC_ACCEPTED,
            "draft tokens accepted by the target").inc(accepted_total)
        if st["proposed"]:
            self.metrics.gauge(
                METRIC_SPEC_ACCEPT_RATE,
                "running draft acceptance rate").set(
                st["accepted"] / st["proposed"])
        return total, chunk_out

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """Host-loop sampling (fused=False): logits (num_slots, V).  The
        generator advances on every call, greedy or not — the stream
        ``decode_n`` draws from, so host and fused paths stay
        interchangeable when greedy and sampled slots mix."""
        temps = np.array([
            (self.slots[i].temperature if self.slots[i] else 0.0)
            for i in range(self.num_slots)], np.float32)
        nxt = sample_tokens(self._gen, logits, self._put(temps))
        return nxt.cpu().numpy().astype(np.int32)

    def _step_host(self, active: list):
        """The per-token host loop (fused=False): one ``decode_step``, one
        host sample, per-token ledger charges."""
        table = (self._dispatch_table() if self.paging is not None
                 else None)
        self._check_lockstep("decode", 1,
                             None if table is None else table.shape[1])
        t0 = time.perf_counter()
        with torch.no_grad(), self.tp_scope():
            logits, self.cache = decode_step(
                self.params, self.cache, self._put(self.last_tok[:, None]),
                self._put(self.pos.astype(np.int32)), self.cfg, self.run,
                page_table=None if table is None else self._put(table))
            nxt = self._sample(logits[:, 0])
        self.metrics.histogram("serve_decode_seconds",
                               "batched decode-step latency").observe(
            time.perf_counter() - t0)
        tr = self.tracer
        ts_sync = tr.clock() if tr is not None else 0.0
        tenant_tokens: dict[str, int] = {}
        for i in active:
            req = self.slots[i]
            req.output.append(int(nxt[i]))
            if tr is not None:
                if req._t_last is not None:
                    tr.slo.itl(ts_sync - req._t_last, req.tenant, req.qos)
                req._t_last = ts_sync
            self.pos[i] += 1
            self.last_tok[i] = nxt[i]
            self.remaining[i] -= 1
            # one generated token + rent on the KV residency this slot
            # holds (dense lines, or the pages pinned)
            if self.paging is not None:
                self.admission.charge(req, tokens=1,
                                      kv_pages=self._billed_pages(i))
            else:
                self.admission.charge(req, tokens=1,
                                      kv_tokens=int(self.pos[i]))
            tenant_tokens[req.tenant] = tenant_tokens.get(req.tenant, 0) + 1
            self._maybe_finish(i)
        self._book_tokens(None, tenant_tokens, len(active))

    def run_to_completion(self, max_steps: int = 10_000):
        for _ in range(max_steps):
            if self.step() == 0:
                break
