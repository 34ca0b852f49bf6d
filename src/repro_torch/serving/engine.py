"""Batched decode engine, classic mode — the port of the JAX package's
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
and fair-share picks happen at chunk boundaries.

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
slot requeues with its output kept.

The JAX engine's prefix cache, token-budgeted chunked prefill,
speculative decoding, tensor parallelism, tracer and per-token host loop
come with later slices of the port: asking for them raises
``NotImplementedError``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import (
    compute_dtype, decode_n, init_cache, prefill,
)
from repro_torch.models.paging import (
    PageAllocator, PagedKVConfig, TwoLevelPageTable, pages_for,
)
from repro_torch.monitoring import MetricsRegistry
from repro_torch.monitoring.metrics import (
    METRIC_SERVE_KV_PAGES_IN_USE, METRIC_SERVE_PREEMPTIONS,
    METRIC_SERVE_TENANT_ADMITTED, METRIC_SERVE_TENANT_TOKENS,
)
from repro_torch.serving.admission import (
    SERVING_TRES_WEIGHTS, AdmissionController,
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


def _not_in_this_slice(option: str, slice_: str):
    raise NotImplementedError(
        f"DecodeEngine({option}): {slice_} is not ported yet — the port "
        "serves classic mode (dense or paged cache, bucketed prefill, "
        "fused decode chunks)")


def cast_for_compute(params, dtype: torch.dtype):
    """Cast every weight that the model casts to the compute dtype at use
    (matrices, embeddings, biases) once, up front — the same numbers as
    casting at every use.  Norm scales stay in their storage dtype: the
    model reads them in f32."""
    if isinstance(params, dict):
        return {k: (v if k == "scale" else cast_for_compute(v, dtype))
                for k, v in params.items()}
    if isinstance(params, list):
        return [cast_for_compute(v, dtype) for v in params]
    return params.to(dtype)


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
                 tracer=None,
                 speculate: int = 0,
                 mesh=None,
                 device=None):
        if prefix_cache:
            _not_in_this_slice("prefix_cache=True",
                               "the radix prefix cache (ROADMAP A1.1)")
        if max_batch_tokens is not None:
            _not_in_this_slice("max_batch_tokens", "token-budgeted "
                               "chunked prefill (ROADMAP A1.2)")
        if speculate:
            _not_in_this_slice("speculate",
                               "speculative decoding (ROADMAP A1.3)")
        if tracer is not None:
            _not_in_this_slice("tracer",
                               "request-lifecycle tracing (ROADMAP A1)")
        if not fused:
            _not_in_this_slice("fused=False",
                               "the per-token host loop (ROADMAP A1)")
        if mesh is not None:
            _not_in_this_slice("mesh",
                               "tensor-parallel serving (ROADMAP A4)")
        self.device = resolve_device(device)
        self.cfg = cfg
        # the serving entry points run attention through the kernels
        self.run = run or RunConfig(use_kernels=True)
        self.params = cast_for_compute(params, compute_dtype(cfg))
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.metrics = metrics or MetricsRegistry()
        self.admission = admission if admission is not None \
            else AdmissionController()
        self.decode_chunk = max(1, int(decode_chunk))
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
            # two-level (directory, leaf) page map: host memory scales
            # with pages actually mapped, not slots * pages_per_seq
            self._ptab = TwoLevelPageTable(num_slots,
                                           self.paging.pages_per_seq)
            #: dispatch-width bucket of the page table (grows
            #: monotonically in powers of two)
            self._table_width = 1
            self._slot_pages: list[list[int]] = [[] for _ in
                                                 range(num_slots)]
        self.cache = init_cache(cfg, num_slots, cache_len,
                                device=self.device, paging=self.paging)
        self.slots: list[Optional[Request]] = [None] * num_slots
        self.pos = np.zeros(num_slots, np.int64)       # next position per slot
        self.last_tok = np.zeros(num_slots, np.int32)
        self.remaining = np.zeros(num_slots, np.int64)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._buckets = self._resolve_buckets(prefill_buckets)
        #: bucket lengths prefilled so far (the JAX engine's per-bucket
        #: compilations; eager PyTorch compiles nothing)
        self.prefill_lengths: set = set()

    def _resolve_paging(self, kv_page_size: int,
                        kv_pages: Optional[int]) -> Optional[PagedKVConfig]:
        """Paged layout, or None (dense default).  Paging needs full
        attention and no sliding-window ring.  ``kv_pages`` overrides the
        pool size; the default matches the dense budget (num_slots *
        cache_len lines) plus the null page."""
        if not kv_page_size:
            return None
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
        """The page table a decode call sees: its width buckets to a
        monotonically-growing power of two covering every live mapping,
        so short requests gather small tables."""
        w = max(self._ptab.max_width(), 1)
        while self._table_width < w:
            self._table_width *= 2
        self._table_width = min(self._table_width,
                                self.paging.pages_per_seq)
        return self._ptab.dense(self._table_width)

    def _resolve_buckets(self, spec):
        """Power-of-two prompt-length buckets, or None (exact-length
        prefill).  Full-attention configs pad the prompt tail; refused
        (exact prefill) for sliding-window ring caches, whose wrapped
        slot layout has no pad region."""
        if not spec:
            return None
        if self.cfg.sliding_window is not None:
            return None
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

    def _update_pool_gauges(self):
        if self.paging is None:
            return
        self.metrics.gauge(
            METRIC_SERVE_KV_PAGES_IN_USE,
            "KV pages with >= 1 holder, per device").set(
                int(self.allocator.in_use), device=str(self.device))

    # ------------------------------------------------------------ public ----
    def submit(self, req: Request):
        # generation past the cache boundary truncates in _maybe_finish,
        # which also guarantees a preemption victim's resume prefill
        # (prompt + partial output) still fits the cache
        assert len(req.prompt) < self.cache_len, "prompt exceeds cache"
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
        fit the free pool right now (decode growth is handled later)."""
        need = pages_for(len(self._resume_tokens(req)),
                         self.paging.page_size)
        return need <= self.allocator.available()

    def _free_slots(self):
        return [i for i, r in enumerate(self.slots) if r is None]

    def _admit(self):
        """Fill free slots from the admission controller; then let blocked
        high-QOS requests preempt one preemptable slot each.  In paged
        mode the pick is additionally gated on the prefill fitting the
        free page pool."""
        eligible = self._fits_pages if self.paging is not None else None
        for slot in self._free_slots():
            req = self.admission.next_request(eligible=eligible)
            if req is None:
                return
            self._prefill_into(slot, req)
        # QOS preemption: each blocked preempting request evicts exactly
        # one victim slot (bounded per pass against cyclic QOS tables)
        for _ in range(self.num_slots):
            running = [r for r in self.slots if r is not None]
            pick = self.admission.next_preempting(running)
            if pick is None:
                return
            req, victim = pick
            slot = self._evict(victim)
            self._prefill_into(slot, req)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prefill_into(self, slot: int, req: Request):
        """Prefill a request into a free slot.  A preempted request
        resumes: its prompt *and* retained partial output are prefilled,
        so decode continues from exactly where the eviction stopped.

        Paged mode allocates exactly ``ceil(len(toks)/page_size)`` pages
        first (the bucketed pad tail allocates nothing) and bails back to
        the queue if the pool cannot hold the prefill."""
        toks = self._resume_tokens(req)
        priv = None
        if self.paging is not None:
            priv = self.allocator.alloc(
                pages_for(len(toks), self.paging.page_size))
            if priv is None:
                # preemption admitted past the page gate but the pool
                # still can't hold the prefill: back to the queue
                self.admission.release(req)
                self.admission.requeue(req)
                return
        P = len(toks)
        L = P if self._buckets is None else next(
            b for b in self._buckets if b >= P)
        padded = np.zeros(L, np.int32)
        padded[:P] = toks
        tokens = torch.from_numpy(padded).to(self.device)[None]
        with self.metrics.timer("serve_prefill_seconds", "prefill latency"):
            with torch.no_grad():
                logits, cache1 = prefill(
                    self.params, {"tokens": tokens}, self.cfg, self.run,
                    cache_len=None if self.paging is not None
                    else self.cache_len,
                    last_pos=P - 1)
            # sync inside the timed region: the launches are asynchronous
            self._sync()
        self.prefill_lengths.add(L)
        if self.paging is not None:
            self._insert_pages(cache1, priv)
            self._ptab.clear(slot)
            self._ptab.set_range(slot, 0, priv)
            self._slot_pages[slot] = priv
            # GrpTRES holds the request's WORST-CASE footprint for its
            # whole residency (SLURM-style reservation): decode growth
            # then cannot push a tenant past its kv_pages cap
            self.admission.adjust_pages(req, req._est_pages)
        else:
            self._insert_dense(cache1, slot)
        if req.output:
            tok = int(req.output[-1])      # resume: last token re-decodes
        else:
            tok = int(torch.argmax(logits[0, -1]))
            req.output.append(tok)
        self.slots[slot] = req
        req._slot = slot
        self.pos[slot] = len(toks)
        self.last_tok[slot] = tok
        self.remaining[slot] = req.max_new_tokens - len(req.output)
        # the prefilled KV residency the tenant pays for: dense lines, or
        # (paged) the pages actually pinned
        if self.paging is not None:
            self.admission.charge(req, kv_pages=len(self._slot_pages[slot]))
        else:
            self.admission.charge(req, kv_tokens=len(toks))
        self.metrics.counter("serve_requests_admitted").inc()
        self.metrics.counter(
            METRIC_SERVE_TENANT_ADMITTED,
            "admissions per tenant").inc(tenant=req.tenant)
        self._maybe_finish(slot)

    def _insert_dense(self, cache1, slot: int):
        """Write a prefilled slice (G, 1, n, K, Dh) per layer into the
        slot's row, in place.  Lines past n keep stale contents, masked
        at decode until overwritten."""
        for dst, src in zip(self.cache["layers"], cache1["layers"]):
            for name in ("k", "v"):
                n = src[name].shape[2]
                dst[name][:, slot, :n].copy_(src[name][:, 0])

    def _insert_pages(self, cache1, pages: list):
        """Scatter a prefilled slice's lines into the request's pages, in
        place.  Only the allocated pages are written: the bucketed pad
        lines past them belong to no page."""
        ps = self.paging.page_size
        n = len(pages)
        idx = torch.tensor(pages, dtype=torch.int64, device=self.device)
        for dst, src in zip(self.cache["layers"], cache1["layers"]):
            for name in ("k", "v"):
                lines = src[name][:, 0]                  # (G, L, K, Dh)
                g, length = lines.shape[:2]
                if n * ps > length:
                    lines = torch.nn.functional.pad(
                        lines, (0, 0, 0, 0, 0, n * ps - length))
                lines = lines[:, :n * ps].reshape(g, n, ps,
                                                  *lines.shape[2:])
                dst[name][:, idx] = lines.to(dst[name].dtype)

    def _release_pages(self, slot: int, req: Request):
        """Paged mode: return the slot's pages to the pool and the
        worst-case GrpTRES hold."""
        if self.paging is None:
            return
        pages = self._slot_pages[slot]
        if pages:
            self.allocator.free(pages)
        self.admission.adjust_pages(req, -req._est_pages)
        self._slot_pages[slot] = []
        self._ptab.clear(slot)

    def _vacate(self, victim: Request) -> int:
        """Shared eviction bookkeeping: clear the slot, free its pages,
        return the slot/page holds, and requeue the request with partial
        output retained.  Returns the freed slot index."""
        slot = victim._slot
        assert slot >= 0 and self.slots[slot] is victim, (slot, victim.rid)
        self.slots[slot] = None
        victim._slot = -1
        self._release_pages(slot, victim)
        self.admission.release(victim)
        self.admission.requeue(victim)
        return slot

    def _evict(self, victim: Request) -> int:
        """Evict a running request from its slot; it requeues at the head
        of its QOS class in its tenant queue with partial output kept."""
        victim.preemptions += 1
        self.metrics.counter(
            METRIC_SERVE_PREEMPTIONS, "evicted decode slots").inc()
        return self._vacate(victim)

    def _finish(self, slot: int):
        req = self.slots[slot]
        req.done = True
        self.slots[slot] = None
        req._slot = -1
        self._release_pages(slot, req)
        self.admission.release(req)
        self.metrics.counter("serve_requests_completed").inc()

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
        self._vacate(self.slots[slot])
        self.metrics.counter(
            "serve_page_starvations",
            "slots requeued on page-pool exhaustion").inc()

    def _ensure_pages(self, active: list):
        """Grow each live slot's allocation to cover the coming chunk.
        The +2 headroom keeps the slot's freeze boundary strictly beyond
        the chunk, so a fully-grown paged slot freezes exactly where the
        dense cache would.  On pool exhaustion, reclaim via one-victim
        scavenger eviction; a slot that still cannot cover even its
        current position requeues starved."""
        ps = self.paging.page_size
        for i in list(active):
            req = self.slots[i]
            if req is None:                    # evicted by a reclaim below
                active.remove(i)
                continue
            # a nearly-finished slot only needs pages for the tokens it
            # may still generate
            steps = min(self.decode_chunk, max(int(self.remaining[i]), 1))
            target = min(int(self.pos[i]) + steps + 2, self.cache_len)
            need = pages_for(target, ps) - len(self._slot_pages[i])
            if need <= 0:
                continue
            got = self.allocator.alloc(need)
            if got is None and self._reclaim_one_victim(req):
                got = self.allocator.alloc(need)
            if got is None:                    # partial growth: best effort
                got = self.allocator.alloc(
                    min(need, self.allocator.available()))
            if got:
                n0 = len(self._slot_pages[i])
                self._slot_pages[i].extend(got)
                self._ptab.set_range(i, n0, got)
            if self._capacity(i) <= int(self.pos[i]):
                # starved: not even the current token's page
                self._requeue_starved(i)
                active.remove(i)

    # -------------------------------------------------------------- step ----
    def step(self) -> int:
        """Admit + one fused decode call (``decode_chunk`` tokens per
        slot).  Returns #active + #queued."""
        self._admit()
        self._update_pool_gauges()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if self.paging is not None and active:
            self._ensure_pages(active)
            # growth may have evicted/requeued slots at ANY index (a
            # reclaim victim can precede its requester) — rebuild
            active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return self.admission.pending()
        self._step_fused(active)
        return (len([r for r in self.slots if r is not None])
                + self.admission.pending())

    def _host_vectors(self):
        done = np.array([r is None for r in self.slots])
        eos = np.array([
            (r.eos_id if r is not None and r.eos_id is not None else -1)
            for r in self.slots], np.int32)
        temps = np.array([(r.temperature if r else 0.0)
                          for r in self.slots], np.float32)
        return done, eos, temps

    def _step_fused(self, active: list):
        """One device-resident chunk: one call, one host sync."""
        done, eos, temps = self._host_vectors()
        dev = self.device

        def put(a):
            return torch.from_numpy(a).to(dev)

        page_table = limit = None
        if self.paging is not None:
            limit = put(np.array([
                self._capacity(i) if self.slots[i] is not None
                else self.cache_len
                for i in range(self.num_slots)], np.int32))
            page_table = put(self._dispatch_table())
        t0 = time.perf_counter()
        with torch.no_grad():
            toks, self.cache, token, pos, remaining, done_d = decode_n(
                self.params, self.cache, put(self.last_tok),
                put(self.pos.astype(np.int32)),
                put(self.remaining.astype(np.int32)), put(done), put(eos),
                put(temps), self._gen, self.cfg, self.run,
                self.decode_chunk, self.cache_len,
                page_table=page_table, limit=limit)
            # ONE sync per chunk: everything below is host-side numpy
            toks, pos, token, remaining, done_d = (
                t.cpu().numpy() for t in (toks, pos, token, remaining,
                                          done_d))
        self.metrics.histogram("serve_decode_seconds",
                               "batched decode-step latency").observe(
            time.perf_counter() - t0)
        charges = []
        tenant_tokens: dict[str, int] = {}
        total = 0
        for i in active:
            req = self.slots[i]
            n_gen = int(pos[i]) - int(self.pos[i])
            if n_gen:
                req.output.extend(int(t) for t in toks[i, :n_gen])
                if self.paging is not None:
                    # paged rent: pages actually pinned x steps
                    charges.append(
                        (req, n_gen, 0, len(self._slot_pages[i]) * n_gen))
                else:
                    # per-chunk charge: n tokens + KV-line rent summed over
                    # the chunk's steps (sum_{j=1..n} pos0+j)
                    kv = n_gen * int(self.pos[i]) + n_gen * (n_gen + 1) // 2
                    charges.append((req, n_gen, kv))
                tenant_tokens[req.tenant] = \
                    tenant_tokens.get(req.tenant, 0) + n_gen
                total += n_gen
            self.pos[i] = pos[i]
            self.last_tok[i] = token[i]
            self.remaining[i] = remaining[i]
            if done_d[i]:
                hit_eos = (req.eos_id is not None and req.output
                           and req.output[-1] == req.eos_id)
                if (self.paging is not None and not hit_eos
                        and self.remaining[i] > 0
                        and self._capacity(i) < self.cache_len):
                    # froze at its allocation boundary, not a real stop:
                    # partial growth ran out of pages mid-chunk
                    self._requeue_starved(i)
                else:
                    self._finish(i)
        self.admission.charge_bulk(charges)
        self.metrics.counter("serve_tokens_generated").inc(total)
        tok_counter = self.metrics.counter(
            METRIC_SERVE_TENANT_TOKENS, "generated tokens per tenant")
        for tenant, n in tenant_tokens.items():
            tok_counter.inc(n, tenant=tenant)
        return total

    def run_to_completion(self, max_steps: int = 10_000):
        for _ in range(max_steps):
            if self.step() == 0:
                break
