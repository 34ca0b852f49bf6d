"""Span-based request/job lifecycle tracer + derived SLO series.

The paper's §6.1 stands Prometheus + Grafana next to SLURM because
aggregate counters alone cannot answer "why was THIS request slow".
:class:`MetricsRegistry` reproduces the scrape surface; this module adds
the per-request story:

* **Spans** — named intervals with explicit parents, attributes, and
  instant events, stamped by an injectable monotonic clock (tests and the
  cluster simulation pass their own).  Completed spans land in a ring
  buffer (bounded memory under sustained traffic); open spans live in a
  side table until ended.
* **One timeline, two workloads** — the serving engine emits
  SUBMIT/QUEUED/ADMIT/PREFILL/DECODE/PREEMPT/RESUME/FINISH request spans
  and the cluster engine (``repro_torch.cluster``) emits job
  PENDING/RUNNING/PREEMPTED/COMPLETED spans into the *same* tracer, so a
  single trace shows batch jobs and serving requests contending for the
  shared ledger.
* **Chrome trace export** — :meth:`Tracer.export_chrome` writes the
  Chrome trace-event JSON format; load it in Perfetto (ui.perfetto.dev)
  or ``chrome://tracing`` — the CI-friendly stand-in for the paper's
  Grafana dashboards.  Each span's ``track`` tuple becomes a
  (process, thread) lane pair.
* **Derived SLO series** — :class:`SLORecorder` turns lifecycle
  timestamps into per-tenant/per-QOS histograms on the latency-tuned
  bucket preset (queue wait, TTFT, inter-token latency, end-to-end) plus
  per-tier SLO-attainment counters, the series the ROADMAP's
  SLO-aware-QOS admission will be judged against.

* **Device timing** — a span opened with ``device=`` a CUDA device
  records a timing event on that device's current stream at its begin
  and its end (events come from a pool).  :meth:`Tracer.resolve` turns
  completed events into ``device_start``/``device_end`` on the tracer's
  own clock, through an anchor event recorded while the stream was idle
  together with a clock reading.  :meth:`Tracer.sync_point` resolves
  and re-anchors, and is called only after a synchronize the program
  makes anyway, so device timing adds none (what has not completed stays
  pending; an export resolves too).  :meth:`Tracer.anchor`
  pairs the clock with ``time.time_ns()`` and travels with every export,
  which maps the profiler's epoch-nanosecond device ops onto the span
  axis.
* **Layer spans** — an engine step or a train step installs a
  :class:`SpanScope` in the :data:`SPANS` context variable; the model,
  optimizer and kernel code below it open their spans there, as
  children of the innermost open one (``core.actshard.snapshot`` carries
  it onto autograd's device thread).

Tracing is strictly opt-in: every producer guards on ``tracer is None``
or reads :data:`SPANS` once, so the untraced hot path creates no span
and no event (the JAX package's ``bench_latency_slo`` asserts the traced
path stays within 5% tok/s of tracing disabled).
"""
from __future__ import annotations

import contextvars
import itertools
import json
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Optional, Sequence

from repro_torch.monitoring.metrics import LATENCY_BUCKETS, MetricsRegistry

# Derived SLO series (latency-tuned buckets, labeled {tenant=, qos=}).
#: seconds between enqueue and admission pick
METRIC_SERVE_QUEUE_WAIT = "serve_queue_wait_seconds"
#: admit -> first decoded token
METRIC_SERVE_TTFT = "serve_ttft_seconds"
#: per-token inter-token latency (chunk-amortized on the fused path)
METRIC_SERVE_ITL = "serve_itl_seconds"
#: submit -> finish
METRIC_SERVE_E2E = "serve_e2e_seconds"
# Per-tier SLO attainment, labeled {tenant=, qos=} — the counters an
# SLO-aware admission policy will read to deadline-boost a tier.
METRIC_SLO_TTFT_MET = "serve_slo_ttft_met"
METRIC_SLO_TTFT_VIOLATIONS = "serve_slo_ttft_violations"
METRIC_SLO_ITL_MET = "serve_slo_itl_met"
METRIC_SLO_ITL_VIOLATIONS = "serve_slo_itl_violations"

#: default (process, thread) lane for spans that don't name one
DEFAULT_TRACK = ("trace", "main")
#: the Chrome export's lane of device-timed spans, at their device times
DEVICE_TRACK = ("device", "stream")


@dataclass
class SpanEvent:
    """Instant event inside a span (Chrome 'i' phase)."""
    name: str
    ts: float
    attrs: dict = field(default_factory=dict)


@dataclass
class Span:
    """One interval on the timeline.  ``track`` is a (process, thread)
    pair — requests get one thread lane each, so Perfetto stacks a
    request's QUEUED/PREFILL/DECODE children under its root span."""
    sid: int
    name: str
    cat: str
    track: tuple
    start: float
    parent: Optional[int] = None       # parent span id
    attrs: dict = field(default_factory=dict)
    #: instant events; a tuple until the first (one object fewer for the
    #: garbage collector to walk in each of the many spans with none)
    events: Sequence = ()
    end: Optional[float] = None
    #: when the device ran the span's work, on the tracer's clock (device-
    #: timed spans, once :meth:`Tracer.resolve` has read their events)
    device_start: Optional[float] = None
    device_end: Optional[float] = None
    #: [anchor, begin event, end event, device] until resolved
    _dev: Optional[list] = field(default=None, repr=False, compare=False)

    @property
    def duration(self) -> float:
        return (self.end - self.start) if self.end is not None else 0.0


@dataclass(frozen=True)
class SLOTarget:
    """Latency objectives for one QOS tier (None = best-effort: the
    series still records, but no attainment counter moves)."""
    ttft_s: Optional[float] = None
    itl_s: Optional[float] = None


#: Default per-tier objectives: interactive `high` traffic wants sub-
#: second first tokens and snappy streaming; `normal` tolerates seconds;
#: `scavenger` is explicitly best-effort (no SLO to violate).
DEFAULT_SLO_TARGETS = {
    "high": SLOTarget(ttft_s=1.0, itl_s=0.2),
    "normal": SLOTarget(ttft_s=5.0, itl_s=0.5),
    "scavenger": SLOTarget(),
}


class SLORecorder:
    """Derived latency series + per-tier attainment counters.

    Producers report raw seconds at lifecycle edges; everything lands in
    per-(tenant, QOS) histograms on :data:`LATENCY_BUCKETS` so p50/p99
    are meaningful at interactive latencies.  A tier with a target in
    ``targets`` additionally bumps met/violated counters per observation.
    """

    def __init__(self, metrics: MetricsRegistry,
                 targets: Optional[dict[str, SLOTarget]] = None):
        self.metrics = metrics
        self.targets = dict(DEFAULT_SLO_TARGETS if targets is None
                            else targets)

    def _hist(self, name: str, help_: str):
        return self.metrics.histogram(name, help_, buckets=LATENCY_BUCKETS)

    def queue_wait(self, seconds: float, tenant: str, qos: str):
        self._hist(METRIC_SERVE_QUEUE_WAIT,
                   "enqueue -> admission pick").observe(
            seconds, tenant=tenant, qos=qos)

    def ttft(self, seconds: float, tenant: str, qos: str):
        self._hist(METRIC_SERVE_TTFT,
                   "admit -> first decoded token").observe(
            seconds, tenant=tenant, qos=qos)
        self._attain(seconds, self.targets.get(qos, SLOTarget()).ttft_s,
                     METRIC_SLO_TTFT_MET, METRIC_SLO_TTFT_VIOLATIONS,
                     tenant, qos)

    def itl(self, seconds: float, tenant: str, qos: str, n: int = 1):
        """Per-token inter-token latency.  The fused decode path syncs
        once per chunk, so it reports the chunk-amortized per-token
        latency with a count of ``n`` — the histogram stays
        token-weighted."""
        self._hist(METRIC_SERVE_ITL, "per-token inter-token latency").observe(
            seconds, count=n, tenant=tenant, qos=qos)
        self._attain(seconds, self.targets.get(qos, SLOTarget()).itl_s,
                     METRIC_SLO_ITL_MET, METRIC_SLO_ITL_VIOLATIONS, tenant,
                     qos, n)

    def e2e(self, seconds: float, tenant: str, qos: str):
        self._hist(METRIC_SERVE_E2E, "submit -> finish").observe(
            seconds, tenant=tenant, qos=qos)

    def _attain(self, seconds, target, met_name, viol_name, tenant, qos,
                n: int = 1):
        if target is None:
            return
        name = met_name if seconds <= target else viol_name
        self.metrics.counter(name, "SLO attainment").inc(
            n, tenant=tenant, qos=qos)

    # ----------------------------------------------------------- reports ----
    def attainment(self) -> dict[tuple, dict]:
        """(tenant, qos) -> attainment summary for tiers with targets."""
        out: dict[tuple, dict] = {}
        met_t = self.metrics.counter(METRIC_SLO_TTFT_MET)
        viol_t = self.metrics.counter(METRIC_SLO_TTFT_VIOLATIONS)
        met_i = self.metrics.counter(METRIC_SLO_ITL_MET)
        viol_i = self.metrics.counter(METRIC_SLO_ITL_VIOLATIONS)
        keys = set()
        for c in (met_t, viol_t, met_i, viol_i):
            keys.update(tuple(sorted(dict(k).items())) for k in c._vals)
        for key in sorted(keys):
            labels = dict(key)
            out[(labels["tenant"], labels["qos"])] = {
                "ttft_met": met_t.value(**labels),
                "ttft_violations": viol_t.value(**labels),
                "itl_met": met_i.value(**labels),
                "itl_violations": viol_i.value(**labels),
            }
        return out

    def format_report(self) -> str:
        """Per-(tenant, QOS) p50/p95/p99 TTFT & ITL table — the serving
        section of ``sdiag`` and the ``--trace`` end-of-run summary."""
        ttft = self._hist(METRIC_SERVE_TTFT, "")
        itl = self._hist(METRIC_SERVE_ITL, "")
        e2e = self._hist(METRIC_SERVE_E2E, "")
        rows = [f"{'TENANT':<12}{'QOS':<11}{'N':>5} "
                f"{'TTFT p50/p95/p99 (ms)':>24} "
                f"{'ITL p50/p95/p99 (ms)':>23} {'SLO ok':>8}"]
        attain = self.attainment()
        for labels in ttft.label_sets():
            tenant, qos = labels["tenant"], labels["qos"]

            def pct(hist):
                return "/".join(
                    f"{hist.quantile(q, **labels) * 1e3:.1f}"
                    for q in (0.5, 0.95, 0.99))

            a = attain.get((tenant, qos))
            if a:
                total = sum(a.values())
                ok = (a["ttft_met"] + a["itl_met"]) / total if total else 1.0
                slo = f"{ok:.0%}"
            else:
                slo = "n/a"
            rows.append(f"{tenant:<12}{qos:<11}"
                        f"{ttft.count(**labels):>5d} {pct(ttft):>24} "
                        f"{pct(itl):>23} {slo:>8}")
            rows.append(f"{'':<12}{'':<11}{'':>5} "
                        f"e2e {e2e.quantile(0.5, **labels) * 1e3:.1f}/"
                        f"{e2e.quantile(0.99, **labels) * 1e3:.1f}ms "
                        f"(p50/p99)")
        return "\n".join(rows)


class CudaEvents:
    """Timing events on a CUDA device's current stream.  Span events come
    from a pool that :meth:`Tracer.resolve` refills; a test substitutes a
    fake with the same methods."""

    def __init__(self):
        self._free: list = []

    def record(self, device):
        import torch

        ev = self._free.pop() if self._free else \
            torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev

    @staticmethod
    def idle(device) -> bool:
        """Whether the device's current stream has finished its work (no
        wait)."""
        import torch

        return torch.cuda.current_stream(device).query()

    @staticmethod
    def done(ev) -> bool:
        return ev.query()

    @staticmethod
    def seconds(a, b) -> float:
        """Device time from event ``a`` to event ``b``."""
        return a.elapsed_time(b) / 1e3

    def release(self, *evs):
        self._free.extend(evs)


class Tracer:
    """Nestable spans over an injectable monotonic clock, with ring-buffer
    retention and Chrome trace-event export.

    One tracer per deployment: the serving engine, admission controller,
    and cluster simulation all write here.  ``clock`` defaults to wall
    ``time.monotonic``; the cluster passes explicit ``ts=`` stamps from
    its virtual clock so simulated jobs land on the same timeline.
    """

    def __init__(self, clock=time.monotonic, max_spans: int = 65536,
                 metrics: Optional[MetricsRegistry] = None,
                 slo_targets: Optional[dict[str, SLOTarget]] = None):
        self.clock = clock
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.slo = SLORecorder(self.metrics, slo_targets)
        self._done: deque[Span] = deque(maxlen=max_spans)
        self._open: dict[int, Span] = {}
        self._sid = itertools.count(1)
        self._lock = threading.Lock()
        self.events = CudaEvents()
        self._anchors: dict = {}        # device -> (event, clock reading)
        self._pending: list[Span] = []  # ended, device times not read yet

    # ------------------------------------------------------------- spans ----
    def begin(self, name: str, cat: str = "serving",
              track: tuple = DEFAULT_TRACK,
              parent: Optional[Span] = None,
              ts: Optional[float] = None, device=None, **attrs) -> Span:
        """Open a span.  ``parent`` nests it (child inherits the parent's
        track unless one is given explicitly via a non-default value).
        ``device``: a CUDA ``torch.device`` times the span on the device
        too (any other device, or None, records nothing)."""
        if parent is not None and track is DEFAULT_TRACK:
            track = parent.track
        span = Span(sid=next(self._sid), name=name, cat=cat,
                    track=tuple(track),
                    start=self.clock() if ts is None else ts,
                    parent=parent.sid if parent is not None else None,
                    attrs=dict(attrs))
        if device is not None:
            anchor = self._anchors.get(device)
            if anchor is None and device.type == "cuda":
                anchor = self._anchor_device(device)
            if anchor is not None:
                span._dev = [anchor, self.events.record(device), None,
                             device]
        with self._lock:
            self._open[span.sid] = span
        return span

    def end(self, span: Span, ts: Optional[float] = None, **attrs) -> Span:
        """Close a span: stamp its end, merge attrs, move it from the
        open table into the ring buffer."""
        if span.end is not None:        # idempotent: double-end is a no-op
            return span
        if span._dev is not None:
            span._dev[2] = self.events.record(span._dev[3])
            self._pending.append(span)
        span.end = self.clock() if ts is None else ts
        span.attrs.update(attrs)
        with self._lock:
            self._open.pop(span.sid, None)
            self._done.append(span)
        return span

    def add(self, parent: Span, names: list, marks: list, cat: str) -> None:
        """Completed children of ``parent``, ``names[i]`` from ``marks[i]``
        to ``marks[i + 1]`` (see :meth:`SpanScope.layers`)."""
        sid, track, up = self._sid, parent.track, parent.sid
        spans = [Span(next(sid), name, cat, track, marks[i], up,
                      end=marks[i + 1]) for i, name in enumerate(names)]
        with self._lock:
            self._done.extend(spans)

    # ------------------------------------------------------ device time ----
    def anchor(self) -> tuple:
        """``(clock(), time.time_ns())`` read back to back: maps an
        epoch-nanosecond stamp (the profiler's) onto the span axis."""
        return self.clock(), time.time_ns()

    def _anchor_device(self, device):
        """Record an anchor event if the device's stream is idle (the
        event then runs as it is recorded, at the clock reading taken
        with it); else keep the last anchor.  Anchors are not pooled:
        spans still pending hold theirs."""
        if not self.events.idle(device):
            return self._anchors.get(device)
        anchor = (self.events.record(device), self.clock())
        self._anchors[device] = anchor
        return anchor

    def resolve(self) -> int:
        """Read the events of ended device-timed spans whose work has
        completed into ``device_start``/``device_end`` (no wait: a span
        still running stays pending), and hand their events back to the
        pool.  Returns how many spans were read."""
        pending = self._pending
        if not pending:
            return 0
        # one stream a device: its last event done means all are
        last = pending[-1]._dev
        every = self.events.done(last[2]) and all(
            sp._dev[3] == last[3] for sp in pending)
        keep = []
        for sp in pending:
            (ev_a, t_a), ev0, ev1, _ = sp._dev
            if not every and not self.events.done(ev1):
                keep.append(sp)
                continue
            sp.device_start = t_a + self.events.seconds(ev_a, ev0)
            sp.device_end = t_a + self.events.seconds(ev_a, ev1)
            self.events.release(ev0, ev1)
            sp._dev = None
        self._pending = keep
        return len(pending) - len(keep)

    def sync_point(self, device) -> None:
        """Call right after a synchronize the program makes on ``device``:
        resolve what has completed and re-anchor the device's clock."""
        if device is None or device.type != "cuda":
            return
        self.resolve()
        self._anchor_device(device)

    @contextmanager
    def span(self, name: str, cat: str = "serving",
             track: tuple = DEFAULT_TRACK, parent: Optional[Span] = None,
             **attrs):
        sp = self.begin(name, cat=cat, track=track, parent=parent, **attrs)
        try:
            yield sp
        finally:
            self.end(sp)

    def event(self, name: str, span: Span, ts: Optional[float] = None,
              **attrs):
        """Instant event attached to a span (rendered as an 'i' marker)."""
        if not span.events:
            span.events = []
        span.events.append(SpanEvent(
            name, self.clock() if ts is None else ts, dict(attrs)))

    # ----------------------------------------------------------- queries ----
    def spans(self, name: Optional[str] = None, cat: Optional[str] = None,
              track: Optional[tuple] = None) -> list[Span]:
        """Completed spans (ring-buffer contents), optionally filtered."""
        with self._lock:
            out = list(self._done)
        if name is not None:
            out = [s for s in out if s.name == name]
        if cat is not None:
            out = [s for s in out if s.cat == cat]
        if track is not None:
            out = [s for s in out if s.track == tuple(track)]
        return out

    def open_spans(self) -> list[Span]:
        with self._lock:
            return list(self._open.values())

    # ------------------------------------------------------------ export ----
    def export(self) -> dict:
        """The completed spans as plain records, with the clock
        :meth:`anchor`: ``{"anchor": [clock, time_ns], "spans": [{sid,
        parent, name, cat, track, start, end, device_start, device_end,
        attrs}]}``, in completion order.  Device times that have completed
        are read first (no wait)."""
        self.resolve()
        return {"anchor": list(self.anchor()),
                "spans": [{"sid": s.sid, "parent": s.parent, "name": s.name,
                           "cat": s.cat, "track": list(s.track),
                           "start": s.start, "end": s.end,
                           "device_start": s.device_start,
                           "device_end": s.device_end,
                           "attrs": dict(s.attrs)} for s in self.spans()]}

    def export_chrome(self, path: Optional[str] = None,
                      include_open: bool = True) -> dict:
        """Chrome trace-event JSON (the format Perfetto/chrome://tracing
        load).  Spans become complete ('X') events; span events become
        instants ('i'); track tuples map to (pid, tid) lanes with
        metadata naming events.  A device-timed span appears a second
        time on the :data:`DEVICE_TRACK` lane, at its device times, so
        the host's spans and the device's work show side by side.  Events
        are sorted by timestamp, so consumers see a monotonically ordered
        stream; ``otherData.clock_anchor`` holds :meth:`anchor`.  Returns
        the dict; writes it to ``path`` when given."""
        self.resolve()
        with self._lock:
            spans = list(self._done)
            if include_open:
                now = self.clock()
                for s in self._open.values():
                    spans.append(Span(s.sid, s.name, s.cat, s.track,
                                      s.start, s.parent,
                                      dict(s.attrs, incomplete=True),
                                      list(s.events), end=now))
        pids: dict[str, int] = {}
        tids: dict[tuple, int] = {}
        meta, events = [], []

        def lane(track):
            proc = track[0]
            if proc not in pids:
                pids[proc] = len(pids) + 1
                meta.append({"ph": "M", "name": "process_name",
                             "pid": pids[proc], "tid": 0,
                             "args": {"name": proc}})
            if track not in tids:
                tids[track] = len(tids) + 1
                meta.append({"ph": "M", "name": "thread_name",
                             "pid": pids[proc], "tid": tids[track],
                             "args": {"name": track[1]}})
            return pids[proc], tids[track]

        for s in spans:
            pid, tid = lane(s.track)
            args = {k: v for k, v in s.attrs.items()}
            args["sid"] = s.sid
            if s.parent is not None:
                args["parent_sid"] = s.parent
            events.append({
                "name": s.name, "cat": s.cat, "ph": "X",
                "ts": round(s.start * 1e6, 3),
                "dur": round(max(s.duration, 0.0) * 1e6, 3),
                "pid": pid, "tid": tid, "args": args,
            })
            for ev in s.events:
                events.append({
                    "name": ev.name, "cat": s.cat, "ph": "i",
                    "ts": round(ev.ts * 1e6, 3), "pid": pid, "tid": tid,
                    "s": "t", "args": dict(ev.attrs, span_sid=s.sid),
                })
            if s.device_start is not None:
                dpid, dtid = lane(DEVICE_TRACK)
                events.append({
                    "name": s.name, "cat": s.cat, "ph": "X",
                    "ts": round(s.device_start * 1e6, 3),
                    "dur": round((s.device_end - s.device_start) * 1e6, 3),
                    "pid": dpid, "tid": dtid, "args": {"span_sid": s.sid},
                })
        events.sort(key=lambda e: (e["ts"], e.get("dur", 0.0) * -1))
        data = {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"clock_anchor": list(self.anchor())}}
        if path is not None:
            with open(path, "w") as f:
                json.dump(data, f)
        return data


# --------------------------------------------------------- layer spans ----

class SpanScope:
    """The open spans of one traced call (an engine step, a train step).
    Code below the call opens its spans here, through :data:`SPANS`, as
    children of the innermost open one, timed on ``device`` as well."""

    __slots__ = ("tracer", "device", "stack")

    def __init__(self, tracer: Tracer, device, root: Span):
        self.tracer, self.stack = tracer, [root]
        # a device that records nothing is not passed on span by span
        self.device = device if device is not None and \
            device.type == "cuda" else None

    def begin(self, name: str, cat: str, timed: bool = True,
              **attrs) -> Span:
        sp = self.tracer.begin(name, cat=cat, parent=self.stack[-1],
                               device=self.device if timed else None,
                               **attrs)
        self.stack.append(sp)
        return sp

    def end(self, sp: Span, **attrs) -> None:
        """Close ``sp``, the innermost open span."""
        self.stack.pop()
        self.tracer.end(sp, **attrs)

    @contextmanager
    def span(self, name: str, cat: str, timed: bool = True, **attrs):
        sp = self.begin(name, cat, timed, **attrs)
        try:
            yield sp
        finally:
            self.end(sp)

    def layers(self, names: list, marks: list, cat: str) -> None:
        """Host-timed spans of back-to-back intervals under the innermost
        open span: ``names[i]`` from ``marks[i]`` to ``marks[i + 1]`` (a
        layer loop reads the clock once a boundary; the spans are made
        after it, in one go)."""
        self.tracer.add(self.stack[-1], names, marks, cat)

    @contextmanager
    def under(self, sp: Span):
        """Make ``sp``, opened elsewhere, the parent of the spans opened
        inside."""
        self.stack.append(sp)
        try:
            yield
        finally:
            self.stack.pop()


#: the :class:`SpanScope` of the traced call in progress (None: untraced)
SPANS: contextvars.ContextVar[Optional[SpanScope]] = contextvars.ContextVar(
    "repro_torch_spans", default=None)


@contextmanager
def span_scope(tracer: Tracer, device, name: str, cat: str, track: tuple,
               **attrs):
    """Open the root span ``name`` of a traced call (device-timed on
    ``device``) and install its :class:`SpanScope` in :data:`SPANS` until
    the call returns; yields the scope."""
    root = tracer.begin(name, cat=cat, track=track, device=device, **attrs)
    sc = SpanScope(tracer, device, root)
    tok = SPANS.set(sc)
    try:
        yield sc
    finally:
        SPANS.reset(tok)
        tracer.end(root)


def scoped(name: str, cat: str, timed: bool = True, **attrs):
    """A context manager for one span in the current scope; outside one a
    no-op (the cost: one context-variable read)."""
    sc = SPANS.get()
    return nullcontext() if sc is None else sc.span(name, cat, timed,
                                                    **attrs)
