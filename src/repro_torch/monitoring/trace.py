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

Tracing is strictly opt-in: every producer guards on ``tracer is None``,
so the untraced hot path pays nothing (the JAX package's
``bench_latency_slo`` asserts the traced path stays within 5% tok/s of
tracing disabled).
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

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
    events: list = field(default_factory=list)
    end: Optional[float] = None

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
        latency ``n`` times — the histogram stays token-weighted."""
        hist = self._hist(METRIC_SERVE_ITL, "per-token inter-token latency")
        for _ in range(n):
            hist.observe(seconds, tenant=tenant, qos=qos)
        target = self.targets.get(qos, SLOTarget()).itl_s
        for _ in range(n):
            self._attain(seconds, target, METRIC_SLO_ITL_MET,
                         METRIC_SLO_ITL_VIOLATIONS, tenant, qos)

    def e2e(self, seconds: float, tenant: str, qos: str):
        self._hist(METRIC_SERVE_E2E, "submit -> finish").observe(
            seconds, tenant=tenant, qos=qos)

    def _attain(self, seconds, target, met_name, viol_name, tenant, qos):
        if target is None:
            return
        name = met_name if seconds <= target else viol_name
        self.metrics.counter(name, "SLO attainment").inc(
            tenant=tenant, qos=qos)

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

    # ------------------------------------------------------------- spans ----
    def begin(self, name: str, cat: str = "serving",
              track: tuple = DEFAULT_TRACK,
              parent: Optional[Span] = None,
              ts: Optional[float] = None, **attrs) -> Span:
        """Open a span.  ``parent`` nests it (child inherits the parent's
        track unless one is given explicitly via a non-default value)."""
        if parent is not None and track is DEFAULT_TRACK:
            track = parent.track
        span = Span(sid=next(self._sid), name=name, cat=cat,
                    track=tuple(track),
                    start=self.clock() if ts is None else ts,
                    parent=parent.sid if parent is not None else None,
                    attrs=dict(attrs))
        with self._lock:
            self._open[span.sid] = span
        return span

    def end(self, span: Span, ts: Optional[float] = None, **attrs) -> Span:
        """Close a span: stamp its end, merge attrs, move it from the
        open table into the ring buffer."""
        if span.end is not None:        # idempotent: double-end is a no-op
            return span
        span.end = self.clock() if ts is None else ts
        span.attrs.update(attrs)
        with self._lock:
            self._open.pop(span.sid, None)
            self._done.append(span)
        return span

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
    def export_chrome(self, path: Optional[str] = None,
                      include_open: bool = True) -> dict:
        """Chrome trace-event JSON (the format Perfetto/chrome://tracing
        load).  Spans become complete ('X') events; span events become
        instants ('i'); track tuples map to (pid, tid) lanes with
        metadata naming events.  Events are sorted by timestamp, so
        consumers see a monotonically ordered stream.  Returns the dict;
        writes it to ``path`` when given."""
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
        for s in spans:
            proc, thread = s.track[0], s.track
            if proc not in pids:
                pids[proc] = len(pids) + 1
                meta.append({"ph": "M", "name": "process_name",
                             "pid": pids[proc], "tid": 0,
                             "args": {"name": proc}})
            if thread not in tids:
                tids[thread] = len(tids) + 1
                meta.append({"ph": "M", "name": "thread_name",
                             "pid": pids[proc], "tid": tids[thread],
                             "args": {"name": s.track[1]}})
            pid, tid = pids[proc], tids[thread]
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
        events.sort(key=lambda e: (e["ts"], e.get("dur", 0.0) * -1))
        data = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(data, f)
        return data
