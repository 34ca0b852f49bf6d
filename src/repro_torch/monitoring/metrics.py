"""In-process metrics registry with Prometheus text exposition.

The paper's §6.1 deploys Prometheus + Grafana next to SLURM; daemons don't
fit a CI container, so the same observability surface is provided in-process:
counters / gauges / histograms, labeled series, `expose()` emitting the
Prometheus text format those servers would scrape, and an ASCII dashboard
(`dashboard()`) standing in for Grafana.
"""
from __future__ import annotations

import bisect
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

_DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0,
    float("inf"))

#: Latency-tuned preset for request-level SLO series (queue wait, TTFT,
#: inter-token latency, end-to-end): sub-millisecond resolution at the
#: fast end, where the default preset's decade-wide buckets would smear
#: every interactive-tier percentile into one bin.
LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, float("inf"))

# Canonical series names for the SLURM layer (what the paper's §6.1
# Prometheus would scrape from slurmctld exporters).  The cluster engine
# exports these; dashboards/tests key off the constants, not string
# literals.
METRIC_JOBS_PENDING = "slurm_jobs_pending"
METRIC_JOBS_RUNNING = "slurm_jobs_running"
#: total preempted segments since boot (gauge mirror of the counter below)
METRIC_PREEMPTIONS = "slurm_preemptions_total"
#: preempted segments labeled by victim {qos=,account=}
METRIC_PREEMPTIONS_BY = "slurm_preempted_segments"
#: decayed weighted TRES-seconds, labeled {account=}
METRIC_ACCOUNT_USAGE = "slurm_account_tres_usage"
#: the 2^(-usage/shares) fair-share factor, labeled {account=}
METRIC_ACCOUNT_FAIRSHARE = "slurm_account_fairshare_factor"

# Multi-tenant serving (the admission controller shares the fair-share
# ledger above; these series break the decode engine down per tenant).
#: generated tokens, labeled {tenant=}
METRIC_SERVE_TENANT_TOKENS = "serve_tenant_tokens_generated"
#: admitted requests (incl. resumed preemption victims), labeled {tenant=}
METRIC_SERVE_TENANT_ADMITTED = "serve_tenant_requests_admitted"
#: decode slots evicted for a higher-QOS request
METRIC_SERVE_PREEMPTIONS = "serve_preemptions_total"

# Prefix cache (radix-style shared-prefix reuse over the paged KV pool).
#: admissions that mapped >= 1 cached prefix page read-only
METRIC_SERVE_PREFIX_HITS = "serve_prefix_hits"
#: admissions that found no cached prefix
METRIC_SERVE_PREFIX_MISSES = "serve_prefix_misses"
#: prompt tokens whose prefill was skipped via shared pages
METRIC_SERVE_PREFIX_REUSED_TOKENS = "serve_prefix_reused_tokens"
#: cached prefix pages LRU-evicted back to the free pool under pressure
METRIC_SERVE_PREFIX_EVICTIONS = "serve_prefix_evicted_pages"

# Tensor-parallel serving (paged KV pool sharded across the mesh).
#: KV pages with >= 1 holder, a gauge labeled {device=} — one series per
#: shard, so asymmetric pool pressure is visible before it starves a shard
METRIC_SERVE_KV_PAGES_IN_USE = "serve_kv_pages_in_use"

# Speculative decoding (draft-and-verify inside the fused chunk).
#: draft tokens proposed to the verifier
METRIC_SPEC_PROPOSED = "serve_spec_proposed_total"
#: draft tokens the target model accepted
METRIC_SPEC_ACCEPTED = "serve_spec_accepted_total"
#: running acceptance rate (accepted / proposed), a gauge
METRIC_SPEC_ACCEPT_RATE = "serve_spec_acceptance_rate"

# CUDA graphs of the fused decode token step (``models.model.DecodeGraphs``).
#: token-step graphs captured
METRIC_SERVE_DECODE_GRAPH_CAPTURES = "serve_decode_graph_captures"
#: token steps replayed from a graph
METRIC_SERVE_DECODE_GRAPH_REPLAYS = "serve_decode_graph_replays"
#: token steps run eagerly (a capture's first step among them)
METRIC_SERVE_DECODE_EAGER_STEPS = "serve_decode_eager_token_steps"

# SSM and hybrid serving (per-slot recurrent state beside the KV cache).
#: bytes of SSM state and conv windows the engine holds, a gauge
METRIC_SERVE_SSM_STATE_BYTES = "serve_ssm_state_bytes"

# Elastic multi-replica serving (prefix-affinity router + autoscaler).
#: per-replica queue depth (slot holders + queued), a gauge {replica=}
METRIC_SERVE_REPLICA_LOAD = "serve_replica_load"
#: per-replica KV pages with >= 1 holder, a gauge {replica=}
METRIC_SERVE_REPLICA_KV_PAGES = "serve_replica_kv_pages_in_use"
#: requests the router sent to their prefix-affine replica
METRIC_ROUTE_AFFINITY_HITS = "route_affinity_hits"
#: affinity routes shed to the least-loaded replica (load-shed bound)
METRIC_ROUTE_SPILLS = "route_spills_total"


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _escape_label_value(value) -> str:
    """Prometheus exposition-format label-value escaping: backslash,
    double-quote, and newline must be escaped or the scrape text is
    invalid (a tenant named ``acme "prod"`` would otherwise break every
    series it labels)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels_text(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._vals: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels):
        assert amount >= 0, "counters only go up"
        key = _labels_key(labels)
        with self._lock:
            self._vals[key] = self._vals.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._vals.get(_labels_key(labels), 0.0)

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} counter"]
        for key, v in sorted(self._vals.items()):
            out.append(f"{self.name}{_labels_text(dict(key))} {v}")
        return out


class Gauge:
    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._vals: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels):
        with self._lock:
            self._vals[_labels_key(labels)] = float(value)

    def add(self, amount: float, **labels):
        key = _labels_key(labels)
        with self._lock:
            self._vals[key] = self._vals.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._vals.get(_labels_key(labels), 0.0)

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} gauge"]
        for key, v in sorted(self._vals.items()):
            out.append(f"{self.name}{_labels_text(dict(key))} {v}")
        return out


class Histogram:
    def __init__(self, name: str, help_: str = "", buckets=_DEFAULT_BUCKETS):
        self.name, self.help = name, help_
        self.buckets = tuple(buckets)
        assert self.buckets[-1] == float("inf")
        self._counts: dict[tuple, list[int]] = {}
        self._sum: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, count: int = 1, **labels):
        """Record ``value`` ``count`` times (one bucket and sum update)."""
        key = _labels_key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            counts[bisect.bisect_left(self.buckets, value)] += count
            self._sum[key] = self._sum.get(key, 0.0) + value * count

    def count(self, **labels) -> int:
        return sum(self._counts.get(_labels_key(labels), []))

    def sum(self, **labels) -> float:
        """Total of all observed values (the Prometheus ``_sum`` series)
        — e.g. cumulative prefill seconds across admissions."""
        return self._sum.get(_labels_key(labels), 0.0)

    def quantile(self, q: float, **labels) -> float:
        """Approximate quantile from bucket boundaries, linearly
        interpolated within the terminal bucket (Prometheus
        ``histogram_quantile`` semantics) — 100 observations of 3ms in
        the (1ms, 5ms] bucket report ~3ms, not the 5ms upper bound.  The
        +Inf bucket has no upper bound to interpolate toward, so values
        landing there report the last finite boundary."""
        counts = self._counts.get(_labels_key(labels))
        if not counts:
            return math.nan
        total = sum(counts)
        target = q * total
        acc = 0
        for i, (b, c) in enumerate(zip(self.buckets, counts)):
            prev = acc
            acc += c
            if acc >= target:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                if math.isinf(b) or c == 0:
                    return lo
                return lo + (b - lo) * (target - prev) / c
        return self.buckets[-2]

    def label_sets(self) -> list[dict]:
        """Every label combination this histogram has observed — lets
        dashboards/reports enumerate series without poking ``_counts``."""
        return [dict(key) for key in sorted(self._counts)]

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        for key, counts in sorted(self._counts.items()):
            labels = dict(key)
            acc = 0
            for b, c in zip(self.buckets, counts):
                acc += c
                lb = dict(labels, le=("+Inf" if b == float("inf") else b))
                out.append(f"{self.name}_bucket{_labels_text(lb)} {acc}")
            out.append(f"{self.name}_sum{_labels_text(labels)} "
                       f"{self._sum[key]}")
            out.append(f"{self.name}_count{_labels_text(labels)} {acc}")
        return out


class MetricsRegistry:
    """One per process (or per Cluster); hand it to anything that reports."""

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help_: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_, **kw)
                self._metrics[name] = m
            assert isinstance(m, cls), f"{name} registered as {type(m)}"
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help_, buckets=buckets)

    def timer(self, name: str, help_: str = "", **labels) -> Timer:
        """The ``with registry.timer(...)`` factory Timer's docstring
        advertises: times the with-block into the named histogram."""
        return Timer(self.histogram(name, help_), dict(labels))

    def expose(self) -> str:
        """Prometheus text exposition format (what :9090 would scrape)."""
        lines = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].expose())
        return "\n".join(lines) + "\n"

    def dashboard(self, width: int = 60) -> str:
        """ASCII Grafana: one bar per gauge/counter series, plus one
        summary row per histogram series (count, sum, p50/p99)."""
        rows = []
        vals = []
        hists = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, (Counter, Gauge)):
                for key, v in sorted(m._vals.items()):
                    vals.append((f"{name}{_labels_text(dict(key))}", v))
            elif isinstance(m, Histogram):
                for labels in m.label_sets():
                    hists.append((f"{name}{_labels_text(labels)}", m,
                                  labels))
        peak = max((abs(v) for _, v in vals), default=1.0) or 1.0
        for label, v in vals:
            bar = "#" * int(width * abs(v) / peak)
            rows.append(f"{label:<44} {v:>12.3f} |{bar}")
        for label, m, labels in hists:
            rows.append(
                f"{label:<44} n={m.count(**labels):<8d} "
                f"sum={m.sum(**labels):<12.3f} "
                f"p50={m.quantile(0.5, **labels):.4f} "
                f"p99={m.quantile(0.99, **labels):.4f}")
        return "\n".join(rows)


@dataclass
class Timer:
    """``with registry.timer(...)``-style latency helper."""
    hist: Histogram
    labels: dict = field(default_factory=dict)
    _t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self._t0, **self.labels)
        return False
