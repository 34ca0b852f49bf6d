#!/usr/bin/env python3
"""Where the time of a benchmark cell's step goes, read from the port's
own spans (``repro_torch.monitoring.trace``) and the device trace:

    python3 scripts/step_spans.py --workload stablelm-3b.decode \\
        --seed N --seconds S [--train-tracer 0|1] [--out FILE]

runs one traced run of a cell of ``BENCHMARK.json`` through the
benchmark's own harness (``cardbench/harness/serve.py`` or ``train.py``,
its window and its profiled step after the window), with the port's
tracer on: the serving harness builds one in a traced run; the training
harness is handed one through ``make_train_step(..., tracer=)``.  It skips
the reference check and prints one JSON line:

* serving: per token step of the window's steps, the host time inside
  ``launch`` (``decode_launch_ms``; a chunk replayed from CUDA graphs is
  a ``launch`` span with ``graphed`` set and no layer spans under it:
  ``replayed_share`` of the window's token steps, and "no layer split
  under replay"; the engine's graph counters), inside ``wait``, and the
  ``step``
  spans' self time outside ``launch``, ``wait`` and PREFILL
  (``engine_host_ms``), beside the benchmark's ``decode_step_ms``; host
  ms a token step of each model span (``attention.decode``,
  ``ssm.decode``, ``ssm_prefill.prefill``, ``ffn.prefill``...) and the
  engine's host time by span; in the
  profiled step, the device ms of the ops each model span kind launched
  (by the profiler's correlation of each op with its launch call: layer
  spans are timed on the host only), the device's idle time split by the
  innermost host span it falls in (``idle_in_launch`` is the ``launch``
  part over the step's wall), how far device ops stray outside the
  ``step`` span, the share of idle time the spans cover, and how many
  ops straddle a span's device start or end (its CUDA events);
* training: per window step, the device time of ``forward``,
  ``backward`` (``attention_bwd`` within), ``reduce`` and ``optimizer``
  (``grad_norm`` within), their sum against the step's wall time, and
  the profiled step's idle time split by host span.

Both also give the tracer's own host time (its calls, a token step or a
step), and the profiled step's garbage collections and longest idle
gaps with the host span each falls in.  ``--train-tracer 0`` runs the
training harness without a tracer, as the benchmark runs it.  The
profiler's ops are mapped onto the span axis by the export's clock
anchor.  ``--out`` also writes the profiled step's spans and ops.  Needs
a CUDA card; the analysis functions run anywhere.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: host span kinds an idle moment is put down to, innermost first
SERVE_KINDS = ("PREFILL", "launch", "stage", "wait", "book", "pages",
               "admit", "step")
TRAIN_KINDS = ("attention_bwd", "grad_norm", "forward", "backward",
               "reduce", "optimizer", "train_step")


# ------------------------------------------------------------ intervals ----

def union(iv) -> list:
    """Merged, sorted intervals."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def total(iv) -> float:
    return sum(e - s for s, e in iv)


def intersect(a, b) -> list:
    """Intersection of two merged, sorted interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a, b) -> list:
    """``a`` less ``b`` (merged, sorted lists)."""
    out = []
    for s, e in a:
        for bs, be in b:
            if be <= s or bs >= e:
                continue
            if bs > s:
                out.append((s, bs))
            s = max(s, be)
            if s >= e:
                break
        if s < e:
            out.append((s, e))
    return out


def on_span_axis(ops, anchor) -> list:
    """Profiler ops ``(start_us, end_us, name)`` on the Unix epoch onto the
    span clock, by the anchor ``(clock, time_ns)``: seconds."""
    clock, ns = anchor
    us0 = ns / 1e3
    return [(clock + (s - us0) / 1e6, clock + (e - us0) / 1e6, n)
            for s, e, n in ops]


def idle(ops, t0: float, t1: float) -> list:
    """Where no op of ``ops`` (on the span axis) runs in ``[t0, t1]``."""
    return subtract([(t0, t1)], union((s, e) for s, e, _ in ops))


def split_by(pieces, kinds: dict) -> dict:
    """Seconds of ``pieces`` (merged intervals) in each kind's intervals,
    each moment to the first kind (in order) that holds it; ``none``: in
    no kind."""
    out, rest = {}, pieces
    for name, iv in kinds.items():
        iv = union(iv)
        out[name] = total(intersect(rest, iv))
        rest = subtract(rest, iv)
    out["none"] = total(rest)
    return out


def within(spans, t0: float, t1: float, name: str | None = None) -> list:
    return [s for s in spans if t0 <= s["start"] and s["end"] <= t1
            and (name is None or s["name"] == name)]


def host_s(spans) -> float:
    return sum(s["end"] - s["start"] for s in spans)


def device_s(spans) -> float:
    return sum(s["device_end"] - s["device_start"] for s in spans
               if s["device_start"] is not None)


# --------------------------------------------------------------- serving ----

def model_key(s: dict, names: dict):
    """``attention.decode``, ``ffn.prefill``, ``token_step.decode``...:
    a model span by the call it ran in."""
    where = "prefill" if names.get(s["parent"]) == "PREFILL" else "decode"
    return f"{s['name']}.{where}"


def serve_summary(rec: dict, export: dict) -> dict:
    spans = [s for s in export["spans"] if s["end"] is not None]
    names = {s["sid"]: s["name"] for s in export["spans"]}
    window = [s for s in rec["steps"] if not s["traced"]
              and s["token_steps"]]
    n = sum(s["token_steps"] for s in window)
    parts = {"launch": 0.0, "wait": 0.0, "engine_host": 0.0, "step": 0.0,
             "after": 0.0}
    graphed = [0, 0]                   # chunks, token steps replayed
    model: dict = {}
    split: dict = {}
    longest: dict = {}
    for st in window:
        inside = within(spans, st["t0"], st["t1"])
        roots = [s for s in inside if s["name"] == "step"
                 and s["cat"] == "step"]
        step = host_s(roots)
        # after the last child: reading the step's device times
        parts["after"] += sum(r["end"] - max(
            (s["end"] for s in inside if s["parent"] == r["sid"]),
            default=r["end"]) for r in roots)
        launches = [s for s in inside if s["name"] == "launch"]
        launch = host_s(launches)
        for s in launches:
            if s["attrs"].get("graphed"):
                graphed[0] += 1
                graphed[1] += s["attrs"].get("replayed", 0)
        wait = host_s(s for s in inside if s["name"] == "wait")
        prefill = host_s(s for s in inside if s["name"] == "PREFILL")
        parts["launch"] += launch
        parts["wait"] += wait
        parts["engine_host"] += step - launch - wait - prefill
        for k in ("admit", "pages", "stage", "book"):
            ks = [s["end"] - s["start"] for s in inside if s["name"] == k]
            split[k] = split.get(k, 0.0) + sum(ks)
            longest[k] = max([longest.get(k, 0.0)] + ks)
        split["admit"] -= prefill
        parts["step"] += st["t1"] - st["t0"] - st["prefill_s"]
        for s in inside:
            if s["cat"] == "model":
                k = model_key(s, names)
                model[k] = model.get(k, 0.0) + s["end"] - s["start"]
    n = max(n, 1)
    out = {"token_steps": n,
           "decode_step_ms": 1e3 * parts["step"] / n,
           "decode_launch_ms": 1e3 * parts["launch"] / n,
           "wait_ms": 1e3 * parts["wait"] / n,
           "engine_host_ms": 1e3 * parts["engine_host"] / n,
           "resolve_ms": 1e3 * parts["after"] / n,
           # engine_host_ms by span (admit less its PREFILL spans), and
           # each span's longest single step
           "engine_split_ms": {k: 1e3 * v / n for k, v in split.items()},
           "engine_longest_ms": {k: 1e3 * v for k, v in longest.items()},
           "model_host_ms": {k: 1e3 * h / n
                             for k, h in sorted(model.items())}}
    out["sum_over_step"] = (out["decode_launch_ms"] + out["wait_ms"]
                            + out["engine_host_ms"]) / max(
        out["decode_step_ms"], 1e-9)
    # a chunk replayed from CUDA graphs runs no Python a layer: its
    # ``launch`` span (``graphed``) has no token_step/attention/ffn/sample
    out["graphed_chunks"] = graphed[0]
    out["replayed_share"] = graphed[1] / n
    if graphed[0] and not model:
        out["layer_split"] = "no layer split under replay"
    traced = [s for s in rec["steps"] if s["traced"]]
    if traced and rec.get("trace"):
        prof = out["profiled"] = profiled_summary(
            traced[0], rec["trace"], export, spans, SERVE_KINDS)
        out["idle_in_launch"] = prof["idle_share"]["launch"]
    return out


def launched_by(spans: list, launches: dict, anchor, per: int) -> dict:
    """Host ms and device ms a token step (``per``: the profiled step's
    token steps) of each model span kind, the device ms being that of
    the ops whose launch call the host made inside a span of the kind
    (the innermost); ops launched elsewhere count as ``other``."""
    names = {s["sid"]: s["name"] for s in spans}
    leaves = sorted((s["start"], s["end"], model_key(s, names))
                    for s in spans if s["cat"] == "model"
                    and s["name"] != "token_step")
    steps = sorted((s["start"], s["end"]) for s in spans
                   if s["name"] == "token_step")
    out: dict = {}
    for s in spans:
        if s["cat"] == "model":
            out.setdefault(model_key(s, names), [0.0, 0.0])[0] += \
                s["end"] - s["start"]
    starts = [a for a, _, _ in leaves]
    step_starts = [a for a, _ in steps]
    clock, ns = anchor
    for a, b, _, corr in launches["ops"]:
        t = launches["host_us"].get(corr)
        if t is None:
            continue
        t = clock + (t - ns / 1e3) / 1e6
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and leaves[i][1] >= t:
            key = leaves[i][2]
        else:
            j = bisect.bisect_right(step_starts, t) - 1
            key = "token_step.decode" if j >= 0 and steps[j][1] >= t \
                else "other"
        out.setdefault(key, [0.0, 0.0])[1] += (b - a) / 1e6
    return {k: [1e3 * h / per, 1e3 * d / per]
            for k, (h, d) in sorted(out.items())}


def profiled_summary(st: dict, trace: dict, export: dict, spans: list,
                     kinds: tuple) -> dict:
    """The profiled step: idle time by host span, how far ops stray
    outside the root span (its host interval, and its device interval
    from its events), the spans' cover of idle time, and device ops that
    straddle a span's device start or end (none, if the events' clock
    and the profiler's agree)."""
    ops = on_span_axis(trace["ops"], export["anchor"])
    # the profiled wall: from the step's start to the synchronize after
    # it, before the profiler stops
    t0 = st["t0"]
    t1 = t0 + trace["wall_s"]
    inside = within(spans, t0, t1)
    gaps = idle(ops, t0, t1)
    split = split_by(gaps, {k: [(s["start"], s["end"]) for s in inside
                                if s["name"] == k] for k in kinds})
    wall = t1 - t0

    def stray(a, b):
        return 1e3 * max((max(a - s, e - b, 0.0) for s, e, _ in ops),
                         default=0.0)

    roots = [s for s in inside if s["name"] == kinds[-1]]
    out = {"wall_s": wall, "ops": len(ops),
           "busy_s": total(union((s, e) for s, e, _ in ops)),
           "idle_s": total(gaps), "idle_by_span_s": split,
           "idle_share": {k: 100.0 * v / wall for k, v in split.items()},
           "idle_covered": total(intersect(gaps, union(
               (s["start"], s["end"]) for s in inside))) / total(gaps)
           if gaps else 1.0,
           "spans": inside}
    if roots:
        r = roots[0]
        out["stray_ms"] = stray(r["start"], r["end"])
        if r["device_start"] is not None:
            out["stray_device_ms"] = stray(r["device_start"],
                                           r["device_end"])
    cuts = [t for s in inside if s["device_start"] is not None
            for t in (s["device_start"], s["device_end"])]
    cross = [min(t - a, b - t) for a, b, _ in ops for t in cuts
             if a < t < b]
    out["device_cuts"] = len(cuts)
    out["straddling_ops"] = len(cross)
    out["max_straddle_us"] = 1e6 * max(cross, default=0.0)
    return out


# -------------------------------------------------------------- training ----

def train_summary(rec: dict, export: dict) -> dict:
    spans = [s for s in export["spans"] if s["end"] is not None]
    window = [s for s in rec["steps"] if not s["traced"]]
    names = ("forward", "backward", "attention_bwd", "reduce", "optimizer",
             "grad_norm")
    dev = {k: [] for k in names}
    sums, walls = [], []
    for st in window:
        inside = within(spans, st["t0"], st["t1"])
        if not any(s["name"] == "train_step" for s in inside):
            continue
        d = {k: device_s(s for s in inside if s["name"] == k) for k in names}
        for k in names:
            dev[k].append(d[k])
        sums.append(d["forward"] + d["backward"] + d["reduce"]
                    + d["optimizer"])
        walls.append(st["t1"] - st["t0"])
    if not walls:
        walls = [st["t1"] - st["t0"] for st in window]
        return {"steps": len(walls), "step_s_mean": statistics.mean(walls),
                "profiled": profiled_summary(
                    [s for s in rec["steps"] if s["traced"]][0],
                    rec["trace"], export, spans, TRAIN_KINDS)}
    out = {"steps": len(walls),
           "step_s": statistics.median(walls),
           "step_s_mean": statistics.mean(walls),
           "device_ms": {k: 1e3 * statistics.median(v)
                         for k, v in dev.items() if any(v)},
           "children_over_wall": statistics.median(
               a / b for a, b in zip(sums, walls))}
    traced = [s for s in rec["steps"] if s["traced"]]
    if traced and rec.get("trace"):
        out["profiled"] = profiled_summary(traced[0], rec["trace"], export,
                                           spans, TRAIN_KINDS)
    return out


# ------------------------------------------------------------------ run ----

def use_harness():
    """Make the benchmark's harness importable (as ``cardbench/run.py``
    does) and import the port through it."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    if str(ROOT / "cardbench") not in sys.path:
        sys.path.insert(0, str(ROOT / "cardbench"))
    from harness import port

    port.import_port()


#: the serving engine's decode-graph counters (``models.model.DecodeGraphs``)
GRAPH_COUNTERS = ("serve_decode_graph_captures",
                  "serve_decode_graph_replays",
                  "serve_decode_eager_token_steps")

#: the engine's SSM gauges (hybrid and SSM configs)
SSM_GAUGES = ("serve_ssm_state_bytes",)

#: span categories this tracer's spans inside a step use (the others
#: are the request lifecycle's)
STEP_CATS = ("step", "model", "train", "kernel")


def traced_run(cell, seed: int, seconds: float, device="cuda",
               train_tracer: bool = True):
    """One traced run of the cell through its harness: ``(rec, export,
    host)``, ``host`` holding the time spent in the tracer's calls (by
    whether the span is one of :data:`STEP_CATS`) and the garbage
    collections, on the span clock.  ``train_tracer=False`` runs the
    training harness without a tracer, as the benchmark does."""
    use_harness()
    import gc

    import torch
    from harness import bench
    from harness.clock import now

    import repro_torch.monitoring as monitoring
    import repro_torch.training.train_step as train_step

    made = []
    host = {"tracer_s": {"step": 0.0, "request": 0.0, "events": 0.0},
            "gc": []}
    real_tracer, real_make = monitoring.Tracer, train_step.make_train_step

    def charge(cat, t0):
        host["tracer_s"]["step" if cat in STEP_CATS else "request"] += \
            now() - t0

    class Kept(real_tracer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)
            record = self.events.record

            def timed(device):
                t0 = now()
                ev = record(device)
                host["tracer_s"]["events"] += now() - t0
                return ev

            self.events.record = timed

        def begin(self, name, cat="serving", *a, **k):
            t0 = now()
            sp = super().begin(name, cat, *a, **k)
            charge(cat, t0)
            return sp

        def end(self, span, *a, **k):
            t0 = now()
            super().end(span, *a, **k)
            charge(span.cat, t0)
            return span

        def add(self, parent, names, marks, cat):
            t0 = now()
            super().add(parent, names, marks, cat)
            charge(cat, t0)

        def sync_point(self, device):
            t0 = now()
            super().sync_point(device)
            charge("step", t0)

    def make(*a, **k):
        return real_make(*a, tracer=Kept(clock=now, max_spans=1 << 20), **k)

    def collected(phase, info):
        host["gc"].append((phase, info["generation"], now()))

    runner = bench.driver(cell)
    real_profiled = runner.Profiled

    class Linked(real_profiled):
        """The harness's profiled step, also keeping each device op's
        correlation with the host call that launched it."""

        def __exit__(self, *exc):
            prof = self._prof
            out = super().__exit__(*exc)
            launched, ops = {}, []
            for e in prof.profiler.kineto_results.events():
                if e.device_type() == self.ops_device:
                    ops.append((e.start_ns() / 1e3,
                                (e.start_ns() + e.duration_ns()) / 1e3,
                                e.name(), e.correlation_id()))
                else:
                    launched[e.correlation_id()] = e.start_ns() / 1e3
            host["launches"] = {"ops": ops, "host_us": launched}
            return out

    from torch.autograd import DeviceType

    Linked.ops_device = DeviceType.CUDA if torch.device(device).type == \
        "cuda" else DeviceType.CPU
    monitoring.Tracer, runner.Profiled = Kept, Linked
    if train_tracer:
        train_step.make_train_step = make
    gc.callbacks.append(collected)
    try:
        rec = runner.run(cell, seed, seconds, True, device)
    finally:
        monitoring.Tracer, train_step.make_train_step = real_tracer, \
            real_make
        runner.Profiled = real_profiled
        gc.callbacks.remove(collected)
    tracer = made[-1] if made else real_tracer(clock=now)
    # the engine's decode-graph counters, set-up included (the serving
    # harness hands its registry to the tracer)
    host["graphs"] = {name: tracer.metrics.counter(name).value()
                      for name in GRAPH_COUNTERS}
    host["ssm"] = {name: tracer.metrics.gauge(name).value()
                   for name in SSM_GAUGES}
    return rec, tracer.export(), host


def host_summary(rec: dict, export: dict, host: dict, n: int) -> dict:
    """The tracer's own host time a token step (``n``: token steps, or
    steps, of the window), the garbage collections inside the profiled
    step, and its longest idle gaps, each with the host span and the
    collection time it overlaps."""
    out = {"tracer_ms": {k: 1e3 * v / max(n, 1)
                         for k, v in host["tracer_s"].items()}}
    if any(host.get("graphs", {}).values()):
        out["graph_counters"] = host["graphs"]
    if any(host.get("ssm", {}).values()):
        out["ssm_gauges"] = host["ssm"]
    starts, every = {}, []
    for phase, gen, t in host["gc"]:
        if phase == "start":
            starts[gen] = t
        elif gen in starts:
            every.append((gen, starts.pop(gen), t))
    w0 = rec["window"]["t0"]
    w1 = max(s["t1"] for s in rec["steps"])
    by_gen: dict = {}
    for g, a, b in every:
        if w0 <= a < w1:
            c = by_gen.setdefault(g, [0, 0.0])
            c[0] += 1
            c[1] += 1e3 * (b - a)
    # collections in the window (count, ms) by generation
    out["gc_window"] = by_gen
    traced = [s for s in rec["steps"] if s["traced"]]
    if not traced or not rec.get("trace"):
        return out
    t0 = traced[0]["t0"]
    t1 = t0 + rec["trace"]["wall_s"]
    runs = [r for r in every if r[1] < t1 and r[2] > t0]
    out["gc_in_profiled"] = [[g, 1e3 * (a - t0), 1e3 * (b - a)]
                             for g, a, b in runs]
    ops = on_span_axis(rec["trace"]["ops"], export["anchor"])
    gaps = sorted(idle(ops, t0, t1), key=lambda g: g[0] - g[1])[:5]
    spans = within([s for s in export["spans"] if s["end"] is not None],
                   t0, t1)
    if host.get("launches") and any(s["cat"] == "model" for s in spans):
        out["profiled_model_ms"] = launched_by(
            spans, host["launches"], export["anchor"],
            max(traced[0].get("token_steps", 1), 1))
    out["longest_gaps"] = []
    for a, b in gaps:
        inner = [s for s in spans if s["start"] <= a and b <= s["end"]]
        where = min(inner, key=lambda s: s["end"] - s["start"])["name"] \
            if inner else "none"
        in_gc = total(intersect([(a, b)], union((x, y) for _, x, y in runs)))
        out["longest_gaps"].append([1e3 * (a - t0), 1e3 * (b - a), where,
                                    1e3 * in_gc])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--train-tracer", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("step_spans: needs a CUDA card", file=sys.stderr)
        return 2
    use_harness()
    from harness import spec

    rec, export, host = traced_run(spec.resolve(args.workload), args.seed,
                                   args.seconds,
                                   train_tracer=bool(args.train_tracer))
    summary = (serve_summary if rec["kind"] == "serve"
               else train_summary)(rec, export)
    n = summary.get("token_steps", summary.get("steps", 0))
    summary.update(host_summary(rec, export, host, n))
    summary.update(workload=args.workload, seed=args.seed,
                   device=torch.cuda.get_device_name(0))
    prof = summary.get("profiled", {})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"anchor": export["anchor"],
                       "spans": prof.get("spans", []),
                       "ops": (rec.get("trace") or {}).get("ops", [])}, f)
    prof.pop("spans", None)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
