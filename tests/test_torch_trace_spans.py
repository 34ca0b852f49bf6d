"""The port's spans inside an engine step and a train step
(``monitoring.trace``: device timing, clock anchor, span scopes), the
SLO series' chunk-amortised latency, the Chrome export's device lane, and
``scripts/step_spans.py``'s reading of spans against a device trace.

On the CPU no device event is recorded; the device-timing arithmetic runs
here on a fake event backend (``FakeEvents``) with a fake clock."""
import dataclasses
import itertools
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import RunConfig, get_reduced_config
from repro_torch.core.actshard import snapshot
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import single_device_mesh
from repro_torch.models.init import init_params
from repro_torch.monitoring import MetricsRegistry, Tracer
from repro_torch.monitoring import trace as T
from repro_torch.optim import OptimizerConfig, init_opt_state
from repro_torch.serving import DecodeEngine, Request
from repro_torch.training.train_step import make_train_step
from repro_torch.tree import tree_map

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import step_spans  # noqa: E402

CUDA = torch.device("cuda")
CHUNK = 3


@pytest.fixture(scope="module")
def tiny():
    torch.set_num_threads(1)
    cfg = dataclasses.replace(get_reduced_config("stablelm-3b"),
                              dtype="float32")
    return cfg, init_params(cfg, 0, device="cpu")


def _counting_clock():
    tick = itertools.count()
    return lambda: next(tick) * 1e-3


def _engine(cfg, params, tracer):
    eng = DecodeEngine(cfg, params, num_slots=2, cache_len=64,
                       decode_chunk=CHUNK, kv_page_size=16, tracer=tracer,
                       device="cpu")
    rng = np.random.default_rng(0)
    for i, n in enumerate((10, 21)):
        eng.submit(Request(rid=i, prompt=rng.integers(
            1, cfg.vocab_size, n).astype(np.int32), max_new_tokens=8))
    return eng


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.sid]


def _inside(s, p):
    return p.start <= s.start and s.end <= p.end


def test_engine_step_span_tree(tiny):
    """One fused step: ``step`` > ``admit`` (the PREFILL spans inside it,
    in time), ``pages``, ``decode_chunk`` > ``stage``/``launch``/``wait``,
    then ``book``, with the batch's make-up; no device times on the CPU."""
    cfg, params = tiny
    tr = Tracer(clock=_counting_clock())
    eng = _engine(cfg, params, tr)
    eng.step()
    spans = tr.spans()
    (step,) = [s for s in spans if s.name == "step"]
    assert step.parent is None and step.track == ("serving:engine", "step")
    assert [c.name for c in _children(spans, step)] == \
        ["admit", "pages", "decode_chunk", "book"]
    admit, pages, chunk, book = _children(spans, step)
    assert admit.attrs["admitted"] == 2
    prefills = [s for s in spans if s.name == "PREFILL"]
    assert len(prefills) == 2 and all(_inside(p, admit) for p in prefills)
    assert [c.name for c in _children(spans, chunk)] == \
        ["stage", "launch", "wait"]
    assert chunk.track == ("serving:engine", "dispatch")
    assert chunk.attrs == {"active": 2, "decode_tokens": CHUNK,
                           "live_lines": 10 + 21, "max_context": 21,
                           "table_width": 2, "tokens": 2 * CHUNK}
    # the JAX engine's decode_chunk ends at the sync; booking follows it
    assert chunk.end < book.start and _inside(book, step)
    assert all(s.device_start is None and s.device_end is None
               for s in spans)
    assert T.SPANS.get() is None


@pytest.mark.parametrize("where", ["token_step", "PREFILL"])
def test_one_attention_and_one_ffn_span_a_layer(tiny, where):
    """Each token step of ``decode_n`` holds one ``attention`` and one
    ``ffn`` span a layer, then ``sample``; each whole-prompt prefill one
    ``attention`` and one ``ffn`` a layer."""
    cfg, params = tiny
    tr = Tracer(clock=_counting_clock())
    eng = _engine(cfg, params, tr)
    eng.step()
    spans = tr.spans()
    outer = [s for s in spans if s.name == where]
    assert len(outer) == (CHUNK if where == "token_step" else 2)
    want = ["attention", "ffn"] * cfg.num_layers
    if where == "token_step":
        (launch,) = [s for s in spans if s.name == "launch"]
        assert all(s.parent == launch.sid for s in outer)
        want = want + ["sample"]
    for s in outer:
        kids = _children(spans, s)
        assert [k.name for k in kids] == want
        assert all(k.cat == "model" and _inside(k, s) for k in kids)


def _batch(cfg, rows=2, seq=16):
    g = torch.Generator().manual_seed(0)
    return {"tokens": torch.randint(0, cfg.vocab_size, (rows, seq),
                                    generator=g, dtype=torch.int32),
            "labels": torch.randint(0, cfg.vocab_size, (rows, seq),
                                    generator=g, dtype=torch.int32),
            "loss_mask": torch.ones(rows, seq)}


@pytest.mark.parametrize("remat", ["none", "layer"])
def test_train_step_spans(tiny, remat, monkeypatch):
    """``train_step`` > ``forward``/``backward``/``reduce``/``optimizer``
    (``grad_norm`` inside), and the kernel's recomputed backward
    (``_recompute_grads``) as one ``attention_bwd`` a layer under
    ``backward``, with and without layer recompute.  The kernel route
    runs on the CPU here with the plain attention in the kernel's place."""
    cfg, params = tiny
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops._fa, "flash_attention_bshd",
                        lambda q, k, v, window=None, **kw:
                        ref.attention_ref(q, k, v, window=window, **kw))
    tr = Tracer(clock=_counting_clock())
    opt = OptimizerConfig()
    step = make_train_step(cfg, RunConfig(use_kernels=True, remat=remat),
                           single_device_mesh(torch.device("cpu")), opt,
                           tracer=tr)
    p = tree_map(torch.clone, params)
    step(p, init_opt_state(p, opt), _batch(cfg))
    spans = tr.spans()
    (root,) = [s for s in spans if s.name == "train_step"]
    assert root.track == ("training", "step")
    kids = _children(spans, root)
    assert [k.name for k in kids] == ["forward", "backward", "reduce",
                                      "optimizer"]
    back, opt_span = kids[1], kids[3]
    bwd = _children(spans, back)
    assert [b.name for b in bwd] == ["attention_bwd"] * cfg.num_layers
    assert all(b.cat == "kernel" and _inside(b, back) for b in bwd)
    assert [c.name for c in _children(spans, opt_span)] == ["grad_norm"]
    assert T.SPANS.get() is None


def test_recompute_grads_span_scope_reaches_another_thread():
    """The span scope travels in ``core.actshard.snapshot`` (a recomputed
    body runs on autograd's device thread, where it is not set)."""
    tr = Tracer(clock=_counting_clock())
    seen = []
    with T.span_scope(tr, None, "train_step", cat="train",
                      track=("training", "step")) as sc:
        scopes = snapshot()

    def body():
        seen.append(T.SPANS.get())
        with scopes():
            seen.append(T.SPANS.get())

    t = threading.Thread(target=body)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert seen == [None, sc]


def test_layer_spans_record_no_device_event(tiny):
    """Under a scope timed on a CUDA device, a prefill's layer spans are
    host-only: the only events are the anchor and the root span's."""
    from repro_torch.models.model import prefill

    cfg, params = tiny
    tr, ev = _fake_tracer()
    with T.span_scope(tr, CUDA, "step", cat="step", track=("t", "t")):
        prefill(params, {"tokens": torch.ones(1, 8, dtype=torch.int32)},
                cfg, RunConfig())
    layers = tr.spans(cat="model")
    assert len(layers) == 2 * cfg.num_layers
    assert all(s._dev is None for s in layers) and ev.recorded == 3


def test_off_path_creates_no_span_and_no_event(tiny, monkeypatch):
    """With no tracer an engine step and a train step create no ``Span``
    and record no event."""
    cfg, params = tiny
    made = []

    class Counted(T.Span):
        def __init__(self, *a, **k):
            made.append(1)
            super().__init__(*a, **k)

    monkeypatch.setattr(T, "Span", Counted)
    monkeypatch.setattr(T.CudaEvents, "record",
                        lambda self, device: made.append(2))
    eng = _engine(cfg, params, None)
    eng.step()
    opt = OptimizerConfig()
    step = make_train_step(cfg, RunConfig(), single_device_mesh(
        torch.device("cpu")), opt)
    p = tree_map(torch.clone, params)
    step(p, init_opt_state(p, opt), _batch(cfg))
    assert made == []


class FakeEvents:
    """A device whose clock is ``now`` and whose work completes up to
    ``done_to``; an event records the device time it runs at."""

    def __init__(self):
        self.now, self.done_to, self.busy = 100.0, 0.0, False
        self.recorded = self.released = 0

    def record(self, device):
        self.recorded += 1
        return [self.now]

    def idle(self, device):
        return not self.busy

    def done(self, ev):
        return ev[0] <= self.done_to

    @staticmethod
    def seconds(a, b):
        return b[0] - a[0]

    def release(self, *evs):
        self.released += len(evs)


def _fake_tracer():
    tr = Tracer(clock=_counting_clock())
    tr.events = FakeEvents()
    return tr, tr.events


def test_anchor_and_resolve_on_a_fake_clock():
    """An idle stream anchors at the clock; device times are the anchor's
    clock reading plus the device time since the anchor event; a span
    whose work has not completed waits for a later resolve; a sync point
    resolves and re-anchors an idle stream (a busy one keeps its last
    anchor); a CPU device records nothing."""
    import time

    tr, ev = _fake_tracer()
    before = time.time_ns()
    clock, ns = tr.anchor()
    assert clock == 0.0 and before <= ns <= time.time_ns()
    a = tr.begin("a", device=CUDA)          # anchors at clock 1e-3
    _, t_anchor = a._dev[0]
    assert t_anchor == pytest.approx(2e-3)
    ev.now = 100.5
    tr.end(a)
    b = tr.begin("b", device=CUDA)
    ev.now = 101.25
    tr.end(b)
    ev.done_to = 100.5                      # a's work done, b's not yet
    assert tr.resolve() == 1
    assert (a.device_start, a.device_end) == (pytest.approx(t_anchor),
                                              pytest.approx(t_anchor + .5))
    assert b.device_start is None and tr._pending == [b]
    ev.busy = True
    tr.sync_point(CUDA)                     # busy: no new anchor
    assert tr._anchors[CUDA][1] == t_anchor
    ev.done_to, ev.busy = 200.0, False
    tr.sync_point(CUDA)                     # resolves b, re-anchors
    assert b.device_end == pytest.approx(t_anchor + 1.25)
    assert tr._anchors[CUDA][1] > t_anchor and ev.released == 4
    cpu = tr.begin("c", device=torch.device("cpu"))
    tr.end(cpu)
    assert cpu._dev is None and cpu.device_start is None
    assert ev.recorded == 6                 # 2 anchors + 2 spans x 2


def test_chrome_export_puts_device_times_on_a_device_lane(tmp_path):
    """Device-timed spans appear a second time on the ``("device",
    "stream")`` lane at their device times; events stay ordered; the
    clock anchor rides along; the file passes ``validate_trace``."""
    import validate_trace

    tr, ev = _fake_tracer()
    host = tr.begin("launch", track=("serving:engine", "dispatch"),
                    device=CUDA)
    ev.now = 100.004
    tr.end(host)
    plain = tr.begin("book", track=("serving:engine", "dispatch"))
    tr.end(plain)
    ev.done_to = 1e9
    path = tmp_path / "t.json"
    data = tr.export_chrome(str(path))
    assert validate_trace.validate(str(path)) == []
    lanes = {(e["pid"], e["tid"]): e["args"]["name"]
             for e in data["traceEvents"] if e["name"] == "thread_name"}
    xs = [e for e in data["traceEvents"] if e["ph"] == "X"]
    dev = [e for e in xs if lanes[(e["pid"], e["tid"])] == "stream"]
    assert [e["name"] for e in dev] == ["launch"]
    assert dev[0]["ts"] == pytest.approx(host.device_start * 1e6)
    assert dev[0]["dur"] == pytest.approx(4e3)
    assert dev[0]["args"]["span_sid"] == host.sid
    ts = [e["ts"] for e in data["traceEvents"] if e["ph"] != "M"]
    assert ts == sorted(ts)
    assert len(data["otherData"]["clock_anchor"]) == 2
    rec = tr.export()
    assert [s["name"] for s in rec["spans"]] == ["launch", "book"]
    assert rec["spans"][0]["device_end"] == host.device_end


@pytest.mark.parametrize("n", [1, 8])
def test_itl_counts_a_chunk_once_as_the_per_token_loop(n):
    """``SLORecorder.itl(.., n)`` leaves the histogram and attainment
    counters as ``n`` single-token reports did."""
    got, want = MetricsRegistry(), MetricsRegistry()
    T.SLORecorder(got).itl(0.3, "t", "normal", n=n)
    T.SLORecorder(got).itl(0.7, "t", "normal", n=n)
    ref_slo = T.SLORecorder(want)
    for seconds in (0.3, 0.7):
        for _ in range(n):
            ref_slo.itl(seconds, "t", "normal")
    h, hr = (r.histogram(T.METRIC_SERVE_ITL) for r in (got, want))
    assert h._counts == hr._counts
    assert h.sum(tenant="t", qos="normal") == pytest.approx(
        hr.sum(tenant="t", qos="normal"), rel=1e-12)
    for name in (T.METRIC_SLO_ITL_MET, T.METRIC_SLO_ITL_VIOLATIONS):
        assert got.counter(name).value(tenant="t", qos="normal") == \
            want.counter(name).value(tenant="t", qos="normal") == n


def test_step_spans_maps_ops_with_a_known_offset():
    """Profiler ops on the epoch axis land on the span axis by the
    anchor; idle time splits by the innermost host span."""
    anchor = (10.0, 1_700_000_000_000_000_000)     # clock 10 s <-> ns
    us0 = anchor[1] / 1e3
    ops = [(us0 + 1_000, us0 + 3_000, "k1"), (us0 + 6_000, us0 + 7_000,
                                              "k2")]
    mapped = step_spans.on_span_axis(ops, anchor)
    assert [(s, e) for s, e, _ in mapped] == [
        (pytest.approx(10.001), pytest.approx(10.003)),
        (pytest.approx(10.006), pytest.approx(10.007))]
    gaps = step_spans.idle(mapped, 10.0, 10.008)
    assert step_spans.total(gaps) == pytest.approx(0.005)
    split = step_spans.split_by(gaps, {
        "launch": [(10.0, 10.0045)], "book": [(10.004, 10.0075)],
        "step": [(10.0, 10.0075)]})
    assert split == {"launch": pytest.approx(0.0025),
                     "book": pytest.approx(0.002),
                     "step": pytest.approx(0.0), "none": pytest.approx(5e-4)}


def _span(name, start, end, cat="step", dev=None, sid=0, parent=None):
    return {"sid": sid, "parent": parent, "name": name, "cat": cat,
            "track": ["t", "t"], "start": start, "end": end,
            "device_start": dev[0] if dev else None,
            "device_end": dev[1] if dev else None, "attrs": {}}


def test_step_spans_serve_summary_adds_up():
    """``decode_launch_ms`` + ``wait`` + ``engine_host_ms`` per token step
    is the step less its prefills; model spans count by the call they
    ran in; ``idle_in_launch`` is the idle share under ``launch``; ops
    stay inside the ``step`` span and straddle no device time."""
    spans = [_span("step", 1.0, 1.1, sid=1),
             _span("admit", 1.0, 1.025, sid=13, parent=1),
             _span("PREFILL", 1.0, 1.02, "prefill", sid=2),
             _span("attention", 1.005, 1.01, "model", sid=3, parent=2),
             _span("launch", 1.03, 1.07, dev=(1.031, 1.08), sid=4),
             _span("token_step", 1.035, 1.065, "model", sid=5, parent=4),
             _span("attention", 1.04, 1.05, "model", dev=(1.05, 1.06),
                   sid=6, parent=5),
             _span("wait", 1.07, 1.08, sid=7),
             _span("step", 2.0, 2.1, sid=8), _span("launch", 2.0, 2.05,
                                                   sid=9),
             _span("token_step", 2.0, 2.05, "model", sid=10, parent=9),
             _span("attention", 2.0, 2.02, "model", dev=(2.045, 2.06),
                   sid=11, parent=10),
             _span("wait", 2.05, 2.06, sid=12)]
    rec = {"steps": [
        {"t0": 1.0, "t1": 1.1, "token_steps": 2, "traced": False,
         "prefill_s": 0.02},
        {"t0": 2.0, "t1": 2.1, "token_steps": 2, "traced": True,
         "prefill_s": 0.0}],
        "trace": {"ops": [(2_040_000.0, 2_045_000.0, "k1"),
                          (2_045_000.0, 2_060_000.0, "k2")],
                  "wall_s": 0.1}}
    out = step_spans.serve_summary(rec, {"anchor": (0.0, 0),
                                         "spans": spans})
    assert out["decode_step_ms"] == pytest.approx(40.0)
    assert out["decode_launch_ms"] == pytest.approx(20.0)
    assert out["wait_ms"] == pytest.approx(5.0)
    assert out["engine_host_ms"] == pytest.approx(15.0)
    assert out["sum_over_step"] == pytest.approx(1.0)
    assert out["engine_split_ms"]["admit"] == pytest.approx(2.5)
    assert out["engine_longest_ms"]["admit"] == pytest.approx(25.0)
    ms = out["model_host_ms"]
    assert ms == {"attention.decode": pytest.approx(5.0),
                  "attention.prefill": pytest.approx(2.5),
                  "token_step.decode": pytest.approx(15.0)}
    # ops by the span their launch call ran in: k1 from the attention
    # span, k2 from the token step outside it, k3 from no model span
    launches = {"ops": [(2_040_000.0, 2_045_000.0, "k1", 7),
                        (2_045_000.0, 2_060_000.0, "k2", 8),
                        (2_060_000.0, 2_061_000.0, "k3", 9)],
                "host_us": {7: 2_010_000.0, 8: 2_030_000.0,
                            9: 2_070_000.0}}
    got = step_spans.launched_by(spans[8:], launches, (0.0, 0), 2)
    assert got == {"attention.decode": [pytest.approx(10.0),
                                        pytest.approx(2.5)],
                   "token_step.decode": [pytest.approx(25.0),
                                         pytest.approx(7.5)],
                   "other": [0.0, pytest.approx(0.5)]}
    prof = out["profiled"]
    assert out["idle_in_launch"] == pytest.approx(40.0)   # 2.00-2.04
    assert prof["idle_by_span_s"]["step"] == pytest.approx(0.04)
    assert prof["stray_ms"] == 0.0 and prof["idle_covered"] == 1.0
    assert prof["device_cuts"] == 2 and prof["straddling_ops"] == 0


def test_step_spans_train_summary_sums_children():
    spans = [_span("train_step", 0.0, 1.0, "train"),
             _span("forward", 0.0, 0.3, "train", dev=(0.0, 0.3)),
             _span("backward", 0.3, 0.7, "train", dev=(0.3, 0.7)),
             _span("attention_bwd", 0.4, 0.5, "kernel", dev=(0.4, 0.5)),
             _span("reduce", 0.7, 0.7, "train", dev=(0.7, 0.7)),
             _span("optimizer", 0.7, 0.95, "train", dev=(0.7, 0.95)),
             _span("grad_norm", 0.7, 0.72, "train", dev=(0.7, 0.71))]
    rec = {"steps": [{"t0": 0.0, "t1": 1.0, "traced": False}],
           "trace": None}
    out = step_spans.train_summary(rec, {"anchor": (0.0, 0),
                                         "spans": spans})
    assert out["device_ms"]["backward"] == pytest.approx(400.0)
    assert out["device_ms"]["attention_bwd"] == pytest.approx(100.0)
    assert out["device_ms"]["grad_norm"] == pytest.approx(10.0)
    assert out["children_over_wall"] == pytest.approx(0.95)
