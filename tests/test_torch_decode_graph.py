"""The CUDA graph of ``decode_n``'s token step (``models.model.DecodeGraphs``)
on the CPU: the rule that picks graph or eager, the captured unit's wiring
through a CPU stand-in for capture and replay held to eager ``decode_n``
token for token and state for state, and the decode kernels' counter
buffer, which a captured graph keeps writing to.  The graphs themselves
run on the card (``chip_smoke.py``'s serve phase)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import RunConfig, get_reduced_config
from repro_torch.core.actshard import (
    collectives_scoped, param_use_scope, tp_reduce_scope, tp_train_scope,
)
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops
from repro_torch.models.init import init_params
from repro_torch.models.model import (
    DecodeGraphs, cast_for_compute, decode_n, graph_eligible, init_cache,
)
from repro_torch.models.paging import PagedKVConfig
from repro_torch.monitoring import MetricsRegistry, Tracer
from repro_torch.monitoring.metrics import (
    METRIC_SERVE_DECODE_EAGER_STEPS, METRIC_SERVE_DECODE_GRAPH_CAPTURES,
    METRIC_SERVE_DECODE_GRAPH_REPLAYS,
)
from repro_torch.serving import DecodeEngine, Request

CACHE_LEN = 64
PAGE = 16
B = 5


@pytest.fixture(scope="module")
def tiny():
    torch.set_num_threads(1)
    cfg = dataclasses.replace(get_reduced_config("stablelm-3b"),
                              dtype="float32")
    params = cast_for_compute(init_params(cfg, 0, device="cpu"),
                              torch.float32)
    return cfg, params


class CpuReplay(DecodeGraphs):
    """The store with a stand-in for capture and replay on the CPU: a
    key's first token step runs eagerly, each replay runs the same static
    step again."""

    def _first(self, st):
        st.step()
        st.replay = st.step


def _count(store, name) -> float:
    return store.metrics.counter(name).value()


# ------------------------------------------------------------ the rule ----

@pytest.mark.parametrize("device,collectives,grad,want", [
    ("cpu", False, False, False),
    ("meta", False, False, False),
    ("cuda", True, False, False),          # a tp rank's reduction scope
    ("cuda", False, True, False),
    ("cuda", False, False, True),          # one rank, on the card
])
def test_graph_eligible(device, collectives, grad, want):
    assert graph_eligible(torch.device(device), collectives, grad) is want


@pytest.mark.parametrize("scope", ["tp_reduce", "tp_train", "param_use",
                                   "none"])
def test_collectives_scoped(scope):
    """An engine whose tp scope is active (and a training plan or a ZeRO-3
    gather) puts a collective in reach of the model code."""
    ctx = {"tp_reduce": lambda: tp_reduce_scope(None, True, True),
           "tp_train": lambda: tp_train_scope(object()),
           "param_use": lambda: param_use_scope(lambda t, w: t),
           "none": None}[scope]
    if ctx is None:
        assert not collectives_scoped()
        return
    with ctx():
        assert collectives_scoped()
    assert not collectives_scoped()


def test_cpu_engine_runs_eagerly_and_counts_it(tiny):
    """A CPU engine's fused chunks run eagerly: no capture, no replay,
    every token step counted eager, ``launch`` not graphed."""
    cfg, params = tiny
    tr = Tracer()
    eng = DecodeEngine(cfg, params, num_slots=2, cache_len=CACHE_LEN,
                       decode_chunk=3, kv_page_size=PAGE, tracer=tr,
                       device="cpu")
    rng = np.random.default_rng(0)
    for i, n in enumerate((10, 21)):
        eng.submit(Request(rid=i, prompt=rng.integers(
            1, cfg.vocab_size, n).astype(np.int32), max_new_tokens=8))
    eng.step()
    eng.step()
    g = eng.graphs
    assert _count(g, METRIC_SERVE_DECODE_EAGER_STEPS) == 6
    assert _count(g, METRIC_SERVE_DECODE_GRAPH_CAPTURES) == 0
    assert _count(g, METRIC_SERVE_DECODE_GRAPH_REPLAYS) == 0
    launches = tr.spans(name="launch")
    assert len(launches) == 2
    assert all(s.attrs == {"graphed": False, "replayed": 0}
               for s in launches)


# ----------------------------------------------------- the captured unit ----

def _state(cfg, paged: bool, seed: int = 0):
    """A cache holding random lines and lanes that, over a chunk, hit EOS
    (lane 1, set later), reach their boundary (lane 2: its page ``limit``,
    or the dense cache's end), run out of ``remaining`` (lane 3), or are
    dead from the start (lane 4); lane 0 samples at T = 0.8."""
    g = torch.Generator().manual_seed(seed)
    paging = PagedKVConfig(page_size=PAGE, num_pages=1 + B * 4,
                           pages_per_seq=CACHE_LEN // PAGE) if paged else None
    cache = init_cache(cfg, B, CACHE_LEN, device="cpu", paging=paging)
    for leaf in cache["layers"]:
        for t in leaf.values():
            t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    pos = [10, 20, 30 if paged else CACHE_LEN - 2, 5, 12]
    lanes = dict(
        token=torch.randint(1, cfg.vocab_size, (B,), generator=g,
                            dtype=torch.int32),
        pos=torch.tensor(pos, dtype=torch.int32),
        remaining=torch.tensor([40, 40, 40, 2, 40], dtype=torch.int32),
        done=torch.tensor([False, False, False, False, True]),
        eos=torch.full((B,), -1, dtype=torch.int32),
        temps=torch.tensor([0.8, 0, 0, 0, 0], dtype=torch.float32))
    return cache, lanes


def _tables(paged: bool):
    """Per call: (page_table, limit) — a 2-page table (lane 2's limit at 32
    lines), then the whole 4-page one; the dense cache has none."""
    if not paged:
        return [(None, None), (None, None)]
    rows = torch.arange(B * 4, dtype=torch.int32).reshape(B, 4) + 1
    rows[4] = 0                                     # the dead lane: null
    first = (rows[:, :2].contiguous(),
             torch.tensor([64, 64, 32, 64, 64], dtype=torch.int32))
    return [first, (rows, torch.full((B,), CACHE_LEN, dtype=torch.int32))]


def _chunks(cfg, params, cache, lanes, tables, n, graphs):
    """Two ``decode_n`` calls in a row, the second from the first's
    lanes; returns each call's outputs and the generator."""
    gen = torch.Generator().manual_seed(7)
    lane = [lanes[k] for k in ("token", "pos", "remaining", "done")]
    outs = []
    run = RunConfig(use_kernels=True)
    with torch.no_grad():
        for table, limit in tables:
            toks, cache, *lane = decode_n(
                params, cache, *lane, lanes["eos"], lanes["temps"], gen, cfg,
                run, n, CACHE_LEN, page_table=table, limit=limit,
                graphs=graphs)
            outs.append((toks, *lane))
    return outs, gen


@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_static_step_matches_decode_n(tiny, layout, n, monkeypatch):
    """The static-buffer token step, replayed ``n`` times a call through
    the CPU stand-in (lanes copied in once, the results written back,
    each emitted token copied into its column) equals eager ``decode_n``
    token for token and state for state: outputs, lanes, the cache and
    the generator, over two calls (the paged table widens between them:
    a second key)."""
    cfg, params = tiny
    paged = layout == "paged"
    tables = _tables(paged)
    cache, lanes = _state(cfg, paged)
    probe, _ = _chunks(cfg, params, _clone(cache), lanes, tables[:1], n,
                       None)
    lanes["eos"][1] = probe[0][0][1, n // 2]        # lane 1 stops on EOS
    want_cache = _clone(cache)
    want, want_gen = _chunks(cfg, params, want_cache, lanes, tables, n, None)
    store = CpuReplay(MetricsRegistry())
    # the stand-in replays on the CPU, as the card's graphs replay there
    monkeypatch.setattr("repro_torch.models.model.graph_eligible",
                        lambda *a: True)
    got, got_gen = _chunks(cfg, params, cache, lanes, tables, n, store)
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            assert a.dtype == b.dtype and torch.equal(a, b)
    for lw, lg in zip(want_cache["layers"], cache["layers"]):
        for k in lw:
            assert torch.equal(lw[k], lg[k])
    assert torch.equal(want_gen.get_state(), got_gen.get_state())
    # every stop rule fired in the reference run
    done = want[-1][4]
    assert bool(done[1]) and bool(done[3]) and bool(done[4])
    assert int(want[-1][2][2]) == (31 if paged else CACHE_LEN - 1)
    keys = 2 if paged else 1
    assert _count(store, METRIC_SERVE_DECODE_GRAPH_CAPTURES) == keys
    assert _count(store, METRIC_SERVE_DECODE_EAGER_STEPS) == keys
    assert _count(store, METRIC_SERVE_DECODE_GRAPH_REPLAYS) == 2 * n - keys
    assert store.replayed == (n - 1 if paged else n)


def _clone(cache):
    return {"layers": [{k: v.clone() for k, v in leaf.items()}
                       for leaf in cache["layers"]]}


# ------------------------------------------------------------- kernels ----

def test_counter_buffer_never_shrinks_or_moves():
    """A key already handed a counter buffer never gets a smaller or moved
    one while it is large enough; a larger key gets a new buffer, and the
    old one stays alive for a graph that captured it."""
    dev = torch.device("cpu")
    saved = fd._counters.pop(dev, None), list(fd._retired)
    try:
        a = fd._counter(dev, 8)
        assert fd._counter(dev, 4) is a and fd._counter(dev, 8) is a
        ptr = a.data_ptr()
        b = fd._counter(dev, 16)
        assert b is not a and b.numel() >= 16 and not b.any()
        assert any(t is a for t in fd._retired) and a.data_ptr() == ptr
        assert fd._counter(dev, 8) is b and fd._counter(dev, 16) is b
    finally:
        fd._counters.pop(dev, None)
        if saved[0] is not None:
            fd._counters[dev] = saved[0]
        fd._retired[:] = saved[1]


def test_replays_add_their_captures_launches():
    """A capture's launches come off the counters (nothing ran); each
    replay adds them back."""
    before = ops.launch_counts()
    step = {"flash_decode_paged": 2, "flash_attention": 0}
    ops.add_launch_counts(step)                # what the capture counted
    ops.add_launch_counts(step, -1)
    assert ops.launch_counts() == before
    ops.add_launch_counts(step, 5)
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: 10 if k == "flash_decode_paged" else 0 for k in before}
    ops.add_launch_counts(step, -5)


# ---------------------------------------------------------- step_spans ----

def test_step_spans_reports_a_graphed_chunk():
    """A chunk replayed from graphs is its ``launch`` span, ``graphed``,
    with no layer spans under it: ``step_spans`` counts it, gives the
    replayed share of the window's token steps, and says there is no
    layer split instead of reporting an empty one."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    import step_spans

    def span(name, start, end, sid, parent=None, **attrs):
        return {"sid": sid, "parent": parent, "name": name, "cat": "step",
                "track": ["t", "t"], "start": start, "end": end,
                "device_start": None, "device_end": None, "attrs": attrs}

    spans = [span("step", 1.0, 1.1, 1),
             span("launch", 1.0, 1.02, 2, 1, graphed=True, replayed=7),
             span("wait", 1.02, 1.09, 3, 1),
             span("step", 2.0, 2.1, 4),
             span("launch", 2.0, 2.02, 5, 4, graphed=True, replayed=8),
             span("wait", 2.02, 2.09, 6, 4)]
    rec = {"steps": [{"t0": 1.0, "t1": 1.1, "token_steps": 8,
                      "traced": False, "prefill_s": 0.0},
                     {"t0": 2.0, "t1": 2.1, "token_steps": 8,
                      "traced": False, "prefill_s": 0.0}]}
    out = step_spans.serve_summary(rec, {"anchor": (0.0, 0),
                                         "spans": spans})
    assert out["graphed_chunks"] == 2
    assert out["replayed_share"] == pytest.approx(15 / 16)
    assert out["layer_split"] == "no layer split under replay"
    assert out["model_host_ms"] == {}
    assert out["decode_launch_ms"] == pytest.approx(40 / 16)
