"""The port's token-budgeted chunked prefill, per-token host loop and
request tracer against the JAX package, on the CPU, with the same weights
(reduced stablelm-3b in f32): the scenarios of ``tests/test_chunked.py`` (budgets 1, 8 and 13 — chunks that
start and end mid-page — the prefix-cache combination, a short prompt's
first token landing while a long one is mid-prefill, preemption
mid-prefill at a chunk boundary) with per-request greedy outputs
identical to the JAX engine's, and the tracer on the budgeted path: the
same spans, in the same order, with the same attributes and events as the
JAX engine's when both run on one counting clock.  ``prefill_chunk`` at
the model level is in ``test_torch_prefix.py`` (it is the suffix prefill
at an unaligned start)."""
import dataclasses
import itertools

import jax
import numpy as np
import pytest

from repro.configs import get_reduced_config as jax_reduced
from repro.models import init_params as jax_init_params
from repro.monitoring import Tracer as JaxTracer
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_reduced_config
from repro_torch.monitoring import Tracer
from repro_torch.monitoring.metrics import METRIC_SERVE_PREFIX_HITS
from repro_torch.serving import DecodeEngine, Request
from repro_torch.weights import params_from_jax


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_reduced("stablelm-3b"), dtype="float32")
    tcfg = dataclasses.replace(get_reduced_config("stablelm-3b"),
                               dtype="float32")
    jparams = jax_init_params(jcfg, 0)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def _engine(cls, cfg, params, **kw):
    if cls is DecodeEngine:
        kw["device"] = "cpu"
    kw.setdefault("num_slots", 2)
    kw.setdefault("cache_len", 64)
    return cls(cfg, params, kv_page_size=8, **kw)


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert all(r.done for r in reqs), [(r.rid, r.done) for r in reqs]
    return {r.rid: list(r.output) for r in reqs}


def _reqs(cls, vocab, n=4, seed=3):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, 4 + 5 * i).astype(
        np.int32), max_new_tokens=6 + i) for i in range(n)]


def _hol_reqs(cls):
    return [cls(rid=10, prompt=np.arange(48, dtype=np.int32) % 50,
                max_new_tokens=4),
            cls(rid=11, prompt=np.arange(5, dtype=np.int32),
                max_new_tokens=8)]


# ------------------------------------------------------- engine level ----

@pytest.mark.parametrize("budget", [1, 8, 13])
def test_chunked_greedy_identical_to_jax(models, budget):
    """Budgets of 1 (one-token chunks), 8 (page-aligned chunks) and 13
    (8/4/1 buckets: chunks start and end mid-page): per-request greedy
    outputs and the serve-step counters are the JAX engine's at the same
    budget; every prompt token goes through a chunk, in power-of-two
    buckets no larger than the budget.  (With f32 compute and the bf16
    cache, chunked and whole-prompt prefill may round a prefix line
    differently, in either package, so the reference is the JAX engine in
    the same mode.)"""
    jcfg, tcfg, jparams, tparams = models
    jeng = _engine(JaxEngine, jcfg, jparams, max_batch_tokens=budget)
    ref = _run(jeng, _reqs(JaxRequest, jcfg.vocab_size))
    reqs = _reqs(Request, tcfg.vocab_size)
    eng = _engine(DecodeEngine, tcfg, tparams, max_batch_tokens=budget)
    assert _run(eng, reqs) == ref
    assert eng.serve_stats == jeng.serve_stats
    st = eng.serve_stats
    assert st["prefill_tokens"] == sum(len(r.prompt) for r in reqs)
    assert st["prefill_chunks"] >= len(reqs) and st["iterations"] >= 1
    assert eng.chunk_lengths <= set(eng.chunk_buckets)
    assert max(eng.chunk_buckets) <= budget
    assert eng.allocator.in_use == 0


def _prefix_combo(cls, req_cls, cfg, params, **kw):
    rng = np.random.default_rng(9)
    shared = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    rng2 = np.random.default_rng(4)
    reqs = [req_cls(rid=i, prompt=np.concatenate(
        [shared, rng2.integers(0, cfg.vocab_size, 3 + 5 * i).astype(
            np.int32)]), max_new_tokens=5) for i in range(3)]
    eng = _engine(cls, cfg, params, **kw)
    out = _run(eng, reqs)
    return out, int(eng.metrics.counter(METRIC_SERVE_PREFIX_HITS).value()), \
        dict(eng.serve_stats)


def test_chunked_identical_with_prefix_cache(models):
    """Budgeted admission with the radix prefix cache: a partial starts
    with the shared pages mapped and only the suffix goes through chunks
    — outputs, hits and chunk counters as the JAX engine's."""
    jcfg, tcfg, jparams, tparams = models
    kw = dict(prefix_cache=True, max_batch_tokens=8)
    got = _prefix_combo(DecodeEngine, Request, tcfg, tparams, **kw)
    assert got == _prefix_combo(JaxEngine, JaxRequest, jcfg, jparams, **kw)
    assert got[1] >= 1


def test_short_first_token_lands_mid_long_prefill(models):
    """A short prompt's first token comes while a long prompt is still
    mid-prefill; both finish with the JAX engine's outputs."""
    jcfg, tcfg, jparams, tparams = models
    ref = _run(_engine(JaxEngine, jcfg, jparams, max_batch_tokens=16),
               _hol_reqs(JaxRequest))
    long, short = _hol_reqs(Request)
    eng = _engine(DecodeEngine, tcfg, tparams, max_batch_tokens=16)
    eng.submit(long)
    eng.submit(short)
    saw = False
    for _ in range(100):
        n = eng.step()
        if short.output and not long.done:
            part = next((p for p in eng._partials if p.req is long), None)
            saw |= part is not None and part.pos_filled < len(long.prompt)
        if n == 0:
            break
    assert saw, "short waited for the long's whole prefill"
    assert long.done and short.done
    assert [long.output, short.output] == [ref[10], ref[11]]


def _fake_clock():
    tick = itertools.count()
    return lambda: next(tick) * 1e-3


#: attributes of the port's ``decode_chunk`` spans beyond the JAX engine's
MAKEUP = ("decode_tokens", "live_lines", "max_context", "table_width")

def _trace_record(tracer, cats):
    """The completed spans of the categories ``cats`` (those the JAX
    engine writes), in completion order: name, category, track, the
    nearest compared ancestor's name, attributes and events, with every
    stamp replaced by its rank among the compared spans' stamps.  The
    port's own spans (its engine step and layers, outside ``cats``) read
    the clock too, which shifts the stamps but not their order.  The
    batch's make-up that the port adds to ``decode_chunk`` is set aside
    (``MAKEUP``)."""
    spans = tracer.spans()
    every = {s.sid: s for s in spans + tracer.open_spans()}
    kept = [s for s in spans if s.cat in cats]
    stamps = sorted({t for s in kept
                     for t in (s.start, s.end, *(e.ts for e in s.events))})
    rank = {t: i for i, t in enumerate(stamps)}

    def ancestor(s):
        p = every.get(s.parent)
        while p is not None and p.cat not in cats:
            p = every.get(p.parent)
        return None if p is None else p.name

    return [(s.name, s.cat, s.track, ancestor(s), rank[s.start],
             rank[s.end],
             {k: v for k, v in s.attrs.items() if k not in MAKEUP},
             [(e.name, rank[e.ts], e.attrs) for e in s.events])
            for s in kept]


def _cats(jax_tracer):
    return {s.cat for s in jax_tracer.spans() + jax_tracer.open_spans()}


def _mid_prefill_run(cls, req_cls, tracer_cls, cfg, params):
    scav = req_cls(rid=0, prompt=np.arange(56, dtype=np.int32) % 50,
                   max_new_tokens=4, qos="scavenger")
    hi = req_cls(rid=1, prompt=np.arange(96, dtype=np.int32) % 50,
                 max_new_tokens=4, qos="high")
    tracer = tracer_cls(clock=_fake_clock())
    eng = _engine(cls, cfg, params, cache_len=128, kv_pages=17,
                  max_batch_tokens=16, tracer=tracer)
    eng.submit(scav)
    eng.step()
    eng.step()                      # scav mid-prefill (32/56 tokens)
    assert eng._partials and not scav.done
    eng.submit(hi)                  # its pages and scav's can't coexist
    eng.run_to_completion()
    assert scav.done and hi.done
    return ([scav.output, hi.output], [scav.preemptions, hi.preemptions],
            eng.admission.stats["requeues"], dict(eng.serve_stats)), tracer


@pytest.fixture(scope="module")
def mid_prefill(models):
    jcfg, tcfg, jparams, tparams = models
    return (_mid_prefill_run(DecodeEngine, Request, Tracer, tcfg, tparams),
            _mid_prefill_run(JaxEngine, JaxRequest, JaxTracer, jcfg,
                             jparams))


def test_preempt_mid_prefill_round_trips_like_jax(mid_prefill):
    """A scavenger preempted mid-prefill requeues at a chunk boundary and
    replays its prompt: outputs, preemptions, requeues and chunk counters
    as the JAX engine's."""
    (got, _), (ref, _) = mid_prefill
    assert got == ref
    assert got[1][0] >= 1 and got[2] >= 1


def test_budgeted_trace_matches_jax(mid_prefill):
    """Chunked PREFILL spans (chunks, pos_filled, aborted on preemption),
    ADMIT/PREEMPT/RESUME events, decode-call spans and the SLO series: the
    same record as the JAX engine's on one counting clock (stamps compared
    by rank; the port's decode calls also carry the batch's make-up)."""
    (_, tracer), (_, jtracer) = mid_prefill
    cats = _cats(jtracer)
    rec = _trace_record(tracer, cats)
    assert rec == _trace_record(jtracer, cats)
    chunks = tracer.spans(name="decode_chunk")
    assert chunks and all(set(MAKEUP) <= set(s.attrs) for s in chunks)
    prefills = [r for r in rec if r[0] == "PREFILL"]
    assert any(r[6].get("aborted") for r in prefills)
    assert all(r[6].get("chunked") for r in prefills)
    assert not tracer.open_spans()


def test_budgeted_mode_requires_paging_and_fused(models):
    _, tcfg, _, tparams = models
    with pytest.raises(ValueError, match="kv_page_size"):
        DecodeEngine(tcfg, tparams, num_slots=2, cache_len=64,
                     max_batch_tokens=32, device="cpu")
    with pytest.raises(ValueError, match="fused"):
        DecodeEngine(tcfg, tparams, num_slots=2, cache_len=64,
                     kv_page_size=8, fused=False, max_batch_tokens=32,
                     device="cpu")
