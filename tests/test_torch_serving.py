"""The PyTorch port's serving engine against the JAX ``DecodeEngine``, on
the CPU: per-request greedy outputs are identical with the same weights
and requests (reduced stablelm-3b in f32, dense and paged caches,
``decode_chunk=4``, bucketed prefill), QOS preemption resumes to the same
tokens, the per-token host loop (``fused=False``) gives the JAX host
loop's tokens and, traced on one counting clock, the JAX engine's spans,
temperature sampling follows its distribution, the CLI runs in every
serving mode, and a mesh that is not the port's ``launch.mesh.Mesh``
refuses loudly (tensor-parallel serving over the port's mesh is
``test_torch_tp_serving.py``'s).  The
prefix cache, chunked prefill and speculation have their own files
(``test_torch_prefix.py``, ``test_torch_chunked.py``,
``test_torch_speculative.py``)."""
import contextlib
import dataclasses
import io
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.models import init_params as jax_init_params
from repro.monitoring import Tracer as JaxTracer
from repro.serving import AdmissionController as JaxAdmission
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs import RunConfig, get_reduced_config
from repro_torch.models.model import sample_tokens
from repro_torch.monitoring import Tracer
from repro_torch.monitoring.metrics import METRIC_SERVE_PREEMPTIONS
from repro_torch.serving import AdmissionController, DecodeEngine, Request
from repro_torch.weights import params_from_jax


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_reduced("stablelm-3b"), dtype="float32")
    tcfg = dataclasses.replace(get_reduced_config("stablelm-3b"),
                               dtype="float32")
    jparams = jax_init_params(jcfg, 0)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def _specs(n=5, seed=3, vocab=512):
    rng = np.random.default_rng(seed)
    return [dict(rid=i,
                 prompt=rng.integers(0, vocab, 4 + 7 * i).astype(np.int32),
                 max_new_tokens=5 + 2 * i)
            for i in range(n)]


def _serve(engine, req_cls, specs):
    reqs = [req_cls(**s) for s in specs]
    for r in reqs:
        engine.submit(r)
    engine.run_to_completion()
    assert all(r.done for r in reqs)
    return [list(r.output) for r in reqs]


@pytest.mark.parametrize("page_size", [0, 16], ids=["dense", "paged"])
def test_greedy_outputs_identical_to_jax_engine(models, page_size):
    jcfg, tcfg, jparams, tparams = models
    kw = dict(num_slots=2, cache_len=64, decode_chunk=4,
              prefill_buckets="auto", kv_page_size=page_size)
    specs = _specs()
    ref = _serve(JaxEngine(jcfg, jparams, **kw), JaxRequest, specs)
    for use_kernels in (True, False):
        eng = DecodeEngine(tcfg, tparams, device="cpu",
                           run=RunConfig(use_kernels=use_kernels), **kw)
        assert _serve(eng, Request, specs) == ref, use_kernels
    assert [len(o) for o in ref] == [s["max_new_tokens"] for s in specs]


def test_paged_pool_pressure_requeues_like_jax(models):
    """A pool too small for both slots' growth: the starved slot requeues
    and resumes; outputs still match the JAX engine token for token."""
    jcfg, tcfg, jparams, tparams = models
    kw = dict(num_slots=2, cache_len=64, decode_chunk=4,
              prefill_buckets="auto", kv_page_size=16, kv_pages=6)
    specs = [dict(rid=i, prompt=np.arange(5 + i, 25 + i, dtype=np.int32),
                  max_new_tokens=30) for i in range(2)]
    jeng = JaxEngine(jcfg, jparams, **kw)
    ref = _serve(jeng, JaxRequest, specs)
    teng = DecodeEngine(tcfg, tparams, device="cpu", **kw)
    assert _serve(teng, Request, specs) == ref
    assert teng.allocator.high_water == jeng.allocator.high_water
    assert teng.allocator.in_use == 0


def _preemption_run(engine_cls, req_cls, admission_cls, cfg, params, **kw):
    ctrl = admission_cls()
    ctrl.add_tenant("research", shares=1)
    ctrl.add_tenant("prod", shares=10)
    eng = engine_cls(cfg, params, num_slots=2, cache_len=64,
                     admission=ctrl, decode_chunk=4, **kw)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
               for _ in range(3)]
    scavs = [req_cls(rid=i, prompt=prompts[i], max_new_tokens=16,
                     tenant="research", qos="scavenger") for i in range(2)]
    for r in scavs:
        eng.submit(r)
    eng.step()
    hi = req_cls(rid=2, prompt=prompts[2], max_new_tokens=4, tenant="prod",
                 qos="high")
    eng.submit(hi)
    eng.step()
    eng.run_to_completion()
    return eng, scavs + [hi]


def test_qos_preemption_resumes_like_jax(models):
    jcfg, tcfg, jparams, tparams = models
    jeng, jreqs = _preemption_run(JaxEngine, JaxRequest, JaxAdmission,
                                  jcfg, jparams)
    teng, treqs = _preemption_run(DecodeEngine, Request, AdmissionController,
                                  tcfg, tparams, device="cpu")
    assert teng.metrics.counter(METRIC_SERVE_PREEMPTIONS).value() == 1
    assert [r.preemptions for r in treqs] == [r.preemptions for r in jreqs]
    assert sum(r.preemptions for r in treqs) == 1
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert all(r.done for r in treqs)


def test_sample_tokens_follows_the_softmax():
    """Temperature sampling cannot match JAX's threefry bits; it must
    match the distribution softmax(logits / t).  50k draws put the
    empirical frequencies within 0.01 of it (>5 standard deviations)."""
    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, 3.0, 0.2, -0.5])
    n, t = 50_000, 0.7
    temps = torch.full((n,), t)
    temps[:10] = 0.0                                  # greedy rows
    out = sample_tokens(gen, logits.expand(n, -1), temps)
    assert (out[:10] == 5).all()
    freq = torch.bincount(out[10:].long(), minlength=8).double() / (n - 10)
    want = torch.softmax(logits.double() / t, dim=0)
    assert (freq - want).abs().max() < 0.01


def test_temperature_requests_sample_and_finish(models):
    _, tcfg, _, tparams = models
    eng = DecodeEngine(tcfg, tparams, num_slots=2, cache_len=64,
                       decode_chunk=4, device="cpu", seed=5)
    reqs = [Request(rid=i, prompt=np.arange(3, 11, dtype=np.int32),
                    max_new_tokens=12, temperature=1.0) for i in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert all(r.done and len(r.output) == 12 for r in reqs)
    # same prompt, independent noise: the two streams diverge
    assert reqs[0].output != reqs[1].output
    assert all(0 <= t < tcfg.vocab_size for r in reqs for t in r.output)


@pytest.mark.parametrize("option", [dict(mesh=object())])
def test_later_slices_refuse_loudly(models, option):
    _, tcfg, _, tparams = models
    with pytest.raises(NotImplementedError):
        DecodeEngine(tcfg, tparams, device="cpu", **option)


def test_default_device_is_cuda_and_never_falls_back(models, monkeypatch):
    _, tcfg, _, tparams = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(tcfg, tparams)


MODE_FLAGS = {
    "dense": [], "paged": ["--kv-paging", "16"],
    "prefix": ["--prefix-cache", "--shared-prefix", "16"],
    "budgeted": ["--max-batch-tokens", "32"],
    "speculative": ["--speculate", "2"],
}


@pytest.mark.parametrize("extra", list(MODE_FLAGS.values()),
                         ids=list(MODE_FLAGS))
def test_cli_cpu_smoke(extra):
    from repro_torch.launch import serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--reduced", "--device", "cpu", "--requests", "3",
                         "--max-new", "4", "--cache-len", "64",
                         "--tenants", "a:2,b:1", "--qos", "high,scavenger"]
                        + extra)
    text = out.getvalue()
    assert rc == 0
    # the decode loop counts 3 of each request's 4 tokens: the first comes
    # from the prefill, as in the JAX CLI
    assert "served 3 requests, 9 tokens" in text
    assert "decode p50" in text and "per-tenant tokens" in text
    # the serving modes imply 16-line pages, as the JAX CLI's do
    assert ("paged KV: 16-line pages" in text) == bool(extra)
    assert ("implies --kv-paging" in text) == (
        bool(extra) and extra[0] != "--kv-paging")
    assert ("prefix cache: " in text) == ("--prefix-cache" in extra)
    assert ("chunked prefill: budget 32" in text) == \
        ("--max-batch-tokens" in extra)
    assert ("speculative decoding: k=2" in text) == ("--speculate" in extra)


# ------------------------------------------------ host loop and tracing ----

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


def _host_run(cls, req_cls, adm_cls, tracer_cls, cfg, params, page_size):
    """The trace test's preemption scenario (``tests/test_trace.py``) on
    the per-token host loop, traced on a counting clock."""
    rng = np.random.default_rng(7)
    tracer = tracer_cls(clock=_fake_clock())
    ctrl = adm_cls(tracer=tracer)
    ctrl.add_tenant("research", shares=1)
    ctrl.add_tenant("prod", shares=10)
    kw = {"device": "cpu"} if cls is DecodeEngine else {}
    eng = cls(cfg, params, num_slots=2, cache_len=64, admission=ctrl,
              tracer=tracer, fused=False, kv_page_size=page_size, **kw)
    scavs = [req_cls(rid=i, prompt=rng.integers(0, cfg.vocab_size, 8).astype(
        np.int32), max_new_tokens=16, tenant="research", qos="scavenger")
        for i in range(2)]
    for r in scavs:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    hi = req_cls(rid=2, prompt=rng.integers(0, cfg.vocab_size, 8).astype(
        np.int32), max_new_tokens=4, tenant="prod", qos="high")
    eng.submit(hi)
    eng.run_to_completion()
    reqs = scavs + [hi]
    assert all(r.done for r in reqs)
    return ([r.output for r in reqs], [r.preemptions for r in reqs]), tracer


@pytest.fixture(scope="module")
def host_ref(models):
    jcfg, _, jparams, _ = models
    return _host_run(JaxEngine, JaxRequest, JaxAdmission, JaxTracer, jcfg,
                     jparams, 16)


@pytest.mark.parametrize("page_size", [0, 16], ids=["dense", "paged"])
def test_host_loop_identical_to_jax(models, host_ref, page_size):
    """``fused=False``: one decode step and one host sample per token; the
    greedy outputs and the preemption are the JAX host loop's (paged; the
    JAX engine's dense and paged host loops give the same tokens)."""
    _, tcfg, _, tparams = models
    (got, _) = _host_run(DecodeEngine, Request, AdmissionController, Tracer,
                         tcfg, tparams, page_size)
    assert got == host_ref[0]
    assert sum(got[1]) == 1


def test_host_loop_trace_matches_jax(models, host_ref):
    """One request trace with two DECODE spans around PREEMPT/RESUME, the
    QUEUED/PREFILL/DECODE spans and SLO series of the reference test — the
    same record as the JAX engine's, span for span, on one clock (stamps
    compared by rank)."""
    _, tcfg, _, tparams = models
    _, tracer = _host_run(DecodeEngine, Request, AdmissionController, Tracer,
                          tcfg, tparams, 16)
    cats = _cats(host_ref[1])
    rec = _trace_record(tracer, cats)
    assert rec == _trace_record(host_ref[1], cats)
    (victim,) = [r for r in rec if r[0].startswith("request")
                 and any(e[0] == "PREEMPT" for e in r[7])]
    decodes = [r for r in rec if r[0] == "DECODE" and r[2] == victim[2]]
    assert len(decodes) == 2 and decodes[0][6]["stop"] == "PREEMPT"
    marks = [e[0] for e in victim[7]]
    assert marks[0] == "SUBMIT" and marks[-1] == "FINISH"
    assert {"QUEUED", "PREFILL", "DECODE"} <= {r[0] for r in rec}
    ttft = tracer.metrics.histogram("serve_ttft_seconds")
    assert ttft.count(tenant="research", qos="scavenger") == 2
