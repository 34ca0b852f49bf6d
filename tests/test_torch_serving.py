"""The PyTorch port's serving engine against the JAX ``DecodeEngine``, on
the CPU: per-request greedy outputs are identical with the same weights
and requests (reduced stablelm-3b in f32, dense and paged caches,
``decode_chunk=4``, bucketed prefill), QOS preemption resumes to the same
tokens, temperature sampling follows its distribution, the CLI runs, and
the options of later slices refuse loudly."""
import contextlib
import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.models import init_params as jax_init_params
from repro.serving import AdmissionController as JaxAdmission
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs import RunConfig, get_reduced_config
from repro_torch.models.model import sample_tokens
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


@pytest.mark.parametrize("option", [
    dict(prefix_cache=True), dict(max_batch_tokens=64), dict(speculate=2),
    dict(fused=False), dict(mesh=object()), dict(tracer=object())])
def test_later_slices_refuse_loudly(models, option):
    _, tcfg, _, tparams = models
    with pytest.raises(NotImplementedError):
        DecodeEngine(tcfg, tparams, device="cpu", **option)


def test_default_device_is_cuda_and_never_falls_back(models, monkeypatch):
    _, tcfg, _, tparams = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(tcfg, tparams)


@pytest.mark.parametrize("extra", [[], ["--kv-paging", "16"]],
                         ids=["dense", "paged"])
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
    assert ("paged KV: 16-line pages" in text) == bool(extra)
