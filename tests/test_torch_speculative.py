"""The port's speculative decoding against the JAX package, on the CPU, with
the same weights (reduced stablelm-3b in f32): ``verify_tokens`` logits
and pool writes within 1e-5 of JAX's, the acceptance rules and the n-gram
machinery (copies) giving JAX's results on the same inputs, and the
scenarios of ``tests/test_speculative.py`` — greedy outputs identical to
the JAX engine's for k in {1, 2, 4}, with the same rounds, proposals and
acceptances as the JAX engine at k = 2, under budgeted batching, with the
prefix cache indexing generated pages, with the draft model (given the
JAX draft's weights: the same proposals and acceptances as the JAX
engine), with an oracle draft accepting everything, EOS inside an
accepted run, and a starvation requeue.  Temperature cannot follow JAX's
threefry stream: the rejection sampler is held to the target distribution
by frequency, and a sampled speculative run to finishing in vocabulary."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_reduced_config as jax_reduced
from repro.models import init_params as jax_init_params
from repro.models import model as JM
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import spec as JS
from repro_torch.configs import RunConfig, get_reduced_config
from repro_torch.models import model as TM
from repro_torch.serving import DecodeEngine, Request
from repro_torch.serving import spec as TS
from repro_torch.weights import params_from_jax


def _models(arch):
    jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
    tcfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
    jparams = jax_init_params(jcfg, 0)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def models():
    return _models("stablelm-3b")


@pytest.fixture(scope="module", params=("stablelm-3b", "musicgen-large"))
def arch_models(request):
    """The model-level case's configs: rotary positions, and sinusoidal
    positions with a GELU MLP (musicgen-large)."""
    return _models(request.param)


def _repeat_reqs(cls, vocab, n=3, seed=3, **kw):
    """Repeat-heavy prompts (a base phrase looped) so prompt-lookup
    drafting has material to match."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        base = rng.integers(0, vocab, 6).astype(np.int32)
        out.append(cls(rid=i, prompt=np.concatenate([base] * 3),
                       max_new_tokens=12 + i, **kw))
    return out


def _engine(cls, cfg, params, **kw):
    if cls is DecodeEngine:
        kw["device"] = "cpu"
    return cls(cfg, params, num_slots=2, cache_len=64, kv_page_size=8, **kw)


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert all(r.done for r in reqs), [(r.rid, r.done) for r in reqs]
    return {r.rid: list(r.output) for r in reqs}


def _stats(eng):
    st = eng.spec_stats
    return {k: st[k] for k in ("rounds", "proposed", "accepted", "emitted",
                               "proposed_by")}


@pytest.fixture(scope="module")
def plain_engine(models):
    """The JAX engine without speculation, and its outputs on the
    repeat-heavy requests."""
    jcfg, _, jparams, _ = models
    eng = _engine(JaxEngine, jcfg, jparams)
    return eng, _run(eng, _repeat_reqs(JaxRequest, jcfg.vocab_size))


@pytest.fixture(scope="module")
def plain_ref(plain_engine):
    return plain_engine[1]


@pytest.fixture(scope="module")
def spec2_ref(models):
    """The JAX engine speculating 2 tokens with the n-gram source."""
    jcfg, _, jparams, _ = models
    eng = _engine(JaxEngine, jcfg, jparams, speculate=2)
    return _run(eng, _repeat_reqs(JaxRequest, jcfg.vocab_size)), _stats(eng)


# ------------------------------------------------------- model level ----

def test_verify_tokens_matches_jax(arch_models):
    """Three positions per slot in one call: logits within 1e-5 of JAX's
    and the pool after the in-place writes equal to the JAX cache it
    returns (lines past slot 1's allocation land on the null page)."""
    jcfg, tcfg, jparams, tparams = arch_models
    rng = np.random.default_rng(4)
    ps, S = 8, 3
    shape = (tcfg.num_layers, 10, ps, tcfg.num_kv_heads, tcfg.head_dim)
    pool = {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}
    table = np.array([[3, 1, 6, 0], [2, 5, 0, 0]], np.int32)
    pos0 = np.array([17, 14], np.int32)
    pages = np.array([[6, 6, 6], [5, 5, 0]], np.int32)
    offs = np.array([[1, 2, 3], [6, 7, 0]], np.int32)
    toks = rng.integers(0, tcfg.vocab_size, (2, S)).astype(np.int32)
    jl, jc = JM.verify_tokens(
        jparams, {"layers": [{n: jnp.asarray(v) for n, v in pool.items()}]},
        jnp.asarray(toks), jnp.asarray(pos0), jnp.asarray(pages),
        jnp.asarray(offs), jnp.asarray(table), jcfg,
        JaxRunConfig(remat="none"))
    tc = {"layers": [{n: torch.from_numpy(v.copy()) for n, v in pool.items()}]}
    tl, tc = TM.verify_tokens(
        tparams, tc, torch.from_numpy(toks), torch.from_numpy(pos0),
        torch.from_numpy(pages), torch.from_numpy(offs),
        torch.from_numpy(table), tcfg, RunConfig(use_kernels=True))
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["layers"][0][name].numpy(),
                                   np.asarray(jc["layers"][0][name]), **tol)


# ---------------------------------------------- acceptance and drafts ----

def test_acceptance_rules_follow_jax():
    """The copied rules on the same inputs and the same numpy streams."""
    t = np.array([5, 6, 7, 8])
    for d in ([5, 6, 7], [5, 9, 7], [9, 6, 7], []):
        d = np.array(d, np.int32)
        assert list(TS.greedy_accept(t[:len(d) + 1], d)) == \
            list(JS.greedy_accept(t[:len(d) + 1], d))
    rng_p = np.random.default_rng(0)
    probs = rng_p.dirichlet(np.ones(6), size=4)
    drafts = np.array([1, 4, 0], np.int32)
    a, b = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(200):
        assert list(TS.rejection_sample(a, probs, drafts)) == \
            list(JS.rejection_sample(b, probs, drafts))


def test_rejection_sample_preserves_distribution():
    """Each emitted token's marginal is the target row's distribution."""
    rng = np.random.default_rng(0)
    p = np.array([[0.7, 0.2, 0.1]])
    counts = np.zeros(3)
    for _ in range(4000):
        counts[TS.rejection_sample(rng, np.vstack([p, p]),
                                   np.array([0]))[0]] += 1
    assert np.allclose(counts / 4000, p[0], atol=0.03)


def test_ngram_sources_follow_jax():
    """Own-context n-grams with the self-match fallback, and the
    cross-request index with its capacity, on one random token stream."""
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 6, 80).astype(np.int32)
    t_src = TS.NgramDraftSource(index=TS.NgramIndex(capacity=20))
    j_src = JS.NgramDraftSource(index=JS.NgramIndex(capacity=20))
    for src in (t_src, j_src):
        src.observe(toks[40:])
        src.begin(0, toks[:5])
    for i in range(5, 40, 3):
        assert list(t_src.draft(0, 4)) == list(j_src.draft(0, 4)), i
        t_src.advance(0, toks[i:i + 3])
        j_src.advance(0, toks[i:i + 3])
    assert len(t_src.index) == len(j_src.index) <= 20
    assert TS._SlotNgrams((3, 2), [1, 2, 3]).match(4) is None


# ------------------------------------------------------- engine level ----

@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_greedy_identical_to_jax(models, plain_ref, spec2_ref, k):
    """Greedy output equals plain decoding's at any draft length, as the
    JAX engine's does; at k = 2 the rounds, proposals and acceptances are
    the JAX engine's too."""
    _, tcfg, _, tparams = models
    eng = _engine(DecodeEngine, tcfg, tparams, speculate=k)
    got = _run(eng, _repeat_reqs(Request, tcfg.vocab_size))
    assert got == plain_ref == spec2_ref[0]
    st = eng.spec_stats
    assert st["rounds"] > 0 and 0 <= st["accepted"] <= st["proposed"]
    assert st["proposed_by"].get("ngram", 0) == st["proposed"]
    if k == 2:
        assert _stats(eng) == spec2_ref[1]


def test_spec_identical_under_budgeted_batching(models, plain_ref):
    """Lanes cost k+1 budget tokens; the verify runs beside the head
    prefill chunk."""
    _, tcfg, _, tparams = models
    eng = _engine(DecodeEngine, tcfg, tparams, speculate=2,
                  max_batch_tokens=16)
    assert _run(eng, _repeat_reqs(Request, tcfg.vocab_size)) == plain_ref
    assert eng.spec_stats["rounds"] > 0


def test_spec_with_prefix_cache_indexes_generated_pages(models, plain_ref):
    """With the prefix cache, finished requests' generated tokens are
    indexed: a later request whose prompt is request 0's prompt plus its
    output reuses pages marked as generated."""
    _, tcfg, _, tparams = models
    eng = _engine(DecodeEngine, tcfg, tparams, speculate=2,
                  prefix_cache=True)
    reqs = _repeat_reqs(Request, tcfg.vocab_size)
    assert _run(eng, reqs) == plain_ref
    seq = np.concatenate([reqs[0].prompt, np.asarray(plain_ref[0], np.int32)])
    _run(eng, [Request(rid=9, prompt=seq, max_new_tokens=4)])
    assert eng.prefix.generated_hits > 0


def test_spec_model_draft_matches_jax(models):
    """The draft model with the JAX draft's weights: the same outputs and
    the same proposals and acceptances as the JAX engine's draft."""
    jcfg, tcfg, jparams, tparams = models
    jeng = _engine(JaxEngine, jcfg, jparams, speculate=2,
                   spec_source="model")
    ref = _run(jeng, _repeat_reqs(JaxRequest, jcfg.vocab_size))
    dcfg = TS.draft_config(tcfg)
    # the JAX config's fields; the port's own (the attention offset and
    # the muP scalars) at their defaults
    jd = JS.draft_config(jcfg)
    shared = {f.name for f in dataclasses.fields(jd)}
    mine = dataclasses.asdict(dcfg)
    assert {k: mine[k] for k in shared} == dataclasses.asdict(jd)
    assert all(getattr(dcfg, f.name) == f.default
               for f in dataclasses.fields(dcfg) if f.name not in shared)
    dparams = params_from_jax(jax.tree.map(
        np.asarray, jax_init_params(JS.draft_config(jcfg), 0)))
    eng = _engine(DecodeEngine, tcfg, tparams, speculate=2,
                  spec_source="model")
    assert isinstance(eng.spec, TS.ModelDraftSource)
    eng.spec = TS.ModelDraftSource(dcfg, 2, 64, params=dparams, run=eng.run,
                                   device="cpu")
    assert _run(eng, _repeat_reqs(Request, tcfg.vocab_size)) == ref
    assert _stats(eng) == _stats(jeng)
    assert eng.spec_stats["proposed_by"]["model"] > 0


def test_spec_oracle_draft_full_accept(models, plain_ref):
    """The target as its own draft: every proposal accepted, through the
    full-accept catch-up of draft k-1's KV line."""
    _, tcfg, _, tparams = models
    eng = _engine(DecodeEngine, tcfg, tparams, speculate=3,
                  spec_source="model")
    eng.spec = TS.ModelDraftSource(tcfg, 2, 64, params=tparams, run=eng.run,
                                   device="cpu")
    assert _run(eng, _repeat_reqs(Request, tcfg.vocab_size)) == plain_ref
    st = eng.spec_stats
    assert st["proposed"] > 0 and st["accepted"] == st["proposed"]


def test_spec_eos_mid_accepted_run(models, plain_engine):
    """EOS inside an accepted run stops the request there, as the JAX
    engine's plain decoding does (the JAX engine of ``plain_ref``, idle
    again, serves the requests with an EOS)."""
    jcfg, tcfg, _, tparams = models
    jeng, plain_ref = plain_engine
    eos = plain_ref[2][len(plain_ref[2]) // 2]
    ref = _run(jeng, _repeat_reqs(JaxRequest, jcfg.vocab_size, eos_id=eos))
    assert any(len(ref[r]) < len(plain_ref[r]) for r in ref)
    eng = _engine(DecodeEngine, tcfg, tparams, speculate=4)
    assert _run(eng, _repeat_reqs(Request, tcfg.vocab_size,
                                  eos_id=eos)) == ref


def test_spec_starvation_requeue_round_trip(models, plain_ref):
    """Pool pressure starves a speculating request; it requeues with its
    draft state released, resumes, and ends with the plain outputs."""
    _, tcfg, _, tparams = models
    eng = _engine(DecodeEngine, tcfg, tparams, kv_pages=8, speculate=2)
    assert _run(eng, _repeat_reqs(Request, tcfg.vocab_size)) == plain_ref
    assert eng.metrics.counter("serve_page_starvations").value() >= 1


def test_spec_temperature_requests_finish(models):
    """Sampled lanes go through rejection sampling (numpy, as the JAX
    engine) of the draft model's proposals: every request finishes with
    its token count, in the vocabulary."""
    _, tcfg, _, tparams = models
    eng = _engine(DecodeEngine, tcfg, tparams, speculate=2, seed=3,
                  spec_source="model")
    reqs = _repeat_reqs(Request, tcfg.vocab_size, temperature=0.8)
    out = _run(eng, reqs)
    assert [len(out[r.rid]) for r in reqs] == [r.max_new_tokens for r in reqs]
    assert all(0 <= t < tcfg.vocab_size for o in out.values() for t in o)
    assert eng.spec_stats["rounds"] > 0


def test_speculate_requires_paging_and_fused(models):
    _, tcfg, _, tparams = models
    with pytest.raises(ValueError, match="kv[-_]paging"):
        DecodeEngine(tcfg, tparams, num_slots=2, cache_len=64, speculate=2,
                     device="cpu")
    with pytest.raises(ValueError, match="fused"):
        DecodeEngine(tcfg, tparams, num_slots=2, cache_len=64,
                     kv_page_size=8, fused=False, speculate=2, device="cpu")
    with pytest.raises(ValueError, match="spec_source"):
        DecodeEngine(tcfg, tparams, num_slots=2, cache_len=64,
                     kv_page_size=8, speculate=2, spec_source="psychic",
                     device="cpu")
