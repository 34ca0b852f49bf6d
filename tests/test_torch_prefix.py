"""The port's prefix cache against the JAX package, on the CPU: the suffix
prefill at the model level (``prefill_suffix`` logits and KV lines at a
page-aligned and a mid-page ``start``, within 1e-5 in f32, and
``prefill_chunk``, the same call at an unaligned start; the bf16
two-region combine of ``attention_prefill_paged``), the radix index on
the same operations, and the engine on the scenarios of
``tests/test_prefix.py`` — per-request greedy outputs and prefix counters
identical to the JAX engine's with the same weights (reduced stablelm-3b
in f32), shared pages never written, LRU eviction under pressure, billing
amortized over holders, the preempted victim resuming through the cache,
and no livelock when the match is the only eviction fodder.

The preempted-victim scenario is held to the JAX engine's own outputs:
the reference test's claim that they equal a solo run does not hold on
this tree (the JAX test fails), and the port must do what the JAX engine
does."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_reduced_config as jax_reduced
from repro.models import attention as JA
from repro.models import init_params as jax_init_params
from repro.models import model as JM
from repro.models.paging import PageAllocator as JaxAllocator
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import PrefixCache as JaxPrefixCache
from repro.serving import Request as JaxRequest
from repro_torch.configs import RunConfig, get_reduced_config
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.paging import PageAllocator
from repro_torch.monitoring.metrics import (
    METRIC_SERVE_PREFIX_EVICTIONS, METRIC_SERVE_PREFIX_HITS,
    METRIC_SERVE_PREFIX_MISSES, METRIC_SERVE_PREFIX_REUSED_TOKENS,
)
from repro_torch.serving import (
    AdmissionController, DecodeEngine, PrefixCache, Request,
)
from repro_torch.weights import params_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)


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
    """The model-level cases' configs: rotary positions, and sinusoidal
    positions with a GELU MLP (musicgen-large)."""
    return _models(request.param)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().cpu().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


# ------------------------------------------------------- model level ----

def _pools(cfg, num_pages, ps, rng, dtype=np.float32):
    """The same random pool contents on both sides (f32 unless asked:
    see ``tests/test_torch_model.py::_decode_both``)."""
    G = cfg.num_layers
    shape = (G, num_pages, ps, cfg.num_kv_heads, cfg.head_dim)
    jc, tc = {"layers": []}, {"layers": []}
    lay_j, lay_t = {}, {}
    for name in ("k", "v"):
        x = rng.standard_normal(shape).astype(dtype)
        lay_j[name] = jnp.asarray(x)
        lay_t[name] = torch.from_numpy(x.copy())
    jc["layers"].append(lay_j)
    tc["layers"].append(lay_t)
    return jc, tc


@pytest.mark.parametrize("start", [16, 13], ids=["page-aligned", "mid-page"])
def test_prefill_suffix_matches_jax(arch_models, start):
    """Suffix logits and the suffix's KV lines match JAX within 1e-5 for a
    prefix that ends on a page boundary and one that ends inside a page
    (the line-granular prefix mask); the pool is not written."""
    jcfg, tcfg, jparams, tparams = arch_models
    rng = np.random.default_rng(5)
    ps, S = 8, 11
    jc, tc = _pools(tcfg, 9, ps, rng)
    pool_before = tc["layers"][0]["k"].clone()
    # the prefix lives in pages 4, 7 (and 2 for a mid-page start); the
    # row's last entry is null, as a bucketed row's tail is
    table = np.array([[4, 7, 2, 0]], np.int32)
    toks = rng.integers(0, tcfg.vocab_size, (1, S)).astype(np.int32)
    jl, jslices = JM.prefill_suffix(
        jparams, {"tokens": jnp.asarray(toks)}, jc, jnp.asarray(table),
        jnp.asarray(start, jnp.int32), jcfg, JaxRunConfig(remat="none"),
        last_pos=jnp.asarray(S - 3, jnp.int32))
    tl, tslices = TM.prefill_suffix(
        tparams, {"tokens": torch.from_numpy(toks)}, tc,
        torch.from_numpy(table), start, tcfg, RunConfig(use_kernels=True),
        last_pos=S - 3)
    _close(tl, jl)
    for jlay, tlay in zip(jslices["layers"], tslices["layers"]):
        for name in ("k", "v"):
            assert tlay[name].shape[2] == S
            _close(tlay[name], jlay[name])
    assert torch.equal(tc["layers"][0]["k"], pool_before)
    # a chunk of a chunked prefill is this call at an unaligned start
    cl, _ = TM.prefill_chunk(tparams, {"tokens": torch.from_numpy(toks)},
                             tc, torch.from_numpy(table), start, tcfg,
                             RunConfig(), last_pos=S - 3)
    assert torch.equal(cl, tl)


class _RoundEachRegion:
    """``torch`` as the attention module sees it, except that each
    region's partial sum is rounded to bf16 before the two are added: the
    double rounding that the single final cast avoids, planted to show
    that the check on the combined heads tells the two apart."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def einsum(spec, *ops):
        out = torch.einsum(spec, *ops)
        if spec == "bkgqs,bskd->bqkgd":
            out = out.to(torch.bfloat16).to(out.dtype)
        return out


def test_prefill_paged_bf16_combine(models, monkeypatch):
    """bf16: the two regions' partial sums are taken in f32 and cast once.

    Read before out_proj, the port's combined heads are within one bf16
    ulp of each of JAX's values; a planted variant that rounds each
    region's partial sum to bf16 before adding fails that check.  Set
    from these readings on the CPU: the port equals JAX in all 2304
    values; the variant differs in 35% of them, 107 by more than one ulp
    (up to 222 ulps where the regions cancel), at most 2^-7 absolute —
    so an absolute tolerance of 2^-7 after out_proj could not see it.
    After out_proj the port stays within one bf16 rounding of JAX's
    output (atol/rtol 2^-7) and within bf16 tolerance (2e-2) of the same
    attention in f32."""
    _, tcfg, _, tparams = models
    rng = np.random.default_rng(7)
    cfg16 = dataclasses.replace(tcfg, dtype="bfloat16")
    p = tparams["layers"][0]["attn"]
    p_np = {k: v[0].numpy() for k, v in p.items()}
    ps, S, start = 8, 9, 21
    x = rng.standard_normal((1, S, tcfg.d_model)).astype(np.float32)
    shape = (5, ps, tcfg.num_kv_heads, tcfg.head_dim)
    pool = {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}
    table = np.array([[2, 4, 1, 0]], np.int32)

    def port(dt):
        tp = {k: torch.from_numpy(v).to(dt) for k, v in p_np.items()}
        to, _ = TA.attention_prefill_paged(
            tp, torch.from_numpy(x).to(dt),
            {n: torch.from_numpy(v).to(dt) for n, v in pool.items()},
            torch.from_numpy(table), start, cfg16)
        return to.float().numpy()

    def reference(jdt, fn):
        jp = {k: jnp.asarray(v).astype(jdt) for k, v in p_np.items()}
        jo, _ = fn(jp, jnp.asarray(x).astype(jdt),
                   {n: jnp.asarray(v).astype(jdt) for n, v in pool.items()},
                   jnp.asarray(table), jnp.asarray(start, jnp.int32), cfg16)
        return np.asarray(jo, np.float32)

    jit = jax.jit(JA.attention_prefill_paged, static_argnums=5)
    t16, j16 = port(torch.bfloat16), reference(jnp.bfloat16, jit)
    t32, j32 = port(torch.float32), reference(jnp.float32, jit)
    np.testing.assert_allclose(t32, j32, **TOL)
    np.testing.assert_allclose(t16, j16, atol=2 ** -7, rtol=2 ** -7)
    np.testing.assert_allclose(t16, t32, atol=2e-2, rtol=2e-2)

    # the combined heads, read before out_proj on both sides (JAX eager,
    # so that no traced function keeps the stand-in)
    monkeypatch.setattr(TA, "out_proj", lambda p, o: o)
    monkeypatch.setattr(JA, "out_proj", lambda p, o: o)
    heads = reference(jnp.bfloat16, JA.attention_prefill_paged)
    one_ulp = np.ldexp(1.0, np.frexp(heads)[1] - 8)
    assert (np.abs(port(torch.bfloat16) - heads) <= one_ulp).all()
    monkeypatch.setattr(TA, "torch", _RoundEachRegion())
    assert not (np.abs(port(torch.bfloat16) - heads) <= one_ulp).all()


# -------------------------------------------------------- radix index ----

def _toks(*blocks, ps=4):
    out = []
    for b in blocks:
        out.extend(b * 10 + i for i in range(ps))
    return np.asarray(out, np.int32)


def test_radix_index_follows_jax_operation_for_operation():
    """The copied index against the JAX one on one sequence of inserts,
    matches, pins and LRU evictions over a tight pool: the same pages,
    counts and refcounts after every operation."""
    sides = []
    for alloc_cls, cache_cls in ((JaxAllocator, JaxPrefixCache),
                                 (PageAllocator, PrefixCache)):
        a = alloc_cls(12)
        sides.append((a, cache_cls(a, page_size=4)))
    rng = np.random.default_rng(8)
    held = [[], []]
    for step in range(60):
        kind = int(rng.integers(0, 3))
        blocks = [int(b) for b in rng.integers(0, 4, int(rng.integers(1, 4)))]
        toks = np.concatenate([_toks(*blocks), _toks(9)[:1]])
        want = int(rng.integers(1, 4))
        seen = []
        for side, (a, pc) in enumerate(sides):
            if kind == 0:                  # admit: match, pin, alloc
                shared = pc.acquire(pc.match(toks))
                need = -(-len(toks) // 4) - len(shared)
                priv = a.alloc(need)
                if priv is None and pc.evict(need - a.available()):
                    priv = a.alloc(need)
                if priv is None:
                    if shared:
                        a.free(shared)
                else:
                    pc.insert(toks, shared + priv)
                    held[side].append(shared + priv)
            elif kind == 1 and held[side]:  # a holder leaves
                a.free(held[side].pop(0))
            else:
                pc.evict(want)
            seen.append((a.available(), a.in_use, a.total_refs, pc.nodes,
                         pc.evictable_pages(),
                         [n.page for n in pc.match(toks)],
                         [a.refcount(p) for p in range(12)]))
        assert seen[0] == seen[1], step


# --------------------------------------------------------- engine level ----

def _shared_specs(vocab, n=4, sys_len=40, tail=6, max_new=6, **kw):
    rng = np.random.default_rng(11)
    system = rng.integers(2, vocab, sys_len).astype(np.int32)
    return [dict(rid=i,
                 prompt=np.concatenate(
                     [system, rng.integers(2, vocab, tail).astype(np.int32)]),
                 max_new_tokens=max_new, **kw)
            for i in range(n)]


def _engine(cls, cfg, params, **kw):
    kw.setdefault("prefill_buckets", (16, 32, 64))
    kw.setdefault("num_slots", 2)
    if cls is DecodeEngine:
        kw["device"] = "cpu"
    return cls(cfg, params, cache_len=64, decode_chunk=4, kv_page_size=8,
               **kw)


def _serve(eng, req_cls, specs):
    reqs = [req_cls(**s) for s in specs]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert all(r.done for r in reqs)
    return [list(r.output) for r in reqs]


def _counters(eng):
    m = eng.metrics
    return [int(m.counter(name).value()) for name in (
        METRIC_SERVE_PREFIX_HITS, METRIC_SERVE_PREFIX_MISSES,
        METRIC_SERVE_PREFIX_REUSED_TOKENS, METRIC_SERVE_PREFIX_EVICTIONS)]


@pytest.fixture(scope="module")
def shared_ref(models):
    """The JAX engine with the prefix cache on the shared-prompt workload
    (4 requests behind a 40-token system prompt, 8-line pages)."""
    jcfg, _, jparams, _ = models
    eng = _engine(JaxEngine, jcfg, jparams, prefix_cache=True)
    out = _serve(eng, JaxRequest, _shared_specs(jcfg.vocab_size))
    return out, eng


def test_prefix_reuse_identical_to_jax_and_counted(models, shared_ref):
    """Greedy outputs, hit/miss/reused counters, cached pages and pool
    occupancy as the JAX engine's; the outputs also equal the port's own
    run without reuse."""
    _, tcfg, _, tparams = models
    ref, jeng = shared_ref
    specs = _shared_specs(tcfg.vocab_size)
    eng = _engine(DecodeEngine, tcfg, tparams, prefix_cache=True)
    assert _serve(eng, Request, specs) == ref
    assert _counters(eng) == _counters(jeng) == [3, 1, 120, 0]
    assert eng.prefix.nodes == jeng.prefix.nodes == 5
    assert eng.allocator.in_use == jeng.allocator.in_use == 5
    assert eng.prefix.evictable_pages() == 5
    assert eng._page_holders == {}
    plain = _engine(DecodeEngine, tcfg, tparams)
    assert _serve(plain, Request, specs) == ref


def test_prefix_reuse_exact_length_prefill(models, shared_ref):
    """Without buckets (exact-length suffix prefill) the first two requests
    come out as in the JAX run (greedy decode does not depend on the
    requests beside it)."""
    _, tcfg, _, tparams = models
    ref, _ = shared_ref
    eng = _engine(DecodeEngine, tcfg, tparams, prefix_cache=True,
                  prefill_buckets=None)
    assert _serve(eng, Request, _shared_specs(tcfg.vocab_size, n=2)) == \
        ref[:2]
    assert eng.metrics.counter(METRIC_SERVE_PREFIX_HITS).value() == 1


def test_shared_pages_are_never_written(models):
    """Copy-on-write safety with an in-place pool: decode and suffix
    prefill never write through a read-only shared mapping — the cached
    pages' lines are byte-identical before and after sharing requests
    run."""
    _, tcfg, _, tparams = models
    specs = _shared_specs(tcfg.vocab_size, n=1)
    eng = _engine(DecodeEngine, tcfg, tparams, prefix_cache=True)
    _serve(eng, Request, specs)
    cached = [n.page for n in eng.prefix.match(
        np.concatenate([specs[0]["prompt"], np.zeros(9, np.int32)]))]
    assert len(cached) == 5
    idx = torch.tensor(cached)
    before = [lay[n][:, idx].clone() for lay in eng.cache["layers"]
              for n in ("k", "v")]
    _serve(eng, Request, _shared_specs(tcfg.vocab_size, n=3, max_new=10))
    assert eng.metrics.counter(METRIC_SERVE_PREFIX_HITS).value() >= 3
    after = [lay[n][:, idx] for lay in eng.cache["layers"]
             for n in ("k", "v")]
    for b, a in zip(before, after):
        assert torch.equal(b, a)


def _lru_run(cls, req_cls, cfg, params):
    rng = np.random.default_rng(3)
    eng = _engine(cls, cfg, params, num_slots=1, kv_pages=9,
                  prefill_buckets=(32, 64), prefix_cache=True)
    a = req_cls(rid=0, prompt=rng.integers(2, cfg.vocab_size, 24).astype(
        np.int32), max_new_tokens=4)
    eng.submit(a)
    eng.run_to_completion()
    nodes_a = eng.prefix.nodes
    b = req_cls(rid=1, prompt=rng.integers(2, cfg.vocab_size, 50).astype(
        np.int32), max_new_tokens=4)
    eng.submit(b)                          # needs 7 pages; only 5 free
    eng.run_to_completion()
    assert a.done and b.done
    return [a.output, b.output], nodes_a, eng


def test_prefix_lru_eviction_under_pressure_like_jax(models):
    """A full pool whose pages only the index holds yields to a new
    request: cached prefixes LRU-evict (counted), with the JAX engine's
    outputs, evictions and cached pages."""
    jcfg, tcfg, jparams, tparams = models
    ref, jnodes, jeng = _lru_run(JaxEngine, JaxRequest, jcfg, jparams)
    got, nodes, eng = _lru_run(DecodeEngine, Request, tcfg, tparams)
    assert got == ref and nodes == jnodes == 3
    assert _counters(eng) == _counters(jeng)
    assert eng.metrics.counter(METRIC_SERVE_PREFIX_EVICTIONS).value() >= 1
    assert eng.prefix.nodes == jeng.prefix.nodes


def test_shared_residency_bills_once_across_holders(models):
    """With two live holders every shared page bills 1/2 to each, so the
    tenant's raw gres/kv_page use is well below the no-reuse run's."""
    _, tcfg, _, tparams = models

    def ledger(prefix_cache):
        ctrl = AdmissionController()
        specs = _shared_specs(tcfg.vocab_size, n=2, max_new=8, tenant="acct")
        reqs = [Request(**s) for s in specs]
        eng = _engine(DecodeEngine, tcfg, tparams, admission=ctrl,
                      prefix_cache=prefix_cache)
        for r in reqs:
            eng.submit(r)
        eng._admit()                       # both prefilled, none decoded
        if prefix_cache:
            shared = [n.page for n in eng.prefix.match(
                np.concatenate([reqs[0].prompt, np.zeros(9, np.int32)]))]
            assert all(eng._page_holders[p] == 2 for p in shared)
        eng.run_to_completion()
        return ctrl.tree.tres_usage_of("acct")["gres/kv_page"]

    assert ledger(True) < 0.75 * ledger(False)


def _victim_run(cls, req_cls, cfg, params):
    rng = np.random.default_rng(9)
    prompt = rng.integers(2, cfg.vocab_size, 24).astype(np.int32)
    scav = req_cls(rid=0, prompt=prompt, max_new_tokens=24, tenant="a",
                   qos="scavenger")
    hi = req_cls(rid=1, prompt=prompt.copy(), max_new_tokens=24,
                 tenant="b", qos="high")
    eng = _engine(cls, cfg, params, num_slots=1, prefill_buckets=(32, 64),
                  prefix_cache=True)
    eng.submit(scav)
    eng.step()
    eng.submit(hi)                         # evicts scav from the only slot
    eng.run_to_completion()
    assert scav.done and hi.done
    return ([scav.output, hi.output], [scav.preemptions, hi.preemptions],
            _counters(eng))


def test_preempted_victim_resumes_through_prefix_cache_like_jax(models):
    """A scavenger victim's resume prefill re-matches the cached prompt;
    the outputs, preemptions and prefix counters are the JAX engine's
    (not the reference test's solo-run equality, which the JAX engine
    itself does not meet on this tree)."""
    jcfg, tcfg, jparams, tparams = models
    ref = _victim_run(JaxEngine, JaxRequest, jcfg, jparams)
    got = _victim_run(DecodeEngine, Request, tcfg, tparams)
    assert got == ref
    assert got[1][0] >= 1 and got[2][0] >= 1


def _livelock_run(cls, req_cls, cfg, params):
    rng = np.random.default_rng(21)
    base = rng.integers(2, cfg.vocab_size, 24).astype(np.int32)
    eng = cls(cfg, params, num_slots=2, cache_len=64, decode_chunk=2,
              kv_page_size=8, kv_pages=9, prefill_buckets=(32, 64),
              prefix_cache=True,
              **({"device": "cpu"} if cls is DecodeEngine else {}))
    seed = req_cls(rid=0, prompt=base, max_new_tokens=2)
    eng.submit(seed)
    eng.run_to_completion()                # the index holds base's 3 pages
    hog = req_cls(rid=1, prompt=rng.integers(
        2, cfg.vocab_size, 8).astype(np.int32), max_new_tokens=40)
    eng.submit(hog)
    eng.step()                             # hog runs, pinning free pages
    big = req_cls(rid=2, prompt=np.concatenate(
        [base, rng.integers(2, cfg.vocab_size, 24).astype(np.int32)]),
        max_new_tokens=2)
    eng.submit(big)                        # needs 6 pages; matches 3
    for _ in range(300):
        if eng.step() == 0:
            break
    assert seed.done and hog.done and big.done
    assert eng.allocator.in_use == eng.prefix.nodes
    return [seed.output, hog.output, big.output], _counters(eng)


def test_no_livelock_when_match_is_the_only_eviction_fodder(models):
    """When only the matched pages could cover the shortfall, placement
    abandons the match and prefills plainly, as the JAX engine does."""
    jcfg, tcfg, jparams, tparams = models
    assert _livelock_run(DecodeEngine, Request, tcfg, tparams) == \
        _livelock_run(JaxEngine, JaxRequest, jcfg, jparams)


def test_prefix_cache_requires_paging(models):
    _, tcfg, _, tparams = models
    with pytest.raises(ValueError, match="kv_page_size"):
        DecodeEngine(tcfg, tparams, num_slots=1, cache_len=32,
                     prefix_cache=True, device="cpu")
