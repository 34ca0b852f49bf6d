"""Parity of the PyTorch port's model layer with the JAX package, on the
CPU: the weight bridge, RMSNorm / MLP / RoPE, and prefill + dense and
paged decode steps for both attention routes (the port's ``use_kernels``
against JAX's ``use_pallas``, Pallas in interpret mode), on reduced
stablelm-3b and qwen2-7b (GQA + QKV bias) in f32.  The same weights and
inputs, made with numpy from a seed, go to both sides.

Tolerance: 1e-5 absolute and relative in f32 — the two sides sum in
different orders, which moves the last bits of f32 results."""
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
from repro.models import attention as JA
from repro.models import mlp as JMLP
from repro.models.paging import PagedKVConfig as JaxPagedKVConfig
from repro_torch.configs import RunConfig, get_reduced_config
from repro_torch.models import attention as TA
from repro_torch.models import mlp as TMLP
from repro_torch.models import model as TM
from repro_torch.models.init import init_params
from repro_torch.models.paging import PagedKVConfig
from repro_torch.weights import params_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ("stablelm-3b", "qwen2-7b")


def _cfgs(arch):
    return (dataclasses.replace(jax_reduced(arch), dtype="float32"),
            dataclasses.replace(get_reduced_config(arch), dtype="float32"))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, torch cfg, jax params, torch params) sharing weights.
    qwen2's zero-init QKV biases are filled so the bias path counts."""
    jcfg, tcfg = _cfgs(request.param)
    jparams = jax_init_params(jcfg, 0)
    if jcfg.qkv_bias:
        rng = np.random.default_rng(1)
        attn = jparams["layers"][0]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(
                rng.standard_normal(attn[name].shape).astype(np.float32)
                * 0.1)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def params_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to_numpy(v) for v in tree]
    return tree.numpy()


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().cpu().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


# ------------------------------------------------------------ weights ----

def test_params_from_jax_round_trip(pair):
    jcfg, tcfg, jparams, tparams = pair
    back = params_to_numpy(tparams)
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    bl = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in jl] == [p for p, _ in bl]
    for (_, a), (_, b) in zip(jl, bl):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), b)
    # the port's own init builds the same tree, shapes and dtypes
    own = init_params(tcfg, 0, "cpu")
    ol = jax.tree_util.tree_leaves_with_path(params_to_numpy(own))
    assert [p for p, _ in ol] == [p for p, _ in bl]
    assert [(a.shape, a.dtype) for _, a in ol] == \
        [(b.shape, b.dtype) for _, b in bl]


# -------------------------------------------------------------- layers ----

def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    _close(TMLP.rmsnorm(torch.from_numpy(x), torch.from_numpy(s), 1e-5),
           JMLP.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-5))


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu", "relu2"])
def test_mlp_apply_matches_jax(mlp_type):
    rng = np.random.default_rng(1)
    d, f = 32, 48
    p = {"w1": rng.standard_normal((d, f)).astype(np.float32) * d ** -0.5,
         "w2": rng.standard_normal((f, d)).astype(np.float32) * f ** -0.5,
         "w3": rng.standard_normal((d, f)).astype(np.float32) * d ** -0.5}
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    got = TMLP.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), mlp_type)
    ref = JMLP.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), mlp_type)
    _close(got, ref)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 4, 64)).astype(np.float32)
    pos = np.arange(16, dtype=np.int32) + 5
    _close(TA.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           JA.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


# ----------------------------------------------------- prefill + decode ----

ROUTES = [(False, False), (True, True)]      # (use_kernels, use_pallas)


def _prompt(cfg, S, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, S)).astype(np.int32)


@pytest.mark.parametrize("use_kernels,use_pallas", ROUTES)
def test_prefill_logits_and_cache_match_jax(pair, use_kernels, use_pallas):
    jcfg, tcfg, jparams, tparams = pair
    toks = _prompt(jcfg, 32)
    jl, jc = JM.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                        JaxRunConfig(remat="none", use_pallas=use_pallas),
                        cache_len=64, last_pos=jnp.asarray(20, jnp.int32))
    tl, tc = TM.prefill(tparams, {"tokens": torch.from_numpy(toks)}, tcfg,
                        RunConfig(use_kernels=use_kernels), cache_len=64,
                        last_pos=20)
    _close(tl, jl)
    for jlay, tlay in zip(jc["layers"], tc["layers"]):
        for name in ("k", "v"):
            n = tlay[name].shape[2]
            assert n == 32
            _close(tlay[name], np.asarray(jlay[name])[:, :, :n])
            # the JAX slice pads the rest of cache_len with zeros
            assert not np.asarray(jlay[name])[:, :, n:].any()


def _decode_both(jcfg, tcfg, jparams, tparams, use_kernels, use_pallas,
                 paged: bool):
    """Fill a 2-slot cache with the same random lines on both sides, then
    take two decode steps at different per-slot positions."""
    B, cache_len, ps = 2, 64, 16
    rng = np.random.default_rng(4)
    jrun = JaxRunConfig(remat="none", use_pallas=use_pallas)
    trun = RunConfig(use_kernels=use_kernels)
    if paged:
        jpg = JaxPagedKVConfig(page_size=ps, num_pages=10,
                               pages_per_seq=cache_len // ps)
        tpg = PagedKVConfig(page_size=ps, num_pages=10,
                            pages_per_seq=cache_len // ps)
        # slot 0 owns pages 3, 1; slot 1 owns 2, 5, 7; the rest null
        table = np.array([[3, 1, 0, 0], [2, 5, 7, 0]], np.int32)
    else:
        jpg = tpg = None
        table = None
    jcache = JM.init_cache(jcfg, B, cache_len, paging=jpg)
    tcache = TM.init_cache(tcfg, B, cache_len, device="cpu", paging=tpg)
    # identical random cache contents, held in f32 on both sides: the
    # engines' bf16 caches would round the new lines, and a last-bit
    # difference of the f32 K/V can round to a neighbouring bf16 value
    # (the engine tests cover the bf16 cache, by tokens)
    for jl, tl in zip(jcache["layers"], tcache["layers"]):
        for name in ("k", "v"):
            x = rng.standard_normal(jl[name].shape).astype(np.float32)
            jl[name] = jnp.asarray(x)
            tl[name] = torch.from_numpy(x)
    pos = np.array([17, 30], np.int32)
    out = []
    for step in range(2):
        tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        p = pos + step
        jlog, jcache = JM.decode_step(
            jparams, jcache, jnp.asarray(tok), jnp.asarray(p), jcfg, jrun,
            page_table=None if table is None else jnp.asarray(table))
        tlog, tcache = TM.decode_step(
            tparams, tcache, torch.from_numpy(tok), torch.from_numpy(p),
            tcfg, trun,
            page_table=None if table is None else torch.from_numpy(table))
        out.append((tlog, jlog))
    return out, tcache, jcache


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("use_kernels,use_pallas", ROUTES)
def test_decode_step_matches_jax(pair, use_kernels, use_pallas, paged):
    jcfg, tcfg, jparams, tparams = pair
    out, tcache, jcache = _decode_both(jcfg, tcfg, jparams, tparams,
                                       use_kernels, use_pallas, paged)
    for tlog, jlog in out:
        _close(tlog, jlog)
    # the in-place KV writes land where the JAX cache puts them
    for jl, tl in zip(jcache["layers"], tcache["layers"]):
        for name in ("k", "v"):
            _close(tl[name], jl[name])


def test_ring_decode_matches_jax():
    """Sliding-window ring cache (window < prompt < cache_len) through
    prefill and decode, both routes, against the JAX reference path."""
    jcfg, tcfg = _cfgs("qwen2-7b")
    jcfg = dataclasses.replace(jcfg, sliding_window=16)
    tcfg = dataclasses.replace(tcfg, sliding_window=16)
    jparams = jax_init_params(jcfg, 0)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    toks = _prompt(jcfg, 24)
    jrun = JaxRunConfig(remat="none")
    jl, jcache = JM.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                            jrun, cache_len=64)
    # f32 ring caches on both sides (see _decode_both)
    steps, tok = [], toks[:, -1:]
    for p in (24, 25):
        jlog, jcache = JM.decode_step(jparams, jcache, jnp.asarray(tok),
                                      jnp.asarray([p], jnp.int32), jcfg,
                                      jrun)
        steps.append((tok, p, jlog))
        tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    for use_kernels in (False, True):
        run = RunConfig(use_kernels=use_kernels)
        tl, tcache = TM.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                tcfg, run, cache_len=64)
        _close(tl, jl)
        assert tcache["layers"][0]["k"].shape[2] == 16      # ring slots
        for tok, p, jlog in steps:
            tlog, tcache = TM.decode_step(
                tparams, tcache, torch.from_numpy(tok),
                torch.tensor([p], dtype=torch.int32), tcfg, run)
            _close(tlog, jlog)
