"""The port's serve steps (``repro_torch.serving.serve_step``) against the
JAX package's, on the CPU.

Reduced stablelm-3b in f32 with the JAX init's weights
(``weights.params_from_jax``), a one-cell mesh on both sides, greedy:

* ``make_serve_step``: 5 decode steps from a zero cache, each feeding the
  last step's argmax — logits within 1e-5 of the largest magnitude of
  JAX's, tokens equal;
* ``make_fused_serve_step``: one fused chunk of 6 tokens over 3 slots,
  one slot stopped by EOS and one by ``remaining`` — tokens and the
  returned token, position, remaining and done vectors equal to JAX's;
* ``make_chunked_serve_step``: a 12-line prefill chunk of one request
  written into the paged pool beside a live decode lane — the chunk's
  logits within 1e-5 of JAX's, the decode lane's tokens equal, and the
  chunk's lines in the bf16 pool within one bf16 rounding step of JAX's.

Then the arguments the ``*_lowering_args`` give (this rank's local
shapes at 2 x 2 under fsdp_tp ZeRO 3), and the layouts the builders
refuse: sharded query heads over a cache that holds every line, and a
paged pool sharded on its lines."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.serving as jserving
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
import repro_torch.configs as TC
import repro_torch.serving as tserving
from repro_torch.configs import InputShape, RunConfig
from repro_torch.launch.mesh import single_device_mesh, virtual_mesh
from repro_torch.launch.mesh import virtual_world
from repro_torch.models import init_cache
from repro_torch.tree import leaves
from repro_torch.weights import params_from_jax

B, CACHE = 3, 48
TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(JC.get_reduced_config("stablelm-3b"),
                               dtype="float32")
    tcfg = dataclasses.replace(TC.get_reduced_config("stablelm-3b"),
                               dtype="float32")
    jparams = jax_init_params(jcfg, 0)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=TOL * scale, rtol=0)


def test_serve_step_matches_jax(model):
    jcfg, tcfg, jparams, tparams = model
    jstep = jserving.make_serve_step(jcfg, JC.RunConfig(), jax_make_mesh(),
                                     B, CACHE)
    tstep = tserving.make_serve_step(tcfg, RunConfig(),
                                     single_device_mesh("cpu"), B, CACHE)
    jc = jax_init_cache(jcfg, B, CACHE)
    tc = init_cache(tcfg, B, CACHE, device="cpu")
    tok = np.array([[5], [17], [300]], np.int32)
    for pos in range(5):
        jl, jc = jstep(jparams, jc, jnp.asarray(tok), jnp.int32(pos))
        tl, tc = tstep(tparams, tc, torch.from_numpy(tok),
                       torch.tensor(pos, dtype=torch.int32))
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1), np.int32)[:, None]
        assert np.array_equal(tl[:, 0].argmax(-1).numpy()[:, None], nxt)
        tok = nxt


def _vectors():
    token = np.array([5, 17, 300], np.int32)
    pos = np.array([0, 3, 7], np.int32)
    remaining = np.array([6, 2, 6], np.int32)
    done = np.array([False, False, False])
    temps = np.zeros(B, np.float32)
    return token, pos, remaining, done, temps


def test_fused_serve_step_matches_jax(model):
    jcfg, tcfg, jparams, tparams = model
    n = 6
    jstep = jserving.make_fused_serve_step(jcfg, JC.RunConfig(),
                                           jax_make_mesh(), B, CACHE, n)
    tstep = tserving.make_fused_serve_step(tcfg, RunConfig(),
                                           single_device_mesh("cpu"), B,
                                           CACHE, n)
    token, pos, remaining, done, temps = _vectors()
    # slot 2 stops on its second token (its greedy continuation's EOS)
    probe = jstep(jparams, jax_init_cache(jcfg, B, CACHE), token, pos,
                  remaining, done, np.full(B, -1, np.int32), temps,
                  jax.random.PRNGKey(0))
    eos = np.array([-1, -1, int(probe[0][2, 1])], np.int32)
    jout = jstep(jparams, jax_init_cache(jcfg, B, CACHE), token, pos,
                 remaining, done, eos, temps, jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    tout = tstep(tparams, init_cache(tcfg, B, CACHE, device="cpu"),
                 *map(torch.from_numpy, (token, pos, remaining, done, eos,
                                         temps)), gen)
    assert tout[-1] is gen
    for i in (0, 2, 3, 4, 5):           # tokens, token, pos, remaining, done
        assert np.array_equal(tout[i].numpy(), np.asarray(jout[i])), i
    assert bool(tout[5][1]) and bool(tout[5][2])


def test_chunked_serve_step_matches_jax(model):
    jcfg, tcfg, jparams, tparams = model
    page, n, C = 16, 4, 12
    jstep = jserving.make_chunked_serve_step(
        jcfg, JC.RunConfig(), jax_make_mesh(), B, CACHE, page_size=page,
        num_tokens=n)
    tstep = tserving.make_chunked_serve_step(
        tcfg, RunConfig(), single_device_mesh("cpu"), B, CACHE,
        page_size=page, num_tokens=n)
    paging = tstep.layout.cache_abs["layers"][0]["k"].shape
    pps = CACHE // page
    token, pos, remaining, done, temps = _vectors()
    pos = np.zeros(B, np.int32)
    done = np.array([False, True, True])       # lane 0 decodes
    table = np.zeros((B, pps), np.int32)
    table[0] = [1, 2, 3]
    limit = np.array([CACHE, 0, 0], np.int32)
    rng = np.random.default_rng(1)
    c_tokens = rng.integers(1, 500, (1, C)).astype(np.int32)
    c_row = np.array([[4, 5, 6]], np.int32)
    lines = np.arange(C)
    c_pages = c_row[0][lines // page].astype(np.int32)
    c_offs = (lines % page).astype(np.int32)
    eos = np.full(B, -1, np.int32)
    from repro.models.paging import PagedKVConfig as JPaged
    jpaging = JPaged.for_budget(B * CACHE, page, CACHE)
    jcache = jax_init_cache(jcfg, B, CACHE, paging=jpaging)
    jout = jstep(jparams, jcache, token, pos, remaining, done, eos, temps,
                 jax.random.PRNGKey(0), table, limit, c_tokens, c_row,
                 jnp.int32(0), jnp.int32(C - 1), c_pages, c_offs)
    tcache = init_cache(tcfg, B, CACHE, device="cpu",
                        paging=tstep.layout.paging)
    assert tuple(tcache["layers"][0]["k"].shape) == paging
    tout = tstep(tparams, tcache,
                 *map(torch.from_numpy, (token, pos, remaining, done, eos,
                                         temps)),
                 torch.Generator().manual_seed(0),
                 *map(torch.from_numpy, (table, limit, c_tokens, c_row)),
                 0, C - 1, *map(torch.from_numpy, (c_pages, c_offs)))
    _close(tout[-1], jout[-1])                          # chunk logits
    assert np.array_equal(tout[0].numpy(), np.asarray(jout[0]))
    # the chunk's lines in the bf16 pool: within one bf16 rounding step
    # (the f32 products round to bf16 either side of a tie)
    for jl, tl in zip(jax.tree.leaves(jout[1]), leaves(tout[1])):
        want = np.asarray(jl.astype(jnp.float32))[:, 4:7]
        np.testing.assert_allclose(tl[:, 4:7].float().numpy(), want,
                                   rtol=2 ** -7, atol=0)


def test_lowering_args_are_local_shards():
    cfg = TC.get_reduced_config("stablelm-3b")
    run = RunConfig(strategy="fsdp_tp", zero_stage=3)
    shape = InputShape("d", 32, 4, "decode")
    with virtual_world(1, 4):
        mesh = virtual_mesh((2, 2))
        params, cache, token, pos = tserving.serve_step_lowering_args(
            cfg, run, mesh, shape)
        fused = tserving.fused_serve_step_lowering_args(cfg, run, mesh,
                                                        shape)
        chunked = tserving.chunked_serve_step_lowering_args(cfg, run, mesh,
                                                            shape)
    k = cache["layers"][0]["k"]
    # (groups, batch / data, lines, kv heads / model, head dim)
    assert tuple(k.shape) == (2, 2, 32, 2, 64) and k.device.type == "meta"
    # this rank's rows of the tokens, as its cache holds them
    assert tuple(token.shape) == (2, 1) and pos.dtype == torch.int32
    assert all(tuple(v.shape) == (2,) for v in fused[2:8])
    wq = params["layers"][0]["attn"]["wq"]
    assert tuple(wq.shape) == (2, 128, 2, 64)      # d / data, heads / model
    assert len(fused) == 9 and fused[-1] is None
    assert len(chunked) == 17 and chunked[13:15] == (0, 63)
    pool = chunked[1]["layers"][0]["k"]
    assert pool.shape[0] == 2 and pool.shape[3] == 2   # heads / model


def test_refused_and_sharded_layouts():
    run = RunConfig(strategy="tp", zero_stage=3)
    with virtual_world(0, 2):
        mesh = virtual_mesh((1, 2))
        # SSD heads shard and run (held to one rank in
        # tests/test_torch_dryrun.py)
        assert tserving.make_serve_step(TC.get_reduced_config(
            "mamba2-780m"), run, mesh, 2, 32).layout.plan.ssm
        gqa = dataclasses.replace(TC.get_reduced_config("stablelm-3b"),
                                  num_kv_heads=1)
        # one kv head: the cache's lines shard over the ranks, but 33 do
        # not divide, and a paged pool's do not run sharded
        with pytest.raises(NotImplementedError, match="every line"):
            tserving.make_serve_step(gqa, run, mesh, 2, 33)
        with pytest.raises(NotImplementedError, match="paged pool"):
            tserving.make_chunked_serve_step(gqa, run, mesh, 2, 32)
        assert tserving.make_serve_step(gqa, run, mesh, 2, 32).layout.seq_kv
