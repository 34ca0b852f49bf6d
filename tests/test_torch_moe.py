"""The PyTorch port's MoE layer, aux losses and modality stubs against the
JAX package, on the CPU: ``moe_apply`` output and its three aux values
(random routing, a group that overflows capacity, exact ties in the
router probabilities), ``loss_fn`` with the balance and z terms on reduced
qwen2-moe-a2.7b, dbrx-132b and jamba-1.5-large-398b, ``forward_train`` on
the pixtral-12b and musicgen-large stub batches, ``make_batch`` equal to
the JAX one for the same seed, and per-request greedy tokens of the
port's ``DecodeEngine`` against the JAX engine's for reduced
qwen2-moe-a2.7b with a dense cache, with pages and with n-gram
speculation, each against the JAX engine in the same mode (capacity is
counted per call, so an MoE model's output depends on what else the call
holds: a mode is never compared with another).

Reduced configs in f32, one set of weights from the JAX init through
``params_from_jax``.  Tolerance: 1e-5 absolute and relative, as in
``tests/test_torch_model.py``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import InputShape as JaxInputShape
from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_reduced_config as jax_reduced
from repro.models import init_params as jax_init_params
from repro.models import make_batch as jax_make_batch
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs import InputShape, RunConfig, get_reduced_config
from repro_torch.models import make_batch
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.serving import DecodeEngine, Request
from repro_torch.weights import params_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)
SHAPE = (2, 64)                                   # (batch, seq)
_jax_moe = jax.jit(JMOE.moe_apply, static_argnums=2)


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops under a loaded machine: torch's intra-op pool only
    waits (see tests/test_torch_cluster.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(jax cfg, torch cfg, numpy params) with weights from the JAX init."""
    jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
    tcfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
    params = jax.jit(jax_init_params, static_argnums=(0, 1))(jcfg, 0)
    return jcfg, tcfg, jax.tree.map(np.asarray, params)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


# ------------------------------------------------------------- moe_apply ----

def _moe_case(case):
    """(cfg pair, moe params, x) for one routing case of reduced
    qwen2-moe (4 experts, top-2, groups of 64, capacity 40)."""
    jcfg, tcfg, params = _pair("qwen2-moe-a2.7b")
    p = jax.tree.map(lambda a: a[0], params["layers"][0]["moe"])
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 48, jcfg.d_model)).astype(np.float32)
    router = p["router"].copy()
    if case == "overflow":
        # every token's first choice is expert 0: 64 tokens a group for
        # 40 slots, so 24 a group overflow (and none of 48 in the last)
        router[:, 0] = np.abs(router).sum(0).max() * 3
        x = np.abs(x)
    elif case == "tie":
        # experts 1 and 2 get logit 0 exactly: wherever both beat 0 and 3
        # the top-2 is a tie, which lax.top_k breaks to the lower index
        router[:, 1] = 0.0
        router[:, 2] = 0.0
        router[:, 0] = -np.abs(router[:, 0])
        router[:, 3] = -np.abs(router[:, 3])
        x = np.abs(x)
    p["router"] = router
    return jcfg, tcfg, p, x


@pytest.mark.parametrize("case", ["random", "overflow", "tie"])
def test_moe_apply_matches_jax(case):
    jcfg, tcfg, p, x = _moe_case(case)
    jy, jaux = _jax_moe(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    tp = {k: ({n: torch.from_numpy(a) for n, a in v.items()}
              if isinstance(v, dict) else torch.from_numpy(v))
          for k, v in p.items()}
    ty, taux = TMOE.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert ty.shape == x.shape
    _close(ty, jy)
    assert set(taux) == set(jaux)
    for k in jaux:
        _close(taux[k], jaux[k])
    over = float(taux["moe_overflow"])
    if case == "overflow":
        assert over > 0.1           # the capacity really bound
    elif case == "tie":
        probs = torch.softmax(torch.from_numpy(x).reshape(-1, x.shape[-1])
                              @ torch.from_numpy(p["router"]), -1)
        ties = (probs[:, 1] == probs[:, 2]) & (probs[:, 1] > probs[:, 0]) \
            & (probs[:, 1] > probs[:, 3])
        assert bool(ties.all())


def test_top_k_orders_ties_like_lax():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = TMOE._top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_capacity_matches_jax():
    for args in [(64, 2, 4, 1.25), (4, 4, 60, 1.25), (1024, 4, 60, 1.25),
                 (128, 2, 16, 1.0), (1, 1, 1, 1.0)]:
        assert TMOE._capacity(*args) == JMOE._capacity(*args)


# --------------------------------------------------------- loss, batches ----

def _batch(arch, seed=0):
    jcfg = _pair(arch)[0]
    jb = jax_make_batch(jcfg, JaxInputShape("t", SHAPE[1], SHAPE[0],
                                            "train"), seed)
    tb = make_batch(get_reduced_config(arch),
                    InputShape("t", SHAPE[1], SHAPE[0], "train"), seed,
                    device="cpu")
    return jb, tb


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "dbrx-132b",
                                  "jamba-1.5-large-398b"])
def test_loss_fn_with_aux_matches_jax(arch):
    """loss = xent + balance_coef * balance + router_z_coef * z, summed
    over the MoE sublayers, as in the JAX ``loss_fn``."""
    jcfg, tcfg, params = _pair(arch)
    jb, tb = _batch(arch)
    run = JaxRunConfig(remat="none")
    jloss, jm = jax.jit(functools.partial(JM.loss_fn, cfg=jcfg, run=run))(
        params, jb)
    tloss, tm = TM.loss_fn(params_from_jax(params), tb, tcfg, RunConfig())
    _close(tloss, jloss)
    assert set(tm) == set(jm)
    for k in jm:
        _close(tm[k], jm[k])
    moe = tcfg.moe
    want = (tm["xent"] + moe.balance_coef * tm["moe_balance_loss"]
            + moe.router_z_coef * tm["moe_z_loss"])
    assert float(tm["moe_balance_loss"]) > 0 and float(tm["moe_z_loss"]) > 0
    torch.testing.assert_close(tloss, want)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "musicgen-large"])
def test_grads_match_jax(arch):
    """Gradients of the loss against ``jax.grad``: the router and experts
    through the top-k gates and the aux terms (MoE), and a zero gradient
    for the token table the audio stub's batch never reads.  At the
    tolerance ``tests/test_torch_training.py`` holds gradients to."""
    from repro_torch.tree import leaves
    jcfg, tcfg, params = _pair(arch)
    jb, tb = _batch(arch)
    f = functools.partial(JM.loss_fn, cfg=jcfg,
                          run=JaxRunConfig(remat="none"))
    jgrads = jax.jit(jax.grad(lambda p, b: f(p, b)[0]))(params, jb)
    tparams = params_from_jax(params)
    xs = [p.requires_grad_(True) for p in leaves(tparams)]
    loss, _ = TM.loss_fn(tparams, tb, tcfg, RunConfig())
    tgrads = torch.autograd.grad(loss, xs, allow_unused=True,
                                 materialize_grads=True)
    jl = jax.tree_util.tree_leaves(jgrads)
    assert len(jl) == len(tgrads)
    for t, j in zip(tgrads, jl):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=1e-4)
    if arch == "musicgen-large":       # held equal to it just above
        assert float(np.abs(np.asarray(jgrads["embed"]["tok"])).max()) == 0


@pytest.mark.parametrize("arch", ["pixtral-12b", "musicgen-large",
                                  "qwen2-moe-a2.7b"])
def test_make_batch_matches_jax(arch):
    jb, tb = _batch(arch, seed=3)
    assert list(jb) == list(tb)
    for k in jb:
        assert str(tb[k].dtype)[6:] == str(jb[k].dtype)
        np.testing.assert_array_equal(
            np.asarray(jb[k].astype(jnp.float32)), tb[k].float().numpy())
    if arch == "pixtral-12b":
        P = min(256, SHAPE[1] // 2)
        assert tuple(tb["prefix_embeddings"].shape) == (SHAPE[0], P, 256)
        assert tuple(tb["tokens"].shape) == (SHAPE[0], SHAPE[1] - P)
        assert not bool(tb["loss_mask"][:, :P].any())
        assert bool(tb["loss_mask"][:, P:].all())


@pytest.mark.parametrize("arch", ["pixtral-12b", "musicgen-large"])
def test_forward_train_on_stub_batches_matches_jax(arch):
    """The stub embeddings go ahead of the tokens (vision) or replace them
    (audio, with sinusoidal PE over the whole length)."""
    jcfg, tcfg, params = _pair(arch)
    jb, tb = _batch(arch)
    run = JaxRunConfig(remat="none")
    jlog, _ = jax.jit(functools.partial(JM.forward_train, cfg=jcfg,
                                        run=run))(params, jb)
    tlog, _ = TM.forward_train(params_from_jax(params), tb, tcfg,
                               RunConfig())
    assert tuple(tlog.shape) == (*SHAPE, tcfg.vocab_size)
    _close(tlog, jlog)
    jloss, _ = jax.jit(functools.partial(JM.loss_fn, cfg=jcfg, run=run))(
        params, jb)
    tloss, _ = TM.loss_fn(params_from_jax(params), tb, tcfg, RunConfig())
    _close(tloss, jloss)


# ---------------------------------------------------------------- engine ----

def _serve(engine, req_cls, specs):
    reqs = [req_cls(**s) for s in specs]
    for r in reqs:
        engine.submit(r)
    engine.run_to_completion()
    assert all(r.done for r in reqs)
    return [list(r.output) for r in reqs]


def _specs():
    """Two prompts, each asked twice, greedy: with two slots the second
    pair starts after the first pair finishes, whose tokens the n-gram
    index has by then (drafts to verify)."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, 512, n).astype(np.int32) for n in (21, 9)]
    return [dict(rid=i, prompt=prompts[i % 2], max_new_tokens=14)
            for i in range(4)]


MODES = [("dense", dict()), ("paged", dict(kv_page_size=16)),
         ("ngram", dict(kv_page_size=16, speculate=3))]


@pytest.mark.parametrize("mode,options", MODES, ids=[m for m, _ in MODES])
def test_greedy_outputs_identical_to_jax_engine(mode, options):
    jcfg, tcfg, params = _pair("qwen2-moe-a2.7b")
    kw = dict(num_slots=2, cache_len=128, decode_chunk=4,
              prefill_buckets="auto", **options)
    specs = _specs()
    jeng = JaxEngine(jcfg, jax.tree.map(jnp.asarray, params), **kw)
    ref = _serve(jeng, JaxRequest, specs)
    for use_kernels in (True, False):
        eng = DecodeEngine(tcfg, params_from_jax(params), device="cpu",
                           run=RunConfig(use_kernels=use_kernels), **kw)
        assert _serve(eng, Request, specs) == ref, use_kernels
        assert eng.spec_stats == jeng.spec_stats
    if mode == "ngram":
        assert jeng.spec_stats["rounds"] > 0
        assert jeng.spec_stats["accepted"] > 0
