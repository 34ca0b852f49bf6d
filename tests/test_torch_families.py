"""The PyTorch port's SSM and hybrid serving against the JAX package, on
the CPU: ``init_ssm_cache``, ``ssm_prefill`` (exact and front-padded, the
conv window sliding into the pad for a prompt shorter than it) and
``ssm_decode`` over 8 steps on reduced mamba2-780m; the front-pad
arguments of ``attention_prefill`` and ``prefill`` on reduced
jamba-1.5-large-398b (the SSM + attention + MoE hybrid); per-request greedy
tokens of the port's ``DecodeEngine`` against the JAX engine's for reduced
mamba2-780m and jamba, exact and with front-padded buckets (the front pad
``f`` nonzero); the engine's guards (paging refused for an SSM config,
buckets refused under the kernels); the ten architectures and their
default AdamW state dtype; and ``chip_smoke.py``'s families phase at
reduced size on the CPU.

Reduced configs in f32, one set of weights from the JAX init through
``params_from_jax``.  Tolerance: 1e-5 absolute and relative, as in
``tests/test_torch_model.py`` (the two sides sum in different orders)."""
import dataclasses
import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import INPUT_SHAPES as JAX_INPUT_SHAPES
from repro.configs import default_run_config as jax_default_run_config
from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_config
from repro.configs import get_reduced_config as jax_reduced
from repro.models import attention as JA
from repro.models import init_params as jax_init_params
from repro.models import model as JM
from repro.models import ssm as JSSM
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs import (
    ARCH_IDS, RunConfig, default_opt_state_dtype, get_config,
    get_reduced_config,
)
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import ssm as TSSM
from repro_torch.serving import DecodeEngine, Request
from repro_torch.weights import params_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)
# the JAX side jitted: eager dispatch of each op costs seconds per test
_jax_ssm_prefill = jax.jit(JSSM.ssm_prefill, static_argnums=2)
_jax_ssm_decode = jax.jit(JSSM.ssm_decode, static_argnums=3)


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops under a loaded machine: torch's intra-op pool only
    waits (see tests/test_torch_cluster.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch):
    jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
    tcfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
    jparams = jax.jit(jax_init_params, static_argnums=(0, 1))(jcfg, 0)
    return jcfg, tcfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def mamba():
    return _models("mamba2-780m")


@pytest.fixture(scope="module")
def jamba():
    return _models("jamba-1.5-large-398b")


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


def _hidden(cfg, S, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (1, S, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------- configs ----

def test_ten_architectures_match_jax_configs():
    """Every field of the JAX ``ModelConfig`` as the JAX package sets it;
    the fields only the port has (the attention layer's offset in its
    period, the muP scalars) at their defaults, which change nothing."""
    assert ARCH_IDS == JAX_ARCH_IDS
    shared = {f.name for f in dataclasses.fields(jax_config(ARCH_IDS[0]))}
    extra = [f for f in dataclasses.fields(get_config(ARCH_IDS[0]))
             if f.name not in shared]
    assert sorted(f.name for f in extra) == sorted(
        ("attn_offset", "embedding_multiplier", "residual_multiplier",
         "attention_multiplier", "logits_scaling"))
    for arch in ARCH_IDS:
        for ours, theirs in ((get_config(arch), jax_config(arch)),
                             (get_reduced_config(arch), jax_reduced(arch))):
            mine = dataclasses.asdict(ours)
            assert {k: mine[k] for k in shared} == dataclasses.asdict(theirs)
            assert all(getattr(ours, f.name) == f.default for f in extra)
            assert ours.param_count() == theirs.param_count()


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_default_opt_state_dtype_matches_jax(arch):
    """The AdamW state dtype (bf16 above 100B parameters: dbrx and
    jamba), as the JAX defaults give it."""
    theirs = jax_default_run_config(jax_config(arch),
                                    JAX_INPUT_SHAPES["train_4k"])
    assert default_opt_state_dtype(get_config(arch)) == \
        theirs.opt_state_dtype


# ----------------------------------------------------------- ssm serving ----

def test_init_ssm_cache_matches_jax(mamba):
    jcfg, tcfg, _, _ = mamba
    j = JSSM.init_ssm_cache(jcfg, 3, 2)
    t = TSSM.init_ssm_cache(tcfg, 3, 2, device="cpu")
    for name in ("state", "conv"):
        assert tuple(t[name].shape) == j[name].shape
        assert str(t[name].dtype)[6:] == str(j[name].dtype)
        assert not bool(t[name].any())


# (S, front pad, real tokens): exact; a chunk-aligned front pad of one
# chunk; a 2-token prompt, shorter than the conv window
SSM_PREFILLS = [(40, None, None), (64, 32, 20), (64, 32, 2)]


@pytest.mark.parametrize("S,front,real", SSM_PREFILLS,
                         ids=["exact", "front-pad", "front-pad-short"])
def test_ssm_prefill_matches_jax(mamba, S, front, real):
    jcfg, tcfg, jparams, tparams = mamba
    x = _hidden(jcfg, S)
    kw_j = kw_t = {}
    if front is not None:
        idx = np.arange(S)
        valid = (idx >= front) & (idx < front + real)
        kw_j = dict(valid=jnp.asarray(valid), conv_end=front + real)
        kw_t = dict(valid=torch.from_numpy(valid), conv_end=front + real)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"][0]["ssm"])
    tp = {k: v[0] for k, v in tparams["layers"][0]["ssm"].items()}
    jy, jc = _jax_ssm_prefill(jp, jnp.asarray(x), jcfg, **kw_j)
    ty, tc = TSSM.ssm_prefill(tp, torch.from_numpy(x), tcfg, **kw_t)
    _close(ty, jy)
    assert tc["state"].dtype == torch.float32
    for name in ("state", "conv"):
        _close(tc[name], jc[name])


def test_ssm_decode_eight_steps_matches_jax(mamba):
    """Prefill 20 tokens, then 8 recurrent steps; the port's cache is
    updated in place and must track the JAX cache step by step."""
    jcfg, tcfg, jparams, tparams = mamba
    jp = jax.tree.map(lambda a: a[0], jparams["layers"][0]["ssm"])
    tp = {k: v[0] for k, v in tparams["layers"][0]["ssm"].items()}
    x = _hidden(jcfg, 20, seed=1)
    _, jc = _jax_ssm_prefill(jp, jnp.asarray(x), jcfg)
    _, tc = TSSM.ssm_prefill(tp, torch.from_numpy(x), tcfg)
    tcache = {k: v.clone() for k, v in tc.items()}
    ids = {k: id(v) for k, v in tcache.items()}
    for step in range(8):
        xt = _hidden(jcfg, 1, seed=10 + step)
        jy, jc = _jax_ssm_decode(jp, jnp.asarray(xt), jc, jcfg)
        ty, out = TSSM.ssm_decode(tp, torch.from_numpy(xt), tcache, tcfg)
        assert out is tcache and {k: id(v) for k, v in out.items()} == ids
        _close(ty, jy)
        for name in ("state", "conv"):
            _close(tcache[name], jc[name])


def test_attention_prefill_front_pad_matches_jax(jamba):
    """positions / valid / roll on the hybrid's attention sublayer: pad
    kv masked out of every query, RoPE shifted, real lines rolled to
    [0, num_real)."""
    jcfg, tcfg, jparams, tparams = jamba
    S, front, real = 64, 32, 11
    x = _hidden(jcfg, S, seed=2)
    idx = np.arange(S)
    valid = (idx >= front) & (idx < front + real)
    positions = (idx - front).astype(np.int32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"][0]["attn"])
    tp = {k: v[0] for k, v in tparams["layers"][0]["attn"].items()}
    jo, jc = JA.attention_prefill(jp, jnp.asarray(x), jcfg, S,
                                  positions=jnp.asarray(positions),
                                  valid=jnp.asarray(valid), roll=front)
    to, tc = TA.attention_prefill(tp, torch.from_numpy(x), tcfg, S,
                                  positions=torch.from_numpy(positions),
                                  valid=torch.from_numpy(valid), roll=front)
    rows = slice(front, front + real)
    _close(to[:, rows], jo[:, rows])
    for name in ("k", "v"):
        _close(tc[name], jc[name])


@pytest.mark.parametrize("real", [2, 40])
@pytest.mark.parametrize("arch", ["mamba", "jamba"])
def test_front_padded_prefill_matches_jax(request, arch, real):
    """The whole model: front-padded prefill gives the JAX package's
    logits, SSM state and conv window and (hybrid) its rolled K/V lines.
    Without MoE it also gives the exact (unpadded) prefill's; with MoE
    the pad tokens take part in the capacity count, so exact and padded
    runs may route differently, in the JAX package too."""
    jcfg, tcfg, jparams, tparams = request.getfixturevalue(arch)
    L, Q = 128, jcfg.ssm.chunk
    f = ((L - real) // Q) * Q
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size,
                                             real).astype(np.int32)
    padded = np.zeros((1, L), np.int32)
    padded[0, f:f + real] = toks
    run = JaxRunConfig(remat="none")
    jl, jc = JM.prefill(jparams, {"tokens": jnp.asarray(padded)}, jcfg, run,
                        cache_len=L, last_pos=f + real - 1, front_pad=f,
                        num_real=real)
    tl, tc = TM.prefill(tparams, {"tokens": torch.from_numpy(padded)}, tcfg,
                        RunConfig(), cache_len=L, last_pos=f + real - 1,
                        front_pad=f, num_real=real)
    _close(tl, jl)
    for tleaf, jleaf in zip(tc["layers"], jc["layers"]):
        assert set(tleaf) == set(jleaf)
        for name in tleaf:
            _close(tleaf[name], jleaf[name])
    if tcfg.moe is not None:
        return
    el, ec = TM.prefill(tparams, {"tokens": torch.from_numpy(toks)[None]},
                        tcfg, RunConfig(), cache_len=L)
    _close(tl, el)
    for tleaf, eleaf in zip(tc["layers"], ec["layers"]):
        for name in tleaf:
            n = eleaf[name].shape[2]
            _close(tleaf[name][:, :, :n], eleaf[name])


# ---------------------------------------------------------------- engine ----

def _serve(engine, req_cls, specs):
    reqs = [req_cls(**s) for s in specs]
    for r in reqs:
        engine.submit(r)
    engine.run_to_completion()
    assert all(r.done for r in reqs)
    return [list(r.output) for r in reqs]


def _specs(lengths, seed=3, vocab=512):
    rng = np.random.default_rng(seed)
    return [dict(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                 max_new_tokens=4 + 2 * (i % 3))
            for i, n in enumerate(lengths)]


# prompts: under the single 128 bucket with the reduced chunk of 32, 9 and
# 2 tokens take f = 96 and 70 tokens f = 32 (the JAX test's short prompts
# under "auto" buckets all give f = 0)
ENGINE_CASES = [
    ("mamba2-780m", (9, 70, 3)),
    ("jamba-1.5-large-398b", (2, 9, 70)),
]


@pytest.mark.parametrize("buckets", [None, (128,), "auto"],
                         ids=["exact", "bucket128", "auto"])
@pytest.mark.parametrize("arch,lengths", ENGINE_CASES,
                         ids=["mamba2", "jamba"])
def test_greedy_outputs_identical_to_jax_engine(request, arch, lengths,
                                                buckets):
    jcfg, tcfg, jparams, tparams = request.getfixturevalue(
        "mamba" if arch.startswith("mamba") else "jamba")
    kw = dict(num_slots=2, cache_len=128, decode_chunk=4,
              prefill_buckets=buckets)
    specs = _specs(lengths)
    jeng = JaxEngine(jcfg, jparams, **kw)
    ref = _serve(jeng, JaxRequest, specs)
    eng = DecodeEngine(tcfg, tparams, device="cpu",
                       run=RunConfig(use_kernels=False), **kw)
    assert eng.prefill_buckets == jeng.prefill_buckets
    assert eng._front_pad == (buckets is not None)
    assert _serve(eng, Request, specs) == ref
    assert [len(o) for o in ref] == [s["max_new_tokens"] for s in specs]


def test_front_pad_offsets_nonzero(mamba, monkeypatch):
    """The bucket128 case above prefills at front pads 96 and 32: the
    chunk-aligned offsets the JAX test's prompts never reach."""
    import repro_torch.serving.engine as E
    _, tcfg, _, tparams = mamba
    eng = DecodeEngine(tcfg, tparams, num_slots=2, cache_len=128,
                       prefill_buckets=(128,), device="cpu",
                       run=RunConfig(use_kernels=False))
    seen = []

    def spy(*a, **kw):
        seen.append((kw.get("front_pad"), kw.get("num_real"),
                     kw.get("last_pos")))
        return TM.prefill(*a, **kw)

    monkeypatch.setattr(E, "prefill", spy)
    _serve(eng, Request, _specs((9, 70)))
    assert seen == [(96, 9, 104), (32, 70, 101)]


def test_engine_guards_for_ssm_configs(mamba, jamba):
    _, tcfg, _, tparams = mamba
    # attention-free: no sublayer to page
    with pytest.raises(ValueError, match="cfg.ssm"):
        DecodeEngine(tcfg, tparams, num_slots=2, cache_len=64,
                     kv_page_size=16, device="cpu")
    _, hcfg, _, hparams = jamba
    with pytest.raises(ValueError, match="attn_every"):
        DecodeEngine(dataclasses.replace(hcfg, ssm=None, attn_every=2),
                     hparams, num_slots=2, cache_len=64, kv_page_size=16,
                     device="cpu")
    # under the kernels front-padded buckets are refused (exact prefill),
    # as the JAX engine refuses them under use_pallas
    eng = DecodeEngine(tcfg, tparams, num_slots=2, cache_len=64,
                       prefill_buckets="auto", device="cpu")
    assert eng.prefill_buckets is None and not eng._front_pad
    with pytest.raises(AssertionError, match="full-attention"):
        TM.verify_tokens(hparams, None, torch.zeros((1, 2), dtype=torch.int32),
                         None, None, None, None, hcfg, RunConfig())


def test_chip_smoke_families_phase_on_cpu():
    """``chip_smoke.py``'s families phase at reduced size on the CPU: every
    run finishes its requests, the SSM check takes nonzero front pads and
    holds, the MoE speculation run's second wave verifies drafts, and each
    model passes the consistency checks (the f32 one for MoE)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    cs = importlib.import_module("chip_smoke")
    args = dict(requests=4, slots=4, cache_len=256, max_new=12,
                decode_chunk=4)
    out = cs.families_phase(args, device="cpu", reduced=True)
    assert [r["label"] for r in out["runs"]] == [
        "mamba2-780m dense", "qwen2-moe-a2.7b dense",
        "qwen2-moe-a2.7b paged (16-line pages)",
        "qwen2-moe-a2.7b speculation, n-gram, k 4", "starcoder2-3b dense"]
    assert [r["tokens"] for r in out["runs"]] == [4 * 11] * 3 + [
        8 * 11, 4 * 11]
    assert out["runs"][0]["buckets"] is None      # the kernels: exact
    assert out["runs"][3]["rounds"] >= 4
    assert out["runs"][3]["proposed"] >= 16
    ident = out["identity"]
    assert ident["same"] + ident["ties"] == 4 and min(ident["pads"]) > 0
    assert set(out["consistency"]) == {
        "mamba2-780m", "qwen2-moe-a2.7b", "qwen2-moe-a2.7b f32",
        "starcoder2-3b"}
    assert out["consistency"]["qwen2-moe-a2.7b f32"]["kernels_vs_plain"] \
        == 0.0                           # on the CPU both are the plain route
