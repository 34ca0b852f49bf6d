"""Parity of the PyTorch port's SSD scan and Mamba-2 block with the JAX
package, on the CPU: the scan's plain version (``kernels.ref.ssd_scan_ref``)
and its entry point (``kernels.ops.ssd_scan``) against the Pallas kernel in
interpret mode and the token-by-token oracle over the ``SSD_CASES`` of
``tests/test_kernels.py``; the model's chunked scan (ragged S and the
final state), the causal conv, and ``ssm_train`` for both routes on reduced
mamba2-780m.  Also: the autograd functions that carry the kernels'
gradients, with the kernel call replaced by its plain version (the kernel
runs only on the card), and the CUDA wrapper's refusals before any build.

Tolerances: 1e-4 in f32 against the Pallas kernel and the oracle, as
``tests/test_kernels.py`` holds the Pallas kernel (the chunked and the
token-by-token forms sum in different orders); 1e-5 between the port's and
JAX's chunked scans, which sum the same terms; 5e-2 in bf16 (the output is
rounded to bf16 once, at magnitudes up to ~10)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.kernels import ops as jops
from repro.kernels.ref import ssd_ref as jax_ssd_ref
from repro.models import init_params as jax_init_params
from repro.models import ssm as JSSM
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import ssm as TSSM
from repro_torch.weights import params_from_jax

SSD_CASES = [
    # (B, S, H, P, N, chunk) — tests/test_kernels.py's sweep ...
    (2, 128, 4, 32, 16, 32),
    (1, 256, 2, 64, 32, 64),
    (2, 64, 1, 16, 8, 64),            # single chunk
    (1, 96, 3, 32, 128, 32),          # big state
    # ... plus a chunk that _pick_block shrinks (96 -> 48)
    (1, 96, 2, 32, 16, 64),
]
DTYPES = [(jnp.float32, torch.float32, 1e-4),
          (jnp.bfloat16, torch.bfloat16, 5e-2)]
# the JAX side jitted: eager dispatch of each op costs seconds per test
_jax_ssd_ref = jax.jit(jax_ssd_ref)
_jax_ssd_chunked = jax.jit(JSSM.ssd_chunked, static_argnums=5)


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def _ssd_inputs(B, S, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, P)).astype(np.float32),
            rng.uniform(1e-3, 0.1, (B, S, H)).astype(np.float32),
            -rng.uniform(0.5, 4.0, (H,)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32))


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_CASES)
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
def test_ssd_scan_matches_pallas_and_oracle(B, S, H, P, N, chunk, jdt, tdt,
                                            tol):
    """f32 against the Pallas kernel (interpret mode) and the oracle; bf16
    against the oracle (the Pallas interpreter costs ~1 s a case)."""
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, N, seed=S + H + N)
    jx, jB, jC = (jnp.asarray(v, jdt) for v in (x, Bm, Cm))
    oracle = _jax_ssd_ref(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC)
    tx, tB, tC = (torch.from_numpy(v).to(tdt) for v in (x, Bm, Cm))
    tdt_, tA = torch.from_numpy(dt), torch.from_numpy(A)
    y = tops.ssd_scan(tx, tdt_, tA, tB, tC, chunk=chunk)
    assert y.dtype == tdt and y.shape == (B, S, H, P)
    _close(y, oracle, tol)
    # the port's own oracle is the JAX one
    _close(tref.ssd_ref(tx, tdt_, tA, tB, tC), oracle, tol)
    # the plain version at the chunk the entry point picked
    Q = tops._pick_block(S, chunk)
    assert Q == jops._pick_block(S, chunk) and S % Q == 0
    _close(tref.ssd_scan_ref(tx, tdt_, tdt_ * tA, tB, tC, Q),
           y.float().numpy(), 0)
    if jdt == jnp.float32:
        pallas = jops.ssd_scan(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                               chunk=chunk, interpret=True)
        _close(y, pallas, tol)


@pytest.mark.parametrize("S", [130, 96])
def test_ssd_chunked_matches_jax_with_final_state(S):
    """The model's chunked scan, S ragged (the dt=0 tail pad) or aligned,
    from a given initial state; y and the final state."""
    B, H, P, N, chunk = 2, 4, 32, 16, 32
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, N, seed=7)
    s0 = np.random.default_rng(8).standard_normal(
        (B, H, P, N)).astype(np.float32)
    jy, js = _jax_ssd_chunked(*(jnp.asarray(v) for v in
                                (x, dt, A, Bm, Cm)), chunk,
                              jnp.asarray(s0))
    ty, ts = TSSM.ssd_chunked(*(torch.from_numpy(v) for v in
                                (x, dt, A, Bm, Cm)), chunk,
                              init_state=torch.from_numpy(s0))
    assert ty.shape == (B, S, H, P) and ts.shape == (B, H, P, N)
    _close(ty, jy, 1e-5)
    _close(ts, js, 1e-5)
    # without an initial state it is the scan of the kernel
    ty0, _ = TSSM.ssd_chunked(*(torch.from_numpy(v) for v in
                                (x, dt, A, Bm, Cm)), chunk)
    _close(ty0, _jax_ssd_ref(*(jnp.asarray(v) for v in
                               (x, dt, A, Bm, Cm))), 1e-4)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for init in (None, st):
        jy, jst = JSSM._causal_conv(
            jnp.asarray(u), jnp.asarray(w), jnp.asarray(b),
            None if init is None else jnp.asarray(init))
        ty, tst = TSSM._causal_conv(
            torch.from_numpy(u), torch.from_numpy(w), torch.from_numpy(b),
            None if init is None else torch.from_numpy(init))
        _close(ty, jy, 1e-6)
        _close(tst, jst, 0)


def test_rmsnorm_gated_matches_jax():
    rng = np.random.default_rng(4)
    y, z = (rng.standard_normal((2, 5, 64)).astype(np.float32)
            for _ in range(2))
    s = rng.standard_normal(64).astype(np.float32)
    _close(TSSM._rmsnorm_gated(*(torch.from_numpy(v) for v in (y, z, s)),
                               1e-5),
           JSSM._rmsnorm_gated(*(jnp.asarray(v) for v in (y, z, s)), 1e-5),
           1e-5)


@pytest.fixture(scope="module")
def mamba():
    jcfg = dataclasses.replace(jax_reduced("mamba2-780m"), dtype="float32")
    tcfg = dataclasses.replace(get_reduced_config("mamba2-780m"),
                               dtype="float32")
    jparams = jax.jit(jax_init_params, static_argnums=(0, 1))(jcfg, 0)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("use_kernels", [False, True])
def test_ssm_train_matches_jax(mamba, use_kernels):
    """One SSD block of reduced mamba2-780m (d_model 256, 16 heads of 32,
    state 32, chunk 32) on S=80 — two full chunks and a ragged one on the
    reference route, four chunks of 20 (``_pick_block``) through
    ``ops.ssd_scan`` — against the JAX block on the same route."""
    jcfg, tcfg, jparams, tparams = mamba
    x = np.random.default_rng(5).standard_normal(
        (2, 80, jcfg.d_model)).astype(np.float32) * 0.5
    jp = jax.tree.map(lambda l: l[0], jparams["layers"][0]["ssm"])
    tp = {k: v[0] for k, v in tparams["layers"][0]["ssm"].items()}
    jy = jax.jit(functools.partial(JSSM.ssm_train, cfg=jcfg,
                                   use_pallas=use_kernels))(jp,
                                                            jnp.asarray(x))
    ty = TSSM.ssm_train(tp, torch.from_numpy(x), tcfg,
                        use_kernels=use_kernels)
    _close(ty, jy, 1e-5)


# ----------------------------------------------- autograd through kernels ----

def _plain_kernels(monkeypatch):
    """Replace the kernel launches by their plain versions, so the autograd
    functions run on the CPU; count the calls as the wrappers do."""
    calls = {"ssd": 0, "fa": 0}

    def ssd(x, dt, a, Bm, Cm, chunk):
        calls["ssd"] += 1
        return tref.ssd_scan_ref(x, dt, a, Bm, Cm, chunk)

    def fa(q, k, v, window=None):
        calls["fa"] += 1
        return tref.attention_ref(q, k, v, window=window)

    monkeypatch.setattr(tops._ssd, "ssd_scan_bshp", ssd)
    monkeypatch.setattr(tops._fa, "flash_attention_bshd", fa)
    return calls


def _grads(fn, inputs):
    ins = [t.clone().requires_grad_(t.is_floating_point()) for t in inputs]
    out = fn(*ins)
    w = torch.from_numpy(np.random.default_rng(9).standard_normal(
        out.shape).astype(np.float32))
    g = torch.autograd.grad((out.float() * w).sum(),
                            [t for t in ins if t.requires_grad])
    return out.detach(), g


def test_ssd_scan_function_grads_match_plain_autograd(monkeypatch):
    calls = _plain_kernels(monkeypatch)
    x, dt, A, Bm, Cm = (torch.from_numpy(v) for v in
                        _ssd_inputs(1, 64, 2, 16, 8, seed=11))
    a = dt * A
    got = _grads(lambda *t: tops._SSDScan.apply(*t, 32), (x, dt, a, Bm, Cm))
    want = _grads(lambda *t: tref.ssd_scan_ref(*t, 32), (x, dt, a, Bm, Cm))
    assert calls["ssd"] == 1                  # the backward never launches
    _close(got[0], want[0].numpy(), 0)
    for g, w in zip(got[1], want[1]):
        _close(g, w.numpy(), 1e-6)
    # only the inputs that ask for a gradient get one
    xg = x.clone().requires_grad_(True)
    y = tops._SSDScan.apply(xg, dt, a, Bm, Cm, 32)
    (gx,) = torch.autograd.grad(y.sum(), [xg])
    assert gx.shape == x.shape


def test_flash_attention_function_grads_match_plain_autograd(monkeypatch):
    calls = _plain_kernels(monkeypatch)
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 24, n, 16)).astype(
        np.float32)) for n in (4, 2, 2))
    for window in (None, 8):
        got = _grads(lambda *t: tops._FlashAttention.apply(*t, window),
                     (q, k, v))
        want = _grads(lambda *t: tref.attention_ref(*t, window=window),
                      (q, k, v))
        _close(got[0], want[0].numpy(), 0)
        for g, w in zip(got[1], want[1]):
            _close(g, w.numpy(), 1e-6)
    assert calls["fa"] == 2


@pytest.mark.parametrize("arch", ["mamba2-780m", "stablelm-3b"])
def test_training_through_kernel_functions_under_recompute(monkeypatch,
                                                           arch):
    """The training path as it runs on the card — every scan / attention
    call through the autograd functions, inside layer recomputation — gives
    the gradients of the plain path, and launches the kernel twice per
    layer (the forward and its recompute)."""
    from repro_torch.configs import RunConfig
    from repro_torch.models import init_params, loss_fn
    from repro_torch.tree import leaves

    calls = _plain_kernels(monkeypatch)
    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
    params = init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(13)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    xs = [p.requires_grad_(True) for p in leaves(params)]

    def grads(use_kernels, remat):
        loss, _ = loss_fn(params, batch, cfg,
                          RunConfig(use_kernels=use_kernels, remat=remat))
        return loss, torch.autograd.grad(loss, xs)

    want = grads(False, "none")
    monkeypatch.setattr(tops, "_on_card", lambda t: True)
    got = grads(True, "layer")
    assert calls["ssd" if arch.startswith("mamba") else "fa"] == \
        2 * cfg.num_layers
    _close(got[0], want[0].detach().numpy(), 1e-5)
    for g, w in zip(got[1], want[1]):
        _close(g, w.numpy(), 1e-5)


# ------------------------------------------------------ wrapper refusals ----

def test_ssd_wrapper_refuses_before_build():
    """Checks run before the library is asked for, so none of these needs
    nvcc; a CPU tensor is refused by the wrapper (the entry point sends
    CPU tensors to the plain version instead)."""
    x, dt, A, Bm, Cm = (torch.from_numpy(v) for v in
                        _ssd_inputs(1, 64, 2, 16, 8))
    a = dt * A
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan_bshp(x, dt, a, Bm, Cm, 32)
    meta = [t.to("meta") for t in (x, dt, a, Bm, Cm)]
    with pytest.raises(ValueError, match="no attention kernel"):
        tops.ssd_scan(meta[0], meta[1], A.to("meta"), meta[3], meta[4])
    assert tssd.launches == 0
