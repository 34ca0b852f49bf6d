"""The port's attention entry points (``repro_torch.kernels.ops``) on CPU
tensors — the plain versions of the CUDA kernels — against the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs: the
``ATTN_CASES`` sweep of ``tests/test_kernels.py`` plus head_dim 80 and GQA
cases, dense / ring / paged decode, f32 and bf16.  Also: the CUDA
wrappers refuse what their kernels do not take, before any build; the
attention backward's routing by dtype, its launch counter and its kernel
names.

Tolerance: 2e-5 in f32 (summation order); 2e-2 in bf16 (one bf16 rounding
of outputs of magnitude up to ~2)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import attention_bwd as tab
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops

DTYPES = [(jnp.float32, torch.float32, 2e-5),
          (jnp.bfloat16, torch.bfloat16, 2e-2)]
DTYPE_IDS = ["f32", "bf16"]


def _pair(rng, shape, jdt, tdt):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


ATTN_CASES = [
    # (B, S, H, K, Dh, window, block) — tests/test_kernels.py's sweep ...
    (2, 128, 4, 2, 64, None, 64),
    (1, 256, 8, 8, 64, None, 128),
    (2, 128, 4, 1, 32, 64, 64),
    (1, 512, 4, 2, 128, 128, 128),
    (1, 64, 2, 2, 16, None, 64),
    (2, 96, 3, 1, 32, None, 32),
    # ... plus stablelm-3b's head_dim 80 and qwen2-7b's GQA group of 7
    (1, 128, 4, 4, 80, None, 64),
    (1, 64, 14, 2, 128, 24, 32),
]


@pytest.mark.parametrize("B,S,H,K,Dh,window,block", ATTN_CASES)
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=DTYPE_IDS)
def test_flash_attention_matches_pallas(B, S, H, K, Dh, window, block,
                                        jdt, tdt, tol):
    rng = np.random.default_rng(B * 1000 + S + H + Dh)
    jq, tq = _pair(rng, (B, S, H, Dh), jdt, tdt)
    jk, tk = _pair(rng, (B, S, K, Dh), jdt, tdt)
    jv, tv = _pair(rng, (B, S, K, Dh), jdt, tdt)
    ref = jops.flash_attention(jq, jk, jv, window=window, block_q=block,
                               block_k=block, interpret=True)
    out = tops.flash_attention(tq, tk, tv, window=window)
    assert out.dtype == tdt and out.shape == (B, S, H, Dh)
    _close(out, ref, tol)


DECODE_CASES = [
    # (B, S, H, K, Dh, window)
    (3, 64, 4, 2, 64, None),
    (2, 48, 4, 4, 80, None),
    (2, 32, 14, 2, 128, None),       # GQA group of 7
    (3, 16, 4, 2, 64, 16),           # ring: slots == window
    (2, 16, 4, 1, 32, 24),           # ring: window past the slots
]


@pytest.mark.parametrize("B,S,H,K,Dh,window", DECODE_CASES)
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=DTYPE_IDS)
def test_flash_decode_matches_pallas(B, S, H, K, Dh, window, jdt, tdt, tol):
    rng = np.random.default_rng(S + H + Dh)
    jq, tq = _pair(rng, (B, 1, H, Dh), jdt, tdt)
    jk, tk = _pair(rng, (B, S, K, Dh), jdt, tdt)
    jv, tv = _pair(rng, (B, S, K, Dh), jdt, tdt)
    # early, mid and wrapped positions (a ring wraps once pos >= S)
    pos = np.array([0, S // 2, 3 * S + 5][:B], np.int32) if window else \
        np.array([0, S // 2, S - 1][:B], np.int32)
    ref = jops.flash_decode(jq, jk, jv, jnp.asarray(pos), interpret=True,
                            window=window)
    out = tops.flash_decode(tq, tk, tv, torch.from_numpy(pos), window=window)
    assert out.dtype == tdt and out.shape == (B, 1, H, Dh)
    _close(out, ref, tol)


PAGED_CASES = [
    # (H, K, Dh, page_size)
    (4, 2, 64, 16),
    (4, 4, 80, 16),
    (14, 2, 128, 8),
]


@pytest.mark.parametrize("H,K,Dh,ps", PAGED_CASES)
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=DTYPE_IDS)
def test_flash_decode_paged_matches_pallas(H, K, Dh, ps, jdt, tdt, tol):
    rng = np.random.default_rng(H + Dh + ps)
    num_pages = 12
    jq, tq = _pair(rng, (3, 1, H, Dh), jdt, tdt)
    jk, tk = _pair(rng, (num_pages, ps, K, Dh), jdt, tdt)
    jv, tv = _pair(rng, (num_pages, ps, K, Dh), jdt, tdt)
    # null pages (0) past each row's live pages; positions differ per row
    table = np.array([[5, 0, 0, 0], [3, 9, 1, 0], [2, 7, 11, 4]], np.int32)
    pos = np.array([ps - 3, 2 * ps + 1, 4 * ps - 1], np.int32)
    ref = jops.flash_decode_paged(jq, jk, jv, jnp.asarray(table),
                                  jnp.asarray(pos), interpret=True)
    out = tops.flash_decode_paged(tq, tk, tv, torch.from_numpy(table),
                                  torch.from_numpy(pos))
    assert out.dtype == tdt and out.shape == (3, 1, H, Dh)
    _close(out, ref, tol)


# ------------------------------------------- the CUDA wrappers' guards ----

def _qkv(H=4, K=2, Dh=64, S=8, dtype=torch.float32, device="cpu"):
    return (torch.zeros(1, S, H, Dh, dtype=dtype, device=device),
            torch.zeros(1, S, K, Dh, dtype=dtype, device=device),
            torch.zeros(1, S, K, Dh, dtype=dtype, device=device))


@pytest.mark.parametrize("call", [
    lambda: tfa.flash_attention_bshd(*_qkv()),
    lambda: tfd.flash_decode_bshd(*(t[:, :1] if i == 0 else t
                                    for i, t in enumerate(_qkv())),
                                  torch.zeros(1, dtype=torch.int32)),
    lambda: tfd.flash_decode_paged_bshd(
        torch.zeros(1, 1, 4, 64), torch.zeros(3, 4, 2, 64),
        torch.zeros(3, 4, 2, 64), torch.zeros(1, 2, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32)),
    lambda: tab.attention_bwd_bshd(*_qkv(dtype=torch.bfloat16),
                                   _qkv(dtype=torch.bfloat16)[0]),
], ids=["flash_attention", "flash_decode", "flash_decode_paged",
        "attention_bwd"])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """On a CPU tensor a wrapper raises at once: it never builds, never
    falls back and never counts a launch."""
    before = tops.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
    assert tops.launch_counts() == before


class _FakeCuda:
    """A meta tensor (no memory) that reports a CUDA device, so the
    wrapper's shape and dtype checks run without a card."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._t, name)


@pytest.mark.parametrize("kwargs,match", [
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(Dh=160), "head_dim"),
    (dict(H=6, K=4), "multiple"),
])
def test_flash_attention_checks_shapes_and_dtypes(kwargs, match):
    q, k, v = (_FakeCuda(t) for t in _qkv(device="meta", **kwargs))
    with pytest.raises((TypeError, ValueError), match=match):
        tfa._check(q, k, v)


@pytest.mark.parametrize("kwargs,match", [
    (dict(dtype=torch.float32), "bfloat16"),
    (dict(Dh=160), "head_dim"),
    (dict(H=6, K=4), "multiple"),
    (dict(do_S=4), "does not match"),
])
def test_attention_bwd_checks_shapes_and_dtypes(kwargs, match):
    do_S = kwargs.pop("do_S", 8)
    kwargs.setdefault("dtype", torch.bfloat16)
    q, k, v = (_FakeCuda(t) for t in _qkv(device="meta", **kwargs))
    do = _FakeCuda(_qkv(device="meta", S=do_S, **kwargs)[0])
    with pytest.raises((TypeError, ValueError), match=match):
        tab._check(q, k, v, do)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_attention_backward_routes_by_dtype(monkeypatch, dtype):
    """bf16: the backward calls the backward kernel's wrapper once, with
    the forward's window and scale, and returns its gradients (None where
    none is asked for); f32: the plain recompute under autograd.  CPU
    stand-ins take the wrappers' places."""
    from repro_torch.kernels import ref

    calls = []

    def fake_bwd(q, k, v, do, window=None, scale=None):
        calls.append((window, scale))
        ins = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
        with torch.enable_grad():
            out = ref.attention_ref(*ins, window=window, scale=scale)
        return tuple(g.to(dtype) for g in torch.autograd.grad(
            out, ins, do.float()))

    monkeypatch.setattr(tops._fa, "flash_attention_bshd",
                        lambda q, k, v, window=None, scale=None:
                        ref.attention_ref(q, k, v, window=window,
                                          scale=scale))
    monkeypatch.setattr(tops._fa_bwd, "attention_bwd_bshd", fake_bwd)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 12, n, 16)).astype(np.float32)).to(dtype) for n in (4, 2, 2))
    q.requires_grad_(True)
    k.requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    out = tops._FlashAttention.apply(q, k, v, 5, 0.25)
    gq, gk = torch.autograd.grad((out.float() * w).sum(), (q, k))
    assert calls == ([(5, 0.25)] if dtype == torch.bfloat16 else [])
    assert v.grad is None
    ins = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        (ref.attention_ref(*ins, window=5, scale=0.25) * w).sum(), ins[:2])
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for g, r in zip((gq, gk), want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), r, atol=tol, rtol=tol)


def test_attention_bwd_reads_the_output_gradient_aligned():
    """The output's gradient is read as it is where the kernel's 16-byte
    copies can read it, else from a copy whose rows are padded to 16
    bytes, with the same values."""
    from repro_torch.kernels import build

    ok = torch.zeros(2, 5, 3, 48, dtype=torch.bfloat16)[..., :24]
    assert tab._aligned(ok) is ok
    for t in (torch.randn(2, 5, 3, 20).to(torch.bfloat16),
              torch.randn(2, 5, 24, 3).to(torch.bfloat16).transpose(2, 3)):
        got = tab._aligned(t)
        assert got is not t and build.aligned(got) and got.stride(-1) == 1
        assert torch.equal(got, t)


def test_launch_counters_carry_attention_bwd():
    """``attention_bwd`` counts wrapper calls, and the three counter
    functions carry it as they carry every kernel's."""
    tops.reset_launch_counts()
    assert tops.launch_counts()["attention_bwd"] == 0
    tops.add_launch_counts({"attention_bwd": 3, "flash_attention": 6}, 2)
    assert tops.launch_counts()["attention_bwd"] == 6
    tops.add_launch_counts({"attention_bwd": 3}, -2)
    assert tops.launch_counts()["attention_bwd"] == 0
    tab.launches = 4
    assert tops.launch_counts()["attention_bwd"] == 4
    tops.reset_launch_counts()
    assert set(tops.launch_counts().values()) == {0}


def test_backward_kernel_names_stay_out_of_the_forward_roofline():
    """Every kernel of ``attention_bwd.cu`` is named ``attn_bwd_...``
    and none matches the forward's roofline patterns
    (``cardbench/roofline/flash_attention.py``), so the forward's share
    never counts the backward's time, and no forward kernel matches the
    backward's pattern."""
    import importlib.util
    import re
    from pathlib import Path

    from repro_torch.kernels import build

    root = Path(__file__).resolve().parents[1] / "cardbench" / "roofline"

    def patterns(name):
        spec = importlib.util.spec_from_file_location(
            f"roofline_{name}", root / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.PATTERNS

    def kernels(src):
        text = (build.CSRC / src).read_text()
        return re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                          r"\([^)]*\)\s+)?(\w+)", text)

    bwd, fwd = kernels("attention_bwd.cu"), kernels("flash_attention.cu")
    assert sorted(bwd) == ["attn_bwd_dkdv_kernel", "attn_bwd_dq_kernel",
                           "attn_bwd_pre_kernel"]
    assert len(fwd) == 2
    for name in bwd:
        assert not any(p in name for p in patterns("flash_attention"))
        assert any(p in name for p in patterns("attention_bwd"))
    for name in fwd:
        assert not any(p in name for p in patterns("attention_bwd"))
        assert any(p in name for p in patterns("flash_attention"))


def test_ops_refuse_unknown_devices():
    q, k, v = _qkv(device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        tops.flash_attention(q, k, v)
