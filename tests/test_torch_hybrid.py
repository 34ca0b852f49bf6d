"""granite-4.0-h-micro in the port, on the CPU at reduced size: the
attention layer's offset and the muP scalars of its config, the
softmax scale of the attention kernels' entry points (``None`` the old
arithmetic bit for bit), the SSD decode step's plain route against the
token-by-token recurrence and its CUDA source emulated on the host
(``kernels/host_emulation.py``), the paged hybrid cache against the
dense one through ``DecodeEngine``, an admission overwriting a slot's
SSM rows whole, the engine's guards and SSM gauge, the ``ssm`` and
``ssm_prefill`` spans, the serve CLI, and ``chip_smoke.py``'s launch
sum over the main path.

Tolerances: 1e-5 where two f32 routes sum the same terms in another
order; exact equality where the arithmetic is the same."""
import contextlib
import dataclasses
import io
import itertools

import numpy as np
import pytest
import torch

from repro_torch.configs import (
    ARCH_IDS, PORT_ARCH_IDS, RunConfig, get_config, get_reduced_config,
)
from repro_torch.kernels import ops, ref
from repro_torch.models import model as M
from repro_torch.models.init import init_params
from repro_torch.monitoring import Tracer
from repro_torch.serving import DecodeEngine, Request

ARCH = "granite-4.0-h-micro"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def granite():
    cfg = dataclasses.replace(get_reduced_config(ARCH), dtype="float32")
    return cfg, init_params(cfg, 0, device="cpu")


def test_the_config_places_attention_at_its_offset():
    assert ARCH in PORT_ARCH_IDS and ARCH not in ARCH_IDS
    cfg = get_config(ARCH)
    kinds = cfg.layer_kinds()
    assert [i for i, k in enumerate(kinds) if k == "attn"] == [5, 15, 25, 35]
    assert get_reduced_config(ARCH).layer_kinds() == ["ssm", "attn"] * 2
    assert 3.18e9 < cfg.param_count() < 3.20e9
    # the default offset places attention first in each period, as before
    jamba = get_config("jamba-1.5-large-398b")
    assert [i for i, k in enumerate(jamba.layer_kinds())
            if k == "attn"] == list(range(0, 72, 8))


def test_mup_scalars_scale_the_stream(granite):
    cfg, params = granite
    tok = torch.tensor([[3, 7, 11]])
    table = params["embed"]["tok"]
    assert torch.equal(M.embed_tokens(params, tok, cfg),
                       table[tok] * cfg.embedding_multiplier)
    h = torch.randn(1, 3, cfg.d_model)
    assert torch.equal(M.unembed(params, h, cfg),
                       torch.einsum("bsd,vd->bsv", h, table) / 8.0)
    x = torch.randn(2, cfg.d_model)
    assert torch.equal(M.residual(x, h[0, :2], cfg), x + h[0, :2] * 0.22)
    # without the scalars nothing is multiplied: the same tensor object
    assert M.times(x, 1.0) is x


def _attn_inputs(g, S=24, H=4, K=2, Dh=16):
    return (torch.randn(2, S, H, Dh, generator=g),
            torch.randn(2, S, K, Dh, generator=g),
            torch.randn(2, S, K, Dh, generator=g))


def _plain(q, k, v, scale, mask):
    G = q.shape[2] // k.shape[2]
    kk, vv = k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * scale
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv)


def test_scale_none_is_the_old_arithmetic_and_a_scale_is_used():
    g = torch.Generator().manual_seed(0)
    q, k, v = _attn_inputs(g)
    Dh = q.shape[-1]
    S = q.shape[1]
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    for scale in (None, 1 / 64):
        got = ops.flash_attention(q, k, v, scale=scale)
        want = _plain(q, k, v, Dh ** -0.5 if scale is None else scale,
                      causal)
        assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(ops.flash_attention(q, k, v),
                       ops.flash_attention(q, k, v, scale=Dh ** -0.5))
    # decode over a dense cache and a paged pool
    qd = q[:, :1]
    pos = torch.tensor([20, 9], dtype=torch.int32)
    valid = torch.arange(S)[None, None, None, :] <= pos[:, None, None, None]
    pool_k = k.reshape(2 * S // 8, 8, *k.shape[2:])
    pool_v = v.reshape(2 * S // 8, 8, *v.shape[2:])
    table = torch.arange(2 * S // 8, dtype=torch.int32).reshape(2, -1)
    for scale in (None, 1 / 64):
        want = _plain(qd, k, v, Dh ** -0.5 if scale is None else scale,
                      valid)
        dense = ops.flash_decode(qd, k, v, pos, scale=scale)
        paged = ops.flash_decode_paged(qd, pool_k, pool_v, table, pos,
                                       scale=scale)
        assert torch.allclose(dense, want, atol=1e-5, rtol=1e-5)
        assert torch.equal(paged, dense)
    assert torch.equal(ops.flash_decode(qd, k, v, pos),
                       ops.flash_decode(qd, k, v, pos, scale=Dh ** -0.5))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_a_config_without_a_multiplier_keeps_its_bits(use_kernels):
    """``attention_multiplier=None`` is ``1/sqrt(head_dim)`` bit for bit
    on every attention route of the model, and another value moves it."""
    cfg = dataclasses.replace(get_reduced_config("stablelm-3b"),
                              dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    run = RunConfig(use_kernels=use_kernels)
    toks = torch.randint(2, cfg.vocab_size, (1, 20),
                         generator=torch.Generator().manual_seed(1))
    same = dataclasses.replace(cfg, attention_multiplier=cfg.head_dim ** -0.5)
    other = dataclasses.replace(cfg, attention_multiplier=0.02)
    outs = []
    for c in (cfg, same, other):
        logits, cache = M.prefill(params, {"tokens": toks}, c, run,
                                  cache_len=32)
        full = M.init_cache(c, 1, 32)
        for dst, src in zip(full["layers"], cache["layers"]):
            for name in ("k", "v"):
                dst[name][:, :, :20] = src[name]
        step, _ = M.decode_step(params, full, toks[:, -1:], 20, c, run)
        outs.append((logits, step))
    assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
    assert not torch.equal(outs[0][0], outs[2][0])


def test_decode_step_plain_route_is_the_recurrence():
    """Steps of ``ssd_decode_step`` (the CPU route of ``kernels.ops``)
    from a zero state give the token-by-token oracle's y, plus D x."""
    g = torch.Generator().manual_seed(2)
    B, S, H, P, N = 2, 9, 3, 8, 16
    x = torch.randn(B, S, H, P, generator=g)
    dt = torch.rand(B, S, H, generator=g) * 0.3
    A_ = -torch.rand(H, generator=g) * 4 - 0.5
    D = torch.randn(H, generator=g)
    Bm, Cm = torch.randn(B, S, N, generator=g), torch.randn(B, S, N,
                                                            generator=g)
    state = torch.zeros(B, H, P, N)
    ys = [ops.ssd_decode_step(state, x[:, t], dt[:, t], A_, D, Bm[:, t],
                              Cm[:, t]) for t in range(S)]
    want = ref.ssd_ref(x, dt, A_, Bm, Cm) + x * D[:, None]
    assert torch.allclose(torch.stack(ys, 1), want, atol=1e-5, rtol=1e-5)
    # the state after the steps is the chunked scan's final state
    _, final = ref.ssd_chunks(x * dt[..., None], dt * A_, Bm, Cm, S)
    assert torch.allclose(state, final, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,H,P,N,dtype", [
    (3, 2, 24, 16, torch.float32), (2, 3, 64, 128, torch.bfloat16),
    (1, 2, 5, 4, torch.float32), (2, 1, 33, 32, torch.bfloat16)])
def test_the_cuda_source_emulated_is_the_plain_step(tmp_path_factory, B, H,
                                                    P, N, dtype):
    """``csrc/ssd_decode.cu`` built for the host, driven through the
    wrapper's own argument list on x, B and C lying batch-minor (as the
    decode step's conv output does), against the plain step; the state
    within f32 rounding, y within one rounding of its dtype."""
    from repro_torch.kernels import host_emulation
    from repro_torch.kernels import ssd_decode as sd

    lib = host_emulation.build("ssd_decode",
                               tmp_path_factory.getbasetemp() / "ssd_emu")
    g = torch.Generator().manual_seed(B * 100 + N)
    u = torch.randn(H * P + 2 * N, B, generator=g).to(dtype).t()
    x = u[:, :H * P].reshape(B, H, P)
    Bm, Cm = u[:, H * P:H * P + N], u[:, H * P + N:]
    dt = torch.rand(B, H, generator=g) * 0.3
    A_ = -torch.rand(H, generator=g) * 15 - 1
    D = torch.rand(H, generator=g) + 0.5
    state = torch.randn(B, H, P, N, generator=g)
    plain_state = state.clone()
    y = torch.empty(B, H, P, dtype=dtype)
    assert lib.repro_ssd_decode_step(*sd.step_args(
        state, x, dt, A_, D, Bm, Cm, y, None)) == 0
    want = ref.ssd_decode_step_ref(plain_state, x, dt, A_, D, Bm, Cm)
    assert torch.allclose(state, plain_state, atol=1e-6, rtol=1e-6)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    assert torch.allclose(y.float(), want.float(), atol=tol, rtol=tol)


def _serve(cfg, params, poison=False, **kw):
    """5 requests on 3 slots; with ``poison`` every SSM row holds NaN
    before they come."""
    eng = DecodeEngine(cfg, params, num_slots=3, cache_len=128,
                       decode_chunk=4, device="cpu", **kw)
    if poison:
        for c in eng.cache["layers"]:
            if "state" in c:
                for t in c.values():
                    t.fill_(float("nan"))
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate([(9, 20), (40, 7), (17, 30), (5, 12),
                                        (70, 9)])]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return [r.output for r in reqs], eng


@pytest.mark.parametrize("fused", [True, False])
def test_paged_hybrid_gives_the_dense_hybrids_tokens(granite, fused):
    """The same requests on 3 slots (5 requests, so slots are reused):
    greedy tokens of the paged hybrid cache (KV pages for the attention
    layers, per-slot SSM state) equal the dense cache's."""
    cfg, params = granite
    dense, _ = _serve(cfg, params, fused=fused)
    paged, eng = _serve(cfg, params, fused=fused, kv_page_size=16)
    assert paged == dense and eng.paging is not None
    held = sum(t.numel() * t.element_size() for c in eng.cache["layers"]
               if "state" in c for t in c.values())
    assert eng.metrics.gauge("serve_ssm_state_bytes").value() == held


@pytest.mark.parametrize("paging", [16, None])
def test_admission_overwrites_a_slots_ssm_rows(granite, paging):
    """An admission writes the slot's SSM ``state`` and ``conv`` rows
    whole: slots whose rows hold NaN before the requests come serve the
    tokens of a fresh engine's."""
    cfg, params = granite
    fresh, _ = _serve(cfg, params, kv_page_size=paging)
    poisoned, _ = _serve(cfg, params, poison=True, kv_page_size=paging)
    assert poisoned == fresh


def test_engine_guards_for_hybrid_configs(granite):
    cfg, params = granite
    for kw in (dict(prefix_cache=True), dict(speculate=2),
               dict(max_batch_tokens=16)):
        with pytest.raises(ValueError, match="cfg.ssm"):
            DecodeEngine(cfg, params, num_slots=2, cache_len=64,
                         kv_page_size=16, device="cpu", **kw)


def test_ssm_and_ssm_prefill_spans(granite):
    """A traced step: each token step holds an ``ssm`` span for each SSM
    layer and an ``attention`` span for each attention layer, each with
    its ``ffn``; each prefill ``ssm_prefill`` in place of ``ssm``."""
    cfg, params = granite
    tick = itertools.count()
    tr = Tracer(clock=lambda: next(tick) * 1e-3)
    eng = DecodeEngine(cfg, params, num_slots=2, cache_len=64,
                       decode_chunk=2, kv_page_size=16, tracer=tr,
                       device="cpu")
    for i, n in enumerate((10, 21)):
        eng.submit(Request(rid=i, prompt=np.arange(2, 2 + n, dtype=np.int32),
                           max_new_tokens=6))
    eng.step()
    spans = tr.spans()
    kids = {s.sid: [k.name for k in spans if k.parent == s.sid]
            for s in spans}
    steps = [s for s in spans if s.name == "token_step"]
    prefills = [s for s in spans if s.name == "PREFILL"]
    assert len(steps) == 2 and len(prefills) == 2
    layer = ["ssm", "ffn", "attention", "ffn"] * 2
    assert all(kids[s.sid] == layer + ["sample"] for s in steps)
    assert all(kids[s.sid] == [n.replace("ssm", "ssm_prefill")
                               for n in layer] for s in prefills)


def test_serve_cli_serves_granite_paged():
    from repro_torch.launch import serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--requests", "3", "--max-new", "4",
                         "--cache-len", "64", "--kv-paging", "16"])
    assert rc == 0
    assert "served 3 requests, 9 tokens" in out.getvalue()


def _span(name, start, end, cat="step", sid=0, parent=None):
    return {"sid": sid, "parent": parent, "name": name, "cat": cat,
            "track": ["t", "t"], "start": start, "end": end,
            "device_start": None, "device_end": None, "attrs": {}}


def test_step_spans_summarises_the_mixers():
    """``scripts/step_spans.py``: the SSM spans of a token step and of a
    prefill beside attention's, per token step of the window."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    import step_spans

    spans = [_span("step", 1.0, 1.1, sid=1),
             _span("PREFILL", 1.0, 1.02, "prefill", sid=2),
             _span("ssm_prefill", 1.0, 1.01, "model", sid=3, parent=2),
             _span("attention", 1.01, 1.012, "model", sid=4, parent=2),
             _span("launch", 1.03, 1.07, sid=5),
             _span("token_step", 1.03, 1.07, "model", sid=6, parent=5),
             _span("ssm", 1.03, 1.05, "model", sid=7, parent=6),
             _span("attention", 1.05, 1.054, "model", sid=8, parent=6),
             _span("ffn", 1.054, 1.06, "model", sid=9, parent=6),
             _span("wait", 1.07, 1.08, sid=10)]
    rec = {"steps": [{"t0": 1.0, "t1": 1.1, "token_steps": 2,
                      "traced": False, "prefill_s": 0.02}]}
    out = step_spans.serve_summary(rec, {"anchor": (0.0, 0),
                                         "spans": spans})
    assert out["model_host_ms"] == {
        "attention.decode": pytest.approx(2.0),
        "attention.prefill": pytest.approx(1.0),
        "ffn.decode": pytest.approx(3.0),
        "ssm.decode": pytest.approx(10.0),
        "ssm_prefill.prefill": pytest.approx(5.0),
        "token_step.decode": pytest.approx(20.0)}


def test_chip_smoke_sums_every_kernels_launches():
    """``chip_smoke.py``'s summary sums each kernel's launches over the
    main path, every kernel of ``ops.launch_counts()`` among them: the
    SSD decode step's from the serve runs, the scan's from training."""
    import importlib
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    cs = importlib.import_module("chip_smoke")

    def run(**n):
        return {"launches": {k: n.get(k, 0) for k in ops.launch_counts()}}

    serve = [run(flash_decode_paged=3, ssd_decode_step=36),
             run(flash_attention=2, ssd_decode_step=4, ssd_scan=9)]
    got = cs.main_path_launches(
        serve, run(ssd_scan=5, flash_attention=1),
        run(ssd_scan=7, flash_decode=1), [run(flash_attention=10)],
        {"launches": {"ssd_scan": 2}})
    assert got == {"flash_attention": 12, "flash_decode": 1,
                   "flash_decode_paged": 3, "ssd_scan": 14,
                   "ssd_decode_step": 40}
