"""The hybrid family (granite-4.0-h-micro) on the CPU at a tiny size: its
leaves are the port's parameter tree, its check refuses what it cannot
map, the reference agrees with the port served paged through the
engine (prefill, then fused ``decode_n``), the decode cell runs, fails
on a planted fault and judges the control not correct, and the decode
step kernel's roofline is counted from the live lanes."""
import dataclasses
import time

import numpy as np
import pytest
import torch

import calibrate
from harness import bench, port, readers, spec, weights
from reference import hybrid

SEED = 2**31 + 303
CELL = "granite-4.0-h-micro.decode"
#: the tiny model: 4 layers, period 2 with attention at offset 1
WIDTHS = {"hidden_size": 64, "num_attention_heads": 4,
          "num_key_value_heads": 2, "head_dim": 16,
          "shared_intermediate_size": 96, "intermediate_size": 96,
          "vocab_size": 256, "num_hidden_layers": 4,
          "layer_types": ["mamba", "attention"] * 2, "mamba_n_heads": 8,
          "mamba_d_head": 16, "mamba_d_state": 16, "mamba_chunk_size": 8}
SERVE = {"clients": 4, "block": 8,
         "prompt": {"dist": "loguniform", "min": 8, "max": 40},
         "output": {"dist": "uniform", "min": 16, "max": 48},
         "engine": {"slots": 4, "cache_len": 128, "page_size": 16,
                    "prefix_cache": False, "decode_chunk": 4}}


#: the tiny model's own limit: its logits are a few hundredths (an
#: embedding of 64 columns drawn at 64 ** -0.5 / 12, the tied head), far
#: below the published model's; its program read at most 4.0e-4 over 3
#: seeds, the control at least 2.2e-3, ``token`` at least 0.059
LIMITS = {"sample": 8, "numbers": {"gap_max": 1e-3}}


def tiny_cell():
    full = spec.resolve(CELL)
    conf = dict(full.config, **WIDTHS)
    return dataclasses.replace(full, config=conf, limits=LIMITS,
                               traffic=dict(full.traffic, **SERVE))


def run(cell, fault=None):
    result, _ = bench.run_cell(cell, SEED, 1.0, False, "cpu",
                               time.perf_counter(), fault)
    return result


def test_the_published_file_maps_to_the_port():
    conf = spec.resolve(CELL).config
    fam = spec.family(conf)
    assert fam.schedule(conf) == (10, 5)
    cfg = port.model_config(conf, "bfloat16", "bfloat16")
    kinds = cfg.layer_kinds()
    assert [i for i, k in enumerate(kinds) if k == "attn"] == [5, 15, 25, 35]
    assert (cfg.pos_embedding, cfg.attention_multiplier, cfg.logits_scaling,
            cfg.embedding_multiplier, cfg.residual_multiplier) == \
        ("none", 0.015625, 8.0, 12.0, 0.22)
    assert cfg.ssm.num_heads(cfg.d_model) == 64 and cfg.ssm.state == 128
    # about 3.19 B parameters, as published
    assert 3.18e9 < cfg.param_count() < 3.20e9


@pytest.mark.parametrize("size", ["tiny", "published"])
def test_the_leaves_are_the_ports_spec(size):
    from repro_torch.models.spec import model_spec

    conf = tiny_cell().config if size == "tiny" else spec.resolve(CELL).config
    cfg = port.model_config(conf, "float32", "float32")
    if size == "tiny":
        port.check_layout(cfg, weights.make(conf, SEED, "cpu",
                                            torch.float32))
        return
    # the published size on no device: names and shapes only
    lay = {p: sh for p, sh, *_ in weights.layout(conf)}

    def walk(t, path, out):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}.{k}" if path else k, out)
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{path}.{i}", out)
        else:
            out[path] = tuple(t.shape)
        return out

    assert lay == walk(model_spec(cfg), "", {})


@pytest.mark.parametrize("change", [
    {"sliding_window": 4096},
    {"position_embedding_type": "rope"},
    {"mamba_n_groups": 2},
    {"layer_types": ["mamba"] * 4 + ["attention"] * 2 + ["mamba"] * 34},
    {"layer_types": ["mamba"] * 39 + ["cross"]},
    {"mamba_n_heads": 32},
], ids=["unmapped_key", "positions", "groups", "not_periodic",
        "unknown_kind", "heads_not_the_width"])
def test_a_file_the_family_does_not_map_is_refused(change):
    conf = dict(spec.resolve(CELL).config, **change)
    with pytest.raises(ValueError, match="family file of its own|entries"):
        spec.family(conf).port_kwargs(conf)


def test_the_reference_is_the_port_served_paged(one_thread):
    """Prefill then fused paged decode in f32 through ``DecodeEngine``:
    each decoded token's logits are the reference's full forward at its
    position (the pool holds bfloat16 lines: one rounding of k and v)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.serving import DecodeEngine, Request

    conf = tiny_cell().config
    cfg = port.model_config(conf, "float32", "float32")
    flat = weights.make(conf, SEED, "cpu", torch.float32)
    seen = []
    eng = DecodeEngine(cfg, weights.tree(flat), num_slots=2, cache_len=64,
                       run=RunConfig(use_kernels=True), decode_chunk=4,
                       fused=True, kv_page_size=16, device="cpu")
    assert eng.paging is not None
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, conf["vocab_size"], n).astype(np.int32)
               for n in (21, 9)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=12)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert eng.graphs.metrics.counter(
        "serve_decode_eager_token_steps").value() > 0
    for r in reqs:
        seq = torch.from_numpy(np.concatenate([r.prompt, r.output[:-1]]))
        want = hybrid.logits(flat, conf, seq.long(), len(r.prompt) - 1)
        top = want.argmax(-1)
        served = torch.tensor(r.output)
        gap = want.max(-1).values - want.gather(-1, served[:, None])[:, 0]
        seen.append(float(gap.max()))
        assert bool((top == served).all()) or float(gap.max()) < 1e-3
    assert max(seen) < 1e-3


def test_the_reference_chunks_are_the_sequential_scan():
    """The chunked dual form is the token-by-token recurrence."""
    g = torch.Generator().manual_seed(0)
    b, S, H, P, N = 2, 21, 3, 4, 5
    x = torch.randn(b, S, H, P, generator=g)
    dt = torch.rand(b, S, H, generator=g) * 0.5
    A = -torch.rand(H, generator=g) * 4 - 0.5
    Bm, Cm = torch.randn(b, S, N, generator=g), torch.randn(b, S, N,
                                                            generator=g)
    h = torch.zeros(b, H, P, N)
    want = []
    for t in range(S):
        h = h * torch.exp(dt[:, t] * A)[..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], Bm[:, t])
        want.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    want = torch.stack(want, 1)
    for chunk in (1, 4, 8, 32):
        got = hybrid.ssd(x, dt, A, Bm, Cm, chunk)
        assert torch.allclose(got, want, atol=1e-5, rtol=1e-5), chunk


def test_a_run_is_correct_and_a_fault_fails_it(one_thread, steady_clock):
    cell = tiny_cell()
    good = run(cell)
    assert good["correct"] is True and good["attempted"] > 0
    assert good["metrics"]["decode_tok_s"]["value"] > 0
    bad = run(cell, "token")
    assert bad["correct"] is False


def test_the_control_is_judged_not_correct(one_thread, steady_clock):
    cell = tiny_cell()
    got = dict(calibrate.readings(cell, SEED, 1.0, True, [], "cpu"))
    prog, ctl = got["program"], got["control"]
    assert bench.judge(prog, cell.limits)[0] is True
    assert bench.judge(ctl, cell.limits)[0] is False
    assert ctl["gap_max"] > 3 * prog["gap_max"]


def serve_rec(conf, lines, ops):
    return {"config": conf, "steps": [{"traced": True, "lines": lines}],
            "trace": {"ops": ops, "wall_s": 1.0}}


def test_roofline_of_the_decode_step():
    conf = spec.resolve(CELL).config
    k = spec.kernel_work("ssd_decode_step")
    f, b = k.work(384, 64, 64, 128)
    assert f == 6 * 64 * 64 * 128 * 384
    assert b == 384 * (8 * 64 * 64 * 128 + 2 * (2 * 64 * 64 + 2 * 128)
                       + 4 * 64) + 8 * 64
    assert readers.least_s(f, b)[1] == "bytes"
    # two token steps of 3 and 2 live lanes: 36 layers each
    lines = [[10, 20, 30], [11, 21]]
    least = 36 * (readers.least_s(*k.work(3, 64, 64, 128))[0]
                  + readers.least_s(*k.work(2, 64, 64, 128))[0])
    spent_us = 4 * least * 1e6
    ops = [(0.0, spent_us, "void repro::(anonymous namespace)::"
            "ssd_decode_step_kernel<__nv_bfloat16>(StepArgs)"),
           (spent_us, spent_us + 9, "gemm")]
    read = spec.metric_reader("ssd_decode_step_roofline.decode")
    assert read(serve_rec(conf, lines, ops)) == pytest.approx(25.0)
    # a program without the kernel (the eager recurrence): no reading
    assert read(serve_rec(conf, lines, ops[1:])) is None


def test_the_flops_are_a_hand_count():
    conf = spec.resolve(CELL).config
    fam = spec.family(conf)
    d, f, V = 2048, 8192, 100352
    attn = d * (32 + 16) * 64 + 32 * 64 * d
    ssm = d * (2 * 4096 + 256 + 64) + 4096 * d
    want = 2 * (4 * attn + 36 * ssm + 40 * 3 * d * f) \
        + 36 * (6 * 64 * 64 * 128 + 2 * 4 * 4352)
    assert fam.body_flops(conf) == want
    assert fam.head_flops(conf) == 2 * d * V
    assert fam.pair_flops(conf) == 4 * 4 * 32 * 64
    # 300 tokens: one whole chunk of 256 and 44 more
    pairs = 256 * 257 // 2 + 44 * 45 // 2
    assert fam.mixer_flops(conf, 300, 0) == \
        fam.pair_flops(conf) * 300 * 301 // 2 \
        + 36 * pairs * (2 * 128 + 2 * 64 * 64)
