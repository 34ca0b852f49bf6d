"""The metric arithmetic on synthetic records: rates over the whole
window, tails over every request, the idle share of a kernel timeline,
roofline shares and their refusal to read a share without device time."""
import math

import pytest

from harness import readers, spec, trace
from harness.clock import percentile


def read(name, rec):
    return spec.metric_reader(name)(rec)


def serve_rec(**kw):
    rec = {"window": {"t0": 10.0, "t1": 20.0, "close": 19.5},
           "requests": [], "steps": [], "prefills": [], "page_size": 16,
           "counters": {"prefix_reused_tokens": 0},
           "trace": None, "setup_s": 3.5,
           "config": spec.load_json(spec.HERE / "configs" /
                                    "stablelm-3b.json"),
           "traffic": {"engine": {"decode_chunk": 8}}}
    rec.update(kw)
    return rec


def test_percentile_matches_linear_ranks():
    xs = list(range(1, 101))
    assert percentile(xs, 95) == pytest.approx(95.05)
    assert percentile([5.0], 95) == 5.0
    assert percentile([1, 2], 50) == 1.5


def test_decode_rate_covers_the_whole_window():
    steps = [{"t0": 10.0, "t1": 12.0, "tokens": 100, "traced": False},
             {"t0": 12.0, "t1": 20.0, "tokens": 300, "traced": False}]
    rec = serve_rec(steps=steps)
    assert read("decode_tok_s", rec) == pytest.approx(400 / 10.0)


def test_train_rate_and_peak():
    steps = [{"t0": 0.0, "t1": 2.0, "tokens": 8192, "traced": False},
             {"t0": 2.0, "t1": 3.0, "tokens": 8192, "traced": False},
             {"t0": 3.0, "t1": 9.0, "tokens": 8192, "traced": True}]
    rec = {"steps": steps, "window_peak_bytes": 3 * 2**30}
    assert read("train_tok_s", rec) == pytest.approx(2 * 8192 / 3.0)
    assert read("peak_gib.train", rec) == 3.0


def test_idle_share_of_a_timeline():
    # two overlapping kernels (0-4 and 2-6 us) and one at 8-10: busy 8 us
    ops = [(0.0, 4.0, "a"), (2.0, 6.0, "b"), (8.0, 10.0, "c")]
    assert trace.busy_us(ops) == 8.0
    rec = {"trace": {"ops": ops, "wall_s": 20e-6}}
    for cell in ("decode", "train"):
        assert read(f"device_idle.{cell}", rec) == pytest.approx(60.0)
    assert read("device_idle.decode", {"trace": None}) is None
    b = trace.breakdown(ops)
    assert b["device_ops"][0][1] == pytest.approx(4e-6)
    assert b["idle_gaps"] == [["idle before c", pytest.approx(2e-6)]]


def test_short_names():
    name = ("void repro::(anonymous namespace)::split_decode_kernel<float, "
            "__nv_bfloat16, true>(repro::(anonymous namespace)::DecodeArgs)")
    assert trace.short_name(name) == "split_decode_kernel"


def test_roofline_of_the_paged_decode():
    c = spec.load_json(spec.HERE / "configs" / "stablelm-3b.json")
    lines = [[512, 600], [513]]
    k = spec.kernel_work("flash_decode_paged")
    least = c["num_hidden_layers"] * sum(
        readers.least_s(*k.work(l, 32, 32, 80))[0] for l in lines)
    spent_us = 2 * least * 1e6           # the kernels took twice the bound
    ops = [(0.0, spent_us, "void repro::split_decode_kernel<float, bf16,"
            " true>(DecodeArgs)"), (spent_us, spent_us + 5, "gemm")]
    rec = serve_rec(steps=[{"traced": True, "lines": lines}],
                    trace={"ops": ops, "wall_s": 1.0})
    assert read("flash_decode_paged_roofline.decode", rec) == \
        pytest.approx(50.0)
    # bytes bound: 2 B x (2 K Dh lines + 2 H Dh lanes)
    f, b = k.work([512], 32, 32, 80)
    assert b == 2 * (2 * 32 * 80 * 512 + 2 * 32 * 80)
    assert readers.least_s(f, b)[1] == "bytes"
    rec["trace"]["ops"] = ops[1:]
    with pytest.raises(RuntimeError, match="no device time"):
        read("flash_decode_paged_roofline.decode", rec)


def test_train_roofline_and_mfu():
    dense = spec.load_json(spec.HERE / "configs" / "stablelm-3b.json")
    mix = spec.load_json(spec.HERE / "traffic" / "packed_4x1024.json")
    f, b = spec.kernel_work("flash_attention").work(4, 1024, 32, 32, 80)
    assert f == 4 * 80 * (1024 * 1025 // 2) * 32 * 4
    assert b == 2 * 4 * 1024 * 80 * 128
    one = readers.least_s(f, b)[0]
    # 64 calls (32 layers, forward and its recompute) took 10x the bound
    ops = [(0.0, 64 * one * 1e6 * 10,
            "flash_attention_mma_kernel(AttnArgs)")]
    rec = {"config": dense, "traffic": mix,
           "trace": {"ops": ops, "wall_s": 1.0,
                     "launches": {"flash_attention": 64}},
           "steps": [{"t0": 0.0, "t1": 2.0, "tokens": 4096,
                      "traced": False}]}
    assert read("flash_attention_roofline.train", rec) == \
        pytest.approx(10.0)
    # 6 N D with N ~ 2.8e9 at 2,048 tokens/s: ~3.5%
    assert 3.2 < read("mfu.train", rec) < 4.2
    rec["trace"]["launches"] = {"flash_attention": 0}
    assert read("flash_attention_roofline.train", rec) is None
    rec["trace"]["launches"] = {"flash_attention": 64}
    rec["trace"]["ops"] = [(0.0, 5.0, "gemm")]
    with pytest.raises(RuntimeError, match="no device time"):
        read("flash_attention_roofline.train", rec)


def test_decode_step_and_mfu_leave_out_the_traced_steps():
    steps = [{"t0": 0.0, "t1": 0.5, "tokens": 1024, "decode_tokens": 1024,
              "decode_ctx": 1024 * 300, "token_steps": 8, "traced": False,
              "prefill_s": 0.1},
             {"t0": 0.5, "t1": 9.5, "tokens": 1024, "decode_tokens": 1024,
              "decode_ctx": 1024 * 300, "token_steps": 8, "traced": True,
              "prefill_s": 0.0}]
    rec = serve_rec(steps=steps, prefills=[(0.0, 0.1, 200, 0)])
    assert read("decode_step_ms", rec) == pytest.approx(1e3 * 0.4 / 8)
    mfu = read("mfu.decode", rec)
    assert 0 < mfu < 5 and math.isfinite(mfu)
