"""The attention backward's roofline share on a synthetic record: calls x
the least time of one call over the device time of the ``attn_bwd_``
kernels, and no reading where the program counts no such call."""
import pytest

from harness import readers, spec, trace


def read(name, rec):
    return spec.metric_reader(name)(rec)


def test_attention_bwd_roofline():
    """The backward's share: calls x its least time over the device time
    of the ``attn_bwd_`` kernels; None with no calls (a program whose
    counters lack ``attention_bwd``); the forward's share leaves the
    backward's kernels out."""
    moe = spec.load_json(spec.HERE / "configs" / "qwen2-moe-a2.7b.json")
    mix = spec.load_json(spec.HERE / "traffic" / "fsdp4_4x2048.json")
    k = spec.kernel_work("attention_bwd")
    f, b = k.work(4, 2048, 16, 16, 128)
    assert f == 10 * 128 * (2048 * 2049 // 2) * 16 * 4
    assert b == 2 * 4 * 2048 * 128 * (3 * 16 + 4 * 16)
    assert readers.least_s(f, b)[1] == "operations"
    one = readers.least_s(f, b)[0]
    # rank 0's 24 calls (a layer each) took 8x their bound over the three
    # launches; the forward kernel's time beside them
    spent = 24 * one * 1e6 * 8
    names = ("void repro::(anonymous namespace)::attn_bwd_pre_kernel<8>"
             "(repro::(anonymous namespace)::BwdArgs)",
             "void repro::(anonymous namespace)::attn_bwd_dkdv_kernel<8>"
             "(repro::(anonymous namespace)::BwdArgs)",
             "void repro::(anonymous namespace)::attn_bwd_dq_kernel<8>"
             "(repro::(anonymous namespace)::BwdArgs)")
    ops = [(i * spent / 3, (i + 1) * spent / 3, n)
           for i, n in enumerate(names)]
    ops.append((spent, spent + 50.0,
                "flash_attention_mma_kernel<8>(AttnArgs)"))
    rec = {"config": moe, "traffic": mix, "ranks": 4,
           "trace": {"ops": ops, "wall_s": 1.0,
                     "launches": {"flash_attention": 48,
                                  "attention_bwd": 24}}}
    got = read("attention_bwd_roofline.train", rec)
    assert got == pytest.approx(12.5) and 0 < got < 100
    assert trace.matching_us(ops, spec.kernel_work(
        "flash_attention").PATTERNS) == pytest.approx(50.0)
    del rec["trace"]["launches"]["attention_bwd"]
    assert read("attention_bwd_roofline.train", rec) is None
    rec["trace"]["launches"]["attention_bwd"] = 0
    assert read("attention_bwd_roofline.train", rec) is None
    rec["trace"] = None
    assert read("attention_bwd_roofline.train", rec) is None
