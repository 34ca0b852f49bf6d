"""The four-rank training driver (``harness/train_ranks.py``) and the
sparse-expert family at a tiny size on the CPU: the family's leaves are
the port's parameter tree and its FLOPs a hand count; the plain
reference is the port's one-rank loss and gradients, also where a group
overflows an expert's capacity; one launch of four gloo ranks runs the
program and its ``half``, ``frozen`` and ``exchange`` faults, and the
program's record equals the one-rank driver's (``harness/train.py``) on
the same rows; the check passes the program and fails the faults and the
float8 control; the ranks' rows and the combination of their shard
norms.

The tiny cell computes in float32 (its mix's ``compute_dtype``, and
``harness/train.py`` given the same model) so that the four ranks and
the one rank differ by summation order only: 1e-5 relative on the
losses, and on each leaf's norms against the larger of its own and the
median leaf's (an all-but-zero gradient differs by its rounding)."""
import dataclasses
import math
import time

import numpy as np
import pytest
import torch

from harness import bench, port, spec, train, train_ranks, weights
from harness import mix as mixmod
from reference import common
from reference import moe as ref

SEED = 2**31 + 303
CELL = "qwen2-moe-a2.7b.train-fsdp4"
#: the widths of a tiny model of the family: 2 layers, 8 experts of 32, 4
#: a token, a shared SwiGLU two experts wide; groups of 32 tokens (an
#: expert has 20 slots a group)
WIDTHS = {"hidden_size": 64, "num_attention_heads": 4,
          "num_key_value_heads": 4, "head_dim": 16, "num_hidden_layers": 2,
          "vocab_size": 256, "num_experts": 8, "num_experts_per_tok": 4,
          "moe_intermediate_size": 32, "shared_expert_intermediate_size": 64,
          "intermediate_size": 64}
#: 4 ranks of 2 rows of 64 tokens; float32 compute and gathers
TRAIN = {"batch": 8, "seq_len": 64, "block": 8,
         "docs": {"dist": "lomax", "mean": 24},
         "compute_dtype": "float32", "gather_bf16": False}


def tiny_cell():
    full = spec.resolve(CELL)
    conf = dict(full.config, **WIDTHS)
    conf["port_moe"] = dict(conf["port_moe"], group_size=32)
    return dataclasses.replace(full, config=conf,
                               traffic=dict(full.traffic, **TRAIN))


@pytest.fixture(scope="module")
def launched():
    """One launch of four gloo ranks, one thread each: the program, then
    its ``half``, ``frozen`` and ``exchange`` faults, each with its
    traced step."""
    cell = tiny_cell()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.perf_counter()
        recs = train_ranks.launch(cell, SEED, 0.3, True, "cpu",
                                  [None, "half", "frozen", "exchange"])
        yield cell, t0, dict(zip(("program", "half", "frozen", "exchange"),
                                 recs))
    finally:
        torch.set_num_threads(n)


# ----------------------------------------------------------- the family ----

def meta_leaves(conf):
    return {p: torch.empty(sh, device="meta")
            for p, sh, *_ in spec.family(conf).leaves(conf)}


@pytest.mark.parametrize("size", ["published", "tiny"])
def test_the_leaves_are_the_ports_spec(size):
    conf = spec.resolve(CELL).config if size == "published" \
        else tiny_cell().config
    cfg = port.model_config(conf, "bfloat16", "float32")
    port.check_layout(cfg, meta_leaves(conf))
    assert (cfg.qkv_bias, cfg.mlp_type, cfg.sliding_window,
            cfg.tie_embeddings) == (True, "swiglu", None, False)
    assert cfg.moe.num_shared * cfg.moe.d_ff == \
        conf["shared_expert_intermediate_size"]
    assert (cfg.moe.group_size, cfg.moe.capacity_factor, cfg.moe.top_k) == \
        (conf["port_moe"]["group_size"], 1.25, conf["num_experts_per_tok"])
    if size == "published":
        n = sum(math.prod(t.shape) for t in meta_leaves(conf).values())
        assert n == cfg.param_count() == 14_315_735_040


def test_the_flops_are_a_hand_count():
    conf = spec.resolve(CELL).config
    fam = spec.family(conf)
    # a layer: q, k, v, o 4 x 2048 x 2048; router 2048 x 60; 4 routed
    # SwiGLUs 3 x 2048 x 1408 each and the shared 3 x 2048 x 5632
    layer = 4 * 2048 * 2048 + 2048 * 60 + 4 * 3 * 2048 * 1408 \
        + 3 * 2048 * 5632
    assert fam.body_flops(conf) == 2 * 24 * layer == 4_133_093_376
    assert fam.head_flops(conf) == 2 * 2048 * 151936
    pairs = 2048 * 2049 // 2
    assert fam.forward_flops(conf, 16, 2048) == 16 * (
        2048 * (2 * 24 * layer + 2 * 2048 * 151936)
        + 4 * 24 * 16 * 128 * pairs)
    # the active parameters the port counts, less norms, biases, embedding
    cfg = port.model_config(conf, "bfloat16", "float32")
    small = 24 * (2 * 2048 + 3 * 2048) + 2048
    assert fam.body_flops(conf) // 2 == \
        cfg.active_param_count() - small - 2 * 151936 * 2048


@pytest.mark.parametrize("conf_key", ["unknown_key", "qkv_bias",
                                      "shared_width", "port_moe"])
def test_a_file_the_family_does_not_map_is_refused(conf_key):
    conf = dict(spec.resolve(CELL).config)
    if conf_key == "unknown_key":
        conf["first_k_dense_replace"] = 1
    elif conf_key == "qkv_bias":
        conf["qkv_bias"] = False
    elif conf_key == "shared_width":
        conf["shared_expert_intermediate_size"] = 5000
    else:
        conf["port_moe"] = {"capacity_factor": 1.25}
    with pytest.raises(ValueError, match="family file of its own"):
        spec.family(conf).port_kwargs(conf)


# --------------------------------------------------------- the reference ----

@pytest.mark.parametrize("rows", ["packed", "overflowing"])
def test_the_reference_is_the_ports_one_rank_step(one_thread, rows):
    """Loss, router losses and every gradient; ``overflowing``: one token
    repeated, so that every token of a group picks the same experts and
    each takes more than its capacity."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.models.model import loss_fn

    conf = tiny_cell().config
    cfg = port.model_config(conf, "float32", "float32")
    flat = weights.make(conf, SEED, "cpu", torch.float32)
    g = torch.Generator().manual_seed(1)
    for k in flat:                     # biases that are not zero
        if ".attn.b" in k:
            flat[k] = 0.1 * torch.randn(flat[k].shape, generator=g)
    mix = dict(TRAIN, batch=2)
    b = {k: torch.from_numpy(v) for k, v in mixmod.train_batch(
        mix, conf["vocab_size"], SEED, 1).items()}
    if rows == "overflowing":
        b["tokens"][:] = 7
        assert ref.capacity(conf) < conf["port_moe"]["group_size"]
    xs = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    loss, metrics = loss_fn(weights.tree(xs), b, cfg,
                            RunConfig(use_kernels=False, remat="none"))
    grads = torch.autograd.grad(loss, list(xs.values()))
    W = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    xent, balance, z = ref.loss_parts(W, conf, b["tokens"].long(),
                                      b["labels"].long(), b["loss_mask"])
    groups, tokens = 2 * 64 // 32, 2 * 64
    want = xent / b["loss_mask"].sum() + 0.01 * balance / groups \
        + 1e-3 * z / tokens
    rgrads = torch.autograd.grad(want, list(W.values()))
    assert float(loss.detach()) == pytest.approx(float(want.detach()),
                                                 rel=1e-5)
    assert float(metrics["moe_balance_loss"].detach()) == \
        pytest.approx(float(balance.detach()) / groups, rel=1e-5)
    assert float(metrics["moe_z_loss"].detach()) == \
        pytest.approx(float(z.detach()) / tokens, rel=1e-5)
    for k, a, r in zip(flat, grads, rgrads):
        assert torch.allclose(a, r, atol=1e-6 + 1e-4 * float(r.abs().max()),
                              rtol=1e-3), k


def test_the_reference_logits_are_its_loss():
    """``logits`` of a sequence of whole groups give ``loss_parts``'s
    cross entropy."""
    conf = tiny_cell().config
    W = weights.make(conf, SEED, "cpu", torch.float32)
    rng = np.random.default_rng(0)
    toks, labels = (torch.from_numpy(rng.integers(2, conf["vocab_size"],
                                                  64)) for _ in range(2))
    lg = ref.logits(W, conf, toks, 0)
    assert lg.shape == (64, conf["vocab_size"])
    xent, _, _ = ref.loss_parts(W, conf, toks[None], labels[None],
                                torch.ones(1, 64))
    want = -torch.log_softmax(lg, -1).gather(1, labels[:, None]).sum()
    assert float(xent) == pytest.approx(float(want), rel=1e-5)


# ------------------------------------------------------------ the ranks ----

def test_four_ranks_are_the_one_rank_driver(one_thread, launched,
                                            monkeypatch):
    cell, _, recs = launched
    got = recs["program"]["program"]
    monkeypatch.setattr(train, "model_config", lambda c, d, p:
                        port.model_config(c, "float32", p))
    want = train.run(cell, SEED, 0.0, False, "cpu")["program"]
    assert got["losses"] == pytest.approx(want["losses"], rel=1e-5)
    assert set(got["grad_norms"]) == set(want["grad_norms"]) \
        == {p for p, *_ in spec.family(cell.config).leaves(cell.config)}
    for key in ("grad_norms", "change"):
        med = float(np.median(list(want[key].values())))
        for leaf, w in want[key].items():
            assert abs(got[key][leaf] - w) <= 1e-5 * max(w, med), \
                (key, leaf, got[key][leaf], w)


def test_the_record_of_a_traced_run(launched, monkeypatch):
    """The result line of the program's run, through ``bench.run_cell``:
    correct, the step's global tokens, the ranks' busy time averaged,
    rank 0's spans, the cell's per-layer metrics that a CPU trace has."""
    cell, t0, recs = launched
    rec = recs["program"]
    monkeypatch.setattr(train_ranks, "run", lambda *a, **k: rec)
    result, checks = bench.run_cell(cell, SEED, 0.3, True, "cpu", t0)
    assert result["correct"] is True and list(result)[-1] == "checks"
    assert result["attempted"] == len(rec["steps"]) >= 2
    assert result["failed"] == 0
    assert all(s["tokens"] == 8 * 64 for s in rec["steps"])
    assert [s["traced"] for s in rec["steps"]][-2:] == [False, True]
    t = rec["trace"]
    assert len(t["busy_s_ranks"]) == 4 and all(b > 0 for b in
                                               t["busy_s_ranks"])
    assert result["device"]["busy_s"] == pytest.approx(
        np.mean(t["busy_s_ranks"]))
    assert result["device"]["window_s"] == t["wall_s"]
    names = {s["name"] for s in rec["spans"]["spans"]}
    assert {"train_step", "forward", "backward", "optimizer"} <= names
    m = result["metrics"]
    # no NCCL kernel in a gloo run: its readers give nothing
    # and no attention kernel on the CPU: its roofline gives nothing
    assert set(m) == {"mfu.train", "peak_gib.train", "device_idle.train"}
    assert 0 < m["mfu.train"]["value"]


@pytest.mark.parametrize("fault", ["half", "frozen", "exchange"])
def test_a_fault_fails_the_check(launched, fault):
    cell, _, recs = launched
    ok, checks = bench.judge(
        train_ranks.check(recs[fault], SEED, "cpu", cell.limits),
        cell.limits)
    assert ok is False
    assert any(not c["value"] <= c["limit"] for c in checks.values())


def test_the_control_is_judged_not_correct(one_thread, launched):
    cell, _, recs = launched
    rec = recs["program"]
    prog = train_ranks.check(rec, SEED, "cpu", cell.limits)
    ctl = train_ranks.check(rec, SEED, "cpu", cell.limits, use=common.fp8)
    assert bench.judge(prog, cell.limits)[0] is True
    assert ctl["grad_gap"] > 3 * prog["grad_gap"]
    # by the cell's own limits
    assert bench.judge(ctl, cell.limits)[0] is False


# --------------------------------------------------- rows and shard norms ----

def test_the_ranks_rows():
    """Rank r takes rows ``[r * 4, r * 4 + 4)`` of 16 (``Layout.
    batch_rows``); microbatch i is every rank's i-th half of its rows."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.zero import Layout
    from repro_torch.launch.mesh import Mesh

    conf = tiny_cell().config
    cfg = port.model_config(conf, "bfloat16", "float32")
    run = RunConfig(strategy="fsdp", zero_stage=3)
    grid = np.empty((4, 1), dtype=object)
    grid[:] = [[torch.device("cpu")]] * 4
    starts = [Layout(cfg, Mesh(devices=grid, coords=(r, 0)), run)
              .batch_rows(16) for r in range(4)]
    assert starts == [(0, 4), (4, 4), (8, 4), (12, 4)]
    mix = {"ranks": 4, "batch": 16, "microbatches": 2}
    assert train_ranks._rows_of_microbatches(mix) == [
        [0, 1, 4, 5, 8, 9, 12, 13], [2, 3, 6, 7, 10, 11, 14, 15]]
    assert train_ranks._rows_of_microbatches(dict(mix, microbatches=1)) \
        == [list(range(16))]


def test_shard_norms_combine_to_the_leafs():
    """Every leaf of the tiny model is split four ways under fsdp ZeRO 3,
    and its four shards' squared norms add up to its own."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.zero import Layout
    from repro_torch.launch.mesh import Mesh
    from repro_torch.tree import leaves, leaves_with_path

    conf = tiny_cell().config
    cfg = port.model_config(conf, "bfloat16", "float32")
    run = RunConfig(strategy="fsdp", zero_stage=3)
    grid = np.empty((4, 1), dtype=object)
    grid[:] = [[torch.device("cpu")]] * 4
    tree = weights.tree(weights.make(conf, SEED, "cpu", torch.float32))
    parts = []
    for r in range(4):
        lay = Layout(cfg, Mesh(devices=grid, coords=(r, 0)), run)
        shard = lay.shard(tree)
        assert all(leaf.data_dim is not None and lay.owned(leaf)
                   for leaf in lay.leaves)
        parts.append({train_ranks.dotted(p): float(t.norm()) ** 2
                      for p, t in leaves_with_path(shard)})
    whole = {train_ranks.dotted(p): float(t.norm())
             for p, t in leaves_with_path(tree)}
    got = train_ranks.combine(parts)
    assert set(got) == set(whole)
    for k in whole:
        assert got[k] == pytest.approx(whole[k], rel=1e-6)
    assert train_ranks.combine([{"a": 9.0, "b": 0.0},
                                {"a": 16.0, "b": 4.0}]) == {"a": 5.0,
                                                           "b": 2.0}
    assert len(leaves(tree)) == len(whole)


def test_the_collectives_readers():
    """``nccl_ms``: device time of NCCL kernels; ``nccl_exposed``: the
    wall share where one runs and no other kernel does; nothing without
    NCCL kernels."""
    ops = [(0.0, 10.0, "ncclDevKernel_AllGather_RING_LL(x)"),
           (5.0, 20.0, "nvjet_gemm"),
           (25.0, 30.0, "ncclKernel_ReduceScatter_Sum_bf16")]
    rec = {"trace": {"ops": ops, "wall_s": 40e-6}}
    read = spec.metric_reader
    assert read("nccl_ms.train-fsdp4")(rec) == pytest.approx(0.015)
    # NCCL alone: 0-5 and 25-30 us of 40
    assert read("nccl_exposed.train-fsdp4")(rec) == pytest.approx(25.0)
    quiet = {"trace": {"ops": ops[1:2], "wall_s": 40e-6}}
    assert read("nccl_ms.train-fsdp4")(quiet) is None
    assert read("nccl_exposed.train-fsdp4")(quiet) is None
    assert read("nccl_exposed.train-fsdp4")({"trace": None}) is None


@pytest.mark.parametrize("ranks,microbatches", [(4, 1), (4, 2), (2, 2),
                                                (1, 1)])
def test_the_train_readers_over_ranks(ranks, microbatches):
    """``mfu.train`` divides the global batch's FLOPs by every rank's
    card; ``flash_attention_roofline.train`` counts rank 0's calls at its
    own rows of a microbatch (16 rows over 4 ranks in 1: 4 a call)."""
    from harness import readers

    cell = spec.resolve(CELL)
    c = cell.config
    mix = dict(cell.traffic, microbatches=microbatches)
    fam = spec.family(c)
    rows = 16 // ranks // microbatches
    f, b = spec.kernel_work("flash_attention").work(
        rows, 2048, *fam.attention_heads(c))
    assert f == 4 * 128 * (2048 * 2049 // 2) * 16 * rows
    one = readers.least_s(f, b)[0]
    # forward and recompute of 24 layers a microbatch took 20x the bound
    calls = 48 * microbatches
    ops = [(0.0, calls * one * 1e6 * 20, "flash_attention_mma_kernel(x)")]
    step_s = 2.0
    rec = {"config": c, "traffic": mix, "ranks": ranks,
           "trace": {"ops": ops, "wall_s": 1.0,
                     "launches": {"flash_attention": calls}},
           "steps": [{"t0": 0.0, "t1": step_s, "tokens": 16 * 2048,
                      "traced": False}]}
    read = spec.metric_reader
    assert read("flash_attention_roofline.train")(rec) == \
        pytest.approx(5.0)
    want = 100.0 * 3 * fam.forward_flops(c, 16, 2048) / \
        (step_s * ranks * spec.peaks()["bf16_flops_per_s"])
    assert read("mfu.train")(rec) == pytest.approx(want)
    if ranks == 1:                     # a one-card record names no ranks
        del rec["ranks"]
        assert read("mfu.train")(rec) == pytest.approx(want)


def _rank_parts(traced: bool) -> list:
    """What four ranks hand back from a run: rank 0 with the record."""
    ops = [[(0.0, 600.0, "gemm")], [(0.0, 900.0, "gemm")],
           [(0.0, 300.0, "gemm")], [(0.0, 1000.0, "gemm")]]
    parts = [{"memory_peak_bytes": (5 + r) * 2**30,
              "window_peak_bytes": (4 + (r * 3) % 4) * 2**30,
              "grad_sq": {"w": 1.0}, "change_sq": {"w": 4.0},
              "busy_s": ops[r][0][1] / 1e6 if traced else None}
             for r in range(4)]
    parts[0]["rec"] = {"losses": [1.0], "steps": [],
                       "trace": {"ops": ops[0], "wall_s": 1e-3}
                       if traced else None}
    return parts


def test_the_peak_is_the_highest_ranks():
    rec = train_ranks.merge(_rank_parts(False))
    assert rec["memory_peak_bytes"] == 8 * 2**30
    assert spec.metric_reader("peak_gib.train")(rec) == 7.0
    assert rec["program"]["grad_norms"] == {"w": 2.0}
    assert rec["program"]["change"] == {"w": 4.0}


def test_idle_is_rank_0s_card_and_busy_the_ranks_mean():
    rec = train_ranks.merge(_rank_parts(True))
    assert spec.metric_reader("device_idle.train")(rec) == \
        pytest.approx(40.0)
    assert rec["trace"]["busy_s"] == pytest.approx(700e-6)
    assert rec["trace"]["busy_s_ranks"] == pytest.approx(
        [600e-6, 900e-6, 300e-6, 1000e-6])
