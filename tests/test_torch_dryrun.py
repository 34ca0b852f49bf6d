"""The port's production dry run (``repro_torch.launch.dryrun``) against
the JAX package's and against real ranks, on the CPU.

* ``default_run_config`` and the record's fixed fields (params, active
  params, microbatches, strategy, ZeRO stage, sliding window, model
  flops) equal JAX's for the ten configs x four shapes x batch divisors
  16 and 32.
* **Census against real ranks.**  The dry run's collectives on ``meta``
  in a fake world equal, call for call and byte for byte, what one step
  of the same reduced config counts through ``chip_smoke.py``'s
  ``timed_collectives`` on real gloo ranks: stablelm-3b fsdp_tp ZeRO 3 2
  x 2, tp 1 x 2, fsdp ZeRO 3 2 x 1, dp ZeRO 1 and 2 2 x 1, mamba2-780m and
  qwen2-moe-a2.7b tp 1 x 2, one decode step at 1 x 2, three with one
  kv head, whose cache lines shard over the ranks (sharded and
  replicated query heads, a ring), and mamba2-780m's prefill and decode
  on a rank's SSD heads; each serving step's logits, and each rank's
  block of the cache it wrote, equal the one-rank step's (f32: 1e-5 of
  the largest magnitude; bf16: 2e-2).  One 4-rank and one 2-rank launch
  (``tests/_torch_dryrun_ranks.py``), run together.
* **Shard shapes against JAX.**  One JAX subprocess with 8 forced host
  devices lowers and compiles a tiny train, prefill and decode step at 2
  x 2: the port's arguments (local meta shapes, leaf by leaf) equal JAX's
  shard shapes and its ``argument_bytes`` equal JAX's
  ``memory_analysis().argument_size_in_bytes``; at (pod 2, data 2, model
  2) the Layout's parameter and optimizer shards equal JAX's, also where
  the joint product does not divide a dim and JAX replicates over
  ``pod``.
* The census arithmetic against JAX's HLO census, the flop count of one
  layer against the config's matmuls, the meter's flops against
  ``FlopCounterMode``'s, the fake world torn down after a run and after
  a failure, the CLI's records through ``benchmarks/bench_roofline.py``,
  a (2, 2, 2) train step's joint-group collectives, and
  ``chip_smoke.py``'s dry-run phase at reduced size."""
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.configs as JC
from repro.launch import hlo as jhlo
import repro_torch.configs as TC
from repro_torch.configs import InputShape, RunConfig
from repro_torch.core.zero import Layout
from repro_torch.launch import dryrun
from repro_torch.launch import hlo as thlo
from repro_torch.launch.mesh import (
    Mesh, launch_ranks, virtual_mesh, virtual_world,
)

from _torch_dryrun_ranks import SCENARIOS, rank_main, scenario

ROOT = Path(__file__).resolve().parents[1]

#: the tiny steps held to JAX's shard shapes at 2 x 2 (reduced stablelm-3b,
#: its f32 parameters and bf16 compute)
TINY = {"train": (32, 4), "prefill": (32, 4), "decode": (32, 4),
        "fused": (32, 4)}
#: the (2, 2, 2) Layout cases: (label, d_model, strategy, ZeRO stage) —
#: d_model 254 divides data 2 but not pod x data 4
POD_CASES = (("fsdp_tp z3", 256, "fsdp_tp", 3), ("dp z1", 256, "dp", 1),
             ("fsdp z2 d254", 254, "fsdp", 2),
             ("fsdp z3 d254", 254, "fsdp", 3),
             ("fsdp_tp z3 d254", 254, "fsdp_tp", 3))

_JAX = r'''
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
assert len(jax.devices()) == 8, jax.devices()
from repro.configs.base import InputShape, RunConfig
from repro.configs.stablelm_3b import reduced
from repro.core import sharding as shd
from repro.core.actshard import activation_sharding
from repro.launch.mesh import make_mesh
from repro.models import abstract_params, input_specs
from repro.models.model import prefill
from repro.optim import OptimizerConfig
from repro.serving import (
    fused_serve_step_lowering_args, make_fused_serve_step, make_serve_step,
    serve_step_lowering_args,
)
from repro.training import make_train_step, train_step_lowering_args

spec = json.loads(sys.argv[1])
cfg = reduced()
run = RunConfig(strategy="fsdp_tp", zero_stage=3)
mesh = make_mesh(2, 2)
out = {"steps": {}, "pod": {}}


def shapes(args, compiled):
    shardings = jax.tree.leaves(compiled.input_shardings[0])
    return [list(s.shard_shape(a.shape)) for a, s in
            zip(jax.tree.leaves(args), shardings)]


with mesh:
    for kind, (S, B) in spec["tiny"].items():
        shape = InputShape(kind, S, B, "decode" if kind == "fused" else kind)
        if kind == "train":
            opt = OptimizerConfig()
            step = make_train_step(cfg, run, mesh, opt)
            args = train_step_lowering_args(cfg, run, mesh, shape, opt)
        elif kind == "prefill":
            specs = input_specs(cfg, shape)
            b_sh = shd.batch_shardings(cfg, mesh, run, specs)
            batch = {k: jax.ShapeDtypeStruct(s.shape, s.dtype,
                                             sharding=b_sh[k])
                     for k, s in specs.items()
                     if k not in ("labels", "loss_mask")}
            rules = shd.make_activation_rules(cfg, mesh, run)

            def prefill_step(params, batch):
                with activation_sharding(rules):
                    return prefill(params, batch, cfg, run)

            step = jax.jit(prefill_step, in_shardings=(
                shd.param_shardings(cfg, mesh, run), None))
            args = (abstract_params(cfg), batch)
        elif kind == "fused":
            step = make_fused_serve_step(cfg, run, mesh, B, S, num_tokens=2)
            args = fused_serve_step_lowering_args(cfg, run, mesh, shape)
        else:
            step = make_serve_step(cfg, run, mesh, B, S)
            args = serve_step_lowering_args(cfg, run, mesh, shape)
        compiled = step.lower(*args).compile()
        out["steps"][kind] = {
            "shapes": shapes(args, compiled),
            "arg_bytes": int(compiled.memory_analysis()
                             .argument_size_in_bytes)}

pod = make_mesh(2, 2, pod=2)
for label, d_model, strategy, zero in spec["pod"]:
    c = dataclasses.replace(cfg, d_model=d_model)
    r = RunConfig(strategy=strategy, zero_stage=zero)
    ap = abstract_params(c)
    res = {}
    for name, fn in (("param", shd.param_shardings),
                     ("opt", shd.opt_shardings)):
        sh = jax.tree.leaves(fn(c, pod, r))
        res[name] = [list(s.shard_shape(a.shape)) for a, s in
                     zip(jax.tree.leaves(ap), sh)]
    out["pod"][label] = res
print("JSON " + json.dumps(out))
'''


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops under a loaded machine: torch's intra-op pool only
    waits (see tests/test_torch_cluster.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sides():
    """The JAX subprocess (8 forced host devices) and, beside it, the
    scenarios on real gloo ranks: one 4-rank launch (the 2 x 2 scenario)
    and one 2-rank launch (the rest), run together."""
    spec = {"tiny": TINY, "pod": POD_CASES}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _JAX, json.dumps(spec)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)
    four = [s for s in SCENARIOS if s[2] == (2, 2)]
    two = [s for s in SCENARIOS if s[2] != (2, 2)]
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            jobs = [pool.submit(launch_ranks, rank_main, *shape,
                                devices=["cpu"] * 4 if shape == (2, 2)
                                else ["cpu"] * 2, backend="gloo",
                                args=(specs, str(ROOT)), threads=1,
                                timeout=300)
                    for shape, specs in (((2, 2), four), ((2, 1), two))]
            ranks = [j.result() for j in jobs]
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, stderr[-4000:]
    line = [x for x in stdout.splitlines() if x.startswith("JSON ")][-1]
    counted = {}
    for got in ranks:
        for per_rank in zip(*got):
            counted[per_rank[0]["label"]] = per_rank
    return json.loads(line[5:]), counted


# ------------------------------------------------------- configurations ----

@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_default_run_config_and_fixed_fields_match_jax(arch):
    for name in TC.INPUT_SHAPES:
        tshape, jshape = TC.INPUT_SHAPES[name], JC.INPUT_SHAPES[name]
        tcfg = TC.shape_for(TC.get_config(arch), tshape)
        jcfg = JC.shape_for(JC.get_config(arch), jshape)
        for divisor in (16, 32):
            t = dataclasses.asdict(TC.default_run_config(tcfg, tshape,
                                                         divisor))
            j = dataclasses.asdict(JC.default_run_config(jcfg, jshape,
                                                         divisor))
            assert t.pop("use_kernels") == j.pop("use_pallas") is False
            assert t == j, (arch, name, divisor)
        run = TC.default_run_config(tcfg, tshape)
        mesh = Mesh(devices=np.empty((16, 16), dtype=object),
                    coords=(0, 0))
        head = dryrun.record_head(arch, name, "single", mesh, tcfg, run)
        jrun = JC.default_run_config(jcfg, jshape)
        want = {"params": jcfg.param_count(),
                "active_params": jcfg.active_param_count(),
                "microbatches": jrun.microbatches,
                "strategy": jrun.strategy, "zero_stage": jrun.zero_stage,
                "sliding_window": jcfg.sliding_window,
                "mesh_shape": {"data": 16, "model": 16}}
        assert {k: head[k] for k in want} == want
        tokens = (jshape.global_batch * jshape.seq_len
                  if jshape.kind != "decode" else jshape.global_batch)
        assert dryrun.model_flops_global(tcfg, tshape) == (
            6 if jshape.kind == "train" else 2) \
            * jcfg.active_param_count() * tokens


# ------------------------------------------------------------- census ----

def _dry(spec):
    cfg, run, shape = scenario(spec)
    with virtual_world(0, spec[2][0] * spec[2][1]):
        mesh = virtual_mesh(spec[2])
        step, args = dryrun.build_step(cfg, run, shape, mesh)
        return dryrun.count_step(step, args)


@pytest.mark.parametrize("spec", SCENARIOS, ids=[s[0] for s in SCENARIOS])
def test_census_equals_real_ranks(sides, spec):
    _, counted = sides
    got = _dry(spec)
    for r in counted[spec[0]]:
        assert got["calls"] == r["calls"], spec[0]
        assert got["handed_bytes"] == r["bytes"], spec[0]
    census = thlo.collective_census(
        (r["op"], r["result"], r["group"]) for r in got["records"])
    assert census.summary()["num_ops"] == sum(got["calls"].values())
    if spec[5] != "train":
        # the tp ranks' logits are the one-rank step's
        from _torch_dryrun_ranks import step_and_args
        from repro_torch.launch.mesh import single_device_mesh
        cfg, run, shape = scenario(spec)
        step, args = step_and_args(cfg, run, shape,
                                   single_device_mesh("cpu"))
        result = step(*args)
        want = result[0]
        cache = result[1] if spec[5] == "prefill" else args[1]
        from repro_torch.tree import leaves
        # bf16 compute: the ranks' f32 reductions round differently
        tol = 1e-5 if cfg.dtype == "float32" else 2e-2
        for rank, r in enumerate(counted[spec[0]]):
            np.testing.assert_allclose(
                r["logits"], want.float().numpy(),
                atol=tol * float(want.abs().max()), rtol=0)
            # the cache it wrote: each rank's block of the one-rank cache
            for got, whole in zip(r["cache"], leaves(cache)):
                whole = whole.float().numpy()
                for dim, (a, b) in enumerate(zip(got.shape, whole.shape)):
                    if a != b:
                        whole = np.take(whole, range(rank * a, (rank + 1)
                                                     * a), axis=dim)
                np.testing.assert_allclose(
                    got, whole, rtol=0,
                    atol=tol * max(float(np.abs(whole).max()), 1e-30))


# --------------------------------------------------------- shard shapes ----

@pytest.mark.parametrize("kind", list(TINY))
def test_lowering_args_match_jax_shard_shapes(sides, kind):
    """Leaf by leaf, and in bytes; the fused step's PRNG key (2 uint32,
    8 bytes) is the port's ``torch.Generator``, no tensor."""
    jax_side, _ = sides
    S, B = TINY[kind]
    cfg = TC.get_reduced_config("stablelm-3b")
    run = RunConfig(strategy="fsdp_tp", zero_stage=3)
    from repro_torch.serving import serve_step as ss
    from repro_torch.tree import leaves
    with virtual_world(0, 4):
        mesh = virtual_mesh((2, 2))
        if kind == "fused":
            step = ss.make_fused_serve_step(cfg, run, mesh, B, S, 2)
            args = ss.fused_serve_step_lowering_args(
                cfg, run, mesh, InputShape(kind, S, B, "decode"))
        else:
            step, args = dryrun.build_step(
                cfg, run, InputShape(kind, S, B, kind), mesh)
        got = [list(t.shape) for t in leaves(list(args)) if t is not None]
        counted = dryrun.count_step(step, args)
    want = jax_side["steps"][kind]
    key = 8 if kind == "fused" else 0
    assert got == want["shapes"][:len(want["shapes"]) - bool(key)]
    assert counted["argument_bytes"] == want["arg_bytes"] - key
    assert counted["peak_bytes"] >= counted["argument_bytes"]


@pytest.mark.parametrize("case", POD_CASES, ids=[c[0] for c in POD_CASES])
def test_pod_layout_matches_jax(sides, case):
    jax_side, _ = sides
    label, d_model, strategy, zero = case
    cfg = dataclasses.replace(TC.get_reduced_config("stablelm-3b"),
                              d_model=d_model)
    run = RunConfig(strategy=strategy, zero_stage=zero)
    from repro_torch.core import sharding as shd
    from repro_torch.models import abstract_params
    from repro_torch.tree import leaves
    grid = np.empty((2, 2, 2), dtype=object)
    for coords in ((0, 0, 0), (1, 1, 1), (1, 0, 1)):
        mesh = Mesh(devices=grid, coords=coords,
                    axis_names=("pod", "data", "model"))
        lay = Layout(cfg, mesh, run)
        for name, fn in (("param", shd.param_shardings),
                         ("opt", shd.opt_shardings)):
            got = [list(t.shape) for t in leaves(lay.local_meta(
                abstract_params(cfg), fn(cfg, mesh, run)))]
            assert got == jax_side["pod"][label][name], (label, name)
    entries = {e for leaf in lay.leaves for e in leaf.param + leaf.opt}
    # d_model 254: the leaves whose only free dim is d replicate over pod
    assert ("data" in entries) == (d_model == 254)
    assert (("pod", "data") in entries) == (label != "fsdp_tp z3 d254")


def test_pod_train_step_reduces_over_the_joint_group():
    cfg = dataclasses.replace(TC.get_reduced_config("stablelm-3b"),
                              d_model=254)
    run = RunConfig(strategy="fsdp", zero_stage=3)
    with virtual_world(5, 8):
        mesh = virtual_mesh((2, 2, 2), ("pod", "data", "model"))
        got = dryrun.dry_run(cfg, run, InputShape("t", 32, 8, "train"),
                             mesh)
    groups = {(r["name"], r["group"]) for r in got["records"]}
    # ZeRO-3 gathers over pod x data (4) and over data alone (2) where a
    # dim divides only by 2; those leaves' gradients sum over pod (2)
    assert ("all_gather", 4) in groups and ("all_gather", 2) in groups
    assert ("reduce_scatter", 4) in groups and ("all_reduce", 2) in groups
    assert not dist.is_initialized()


# ----------------------------------------------------- census arithmetic ----

_HLO = """
  %ag = bf16[8,128]{1,0} all-gather(bf16[2,128]{1,0} %x), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = f32[256]{0} all-reduce(f32[256]{0} %y), replica_groups=[4,2]<=[8], to_apply=%add
  %rs = f32[64]{0} reduce-scatter(f32[256]{0} %z), replica_groups={{0,1,2,3}}, dimensions={0}
  %aa = bf16[4,32]{1,0} all-to-all(bf16[4,32]{1,0} %u), replica_groups={{0,1}}
  %cp = f32[16]{0} collective-permute(f32[16]{0} %w), source_target_pairs={{0,1},{1,0}}
  %ar2 = f32[7]{0} all-reduce-start(f32[7]{0} %v), replica_groups={{0,1,2,3,4,5,6,7}}
  %ar3 = f32[7]{0} all-reduce-done(f32[7]{0} %ar2)
"""
_RECORDS = [("all-gather", 8 * 128 * 2, 4), ("all-reduce", 256 * 4, 2),
            ("reduce-scatter", 64 * 4, 4), ("all-to-all", 4 * 32 * 2, 2),
            ("collective-permute", 16 * 4, 2), ("all-reduce", 7 * 4, 8)]


def test_census_arithmetic_matches_jax():
    assert thlo.collective_census(_RECORDS).summary() == \
        jhlo.collective_census(_HLO).summary()
    for op in thlo.COLLECTIVES:
        for n in (2, 4, 16):
            assert thlo._link_factor(op, n) == jhlo._link_factor(op, n)
    with pytest.raises(ValueError):
        thlo.collective_census([("send", 4, 2)])
    t = thlo.roofline_terms(989e12, 3.35e12, 50e9)
    assert (t["compute_s"], t["memory_s"], t["collective_s"]) == (1, 1, 1)


def test_recorder_answers_point_to_point_sends():
    """The fake backend runs no send; the recorder answers a
    ``batch_isend_irecv`` and records one collective-permute a send."""
    records, orig = [], dist.batch_isend_irecv
    with virtual_world(0, 2), dryrun.record_collectives(records):
        x = torch.empty((4, 8), device="meta")
        y = torch.empty((4, 8), device="meta")
        works = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1),
                                        dist.P2POp(dist.irecv, y, 1)])
        assert all(w.wait() for w in works)
        dist.all_reduce(y)
    assert [(r["name"], r["op"], r["handed"], r["result"], r["group"])
            for r in records] == [
        ("batch_isend_irecv", "collective-permute", 128, 128, 2),
        ("all_reduce", "all-reduce", 128, 128, 2)]
    assert dist.batch_isend_irecv is orig and not dist.is_initialized()


# ----------------------------------------------------------------- flops ----

def _train_flops(cfg, run, shape) -> float:
    with virtual_world(0, 1):
        mesh = virtual_mesh((1, 1))
        step, args = dryrun.build_step(cfg, run, shape, mesh)
        return dryrun.count_step(step, args)["flops"]


def test_flops_of_one_layer_are_its_matmuls():
    cfg = TC.get_reduced_config("stablelm-3b")
    run = RunConfig(remat="none")
    B, S = 2, 64
    shape = InputShape("t", S, B, "train")
    got = [_train_flops(dataclasses.replace(cfg, num_layers=n), run, shape)
           for n in (2, 3)]
    T, d, H, K, Dh, F = (B * S, cfg.d_model, cfg.num_heads,
                         cfg.num_kv_heads, cfg.head_dim, cfg.d_ff)
    forward = (2 * T * d * (H + 2 * K) * Dh      # q, k, v
               + 2 * 2 * B * H * S * S * Dh     # scores and PV
               + 2 * T * H * Dh * d             # out
               + 3 * 2 * T * d * F)             # SwiGLU
    assert got[1] - got[0] == 3 * forward        # forward + two backward
    # layer recomputation runs each layer's forward once more
    remat = [_train_flops(dataclasses.replace(cfg, num_layers=n),
                          RunConfig(remat="layer"), shape) for n in (2, 3)]
    # layer recomputation runs each layer's forward once more, up to its
    # last product (w2), whose output the backward pass does not read:
    # the checkpoint's recomputation stops early
    assert remat[1] - remat[0] == 4 * forward - 2 * T * F * d


def test_meter_flops_equal_flop_counter_mode():
    from torch.utils.flop_counter import FlopCounterMode
    cfg = TC.get_reduced_config("qwen2-moe-a2.7b")
    shape = InputShape("t", 64, 2, "train")
    with virtual_world(0, 1):
        mesh = virtual_mesh((1, 1))
        step, args = dryrun.build_step(cfg, RunConfig(), shape, mesh)
        with FlopCounterMode(display=False) as fc:
            step(*args)
        step, args = dryrun.build_step(cfg, RunConfig(), shape, mesh)
        got = dryrun.count_step(step, args)
    assert got["flops"] == fc.get_total_flops() > 0
    assert got["peak_bytes"] >= got["argument_bytes"] > 0
    assert got["hbm_bytes"] > got["argument_bytes"]


# -------------------------------------------------------------- teardown ----

def test_virtual_world_is_torn_down(tmp_path):
    rec = dryrun.run_one("stablelm-3b", "decode_32k", "single",
                         str(tmp_path))
    assert not dist.is_initialized()
    assert rec["devices"] == 256 and rec["mesh_shape"] == {"data": 16,
                                                           "model": 16}
    with pytest.raises(RuntimeError, match="boom"):
        with virtual_world(3, 4):
            assert dist.get_rank() == 3
            raise RuntimeError("boom")
    assert not dist.is_initialized()
    # a combination refused inside the world leaves none behind either
    with pytest.raises(ValueError, match="pipeline"):
        dryrun.run_one("stablelm-3b", "decode_32k", "single",
                       str(tmp_path), overrides={"strategy": "pp"})
    assert not dist.is_initialized()


# ------------------------------------------------------------ CLI, table ----

#: every key the JAX ``run_one`` and ``analyze`` write
JAX_KEYS = {"arch", "shape", "mesh", "tag", "overrides", "mesh_shape",
            "strategy", "zero_stage", "microbatches", "params",
            "active_params", "sliding_window", "devices", "cost_raw",
            "collectives_raw", "memory", "cost", "roofline",
            "model_flops_global", "useful_flops_ratio", "lower_s",
            "total_s"}


def test_cli_records_render_in_bench_roofline(tmp_path, capsys):
    out = tmp_path / "dryrun_torch"
    assert dryrun.main(["--arch", "stablelm-3b", "--shape", "decode_32k",
                        "long_500k", "--outdir", str(out)]) == 0
    assert "all dry-run combinations ran on meta OK" in capsys.readouterr(
    ).out
    recs = [json.loads(p.read_text()) for p in sorted(out.glob("*.json"))]
    assert len(recs) == 2
    for r in recs:
        assert JAX_KEYS <= set(r)
        assert set(r["memory"]) == {"argument_bytes", "output_bytes",
                                    "temp_bytes", "peak_bytes"}
        assert r["cost"]["method"] == "counted (eager, every layer)"
        assert r["roofline"]["bottleneck"] in ("compute", "memory",
                                               "collective")
        by_op = r["collectives_raw"]["by_op"]
        assert by_op["all-reduce"]["count"] == 2 * 32 + 1
    import importlib
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import bench_roofline
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("REPRO_DRYRUN_DIR", str(out))
            table = importlib.reload(bench_roofline).table()
    finally:
        sys.path.remove(str(ROOT))
    assert "stablelm-3b" in table and "decode_32k" in table \
        and "long_500k" in table


# -------------------------------------------------------- chip_smoke.py ----

def test_chip_smoke_dryrun_phase_at_reduced_size(sides, tmp_path):
    """Phase 14 on the CPU at reduced size, held to the gloo ranks'
    census as the card run holds it to phase 13's."""
    _, counted = sides
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    par = {"runs": [{"label": spec[0], "collectives": counted[spec[0]][0][
        "calls"], "collective_bytes": counted[spec[0]][0]["bytes"],
        "peak_gib": float("nan"), "limit_gib": float("nan")}
        for spec in SCENARIOS if spec[5] == "train"],
        "one_rank": {}}
    out = chip_smoke.dryrun_phase(par, None, dict(
        seq_len=64, batch=4, slots=2, cache_len=64, decode_chunk=4),
        device="cpu", reduced=True, outdir=str(tmp_path),
        runs=tuple((s[0], s[1], s[2], s[3], s[4],
                    {"microbatches": s[6]}) for s in SCENARIOS
                   if s[5] == "train"),
        # two of the subset's combinations, one on the pod mesh (the
        # reduced configs' 4 kv heads do not divide the model axis's 16:
        # their decode shapes are refused)
        subset=[("stablelm-3b", "prefill_32k", "single"),
                ("stablelm-3b", "train_4k", "multi")])
    assert out["census"] == len(par["runs"])
    # the card's count and the dry run's wrap the same collectives
    assert chip_smoke._COLLECTIVES == tuple(dryrun.COLLECTIVES)
    assert len(list(tmp_path.glob("*.json"))) == len(out["subset"])
    assert not dist.is_initialized()
