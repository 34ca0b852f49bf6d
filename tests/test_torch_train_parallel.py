"""Training parallelism of the port against the JAX package, on the CPU:
every strategy and ZeRO stage over gloo ranks gives the JAX one-device
numbers ("sharding annotations change layout, never semantics").

One launch of 2 ranks (started through ``cluster.meshbridge.
launch_on_mesh``) and one of 4 (``launch.mesh.launch_ranks``) run every
scenario (``tests/_torch_train_ranks.py``, which imports no JAX); beside
them this process runs the JAX one-device steps on the same weights (the
JAX init, through numpy) and batches, and a JAX subprocess with 4 forced
host devices runs ``fsdp_tp`` ZeRO 3 on a (2, 2) mesh.

* reduced stablelm-3b in f32, two microbatches, 2 steps: the four
  strategies x ZeRO 1-3 on a (2, 2) mesh, and dp, fsdp, tp and fsdp_tp
  on (2, 1) and (1, 2) meshes, each against the JAX one-device step; the
  (2, 2) ``fsdp_tp`` ZeRO 3 run also against the JAX 4-device run;
* ``gather_bf16`` and ``grad_reduce_bf16`` against JAX with the same knob;
* starcoder2-3b (2 kv heads) on a (1, 4) mesh, where the query heads
  shard and the kv heads do not, and on (2, 2);
* reduced mamba2-780m under fsdp ZeRO 3 and reduced qwen2-moe under dp
  and under fsdp ZeRO 3, its aux losses included;
* the 2-stage pipeline's outputs and gradients against the sequential run
  of the same stage function;
* ``train --data 2 --model 2`` (its ranks' function) against the one-cell
  CLI;
* an fsdp_tp checkpoint restored into the one-rank port trainer and into
  the JAX ``Trainer``, whose next losses are equal;
* a dp ZeRO 2 checkpoint of reduced mamba2-780m resumed under tp on 1 x
  2, on one rank and in the JAX ``Trainer``: step 2 equal to the
  uninterrupted run's;
* ``chip_smoke.py``'s train-parallel and resume phases at reduced size.

Tensor parallelism of the SSM, hybrid and MoE families and the
``seq_parallel``/``moe_defer_combine`` layouts are
``test_torch_train_tp_families.py``'s.

Tolerances: f32 metrics (loss, xent, aux losses, gradient norm, lr) 1e-5
relative; final parameters within 1e-4 of the largest magnitude of the
tree (the norm scales, ~1) — the ranks sum the batch's gradient in
another order, and AdamW's first steps move a parameter by about ``lr *
sign(g)`` where its gradient is near zero.  The bf16 knobs round the
weights or the gradient reductions to bf16 on both sides, but the ranks
sum bf16 partials that the one-device step does not have, which flips
the sign of a few near-zero gradients: metrics 1e-3 relative, and the
parameters' update over the steps (final - initial, the whole tree)
within 2e-2 relative L2 of the JAX update."""
import contextlib
import dataclasses
import io
import json
import os
import pickle
import re
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_reduced_config as jax_reduced
from repro.configs.base import InputShape as JaxInputShape
from repro.models import init_params as jax_init_params
from repro.optim import OptimizerConfig as JaxOptimizerConfig
from repro.optim import init_opt_state as jax_init_opt_state
from repro.training import Trainer as JaxTrainer
from repro.training import TrainerConfig as JaxTrainerConfig
from repro.training import make_train_step as jax_make_train_step
from repro_torch.cluster.meshbridge import DeviceMesh, launch_on_mesh
from repro_torch.configs import InputShape, RunConfig
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import default_backend, launch_ranks
from repro_torch.optim import OptimizerConfig
from repro_torch.training import Trainer, TrainerConfig
from repro_torch.training.train_step import METRIC_KEYS

import _torch_train_ranks as R

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(rtol=1e-5, param=1e-4)
BF16 = dict(rtol=1e-3, update=2e-2)
CLI = ["--reduced", "--device", "cpu", "--steps", "2", "--seq-len", "32",
       "--batch", "4"]

_JAX4 = r'''
import json, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, jax, jax.numpy as jnp, numpy as np
assert len(jax.devices()) == 4, jax.devices()
sys.path.insert(0, sys.argv[2])
from _torch_train_ranks import OPT, SHAPE, batches
from repro.configs import RunConfig, get_reduced_config
from repro.launch.mesh import make_mesh
from repro.optim import OptimizerConfig, init_opt_state
from repro.training import make_train_step

with open(sys.argv[1], "rb") as f:
    weights = pickle.load(f)
cfg = dataclasses.replace(get_reduced_config("stablelm-3b"), dtype="float32")
mesh = make_mesh(2, 2)
opt = OptimizerConfig(**OPT)
step = make_train_step(cfg, RunConfig(strategy="fsdp_tp", zero_stage=3,
                                      microbatches=2, remat="none"),
                       mesh, opt)
params = jax.tree.map(jnp.asarray, weights)
state = init_opt_state(params, opt)
out = []
with mesh:
    for b in batches(cfg, SHAPE):
        params, state, m = step(params, state,
                                {k: jnp.asarray(v) for k, v in b.items()})
        out.append({k: float(v) for k, v in m.items()})
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


def _weights(arch):
    cfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
    params = jax.jit(jax_init_params, static_argnums=(0, 1))(cfg, 0)
    return jax.tree.map(np.asarray, params)


def _jax_steps(arch, weights, mesh, microbatches, bshape, knobs=None):
    """The JAX one-device step on ``R.batches``: per-step metrics, final
    parameters (numpy leaves) and the jitted step."""
    cfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
    opt = JaxOptimizerConfig(**R.OPT)
    step = jax_make_train_step(cfg, JaxRunConfig(
        strategy="dp", microbatches=microbatches, remat="none",
        **(knobs or {})), mesh, opt)
    params = jax.tree.map(jnp.asarray, weights)
    state = jax_init_opt_state(params, opt)
    metrics = []
    with mesh:
        for b in R.batches(cfg, bshape):
            params, state, m = step(params, state,
                                    {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "params": [np.asarray(x) for x in jax.tree.leaves(params)],
            "step": step}


def _train_jobs(entries, arch="stablelm-3b", microbatches=2,
                bshape=R.SHAPE):
    return [(label, arch, shape,
             dict(strategy=s, zero_stage=z, microbatches=microbatches, **kw),
             bshape)
            for label, shape, s, z, kw in entries]


@pytest.fixture(scope="module")
def runs(cpu_mesh, tmp_path_factory):
    """Every launch's results, the JAX one-device references and the JAX
    4-device run."""
    tmp = tmp_path_factory.mktemp("train-parallel")
    archs = ("stablelm-3b", "starcoder2-3b", "mamba2-780m",
             "qwen2-moe-a2.7b")
    weights = {a: _weights(a) for a in archs}
    wpath = tmp / "weights.pkl"
    with open(wpath, "wb") as f:
        pickle.dump(weights["stablelm-3b"], f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    jax4 = subprocess.Popen(
        [sys.executable, "-c", _JAX4, str(wpath), str(ROOT / "tests")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
    others = [(label, arch, shape, dict(strategy=s, zero_stage=z,
                                        microbatches=mb), bshape)
              for label, arch, shape, s, z, mb, bshape in R.OTHERS]
    two = {"weights": weights, "pipeline": True,
           "resume": str(tmp / "resume"),
           "train": _train_jobs(R.TWO) + [j for j in others
                                          if j[2] in ((2, 1), (1, 2))]}
    four = {"weights": {a: weights[a] for a in ("stablelm-3b",
                                                "starcoder2-3b")},
            "train": _train_jobs(R.GRID + R.KNOBS) + [
                j for j in others if j[2] in ((1, 4), (2, 2))],
            "checkpoint": str(tmp / "ckpt"),
            "cli": CLI + ["--data", "2", "--model", "2"]}
    out: dict = {}

    grid = np.empty(2, dtype=object)
    grid[:] = [torch.device("cpu")] * 2
    launches = {
        "two": lambda: launch_on_mesh(DeviceMesh(grid.reshape(2, 1)),
                                      R.rank_main, args=(two,), threads=1,
                                      timeout=600),
        "four": lambda: launch_ranks(R.rank_main, 2, 2, devices=["cpu"] * 4,
                                     backend="gloo", args=(four,),
                                     threads=1, timeout=600)}

    def run(key):
        try:
            out[key] = launches[key]()
        except BaseException as e:          # raised below, in the test
            out["error"] = e

    threads = [threading.Thread(target=run, args=(k,)) for k in launches]
    for th in threads:
        th.start()
    refs = {"stablelm-3b": _jax_steps("stablelm-3b", weights["stablelm-3b"],
                                      cpu_mesh, 2, R.SHAPE)}
    for label, _, _, _, kw in R.KNOBS:
        knob = next(iter(kw))
        if knob not in refs:
            refs[knob] = _jax_steps("stablelm-3b", weights["stablelm-3b"],
                                    cpu_mesh, 2, R.SHAPE, kw)
    for label, arch, shape, s, z, mb, bshape in R.OTHERS:
        if arch not in refs:
            refs[arch] = _jax_steps(arch, weights[arch], cpu_mesh, mb,
                                    bshape)
    # the one-cell CLI, for the 4-rank CLI
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tlaunch.main(CLI) == 0
    for th in threads:
        th.join()
    stdout, stderr = jax4.communicate(timeout=600)
    if "error" in out:
        raise out["error"]
    assert jax4.returncode == 0, stderr[-3000:]
    jax4_metrics = json.loads(stdout.split("JSON ", 1)[1])
    train = {**out["two"][0]["train"], **out["four"][0]["train"]}
    return SimpleNamespace(train=train, refs=refs, jax4=jax4_metrics,
                           two=out["two"], four=out["four"],
                           cli1=buf.getvalue(), tmp=tmp, weights=weights)


def _close(port, ref, rtol, param=None, update=None, initial=None):
    """Metrics within ``rtol``; final parameters within ``param`` of the
    tree's largest magnitude, or their update from ``initial`` within
    ``update`` relative L2 of the reference's."""
    assert len(port["metrics"]) == len(ref["metrics"]) == R.STEPS
    for pm, jm in zip(port["metrics"], ref["metrics"]):
        assert set(pm) == set(jm) == set(METRIC_KEYS)
        for k in METRIC_KEYS:
            np.testing.assert_allclose(pm[k], jm[k], rtol=rtol, atol=1e-8,
                                       err_msg=k)
    assert len(port["params"]) == len(ref["params"])
    assert [a.shape for a in port["params"]] == \
        [b.shape for b in ref["params"]]
    if param is not None:
        scale = max(float(np.max(np.abs(p))) for p in ref["params"])
        for a, b in zip(port["params"], ref["params"]):
            assert float(np.max(np.abs(a - b))) <= param * scale
    if update is not None:
        init = jax.tree.leaves(initial)
        diff = sum(float(np.sum((a - b) ** 2))
                   for a, b in zip(port["params"], ref["params"]))
        norm = sum(float(np.sum((b - i) ** 2))
                   for b, i in zip(ref["params"], init))
        assert np.sqrt(diff / norm) <= update, np.sqrt(diff / norm)


@pytest.mark.parametrize("label", [e[0] for e in R.GRID + R.TWO])
def test_strategy_and_zero_stage_match_jax_one_device(runs, label):
    _close(runs.train[label], runs.refs["stablelm-3b"], **F32)


def test_fsdp_tp_zero3_matches_jax_four_devices(runs):
    """The (2, 2) fsdp_tp ZeRO 3 ranks against the JAX step on a (2, 2)
    mesh of forced host devices."""
    for pm, jm in zip(runs.train["fsdp_tp z3 2x2"]["metrics"], runs.jax4):
        for k in METRIC_KEYS:
            np.testing.assert_allclose(pm[k], jm[k], rtol=F32["rtol"],
                                       atol=1e-8, err_msg=k)


@pytest.mark.parametrize("label", [e[0] for e in R.KNOBS])
def test_bf16_knobs_match_jax_with_the_same_knob(runs, label):
    knob = next(iter(dict((e[0], e[4]) for e in R.KNOBS)[label]))
    _close(runs.train[label], runs.refs[knob], **BF16,
           initial=runs.weights["stablelm-3b"])


@pytest.mark.parametrize("label", [e[0] for e in R.OTHERS])
def test_other_configs_match_jax(runs, label):
    """GQA whose kv heads do not divide the model ranks (the replicated
    kv projections' partial gradients summed over them), an SSM config
    under ZeRO 3 and an MoE config whose aux losses are means over token
    groups inside each rank's rows."""
    arch = next(e[1] for e in R.OTHERS if e[0] == label)
    _close(runs.train[label], runs.refs[arch], **F32)
    if arch == "qwen2-moe-a2.7b":
        m = runs.train[label]["metrics"][0]
        assert m["moe_balance_loss"] > 0 and m["moe_z_loss"] > 0


def test_pipeline_two_stages_match_sequential(runs):
    """2 stages x 4 microbatches over point-to-point sends == the stages
    run in sequence, outputs and gradients, on both stages."""
    w, x = R.pipeline_inputs()
    w.requires_grad_(True)
    ref = torch.stack([R.stage_fn(w, x[i]) for i in range(x.shape[0])])
    (g_ref,) = torch.autograd.grad(torch.sum(ref ** 2), [w])
    for rank in runs.two:
        np.testing.assert_allclose(rank["pipeline"]["y"],
                                   ref.detach().numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(rank["pipeline"]["grad"], g_ref.numpy(),
                                   rtol=1e-4, atol=1e-5)


def _cli_step(text):
    m = re.search(r"step\s+2\s+loss (\S+)\s+gnorm (\S+)", text)
    return float(m.group(1)), float(m.group(2))


def test_cli_data_2_model_2_matches_one_cell(runs):
    """``train --data 2 --model 2``'s ranks print the one-cell CLI's step
    line, and the header has the JAX CLI's form.  The CLI computes in
    bf16, where the model ranks' reduction points reassociate sums (one
    cell: 6.8110 at step 2, 2x2: 6.8111 on the CPU): loss and gradient
    norm within 2e-3 relative."""
    assert "on mesh {'data': 1, 'model': 1} strategy=fsdp_tp zero=3" in \
        runs.cli1
    one = _cli_step(runs.cli1)
    four = _cli_step("\n".join(runs.four[0]["cli"]))
    np.testing.assert_allclose(four, one, rtol=2e-3)
    assert runs.four[1]["cli"] == []                  # rank 0 logs alone


def test_fsdp_tp_checkpoint_restores_in_port_and_jax(runs, cpu_mesh):
    """A checkpoint saved by 4 ranks under fsdp_tp ZeRO 3 holds whole
    leaves; the 4 ranks (each restoring its shards), the one-rank port
    trainer and the JAX trainer resume from it and take the same third
    step."""
    from repro_torch import checkpoint as tckpt
    d = str(runs.tmp / "ckpt")
    assert tckpt.latest_step(d) == 2
    losses, resumed = runs.four[0]["checkpoint"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert [s for s, _ in resumed] == [3]
    tcfg = R.f32_reduced("stablelm-3b")
    t = Trainer(tcfg, RunConfig(use_kernels=True, microbatches=2), None,
                InputShape("t", R.SHAPE[1], R.SHAPE[0], "train"),
                OptimizerConfig(**R.OPT),
                TrainerConfig(steps=3, log_every=100, ckpt_dir=d),
                device="cpu")
    th = t.train(log=lambda *_: None)
    assert [h["step"] for h in th] == [3]
    jcfg = dataclasses.replace(jax_reduced("stablelm-3b"), dtype="float32")
    jt = JaxTrainer(jcfg, JaxRunConfig(strategy="dp", microbatches=2,
                                       remat="none"), cpu_mesh,
                    JaxInputShape("t", R.SHAPE[1], R.SHAPE[0], "train"),
                    JaxOptimizerConfig(**R.OPT),
                    JaxTrainerConfig(steps=3, log_every=100, ckpt_dir=d))
    jt.step_fn = runs.refs["stablelm-3b"]["step"]     # the same program
    with cpu_mesh:
        jh = jt.train(log=lambda *_: None)
    assert [h["step"] for h in jh] == [3]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(th[0][k], jh[0][k], rtol=F32["rtol"])
    np.testing.assert_allclose(resumed[0][1], jh[0]["loss"],
                               rtol=F32["rtol"])


def test_dp_zero2_checkpoint_resumes_on_tp_one_rank_and_jax(runs, cpu_mesh):
    """Reduced mamba2-780m saved by 2 ranks under dp ZeRO 2 at step 1 (the
    AdamW state gathered from their slices) resumes under tp on 1 x 2
    (the SSD heads split over the ranks), on one rank and in the JAX
    ``Trainer``: each one's step 2 is the uninterrupted run's and JAX's
    (f32, 1e-5 relative)."""
    from repro_torch import checkpoint as tckpt
    d = str(runs.tmp / "resume")
    assert tckpt.latest_step(d) == 1
    res = runs.two[0]["resume"]
    assert [h["step"] for h in res["uninterrupted"]] == [1, 2]
    assert [h["step"] for h in res["tp"]] == [2]
    assert runs.two[1]["resume"]["tp"][0]["loss"] == res["tp"][0]["loss"]
    one = R.resume_trainer(R.f32_reduced("mamba2-780m"), None, "fsdp_tp", 3,
                           2, d, device="cpu").train(log=lambda *_: None)
    assert [h["step"] for h in one] == [2]
    jcfg = dataclasses.replace(jax_reduced("mamba2-780m"), dtype="float32")
    jt = JaxTrainer(jcfg, JaxRunConfig(strategy="dp", microbatches=2,
                                       remat="none"), cpu_mesh,
                    JaxInputShape("t", R.SHAPE[1], R.SHAPE[0], "train"),
                    JaxOptimizerConfig(**R.OPT),
                    JaxTrainerConfig(steps=2, log_every=100, ckpt_dir=d))
    jt.step_fn = runs.refs["mamba2-780m"]["step"]     # the same program
    with cpu_mesh:
        jh = jt.train(log=lambda *_: None)
    assert [h["step"] for h in jh] == [2]
    for got in (res["uninterrupted"][1], res["tp"][0], one[0]):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[k], jh[0][k], rtol=F32["rtol"],
                                       err_msg=k)


def test_cell_devices_and_backends():
    """The CLI names one device a cell: ``--device`` repeated, or
    ``--devices``; NCCL only where every cell has a card of its own."""
    args = tlaunch._parser().parse_args(["--device", "cpu", "--data", "2"])
    assert tlaunch.cell_devices(args, 2) == [torch.device("cpu")] * 2
    args = tlaunch._parser().parse_args(["--devices", "cuda:0,cuda:1"])
    assert tlaunch.cell_devices(args, 2) == [torch.device("cuda", 0),
                                            torch.device("cuda", 1)]
    with pytest.raises(SystemExit):
        tlaunch.cell_devices(args, 4)
    assert default_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert default_backend(["cuda:0", "cuda:0"]) == "gloo"
    assert default_backend(["cpu", "cpu"]) == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tlaunch.cell_devices(tlaunch._parser().parse_args([]), 4)


def test_chip_smoke_train_parallel_phase_on_cpu(capsys):
    """``chip_smoke.py``'s train-parallel phase at reduced size on the CPU:
    its seven runs (mamba2-780m and qwen2-moe-a2.7b under tp among them)
    and eight f32 identity runs (mamba2-780m under tp and stablelm-3b
    under tp with seq_parallel among them) pass their gates (the memory
    and launch gates hold on the card only)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    out = chip_smoke.train_parallel_phase(
        dict(seq_len=32, batch=4, steps=1, f32_steps=2), device="cpu",
        reduced=True)
    assert [r["label"] for r in out["runs"]] == [
        r[0] for r in chip_smoke.TRAIN_PAR_RUNS]
    assert len(out["identity"]) == len(chip_smoke.TRAIN_PAR_F32)
    assert all(rel <= 1e-5 and grel <= 1e-5 and perr <= 1e-4
               and upd <= chip_smoke.PAR_UPDATE_TOL
               for _, rel, grel, perr, upd in out["identity"])
    text = capsys.readouterr().out
    for label in ("fsdp_tp z3 2x2", "mamba2-780m tp 1x2",
                  "tp seq_parallel 1x2", "qwen2-moe-a2.7b fsdp z3 2x1",
                  "qwen2-moe-a2.7b tp 1x2"):
        assert f"f32 identity {label}" in text
    assert "  qwen2-moe-a2.7b tp 1x2: losses" in text
    assert "  qwen2-moe-a2.7b fsdp z3 2x1: losses" in text
    assert f"qwen2-moe-a2.7b f32 {chip_smoke.MOE_F32_LAYERS} layers" in text


def test_chip_smoke_resume_phase_on_cpu(capsys):
    """``chip_smoke.py``'s resume phase at reduced size on the CPU: a dp
    ZeRO 2 checkpoint of 2 ranks resumes under tp on 1 x 2 and on one
    rank, bf16 and f32, with every leaf's digest equal to the saving
    run's and the resumed step 2 within the gates (the memory and launch
    gates hold on the card only)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels.ops import launch_counts
    out = chip_smoke.resume_phase(dict(seq_len=32, batch=4), device="cpu",
                                  reduced=True)
    assert [(r["kind"], r["label"]) for r in out["runs"]] == [
        (k, label) for k in ("bf16", "f32")
        for label in ("tp 1x2", "one rank")]
    assert all(r["rel"] <= 1e-5 and r["grel"] <= 1e-5
               for r in out["runs"] if r["kind"] == "f32")
    text = capsys.readouterr().out
    assert text.count("digests equal the saving run's at step 1") == 4
    assert set(out["launches"]) == set(launch_counts())


def test_seq_parallel_one_rank_matches_jax():
    """On one rank ``seq_parallel`` computes training attention in one q
    block (the JAX ``one_block``), past the 512-row blocks of the plain
    path: the loss and gradients are JAX's with the same knob."""
    from repro.models import loss_fn as jax_loss_fn
    from repro_torch.models import loss_fn
    from repro_torch.tree import leaves
    from repro_torch.weights import params_from_jax

    weights = _weights("stablelm-3b")
    jcfg = dataclasses.replace(jax_reduced("stablelm-3b"), dtype="float32")
    b = R.batches(jcfg, (1, 1024), steps=1)[0]
    jrun = JaxRunConfig(remat="none", seq_parallel=True)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, x: jax_loss_fn(p, x, jcfg, jrun), has_aux=True))(
            jax.tree.map(jnp.asarray, weights),
            {k: jnp.asarray(v) for k, v in b.items()})
    params = params_from_jax(weights)
    xs = [p.requires_grad_(True) for p in leaves(params)]
    tl, _ = loss_fn(params, {k: torch.from_numpy(v) for k, v in b.items()},
                    R.f32_reduced("stablelm-3b"),
                    RunConfig(remat="none", seq_parallel=True))
    tg = torch.autograd.grad(tl, xs)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for t, j in zip(tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=1e-4)


def test_adamw_update_in_slices_matches_jax(monkeypatch):
    """AdamW updates each leaf in slices along dim 0 (its f32 temporaries
    one slice in size): the result is the whole-leaf update bit for bit,
    and JAX's ``adamw_update`` within the f32 tolerance, for a stacked
    leaf, a strided view of one (an optimizer-layout slice), a vector and
    a scalar."""
    from repro.optim import adamw_update as jax_adamw_update
    from repro_torch.optim import adamw as tadamw
    from repro_torch.optim import init_opt_state

    rng = np.random.default_rng(0)
    shapes = {"stack": (6, 5, 7), "view": (4, 6, 8), "vec": (9,),
              "one": ()}
    p_np = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    g_np = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    opt = R.OPT

    def port(slice_elems):
        monkeypatch.setattr(tadamw, "_SLICE_ELEMS", slice_elems)
        whole = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
        params = dict(whole, view=whole["view"].narrow(1, 2, 3))
        grads = {k: torch.from_numpy(v.copy()) for k, v in g_np.items()}
        grads["view"] = grads["view"].narrow(1, 2, 3)
        state = init_opt_state(params, OptimizerConfig(**opt))
        for _ in range(2):
            params, state, _ = tadamw.adamw_update(
                params, grads, state, OptimizerConfig(**opt))
        return params, state

    sliced, s_state = port(8)
    whole, w_state = port(1 << 24)
    for k in shapes:
        assert torch.equal(sliced[k], whole[k]), k
        assert torch.equal(s_state["m"][k], w_state["m"][k]), k
        assert torch.equal(s_state["v"][k], w_state["v"][k]), k
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    jp["view"] = jp["view"][:, 2:5]
    jg = {k: jnp.asarray(v) for k, v in g_np.items()}
    jg["view"] = jg["view"][:, 2:5]
    jstate = jax_init_opt_state(jp, JaxOptimizerConfig(**opt))
    for _ in range(2):
        jp, jstate, _ = jax_adamw_update(jp, jg, jstate,
                                         JaxOptimizerConfig(**opt))
    for k in shapes:
        np.testing.assert_allclose(sliced[k].numpy(), np.asarray(jp[k]),
                                   rtol=F32["rtol"], atol=1e-7)


def test_streamed_checkpoint_restores_in_jax_and_by_block(tmp_path):
    """A leaf saved in slices (``checkpoint.Streamed``, as ranks save
    their shards) is the whole leaf in the JAX layout: the JAX store
    restores it, and the port's ``restore(select=)`` reads a block of it,
    f32 and bf16."""
    from repro.checkpoint import restore as jax_restore
    from repro_torch import checkpoint as tckpt

    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((5, 6)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((4, 3)).astype(
        np.float32)).to(torch.bfloat16)

    def rows(t, n):
        return lambda: ((((slice(r, r + n),)), t[r:r + n])
                        for r in range(0, t.shape[0], n))

    tree = {"a": tckpt.Streamed((5, 6), torch.float32, rows(a, 2)),
            "b": tckpt.Streamed((4, 3), torch.bfloat16, rows(b, 3)),
            "step": torch.tensor(7, dtype=torch.int32)}
    tckpt.save(str(tmp_path), 7, tree)
    like = {"a": jnp.zeros((5, 6), jnp.float32),
            "b": jnp.zeros((4, 3), jnp.bfloat16),
            "step": jnp.zeros((), jnp.int32)}
    jt, _ = jax_restore(str(tmp_path), like)
    np.testing.assert_array_equal(np.asarray(jt["a"]), a.numpy())
    np.testing.assert_array_equal(np.asarray(jt["b"]).astype(np.float32),
                                  b.float().numpy())
    assert int(jt["step"]) == 7
    blocks = {"['a']": (slice(None), slice(2, 4)), "['b']": slice(1, 3)}
    tlike = {"a": torch.zeros(5, 2), "b": torch.zeros(2, 3,
                                                      dtype=torch.bfloat16),
             "step": torch.zeros((), dtype=torch.int32)}
    tt, _ = tckpt.restore(str(tmp_path), tlike,
                          select=lambda p, t: t[blocks[p]] if p in blocks
                          else t)
    assert torch.equal(tt["a"], a[:, 2:4])
    assert torch.equal(tt["b"], b[1:3])
    assert int(tt["step"]) == 7
    with pytest.raises(ValueError, match="block"):
        tckpt.restore(str(tmp_path), tlike, select=lambda p, t: t)
