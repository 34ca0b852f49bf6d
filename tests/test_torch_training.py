"""Parity of the PyTorch port's training path with the JAX package, on the
CPU, in f32: ``loss_fn`` for both routes (the port's ``use_kernels``
against JAX's ``use_pallas``, Pallas in interpret mode), gradients against
``jax.grad`` (``use_pallas=False``, the only route JAX differentiates),
layer recomputation, one ``make_train_step`` step with two microbatches,
the data pipeline, three ``Trainer`` steps, checkpoints across the
packages, and the CLI with a requeue.  Reduced mamba2-780m (the slice's
config) and reduced stablelm-3b (the dense branch); the same weights (made
by the JAX init, passed through numpy) and batches on both sides.

Tolerances: losses 1e-5 (``tests/test_kernels.py`` holds the JAX routes to
each other at 1e-4); gradients 1e-5 absolute plus 1e-4 relative — the two
frameworks sum in different orders, which moves the last bits of f32
gradients.  Parameters after an AdamW step: 1e-4 absolute, a fifth of the
step's learning rate (5e-4): the first step moves each parameter by
``lr * m / sqrt(v)``, about ``lr * sign(g)``, so where a gradient is near
zero its last bits decide a sizeable part of the step."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_reduced_config as jax_reduced
from repro.configs.base import InputShape as JaxInputShape
from repro.data import DataConfig as JaxDataConfig
from repro.data import PackedStream as JaxPackedStream
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models import make_batch as jax_make_batch
from repro.optim import OptimizerConfig as JaxOptimizerConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import init_opt_state as jax_init_opt_state
from repro.optim import lr_schedule as jax_lr_schedule
from repro.training import Trainer as JaxTrainer
from repro.training import TrainerConfig as JaxTrainerConfig
from repro_torch import checkpoint as tckpt
from repro_torch.configs import InputShape, RunConfig, get_reduced_config
from repro_torch.data import DataConfig, PackedStream
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import single_device_mesh
from repro_torch.models import init_params, loss_fn, make_batch
from repro_torch.models import model as TM
from repro_torch.optim import (
    OptimizerConfig, adamw_update, init_opt_state, lr_schedule,
)
from repro_torch.training import Trainer, TrainerConfig, make_train_step
from repro_torch.tree import leaves, leaves_with_path
from repro_torch.weights import params_from_jax

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("mamba2-780m", "stablelm-3b")
SHAPE = (2, 64)                                   # (batch, seq)
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=50)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch):
    return (dataclasses.replace(jax_reduced(arch), dtype="float32"),
            dataclasses.replace(get_reduced_config(arch), dtype="float32"))


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(jax cfg, torch cfg, numpy params) with weights from the JAX init."""
    jcfg, tcfg = _cfgs(arch)
    params = jax.jit(jax_init_params, static_argnums=(0, 1))(jcfg, 0)
    return jcfg, tcfg, _np(params)


def _batch(cfg, seed=0):
    """The same numpy batch on both sides (``make_batch`` of each)."""
    shape = JaxInputShape("t", SHAPE[1], SHAPE[0], "train")
    jb = jax_make_batch(cfg, shape, seed)
    tb = make_batch(cfg, InputShape("t", SHAPE[1], SHAPE[0], "train"), seed,
                    device="cpu")
    return jb, tb


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch, use_pallas):
    """JAX loss (and, on the reference route, gradients) on ``_batch``;
    computed once per arch and route (each is a compile)."""
    jcfg, _, params = _pair(arch)
    batch = _batch(jcfg)[0]
    run = JaxRunConfig(remat="none", use_pallas=use_pallas)
    f = functools.partial(jax_loss_fn, cfg=jcfg, run=run)
    if use_pallas:                        # forward only: no VJP through it
        return float(jax.jit(f)(params, batch)[0]), None
    (loss, _), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params, batch)
    return float(loss), _np(grads)


def _torch_loss_and_grads(tcfg, params, batch, use_kernels, remat="none"):
    xs = [p.requires_grad_(True) for p in leaves(params)]
    loss, metrics = loss_fn(params, batch, tcfg,
                            RunConfig(use_kernels=use_kernels, remat=remat))
    grads = torch.autograd.grad(loss, xs)
    for p in xs:
        p.requires_grad_(False)
    return loss.detach(), grads, metrics


def _assert_leaves_close(tgrads, jtree, **tol):
    jl = jax.tree_util.tree_leaves(jtree)
    assert len(jl) == len(tgrads)
    for t, j in zip(tgrads, jl):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   **(tol or GRAD_TOL))


# ------------------------------------------------------- weights, batches ----

def test_ssm_params_bridge_and_init():
    """The SSM leaves (A_log, dt_bias, conv_w, D, norm_scale) go through
    the weight bridge unchanged, and the port's own init builds the same
    tree with the same init styles."""
    jcfg, tcfg, jparams = _pair("mamba2-780m")
    tparams = params_from_jax(jparams)
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    tl = leaves_with_path(tparams)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(a, b.numpy())
    own = init_params(tcfg, 0, "cpu")
    assert [(p, t.shape, t.dtype) for p, t in leaves_with_path(own)] == \
        [(p, t.shape, t.dtype) for p, t in tl]
    ssm = own["layers"][0]["ssm"]
    A = torch.exp(ssm["A_log"])
    assert bool(((A >= 1) & (A <= 16)).all())
    dt = torch.nn.functional.softplus(ssm["dt_bias"])
    assert bool(((dt > 9e-4) & (dt < 0.11)).all())
    assert bool((ssm["D"] == 1).all()) and bool((ssm["norm_scale"] == 1).all())


def test_make_batch_and_packed_stream_match_jax():
    jcfg, tcfg, _ = _pair("mamba2-780m")
    jb, tb = _batch(jcfg, seed=3)
    assert set(jb) == set(tb)
    for k in jb:
        np.testing.assert_array_equal(np.asarray(jb[k]), tb[k].numpy())
    dc = dict(vocab_size=jcfg.vocab_size, seq_len=48, global_batch=3, seed=1)
    js, ts = JaxPackedStream(JaxDataConfig(**dc)), PackedStream(
        DataConfig(**dc))
    for _ in range(3):
        a, b = js.next_batch(), ts.next_batch()
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    # the checkpointable position resumes identically
    js2 = JaxPackedStream(JaxDataConfig(**dc))
    js2.restore(ts.state())
    np.testing.assert_array_equal(js2.next_batch()["tokens"],
                                  ts.next_batch()["tokens"])


# -------------------------------------------------------------- loss_fn ----

@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch, use_kernels):
    jcfg, tcfg, params = _pair(arch)
    _, tb = _batch(jcfg)
    jloss, _ = _jax_loss_and_grads(arch, use_kernels)
    tloss, metrics = loss_fn(params_from_jax(params), tb, tcfg,
                             RunConfig(use_kernels=use_kernels))
    assert abs(float(tloss) - jloss) < 1e-5
    assert float(metrics["xent"]) == float(tloss)
    assert float(metrics["moe_balance_loss"]) == 0.0
    logits, _ = TM.forward_train(params_from_jax(params), tb, tcfg,
                                 RunConfig(use_kernels=use_kernels))
    assert logits.shape == (*SHAPE, tcfg.vocab_size)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax(arch, use_kernels):
    """Both port routes against ``jax.grad`` of the reference route."""
    jcfg, tcfg, params = _pair(arch)
    _, tb = _batch(jcfg)
    jloss, jgrads = _jax_loss_and_grads(arch, False)
    tloss, tgrads, _ = _torch_loss_and_grads(tcfg, params_from_jax(params),
                                             tb, use_kernels)
    assert abs(float(tloss) - jloss) < 1e-5
    _assert_leaves_close(tgrads, jgrads)


@pytest.mark.parametrize("remat", ["layer", "full"])
def test_remat_gives_the_same_gradients(remat):
    jcfg, tcfg, params = _pair("mamba2-780m")
    _, tb = _batch(jcfg)
    base = _torch_loss_and_grads(tcfg, params_from_jax(params), tb, True)
    got = _torch_loss_and_grads(tcfg, params_from_jax(params), tb, True,
                                remat=remat)
    assert float(got[0]) == float(base[0])
    for a, b in zip(got[1], base[1]):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_remat_rejects_unknown_mode():
    jcfg, tcfg, params = _pair("mamba2-780m")
    _, tb = _batch(jcfg)
    with pytest.raises(ValueError, match="remat"):
        loss_fn(params_from_jax(params), tb, tcfg, RunConfig(remat="some"))


def test_blocked_causal_attention_gradients():
    """Past one q block, training attention runs the blocks under
    checkpointing; its gradients are those of the one-block path."""
    from repro_torch.models import attention as TA

    _, tcfg, _ = _pair("stablelm-3b")
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 256, n, 16))
                                .astype(np.float32)) for n in (4, 2, 2))
    w = torch.from_numpy(rng.standard_normal((1, 256, 4, 16)).astype(
        np.float32))

    def grads(q_block):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = TA.causal_attention(*ins, tcfg, q_block=q_block)
        return torch.autograd.grad((o * w).sum(), ins)

    for a, b in zip(grads(64), grads(256)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


# ------------------------------------------------------------ optimizer ----

def test_lr_schedule_and_clipping_match_jax():
    opt, jopt = OptimizerConfig(**OPT), JaxOptimizerConfig(**OPT)
    for step in (0, 1, 2, 3, 26, 50, 80):
        np.testing.assert_allclose(
            float(lr_schedule(torch.tensor(step, dtype=torch.int32), opt)),
            float(jax_lr_schedule(jnp.asarray(step, jnp.int32), jopt)),
            rtol=1e-6)
    rng = np.random.default_rng(6)
    p = {"w": rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal(4).astype(np.float32)}
    g = {"w": 30 * rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal(4).astype(np.float32)}
    jp, js = p, jax_init_opt_state(p, jopt)
    tp = params_from_jax(p)
    ts = init_opt_state(tp, opt)
    jax_update = jax.jit(jax_adamw_update, static_argnums=3)
    for _ in range(2):                        # clipped; decay on "w" only
        jp, js, jm = jax_update(jp, g, js, jopt)
        tp, ts, tm = adamw_update(tp, params_from_jax(g), ts, opt)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts["step"]) == 2 and ts["step"].dtype == torch.int32
    _assert_leaves_close(leaves(tp), jp, atol=1e-7, rtol=1e-6)
    _assert_leaves_close(leaves(ts["m"]), js["m"], atol=1e-7, rtol=1e-6)
    _assert_leaves_close(leaves(ts["v"]), js["v"], atol=1e-7, rtol=1e-6)


# ------------------------------------------------- train step and trainer ----

@pytest.fixture(scope="module")
def jax_trainer(cpu_mesh):
    """A JAX trainer on reduced mamba2-780m with the shared weights:
    batch 4 of 64 tokens in two microbatches.  Its jitted step serves the
    one-step test and the trainer test (one compile)."""
    jcfg, tcfg, params = _pair("mamba2-780m")
    jopt = JaxOptimizerConfig(**OPT)
    shape = JaxInputShape("t", 64, 4, "train")
    t = JaxTrainer(jcfg, JaxRunConfig(strategy="dp", microbatches=2,
                                      remat="none"), cpu_mesh, shape, jopt,
                   JaxTrainerConfig(steps=3, log_every=100))
    return t


def test_train_step_two_microbatches_matches_jax(jax_trainer, cpu_mesh):
    jcfg, tcfg, params = _pair("mamba2-780m")
    opt = OptimizerConfig(**OPT)
    rng = np.random.default_rng(10)
    batch = {k: rng.integers(0, jcfg.vocab_size, (4, 64)).astype(np.int32)
             for k in ("tokens", "labels")}
    batch["loss_mask"] = (rng.random((4, 64)) > 0.1).astype(np.float32)
    jopt_state = jax_init_opt_state(jax.tree.map(jnp.asarray, params),
                                    jax_trainer.opt)
    with cpu_mesh:
        jp, js, jm = jax_trainer.step_fn(
            jax.tree.map(jnp.asarray, params), jopt_state,
            {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = params_from_jax(params)
    step = make_train_step(tcfg, RunConfig(use_kernels=True, microbatches=2),
                           single_device_mesh("cpu"), opt)
    tp, ts, tm = step(tparams, init_opt_state(tparams, opt),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6)
    _assert_leaves_close(leaves(tp), jp, **STEP_TOL)
    _assert_leaves_close(leaves(ts["m"]), js["m"])
    assert int(ts["step"]) == int(js["step"]) == 1


def test_trainer_three_steps_match_jax(jax_trainer, cpu_mesh):
    jcfg, tcfg, params = _pair("mamba2-780m")
    jax_trainer.params = jax.tree.map(jnp.asarray, params)
    jax_trainer.opt_state = jax_init_opt_state(jax_trainer.params,
                                               jax_trainer.opt)
    with cpu_mesh:
        jh = jax_trainer.train(log=lambda *_: None)
    t = Trainer(tcfg, RunConfig(use_kernels=True, microbatches=2), None,
                InputShape("t", 64, 4, "train"), OptimizerConfig(**OPT),
                TrainerConfig(steps=3, log_every=100), device="cpu")
    t.params = params_from_jax(params)
    th = t.train(log=lambda *_: None)
    assert [h["step"] for h in th] == [1, 2, 3]
    for a, b in zip(th, jh):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5)
    assert t.metrics.counter("train_tokens").value() == 3 * 4 * 64
    assert t.metrics.histogram("train_step_seconds").count() == 3


# ---------------------------------------------------------- checkpoints ----

def _ckpt_tree(params, bf16_leaf):
    return {"params": params, "opt": {"step": bf16_leaf[1],
                                      "extra_bf16": bf16_leaf[0]}}


def test_checkpoint_from_jax_restores_in_port(tmp_path):
    _, tcfg, params = _pair("mamba2-780m")
    b16 = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    jtree = _ckpt_tree(jax.tree.map(jnp.asarray, params),
                       (jnp.asarray(b16, jnp.bfloat16),
                        jnp.asarray(5, jnp.int32)))
    ds = {"doc": np.int64(17), "buf": np.arange(5, dtype=np.int32)}
    jckpt.save(str(tmp_path), 7, jtree, data_state=ds)
    like = _ckpt_tree(init_params(tcfg, 1, "cpu"),
                      (torch.zeros(2, 3, dtype=torch.bfloat16),
                       torch.zeros((), dtype=torch.int32)))
    assert tckpt.latest_step(str(tmp_path)) == 7
    got, gds = tckpt.restore(str(tmp_path), like)
    for (p, t), (jp, j) in zip(leaves_with_path(got),
                               jax.tree_util.tree_leaves_with_path(jtree)):
        assert p == jax.tree_util.keystr(jp)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))
    assert got["opt"]["extra_bf16"].dtype == torch.bfloat16
    assert int(gds["doc"]) == 17
    np.testing.assert_array_equal(gds["buf"], ds["buf"])


def test_checkpoint_from_port_restores_in_jax(tmp_path):
    _, tcfg, params = _pair("mamba2-780m")
    ttree = _ckpt_tree(params_from_jax(params),
                       (torch.arange(6, dtype=torch.float32).reshape(2, 3)
                        .div(7).to(torch.bfloat16),
                        torch.tensor(5, dtype=torch.int32)))
    for step in (1, 2, 3, 4):
        tckpt.save(str(tmp_path), step, ttree, keep=2,
                   data_state={"doc": np.int64(step),
                               "buf": np.zeros(2, np.int32)})
    assert sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("step_")) == ["step_00000003",
                                                     "step_00000004"]
    manifest = json.loads((tmp_path / "step_00000004" /
                           "MANIFEST.json").read_text())
    dtypes = {m["name"]: m["dtype"] for m in manifest["leaves"]}
    assert dtypes["opt_extra_bf16"] == "bfloat16"
    assert dtypes["opt_step"] == "int32"
    got, ds = jckpt.restore(str(tmp_path), jax.tree.map(
        lambda t: jax.ShapeDtypeStruct(
            t.shape, jnp.bfloat16 if t.dtype == torch.bfloat16
            else jnp.dtype(str(t.dtype).removeprefix("torch."))), ttree,
        is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert int(ds["doc"]) == 4
    for t, j in zip(leaves(ttree), jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))
    assert got["opt"]["extra_bf16"].dtype == jnp.bfloat16


def test_trainer_resumes_after_requeue(tmp_path):
    """Node drain -> requeue -> the job resumes from its checkpoint: 4
    steps with a checkpoint every 2, then a new trainer on the same
    directory trains to 6 and ends where an uninterrupted run ends."""
    _, tcfg, _ = _pair("mamba2-780m")
    opt = OptimizerConfig(**OPT)
    shape = InputShape("t", 32, 2, "train")

    def trainer(steps, **kw):
        return Trainer(tcfg, RunConfig(use_kernels=True, microbatches=2),
                       None, shape, opt, TrainerConfig(steps=steps, log_every=100,
                                                 **kw), device="cpu")

    trainer(4, ckpt_every=2, ckpt_dir=str(tmp_path)).train(
        log=lambda *_: None)
    assert tckpt.latest_step(str(tmp_path)) == 4
    resumed = trainer(6, ckpt_dir=str(tmp_path))
    h2 = resumed.train(log=lambda *_: None)
    assert resumed.step == 6 and h2[0]["step"] == 5
    straight = trainer(6).train(log=lambda *_: None)
    np.testing.assert_allclose(h2[-1]["loss"], straight[-1]["loss"],
                               rtol=1e-6)


def test_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` on the CPU: 2 steps with a
    checkpoint every 2, then the same job asked for 3 resumes at step 2;
    without ``--device`` and without a card it refuses to run."""
    args = ["--arch", "mamba2-780m", "--reduced", "--device", "cpu",
            "--seq-len", "32", "--batch", "2", "--microbatches", "2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    assert tlaunch.main(args + ["--steps", "2"]) == 0
    assert tckpt.latest_step(str(tmp_path)) == 2
    first = capsys.readouterr().out
    assert "training mamba2-780m" in first and "step     2" in first
    assert tlaunch.main(args + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "step     3" in out and "step     1 " not in out
    assert "train_tokens" in out and "64.000" in out    # one step's tokens
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tlaunch.main(["--arch", "mamba2-780m", "--reduced",
                          "--steps", "1"])
