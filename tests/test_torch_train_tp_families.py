"""Tensor-parallel training of the SSM, hybrid and MoE families and the
``seq_parallel`` and ``moe_defer_combine`` layouts, against the JAX
package's one-device step, on the CPU.

One launch of 2 gloo ranks runs every (1, 2) scenario of
``tests/_torch_train_tp_ranks.py`` (which imports no JAX) and one of 4
ranks every (2, 2) scenario; beside them this process runs the JAX
one-device steps on the same weights (the JAX init, through numpy) and
batches:

* reduced mamba2-780m, jamba and qwen2-moe under ``tp`` on (1, 2) and
  ``fsdp_tp`` ZeRO 3 on (2, 2): the SSD heads, the experts (expert
  parallelism) and the shared expert's ``d_ff`` on ``model``;
* reduced qwen2-moe cut to 3 experts, which 2 ranks do not divide:
  each expert's ``d_ff`` shards (TP-in-expert), with and without
  ``moe_defer_combine``;
* ``seq_parallel`` under ``tp``: reduced stablelm-3b (its heads divide),
  a cut with 3 query heads and a vocabulary of 511 (attention entered on
  the gathered sequence and left through a slice; the embedding and the
  head replicated), mamba2-780m, jamba and the 3-expert qwen2-moe;
* reduced mamba2-780m at d_model 240: 15 SSD heads over an inner dim of
  480, which shards while the heads do not (the block runs whole from
  the gathered weights), with and without ``seq_parallel``;
* ``dp`` + ``seq_parallel`` and ``fsdp`` + ``moe_defer_combine`` on
  (1, 2), which change no layout outside a TP strategy;
* the router's gradient on its own, at the initial weights, and the aux
  losses among the compared metrics.

Every scenario is held against the JAX one-device step without the
knobs: on one device they name no layout (JAX installs no activation
rules there), and at 32 positions ``seq_parallel``'s one q block is the
q-block path (``test_torch_train_parallel.py`` holds the port's
``seq_parallel`` on one rank against JAX's at 1,024).  AdamW takes
``_torch_train_tp_ranks.OPT`` (eps 1e-6, see there) on both sides.

Tolerances are ``test_torch_train_parallel.py``'s: f32 metrics 1e-5
relative, final parameters after 2 steps within 1e-4 of the largest
magnitude; the router gradient 1e-5 of its largest magnitude."""
import dataclasses
import multiprocessing as mp
import threading
from concurrent.futures import ProcessPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_reduced_config as jax_reduced
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.optim import OptimizerConfig as JaxOptimizerConfig
from repro.optim import init_opt_state as jax_init_opt_state
from repro.training import make_train_step as jax_make_train_step
from repro_torch.launch.mesh import launch_ranks
from repro_torch.training.train_step import METRIC_KEYS

import _torch_train_ranks as R
import _torch_train_tp_ranks as T

F32 = dict(rtol=1e-5, param=1e-4)


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops under a loaded machine: torch's intra-op pool only
    waits (see tests/test_torch_cluster.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg(arch, var):
    return T.variant(dataclasses.replace(jax_reduced(arch), dtype="float32"),
                     var)


def _jax_steps(cfg, weights, mesh, bshape):
    """The JAX one-device step on ``R.batches``: per-step metrics and final
    parameters (numpy leaves)."""
    opt = JaxOptimizerConfig(**T.OPT)
    step = jax_make_train_step(cfg, JaxRunConfig(
        strategy="dp", remat="none"), mesh, opt)
    params = jax.tree.map(jnp.asarray, weights)
    state = jax_init_opt_state(params, opt)
    metrics = []
    with mesh:
        for b in R.batches(cfg, bshape):
            params, state, m = step(params, state,
                                    {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "params": [np.asarray(x) for x in jax.tree.leaves(params)]}


def _jax_router_grads(cfg, weights, bshape):
    """The gradient of the JAX loss over the first batch, router leaves."""
    b = R.batches(cfg, bshape)[0]
    run = JaxRunConfig(remat="none")
    grads = jax.jit(jax.grad(
        lambda p, x: jax_loss_fn(p, x, cfg, run)[0]))(
            jax.tree.map(jnp.asarray, weights),
            {k: jnp.asarray(v) for k, v in b.items()})
    return [np.asarray(g) for path, g in
            jax.tree_util.tree_leaves_with_path(grads)
            if "'router'" in jax.tree_util.keystr(path)]


def _jax_refs(keys, weights, mesh=None) -> dict:
    """The JAX one-device steps of ``keys`` ((arch, variant) pairs) and,
    for the routed ones, the router gradients.  Run in a spawned process
    too (``mesh`` None), beside this one."""
    if mesh is None:
        from repro.launch.mesh import make_mesh
        mesh = make_mesh(1, 1)
    routed = {(c[1], c[2]) for c in T.CASES if c[0] in T.ROUTER}
    out = {}
    for arch, var in keys:
        cfg = _jax_cfg(arch, var)
        bshape = T.shape_of(arch)
        w = weights[(arch, var)]
        out[(arch, var)] = _jax_steps(cfg, w, mesh, bshape)
        if (arch, var) in routed:
            out[(arch, var)]["router"] = _jax_router_grads(cfg, w, bshape)
    return out


@pytest.fixture(scope="module")
def runs(cpu_mesh):
    """Both launches' results and the JAX references, per scenario."""
    weights = {}
    for _, arch, var, _, _ in T.CASES:
        if (arch, var) not in weights:
            cfg = _jax_cfg(arch, var)
            weights[(arch, var)] = jax.tree.map(np.asarray, jax.jit(
                jax_init_params, static_argnums=(0, 1))(cfg, 0))
    labels = {shape: [c[0] for c in T.CASES if c[3] == shape]
              for shape in ((1, 2), (2, 2))}
    out: dict = {}

    def run(shape):
        try:
            out[shape] = launch_ranks(
                T.rank_main, *shape, devices=["cpu"] * (shape[0] * shape[1]),
                backend="gloo", args=({"cases": labels[shape],
                                       "weights": weights},),
                threads=1, timeout=600)
        except BaseException as e:          # raised below, in the test
            out["error"] = e

    threads = [threading.Thread(target=run, args=(s,)) for s in labels]
    for th in threads:
        th.start()
    # half the JAX compiles in a process of their own, beside the ranks
    keys = list(weights)
    with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as pool:
        other = pool.submit(_jax_refs, keys[::2], weights)
        refs = _jax_refs(keys[1::2], weights, cpu_mesh)
        refs.update(other.result(timeout=600))
    for th in threads:
        th.join()
    if "error" in out:
        raise out["error"]
    ranks = {**out[(1, 2)][0]["train"], **out[(2, 2)][0]["train"]}
    return SimpleNamespace(train=ranks,
                           refs={c[0]: refs[(c[1], c[2])] for c in T.CASES},
                           ranks_router=out[(1, 2)][0]["router"],
                           others=[r for s in out for r in out[s][1:]])


def _close(port, ref, rtol, param):
    assert len(port["metrics"]) == len(ref["metrics"]) == R.STEPS
    for pm, jm in zip(port["metrics"], ref["metrics"]):
        assert set(pm) == set(jm) == set(METRIC_KEYS)
        for k in METRIC_KEYS:
            np.testing.assert_allclose(pm[k], jm[k], rtol=rtol, atol=1e-8,
                                       err_msg=k)
    assert [a.shape for a in port["params"]] == \
        [b.shape for b in ref["params"]]
    scale = max(float(np.max(np.abs(p))) for p in ref["params"])
    for a, b in zip(port["params"], ref["params"]):
        assert float(np.max(np.abs(a - b))) <= param * scale


@pytest.mark.parametrize("label", [c[0] for c in T.CASES])
def test_tp_families_and_layouts_match_jax_one_device(runs, label):
    _close(runs.train[label], runs.refs[label], **F32)
    arch = next(c[1] for c in T.CASES if c[0] == label)
    if arch in ("qwen2-moe-a2.7b", "jamba-1.5-large-398b"):
        m = runs.train[label]["metrics"][0]
        assert m["moe_balance_loss"] > 0 and m["moe_z_loss"] > 0
    for rank in runs.others:            # every rank took the same steps
        if label in rank["train"]:
            assert rank["train"][label]["metrics"] == \
                runs.train[label]["metrics"]


@pytest.mark.parametrize("label", T.ROUTER)
def test_router_gradient_matches_jax(runs, label):
    """Each rank's router gradient, reduced as the step reduces it, is
    the JAX gradient (the aux losses' part counted once)."""
    got, want = runs.ranks_router[label], runs.refs[label]["router"]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * float(np.max(np.abs(w))))
