"""The port's sharding rules against the JAX package's, with no ranks.

Every spec function of ``repro_torch.core.sharding`` and
``repro_torch.core.zero`` (``param_pspec`` through the trees of
``param_shardings``, ``opt_shardings`` and ``grad_shardings``,
``batch_partition``, ``batch_shardings``, ``cache_shardings``,
``make_activation_rules``, ``replicated``, ``describe``) gives the entries
of the ``PartitionSpec`` that the JAX function gives, for all ten configs
x the four strategies x ZeRO 1-3 x the meshes (4, 8), (4, 1), (2, 2) and
a pod mesh (2, 2, 2).  The port sees a stand-in mesh (``FakeMesh``, as in
``tests/test_parallelism.py``); the JAX package an ``AbstractMesh`` of the
same shape.  Also: ``RunConfig``'s defaults are JAX's, ``get_strategy``
refuses what JAX refuses, and the strategy catalog is the same."""
import dataclasses

import numpy as np
import pytest
from jax.sharding import AbstractMesh

import repro.configs as JC
import repro.core.parallelism as jpar
import repro.core.sharding as jshd
import repro.core.zero as jzero
import repro_torch.configs as TC
import repro_torch.core.parallelism as tpar
import repro_torch.core.sharding as tshd
import repro_torch.core.zero as tzero
from repro.models.model import init_cache as jax_init_cache
from repro.models.spec import iter_specs as jax_iter_specs
from repro.models.spec import model_spec as jax_model_spec
from repro_torch.models.spec import ParamSpec, model_spec

STRATEGIES = ("dp", "tp", "fsdp", "fsdp_tp")
MESHES = {"4x8": ((4, 8), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "pod": ((2, 2, 2), ("pod", "data", "model"))}


class FakeMesh:
    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = names


def _meshes(key):
    shape, names = MESHES[key]
    return FakeMesh(shape, names), AbstractMesh(shape, names)


def _specs(tree):
    """A JAX sharding tree -> the spec tuples, in leaf order (sorted
    keys), with their ``keystr`` names."""
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), tuple(s.spec)) for p, s in flat]


def _port_specs(tree):
    return tshd.spec_leaves(tree)


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_param_opt_grad_specs_match_jax(arch):
    """Every leaf's param, optimizer and gradient spec, per strategy x ZeRO
    stage x mesh; and ``param_pspec`` itself with and without the FSDP
    override."""
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    leaves = [(n, ps) for n, ps in jax_iter_specs(jax_model_spec(jcfg))]
    for key in MESHES:
        fake, amesh = _meshes(key)
        for strat in STRATEGIES:
            js, ts = jpar.get_strategy(strat), tpar.get_strategy(strat)
            for name, ps in leaves:
                tps = ParamSpec(ps.shape, ps.axes, ps.init, ps.scale)
                for override in (None, False, True):
                    assert tshd.param_pspec(tps, fake, ts, override) == \
                        tuple(jshd.param_pspec(ps, amesh, js, override)), (
                            key, strat, name, override)
            for zero in (1, 2, 3):
                jrun = JC.RunConfig(strategy=strat, zero_stage=zero)
                trun = TC.RunConfig(strategy=strat, zero_stage=zero)
                for jf, tf in ((jshd.param_shardings, tshd.param_shardings),
                               (jshd.opt_shardings, tshd.opt_shardings),
                               (jzero.grad_shardings, tzero.grad_shardings)):
                    assert _port_specs(tf(tcfg, fake, trun)) == \
                        _specs(jf(jcfg, amesh, jrun)), (key, strat, zero, tf)


def test_describe_and_replicated_match_jax():
    cfg = "starcoder2-3b"
    fake, amesh = _meshes("pod")
    for strat in STRATEGIES:
        jrun = JC.RunConfig(strategy=strat)
        trun = TC.RunConfig(strategy=strat)
        assert tshd.describe(tshd.param_shardings(TC.get_config(cfg), fake,
                                                  trun)) == \
            jshd.describe(jshd.param_shardings(JC.get_config(cfg), amesh,
                                               jrun))
        assert tshd.describe(tshd.opt_shardings(TC.get_config(cfg), fake,
                                                trun), max_rows=4) == \
            jshd.describe(jshd.opt_shardings(JC.get_config(cfg), amesh,
                                             jrun), max_rows=4)
    assert tshd.replicated(fake) == tuple(jshd.replicated(amesh).spec) == ()


@pytest.mark.parametrize("key", list(MESHES))
def test_batch_partition_and_batch_specs_match_jax(key):
    """The longest divisible prefix of the batch axes, the pod dropped
    first, the batch replicated when nothing divides."""
    import jax
    fake, amesh = _meshes(key)
    for strat in STRATEGIES:
        js, ts = jpar.get_strategy(strat), tpar.get_strategy(strat)
        for b in (1, 2, 3, 4, 6, 8, 12, 16, 32, 256):
            assert tshd.batch_partition(fake, b, ts) == \
                jshd.batch_partition(amesh, b, js), (strat, b)
        specs = {"tokens": jax.ShapeDtypeStruct((8, 64), np.int32),
                 "labels": jax.ShapeDtypeStruct((6, 64), np.int32),
                 "frame_embeddings": jax.ShapeDtypeStruct((4, 8, 16),
                                                          np.float32),
                 "pos": jax.ShapeDtypeStruct((8,), np.int32),
                 "scalar": jax.ShapeDtypeStruct((), np.int32)}
        run = dict(strategy=strat)
        got = tshd.batch_shardings(None, fake, TC.RunConfig(**run), specs)
        want = jshd.batch_shardings(None, amesh, JC.RunConfig(**run), specs)
        assert got == {k: tuple(v.spec) for k, v in want.items()}


@pytest.mark.parametrize("arch", ["stablelm-3b", "starcoder2-3b",
                                  "mamba2-780m", "jamba-1.5-large-398b"])
def test_cache_specs_match_jax(arch):
    """Decode-cache specs: batch on the batch axes, kv heads (or SSM heads)
    on `model`, else the cache sequence; dense and paged pools."""
    from repro.models.paging import PagedKVConfig
    jcfg = JC.get_reduced_config(arch)
    tcfg = TC.get_reduced_config(arch)
    for key in MESHES:
        fake, amesh = _meshes(key)
        for strat in STRATEGIES:
            for paging in ((False, True) if jcfg.ssm is None else (False,)):
                pg = (PagedKVConfig(page_size=8, num_pages=16,
                                    pages_per_seq=8) if paging else None)
                cache = jax_init_cache(jcfg, 4, 64, abstract=True,
                                       paging=pg)
                want = _specs(jshd.cache_shardings(
                    jcfg, amesh, JC.RunConfig(strategy=strat), cache,
                    paging=paging))
                got = _port_specs(tshd.cache_shardings(
                    tcfg, fake, TC.RunConfig(strategy=strat), cache,
                    paging=paging))
                assert got == want, (key, strat, paging)


NAMES = {"hidden": [(8, 4096, 2560), (6, 100, 64), (8, 2560)],
         "heads": [(8, 4096, 32, 80), (8, 4096, 3, 80), (6, 128, 8, 64)],
         "kv": [(8, 4096, 2, 80), (8, 4096, 32, 80)],
         "ssm_heads": [(8, 2048, 48, 64), (4, 256, 3, 64)],
         "ffn_hidden": [(8, 4096, 6912), (8, 4096, 100)],
         "logits": [(8, 4096, 50304), (8, 4096, 49153)],
         "ssm_inner": [(8, 2048, 3328), (8, 2048, 99)],
         "q_blocks": [(8, 8, 512, 4, 8, 80), (2, 6, 512, 2, 8, 80)],
         "hidden_full": [(8, 4096, 2560)],
         "moe_tokens": [(64, 1024, 2048), (6, 64, 256)],
         "moe_dispatch": [(64, 1024, 60, 48), (64, 1024, 64, 48)],
         "moe_expert_d": [(64, 60, 48, 2048), (64, 64, 48, 2048)],
         "moe_expert_f": [(64, 60, 48, 1408), (64, 64, 48, 1408)],
         "unknown-name": [(4,)]}


@pytest.mark.parametrize("key", list(MESHES))
def test_activation_rules_match_jax(key):
    """``make_activation_rules`` for every logical name and a few shapes,
    with and without ``seq_parallel`` and ``moe_defer_combine``."""
    fake, amesh = _meshes(key)
    cfg = "stablelm-3b"
    for strat in STRATEGIES:
        for sp in (False, True):
            for defer in (False, True):
                run = dict(strategy=strat, seq_parallel=sp,
                           moe_defer_combine=defer)
                tr = tshd.make_activation_rules(TC.get_config(cfg), fake,
                                                TC.RunConfig(**run))
                jr = jshd.make_activation_rules(JC.get_config(cfg), amesh,
                                                JC.RunConfig(**run))
                for name, shapes in NAMES.items():
                    for shape in shapes:
                        want = jr(name, shape)
                        want = None if want is None else tuple(want.spec)
                        assert tr(name, shape) == want, (run, name, shape)
    # installed, the rules answer activation_spec; constrain keeps values
    import torch
    from repro_torch.core.actshard import (
        activation_sharding, activation_spec, constrain,
    )
    x = torch.ones(8, 64, 2560)
    with activation_sharding(tr):
        assert activation_spec("hidden", x.shape) == tr("hidden", x.shape)
        assert constrain(x, "hidden") is x
    assert activation_spec("hidden", x.shape) is None


def test_run_config_defaults_and_strategies_match_jax():
    """The port's RunConfig has JAX's fields and defaults (``use_kernels``
    in place of ``use_pallas``); the strategy catalog is JAX's, and
    ``get_strategy`` refuses "pp" and unknown names as JAX does."""
    jf = {f.name: f.default for f in dataclasses.fields(JC.RunConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(TC.RunConfig)}
    assert jf.pop("use_pallas") is False and tf.pop("use_kernels") is False
    assert tf == jf
    assert {k: dataclasses.asdict(v) for k, v in tpar.STRATEGIES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jpar.STRATEGIES.items()}
    assert tpar.TP_AXIS_PRIORITY == jpar.TP_AXIS_PRIORITY
    assert tpar.NEVER_SHARD == jpar.NEVER_SHARD
    for name in ("pp", "zero"):
        with pytest.raises(ValueError) as je:
            jpar.get_strategy(name)
        with pytest.raises(ValueError) as te:
            tpar.get_strategy(name)
        assert str(te.value).replace("repro_torch.", "repro.") == \
            str(je.value)


def test_layout_of_a_one_cell_mesh_is_the_identity():
    """On a one-cell mesh every leaf is whole in every layout and no
    gradient is reduced."""
    import torch
    from repro_torch.launch.mesh import single_device_mesh
    cfg = TC.get_reduced_config("stablelm-3b")
    lay = tzero.Layout(cfg, single_device_mesh("cpu"), TC.RunConfig())
    assert lay.tp is None and lay.world == 1
    for leaf in lay.leaves:
        assert all(e is None for e in leaf.param + leaf.opt)
        t = torch.ones(leaf.shape)
        assert lay.local(t, leaf.param) is t and lay.opt_view(leaf, t) is t
        assert lay.owned(leaf) and not leaf.partial_model
    grads = [torch.ones(leaf.shape) for leaf in lay.leaves]
    assert all(a is b for a, b in zip(lay.reduce_grads(grads), grads))
    assert lay.param_use() is None
    assert [leaf.shape for leaf in lay.leaves] == [
        ps.shape for _, ps in tzero._ps_leaves(model_spec(cfg))]
