"""Tensor-parallel serving of the port against the JAX package, on the
CPU.

* Eight engine scenarios on reduced stablelm-3b in f32 with the JAX init's
  weights — the dense cache, 8-line pages, a 16-token budget, the prefix
  cache, n-gram speculation (k 2), a starved pool (4 pages), the
  kernels' route (``use_kernels``; JAX ``use_pallas``) and 3 heads that 2
  shards do not divide (attention replicates, the MLP shards) — served by
  2 gloo ranks of the port (``serving.tp.launch``, one launch for all of
  them) and by the JAX engine on a (1, 2) mesh of forced host devices
  (one subprocess for all of them, run beside the ranks).  Per scenario:
  greedy outputs equal to JAX tp=2's, to the port's tp=1 and across the
  ranks; both shards' pools drained (to the radix index's pages);
  ``tp_stats()`` equal to JAX's apart from device names; one request's
  prefill logits within 1e-5 of the largest magnitude of JAX tp=2's.
* In the same ranks: the all-reduces of one decode step (one f32
  reduction per layer at each sharded point, none at a replicated one,
  f32 under bf16 compute), the lockstep clock with the ranks' clocks a
  day apart, and a divergence that the next decode call refuses.
* Unit checks against the JAX package: ``plan_tp`` for every config and
  tp 1-5, the sharded dimension of every parameter leaf,
  ``cache_kv_head_dim``, ``shard_params`` slices concatenating back,
  ``sdiag``'s TP section, ``resolve_tp``'s message.
* ``serve --reduced --device cpu --tp 2`` (and with ``--kv-paging 16
  --trace``) against the JAX CLI under forced devices, timings masked.
* ``chip_smoke.py``'s TP phase at reduced size on the CPU, and the new
  modules importing without JAX."""
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.cluster.commands as jcommands
import repro.configs as JC
import repro.serving.tp as jtp
from repro.launch import serve as jserve
from repro.models import init_params as jax_init_params
from repro.models.model import cache_kv_head_dim as jax_cache_kv_head_dim
import repro_torch.cluster.commands as tcommands
import repro_torch.configs as TC
import repro_torch.serving.tp as ttp
from repro_torch.launch import serve as tserve
from repro_torch.models import init_params
from repro_torch.models.model import cache_kv_head_dim
from repro_torch.weights import params_from_jax

from _torch_tp_ranks import (
    SCENARIOS, rank_main, request_specs, scenario_cfg, serve_torch,
)

ROOT = Path(__file__).resolve().parents[1]

_JAX = r'''
import contextlib, dataclasses, io, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import numpy as np, jax, jax.numpy as jnp
assert len(jax.devices()) == 2, jax.devices()
from repro.configs.base import RunConfig
from repro.configs.stablelm_3b import reduced
from repro.launch import serve
from repro.launch.mesh import make_mesh
from repro.models import init_params
from repro.serving import DecodeEngine
from repro.serving.engine import Request

spec = json.loads(sys.argv[1])
cfg = dataclasses.replace(reduced(), dtype="float32")
cfg3 = dataclasses.replace(cfg, num_heads=3, num_kv_heads=3)
params, params3 = init_params(cfg, 0), init_params(cfg3, 0)
mesh = make_mesh(1, 2)
out = {"scenarios": {}, "cli": {}}
for name, (opts, reqs) in spec["scenarios"].items():
    opts = dict(opts)
    kernels = opts.pop("kernels", False)
    c, p = (cfg3, params3) if opts.pop("heads3", False) else (cfg, params)
    eng = DecodeEngine(c, p, num_slots=2, cache_len=64, mesh=mesh,
                       run=RunConfig(remat="none", use_pallas=kernels),
                       prefill_buckets="auto", **opts)
    rs = [Request(rid=i, prompt=np.asarray(q, np.int32), max_new_tokens=n)
          for i, (q, n) in enumerate(reqs)]
    for r in rs:
        eng.submit(r)
    eng.run_to_completion()
    # the first bucket's program, which the engine compiled already
    tokens = np.zeros(eng.prefill_buckets[0], np.int32)
    tokens[:len(rs[0].prompt)] = rs[0].prompt
    logits, _ = eng._prefill_fn(eng.params, jnp.asarray(tokens)[None],
                                jnp.asarray(len(rs[0].prompt) - 1,
                                            jnp.int32))
    out["scenarios"][name] = {
        "outputs": [list(map(int, r.output)) for r in rs],
        "in_use": ([int(n) for n in eng.pool_view.in_use_vector()]
                   if eng.paging is not None else None),
        "tp_stats": eng.tp_stats(),
        "logits": np.asarray(logits[0, -1], np.float64).tolist()}
for key, argv in spec["cli"].items():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert serve.main(argv) == 0
    out["cli"][key] = buf.getvalue()
print("JSON " + json.dumps(out))
'''

#: the CLI runs: flags after ``--reduced --tp 2`` (``TRACE`` is replaced by
#: a path per side)
CLI = {"plain": [], "trace": ["--kv-paging", "16", "--trace", "TRACE"]}


def _cli_argv(key, trace_path):
    return ["--reduced", "--tp", "2"] + [
        trace_path if a == "TRACE" else a for a in CLI[key]]


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops under a loaded machine: torch's intra-op pool only
    waits (see tests/test_torch_cluster.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _port_cli(key, tmp) -> str:
    path = str(tmp / f"torch-trace-{key}.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tserve.main(_cli_argv(key, path) + ["--device", "cpu"]) == 0
    return buf.getvalue()


#: chip_smoke.py's TP phase at reduced size (the prefix run's prompts sit
#: behind a 64-token system prompt)
SMOKE_ARGS = dict(slots=2, cache_len=128, max_new=6, decode_chunk=4,
                  requests=3)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX engine's scenarios and CLI runs under 2 forced host
    devices (a subprocess), and beside it the port's: the scenarios on 2
    gloo ranks (one launch), at tp=1 in this process, the CLI runs and
    ``chip_smoke.py``'s TP phase at reduced size."""
    tmp = tmp_path_factory.mktemp("tp")
    jcfg = _f32(JC.get_reduced_config("stablelm-3b"))
    tcfg = _f32(TC.get_reduced_config("stablelm-3b"))
    np_params = jax.tree.map(np.asarray, jax_init_params(jcfg, 0))
    np_params3 = jax.tree.map(np.asarray, jax_init_params(
        scenario_cfg(jcfg, {"heads3": True}), 0))
    spec = {"scenarios": {
                name: (opts, [(p.tolist(), n) for p, n in
                              request_specs(kind)])
                for name, (opts, kind) in SCENARIOS.items()},
            "cli": {k: _cli_argv(k, str(tmp / "jax-trace.json"))
                    for k in CLI}}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _JAX, json.dumps(spec)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=tmp)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ranks = ttp.launch(rank_main, 2, devices=["cpu", "cpu"],
                           backend="gloo",
                           args=(tcfg, np_params, np_params3), threads=1,
                           timeout=300)
        params = params_from_jax(np_params)
        params3 = params_from_jax(np_params3)
        one = {}
        for name, (opts, kind) in SCENARIOS.items():
            c, p = ((scenario_cfg(tcfg, opts), params3)
                    if opts.get("heads3") else (tcfg, params))
            _, reqs = serve_torch(c, p, opts, kind)
            one[name] = [list(r.output) for r in reqs]
        cli = {key: _port_cli(key, tmp) for key in CLI}
        with pytest.MonkeyPatch.context() as mp:
            mp.syspath_prepend(str(ROOT))
            import chip_smoke
            smoke = chip_smoke.tp_phase(SMOKE_ARGS, device="cpu",
                                        reduced=True)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        torch.set_num_threads(threads)
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-4000:]
    line = next(ln for ln in stdout.splitlines() if ln.startswith("JSON "))
    return {"jax": json.loads(line[5:]), "ranks": ranks, "one": one,
            "cli": cli, "smoke": smoke, "tmp": tmp}


# ------------------------------------------------------------ scenarios ----

@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_jax_tp2_and_tp1(runs, name):
    want = runs["jax"]["scenarios"][name]
    r0, r1 = (r[name] for r in runs["ranks"])
    assert r0["done"] and r1["done"]
    assert r0["outputs"] == r1["outputs"], "the ranks' outputs differ"
    assert r0["outputs"] == want["outputs"], "port tp=2 != JAX tp=2"
    assert r0["outputs"] == runs["one"][name], "port tp=2 != port tp=1"
    # both shards' pools drained: only the radix index holds pages
    assert r0["in_use"] == r1["in_use"] == want["in_use"]
    if want["in_use"] is not None:
        assert r0["in_use"] == [r0["index_pages"]] * len(r0["in_use"])
    # tp_stats equal to JAX's apart from device names
    for r in (r0, r1):
        got, ref = dict(r["tp_stats"]), dict(want["tp_stats"])
        assert len(got.pop("devices")) == len(ref.pop("devices"))
        assert got == ref
    ref = np.asarray(want["logits"])
    for r in (r0, r1):
        err = float(np.abs(r["logits"] - ref).max())
        assert err <= 1e-5 * float(np.abs(ref).max()), err
    heads3 = SCENARIOS[name][0].get("heads3", False)
    # the KV cache holds the shard's heads: 4 kv heads over 2 shards
    assert set(r0["cache_heads"]) == {3 if heads3 else 2}
    counts = r0["counts"]
    assert counts == r1["counts"] and counts["mlp_out"] > 0
    assert counts["attn_out"] == (0 if heads3 else counts["mlp_out"])


def test_scenarios_exercise_their_modes(runs):
    r = runs["ranks"][0]
    assert r["speculative"]["spec_rounds"] > 0
    assert r["budgeted"]["chunks"] > len(request_specs("long"))
    assert r["prefix"]["hits"] > 0
    assert r["starved"]["starvations"] > 0


@pytest.mark.parametrize("case, counts", [
    ("float32", {"attn_out": 2, "mlp_out": 2}),
    ("bfloat16", {"attn_out": 2, "mlp_out": 2}),
    ("heads3", {"attn_out": 0, "mlp_out": 2}),
])
def test_one_decode_step_reduces_f32_partials(runs, case, counts):
    """One all-reduce per layer at each sharded point (reduced stablelm-3b
    has 2 layers), none at a replicated one, each of an f32 partial —
    under bf16 compute too."""
    for r in runs["ranks"]:
        got, dtypes = r["step"][case]
        assert got == counts
        assert dtypes == ["torch.float32"]


def test_lockstep_clock_and_divergence_check(runs):
    r0, r1 = runs["ranks"]
    # clocks a day apart: the ledger decays on rank 0's clock on both
    assert r0["clock"]["outputs"] == r1["clock"]["outputs"]
    assert r0["clock"]["usage"] == r1["clock"]["usage"]
    assert r0["clock"]["last_decay"] == r1["clock"]["last_decay"]
    assert any(v > 0 for v in r0["clock"]["usage"].values())
    for r in (r0, r1):
        assert r["diverged"] is not None
        assert "ranks diverged at decode" in r["diverged"]


# ----------------------------------------------------------------- plan ----

class _FakeMesh:
    """Just enough mesh surface for both packages' plan_tp."""

    def __init__(self, tp):
        self.shape = {"data": 1, "model": tp}
        self.axis_names = ("data", "model")
        self.devices = np.empty((1, tp), object)


def _configs(arch):
    for get_j, get_t in ((JC.get_config, TC.get_config),
                         (JC.get_reduced_config, TC.get_reduced_config)):
        yield get_j(arch), get_t(arch)


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_plan_tp_matches_jax(arch):
    for jcfg, tcfg in _configs(arch):
        for tp in range(1, 6):
            jp = jtp.plan_tp(jcfg, _FakeMesh(tp))
            tp_ = ttp.plan_tp(tcfg, _FakeMesh(tp))
            assert (tp_.tp, tp_.shard_attn, tp_.shard_mlp, tp_.active) == \
                (jp.tp, jp.shard_attn, jp.shard_mlp, jp.active)
            assert tp_.notices == jp.notices
            assert tp_.psums_per_token(tcfg) == jp.psums_per_token(jcfg)
            assert tp_.describe(tcfg) == jp.describe(jcfg)
    assert not ttp.plan_tp(tcfg, None).active
    assert ttp.plan_tp(tcfg, None).describe(tcfg) == "tp=1 (single shard)"


def _dims(tree):
    """Flatten a tree of sharded dims (port) or PartitionSpecs (JAX) into
    (path, dim or None)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            for path, d in _dims(tree[k]):
                yield f"{k}/{path}", d
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            for path, d in _dims(v):
                yield f"{i}/{path}", d
    elif tree is None or isinstance(tree, int):
        yield "", tree
    else:
        spec = tuple(tree)
        yield "", spec.index("model") if "model" in spec else None


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_param_shard_dims_match_jax(arch):
    for jcfg, tcfg in _configs(arch):
        for tp in (2, 3, 4):
            jp = jtp.plan_tp(jcfg, _FakeMesh(tp))
            tp_ = ttp.plan_tp(tcfg, _FakeMesh(tp))
            got = list(_dims(ttp.param_pspecs(tcfg, tp_)))
            want = list(_dims(jtp.param_pspecs(jcfg, jp)))
            assert got == want


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_cache_kv_head_dim_matches_jax(arch):
    jcfg, tcfg = JC.get_reduced_config(arch), TC.get_reduced_config(arch)
    for paging in (False, True):
        try:
            want = jax_cache_kv_head_dim(jcfg, paging=paging)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                cache_kv_head_dim(tcfg, paging=paging)
            continue
        assert cache_kv_head_dim(tcfg, paging=paging) == want == 3
    # the cache's sharded dim is the kv-head axis, when attention shards
    jplan = jtp.TPPlan(mesh=None, tp=2, shard_attn=True)
    tplan = ttp.TPPlan(mesh=None, tp=2, shard_attn=True)
    if jcfg.ssm is None:
        assert ttp.cache_pspec(tplan, tcfg) == \
            tuple(jtp.cache_pspec(jplan, jcfg)).index("model")
    assert ttp.cache_pspec(ttp.TPPlan(mesh=None, tp=2), tcfg) is None


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("arch", ["stablelm-3b", "qwen2-7b", "starcoder2-3b",
                                  "qwen2-moe-a2.7b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_concatenate_back(arch, tp):
    cfg = TC.get_reduced_config(arch)
    full = init_params(cfg, 0, "cpu")
    plan = ttp.plan_tp(cfg, _FakeMesh(tp))
    dims = list(_dims(ttp.param_pspecs(cfg, plan)))
    shards = [list(_leaves(ttp.shard_params(full, cfg, plan, r)))
              for r in range(tp)]
    assert plan.active == any(d is not None for _, d in dims)
    for i, (leaf, (path, d)) in enumerate(zip(_leaves(full), dims)):
        parts = [s[i] for s in shards]
        if d is None:
            assert all(p is leaf for p in parts), path
            continue
        assert all(p.is_contiguous() and p.data_ptr() != leaf.data_ptr()
                   for p in parts), path
        assert torch.equal(torch.cat(parts, dim=d), leaf), path


# ---------------------------------------------------------------- sdiag ----

def _tp_engine(stats):
    return SimpleNamespace(max_batch_tokens=None, speculate=0,
                           tp=SimpleNamespace(tp=stats["tp"]),
                           tp_stats=lambda: stats)


def test_sdiag_tp_section_matches_jax(runs):
    golden = {
        "tp": 2, "active": True,
        "plan": "tp=2 attn(heads 4->2/shard, kv 4->2/shard), "
                "mlp(ffn 512->256/shard)",
        "devices": ["TFRT_CPU_0", "TFRT_CPU_1"],
        "notices": ["d_ff=512 example notice"],
        "psums_per_token": {"attn_out": 2, "mlp_out": 2},
        "kv_pages_in_use": [4, 4], "kv_pages_total": 8}
    cases = [golden] + [runs["ranks"][0][name]["tp_stats"]
                        for name in ("dense", "paged", "heads3")]
    for stats in cases:
        eng = _tp_engine(stats)
        want = jcommands.sdiag(engine=eng)
        assert want.startswith("Tensor parallelism:")
        assert tcommands.sdiag(engine=eng) == want
    off = SimpleNamespace(max_batch_tokens=None, speculate=0,
                          tp=SimpleNamespace(tp=1))
    assert tcommands.sdiag(engine=off) == "sdiag: nothing to report"


# ------------------------------------------------------------------ CLI ----

@pytest.mark.parametrize("requested, n", [(1, 1), (2, 1), (2, 2), (4, 2),
                                          (4, 8), (3, 0)])
def test_resolve_tp_matches_jax(requested, n):
    outs = []
    for fn in (jserve.resolve_tp, tserve.resolve_tp):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            got = fn(requested, n)
        outs.append((got, buf.getvalue()))
    assert outs[0] == outs[1]


#: the port's served line names its device, and its bucket line counts
#: bucket lengths where the JAX line counts compilations (the same number)
_MASKS = [
    (re.compile(r"tokens in [\d.]+s \([\d,.]+ tok/s, (.*?)(, cpu)?\)$",
                re.M), r"tokens in #s (# tok/s, \1)"),
    (re.compile(r": (\d+) (compilations|bucket lengths used)$", re.M),
     r": \1 buckets"),
    (re.compile(r"^decode p50 [\d.]+ms  p99 [\d.]+ms$", re.M),
     "decode p50 #ms  p99 #ms"),
]


def _masked(text: str) -> str:
    for pattern, repl in _MASKS:
        text = pattern.sub(repl, text)
    return text


def _tp_section(text: str) -> list:
    block = text.split("Tensor parallelism:\n", 1)[1].split("\n\n", 1)[0]
    return [re.sub(r"\(.*\)$", "(#)", ln) if "Devices:" in ln else ln
            for ln in block.splitlines()]


@pytest.mark.parametrize("key", list(CLI))
def test_cli_tp2_matches_jax(runs, key):
    """Every line before ``trace:`` equal, timings masked; with
    ``--trace``, sdiag's TP section equal apart from device names."""
    want = runs["jax"]["cli"][key]
    got = runs["cli"][key]
    assert "tensor parallel: tp=2 attn(heads 4->2/shard, kv 4->2/shard), " \
           "mlp(ffn 512->256/shard) on 2 devices, 4 psums/token (attn 2, " \
           "mlp 2)" in got.splitlines()
    head = [ln for ln in got.split("trace:")[0].splitlines()]
    want_head = [ln for ln in want.split("trace:")[0].splitlines()]
    assert _masked("\n".join(head)) == _masked("\n".join(want_head))
    if key == "trace":
        assert (runs["tmp"] / "torch-trace-trace.json").exists()
        assert _tp_section(got) == _tp_section(want)
        assert "\tKV pool shard 1:  0/" in got


# ---------------------------------------------------- smoke and imports ----

def test_chip_smoke_tp_phase_reduced(runs):
    """``chip_smoke.py``'s TP phase at reduced size on the CPU (gloo ranks
    on the CPU in place of two ranks sharing the card); its own gates ran
    in the fixture."""
    out = runs["smoke"]
    assert [r["label"] for r in out["runs"]] == [
        "tp=2 dense", "tp=2 16-line pages, prefix cache"]
    for run in out["runs"]:
        assert run["outputs"][0] == run["outputs"][1]
    assert out["identity"]["same"] == out["identity"]["total"]


_PROBE = r"""
import importlib, importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {"jax", "jaxlib", "repro", "triton"}:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
for mod in ("repro_torch.core", "repro_torch.core.actshard",
            "repro_torch.core.sharding", "repro_torch.launch.mesh",
            "repro_torch.serving.tp", "_torch_tp_ranks"):
    importlib.import_module(mod)
print("OK")
"""


def test_new_modules_import_without_jax():
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    r = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "OK", r.stderr
