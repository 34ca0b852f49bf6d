"""The port's example twins (``examples/torch``) on the CPU, small.

* The host-only twins (``slurm_workflow``, ``multi_tenant``) print byte
  for byte what the JAX examples' ``main()`` prints.
* Every other twin runs with ``--device cpu`` at a small size and passes
  its own assertions: ``quickstart`` and ``train_cluster`` print the JAX
  examples' tables, and ``train_cluster``'s checkpoint at step 100
  resumes a rerun; ``serve_batch``, ``multi_tenant_serving`` (its
  speculation bit-identical to plain decoding) and ``elastic_serving``
  (drained requests bit-identical to one engine) run in this process;
  ``tp_serving`` (f32 tp=2 tokens equal tp=1's) and ``pipeline_parallel``
  (forward within 1e-5 of the sequential run, a falling loss) start one
  2-rank gloo launch each, in processes of their own, since each rank is
  a ``spawn``ed process that imports the script.

That no twin imports ``jax`` or ``repro`` is ``test_torch_imports.py``'s.
"""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TWINS = ROOT / "examples" / "torch"


def _load(path: Path, prefix: str):
    spec = importlib.util.spec_from_file_location(
        f"{prefix}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops under a loaded machine: torch's intra-op pool only
    waits (see tests/test_torch_cluster.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def launched():
    """The two twins that start ranks, started at once beside the
    in-process tests: ``{name: Popen}``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    argv = {"tp_serving": ["--requests", "4", "--max-new", "8"],
            "pipeline_parallel": []}
    procs = {name: subprocess.Popen(
        [sys.executable, str(TWINS / f"{name}.py"), "--device", "cpu",
         *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=ROOT) for name, args in argv.items()}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.wait()


def test_every_jax_example_has_a_twin():
    assert sorted(p.name for p in (ROOT / "examples").glob("*.py")) == \
        sorted(p.name for p in TWINS.glob("*.py"))


@pytest.mark.parametrize("name", ["slurm_workflow", "multi_tenant"])
def test_host_only_twin_is_byte_identical(name, capsys):
    _load(ROOT / "examples" / f"{name}.py", "jax_example").main()
    ref = capsys.readouterr().out
    _load(TWINS / f"{name}.py", "torch_example").main(["--device", "cpu"])
    assert capsys.readouterr().out == ref
    assert "sacct" in ref


def test_quickstart_prints_the_jax_tables(capsys):
    _load(TWINS / "quickstart.py", "torch_example").main(
        ["--device", "cpu", "--steps", "5"])
    out = capsys.readouterr().out
    for section in ("== slurm-validation ==", "validation: PASSED",
                    "== sinfo ==", "== sbatch ==\nSubmitted batch job",
                    "== sacct ==", "deep_learning_job", "COMPLETED",
                    "train_step_seconds           "):
        assert section in out
    assert "step     5  loss" in out


def test_train_cluster_checkpoints_and_resumes(tmp_path, capsys):
    mod = _load(TWINS / "train_cluster.py", "torch_example")
    argv = ["--device", "cpu", "--reduced", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path)]
    mod.main(argv + ["--steps", "100"])
    out = capsys.readouterr().out
    assert "model: repro-100m  params=2,229,504" in out
    assert re.search(r"loss: \S+ \(step 1\) -> \S+ \(step 100\)", out)
    assert (tmp_path / "LATEST").read_text() == "step_00000100"
    # a rerun on the same directory resumes at its LATEST checkpoint
    mod.main(argv + ["--steps", "102"])
    out = capsys.readouterr().out
    assert re.search(r"loss: \S+ \(step 101\) -> \S+ \(step 102\)", out)
    assert re.search(r"train_repro_100m\s.*\sCOMPLETED\s", out)


def test_serve_batch_runs(capsys):
    _load(TWINS / "serve_batch.py", "torch_example").main(
        ["--device", "cpu", "--requests", "6", "--max-new", "8"])
    out = capsys.readouterr().out
    assert "6 requests through 4 slots: " in out
    assert "req 2: prompt[" in out


def test_multi_tenant_serving_runs(capsys):
    _load(TWINS / "multi_tenant_serving.py", "torch_example").main(
        ["--device", "cpu", "--load-steps", "40"])
    out = capsys.readouterr().out
    assert "evictions: 1" in out
    assert "victim's trace: 2 decode segments" in out
    assert "every short is decoding" in out
    assert "output bit-identical to plain decoding" in out
    assert "Serve-step utilization (token budget)" in out


def test_elastic_serving_drains_bit_identically(capsys):
    _load(TWINS / "elastic_serving.py", "torch_example").main(
        ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "affinity hits: 8/8" in out
    assert re.search(r"drained mid-decode: \[\d.*\] \(outputs "
                     r"bit-identical to an undisturbed run: True\)", out)
    assert "== act 4: training ends, the fleet regrows ==" in out


@pytest.mark.parametrize("name,lines", [
    ("tp_serving", ["psums/token: 4 (attn_out 2, mlp_out 2)",
                    "KV pool shard 1: ",
                    "greedy outputs identical across TP degrees: True"]),
    ("pipeline_parallel", ["pipeline mesh: {'pipe': 2}  microbatches=8",
                           "forward max |pipeline - sequential| = ",
                           "after 10 steps: loss="]),
])
def test_twin_on_two_gloo_ranks(launched, name, lines):
    out, err = launched[name].communicate(timeout=300)
    assert launched[name].returncode == 0, err[-3000:]
    for line in lines:
        assert line in out
    if name == "pipeline_parallel":
        err_fwd = float(re.search(r"sequential\| = (\S+)", out).group(1))
        first = float(re.search(r"^loss=(\S+)", out, re.M).group(1))
        final = float(re.search(r"steps: loss=(\S+)", out).group(1))
        assert err_fwd < 1e-5 and final < first
