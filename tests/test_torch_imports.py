"""The port stands alone: every module of ``repro_torch``, every example
twin of ``examples/torch`` and ``chip_smoke.py`` import in a fresh
interpreter whose import hook refuses ``jax`` and ``repro`` (the exact
top-level names), and ``triton``; no
kernel module builds or looks for ``nvcc`` at import, and no module
initialises a process group (the dry run's fake world among them).
Every module of the JAX package has a same-path twin.  The serve and
train CLIs run every model family on the CPU at reduced size, and the
serve CLI two replicas behind the router."""
import contextlib
import io
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, importlib.abc, json, pkgutil, sys

BLOCKED = {"jax", "jaxlib", "repro", "triton"}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
mods = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    mods.append(info.name)
sys.path.insert(0, sys.argv[1])
importlib.import_module("chip_smoke")
import importlib.util, pathlib
examples = []
for f in sorted((pathlib.Path(sys.argv[1]) / "examples" / "torch").glob(
        "*.py")):
    spec = importlib.util.spec_from_file_location("example_" + f.stem, f)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    examples.append(f.stem)
from repro_torch.kernels import build
import torch.distributed as dist
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps({"modules": mods, "leaked": leaked, "examples": examples,
                  "libs": len(build._libs),
                  "process_group": dist.is_initialized()}))
"""


def test_port_imports_without_jax_repro_or_triton(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    # no CUDA toolkit to be found: importing must not need one
    env["CUDA_HOME"] = str(tmp_path / "no-cuda")
    env["PATH"] = "/usr/bin:/bin"
    r = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                       capture_output=True, text=True, env=env,
                       cwd=tmp_path, timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    assert out["libs"] == 0                      # nothing built at import
    assert out["process_group"] is False         # the dry run's world too
    # every example twin imports under the same hook
    assert out["examples"] == sorted(
        p.stem for p in (ROOT / "examples" / "torch").glob("*.py"))
    assert len(out["examples"]) == 9
    want = {"repro_torch." + m.name for m in pkgutil.walk_packages(
        [str(ROOT / "src" / "repro_torch")])}
    for pkg in ("configs", "models", "kernels", "policy", "monitoring",
                "serving", "launch", "data", "optim", "training",
                "checkpoint", "cluster"):
        assert f"repro_torch.{pkg}" in out["modules"]
    assert want <= set(out["modules"])
    for mod in ("kernels.ssd_scan", "models.ssm", "models.inputs", "tree",
                "data.pipeline", "optim.adamw", "training.train_step",
                "training.trainer", "checkpoint.store", "launch.train",
                "configs.mamba2_780m", "monitoring.trace", "serving.prefix",
                "serving.spec", "cluster.meshbridge", "cluster.cli",
                "models.moe", "configs.minitron_4b",
                "configs.starcoder2_3b", "configs.repro_100m",
                "configs.qwen2_moe_a2_7b", "configs.dbrx_132b",
                "configs.jamba_1_5_large_398b", "configs.pixtral_12b",
                "configs.musicgen_large", "serving.router",
                "serving.autoscale", "core.parallelism", "core.sharding",
                "core.zero", "core.pipeline", "core.actshard",
                "launch.mesh", "training.train_step", "launch.dryrun",
                "launch.hlo", "serving.serve_step"):
        assert f"repro_torch.{mod}" in out["modules"]
    assert not (tmp_path / "build").exists()


def test_every_jax_module_has_a_twin():
    """Each module of the JAX package has a same-path counterpart in the
    port."""
    jax_root = ROOT / "src" / "repro"
    port_root = ROOT / "src" / "repro_torch"
    missing = [str(f.relative_to(jax_root))
               for f in sorted(jax_root.rglob("*.py"))
               if not (port_root / f.relative_to(jax_root)).is_file()]
    assert missing == []


def test_no_source_names_jax_or_repro():
    """A static check beside the runtime one: no import line of the port,
    of its example twins (``examples/torch``) or of chip_smoke.py names
    jax, repro or triton at module level."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += sorted((ROOT / "examples" / "torch").glob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = []
    for f in files:
        for n, line in enumerate(f.read_text().splitlines(), 1):
            s = line.strip()
            words = s.replace(",", " ").split()
            if s.startswith(("import ", "from ")) and len(words) > 1:
                top = words[1].split(".")[0]
                if top in ("jax", "jaxlib", "repro") or (
                        top == "triton" and not line.startswith(" ")):
                    bad.append(f"{f.relative_to(ROOT)}:{n}: {s}")
    assert bad == [], json.dumps(bad, indent=1)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-1.5-large-398b",
                                  "qwen2-moe-a2.7b"])
def test_serve_cli_runs_each_family(arch, one_thread):
    from repro_torch.launch import serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--requests", "3", "--max-new", "4",
                         "--cache-len", "64"])
    assert rc == 0
    # 3 of each request's 4 tokens come from decode calls
    assert "served 3 requests, 9 tokens" in out.getvalue()


def test_serve_cli_runs_replicas(one_thread):
    from repro_torch.launch import serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--reduced", "--device", "cpu", "--replicas", "2",
                         "--requests", "3", "--max-new", "4",
                         "--cache-len", "64"])
    assert rc == 0
    assert "served 3 requests on 2 replica(s), 9 tokens" in out.getvalue()
    assert "router: policy rr, 3 routed" in out.getvalue()


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "pixtral-12b",
                                  "musicgen-large"])
def test_train_cli_runs_moe_and_frontend(arch, one_thread):
    from repro_torch.launch import train
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--steps", "2", "--seq-len", "32", "--batch", "2"])
    text = out.getvalue()
    assert rc == 0
    assert "float32 AdamW state" in text and "step     2  loss" in text
    loss = float(text.split("step     2  loss ")[1].split()[0])
    assert 0 < loss < 10
