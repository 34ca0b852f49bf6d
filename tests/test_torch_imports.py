"""The port stands alone: every module of ``repro_torch`` and
``chip_smoke.py`` imports in a fresh interpreter whose import hook refuses
``jax`` and ``repro`` (the exact top-level names), and ``triton``; no
kernel module builds or looks for ``nvcc`` at import."""
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

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
from repro_torch.kernels import build
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps({"modules": mods, "leaked": leaked,
                  "libs": len(build._libs)}))
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
    want = {"repro_torch." + m.name for m in pkgutil.walk_packages(
        [str(ROOT / "src" / "repro_torch")])}
    for pkg in ("configs", "models", "kernels", "policy", "monitoring",
                "serving", "launch", "data", "optim", "training",
                "checkpoint"):
        assert f"repro_torch.{pkg}" in out["modules"]
    assert want <= set(out["modules"])
    for mod in ("kernels.ssd_scan", "models.ssm", "models.inputs", "tree",
                "data.pipeline", "optim.adamw", "training.train_step",
                "training.trainer", "checkpoint.store", "launch.train",
                "configs.mamba2_780m"):
        assert f"repro_torch.{mod}" in out["modules"]
    assert not (tmp_path / "build").exists()


def test_no_source_names_jax_or_repro():
    """A static check beside the runtime one: no import line of the port
    or of chip_smoke.py names jax, repro or triton at module level."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
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
