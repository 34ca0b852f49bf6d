"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either.  Top-level names are
compared whole: ``repro_torch`` begins with ``repro`` and is allowed
outside the reference."""
import ast

import pytest

from harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in spec.HERE.rglob("*.py")
               if "__pycache__" not in p.parts)


def top_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args and isinstance(
                    node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_names(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in FILES if p.parent.name == "reference"],
    ids=lambda p: p.name)
def test_reference_stands_alone(path):
    names = top_names(path)
    assert not names & (FORBIDDEN | {"repro_torch", "harness"})
    assert names <= {"__future__", "math", "torch", "reference", "numpy"}


def test_the_program_is_imported_in_one_place():
    users = [p.relative_to(spec.HERE).as_posix() for p in FILES
             if "repro_torch" in top_names(p)
             or "import_port" in p.read_text()
             and p.name != "port.py"]
    assert all(u.startswith(("harness/", "tests/")) for u in users), users


def test_names_compared_whole():
    from run import FORBIDDEN as RUNTIME, forbidden_modules

    assert set(RUNTIME) == FORBIDDEN
    assert forbidden_modules(["repro_torch", "repro_torch.serving",
                              "jaxlib.xla_client", "numpy"]) == ["jaxlib"]
    assert forbidden_modules(["repro.core", "flax"]) == ["flax", "repro"]
