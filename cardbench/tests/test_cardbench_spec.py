"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its files."""
import json
import re
from pathlib import Path

import pytest

from harness import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|proj|_dim$|_rank$|"
                    r"head|expand|experts_per_tok|top_k)")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "cardbench/run.py"]
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert (spec.ROOT / p).is_dir() and not p.endswith("_torch")
    assert 1 <= BENCH["run_seconds"] <= 51
    n = 24
    assert 338 * (BENCH["run_seconds"] + 60) + n * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and cfg["source"].startswith("https://")
    path = spec.ROOT / cfg["file"]
    assert path.is_file() and cfg["file"].startswith("cardbench/")
    data = json.loads(path.read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert not [k for k in cfg["reduced"] if WIDTHS.search(k)]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_is_mapped_by_its_family(cfg):
    data = json.loads((spec.ROOT / cfg["file"]).read_text())
    fam = spec.family(data)
    fam.check(data)
    assert (spec.HERE / "reference" / f"{data['family']}.py").is_file()
    assert callable(spec.reference(data).logits)
    assert fam.leaves(data) and fam.vocab(data) > 0


@pytest.mark.parametrize("change", [
    {"sliding_window": 4096},
    {"hidden_act": "gelu_pytorch_tanh"},
    {"use_qkv_bias": True},
    {"num_hidden_layers": None},
    {"hidden_act": None},
], ids=["unmapped_key", "other_activation", "biases", "missing_width",
        "unstated_activation"])
def test_a_file_the_family_does_not_map_is_refused(change):
    """A configuration whose keys the family cannot pass to the port (so
    the port and the reference would both run another model) is refused
    before anything is built."""
    data = json.loads((spec.HERE / "configs" / "stablelm-3b.json")
                      .read_text())
    data.update(change)
    data = {k: v for k, v in data.items() if v is not None}
    with pytest.raises(ValueError, match="family file of its own"):
        spec.family(data).port_kwargs(data)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    cell = spec.resolve(w["name"])
    assert cell.traffic["kind"] in ("serve", "train", "train_ranks")
    assert (spec.HERE / "harness" / f"{cell.traffic['kind']}.py").is_file()
    assert cell.limits["numbers"]
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names


def test_pairs_and_names_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_resolves(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    assert callable(spec.metric_reader(m["name"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if "roofline" in m["name"]:
            kernel = m["name"].split("_roofline")[0]
            assert spec.kernel_work(kernel).PATTERNS


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = (spec.ROOT / "PERF.md").read_text()
    for layer in layers:
        assert "\n" not in layer and layer in perf


def test_files_named_from_names():
    for path in spec.HERE.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(spec.ROOT).as_posix()
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
