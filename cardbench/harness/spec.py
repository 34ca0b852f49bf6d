"""Resolve a cell of ``BENCHMARK.json`` to the files that define it.

Everything that belongs to one configuration, traffic mix, per-layer
metric or kernel lives in a file of its own, found by its name:

* ``configs/<config>.json``   the configuration as it is run
* ``families/<family>.py``    its family: leaves, port mapping, FLOPs
* ``reference/<family>.py``   its family's plain reference
* ``traffic/<traffic>.json``  the mix's parameters (read by ``mix.py``)
* ``limits/<workload>.json``  the limits of the numbers ``correct`` compares
* ``metrics/<metric>.py``     a reader: ``read(rec) -> float | None``
* ``roofline/<kernel>.py``    a kernel's name patterns and work count
* ``roofline/peaks.json``     the device's published peaks

A later cell, mix or metric is added by adding files and entries.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

#: the benchmark's folder (``cardbench/``)
HERE = Path(__file__).resolve().parents[1]
#: the checkout's root, where ``BENCHMARK.json`` lies
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple        # the metric entries this cell reports
    per_layer: tuple


def _applies(metric: dict, workload: str) -> bool:
    listed = metric.get("workloads")
    return listed is None or workload in listed


def resolve(workload: str, bench: dict | None = None) -> Cell:
    bench = benchmark() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"workload {workload!r} is not in BENCHMARK.json "
                       f"(it has {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell_from_files(workload, ROOT / configs[w["config"]]["file"],
                           w["traffic"], int(w["chips"]), bench)


def cell_from_files(workload: str, config_file: Path, traffic: str,
                    chips: int = 1, bench: dict | None = None) -> Cell:
    """A cell from its files; its metrics are the entries of
    ``BENCHMARK.json`` that list it (or list no cells)."""
    bench = benchmark() if bench is None else bench
    config = load_json(config_file)
    traffic = load_json(HERE / "traffic" / f"{traffic}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    e2e = tuple(m for m in bench["end_to_end"] if _applies(m, workload))
    # a per-layer metric without a `workloads` key is read in every cell
    # that reports the end-to-end metric it moves
    names = {m["name"] for m in e2e}
    per = tuple(m for m in bench["per_layer"]
                if _applies(m, workload) and m["moves"] in names)
    return Cell(workload, chips, config, traffic, limits, e2e, per)


def load_module(path: Path, name: str):
    """Import a file by its path (metric and kernel files carry dots in
    their names, so they are not importable by module name)."""
    spec = importlib.util.spec_from_file_location(
        "cardbench_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(config: dict):
    """The module of the configuration's family (``families/<family>.py``):
    ``check``, ``vocab``, ``port_kwargs``, ``leaves``, ``attention_heads``
    and the FLOP counts."""
    name = config["family"]
    return load_module(HERE / "families" / f"{name}.py", "family_" + name)


def reference(config: dict):
    """The plain reference of the configuration's family
    (``reference/<family>.py``)."""
    return importlib.import_module(f"reference.{config['family']}")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py", name).read


def kernel_work(kernel: str):
    """The module of one kernel's roofline: ``PATTERNS`` (substrings of
    its device kernels' names) and ``work(...) -> (flops, bytes)``."""
    return load_module(HERE / "roofline" / f"{kernel}.py", kernel)


def peaks() -> dict:
    return load_json(HERE / "roofline" / "peaks.json")
