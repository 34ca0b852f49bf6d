#!/usr/bin/env python3
"""One run of one cell of the port's benchmark:

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds the port (``src/repro_torch``), on
a machine with as many CUDA cards as the cell asks for.  It draws the
cell's weights and traffic from the seed, warms up every shape the
traffic uses (set-up), measures for ``--seconds``, checks what the timed
path produced against the plain reference, and prints one JSON line last
on standard output: the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1`` (read from a short profiled
sub-window).  Without a card, or with fewer than the cell needs, it exits
with 2 and prints no result; it never falls back to the CPU.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# caches at fixed paths inside the checkout, before anything is imported:
# only the first run of a cell in a checkout builds (nvcc's libraries go to
# build/kernels, as the port's kernels/build.py puts them)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(HERE))

#: top-level module names that must not be loaded when the result prints
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among loaded modules (``names``:
    module names to look at instead of ``sys.modules``), each compared
    whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names
                   if n.split(".")[0] in FORBIDDEN})


def fail(msg: str, code: int = 1):
    print(f"cardbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from harness import bench, spec

    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} CUDA card(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             " visible", 2)
    result, checks = bench.run_cell(cell, args.seed, args.seconds,
                                    bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        fail(f"the process holds {found} after the window: nothing the "
             "benchmark runs may load JAX or the JAX package")
    for line in bench.check_lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
