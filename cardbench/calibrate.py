#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, on the card
at a cell's own size:

    python3 cardbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        --seconds <s> [--control] [--faults half,token] [--out FILE]

For each seed it runs the cell as ``run.py`` does (without the profiler)
and prints one JSON line a reading: ``program`` (the numbers the check
compares, from the timed path), ``control`` (the plain reference in the
next precision down, float8 e4m3 products, in the program's place) and
each planted fault (``token``: a served token altered where it is made;
``half``: the training step on half its rows; ``frozen``: a step that
returns its state unchanged).  ``run.py`` never runs these.
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
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path.insert(0, str(HERE))


def readings(cell, seed: int, seconds: float, control: bool, faults,
             device="cuda"):
    """Yield ``(what, numbers)`` for one seed."""
    from harness import bench
    from reference import common

    drv = bench.driver(cell)
    rec = drv.run(cell, seed, seconds, False, device)
    if cell.traffic["kind"] == "train":
        ref = drv.reference_run(rec, seed, device)
        yield "program", drv.judge(rec["program"], ref)
        if control:
            ctl = drv.reference_run(rec, seed, device, use=common.fp8)
            yield "control", drv.judge(ctl, ref)
    else:
        yield "program", drv.check(rec, seed, device, cell.limits)
        if control:
            yield "control", drv.check(rec, seed, device, cell.limits,
                                       use=common.fp8)
    del rec
    for fault in faults:
        rec = drv.run(cell, seed, seconds, False, device, fault)
        yield fault, drv.check(rec, seed, device, cell.limits)
        del rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch

    from harness import spec

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.resolve(args.workload)
    faults = [f for f in args.faults.split(",") if f]
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        for what, numbers in readings(cell, seed, args.seconds, args.control,
                                      faults):
            line = json.dumps({"workload": cell.name, "seed": seed,
                               "what": what, **numbers})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
