#!/usr/bin/env python3
"""The load sweep that fixed an open-loop cell's rate, on the card:

    python3 cardbench/sweep.py --workload <name> --rates 4,6,8 \\
        --seconds <s> --seed <n>

For each offered rate it runs the cell with the mix's rate replaced (no
profiler, no check) and prints one JSON line: requests due, answered and
finished in the window, the tails of time to first token, the completed
tokens per second, and the backlog at the close (requests due and not yet
answered, by the half of the window they fell due in: a backlog that
grows in the second half means the rate is past what the system
sustains).  The benchmark's runs never sweep: the mix file holds the
rate this sweep chose.
"""
import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path.insert(0, str(HERE))


def summary(rec: dict, rate: float) -> dict:
    from harness.clock import percentile
    from harness.readers import due_in_window

    w = rec["window"]
    mid = (w["t0"] + w["close"]) / 2
    due = due_in_window(rec)
    t1 = w["t1"]
    ttft = [(r["first"] if r["first"] is not None else t1) - r["due"]
            for r in due]
    late = [r for r in due if r["first"] is None]
    done = [r for r in rec["requests"] if r["end"] is not None]
    tokens = sum(s["tokens"] for s in rec["steps"])
    return {"rate": rate, "due": len(due), "answered": len(due) - len(late),
            "finished": len(done),
            "ttft_p50_ms": 1e3 * percentile(ttft, 50),
            "ttft_p95_ms": 1e3 * percentile(ttft, 95),
            "tok_s": tokens / (t1 - w["t0"]),
            "backlog_first_half": sum(r["due"] < mid for r in late),
            "backlog_second_half": sum(r["due"] >= mid for r in late)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args()
    import torch

    from harness import bench, spec

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.resolve(args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        c = dataclasses.replace(cell, traffic=dict(cell.traffic, rate=rate))
        rec = bench.driver(c).run(c, args.seed, args.seconds, False, "cuda")
        print(json.dumps(summary(rec, rate)), flush=True)
        del rec
    return 0


if __name__ == "__main__":
    sys.exit(main())
