"""Time the port's kernels on the card at the main path's shapes, for one
source tree, with ``chip_smoke.time_ms`` (median of 20 launches, L2
flushed before each, queued behind a sleep: device time only).

    python3 kernel_bench.py                  # this checkout's kernels
    python3 kernel_bench.py --src DIR        # another checkout's kernels,
                                             # e.g. a parent commit
                                             # unpacked with git archive
    python3 kernel_bench.py --sweep-splits   # the dense decode kernel at
                                             # several split lengths

To compare two trees, run them in turns in one process tree on one card
(parent, change, change, parent).  Each tree builds its own kernels into
its own ``build/``.  Prints one JSON object a line: {"src", "kernel",
"shape", "ms"}; the card's name and power limit first.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

HERE = Path(__file__).resolve().parent
#: (sequences, cache lines) of the dense decode cases, all lines live
DECODE_SHAPES = ((4, 512), (1, 4096), (4, 4096))


def decode_shape(B: int, S: int) -> str:
    return f"q ({B},1,32,80) cache ({B},{S},32,80)"


def cases(fa, fd, ssd, gen):
    """(kernel, shape, call) at the shapes chip_smoke.py times."""
    bf16 = torch.bfloat16

    def rand(shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    out = []
    for L in (128, 512):
        q, k, v = (rand((1, L, 32, 80)) for _ in range(3))
        out.append(("flash_attention", f"(1,{L},32,80) causal",
                    lambda q=q, k=k, v=v: fa.flash_attention_bshd(q, k, v)))
        out.append(("sdpa", f"(1,{L},32,80) causal",
                    lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), is_causal=True)))
    for B, S in DECODE_SHAPES:
        q = rand((B, 1, 32, 80))
        k, v = (rand((B, S, 32, 80)) for _ in range(2))
        pos = torch.full((B,), S - 1, dtype=torch.int32, device="cuda")
        out.append(("flash_decode", decode_shape(B, S),
                    lambda q=q, k=k, v=v, p=pos: fd.flash_decode_bshd(
                        q, k, v, p)))
        out.append(("sdpa", decode_shape(B, S),
                    lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2))))
    q = rand((4, 1, 32, 80))
    kp, vp = (rand((129, 16, 32, 80)) for _ in range(2))
    table = (torch.randperm(128, generator=gen, device="cuda") + 1).reshape(
        4, 32).to(torch.int32)
    pos = torch.full((4,), 511, dtype=torch.int32, device="cuda")
    out.append(("flash_decode_paged", "q (4,1,32,80) pool (129,16,32,80)",
                lambda: fd.flash_decode_paged_bshd(q, kp, vp, table, pos)))
    x = rand((2, 2048, 48, 64))
    dt = torch.rand((2, 2048, 48), generator=gen, device="cuda") * 0.099 \
        + 1e-3
    a = dt * -(torch.rand((48,), generator=gen, device="cuda") * 3.5 + 0.5)
    Bm, Cm = (rand((2, 2048, 128)) for _ in range(2))
    out.append(("ssd_scan", "x (2,2048,48,64) N 128 Q 256",
                lambda: ssd.ssd_scan_bshp(x, dt, a, Bm, Cm, 256)))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", default=str(HERE),
                        help="checkout whose src/repro_torch is timed")
    parser.add_argument("--sweep-splits", action="store_true",
                        help="time the dense decode kernel at split "
                        "lengths 32-1024 instead")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: no CUDA device")
    src = Path(opts.src).resolve()
    sys.path.insert(0, str(src / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ssd_scan as ssd
    # after the kernels: chip_smoke puts this checkout's src first
    sys.path.insert(1, str(HERE))
    from chip_smoke import time_ms

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def emit(kernel, shape, ms):
        print(json.dumps({"src": str(src), "kernel": kernel, "shape": shape,
                          "ms": ms}), flush=True)

    if opts.sweep_splits:
        plan = fd.split_plan
        decode = [fn for kernel, _, fn in cases(fa, fd, ssd, gen)
                  if kernel == "flash_decode"]
        for (B, S), fn in zip(DECODE_SHAPES, decode):
            for chunk in (32, 64, 128, 256, 512, 1024):
                if chunk <= S:
                    fd.split_plan = (lambda s, b, k, sm, c=chunk:
                                     (c, -(-s // c)))
                    emit("flash_decode", f"{decode_shape(B, S)} split "
                         f"{chunk}", time_ms(fn))
            fd.split_plan = plan
            emit("flash_decode", f"{decode_shape(B, S)} planned "
                 f"{plan(S, B, 32, fd.sm_count(0))}", time_ms(fn))
        return 0
    for kernel, shape, fn in cases(fa, fd, ssd, gen):
        emit(kernel, shape, time_ms(fn))
    return 0


if __name__ == "__main__":
    sys.exit(main())
