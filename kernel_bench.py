"""Time the port's kernels on the card at the main path's shapes, for one
source tree, with ``chip_smoke.time_ms`` (median of 20 launches, L2
flushed before each, queued behind a sleep: device time only).

    python3 kernel_bench.py                  # this checkout's kernels
    python3 kernel_bench.py --src DIR        # another checkout's kernels,
                                             # e.g. a parent commit
                                             # unpacked with git archive
    python3 kernel_bench.py --sweep-splits   # the dense decode kernel at
                                             # several split lengths
    python3 kernel_bench.py --trace          # device time of each launch
                                             # inside one call, by kernel
    python3 kernel_bench.py --profile        # one traced decode chunk of
                                             # full-width stablelm-3b, dense
                                             # and paged (chip_smoke's
                                             # profile step)

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
#: (sequences, cache lines) of the decode cases, all lines live; each runs
#: on a dense cache and on a pool of 16-line pages
DECODE_SHAPES = ((4, 512), (1, 4096), (4, 4096))
PAGE = 16


def decode_shape(B: int, S: int) -> str:
    return f"q ({B},1,32,80) cache ({B},{S},32,80)"


def paged_shape(B: int, S: int) -> str:
    return (f"q ({B},1,32,80) pool ({B * S // PAGE + 1},{PAGE},32,80) "
            f"table {B}x{S // PAGE}")


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
        n_tab = S // PAGE
        kp, vp = (rand((B * n_tab + 1, PAGE, 32, 80)) for _ in range(2))
        table = (torch.randperm(B * n_tab, generator=gen, device="cuda")
                 + 1).reshape(B, n_tab).to(torch.int32)
        out.append(("flash_decode_paged", paged_shape(B, S),
                    lambda q=q, k=kp, v=vp, t=table, p=pos:
                    fd.flash_decode_paged_bshd(q, k, v, t, p)))
    for B in (2, 1):
        # the training shape (one microbatch of 2 x 2048 tokens) and one
        # sequence, x/Bm/Cm strided as ``ssm_train`` slices them
        u = rand((B, 2048, 48 * 64 + 2 * 128))
        x = u[..., :48 * 64].reshape(B, 2048, 48, 64)
        Bm, Cm = u[..., 48 * 64:48 * 64 + 128], u[..., 48 * 64 + 128:]
        dt = torch.rand((B, 2048, 48), generator=gen, device="cuda") \
            * 0.099 + 1e-3
        a = dt * -(torch.rand((48,), generator=gen, device="cuda") * 3.5
                   + 0.5)
        out.append(("ssd_scan", f"x ({B},2048,48,64) N 128 Q 256 strided",
                    lambda x=x, dt=dt, a=a, Bm=Bm, Cm=Cm: ssd.ssd_scan_bshp(
                        x, dt, a, Bm, Cm, 256)))
    try:        # a tree older than the attention backward has none
        from repro_torch.kernels import attention_bwd as ab
    except ImportError:
        return out
    # the train cells' shapes: stablelm-3b.train, one fsdp4 rank
    for B, S, H, Dh in ((4, 1024, 32, 80), (4, 2048, 16, 128)):
        q, k, v, do = (rand((B, S, H, Dh)) for _ in range(4))
        shape = f"q/k/v/dO ({B},{S},{H},{Dh}) causal"
        out.append(("attention_bwd", shape,
                    lambda q=q, k=k, v=v, do=do: ab.attention_bwd_bshd(
                        q, k, v, do)))
        ins = [t.transpose(1, 2).detach().requires_grad_(True)
               for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*ins, is_causal=True)
        out.append(("sdpa_bwd", shape,
                    lambda o=o, ins=ins, do=do.transpose(1, 2):
                    torch.autograd.grad(o, ins, do, retain_graph=True)))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", default=str(HERE),
                        help="checkout whose src/repro_torch is timed")
    parser.add_argument("--sweep-splits", action="store_true",
                        help="time the dense decode kernel at split "
                        "lengths 32-1024 instead")
    parser.add_argument("--trace", action="store_true",
                        help="instead, trace 10 calls of each case with "
                        "torch.profiler (L2 flushed before each) and print "
                        "each kernel's mean device time per call")
    parser.add_argument("--profile", action="store_true",
                        help="instead, trace one steady decode chunk of "
                        "full-width stablelm-3b (random weights), dense and "
                        "paged, and print the decode kernel's device time "
                        "per token step")
    parser.add_argument("--only", default=None,
                        help="time only the cases of this kernel (e.g. "
                        "ssd_scan, attention_bwd)")
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

    if opts.profile:
        from chip_smoke import SEED, profile_phase
        from repro_torch.configs import get_config
        from repro_torch.models import init_params
        from repro_torch.serving.engine import cast_for_compute

        cfg = get_config("stablelm-3b")
        params = cast_for_compute(init_params(cfg, SEED, "cuda"),
                                  torch.bfloat16)
        args = dict(slots=4, cache_len=512, decode_chunk=8)
        for paged in (False, True):
            r = profile_phase(cfg, params, args, paged)
            kind = "paged" if paged else "dense"
            step = f"decode chunk, {kind}, per token step"
            emit("flash_decode_paged" if paged else "flash_decode", step,
                 r["decode_ms_per_step"])
            emit("device_busy", step, r["busy_ms"] / args["decode_chunk"])
        return 0
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
        if opts.only and kernel != opts.only:
            continue
        if opts.trace:
            for name, ms in trace_ms(fn).items():
                emit(kernel, f"{shape} | {name}", ms)
        else:
            emit(kernel, shape, time_ms(fn))
    return 0


def trace_ms(fn, calls: int = 10) -> dict:
    """Mean device time per call of each kernel that ``fn`` launches, from
    a ``torch.profiler`` trace of ``calls`` calls, each behind an L2 flush
    (the flush's own kernel is left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    flushes = calls
    out: dict = {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.device_type != DeviceType.CUDA:
            continue
        if flushes and "fill" in e.name.lower():
            flushes -= 1
            continue
        name = e.name.replace("(anonymous namespace)", "").split("(")[0]
        name = name[-60:]
        out[name] = out.get(name, 0.0) + (e.time_range.end
                                          - e.time_range.start) / 1e3
    return {name: ms / calls for name, ms in out.items()}


if __name__ == "__main__":
    sys.exit(main())
