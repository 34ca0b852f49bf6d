"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only   # build, check and time every
                                           # kernel, then stop

Needs one CUDA card and the CUDA toolkit.  Phases, each fatal on failure:

1. device  — refuse to run without ``torch.cuda.is_available()``; print the
   card's name and power limit (``nvidia-smi``).
2. build   — compile the hand-written kernels from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` per source, in parallel).
3. kernels — hold each kernel against its plain PyTorch version on the
   card, at the serving path's shapes (full-width stablelm-3b), a GQA
   shape at qwen2-7b widths, a ring-window case and a paged case with
   null pages, in bf16 and f32; the SSD scan at the training path's
   shape (full-width mamba2-780m), the JAX package's ``SSD_CASES``, a
   chunk that ``_pick_block`` shrinks and a chunk whose decays span the
   f32 range, on inputs strided as the training path gives them, against
   its chunked plain version and the token-by-token oracle; time kernel,
   plain version and one
   library call (a yardstick the port never calls) with CUDA events,
   the L2 cache flushed before every launch and the timed launches
   queued behind a sleep kernel, so that each reading is device time.
   Then the gradients of the two kernels that training differentiates
   (``ops.flash_attention``, ``ops.ssd_scan``) against plain autograd.
4. serve   — full-width stablelm-3b (random weights from a seed, bf16
   compute) through ``DecodeEngine``: a warm-up run, then the dense cache,
   then pages of 16 lines; fail if a kernel of the path never launched or
   a request came back short.  Then a ``torch.profiler`` trace of one
   steady decode chunk, dense and paged: its wall time against the
   device's busy time, and the decode kernel's device time per token
   step.
5. consistency — one request's prefill logits and first decode steps
   through the kernels against the plain versions, at full width.
6. train   — full-width mamba2-780m (f32 weights from a seed, bf16
   compute, f32 AdamW state, layer recomputation) through ``Trainer``:
   2 x 2048-token microbatches a step, one warm-up step, then 4 steps;
   fail on a non-finite loss, a first loss far from ln(vocab), or an
   ``ssd_scan`` launch count other than the run implies.
7. train consistency — loss and gradients of one full-width microbatch
   through the kernels and the plain versions, in f32 (held close) and in
   bf16 (held to the f32 run), with the bf16 gap's parameters listed.
8. summary — the kernels line, then the device line last.

Exits non-zero on any failure, and when no card is present.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16
# and f32 (non-tensor-core) flop/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# the training consistency check in f32: the kernel and plain routes sum
# the same terms in another order (f32 rounding, ~1e-7 relative a step)
F32_LOSS_TOL, F32_GRAD_TOL = 1e-4, 1e-3
SEED = 0


def log(*parts):
    print(*parts, flush=True)


# ----------------------------------------------------------------- timing ----

_CYCLES_PER_MS: list = []


def _cycles_per_ms() -> float:
    """The card's clock as ``torch.cuda._sleep`` counts it, measured once."""
    if not _CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        torch.cuda.synchronize()
        _CYCLES_PER_MS.append(10_000_000 / start.elapsed_time(end))
    return _CYCLES_PER_MS[0]


def time_ms(fn, iters: int = 20) -> float:
    """Median device time of one call, with the L2 cache (50 MB) flushed
    before every call: on the serving path each layer's attention finds
    its KV lines cold, behind the other layers' weights.

    Each (flush, start, call, end) group is enqueued behind a sleep kernel
    that keeps the device busy until the host has enqueued the whole
    group, so the group runs back to back and its event pair holds device
    time only; a group whose sleep ended before it was all queued is timed
    again behind a longer sleep.  One group at a time: a plain version of
    many small launches would fill the device's launch queue if all were
    queued at once."""
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_ms = 0.2 + 2.0 * host_ms
    times = []
    while len(times) < iters:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        slept = torch.cuda.Event()
        torch.cuda._sleep(int(sleep_ms * _cycles_per_ms()))
        slept.record()
        flush.zero_()
        start.record()
        fn()
        end.record()
        late = slept.query()
        torch.cuda.synchronize()
        if late:
            sleep_ms *= 2
            if sleep_ms > 1e4:
                raise AssertionError("time_ms: the host did not enqueue "
                                     "one call within a 10 s sleep")
            continue
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ------------------------------------------------------------ kernels ----

def rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def check(name, got, want, dtype, what, relative=False):
    """max |got - want| against TOL[dtype]; with ``relative`` each element
    may differ by TOL * (1 + |want|) (one rounding of a value of magnitude
    |want| in the working dtype)."""
    err = max_err(got, want)
    tol = TOL[dtype]
    if relative:
        excess = float(((got.float() - want.float()).abs()
                        - tol * want.float().abs()).max())
        ok = math.isfinite(err) and excess <= tol
        tol_s = f"{tol:g} + {tol:g}|ref|"
    else:
        ok = math.isfinite(err) and err <= tol
        tol_s = f"{tol:g}"
    log(f"  {name:<19} {what:<46} max|err| {err:.3e} (tol {tol_s}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{what}: {err} > {tol}")
    return err


def kernel_phase(shape_cfg) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    H, K, Dh = shape_cfg["H"], shape_cfg["K"], shape_cfg["Dh"]
    slots, cache_len, L = (shape_cfg["slots"], shape_cfg["cache_len"],
                           shape_cfg["prefill_len"])
    bf16, f32 = torch.bfloat16, torch.float32
    out = {}

    # ---- flash_attention: prefill of one sequence ------------------------
    errs = []
    cases = [(1, n, H, K, Dh, None, bf16) for n in (32, 64, 128, cache_len)]
    cases += [(1, 100, H, K, Dh, None, f32),          # ragged S
              (2, 96, 28, 4, 128, None, bf16),        # qwen2-7b GQA
              (1, 256, 28, 4, 128, 64, f32),          # sliding window
              # bf16 on tensor cores: S = 1, S ragged against 16 and the
              # q tile, a head padded to 80 (72), windows, B = 2
              (1, 1, H, K, Dh, None, bf16),
              (1, 77, H, K, Dh, None, bf16),
              (2, 200, 28, 4, 128, None, bf16),
              (1, 150, 8, 2, 72, None, bf16),
              (2, 300, 16, 4, 64, 100, bf16),
              (1, 1000, H, K, Dh, 256, bf16)]
    for B, S, h, k, d, window, dt in cases:
        q, kk, v = (rand(gen, (B, S, n, d), dt) for n in (h, k, k))
        got = fa.flash_attention_bshd(q, kk, v, window=window)
        err = check("flash_attention", got, ref.attention_ref(q, kk, v,
                                                              window),
                    dt, f"q({B},{S},{h},{d}) kv {k} heads w={window} "
                    f"{str(dt)[6:]}")
        if dt == bf16 and h == H:
            errs.append(err)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True)

    q, kk, v = (rand(gen, (1, L, n, Dh), bf16) for n in (H, K, K))
    ms = time_ms(lambda: fa.flash_attention_bshd(q, kk, v))
    plain = time_ms(lambda: ref.attention_ref(q, kk, v))
    lib = time_ms(lambda: sdpa(q, kk, v))
    nbytes = 2 * (2 * L * H * Dh + 2 * L * K * Dh)          # q, o, k, v
    flops = 4 * Dh * H * L * (L + 1) / 2                    # causal QK + PV
    b, by = bound_ms(nbytes, flops, bf16)
    out["flash_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:94",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b,
        bound_by=by, library_ms=lib,
        shape=f"q/k/v (1,{L},{H},{Dh}) bf16 causal")
    # the largest bucket of the serving path, for the record
    q2, k2, v2 = (rand(gen, (1, cache_len, n, Dh), bf16) for n in (H, K, K))
    n = cache_len
    b_n, by_n = bound_ms(2 * (2 * n * H * Dh + 2 * n * K * Dh),
                         4 * Dh * H * n * (n + 1) / 2, bf16)
    log(f"  flash_attention at L={n}: "
        f"{time_ms(lambda: fa.flash_attention_bshd(q2, k2, v2)):.4f} ms, "
        f"SDPA {time_ms(lambda: sdpa(q2, k2, v2)):.4f} ms (bound "
        f"{b_n:.4f} ms, {by_n})")

    # ---- flash_decode: dense cache (and the ring) ------------------------
    errs = []
    chunk, n_splits = fd.split_plan(cache_len, slots, K,
                                    fd.sm_count(torch.cuda.current_device()))
    log(f"  flash_decode split plan at ({slots}, {cache_len}) x {K} kv "
        f"heads: {n_splits} splits of {chunk} lines, "
        f"{n_splits * slots * K} blocks")
    positions = torch.tensor([cache_len - 1, 300, 17, 0][:slots] +
                             [cache_len // 2] * max(0, slots - 4),
                             dtype=torch.int32, device="cuda")
    # live lengths ending on, just before and just after a split boundary,
    # and one line: differing by more than a split
    edges = torch.tensor(([chunk, chunk - 1, chunk + 1, 1] * slots)[:slots],
                         dtype=torch.int32, device="cuda") - 1

    def ints(*xs):
        return torch.tensor(xs, dtype=torch.int32, device="cuda")

    dcases = [(slots, cache_len, H, K, Dh, None, bf16, bf16, positions),
              (slots, cache_len, H, K, Dh, None, f32, f32, positions),
              (slots, cache_len, H, K, Dh, None, f32, bf16, positions),
              (slots, cache_len, H, K, Dh, None, bf16, bf16, edges),
              (slots, cache_len, H, K, Dh, None, f32, f32, edges),
              (slots, cache_len, H, K, Dh, None, f32, bf16, edges),
              (3, 256, 28, 4, 128, None, bf16, bf16, ints(255, 3, 128)),
              (3, 64, H, K, Dh, 64, bf16, bf16, ints(200, 63, 5)),  # ring
              (2, 48, 28, 4, 128, 64, f32, f32, ints(150, 20)),  # w > slots
              (2, 300, 4, 2, 20, None, bf16, bf16, ints(299, 150)),  # tails
              (2, 300, 6, 3, 6, None, f32, f32, ints(299, 40)),
              (1, 4096, H, K, Dh, None, bf16, bf16, ints(4095)),
              (4, 4096, H, K, Dh, None, bf16, bf16, ints(4095, 2000, 63, 0))]
    for B, S, h, k, d, window, qdt, kvdt, pos in dcases:
        q = rand(gen, (B, 1, h, d), qdt)
        # a head_dim that does not fill 16 bytes sits in a padded line, so
        # the cache's strides stay 16-byte multiples
        width = -(-d * kvdt.itemsize // 16) * 16 // kvdt.itemsize
        kc, vc = (rand(gen, (B, S, k, width), kvdt)[..., :d]
                  for _ in range(2))
        got = fd.flash_decode_bshd(q, kc, vc, pos, window=window)
        want = ref.decode_attention_ref(q, kc, vc, pos, window=window)
        err = check("flash_decode", got, want, qdt,
                    f"q({B},1,{h},{d}) cache {S}x{k} w={window} "
                    f"{str(qdt)[6:]}/{str(kvdt)[6:]} pos "
                    f"{pos.tolist()[:4]}")
        if qdt == bf16 and h == H and window is None and S == cache_len:
            errs.append(err)

    def decode_bytes(B, S):
        return 2 * (B * S * 2 * K * Dh + 2 * B * H * Dh) + 4 * B

    full = torch.full((slots,), cache_len - 1, dtype=torch.int32,
                      device="cuda")
    q = rand(gen, (slots, 1, H, Dh), bf16)
    kc, vc = (rand(gen, (slots, cache_len, K, Dh), bf16) for _ in range(2))
    ms = time_ms(lambda: fd.flash_decode_bshd(q, kc, vc, full))
    plain = time_ms(lambda: ref.decode_attention_ref(q, kc, vc, full))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)))
    lines = slots * cache_len
    nbytes = decode_bytes(slots, cache_len)
    flops = 4 * H * Dh * lines
    b, by = bound_ms(nbytes, flops, bf16)
    out["flash_decode"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode.py:97",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b,
        bound_by=by, library_ms=lib,
        shape=f"q ({slots},1,{H},{Dh}), cache ({slots},{cache_len},{K},{Dh})"
              f" bf16, all {cache_len} lines live")
    # a long cache, for the record
    for B4 in (1, slots):
        q4 = rand(gen, (B4, 1, H, Dh), bf16)
        k4, v4 = (rand(gen, (B4, 4096, K, Dh), bf16) for _ in range(2))
        p4 = torch.full((B4,), 4095, dtype=torch.int32, device="cuda")
        b4, by4 = bound_ms(decode_bytes(B4, 4096), 4 * H * Dh * B4 * 4096,
                           bf16)
        t4 = time_ms(lambda: fd.flash_decode_bshd(q4, k4, v4, p4))
        lib4 = time_ms(lambda: F.scaled_dot_product_attention(
            q4.transpose(1, 2), k4.transpose(1, 2), v4.transpose(1, 2)))
        log(f"  flash_decode at ({B4},4096): {t4:.4f} ms, SDPA {lib4:.4f} "
            f"ms (bound {b4:.4f} ms, {by4})")

    # ---- flash_decode_paged ----------------------------------------------
    errs = []
    ps = 16
    n_tab = cache_len // ps
    num_pages = slots * n_tab + 1
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    table_full = perm[:slots * n_tab].reshape(slots, n_tab).to(torch.int32)
    # live pages per row up to pos, null pages (0) past them
    table_null = table_full.clone()
    for i, p in enumerate(positions.tolist()):
        table_null[i, p // ps + 1:] = 0
    pcases = [(H, K, Dh, bf16, bf16, table_null, positions),
              (H, K, Dh, f32, f32, table_null, positions),
              (H, K, Dh, f32, bf16, table_full, positions),
              (28, 4, 128, bf16, bf16, table_null, positions)]
    for h, k, d, qdt, kvdt, table, pos in pcases:
        q = rand(gen, (slots, 1, h, d), qdt)
        kp, vp = (rand(gen, (num_pages, ps, k, d), kvdt) for _ in range(2))
        got = fd.flash_decode_paged_bshd(q, kp, vp, table, pos)
        want = ref.paged_decode_attention_ref(q, kp, vp, table, pos)
        nulls = int((table == 0).sum())
        err = check("flash_decode_paged", got, want, qdt,
                    f"q({slots},1,{h},{d}) pool {num_pages}x{ps}x{k} "
                    f"{nulls} null {str(qdt)[6:]}/{str(kvdt)[6:]}")
        if qdt == bf16 and h == H:
            errs.append(err)
    q = rand(gen, (slots, 1, H, Dh), bf16)
    kp, vp = (rand(gen, (num_pages, ps, K, Dh), bf16) for _ in range(2))
    ms = time_ms(lambda: fd.flash_decode_paged_bshd(q, kp, vp, table_full,
                                                    full))
    chunk_p, n_p = fd.split_plan(n_tab * ps, slots, K,
                                 fd.sm_count(torch.cuda.current_device()))
    log(f"  flash_decode_paged: {n_p} splits of {chunk_p} lines; {ms:.4f} ms "
        f"= {ms / out['flash_decode']['ms']:.2f}x the dense kernel at the "
        "same shape")
    plain = time_ms(lambda: ref.paged_decode_attention_ref(q, kp, vp,
                                                           table_full, full))
    nbytes = (2 * (lines * 2 * K * Dh + 2 * slots * H * Dh) + 4 * slots
              + 4 * slots * n_tab)
    b, by = bound_ms(nbytes, flops, bf16)
    out["flash_decode_paged"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode.py:200",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b,
        bound_by=by, library_ms=None,
        shape=f"q ({slots},1,{H},{Dh}), pool ({num_pages},{ps},{K},{Dh}) "
              f"bf16, table {slots}x{n_tab}, all {cache_len} lines live")
    for name, r in out.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {name:<19} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return out


def ssd_kernel_phase(cfg, batch: int, seq_len: int) -> dict:
    """The SSD scan against its chunked plain version and the token-by-token
    oracle, in bf16 and f32, at the training shape of ``cfg``, the JAX
    package's ``SSD_CASES`` (``tests/test_kernels.py``) and a chunk that
    ``_pick_block`` shrinks, on inputs strided as on the training path;
    then its time at the training shape."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ssd

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    ssm = cfg.ssm
    H, P, N = ssm.num_heads(cfg.d_model), ssm.head_dim, ssm.state
    bf16, f32 = torch.bfloat16, torch.float32

    def inputs(B, S, h, p, n, dtype, fixed=None):
        # x, Bm and Cm as ``ssm_train`` hands them over: slices of one
        # (B, S, h*p + 2n) conv output, so x's S stride is h*p + 2n
        u = rand(gen, (B, S, h * p + 2 * n), dtype)
        x = u[..., :h * p].reshape(B, S, h, p)
        Bm, Cm = u[..., h * p:h * p + n], u[..., h * p + n:]
        dt = torch.rand((B, S, h), generator=gen, device="cuda") * 0.099 \
            + 1e-3
        A = -(torch.rand((h,), generator=gen, device="cuda") * 3.5 + 0.5)
        if fixed is not None:             # (A, dt) for every head and token
            A = torch.full_like(A, fixed[0])
            dt = torch.full_like(dt, fixed[1])
        return x, dt, A, dt * A, Bm, Cm

    log(f"  ssd_scan: {ssd.KERNEL_LAUNCHES} kernel launches per call")
    errs = []
    cases = [(batch, seq_len, H, P, N, ssm.chunk, None),  # the training shape
             (2, 128, 4, 32, 16, 32, None), (1, 256, 2, 64, 32, 64, None),
             (2, 64, 1, 16, 8, 64, None),
             (1, 96, 3, 32, 128, 32, None),                # SSD_CASES
             (1, 96, 2, 64, 128, 64, None),                # chunk 64 -> 48
             # decays spanning the f32 range: cs reaches -102 in a chunk,
             # so the hi + lo terms carry factors from 1 down to ~1e-44
             (1, 512, 4, P, N, ssm.chunk, (-4.0, 0.1))]
    for B, S, h, p, n, chunk, fixed in cases:
        Q = ops._pick_block(S, chunk)
        for dt_ in (bf16, f32):
            x, dt, A, a, Bm, Cm = inputs(B, S, h, p, n, dt_, fixed)
            got = ssd.ssd_scan_bshp(x, dt, a, Bm, Cm, Q)
            what = (f"x({B},{S},{h},{p}) N {n} Q {Q} {str(dt_)[6:]}"
                    + (f" A {fixed[0]:g} dt {fixed[1]:g}" if fixed else ""))
            err = check("ssd_scan", got, ref.ssd_scan_ref(x, dt, a, Bm, Cm, Q),
                        dt_, what + " vs chunked", relative=True)
            check("ssd_scan", got, ref.ssd_ref(x, dt, A, Bm, Cm), dt_,
                  what + " vs oracle", relative=True)
            if dt_ == bf16 and (B, S) == (batch, seq_len):
                errs.append(err)
    x, dt, A, a, Bm, Cm = inputs(batch, seq_len, H, P, N, bf16)
    Q = ops._pick_block(seq_len, ssm.chunk)
    ms = time_ms(lambda: ssd.ssd_scan_bshp(x, dt, a, Bm, Cm, Q))
    plain = time_ms(lambda: ref.ssd_scan_ref(x, dt, a, Bm, Cm, Q))
    tokens = batch * seq_len
    # each input of the function read once, y written once: x, y, Bm, Cm
    # bf16; dt (B, S, H) and A (H,) f32 (a = dt * A is derived from them)
    nbytes = 2 * 2 * tokens * H * P + 4 * tokens * H + 4 * H \
        + 2 * 2 * tokens * N
    # per chunk, over its causal pairs k <= q: C B^T once (every head shares
    # it), then per head its product with x dt, and the two products with
    # the state (its term in y, its update)
    pairs = Q * (Q + 1) // 2
    flops = batch * (seq_len // Q) * (
        2 * pairs * N + H * (2 * pairs * P + 4 * Q * N * P))
    b, by = bound_ms(nbytes, flops, bf16)
    r = dict(route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:80",
             max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b,
             bound_by=by, library_ms=None,
             shape=f"x ({batch},{seq_len},{H},{P}), N {N}, Q {Q} bf16 "
                   f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    log(f"  {'ssd_scan':<19} {r['shape']}: kernel {ms:.4f} ms "
        f"({ssd.KERNEL_LAUNCHES} launches), plain {plain:.4f} ms "
        f"({plain / ms:.1f}x the kernel), library n/a ms, bound {b:.4f} ms "
        f"({by})")
    return {"ssd_scan": r}


def grad_phase():
    """Gradients through the two kernels training differentiates: the
    autograd functions of ``kernels.ops`` (kernel forward, plain recompute
    in the backward) against plain autograd, f32, small shapes."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    f32 = torch.float32

    def grads(fn, ins, w):
        ins = [t.detach().clone().requires_grad_(True) for t in ins]
        out = fn(*ins)
        return torch.autograd.grad((out.float() * w).sum(), ins)

    x = rand(gen, (2, 192, 4, 32), f32)
    dt = torch.rand((2, 192, 4), generator=gen, device="cuda") * 0.099 + 1e-3
    A = -(torch.rand((4,), generator=gen, device="cuda") * 3.5 + 0.5)
    Bm, Cm = (rand(gen, (2, 192, 16), f32) for _ in range(2))
    w = rand(gen, x.shape, f32)
    got = grads(lambda *t: ops.ssd_scan(*t, chunk=64), (x, dt, A, Bm, Cm), w)
    want = grads(lambda x_, dt_, A_, B_, C_: ref.ssd_scan_ref(
        x_, dt_, dt_ * A_, B_, C_, 64), (x, dt, A, Bm, Cm), w)
    for name, g, r in zip(("x", "dt", "A", "Bm", "Cm"), got, want):
        check("ssd_scan grad", g, r, f32, f"d{name} at x(2,192,4,32) N 16 "
              "Q 64", relative=True)
    q, k, v = (rand(gen, (1, 96, n, 64), f32) for n in (8, 2, 2))
    w = rand(gen, q.shape, f32)
    for window in (None, 32):
        got = grads(lambda *t: ops.flash_attention(*t, window=window),
                    (q, k, v), w)
        want = grads(lambda *t: ref.attention_ref(*t, window=window),
                     (q, k, v), w)
        for name, g, r in zip("qkv", got, want):
            check("flash_attn grad", g, r, f32,
                  f"d{name} at q(1,96,8,64) kv 2 heads w={window}",
                  relative=True)


# -------------------------------------------------------------- serving ----

def serve_phase(cfg, params, paged: bool, args, device="cuda",
                label=None) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.monitoring import MetricsRegistry
    from repro_torch.serving import DecodeEngine, Request

    rng = np.random.default_rng(SEED)
    requests = []
    for rid in range(args["requests"]):
        plen = int(rng.integers(4, args["cache_len"] // 4))
        prompt = rng.integers(2, cfg.vocab_size, plen).astype(np.int32)
        requests.append(Request(rid=rid, prompt=prompt,
                                max_new_tokens=args["max_new"],
                                temperature=float(rid % 2) * 0.8))
    metrics = MetricsRegistry()
    engine = DecodeEngine(cfg, params, num_slots=args["slots"],
                          cache_len=args["cache_len"], metrics=metrics,
                          seed=SEED, decode_chunk=args["decode_chunk"],
                          prefill_buckets="auto",
                          kv_page_size=16 if paged else 0, device=device)
    for r in requests:
        engine.submit(r)
    sync(device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    engine.run_to_completion()
    sync(device)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    total = int(metrics.counter("serve_tokens_generated").value())
    want = sum(r.max_new_tokens - 1 for r in requests)
    kind = label or ("paged (16-line pages)" if paged else "dense")
    pre = metrics.histogram("serve_prefill_seconds")
    dec = metrics.histogram("serve_decode_seconds")
    # means are exact (histogram sum / count); p50s are interpolated inside
    # the histogram's decade-wide buckets
    log(f"  {kind}: {len(requests)} requests, {total} decode tokens in "
        f"{wall:.3f} s = {total / wall:.1f} tok/s; prefill mean "
        f"{pre.sum() / pre.count() * 1e3:.2f} ms (p50 "
        f"{pre.quantile(0.5) * 1e3:.2f}, bucket-interpolated) over "
        f"{pre.count()}; decode chunk ({args['decode_chunk']} tokens/slot) "
        f"mean {dec.sum() / dec.count() * 1e3:.2f} ms (p50 "
        f"{dec.quantile(0.5) * 1e3:.2f}, bucket-interpolated) over "
        f"{dec.count()}; buckets used {sorted(engine.prefill_lengths)}; "
        f"launches {launches}")
    if not all(r.done and len(r.output) == r.max_new_tokens
               for r in requests) or total != want:
        raise AssertionError(f"{kind}: expected {want} decode tokens and "
                             f"{args['max_new']} per request, got {total}")
    for r in requests:
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"{kind}: token out of vocabulary")
    used = ["flash_attention", "flash_decode_paged" if paged
            else "flash_decode"]
    for name in used:
        if launches[name] == 0 and device == "cuda":
            raise AssertionError(f"{kind}: kernel {name} never launched on "
                                 "the serving path")
    return {"launches": launches, "tok_s": total / wall, "wall_s": wall}


def profile_phase(cfg, params, args, paged: bool,
                  device="cuda") -> dict:
    """Where one steady decode chunk of the engine (dense cache, or pages
    of 16 lines) spends its time: a ``torch.profiler`` trace of one
    ``engine.step()`` (every slot live, nothing to admit), its wall time on
    the host clock (ending in a synchronize) against the union of the
    device's kernel intervals, and the decode kernel's device time per
    token step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import DecodeEngine, Request

    rng = np.random.default_rng(SEED + 2)
    chunk = args["decode_chunk"]
    engine = DecodeEngine(cfg, params, num_slots=args["slots"],
                          cache_len=args["cache_len"], seed=SEED,
                          decode_chunk=chunk, prefill_buckets="auto",
                          kv_page_size=16 if paged else 0, device=device)
    kind = "paged" if paged else "dense"
    kernel = "flash_decode_paged" if paged else "flash_decode"
    for rid in range(args["slots"]):
        engine.submit(Request(
            rid=rid, prompt=rng.integers(2, cfg.vocab_size, 100).astype(
                np.int32), max_new_tokens=4 * chunk))
    engine.step()                          # prefill every slot + a chunk
    engine.step()                          # warm
    sync(device)
    # device activity only on the card: recording every host op as well
    # slows the traced chunk and the processing of the trace
    activities = [ProfilerActivity.CUDA if device == "cuda"
                  else ProfilerActivity.CPU]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        engine.step()
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    by_name: dict = {}
    for s, e, name in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    busy_ms = busy_us / 1e3
    device_part = (
        f"device busy {busy_ms:.2f} ms ({busy_ms / wall_ms:.1%}), "
        f"{len(spans)} device kernels ({len(spans) / chunk:.0f} per token "
        "step)" if spans else
        "device time not measured (the trace holds no device events)")
    log(f"  profile: one {kind} decode chunk ({chunk} tokens x "
        f"{args['slots']} slots, ~{int(engine.pos.mean())} live lines): wall "
        f"{wall_ms:.2f} ms, {device_part}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
        log(f"    {us / 1e3:8.3f} ms  {name[:100]}")
    # one engine uses one of the two decode launches: every decode kernel
    # in this trace is `kernel`
    decode = [(n, us) for n, us in by_name.items() if "decode_kernel" in n]
    step_ms = None
    if spans:
        us = sum(us for _, us in decode)
        n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                and "decode_kernel" in e.name)
        step_ms = us / 1e3 / chunk
        log(f"  {kernel} in the trace: {n} launches, {us / 1e3:.3f} ms = "
            f"{step_ms:.3f} ms of device time per token step; device busy "
            f"{busy_ms / chunk:.3f} ms per token step")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "kernels": len(spans),
            "decode_ms_per_step": step_ms}


def consistency_phase(cfg, params, device="cuda") -> dict:
    """Prefill logits and three decode steps of one request through the
    kernels against the plain versions, both in bf16, with an f32 run of
    the same (bf16-valued) weights as the yardstick.  The kernel route
    must stay within 0.05 + 2x the plain route's own distance from the
    f32 run."""
    from repro_torch.configs import RunConfig
    from repro_torch.models.model import decode_step, init_cache, prefill
    from repro_torch.serving.engine import cast_for_compute

    rng = np.random.default_rng(SEED + 1)
    P, steps = 77, 3
    toks = torch.from_numpy(rng.integers(2, cfg.vocab_size, P).astype(
        np.int32)).to(device)[None]
    f32cfg = dataclasses.replace(cfg, dtype="float32")
    runs = {}
    with torch.no_grad():
        for name, c, p, use_k in (
                ("kernels", cfg, params, True),
                ("plain", cfg, params, False),
                ("f32", f32cfg, cast_for_compute(params, torch.float32),
                 False)):
            run = RunConfig(use_kernels=use_k)
            logits, c1 = prefill(p, {"tokens": toks}, c, run, cache_len=256)
            cache = init_cache(c, 1, 256, device=device)
            for dst, src in zip(cache["layers"], c1["layers"]):
                for kv in ("k", "v"):
                    dst[kv][:, 0, :P].copy_(src[kv][:, 0])
            seq = [logits[0, -1].float()]
            tok = toks[:, -1:]
            for s in range(steps):
                # teacher-forced: every route feeds the same tokens
                tok = torch.full((1, 1), 11 + 7 * s, dtype=torch.int32,
                                 device=device)
                lg, cache = decode_step(p, cache, tok,
                                        torch.tensor([P + s], device=device),
                                        c, run)
                seq.append(lg[0, -1].float())
            runs[name] = torch.stack(seq)
            del p
    for name, r in runs.items():
        if not bool(torch.isfinite(r).all()) or r.shape != (
                steps + 1, cfg.vocab_size):
            raise AssertionError(f"consistency: {name} logits not finite "
                                 f"or of shape {tuple(r.shape)}")
    d_kp = max_err(runs["kernels"], runs["plain"])
    d_k32 = max_err(runs["kernels"], runs["f32"])
    d_p32 = max_err(runs["plain"], runs["f32"])
    tol = 0.05 + 2 * d_p32
    scale = float(runs["f32"].abs().max())
    log(f"  prefill + {steps} decode steps, logits max|f32| {scale:.3f}: "
        f"|kernels - plain| {d_kp:.4f}, |kernels - f32| {d_k32:.4f}, "
        f"|plain - f32| {d_p32:.4f} (tol on |kernels - f32|: {tol:.4f})")
    argmax_same = bool((runs["kernels"].argmax(-1)
                        == runs["f32"].argmax(-1)).all())
    log(f"  argmax agrees with the f32 run at every step: {argmax_same}")
    if d_k32 > tol:
        raise AssertionError(f"consistency: kernel route {d_k32} from the "
                             f"f32 run, tolerance {tol}")
    return {"kernels_vs_plain": d_kp, "kernels_vs_f32": d_k32,
            "plain_vs_f32": d_p32}


# ------------------------------------------------------------- training ----

def train_phase(cfg, args, kernel_ms: float, device="cuda") -> dict:
    """Full-width training through ``Trainer`` with the kernels: one
    warm-up step (not kept), then ``args["steps"]`` steps with the launch
    counts set to 0 just before them and read just after.  ``kernel_ms``
    is the SSD kernel's time at the step's shape (phase 3), for its share
    of the step."""
    from repro_torch.configs import InputShape, RunConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.optim import OptimizerConfig
    from repro_torch.training import Trainer, TrainerConfig

    B, S, micro = args["batch"], args["seq_len"], args["microbatches"]
    run = RunConfig(use_kernels=True, remat="layer", microbatches=micro)
    trainer = Trainer(cfg, run, InputShape("smoke", S, B, "train"),
                      OptimizerConfig(), TrainerConfig(steps=1, seed=SEED),
                      device=device)
    trainer.init_state()
    sync(device)
    log(f"  params {cfg.param_count():,} f32 + AdamW m, v: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    t0 = time.perf_counter()
    warm = trainer.train(log=lambda *_: None)[0]
    log(f"  warm-up step (not kept): loss {warm['loss']:.4f}, "
        f"{time.perf_counter() - t0:.2f} s")
    trainer.tcfg.steps = 1 + args["steps"]
    torch.cuda.reset_peak_memory_stats()
    sync(device)
    ops.reset_launch_counts()
    trainer.train(log=lambda *_: None)
    sync(device)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    kept = trainer.history[1:]
    secs = [h["sec"] for h in kept]
    tok = B * S
    for h in kept:
        log(f"  step {h['step']}: loss {h['loss']:.4f}, grad norm "
            f"{h['grad_norm']:.4f}, {h['sec']:.3f} s, "
            f"{tok / h['sec']:,.0f} tok/s")
    med = statistics.median(secs)
    log(f"  {len(kept)} steps of {B} x {S} tokens in {micro} microbatches: "
        f"median {med:.3f} s/step = {tok / med:,.0f} tok/s; peak memory "
        f"{peak / 2**30:.2f} GiB (max_memory_allocated); launches {launches}")
    first = trainer.history[0]["loss"]
    ln_v = math.log(cfg.vocab_size)
    if not all(math.isfinite(h["loss"]) for h in trainer.history):
        raise AssertionError("train: a loss is not finite")
    if abs(first - ln_v) > 1.5:
        raise AssertionError(f"train: first loss {first} is more than 1.5 "
                             f"from ln({cfg.vocab_size}) = {ln_v:.3f}")
    ssm_layers = sum(k == "ssm" for k in cfg.layer_kinds())
    # each SSM layer launches once per microbatch forward, and once more
    # when layer recomputation reruns the forward in the backward pass
    want = len(kept) * micro * ssm_layers * (2 if run.remat != "none" else 1)
    if launches["ssd_scan"] != want:
        raise AssertionError(f"train: ssd_scan launched "
                             f"{launches['ssd_scan']} times, expected {want}")
    per_step = want / len(kept) * kernel_ms / 1e3
    log(f"  ssd_scan kernel: {want // len(kept)} launches per step x "
        f"{kernel_ms:.3f} ms = {per_step:.3f} s, {per_step / med:.1%} of the "
        "median step")
    # the plain backward of the scan: its recompute + backward at one
    # layer's shape, times the layers and microbatches of a step
    ssm = cfg.ssm
    H, P, N = ssm.num_heads(cfg.d_model), ssm.head_dim, ssm.state
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    b = B // micro
    x = rand(gen, (b, S, H, P), torch.bfloat16)
    dt = torch.rand((b, S, H), generator=gen, device="cuda") * 0.099 + 1e-3
    a = -dt * 4.0
    Bm, Cm = (rand(gen, (b, S, N), torch.bfloat16) for _ in range(2))
    gy = rand(gen, x.shape, torch.bfloat16)
    Q = ops._pick_block(S, ssm.chunk)

    def plain_backward():
        ins = [t.detach().requires_grad_(True) for t in (x, dt, a, Bm, Cm)]
        torch.autograd.grad(ref.ssd_scan_ref(*ins, Q), ins, gy)

    bwd_ms = time_ms(plain_backward, iters=5)
    per_step = bwd_ms * ssm_layers * micro / 1e3
    log(f"  plain backward of the scan (recompute + backward, one layer, "
        f"{b} x {S}): {bwd_ms:.3f} ms x {ssm_layers * micro} per step = "
        f"{per_step:.3f} s, {per_step / med:.1%} of the median step")
    return {"launches": launches, "step_s": med, "tok_s": tok / med,
            "peak_gib": peak / 2**30, "losses": [h["loss"] for h in
                                                 trainer.history]}


def train_consistency_phase(cfg, args, device="cuda") -> dict:
    """Loss and gradients of one full-width microbatch by four routes, all
    from the same f32 weights: the kernels and the plain versions, each in
    f32 and in bf16 compute.  In f32 the kernel route must match the plain
    one to ``F32_LOSS_TOL`` on the loss and ``F32_GRAD_TOL`` on the
    relative L2 error of the whole gradient: the scan kernel, at the
    strided layout ``ssm_train`` hands it, held to its plain version through
    every layer forward and backward.  In bf16 the kernel route must stay
    within 0.05 + 2x the plain route's distance from the f32 plain run, for
    the loss and the gradient; the parameters that carry that distance are
    listed."""
    from repro_torch.configs import InputShape, RunConfig
    from repro_torch.models import init_params, loss_fn, make_batch
    from repro_torch.tree import leaves_with_path

    params = init_params(cfg, SEED + 1, device)
    named = leaves_with_path(params)
    xs = [leaf for _, leaf in named]
    # one name for a parameter in every layer group: ['layers'][0]['ssm']
    # ['A_log'] -> ['layers']['ssm']['A_log']
    kinds = [re.sub(r"\[\d+\]", "", path) for path, _ in named]
    batch = make_batch(cfg, InputShape("c", args["seq_len"],
                                       args["batch"] // args["microbatches"],
                                       "train"), SEED + 1, device=device)

    def loss_and_grads(c, use_kernels):
        for p in xs:
            p.requires_grad_(True)
        loss, _ = loss_fn(params, batch, c, RunConfig(
            use_kernels=use_kernels, remat="layer"))
        grads = torch.autograd.grad(loss, xs)
        for p in xs:
            p.requires_grad_(False)
        return float(loss.detach()), grads

    def by_layer(grads):
        """Per layer (the leading axis of each group's stacked leaves, the
        groups in order): the squared norm of the difference from the f32
        gradient and of the f32 gradient itself."""
        groups: dict = {}
        for (path, _), g, r in zip(named, grads, g32):
            m = re.match(r"\['layers'\]\[(\d+)\]", path)
            if m:
                acc = groups.setdefault(int(m.group(1)), [0.0, 0.0])
                acc[0] += ((g.double() - r.double()) ** 2).flatten(1).sum(1)
                acc[1] += (r.double() ** 2).flatten(1).sum(1)
        return [torch.cat([groups[k][i] for k in sorted(groups)]).cpu()
                for i in (0, 1)]

    f32cfg = dataclasses.replace(cfg, dtype="float32")
    l32, g32 = loss_and_grads(f32cfg, False)
    sq32 = [float(torch.sum(g.double() ** 2)) for g in g32]
    norm32 = math.sqrt(sum(sq32))
    out, sq_diff = {}, {}
    for name, c, use_k in (("kernels f32", f32cfg, True),
                           ("kernels", cfg, True), ("plain", cfg, False)):
        loss, grads = loss_and_grads(c, use_k)
        if not math.isfinite(loss) or not all(
                bool(torch.isfinite(g).all()) for g in grads):
            raise AssertionError(f"train consistency: {name} route gives a "
                                 "non-finite loss or gradient")
        sq_diff[name] = [float(torch.sum((g.double() - r.double()) ** 2))
                         for g, r in zip(grads, g32)]
        out[name] = (loss, math.sqrt(sum(sq_diff[name])) / norm32)
        if name == "plain":
            depth = by_layer(grads)
        del grads
    (lk32, rk32), (lk, rk), (lp, rp) = (out["kernels f32"], out["kernels"],
                                        out["plain"])
    tol_l = 0.05 + 2 * abs(lp - l32)
    tol_g = 0.05 + 2 * rp
    log(f"  one microbatch ({args['batch'] // args['microbatches']} x "
        f"{args['seq_len']}), f32 compute: loss plain {l32:.6f}, kernels "
        f"{lk32:.6f}, |diff| {abs(lk32 - l32):.3e} (tol {F32_LOSS_TOL:g}); "
        f"gradient relative L2 error {rk32:.3e} (tol {F32_GRAD_TOL:g})")
    log(f"  bf16 compute: loss kernels {lk:.5f}, plain {lp:.5f}; |kernels - "
        f"f32| {abs(lk - l32):.5f} (tol {tol_l:.5f}); gradient relative L2 "
        f"error vs f32: kernels {rk:.5f}, plain {rp:.5f} (tol {tol_g:.5f})")
    # where the bf16 routes' gradient distance from the f32 run sits
    by_kind: dict = {}
    for kind, s32, dk, dp in zip(kinds, sq32, sq_diff["kernels"],
                                 sq_diff["plain"]):
        acc = by_kind.setdefault(kind, [0.0, 0.0, 0.0])
        acc[0] += s32
        acc[1] += dk
        acc[2] += dp
    total_p = sum(sq_diff["plain"])
    log("  bf16 gradient distance from f32 by parameter (share of the f32 "
        "gradient's squared norm | share of the plain route's squared "
        "distance | relative L2 error plain, kernels):")
    for kind, (s32, dk, dp) in sorted(by_kind.items(),
                                      key=lambda kv: -kv[1][2])[:8]:
        log(f"    {kind:<34} {s32 / norm32 ** 2:7.2%} | {dp / total_p:7.2%} "
            f"| {math.sqrt(dp / s32) if s32 else math.inf:.4f}, "
            f"{math.sqrt(dk / s32) if s32 else math.inf:.4f}")
    d_sq, r_sq = depth
    n = len(d_sq)
    at = sorted({0, n // 4, n // 2, 3 * n // 4, n - 1})
    log("  bf16 plain route by depth, relative L2 error of a layer's "
        "gradient vs f32: " + ", ".join(
            f"layer {i} {math.sqrt(float(d_sq[i] / r_sq[i])):.4f}"
            for i in at))
    if abs(lk32 - l32) > F32_LOSS_TOL or rk32 > F32_GRAD_TOL:
        raise AssertionError("train consistency: in f32 the kernel route "
                             "differs from the plain route more than allowed")
    if abs(lk - l32) > tol_l or rk > tol_g:
        raise AssertionError("train consistency: the kernel route is "
                             "further from the f32 run than allowed")
    return {"loss": out, "tol_loss": tol_l, "tol_grad": tol_g}


# ----------------------------------------------------------------- main ----

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="build, then check and time every kernel "
                        "(phases 1-3 without the gradient checks) and "
                        "stop; prints no result line")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    from repro_torch.serving.engine import cast_for_compute

    resolve_device("cuda")                 # pins TF32 off for f32 products
    t_start = time.perf_counter()
    log(f"[1/8] device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    build.build_all(verbose=True)
    log(f"[2/8] build: kernels built in {time.perf_counter() - t0:.1f} s "
        f"({build.BUILD_ROOT / build.source_hash()})")

    cfg = get_config("stablelm-3b")
    tcfg = get_config("mamba2-780m")
    targs = dict(batch=4, microbatches=2, seq_len=2048, steps=4)
    shape = dict(H=cfg.num_heads, K=cfg.num_kv_heads, Dh=cfg.head_dim,
                 slots=4, cache_len=512, prefill_len=128)
    log(f"[3/8] kernels vs plain versions (tolerance bf16 {TOL[torch.bfloat16]}"
        f", f32 {TOL[torch.float32]}; times: median of 20 launches, L2 "
        "flushed, queued behind a sleep: device time only):")
    kernels = kernel_phase(shape)
    kernels.update(ssd_kernel_phase(tcfg, targs["batch"] //
                                    targs["microbatches"], targs["seq_len"]))
    if opts.kernels_only:
        log(f"kernels only: stopped after the kernels' checks and times "
            f"({time.perf_counter() - t_start:.1f} s)")
        return 0
    grad_phase()

    log(f"[4/8] serve: full-width {cfg.name} ({cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads} heads x {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), random weights seed "
        f"{SEED}, bf16 compute")
    params = cast_for_compute(init_params(cfg, SEED, "cuda"), torch.bfloat16)
    torch.cuda.synchronize()
    log(f"  params {cfg.param_count() / 1e9:.3f} B, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    args = dict(requests=8, slots=shape["slots"],
                cache_len=shape["cache_len"], max_new=32, decode_chunk=8)
    # the first run in the process pays one-time costs (cuBLAS set-up and
    # heuristics for each product shape), which would land on the dense run
    serve_phase(cfg, params, False, args, label="warm-up (dense, not kept)")
    dense = serve_phase(cfg, params, False, args)
    paged = serve_phase(cfg, params, True, args)
    profiles = {kind: profile_phase(cfg, params, args, kind == "paged")
                for kind in ("dense", "paged")}

    log("[5/8] consistency at full width (kernels vs plain versions):")
    consistency_phase(cfg, params)
    del params
    torch.cuda.empty_cache()

    ssm = tcfg.ssm
    log(f"[6/8] train: full-width {tcfg.name} ({tcfg.num_layers} layers, "
        f"d_model {tcfg.d_model}, {ssm.num_heads(tcfg.d_model)} SSD heads x "
        f"{ssm.head_dim}, state {ssm.state}, chunk {ssm.chunk}, vocab "
        f"{tcfg.vocab_size}), f32 weights seed {SEED}, bf16 compute, f32 "
        f"AdamW, remat=layer, {targs['batch']} x {targs['seq_len']} tokens "
        f"in {targs['microbatches']} microbatches")
    train = train_phase(tcfg, targs, kernels["ssd_scan"]["ms"])
    torch.cuda.empty_cache()

    log("[7/8] train consistency at full width (kernels vs plain vs f32):")
    train_consistency_phase(tcfg, targs)

    launches = {name: dense["launches"][name] + paged["launches"][name]
                for name in ("flash_attention", "flash_decode",
                             "flash_decode_paged")}
    launches["ssd_scan"] = train["launches"]["ssd_scan"]
    summary = {name: {"max_abs_err": r["max_abs_err"],
                      "launches": launches[name]}
               for name, r in kernels.items()}
    log(f"[8/8] summary ({time.perf_counter() - t_start:.1f} s; serve "
        f"dense {dense['tok_s']:.1f} tok/s, paged {paged['tok_s']:.1f} "
        f"tok/s; decode kernel per token step dense "
        f"{profiles['dense']['decode_ms_per_step']} ms, paged "
        f"{profiles['paged']['decode_ms_per_step']} ms; train "
        f"{train['tok_s']:,.0f} tok/s, {train['step_s']:.3f} s/step, peak "
        f"{train['peak_gib']:.2f} GiB; attention launches summed over both "
        "serve runs, ssd_scan over the kept train steps)")
    log("kernels " + json.dumps(summary))
    log(smi)
    line = {"kernels": [dict(name=name, route=r["route"], source=r["source"],
                             replaces=r["replaces"],
                             launches=launches[name],
                             max_abs_err=r["max_abs_err"], ms=r["ms"],
                             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                             bound_by=r["bound_by"],
                             library_ms=r["library_ms"])
                        for name, r in kernels.items()]}
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
