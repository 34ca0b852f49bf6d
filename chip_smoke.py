"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only   # build, check and time every
                                           # kernel, then stop
    python3 chip_smoke.py --only resume examples   # build, run these of
                                           # phases 13-16, then stop

Needs one CUDA card and the CUDA toolkit.  Phases, each fatal on failure:

1. device  — refuse to run without ``torch.cuda.is_available()``; print the
   card's name and power limit (``nvidia-smi``).
2. build   — compile the hand-written kernels from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` per source, in parallel).
3. kernels — hold each kernel against its plain PyTorch version on the
   card, at the serving path's shapes (full-width stablelm-3b), a GQA
   shape at qwen2-7b widths, the families phase's MHA at Dh 128
   (qwen2-moe-a2.7b) and 12 query heads a kv head (starcoder2-3b), a
   ring-window case and a paged case with null pages, in bf16 and f32;
   the SSD decode step at granite-4.0-h-micro's serving shape (384
   lanes) and small widths, the attention kernels with an explicit
   softmax scale, and at that cell's shapes (paged decode over 384
   contexts of 256-6,144 lines, prefill at 2,048 tokens, GQA 4:1, Dh 64);
   the SSD scan at the training path's shape (full-width mamba2-780m),
   the JAX package's ``SSD_CASES``, a
   chunk that ``_pick_block`` shrinks and a chunk whose decays span the
   f32 range, on inputs strided as the training path gives them, against
   its chunked plain version and the token-by-token oracle; time kernel,
   plain version and one
   library call (a yardstick the port never calls) with CUDA events,
   the L2 cache flushed before every launch and the timed launches
   queued behind a sleep kernel, so that each reading is device time.
   The attention backward kernel at the train cells' shapes and ragged
   ones against autograd through the plain version in f32, two calls
   bit-identical, timed beside its bound, the plain recompute and SDPA's
   backward.  Then the gradients of the two kernels that training
   differentiates (``ops.flash_attention`` in f32 and bf16,
   ``ops.ssd_scan``) against plain autograd; ``--kernels-only`` stops
   here.
4. serve   — full-width stablelm-3b (random weights from a seed, bf16
   compute) through ``DecodeEngine``: a warm-up run, then the dense cache,
   then pages of 16 lines; fail if a kernel of the path never launched or
   a request came back short.  Then a ``torch.profiler`` trace of one
   steady decode chunk, dense and paged: its wall time against the
   device's busy time, and the decode kernel's device time per token
   step.  Then the decode graphs (``models.model.DecodeGraphs``): 128
   greedy requests on stablelm-3b (16-line pages, cache 256) and on
   mamba2-780m (its SSM state), every ``decode_n`` call bit-identical to
   eager ``decode_n`` on a copy of its state (tokens, lanes, cache), one
   capture a page-table width, the replayed share and the graphs' memory
   pool logged; 128 lanes of equal logits sampling at T 0.8, graphed and
   eager, each fitting the softmax (chi-square) with no two replays
   drawing alike; and the profiler naming the paged decode kernel in a
   replay.
5. serve modes — the same model through the engine's serving modes, each
   on its own requests: the prefix cache (a shared 64-token system
   prompt), token-budgeted chunked prefill (64 tokens), speculation with
   the n-gram and the draft-model sources; fail on a short request, a
   kernel of the run's path that never launched, no prefix hit, no more
   chunks than requests, or no verify round.  Then the device time of
   each plain attention routine these modes add (suffix prefill, prefill
   chunk, verify).
6. consistency — one request's prefill logits and first decode steps
   through the kernels against the plain versions, at full width; then
   the serve modes' greedy outputs against the classic paged engine's,
   in f32 with the depth cut to 4 layers, token for token (a difference
   passes only where the classic run's top-2 logit gap is below 1e-4).
7. train   — full-width mamba2-780m (f32 weights from a seed, bf16
   compute, f32 AdamW state, layer recomputation) through ``Trainer``:
   2 x 2048-token microbatches a step, one warm-up step, then 4 steps;
   fail on a non-finite loss, a first loss far from ln(vocab), or an
   ``ssd_scan`` launch count other than the run implies.
8. train consistency — loss and gradients of one full-width microbatch
   through the kernels and the plain versions, in f32 (held close) and in
   bf16 (held to the f32 run), with the bf16 gap's parameters listed.
9. cluster — the paper's job-script workflow through the port's cluster
   layer in real mode (``repro_torch.cluster``): a one-host inventory of
   the card is provisioned and validated; a scavenger job trains
   full-width mamba2-780m as phase 7 does, checkpointing every 2 steps,
   to step 2; a high-QOS job serving full-width stablelm-3b (4 requests,
   16-line pages) preempts it; it requeues with the store's step as
   progress and resumes from its checkpoint to step 4; fail on a job
   that did not exit 0, a missing preemption or requeue, losses at steps
   1-4 not bit-identical to phase 7's, too little disk for the
   checkpoints, or a kernel of either job never launched.
10. families — the other model families through ``DecodeEngine`` at
   full width, 4 slots: mamba2-780m (SSM serving, one wave of 4 requests,
   dense cache; fail on any kernel launch, since the SSM serve path has
   none), then its greedy tokens with front-padded bucketed prefill
   against exact prefill in f32 with the depth cut to 4 layers (a
   difference passes only as a tie); qwen2-moe-a2.7b (bf16 weights: one
   wave on the dense cache, one on 16-line pages, then n-gram speculation
   with k = 4 on 4 prompts each asked twice, the second wave drafting
   from the first; fail if a kernel of a run's path never launched, or on
   fewer verify rounds or proposals than the second wave needs), then in
   f32 with the depth cut to 4 layers one request's prefill and 4 decode
   steps through the kernels against the plain versions, where bf16
   rounding cannot flip a router; starcoder2-3b (24 query heads over 2 kv
   heads, one wave, dense cache).  Every run logs tok/s, prefill and
   decode-call means, launches and peak memory; each model then goes
   through the consistency check of phase 6.
11. elastic — full-width stablelm-3b replicas on the one card, built by
   the serve CLI's ``--replicas``/``--autoscale`` code over one bf16
   weight set (built again from the seed: phase 4's were freed), 4
   slots, cache_len 512 and decode chunk 8 each, 8 requests in two waves
   behind two 64-token system prompts in turn: 1 replica (16-line pages,
   prefix cache), then 2 replicas round robin on the dense cache, 2 under
   prefix affinity and 2 round robin with pages and the prefix cache, and
   the autoscaler over a simulated 2-node cluster, where a high-QOS job
   preempts one replica's job after the first wave's 3 router steps and
   the next tick drains it.  Each run logs wall tok/s, tokens over the
   busiest replica's busy seconds, the router's counters, prefix hits,
   peak memory and launches; fail on a short request, a kernel of a
   run's path that never launched, fewer than 7 of 8 affinity hits,
   fewer prefix hits under affinity than under round robin, a drain that
   moved no request mid-decode or lost a partial output, or two
   replicas' peak more than one KV pool + 1 GiB above one replica's.
   Then two replicas (one drained after the first step) against one
   engine, greedy, in f32 at 4 layers, as phase 6 does.
12. tensor parallel — full-width stablelm-3b served by two ranks that
   share the card (``serving.tp.launch`` over gloo; NCCL takes one rank
   per card), each with 16 of the 32 heads and half of d_ff, one f32
   all-reduce per layer at attention-out and one at MLP-down; each rank
   builds the bf16 weights from the seed and keeps its shard.  4 slots,
   cache_len 512, decode chunk 8, 4 greedy requests: the dense cache, then
   16-line pages with the prefix cache (prompts behind a shared 64-token
   system prompt), each against tp=1 runs of this process; a steady
   decode chunk per rank (rank 0's traced: device-busy share) with its
   all-reduces counted and timed on the host; then f32 at 4 layers.  Fail
   on a short request, ranks whose outputs differ, an f32 token that
   differs from tp=1's at all, bf16 logits (phase 6's prompt, and the
   context of a token that differs from tp=1's) farther from tp=1's than
   phase 6's bound, a differing bf16 token whose tp=1 top-2 gap exceeds
   twice that distance, an all-reduce count other than one
   per layer and reduction point a token step, a kernel of the three
   attention kernels that did not launch on a rank, no prefix hit, or a
   rank's peak memory over its shard (its weights and its KV pool) + one
   KV pool + 1 GiB.
13. train parallel — the port's ``Trainer`` on ranks that share the card
   over gloo (``launch.mesh.launch_ranks``), seed-0 f32 weights, bf16
   compute, layer recomputation, 4 x 1024 tokens a step, one step a run
   (a parallel step through gloo takes 10-40 s): full-width stablelm-3b
   under fsdp_tp ZeRO 3 on 2 x 2 ranks (the JAX CLI's default), tp on
   1 x 2 and fsdp ZeRO 3 on 2 x 1; full-width mamba2-780m under dp ZeRO
   1 and 2 on 2 x 1 and tp on 1 x 2; qwen2-moe-a2.7b at full width cut
   to 4 layers under tp on 1 x 2 (expert parallel) and fsdp ZeRO 3 on 2
   x 1; each config first on one rank in this process (qwen2-moe's with
   one more step traced: the device time of the expert einsums against
   the step's, logged).
   Each rank logs its step time, the collectives' count and share of the
   step (timed on the host), its launches, and its peak memory against
   its reckoned shard (f32 params, gradients, AdamW m and v),
   transients and activations.  Then f32 at 4 layers of stablelm-3b, two
   steps a run: dp ZeRO 1 and 2, fsdp ZeRO 2 and 3, tp, tp with
   seq_parallel, fsdp_tp ZeRO 3; mamba2-780m under tp; qwen2-moe-a2.7b
   at 2 layers under fsdp ZeRO 3 and tp; each against the one-rank run.
   Fail on a non-finite loss or a first loss far from ln(vocab), ranks
   whose losses differ, bf16 losses more
   than 0.05 (phase 8's constant term) from the one-rank run's, f32
   losses beyond 1e-5 relative or final parameters beyond 1e-4 of the
   largest magnitude, a rank's peak above its reckoned bytes + 1 GiB, or
   an attention (dense) or scan (SSM) launch count other than two a
   layer a step on a rank.
14. resume — a sharded checkpoint resumed on other meshes: full-width
   mamba2-780m (f32 weights and AdamW, bf16 compute, phase 13's tokens)
   under dp ZeRO 2 on 2 x 1 ranks sharing the card takes a step, saves
   through ``Trainer.save`` (``Streamed`` leaves gathered a slice at a
   time) and takes step 2; the checkpoint resumes (``maybe_resume``,
   each rank reading its blocks) under tp on 1 x 2, where the SSD heads
   split, and on one rank in this process, each taking step 2; then the
   same in f32 at 4 layers.  Free disk is checked first; the checkpoints
   are removed at the end.  Each rank logs save and restore seconds,
   GB/s and the checkpoint's bytes.  Fail on restored state whose
   digests (SHA-1 of every whole leaf) differ from the saving run's at
   step 1, a resumed step-2 loss more than 0.05 from the uninterrupted
   run's (f32: loss or gradient norm beyond 1e-5 relative), a rank's
   peak while saving or restoring above the memory it held before +
   the largest slice handed out + 1 GiB, or a scan launch count other
   than two a layer a step on a rank.
15. dry run — the production dry run (``repro_torch.launch.dryrun``:
   one rank's program on ``meta`` tensors in a fake world of the mesh's
   size, the plain route, no card) held to phase 13's card runs: each
   bf16 run's collectives by kind and the bytes handed over must equal
   phase 13's exactly, and its peak (rank 0) and each one-rank run's
   must lie within 10% of the measured one (printed beside
   ``reckon_train``'s limit); the one-rank runs' counted flops, TF/s
   and MFU (6ND over the data sheet's 989e12 bf16 flop/s); the TP
   decode at 1 x 2 must reduce ``psums_per_token`` times a token and a
   chunk of 8 as phase 12 counted.  Then the production subset (16 x 16
   ranks; stablelm-3b x the four shapes, mamba2-780m, qwen2-moe-a2.7b
   and jamba-1.5-large-398b at train_4k, stablelm-3b train_4k on 2 x 16
   x 16), run on the CPU in two processes started after the build,
   beside the card's phases: each combination's seconds, its record
   under ``results/dryrun_torch`` and ``benchmarks/bench_roofline.py``'s
   table (data-sheet peaks: a reckoning, not a card speed).
16. examples — each twin of ``examples/torch`` that runs on the card as
   its own ``python3 examples/torch/<name>.py --device cuda`` process,
   all started together beside phase 15 (``train_cluster`` at full size
   for 40 steps; ``tp_serving`` and ``pipeline_parallel`` on two ranks
   sharing the card over gloo), and the host-only twins
   (``slurm_workflow``, ``multi_tenant``), started on the CPU after the
   build; fail on a non-zero exit or a last line other than the twin's
   own.  Each run's seconds are logged.
17. summary — the kernels line, then the device line last.

Exits non-zero on any failure, and when no card is present.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
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
# serving logits in f32 through the kernels against the plain versions,
# relative to the logits' largest magnitude (the same sums in another
# order through a few layers; a wrong kernel is off by a large share)
F32_LOGIT_TOL = 1e-4
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
              (1, 1000, H, K, Dh, 256, bf16),
              # the speculative draft model's prefill (1 layer, 2 heads of
              # 32): buckets of 8 to cache_len tokens
              (1, 32, 2, 2, 32, None, bf16), (1, 64, 2, 2, 32, None, f32),
              (1, cache_len, 2, 2, 32, None, bf16)]
    # the families phase's prefills: qwen2-moe-a2.7b (MHA, 16 heads of
    # 128) and starcoder2-3b (24 query heads over 2 kv heads of 128)
    for h, k in ((16, 16), (24, 2)):
        cases += [(1, 128, h, k, 128, None, bf16),
                  (1, cache_len, h, k, 128, None, bf16),
                  (1, 100, h, k, 128, None, f32)]
    # the TP phase's shard: H/2 query heads over K/2 kv heads
    Hs, Ks = H // 2, K // 2
    cases += [(1, L, Hs, Ks, Dh, None, bf16), (1, cache_len, Hs, Ks, Dh,
                                               None, bf16),
              (1, 100, Hs, Ks, Dh, None, f32)]
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

    def gqa_sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)

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
    # the families phase's prefill heads, for the record: qwen2-moe-a2.7b
    # (16 of 128, MHA) and starcoder2-3b (24 over 2 of 128)
    for h, k in ((16, 16), (24, 2)):
        qf, kf, vf = (rand(gen, (1, L, n, 128), bf16) for n in (h, k, k))
        b_f, by_f = bound_ms(2 * (2 * L * h * 128 + 2 * L * k * 128),
                             4 * 128 * h * L * (L + 1) / 2, bf16)
        log(f"  flash_attention at q(1,{L},{h},128) kv {k}: "
            f"{time_ms(lambda: fa.flash_attention_bshd(qf, kf, vf)):.4f} "
            f"ms, SDPA {time_ms(lambda: gqa_sdpa(qf, kf, vf)):.4f} ms "
            f"(bound {b_f:.4f} ms, {by_f})")
    # the TP phase's shard, for the record: each rank's prefill
    qs, ks, vs = (rand(gen, (1, L, n, Dh), bf16) for n in (Hs, Ks, Ks))
    b_s, by_s = bound_ms(2 * (2 * L * Hs * Dh + 2 * L * Ks * Dh),
                         4 * Dh * Hs * L * (L + 1) / 2, bf16)
    log(f"  flash_attention at the TP shard q(1,{L},{Hs},{Dh}) kv {Ks}: "
        f"{time_ms(lambda: fa.flash_attention_bshd(qs, ks, vs)):.4f} ms, "
        f"plain {time_ms(lambda: ref.attention_ref(qs, ks, vs)):.4f} ms, "
        f"SDPA {time_ms(lambda: gqa_sdpa(qs, ks, vs)):.4f} ms (bound "
        f"{b_s:.4f} ms, {by_s})")

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
              (4, 4096, H, K, Dh, None, bf16, bf16, ints(4095, 2000, 63, 0)),
              # the draft model's own dense cache: H = K = 2, Dh 32, every
              # slot's row; bf16 compute, and f32 compute over the bf16
              # cache (the f32 serve runs) and over an f32 one
              (slots, cache_len, 2, 2, 32, None, bf16, bf16, positions),
              (slots, cache_len, 2, 2, 32, None, f32, bf16, positions),
              (slots, cache_len, 2, 2, 32, None, f32, f32, edges)]
    # the families phase's decodes: qwen2-moe-a2.7b's MHA at Dh 128 and
    # starcoder2-3b's 12 query heads a kv head
    for h, k in ((16, 16), (24, 2)):
        dcases += [(slots, cache_len, h, k, 128, None, bf16, bf16, positions),
                   (slots, cache_len, h, k, 128, None, f32, f32, positions),
                   (slots, cache_len, h, k, 128, None, bf16, bf16, edges)]
    # the TP phase's shard (split_plan picks more splits at K/2)
    dcases += [(slots, cache_len, Hs, Ks, Dh, None, bf16, bf16, positions),
               (slots, cache_len, Hs, Ks, Dh, None, f32, f32, edges),
               (slots, cache_len, Hs, Ks, Dh, None, f32, bf16, positions)]
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
    # the families phase's decode heads, for the record
    for h, k in ((16, 16), (24, 2)):
        qf = rand(gen, (slots, 1, h, 128), bf16)
        kf, vf = (rand(gen, (slots, cache_len, k, 128), bf16)
                  for _ in range(2))
        b_f, by_f = bound_ms(
            2 * (slots * cache_len * 2 * k * 128 + 2 * slots * h * 128)
            + 4 * slots, 4 * h * 128 * lines, bf16)
        t_f = time_ms(lambda: fd.flash_decode_bshd(qf, kf, vf, full))
        lib_f = time_ms(lambda: F.scaled_dot_product_attention(
            qf.transpose(1, 2), kf.transpose(1, 2), vf.transpose(1, 2),
            enable_gqa=True))
        log(f"  flash_decode at q({slots},1,{h},128) cache "
            f"({slots},{cache_len},{k},128): {t_f:.4f} ms, SDPA "
            f"{lib_f:.4f} ms (bound {b_f:.4f} ms, {by_f})")
    # the TP phase's shard, for the record: each rank's dense decode
    qs = rand(gen, (slots, 1, Hs, Dh), bf16)
    ks, vs = (rand(gen, (slots, cache_len, Ks, Dh), bf16) for _ in range(2))
    chunk_s, n_s = fd.split_plan(cache_len, slots, Ks,
                                 fd.sm_count(torch.cuda.current_device()))
    b_s, by_s = bound_ms(
        2 * (slots * cache_len * 2 * Ks * Dh + 2 * slots * Hs * Dh)
        + 4 * slots, 4 * Hs * Dh * lines, bf16)
    t_s = time_ms(lambda: fd.flash_decode_bshd(qs, ks, vs, full))
    p_s = time_ms(lambda: ref.decode_attention_ref(qs, ks, vs, full))
    lib_s = time_ms(lambda: F.scaled_dot_product_attention(
        qs.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2)))
    log(f"  flash_decode at the TP shard q({slots},1,{Hs},{Dh}) cache "
        f"({slots},{cache_len},{Ks},{Dh}) ({n_s} splits of {chunk_s} "
        f"lines): {t_s:.4f} ms, plain {p_s:.4f} ms, SDPA {lib_s:.4f} ms "
        f"(bound {b_s:.4f} ms, {by_s})")

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
              (28, 4, 128, bf16, bf16, table_null, positions),
              # qwen2-moe-a2.7b's paged and speculation runs; starcoder2's
              # 12-way groups
              (16, 16, 128, bf16, bf16, table_null, positions),
              (16, 16, 128, f32, f32, table_null, positions),
              (24, 2, 128, bf16, bf16, table_null, positions),
              (24, 2, 128, f32, f32, table_full, positions),
              # the TP phase's shard
              (Hs, Ks, Dh, bf16, bf16, table_null, positions),
              (Hs, Ks, Dh, f32, f32, table_full, positions)]
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
    # the TP phase's shard, for the record: each rank's paged decode
    qs = rand(gen, (slots, 1, Hs, Dh), bf16)
    ks, vs = (rand(gen, (num_pages, ps, Ks, Dh), bf16) for _ in range(2))
    b_s, by_s = bound_ms(
        2 * (lines * 2 * Ks * Dh + 2 * slots * Hs * Dh) + 4 * slots
        + 4 * slots * n_tab, 4 * Hs * Dh * lines, bf16)
    t_s = time_ms(lambda: fd.flash_decode_paged_bshd(qs, ks, vs, table_full,
                                                     full))
    p_s = time_ms(lambda: ref.paged_decode_attention_ref(qs, ks, vs,
                                                         table_full, full))
    log(f"  flash_decode_paged at the TP shard q({slots},1,{Hs},{Dh}) pool "
        f"({num_pages},{ps},{Ks},{Dh}): {t_s:.4f} ms, plain {p_s:.4f} ms, "
        f"no library call (bound {b_s:.4f} ms, {by_s})")
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


def ssd_decode_phase(cfg, lanes: int) -> dict:
    """The SSD decode-step kernel against its plain version, in bf16 and
    f32, at ``cfg``'s widths over ``lanes`` sequences (x, B and C slices
    of one conv output, as ``ssm_decode`` hands them over) and at small
    widths (N 4 to 128; P not a multiple of the block); the state after
    the step held as tightly as y.  Then its time at ``cfg``'s shape
    against the plain version's and the bytes' bound.  Then the attention
    kernels with an explicit softmax scale against their plain versions
    with the same scale, at small shapes and at ``cfg``'s serving shapes
    (:func:`granite_attention_checks`)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_decode as sd

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    ssm = cfg.ssm
    H, P, N = ssm.num_heads(cfg.d_model), ssm.head_dim, ssm.state
    bf16, f32 = torch.bfloat16, torch.float32

    def inputs(B, h, p, n, dtype):
        # batch-minor, as the decode step's conv output lies
        u = rand(gen, (h * p + 2 * n, B), dtype).t()
        x = u[:, :h * p].reshape(B, h, p)
        Bm, Cm = u[:, h * p:h * p + n], u[:, h * p + n:]
        dt = torch.rand((B, h), generator=gen, device="cuda") * 0.099 + 1e-3
        A = -(torch.rand((h,), generator=gen, device="cuda") * 15 + 1)
        D = torch.rand((h,), generator=gen, device="cuda") + 0.5
        state = rand(gen, (B, h, p, n), f32)
        return state, x, dt, A, D, Bm, Cm

    errs = []
    for B, h, p, n in ((lanes, H, P, N), (3, 5, 24, 16), (2, 2, 7, 4),
                       (4, 3, 64, 32), (1, 2, 96, 128)):
        for dt_ in (bf16, f32):
            state, x, dt, A, D, Bm, Cm = inputs(B, h, p, n, dt_)
            plain_state = state.clone()
            got = sd.ssd_decode_step_bhpn(state, x, dt, A, D, Bm, Cm)
            want = ref.ssd_decode_step_ref(plain_state, x, dt, A, D, Bm, Cm)
            what = f"state ({B},{h},{p},{n}) {str(dt_)[6:]}"
            err = check("ssd_decode_step", got, want, dt_, what + " y",
                        relative=True)
            check("ssd_decode_step", state, plain_state, f32,
                  what + " state", relative=True)
            if dt_ == bf16 and B == lanes:
                errs.append(err)
    state, x, dt, A, D, Bm, Cm = inputs(lanes, H, P, N, bf16)
    ms = time_ms(lambda: sd.ssd_decode_step_bhpn(state, x, dt, A, D, Bm,
                                                 Cm))
    plain = time_ms(lambda: ref.ssd_decode_step_ref(state, x, dt, A, D, Bm,
                                                    Cm))
    nbytes = lanes * (8 * H * P * N + 2 * (2 * H * P + 2 * N) + 4 * H) \
        + 8 * H
    flops = 6 * lanes * H * P * N
    b, by = bound_ms(nbytes, flops, bf16)
    r = dict(route="cuda", source="src/repro_torch/kernels/csrc/ssd_decode.cu",
             replaces="the plain one-token step of models/ssm.py",
             max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b,
             bound_by=by, library_ms=None,
             shape=f"state ({lanes},{H},{P},{N}) f32, x bf16 "
                   f"({nbytes / 1e9:.3f} GB)")
    log(f"  {'ssd_decode_step':<19} {r['shape']}: kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms ({plain / ms:.1f}x the kernel), bound "
        f"{b:.4f} ms ({by}), {100 * b / ms:.1f}% of it")
    scale = 0.015625
    q, k, v = (rand(gen, (2, 192, n, 64), bf16) for n in (8, 2, 2))
    check("flash_attention", ops.flash_attention(q, k, v, scale=scale),
          ref.attention_ref(q, k, v, scale=scale), bf16,
          f"q (2,192,8,64) scale {scale}")
    pool_k, pool_v = (rand(gen, (9, 16, 2, 64), bf16) for _ in range(2))
    table = torch.tensor([[1, 2, 3, 0], [4, 5, 6, 7]], dtype=torch.int32,
                         device="cuda")
    qd = rand(gen, (2, 1, 8, 64), bf16)
    pos = torch.tensor([40, 63], dtype=torch.int32, device="cuda")
    check("flash_decode_paged",
          ops.flash_decode_paged(qd, pool_k, pool_v, table, pos, scale=scale),
          ref.paged_decode_attention_ref(qd, pool_k, pool_v, table, pos,
                                         scale=scale), bf16,
          f"q (2,1,8,64) pages of 16 scale {scale}")
    granite_attention_checks(cfg, lanes, gen)
    return {"ssd_decode_step": r}


def granite_attention_checks(cfg, lanes: int, gen, ps: int = 16,
                             cache_len: int = 6144, prompt: int = 2048):
    """The attention kernels at the serving cell's shapes of ``cfg``
    (granite-4.0-h-micro: GQA 4:1, Dh 64, its ``attention_multiplier``):
    the paged decode kernel over ``lanes`` sequences of contexts drawn
    from 256 to ``cache_len`` lines in a pool of ``lanes * cache_len /
    ps`` pages, in random order, null pages past each context, where the
    split-KV partition and merge do their work; prefill attention at the
    longest prompt.  The plain paged version runs 32 lanes at a time (its
    GQA copy of the gathered lines is 4x the kernel's reads)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.attention import softmax_scale

    bf16 = torch.bfloat16
    H, K, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = softmax_scale(cfg, Dh)
    n_tab = cache_len // ps
    num_pages = lanes * n_tab + 1
    ctx = torch.randint(256, cache_len + 1, (lanes,), generator=gen,
                        device="cuda")
    table = (torch.randperm(num_pages - 1, generator=gen, device="cuda")
             + 1)[:lanes * n_tab].reshape(lanes, n_tab).to(torch.int32)
    live = torch.arange(n_tab, device="cuda")[None, :] * ps < ctx[:, None]
    table = torch.where(live, table, torch.zeros_like(table))
    pos = (ctx - 1).to(torch.int32)
    q = rand(gen, (lanes, 1, H, Dh), bf16)
    kp, vp = (rand(gen, (num_pages, ps, K, Dh), bf16) for _ in range(2))
    got = ops.flash_decode_paged(q, kp, vp, table, pos, scale=scale)
    want = torch.cat([ref.paged_decode_attention_ref(
        q[i:i + 32], kp, vp, table[i:i + 32], pos[i:i + 32], scale=scale)
        for i in range(0, lanes, 32)])
    check("flash_decode_paged", got, want, bf16,
          f"q ({lanes},1,{H},{Dh}) pool {num_pages}x{ps}x{K} ctx "
          f"{int(ctx.min())}-{int(ctx.max())} scale {scale}")
    del kp, vp, got, want
    q, k, v = (rand(gen, (1, prompt, n, Dh), bf16) for n in (H, K, K))
    check("flash_attention", ops.flash_attention(q, k, v, scale=scale),
          ref.attention_ref(q, k, v, scale=scale), bf16,
          f"q (1,{prompt},{H},{Dh}) {K} kv heads scale {scale}")


BWD_EXCESS_TOL = 1e-4


def bwd_excess(got, want) -> float:
    """How far bf16 gradients stray past one bf16 rounding of the f32
    ones, over the largest: max(|got - want| - 2^-8 |want|) / max(1,
    max |want|); NaN anywhere reads NaN."""
    w = want.float()
    ex = ((got.float() - w).abs() - 2.0 ** -8 * w.abs()).max()
    return float(ex) / max(1.0, float(w.abs().max()))


def attention_bwd_phase() -> dict:
    """The attention backward kernel (``kernels/attention_bwd.py``): dq,
    dk and dv against autograd through ``ref.attention_ref`` in f32 on the
    same bf16 values (within one bf16 rounding + ``BWD_EXCESS_TOL`` of the
    largest: f32 sums in another order, P and dS in 16 bits), bit-identical
    over two calls, at the train cells' shapes and ragged ones; then timed
    at stablelm-3b.train's (4,1024,32,80) and one fsdp4 rank's
    (4,2048,16,128) beside its bound, the plain recompute (what float32
    still runs) and SDPA's backward (the yardstick; the port never calls
    it)."""
    from repro_torch.kernels import attention_bwd as ab
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    bf16 = torch.bfloat16

    def plain(q, k, v, do, window=None, scale=None):
        with torch.enable_grad():
            ins = [t.detach().float().requires_grad_(True)
                   for t in (q, k, v)]
            out = ref.attention_ref(*ins, window=window, scale=scale)
            return torch.autograd.grad(out, ins, do.float())

    errs = []
    for B, S, H, K, Dh, window, scale in (
            (4, 1024, 32, 32, 80, None, None),      # stablelm-3b.train
            (4, 2048, 16, 16, 128, None, None),     # an fsdp4 rank
            (1, 300, 32, 8, 64, None, 1 / 64),      # granite's GQA 4:1
            (2, 200, 8, 2, 72, 64, None),           # ragged Dh, window
            (1, 1, 4, 4, 80, None, None)):
        q, k, v = (rand(gen, (B, S, n, Dh), bf16) for n in (H, K, K))
        do = rand(gen, q.shape, bf16)
        got = ab.attention_bwd_bshd(q, k, v, do, window=window, scale=scale)
        again = ab.attention_bwd_bshd(q, k, v, do, window=window,
                                      scale=scale)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        want = plain(q, k, v, do, window, scale)
        ex = [bwd_excess(g, w) for g, w in zip(got, want)]
        ok = same and all(math.isfinite(e) and e <= BWD_EXCESS_TOL
                          for e in ex)
        log(f"  attention_bwd q({B},{S},{H},{Dh}) kv {K} w={window} "
            f"scale={scale}: excess over one bf16 rounding dq {ex[0]:.2e} "
            f"dk {ex[1]:.2e} dv {ex[2]:.2e} (tol {BWD_EXCESS_TOL:g}); two "
            f"calls {'bit-identical' if same else 'DIFFER'} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"attention_bwd at q({B},{S},{H},{Dh}): "
                                 f"excess {ex}, bit-identical {same}")
        errs.append(max(float((g.float() - w).abs().max())
                        for g, w in zip(got, want)))
        del got, again, want

    out = {}
    for B, S, H, Dh, what in ((4, 1024, 32, 80, "stablelm-3b.train"),
                              (4, 2048, 16, 128, "an fsdp4 rank")):
        q, k, v, do = (rand(gen, (B, S, H, Dh), bf16) for _ in range(4))
        ms = time_ms(lambda: ab.attention_bwd_bshd(q, k, v, do))
        plain_ms = time_ms(lambda: plain(q, k, v, do), iters=5)
        ins = [t.transpose(1, 2).detach().requires_grad_(True)
               for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*ins, is_causal=True)
        dot = do.transpose(1, 2)
        lib = time_ms(lambda: torch.autograd.grad(o, ins, dot,
                                                  retain_graph=True))
        del o, ins
        # q, dO, dq and k, v, dk, dv once (K = H); five products a pair
        pairs = S * (S + 1) // 2
        b, by = bound_ms(2 * B * S * Dh * 7 * H, 10 * Dh * pairs * H * B,
                         bf16)
        log(f"  attention_bwd at {what}'s q/k/v/dO ({B},{S},{H},{Dh}): "
            f"{ms:.4f} ms ({100 * b / ms:.1f}% of its bound {b:.4f} ms, "
            f"{by}), plain recompute {plain_ms:.4f} ms, SDPA backward "
            f"{lib:.4f} ms")
        if not out:
            out["attention_bwd"] = dict(
                route="cuda",
                source="src/repro_torch/kernels/csrc/attention_bwd.cu",
                replaces="none: the port's own (the TPU kernel is "
                "forward-only)",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=lib,
                shape=f"q/k/v/dO ({B},{S},{H},{Dh}) bf16 causal")
    return out


def grad_phase():
    """Gradients through the two kernels training differentiates: the
    autograd functions of ``kernels.ops`` against plain autograd at small
    shapes; f32 (kernel forward, plain recompute in the backward) and,
    for attention, bf16 (the backward kernel: within one bf16 rounding of
    the f32 gradients + ``BWD_EXCESS_TOL`` of the largest)."""
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
        # the same values in both: the bf16 inputs, and the weights as
        # the bf16 output's gradient rounds them
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        wb = w.to(torch.bfloat16).float()
        got = grads(lambda *t: ops.flash_attention(*t, window=window),
                    (qb, kb, vb), wb)
        want = grads(lambda *t: ref.attention_ref(*t, window=window),
                     (qb.float(), kb.float(), vb.float()), wb)
        for name, g, r in zip("qkv", got, want):
            ex = bwd_excess(g, r)
            ok = g.dtype == torch.bfloat16 and math.isfinite(ex) \
                and ex <= BWD_EXCESS_TOL
            log(f"  {'flash_attn grad':<19} d{name} at q(1,96,8,64) kv 2 "
                f"heads w={window} bf16 (the backward kernel): excess "
                f"{ex:.3e} (tol {BWD_EXCESS_TOL:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attn grad d{name} bf16: "
                                     f"excess {ex}")


# -------------------------------------------------------------- serving ----

def serve_requests(cfg, args, greedy=False) -> list:
    """The serve phase's requests: ``args["requests"]`` prompts of 4 to
    cache_len/4 tokens from the seed, greedy and temperature 0.8 in turn
    (all greedy with ``greedy``)."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(SEED)
    requests = []
    for rid in range(args["requests"]):
        plen = int(rng.integers(4, args["cache_len"] // 4))
        prompt = rng.integers(2, cfg.vocab_size, plen).astype(np.int32)
        requests.append(Request(rid=rid, prompt=prompt,
                                max_new_tokens=args["max_new"],
                                temperature=0.0 if greedy
                                else float(rid % 2) * 0.8))
    return requests


def serve_phase(cfg, params, paged: bool, args, device="cuda",
                label=None) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.monitoring import MetricsRegistry
    from repro_torch.serving import DecodeEngine

    requests = serve_requests(cfg, args)
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
        if launches[name] == 0 and torch.device(device).type == "cuda":
            raise AssertionError(f"{kind}: kernel {name} never launched on "
                                 "the serving path")
    return {"launches": launches, "tok_s": total / wall, "wall_s": wall}


# ---------------------------------------------------------- serve modes ----

#: the engine's serving modes the serve-modes phase drives, each on its own
#: request set ("prefix": 8 prompts behind a shared 64-token system prompt;
#: "serve": the serve phase's requests; "repeat": 8 prompts of a repeated
#: 8-token pattern, greedy; "twice", for the families phase: the "repeat"
#: prompts, each asked twice)
SERVE_MODES = (
    ("prefix cache", "prefix", dict(prefix_cache=True)),
    ("budgeted, 64 tokens", "serve", dict(max_batch_tokens=64)),
    ("speculation, n-gram", "repeat", dict(speculate=4)),
    ("speculation, model", "repeat",
     dict(speculate=4, spec_source="model")),
)


def mode_requests(cfg, kind: str, args, greedy=False) -> list:
    from repro_torch.serving import Request

    if kind == "serve":
        return serve_requests(cfg, args, greedy=greedy)
    rng = np.random.default_rng(SEED + 6)
    requests = []
    if kind == "prefix":
        system = rng.integers(2, cfg.vocab_size, 64).astype(np.int32)
        for rid in range(args["requests"]):
            tail = rng.integers(2, cfg.vocab_size,
                                int(rng.integers(4, 64))).astype(np.int32)
            requests.append(Request(
                rid=rid, prompt=np.concatenate([system, tail]),
                max_new_tokens=args["max_new"],
                temperature=0.0 if greedy else float(rid % 2) * 0.8))
    else:
        n = args["requests"]
        for rid in range(n):
            pattern = rng.integers(2, cfg.vocab_size, 8).astype(np.int32)
            requests.append(Request(
                rid=rid, prompt=np.tile(pattern, 3 + rid % 4),
                max_new_tokens=args["max_new"]))
        if kind == "twice":
            # each prompt asked again after it: with as many slots as
            # prompts the second wave starts once the first has finished,
            # whose sequences the cross-request n-gram index then holds
            requests += [Request(rid=n + q.rid, prompt=q.prompt,
                                 max_new_tokens=q.max_new_tokens)
                         for q in requests]
    return requests


def f32_lines(engine):
    """Swap the engine's empty bf16 KV pools for f32 ones.  Both packages
    hold bf16 lines whatever the compute dtype, so in f32 a suffix or
    chunk prefill reads the prefix rounded where a whole-prompt prefill
    attends its own f32 K/V: a different function.  f32 lines make every
    mode compute the classic engine's function, for the identity check."""
    engine.cache = {"layers": [{n: t.float() for n, t in layer.items()}
                               for layer in engine.cache["layers"]]}


def run_mode(cfg, params, args, kind: str, options: dict, greedy=False,
             device="cuda") -> dict:
    """One engine (paged, 16-line pages unless ``options`` says otherwise,
    the serve phase's slots, cache and decode chunk) with ``options`` on
    its request set, the launch counts set to 0 and the peak memory reset
    just before, both read just after.  With ``greedy`` (the identity
    check) the KV lines are f32 (:func:`f32_lines`)."""
    from repro_torch.kernels import ops
    from repro_torch.monitoring import MetricsRegistry
    from repro_torch.monitoring.metrics import (
        METRIC_SERVE_PREFIX_HITS, METRIC_SERVE_PREFIX_REUSED_TOKENS,
    )
    from repro_torch.serving import DecodeEngine

    requests = mode_requests(cfg, kind, args, greedy=greedy)
    metrics = MetricsRegistry()
    engine = DecodeEngine(cfg, params, num_slots=args["slots"],
                          cache_len=args["cache_len"], metrics=metrics,
                          seed=SEED, decode_chunk=args["decode_chunk"],
                          prefill_buckets="auto", device=device,
                          **{"kv_page_size": 16, **options})
    if greedy:
        f32_lines(engine)
    for r in requests:
        engine.submit(r)
    sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    engine.run_to_completion()
    sync(device)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    total = int(metrics.counter("serve_tokens_generated").value())
    pre = metrics.histogram("serve_prefill_seconds")
    dec = metrics.histogram("serve_decode_seconds")
    st = engine.spec_stats
    return {"requests": requests, "launches": launches, "wall_s": wall,
            "tokens": total, "tok_s": total / wall,
            "prefill_ms": pre.sum() / max(pre.count(), 1) * 1e3,
            "prefills": pre.count(),
            "decode_ms": dec.sum() / max(dec.count(), 1) * 1e3,
            "calls": dec.count(),
            "hits": int(metrics.counter(METRIC_SERVE_PREFIX_HITS).value()),
            "reused": int(metrics.counter(
                METRIC_SERVE_PREFIX_REUSED_TOKENS).value()),
            "chunks": engine.serve_stats["prefill_chunks"],
            "rounds": st["rounds"], "proposed": st["proposed"],
            "accepted": st["accepted"], "peak_gib": peak_gib(device),
            "buckets": engine.prefill_buckets,
            "outputs": [list(r.output) for r in requests]}


def check_run(cfg, label, r, args, device, must=(), never=()):
    """Gates of a serve run: every request finished with its token count,
    in the vocabulary; on the card each kernel of ``must`` launched and
    none of ``never``."""
    reqs = r["requests"]
    want = sum(q.max_new_tokens - 1 for q in reqs)
    if not all(q.done and len(q.output) == q.max_new_tokens
               for q in reqs) or r["tokens"] != want:
        raise AssertionError(f"{label}: expected {want} decode tokens "
                             f"and {args['max_new']} per request, got "
                             f"{r['tokens']}")
    if not all(0 <= t < cfg.vocab_size for q in reqs for t in q.output):
        raise AssertionError(f"{label}: token out of vocabulary")
    if torch.device(device).type != "cuda":
        return
    for name in must:
        if r["launches"][name] == 0:
            raise AssertionError(f"{label}: kernel {name} never launched")
    for name in never:
        if r["launches"][name]:
            raise AssertionError(f"{label}: kernel {name} launched "
                                 f"{r['launches'][name]} times on a path "
                                 "that has no kernel")


def serve_modes_phase(cfg, params, args, device="cuda") -> dict:
    """The engine's serving modes at full width: the prefix cache, the
    token-budgeted chunked prefill, and speculation from both draft
    sources.  Gates: every request finishes with its token count in the
    vocabulary; the kernels of each run's path launched; prefix hits,
    more chunks than requests, and verify rounds where the mode has
    them."""
    out = {}
    for label, kind, options in SERVE_MODES:
        r = run_mode(cfg, params, args, kind, options, device=device)
        reqs = r["requests"]
        rate = (f"{r['accepted'] / r['proposed']:.1%}" if r["proposed"]
                else "n/a")
        log(f"  {label}: {len(reqs)} requests, {r['tokens']} decode tokens "
            f"in {r['wall_s']:.3f} s = {r['tok_s']:.1f} tok/s; prefill "
            f"mean {r['prefill_ms']:.2f} ms over {r['prefills']}; decode "
            f"or verify call mean {r['decode_ms']:.2f} ms over "
            f"{r['calls']}; prefix hits {r['hits']}, reused tokens "
            f"{r['reused']}; chunks {r['chunks']}; verify rounds "
            f"{r['rounds']}, accepted {r['accepted']}/{r['proposed']} "
            f"({rate}); launches {r['launches']}")
        # the kernels each path runs: paged decode wherever decode_n runs,
        # prefill attention on the classic prefills of prefix misses, the
        # draft model's prefill and dense decode.  With the model draft
        # every round has proposals, so every token goes through verify
        # (plain products) and the paged decode kernel is not on its path
        if options.get("spec_source") == "model":
            used = ["flash_attention", "flash_decode"]
        elif kind == "prefix":
            used = ["flash_decode_paged", "flash_attention"]
        else:
            used = ["flash_decode_paged"]
        check_run(cfg, label, r, args, device, must=used)
        if "prefix_cache" in options and r["hits"] == 0:
            raise AssertionError(f"{label}: no prefix hit")
        if "max_batch_tokens" in options and r["chunks"] <= len(reqs):
            raise AssertionError(f"{label}: {r['chunks']} chunks for "
                                 f"{len(reqs)} requests")
        if "speculate" in options and r["rounds"] == 0:
            raise AssertionError(f"{label}: no verify round")
        out[label] = r
    return out


def plain_paths_phase(cfg, params, args) -> dict:
    """Device time of one call of each plain attention routine the serve
    modes add, at full width with layer 0's weights (the q/k/v/o
    projections included): the suffix prefill of a prefix hit (64-token
    bucket over a 4-page prefix row), a prefill chunk (32 tokens at a
    mid-page start over a pages_per_seq-wide row) and a verify call (every
    slot, k + 1 = 5 positions, a 16-page table).  The JAX package runs
    them as einsums outside any Pallas kernel; so does the port."""
    from repro_torch.models import attention as A

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    bf16 = torch.bfloat16
    p = {k: v[0] for k, v in params["layers"][0]["attn"].items()}
    ps, slots = 16, args["slots"]
    n_tab = args["cache_len"] // ps
    pool_shape = (slots * n_tab + 1, ps, cfg.num_kv_heads, cfg.head_dim)
    pool = {n: rand(gen, pool_shape, bf16) for n in ("k", "v")}
    perm = torch.randperm(pool_shape[0] - 1, generator=gen,
                          device="cuda") + 1
    rows = perm[:slots * n_tab].reshape(slots, n_tab).to(torch.int32)
    out = {}
    x = rand(gen, (1, 64, cfg.d_model), bf16)
    out["suffix prefill (64 tokens, 4-page prefix)"] = time_ms(
        lambda: A.attention_prefill_paged(p, x, pool, rows[:1, :4], 64, cfg))
    x = rand(gen, (1, 32, cfg.d_model), bf16)
    out[f"prefill chunk (32 tokens from line 40, {n_tab}-page row)"] = \
        time_ms(lambda: A.attention_prefill_paged(p, x, pool, rows[:1], 40,
                                                  cfg))
    S = 5
    x = rand(gen, (slots, S, cfg.d_model), bf16)
    pos0 = torch.full((slots,), 100, dtype=torch.int64, device="cuda")
    lines = pos0[:, None] + torch.arange(S, device="cuda")
    pages = rows.to(torch.int64).gather(1, lines // ps)
    offs = lines % ps
    out[f"verify ({slots} slots x {S} positions, 16-page table)"] = \
        time_ms(lambda: A.attention_verify(p, x, pool, pos0, pages, offs,
                                           rows[:, :16], cfg))
    for name, ms in out.items():
        log(f"  plain {name}: {ms:.4f} ms a call (device time)")
    return out


def last_logits(params, cfg, toks, use_kernels: bool, engine=None):
    """f32 numpy logits at the last position of a prefill of ``toks``
    ((1, S) int32 on the device): through ``params``, or through a TP
    engine's shard of them under its reduction scope."""
    from repro_torch.configs import RunConfig
    from repro_torch.models.model import prefill

    scope = (engine.tp_scope() if engine is not None
             else contextlib.nullcontext())
    with torch.no_grad(), scope:
        logits, _ = prefill(params, {"tokens": toks}, cfg,
                            RunConfig(use_kernels=use_kernels))
    return logits[0, -1].float().cpu().numpy()


def first_difference(a, b):
    return next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)


def top2_gap(cfg, params, prompt, prefix_out, device="cuda") -> float:
    """The top-2 logit gap of the next token after ``prompt`` +
    ``prefix_out``, from a prefill of that context (the classic run's
    logits at that token, up to the prefill/decode summation order)."""
    toks = np.concatenate([prompt, np.asarray(prefix_out, np.int32)])
    top = np.sort(last_logits(params, cfg, torch.from_numpy(
        toks.astype(np.int32)).to(device)[None], True))[-2:]
    return float(top[1] - top[0])


def identity_phase(cfg, args, device="cuda") -> dict:
    """Greedy identity of the four modes with the classic paged engine,
    at full width in f32 with the depth cut to 4 layers: token for token
    on each request set.  A difference passes only as a tie: the classic
    run's top-2 logit gap at the first differing token below 1e-4.  The
    KV lines are f32 (:func:`f32_lines`)."""
    from repro_torch.models import init_params
    from repro_torch.models.model import cast_for_compute

    c4 = dataclasses.replace(cfg, num_layers=4, dtype="float32")
    params = cast_for_compute(init_params(c4, SEED, device), torch.float32)
    refs, launches, ties = {}, {}, 0
    for label, kind, options in SERVE_MODES:
        if kind not in refs:
            refs[kind] = run_mode(c4, params, args, kind, {}, greedy=True,
                                  device=device)
            for k, n in refs[kind]["launches"].items():
                launches[k] = launches.get(k, 0) + n
        ref = refs[kind]
        r = run_mode(c4, params, args, kind, options, greedy=True,
                     device=device)
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
        same = 0
        for q, a, b in zip(r["requests"], ref["outputs"], r["outputs"]):
            if a == b:
                same += 1
                continue
            j = first_difference(a, b)
            gap = top2_gap(c4, params, q.prompt, a[:j], device)
            log(f"  {label}: request {q.rid} differs at token {j} "
                f"({a[j]} classic, {b[j]} here); classic top-2 gap "
                f"{gap:.3e}")
            if gap >= 1e-4:
                raise AssertionError(f"identity: {label} request {q.rid} "
                                     f"differs at token {j} with a top-2 "
                                     f"gap of {gap}")
            ties += 1
        log(f"  {label}: {same}/{len(ref['outputs'])} requests token for "
            f"token equal to the classic paged engine's; {r['tok_s']:.1f} "
            f"tok/s (classic {ref['tok_s']:.1f}); verify rounds "
            f"{r['rounds']}, accepted {r['accepted']}/{r['proposed']}")
    log(f"  ties (classic top-2 gap < 1e-4 at the first difference): "
        f"{ties}; launches {launches} (a check in f32 at 4 layers, not the "
        "main path: not in the kernels line)")
    return {"launches": launches, "ties": ties}


def device_busy(prof) -> tuple:
    """A trace's device kernels: (the union of their intervals in ms, the
    (start, end, name) spans, device microseconds by kernel name)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    by_name: dict = {}
    for s, e, name in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    return busy_us / 1e3, spans, by_name


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
    busy_ms, spans, by_name = device_busy(prof)
    device_part = (
        f"device busy {busy_ms:.2f} ms ({busy_ms / wall_ms:.1%}), "
        f"{len(spans)} device kernels ({len(spans) / chunk:.0f} per token "
        "step)" if spans else
        "device time not measured (the trace holds no device events)")
    log(f"  profile ({cfg.name}): one {kind} decode chunk ({chunk} tokens x "
        f"{args['slots']} slots, ~{int(engine.pos.mean())} live lines): wall "
        f"{wall_ms:.2f} ms, {device_part}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
        log(f"    {us / 1e3:8.3f} ms  {name[:100]}")
    # one engine uses one of the two decode launches: every decode kernel
    # in this trace is `kernel`
    decode = [(n, us) for n, us in by_name.items() if "decode_kernel" in n]
    step_ms = None
    if spans and decode:
        us = sum(us for _, us in decode)
        n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                and "decode_kernel" in e.name)
        step_ms = us / 1e3 / chunk
        log(f"  {kernel} in the trace: {n} launches, {us / 1e3:.3f} ms = "
            f"{step_ms:.3f} ms of device time per token step; device busy "
            f"{busy_ms / chunk:.3f} ms per token step")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "kernels": len(spans),
            "decode_ms_per_step": step_ms}


# --------------------------------------------------------- decode graphs ----

#: the graph check's engines: a deployment's 128 slots, a cache short
#: enough to copy at every chunk, 16-line pages where the config pages
GRAPH_ARGS = dict(slots=128, cache_len=256, decode_chunk=8)
#: the sampling check: calls a side (a token a lane each), the lanes'
#: temperature, and the chi-square bound on 10 bins of near-equal mass
#: (9 degrees of freedom, p = 0.001)
GRAPH_DRAW_CALLS, GRAPH_TEMP, GRAPH_CHI2 = 40, 0.8, 27.88


def _tree_copy(tree):
    if isinstance(tree, dict):
        return {k: _tree_copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_copy(v) for v in tree]
    return tree.clone()


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def graphs_checked(engine_module, stats: dict, paged: bool):
    """Wrap the engine's ``decode_n``: each call runs as the engine makes
    it (graphed on the card), then eager ``decode_n`` runs on a copy of
    the state taken before it (the cache, the generator's state); both
    are timed to a synchronize.  Tokens, lanes and cache must be
    bit-identical (the paged pool but its null page, which every dead
    lane writes in no fixed order and nothing reads unmasked).  Returns
    the undo."""
    real = engine_module.decode_n

    def checked(params, cache, *a, page_table=None, limit=None,
                graphs=None):
        gen, n = a[6], a[9]
        copy = _tree_copy(cache)
        twin = torch.Generator(device=gen.device)
        twin.set_state(gen.get_state())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(params, cache, *a, page_table=page_table, limit=limit,
                   graphs=graphs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = real(params, copy, *a[:6], twin, *a[7:],
                   page_table=page_table, limit=limit)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        same = all(torch.equal(x, y) for x, y in zip(
            (out[0], *out[2:]), (ref[0], *ref[2:])))
        for x, y in zip(_tree_leaves(cache), _tree_leaves(copy)):
            if paged:
                x, y = x[:, 1:], y[:, 1:]
            same = same and torch.equal(x, y)
        if not same:
            raise AssertionError(
                f"decode graphs: call {stats['calls']} (width "
                f"{None if page_table is None else page_table.shape[1]}) "
                "differs from eager decode_n on a copy of its state")
        stats["calls"] += 1
        stats["widths"].add(None if page_table is None
                            else int(page_table.shape[1]))
        if graphs is not None and graphs.replayed == n:
            stats["replay_calls"] += 1
            stats["graph_ms"] += 1e3 * (t1 - t0) / n
            stats["eager_ms"] += 1e3 * (t2 - t1) / n
        return out

    engine_module.decode_n = checked
    return lambda: setattr(engine_module, "decode_n", real)


def graph_engine_check(cfg, params, paged: bool, max_new: int,
                       device="cuda") -> dict:
    """An engine on :data:`GRAPH_ARGS` serving 128 greedy requests (prompts
    of 20-40 tokens, ``max_new`` tokens each) with every ``decode_n`` call
    held to eager on a copy of its state (:func:`graphs_checked`); then
    the graphs' pool: the memory the card keeps reserved while they live,
    after ``empty_cache``, less what it keeps once they are freed."""
    import repro_torch.serving.engine as engine_module
    from repro_torch.monitoring import MetricsRegistry
    from repro_torch.monitoring.metrics import (
        METRIC_SERVE_DECODE_EAGER_STEPS, METRIC_SERVE_DECODE_GRAPH_CAPTURES,
        METRIC_SERVE_DECODE_GRAPH_REPLAYS,
    )
    from repro_torch.serving import DecodeEngine, Request

    a = GRAPH_ARGS
    metrics = MetricsRegistry()
    engine = DecodeEngine(cfg, params, num_slots=a["slots"],
                          cache_len=a["cache_len"], metrics=metrics,
                          seed=SEED, decode_chunk=a["decode_chunk"],
                          prefill_buckets="auto",
                          kv_page_size=16 if paged else 0, device=device)
    rng = np.random.default_rng(SEED + 3)
    requests = [Request(rid=i, prompt=rng.integers(
        2, cfg.vocab_size, int(rng.integers(20, 41))).astype(np.int32),
        max_new_tokens=max_new) for i in range(a["slots"])]
    stats = {"calls": 0, "widths": set(), "replay_calls": 0,
             "graph_ms": 0.0, "eager_ms": 0.0}
    undo = graphs_checked(engine_module, stats, paged)
    try:
        for r in requests:
            engine.submit(r)
        engine.run_to_completion()
    finally:
        undo()
    if not all(r.done and len(r.output) == max_new for r in requests):
        raise AssertionError(f"decode graphs ({cfg.name}): a request came "
                             "back short")
    count = {k: int(metrics.counter(name).value()) for k, name in (
        ("captures", METRIC_SERVE_DECODE_GRAPH_CAPTURES),
        ("replays", METRIC_SERVE_DECODE_GRAPH_REPLAYS),
        ("eager", METRIC_SERVE_DECODE_EAGER_STEPS))}
    widths = sorted(stats["widths"], key=lambda w: -1 if w is None else w)
    if count["captures"] != len(widths) or stats["calls"] < 4 or \
            (paged and len(widths) < 2):
        raise AssertionError(
            f"decode graphs ({cfg.name}): {count['captures']} captures "
            f"over {stats['calls']} calls at widths {widths}; want one a "
            "width, >= 4 calls and, paged, a width change")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    engine.graphs = None
    gc.collect()
    torch.cuda.empty_cache()
    pool = held - torch.cuda.memory_reserved()
    share = count["replays"] / max(count["replays"] + count["eager"], 1)
    k = max(stats["replay_calls"], 1)
    log(f"  decode graphs, {cfg.name} ({'paged' if paged else 'dense'}, "
        f"{a['slots']} slots, greedy): {stats['calls']} decode_n calls at "
        f"widths {widths} bit-identical to eager decode_n on a copy of "
        f"their state (tokens, lanes, cache); captures {count['captures']}"
        f", replayed {count['replays']} of "
        f"{count['replays'] + count['eager']} token steps ({share:.1%}); a "
        f"token step of a replay-only call {stats['graph_ms'] / k:.2f} ms "
        f"graphed against {stats['eager_ms'] / k:.2f} ms eager (to a "
        f"synchronize, {stats['replay_calls']} calls); graph pool "
        f"{pool / 2**20:.1f} MiB")
    del engine
    return dict(count, calls=stats["calls"], widths=widths, pool=pool,
                share=share, graph_ms=stats["graph_ms"] / k,
                eager_ms=stats["eager_ms"] / k)


def graph_sampling_check(cfg, params, device="cuda") -> dict:
    """128 lanes that read the same pages at one position (so the same
    logits) sample at :data:`GRAPH_TEMP`, one token a ``decode_n`` call:
    :data:`GRAPH_DRAW_CALLS` calls replayed from a graph, then as many
    eager ones from the generator's state before them.  Consecutive
    replays must draw different tokens, and each side's draws, binned by
    the rank of their probability into 10 bins of near-equal mass, must
    fit the softmax (chi-square under :data:`GRAPH_CHI2`), as must the
    two sides against each other.  Then the profiler must name the paged
    decode kernel in two replays, once a layer each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import RunConfig
    from repro_torch.models.model import (
        DecodeGraphs, decode_n, decode_step, init_cache,
    )
    from repro_torch.models.paging import PagedKVConfig

    B, ps, pages, pos0 = GRAPH_ARGS["slots"], 16, 4, 40
    lines = ps * pages
    cache = init_cache(cfg, B, lines, device=device, paging=PagedKVConfig(
        page_size=ps, num_pages=1 + pages, pages_per_seq=pages))
    g = torch.Generator(device=device).manual_seed(SEED)
    for t in _tree_leaves(cache):
        t.normal_(generator=g)
    i32 = dict(dtype=torch.int32, device=device)
    table = torch.arange(1, pages + 1, **i32).repeat(B, 1)
    lanes = (torch.full((B,), 7, **i32), torch.full((B,), pos0, **i32),
             torch.full((B,), 10_000, **i32),
             torch.zeros(B, dtype=torch.bool, device=device),
             torch.full((B,), -1, **i32),
             torch.full((B,), GRAPH_TEMP, dtype=torch.float32,
                        device=device))
    limit = torch.full((B,), lines, **i32)
    run = RunConfig(use_kernels=True)
    store = DecodeGraphs()

    def draws(graphs, gen, calls):
        out = []
        with torch.no_grad():
            for _ in range(calls):
                toks, *_ = decode_n(params, cache, *lanes, gen, cfg, run, 1,
                                    lines, page_table=table, limit=limit,
                                    graphs=graphs)
                out.append(toks[:, 0])
        return torch.stack(out)

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    draws(store, gen, 1)                   # the capture (its step eager)
    state = gen.get_state()
    graphed = draws(store, gen, GRAPH_DRAW_CALLS)
    twin = torch.Generator(device=device)
    twin.set_state(state)
    eager = draws(None, twin, GRAPH_DRAW_CALLS)
    same_state = torch.equal(gen.get_state(), twin.get_state())
    with torch.no_grad():
        logits, _ = decode_step(params, cache, lanes[0][:, None], lanes[1],
                                cfg, run, page_table=table)
    spread = float((logits[:, 0] - logits[:1, 0]).abs().max())
    p = torch.softmax(logits[0, 0].float() / GRAPH_TEMP, dim=-1)
    order = torch.argsort(p, descending=True)
    before = torch.cumsum(p[order], 0) - p[order]
    rank_bin = torch.clamp((before * 10).floor().long(), max=9)
    bin_of = torch.empty_like(rank_bin)
    bin_of[order] = rank_bin
    mass = torch.zeros(10, device=device).index_add_(0, rank_bin, p[order])
    n = graphed.numel()

    def counts(x):
        return torch.bincount(bin_of[x.flatten().long()],
                              minlength=10).float()

    def chi2(c, want):
        keep = want > 0
        return float(((c - want)[keep] ** 2 / want[keep]).sum())

    cg, ce = counts(graphed), counts(eager)
    stats = {"graph": chi2(cg, n * mass), "eager": chi2(ce, n * mass),
             "two_sample": chi2(cg, (cg + ce) / 2) + chi2(ce, (cg + ce) / 2)}
    repeats = sum(bool(torch.equal(graphed[i], graphed[i + 1]))
                  for i in range(len(graphed) - 1))
    bits = float((graphed == eager).float().mean())
    sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        draws(store, gen, 2)
        sync(device)
    named = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                and "split_decode_kernel" in e.name)
    log(f"  decode graphs, sampling at T {GRAPH_TEMP} ({B} lanes, same "
        f"logits): {n} draws a side; chi-square (10 bins, bound "
        f"{GRAPH_CHI2}) graphed {stats['graph']:.2f}, eager "
        f"{stats['eager']:.2f}, graphed vs eager {stats['two_sample']:.2f}; "
        f"consecutive replays with equal draws {repeats} of "
        f"{len(graphed) - 1}; lanes' logits apart by at most {spread:.3g}; "
        f"draws equal bit for bit {bits:.1%}; generator "
        f"state after the replays {'equal' if same_state else 'unequal'} "
        f"to eager's; profiler: {named} split_decode_kernel ops in 2 "
        f"replays ({cfg.num_layers} layers each)")
    if repeats or max(stats.values()) > GRAPH_CHI2:
        raise AssertionError("decode graphs: replays repeat their noise or "
                             "their draws do not fit the distribution")
    return dict(stats, repeats=repeats, bits=bits, same_state=same_state,
                named=named, want_named=2 * cfg.num_layers)


def graph_phase(cfg, params, device="cuda") -> dict:
    """Phase 4's check of the decode graphs: full-width ``cfg``
    (stablelm-3b, bf16 ``params``) paged and greedy against eager, its
    sampling, then full-width mamba2-780m (dense SSM state) greedy."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.model import cast_for_compute

    out = {"paged": graph_engine_check(cfg, params, True, 49, device),
           "sampling": graph_sampling_check(cfg, params, device)}
    torch.cuda.empty_cache()
    scfg = get_config("mamba2-780m")
    sparams = cast_for_compute(init_params(scfg, SEED, device),
                               torch.bfloat16)
    out["ssm"] = graph_engine_check(scfg, sparams, False, 33, device)
    del sparams
    torch.cuda.empty_cache()
    samp = out["sampling"]
    if samp["named"] != samp["want_named"]:
        raise AssertionError("decode graphs: the profiler does not name "
                             "the paged decode kernel in a replay")
    return out


def route_logits(cfg, params, toks, use_kernels: bool, steps: int,
                 device="cuda") -> torch.Tensor:
    """Logits of one prompt's prefill (its last position) and of
    ``steps`` teacher-forced decode steps after it, (steps + 1, vocab) in
    f32.  Every leaf of the prefill's cache (attention K/V lines, SSM
    state and conv window) goes into a fresh 256-line cache first, as the
    engine's ``_insert_dense`` does."""
    from repro_torch.configs import RunConfig
    from repro_torch.models.model import decode_step, init_cache, prefill

    P = toks.shape[1]
    run = RunConfig(use_kernels=use_kernels)
    with torch.no_grad():
        logits, c1 = prefill(params, {"tokens": toks}, cfg, run,
                             cache_len=256)
        cache = init_cache(cfg, 1, 256, device=device)
        for dst, src in zip(cache["layers"], c1["layers"]):
            for name, leaf in src.items():
                dst[name][:, 0, :leaf.shape[2]].copy_(leaf[:, 0])
        seq = [logits[0, -1].float()]
        for s in range(steps):
            # teacher-forced: every route feeds the same tokens
            tok = torch.full((1, 1), 11 + 7 * s, dtype=torch.int32,
                             device=device)
            lg, cache = decode_step(params, cache, tok,
                                    torch.tensor([P + s], device=device),
                                    cfg, run)
            seq.append(lg[0, -1].float())
    out = torch.stack(seq)
    if not bool(torch.isfinite(out).all()) or out.shape != (
            steps + 1, cfg.vocab_size):
        raise AssertionError(f"consistency: {cfg.name} logits not finite "
                             f"or of shape {tuple(out.shape)}")
    return out


def consistency_prompt(cfg, device, P=77) -> torch.Tensor:
    rng = np.random.default_rng(SEED + 1)
    return torch.from_numpy(rng.integers(2, cfg.vocab_size, P).astype(
        np.int32)).to(device)[None]


def consistency_phase(cfg, params, device="cuda", steps=3) -> dict:
    """Prefill logits and ``steps`` decode steps of one request through
    the kernels against the plain versions, both in bf16, with an f32 run
    of the same (bf16-valued) weights as the yardstick (cast at each use,
    as the model casts them: no f32 copy of the weights).  The kernel
    route must stay within 0.05 + 2x the plain route's own distance from
    the f32 run.  Every route's logits must be finite."""
    toks = consistency_prompt(cfg, device)
    f32cfg = dataclasses.replace(cfg, dtype="float32")
    runs = {name: route_logits(c, params, toks, use_k, steps, device)
            for name, c, use_k in (("kernels", cfg, True),
                                   ("plain", cfg, False),
                                   ("f32", f32cfg, False))}
    d_kp = max_err(runs["kernels"], runs["plain"])
    d_k32 = max_err(runs["kernels"], runs["f32"])
    d_p32 = max_err(runs["plain"], runs["f32"])
    tol = 0.05 + 2 * d_p32
    scale = float(runs["f32"].abs().max())
    log(f"  {cfg.name}: prefill + {steps} decode steps, logits max|f32| "
        f"{scale:.3f}: "
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


def f32_consistency_phase(cfg, device="cuda", layers=4, steps=4) -> dict:
    """The kernels against the plain versions in f32 compute with the
    depth cut to ``layers`` (f32 weights of the seed): one request's
    prefill and ``steps`` decode steps, |kernels - plain| held to
    ``F32_LOGIT_TOL`` of the logits' scale.  For a model whose bf16
    routes can part at a router's top-k (MoE), where the bf16 check of
    :func:`consistency_phase` cannot tell a wrong kernel from a flip."""
    from repro_torch.kernels import ops
    from repro_torch.models import init_params

    c = dataclasses.replace(cfg, num_layers=layers, dtype="float32")
    params = init_params(c, SEED, device)
    toks = consistency_prompt(c, device)
    ops.reset_launch_counts()
    kern = route_logits(c, params, toks, True, steps, device)
    launches = ops.launch_counts()
    plain = route_logits(c, params, toks, False, steps, device)
    del params
    d = max_err(kern, plain)
    scale = float(plain.abs().max())
    tol = F32_LOGIT_TOL * scale
    argmax_same = bool((kern.argmax(-1) == plain.argmax(-1)).all())
    log(f"  {cfg.name}, f32, {layers} layers: prefill + {steps} decode "
        f"steps, logits max|plain| {scale:.3f}: |kernels - plain| "
        f"{d:.3e} (tol {tol:.3e}); argmax agrees at every step: "
        f"{argmax_same}; launches {launches} (a check, not the main path)")
    if torch.device(device).type == "cuda":
        for name in ("flash_attention", "flash_decode"):
            if launches[name] == 0:
                raise AssertionError(f"f32 consistency: {name} never "
                                     "launched on the kernel route")
    if d > tol:
        raise AssertionError(f"f32 consistency: {cfg.name} kernel route "
                             f"{d} from the plain route, tolerance {tol}")
    return {"kernels_vs_plain": d, "tol": tol, "argmax_same": argmax_same}


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
    trainer = Trainer(cfg, run, None, InputShape("smoke", S, B, "train"),
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


# ------------------------------------------------------------- families ----

def peak_gib(device) -> float:
    if torch.device(device).type != "cuda":
        return float("nan")
    return torch.cuda.max_memory_allocated() / 2**30


def family_run(cfg, params, args, kind, label, device="cuda", must=(),
               never=(), **options) -> dict:
    """One run of the families phase: :func:`run_mode` on the ``kind``
    requests with ``options`` (dense unless they page), logged, with
    :func:`check_run`'s gates."""
    r = dict(run_mode(cfg, params, args, kind,
                      {"kv_page_size": 0, **options}, device=device),
             label=label)
    log(f"  {label}: {len(r['requests'])} requests, {r['tokens']} decode "
        f"tokens in {r['wall_s']:.3f} s = {r['tok_s']:.1f} tok/s; prefill "
        f"mean {r['prefill_ms']:.2f} ms over {r['prefills']}; decode or "
        f"verify call mean {r['decode_ms']:.2f} ms over {r['calls']}; "
        f"verify rounds {r['rounds']}, accepted {r['accepted']}/"
        f"{r['proposed']}; prefill buckets {r['buckets']}; peak "
        f"{r['peak_gib']:.2f} GiB (max_memory_allocated); launches "
        f"{r['launches']}")
    check_run(cfg, label, r, args, device, must=must, never=never)
    return r


def ssm_bucket_identity(cfg, args, device="cuda", layers=4) -> dict:
    """Greedy tokens of front-padded bucketed prefill against exact
    prefill for an SSM config, in f32 with the depth cut to ``layers``:
    the plain route (``use_kernels=False``, so the engine takes the front
    pad) with the single bucket ``cache_len``, whose prompts of at most
    ``cache_len - chunk`` tokens get a chunk-aligned front pad ``f > 0``.
    A difference passes only as a tie: the exact run's top-2 logit gap at
    the first differing token below 1e-4."""
    from repro_torch.configs import RunConfig
    from repro_torch.models import init_params
    from repro_torch.models.model import cast_for_compute

    c = dataclasses.replace(cfg, num_layers=layers, dtype="float32")
    params = cast_for_compute(init_params(c, SEED, device), torch.float32)
    from repro_torch.serving import DecodeEngine

    run = RunConfig(use_kernels=False)
    outs = {}
    for kind, buckets in (("exact", None), ("bucketed", (args["cache_len"],))):
        reqs = serve_requests(c, args, greedy=True)
        eng = DecodeEngine(c, params, num_slots=args["slots"],
                           cache_len=args["cache_len"], seed=SEED,
                           decode_chunk=args["decode_chunk"], run=run,
                           prefill_buckets=buckets, device=device)
        if (buckets is not None) != eng._front_pad:
            raise AssertionError(f"{cfg.name}: the {kind} engine did not "
                                 "take the front pad it should")
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        outs[kind] = (reqs, [list(r.output) for r in reqs])
    Q, L = cfg.ssm.chunk, args["cache_len"]
    pads = [((L - len(r.prompt)) // Q) * Q for r in outs["exact"][0]]
    same = ties = 0
    for q, a, b in zip(outs["exact"][0], outs["exact"][1],
                       outs["bucketed"][1]):
        if a == b:
            same += 1
            continue
        j = first_difference(a, b)
        gap = top2_gap(c, params, q.prompt, a[:j], device)
        log(f"  request {q.rid} differs at token {j} ({a[j]} exact, {b[j]} "
            f"bucketed); exact top-2 gap {gap:.3e}")
        if gap >= 1e-4:
            raise AssertionError(f"{cfg.name}: bucketed prefill differs "
                                 f"from exact at request {q.rid} token {j} "
                                 f"with a top-2 gap of {gap}")
        ties += 1
    log(f"  f32, {layers} layers: {same}/{len(pads)} requests token for "
        f"token equal, bucketed (front pads {pads}) against exact; ties "
        f"{ties}")
    if not any(pads):
        raise AssertionError(f"{cfg.name}: no request took a front pad")
    return {"same": same, "ties": ties, "pads": pads}


def families_phase(args, device="cuda", reduced=False) -> dict:
    """The other model families through the serving engine, at full
    width (``reduced``: the reduced configs, for a rehearsal on the CPU):
    SSM serving of mamba2-780m (the SSD decode-step kernel the one
    kernel on its path; then its f32
    bucketed-vs-exact check), MoE serving of qwen2-moe-a2.7b (dense,
    16-line pages, n-gram speculation over two waves; then the kernels
    against the plain versions on one request in f32 at 4 layers) and
    starcoder2-3b (24 query heads over 2 kv heads); each model through
    :func:`consistency_phase`.  Returns the runs, whose launches are
    main-path launches."""
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.models import init_params
    from repro_torch.models.model import cast_for_compute

    get = get_reduced_config if reduced else get_config
    attn = ("flash_attention", "flash_decode", "flash_decode_paged")
    runs, profiles = [], {}
    # the cluster phase's trainer sits in a reference cycle (its wrapped
    # save): collect it before measuring what these models hold
    gc.collect()
    empty_cache(device)
    if torch.device(device).type == "cuda":
        log(f"  resident before the phase: "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    def describe(cfg):
        return (f"{cfg.name} ({cfg.param_count() / 1e9:.3f} B params, "
                f"{cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
                f"{cfg.vocab_size})")

    # ---- SSM: mamba2-780m, f32 weights, bf16 compute
    cfg = get("mamba2-780m")
    log(f"  {describe(cfg)}: f32 weights seed {SEED}, bf16 compute, "
        f"{args['slots']} slots, cache {args['cache_len']}, dense cache")
    params = init_params(cfg, SEED, device)
    runs.append(family_run(cfg, params, args, "serve", f"{cfg.name} dense",
                           device, must=("ssd_decode_step",),
                           never=attn + ("ssd_scan",)))
    profiles[cfg.name] = profile_phase(cfg, params, args, False, device)
    cons = {cfg.name: consistency_phase(
        cfg, cast_for_compute(params, torch.bfloat16), device, steps=4)}
    del params
    empty_cache(device)
    ident = ssm_bucket_identity(cfg, args, device)
    empty_cache(device)

    # ---- MoE: qwen2-moe-a2.7b, built in bf16 (f32 and a bf16 copy would
    # not both fit): the same numbers as f32 weights cast once
    cfg = get("qwen2-moe-a2.7b")
    bcfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    moe = cfg.moe
    log(f"  {describe(cfg)}: {moe.num_experts} experts top-{moe.top_k} + "
        f"{moe.num_shared} shared, {cfg.num_heads} heads of "
        f"{cfg.head_dim}; bf16 weights seed {SEED}")
    params = init_params(bcfg, SEED, device)
    sync(device)
    if torch.device(device).type == "cuda":
        log(f"  params {torch.cuda.memory_allocated() / 2**30:.2f} GiB on "
            "the card")
    k = 4
    for label, options, must in (
            ("dense", {}, ("flash_attention", "flash_decode")),
            ("paged (16-line pages)", dict(kv_page_size=16),
             ("flash_attention", "flash_decode_paged")),
            (f"speculation, n-gram, k {k}",
             dict(kv_page_size=16, speculate=k),
             ("flash_attention", "flash_decode_paged"))):
        kind = "twice" if "speculate" in options else "serve"
        r = family_run(cfg, params, args, kind, f"{cfg.name} {label}",
                       device, must=must, never=("ssd_scan",), **options)
        # the second wave's requests draft from the first wave's
        # sequences: at least one round of k proposals each
        second = len(r["requests"]) // 2
        if "speculate" in options and (r["rounds"] < second
                                       or r["proposed"] < second * k):
            raise AssertionError(
                f"{cfg.name} {label}: {r['rounds']} verify rounds, "
                f"{r['proposed']} proposals; the second wave of {second} "
                f"requests needs at least {second} and {second * k}")
        runs.append(r)
    profiles[cfg.name] = profile_phase(cfg, params, args, False, device)
    cons[cfg.name] = consistency_phase(cfg, params, device, steps=4)
    del params
    empty_cache(device)
    cons[f"{cfg.name} f32"] = f32_consistency_phase(cfg, device)
    empty_cache(device)

    # ---- dense GQA: starcoder2-3b, 24 query heads over 2 kv heads
    cfg = get("starcoder2-3b")
    log(f"  {describe(cfg)}: {cfg.num_heads} q heads over "
        f"{cfg.num_kv_heads} kv heads of {cfg.head_dim}, {cfg.mlp_type}, "
        f"qkv bias; bf16 weights seed {SEED}")
    params = init_params(dataclasses.replace(cfg, param_dtype="bfloat16"),
                         SEED, device)
    runs.append(family_run(cfg, params, args, "serve", f"{cfg.name} dense",
                           device, must=("flash_attention", "flash_decode"),
                           never=("ssd_scan",)))
    cons[cfg.name] = consistency_phase(cfg, params, device, steps=4)
    del params
    empty_cache(device)
    return {"runs": runs, "identity": ident, "consistency": cons,
            "profiles": profiles}


def empty_cache(device):
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


# -------------------------------------------------------------- elastic ----

#: the elastic phase's bf16 runs: a label and the serve CLI's flags (every
#: run also gets the phase's slots, cache, decode chunk, new tokens, two
#: waves and the seed).  Run 1 pages as runs 3-5 do, so that their peak
#: memory differs by the KV pools alone; run 5 round-robins, so that the
#: drained replica holds requests whatever the hash ring says
ELASTIC_RUNS = (
    ("1 replica, paged, prefix cache",
     ["--replicas", "1", "--kv-paging", "16", "--prefix-cache"]),
    ("2 replicas, rr, dense", ["--replicas", "2"]),
    ("2 replicas, affinity, paged, prefix cache",
     ["--replicas", "2", "--affinity", "--kv-paging", "16",
      "--prefix-cache"]),
    ("2 replicas, rr, paged, prefix cache",
     ["--replicas", "2", "--kv-paging", "16", "--prefix-cache"]),
    ("autoscale 1-2 replicas, rr, paged, prefix cache",
     ["--replicas", "2", "--autoscale", "--kv-paging", "16",
      "--prefix-cache"]),
)


def elastic_requests(cfg, args, greedy=False) -> list:
    """The elastic phase's requests: ``args["requests"]`` prompts, each one
    of two 64-token system prompts in turn plus a tail of 4-63 tokens, from
    the seed; greedy and temperature 0.8 in turn (all greedy with
    ``greedy``)."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(SEED + 8)
    systems = [rng.integers(2, cfg.vocab_size, 64).astype(np.int32)
               for _ in range(2)]
    requests = []
    for rid in range(args["requests"]):
        tail = rng.integers(2, cfg.vocab_size,
                            int(rng.integers(4, 64))).astype(np.int32)
        requests.append(Request(
            rid=rid, prompt=np.concatenate([systems[rid % 2], tail]),
            max_new_tokens=args["max_new"],
            temperature=0.0 if greedy else float(rid % 2) * 0.8))
    return requests


def elastic_cli(args, flags, device):
    """The serve CLI's parsed arguments for one elastic run."""
    from repro_torch.launch import serve

    return serve.build_parser().parse_args(
        ["--slots", str(args["slots"]), "--cache-len", str(args["cache_len"]),
         "--decode-chunk", str(args["decode_chunk"]), "--max-new",
         str(args["max_new"]), "--bursts", "2", "--seed", str(SEED),
         "--device", str(device), *flags])


def tree_gib(tree) -> float:
    """The tensors of a nested dict/list tree, GiB."""
    if isinstance(tree, dict):
        return sum(tree_gib(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_gib(v) for v in tree)
    return tree.numel() * tree.element_size() / 2**30


def kv_gib(engine) -> float:
    """The engine's KV cache (its pool when paged), GiB."""
    return tree_gib(engine.cache)


def elastic_run(cfg, params, args, label, flags, device="cuda") -> dict:
    """One elastic run through the serve CLI's own functions
    (``elastic_factory``, ``start_elastic``, ``run_waves``): the replicas
    share ``params``; the peak memory is reset before the router is built
    and the launch counts just before the waves, both read after them.
    Logged, and held to :func:`check_run`'s gates."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.monitoring import MetricsRegistry
    from repro_torch.monitoring.metrics import (
        METRIC_SERVE_PREFIX_HITS, METRIC_SERVE_PREFIX_REUSED_TOKENS,
    )

    cli = elastic_cli(args, flags, device)
    paging = serve.resolve_paging(cli)
    requests = elastic_requests(cfg, args)
    metrics = MetricsRegistry()
    gc.collect()              # the last run's engines sit in ref cycles
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    router, scaler, cluster = serve.start_elastic(
        cli, serve.elastic_factory(cli, cfg, params, metrics, paging,
                                   torch.device(device)),
        metrics, {"default": 1})
    pool = kv_gib(next(iter(router.replicas.values())).engine)
    # what each drained replica held: (request, its output at the drain)
    moved = []
    remove = router.remove_replica

    def remove_replica(rid):
        eng = router.replicas[rid].engine
        moved.extend((q, list(q.output)) for q in eng.slots if q is not None)
        return remove(rid)

    router.remove_replica = remove_replica
    sync(device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    serve.run_waves(cli, router, requests, scaler, cluster)
    sync(device)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    total = int(metrics.counter("serve_tokens_generated").value())
    busy = max(router.busy_seconds().values())
    r = {"label": label, "requests": requests, "launches": launches,
         "wall_s": wall, "tokens": total, "tok_s": total / wall,
         "busy_tok_s": total / busy, "stats": dict(router.stats),
         "hits": int(metrics.counter(METRIC_SERVE_PREFIX_HITS).value()),
         "reused": int(metrics.counter(
             METRIC_SERVE_PREFIX_REUSED_TOKENS).value()),
         "peak_gib": peak_gib(device), "pool_gib": pool, "moved": moved,
         "replicas": len(router.replicas),
         "scaler": dict(scaler.stats) if scaler is not None else None}
    st = r["stats"]
    log(f"  {label}: {len(requests)} requests, {total} decode tokens in "
        f"{wall:.3f} s = {r['tok_s']:.1f} tok/s wall, "
        f"{r['busy_tok_s']:.1f} tok/s over the busiest replica's "
        f"{busy:.3f} busy s; router routed {st['routed']}, affinity hits "
        f"{st['affinity_hits']}, spills {st['spills']}, drains "
        f"{st['drains']}, resubmitted {st['resubmitted']}; prefix hits "
        f"{r['hits']}, reused tokens {r['reused']}; KV {pool:.3f} GiB a "
        f"replica; peak {r['peak_gib']:.2f} GiB (max_memory_allocated); "
        f"launches {launches}")
    check_run(cfg, label, r, args, device, must=(
        "flash_attention", "flash_decode_paged" if paging
        else "flash_decode"))
    return r


def elastic_identity(cfg, args, device="cuda", layers=4) -> dict:
    """Greedy tokens of two replicas against one engine, in f32 with the
    depth cut to ``layers`` and f32 KV lines (:func:`f32_lines`): the
    reference is a classic paged engine; the run under test two replicas
    under round robin (16-line pages, prefix cache) with one of them
    drained after the first router step.  A difference passes only as a
    tie: the reference's top-2 logit gap at the first differing token
    below 1e-4."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import init_params
    from repro_torch.models.model import cast_for_compute
    from repro_torch.monitoring import MetricsRegistry
    from repro_torch.serving import DecodeEngine

    c = dataclasses.replace(cfg, num_layers=layers, dtype="float32")
    params = cast_for_compute(init_params(c, SEED, device), torch.float32)
    ops.reset_launch_counts()
    ref = elastic_requests(c, args, greedy=True)
    eng = DecodeEngine(c, params, num_slots=args["slots"],
                       cache_len=args["cache_len"], seed=SEED,
                       decode_chunk=args["decode_chunk"],
                       prefill_buckets="auto", kv_page_size=16,
                       device=device)
    f32_lines(eng)
    for q in ref:
        eng.submit(q)
    eng.run_to_completion()
    del eng

    cli = elastic_cli(args, ["--replicas", "2", "--kv-paging", "16",
                             "--prefix-cache"], device)
    metrics = MetricsRegistry()
    make = serve.elastic_factory(cli, c, params, metrics, 16,
                                 torch.device(device))

    def make_f32(admission):
        engine = make(admission)
        f32_lines(engine)
        return engine

    router, _, _ = serve.start_elastic(cli, make_f32, metrics,
                                       {"default": 1})
    got = elastic_requests(c, args, greedy=True)
    for q in got:
        router.submit(q)
    router.step()
    moved = router.remove_replica(max(router.replicas))
    router.run_to_completion()
    same = ties = 0
    for q, a in zip(ref, got):
        if not a.done or len(a.output) != q.max_new_tokens:
            raise AssertionError(f"elastic identity: request {a.rid} "
                                 f"came back with {len(a.output)} tokens")
        if q.output == a.output:
            same += 1
            continue
        j = first_difference(q.output, a.output)
        gap = top2_gap(c, params, q.prompt, q.output[:j], device)
        log(f"  request {q.rid} differs at token {j} ({q.output[j]} one "
            f"engine, {a.output[j]} two replicas); top-2 gap {gap:.3e}")
        if gap >= 1e-4:
            raise AssertionError(f"elastic identity: request {q.rid} "
                                 f"differs at token {j} with a top-2 gap "
                                 f"of {gap}")
        ties += 1
    launches = ops.launch_counts()
    preempted = sum(q.preemptions > 0 for q in got)
    if moved == 0 or preempted == 0:
        raise AssertionError(f"elastic identity: the drain moved {moved} "
                             f"requests, {preempted} preempted")
    log(f"  f32, {layers} layers: {same}/{len(ref)} requests token for "
        f"token equal to one classic paged engine, through two replicas "
        f"with one drained after the first step ({moved} requests moved, "
        f"{preempted} resumed from partial output); ties (top-2 gap < "
        f"1e-4 at the first difference) {ties}; launches {launches} (a "
        "check in f32 at 4 layers, not the main path: not in the kernels "
        "line)")
    return {"same": same, "ties": ties, "moved": moved,
            "launches": launches}

def elastic_phase(args, device="cuda", reduced=False) -> dict:
    """Elastic serving of stablelm-3b at full width (``reduced``: the
    reduced config, for a rehearsal on the CPU): the weights built from
    the seed and cast to bf16 once, then the runs of ``ELASTIC_RUNS``
    through the serve CLI's router and autoscaler, every replica on the
    one card with the same weights; then :func:`elastic_identity`.
    Gates: every request finishes; the affinity run routes at least 7 of
    8 requests to their affine replica and has at least the round-robin
    run's prefix hits; the autoscale run drains one replica mid-decode
    and resumes its requests from their partial output; on the card the
    kernels of each run's path launched, and two replicas' peak memory
    exceeds one replica's by at most one KV pool + 1 GiB (a second weight
    set would add 5.2 GiB).  Returns the bf16 runs, whose launches are
    main-path launches, and the identity check."""
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.models import init_params
    from repro_torch.models.model import cast_for_compute, compute_dtype

    cfg = (get_reduced_config if reduced else get_config)("stablelm-3b")
    gc.collect()
    empty_cache(device)
    params = cast_for_compute(init_params(cfg, SEED, device),
                              compute_dtype(cfg))
    sync(device)
    if torch.device(device).type == "cuda":
        log(f"  params {torch.cuda.memory_allocated() / 2**30:.2f} GiB on "
            "the card, one set for every replica")
    runs = [elastic_run(cfg, params, args, label, flags, device)
            for label, flags in ELASTIC_RUNS]
    one, _, aff, rr, auto = runs
    n = args["requests"]
    if aff["stats"]["affinity_hits"] < n - 1:
        raise AssertionError(f"elastic: {aff['stats']['affinity_hits']} "
                             f"affinity hits of {n}")
    if aff["hits"] < rr["hits"]:
        raise AssertionError(f"elastic: affinity routing gave "
                             f"{aff['hits']} prefix hits, round robin "
                             f"{rr['hits']}")
    resumed = [(q, out) for q, out in auto["moved"] if out]
    if (auto["stats"]["drains"] != 1 or auto["scaler"]["drains"] != 1
            or not resumed):
        raise AssertionError(f"elastic autoscale: router {auto['stats']}, "
                             f"autoscaler {auto['scaler']}, "
                             f"{len(resumed)} requests moved mid-decode")
    for q, out in resumed:
        if q.output[:len(out)] != out or q.preemptions < 1:
            raise AssertionError(f"elastic autoscale: request {q.rid} lost "
                                 "its partial output in the drain")
    log(f"  autoscale: {len(resumed)} requests drained mid-decode "
        f"({', '.join(f'{q.rid}: {len(out)} tokens' for q, out in resumed)})"
        f", each resumed from its partial output on the survivor")
    if torch.device(device).type == "cuda":
        grew = aff["peak_gib"] - one["peak_gib"]
        log(f"  peak memory: 2 replicas {aff['peak_gib']:.2f} GiB, 1 "
            f"replica {one['peak_gib']:.2f} GiB: +{grew:.2f} GiB for one "
            f"more KV pool of {one['pool_gib']:.3f} GiB")
        if grew > one["pool_gib"] + 1:
            raise AssertionError(f"elastic: a second replica added "
                                 f"{grew:.2f} GiB, more than its KV pool "
                                 f"+ 1 GiB: the weights are not shared")
    del params
    empty_cache(device)
    ident = elastic_identity(cfg, args, device)
    empty_cache(device)
    return {"runs": runs, "identity": ident}


# ------------------------------------------------------ tensor parallel ----

#: the TP phase's bf16 runs: a label, the request set of
#: :func:`mode_requests` (greedy) and the engine options (every run: the
#: serve phase's slots, cache and decode chunk, buckets "auto")
TP_RUNS = (("dense", "serve", {}),
           ("16-line pages, prefix cache", "prefix",
            {"kv_page_size": 16, "prefix_cache": True}))
#: its f32 identity runs on the serve phase's requests (depth cut to 4
#: layers), tp=2 against tp=1
TP_F32_RUNS = (("dense", {}), ("16-line pages", {"kv_page_size": 16}))


def tp_engine(cfg, args, options, device, mesh=None, params=None):
    """An engine of the TP phase.  Without ``params`` the weights are
    built here from the seed in the compute dtype, so that under a mesh
    only the engine's shard of them outlives the call."""
    from repro_torch.models import init_params
    from repro_torch.models.model import cast_for_compute, compute_dtype
    from repro_torch.serving import DecodeEngine

    if params is None:
        params = cast_for_compute(init_params(cfg, SEED, device),
                                  compute_dtype(cfg))
    return DecodeEngine(cfg, params, num_slots=args["slots"],
                        cache_len=args["cache_len"], seed=SEED,
                        decode_chunk=args["decode_chunk"],
                        prefill_buckets="auto", mesh=mesh,
                        device=None if mesh is not None else device,
                        **options)


def tp_serve(engine, requests, device) -> dict:
    """Serve ``requests`` to completion: the launch counts, the
    all-reduce counts and the peak memory set to 0 just before, read just
    after."""
    from repro_torch.kernels import ops
    from repro_torch.monitoring.metrics import METRIC_SERVE_PREFIX_HITS

    for r in requests:
        engine.submit(r)
    gc.collect()
    empty_cache(device)
    sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    engine.tp_counts.update(attn_out=0, mlp_out=0)
    t0 = time.perf_counter()
    engine.run_to_completion()
    sync(device)
    wall = time.perf_counter() - t0
    m = engine.metrics
    total = int(m.counter("serve_tokens_generated").value())
    pre, dec = (m.histogram(n) for n in ("serve_prefill_seconds",
                                          "serve_decode_seconds"))
    return {"outputs": [list(r.output) for r in requests],
            "done": all(r.done and len(r.output) == r.max_new_tokens
                        for r in requests),
            "tokens": total, "wall_s": wall, "tok_s": total / wall,
            "prefill_ms": pre.sum() / max(pre.count(), 1) * 1e3,
            "decode_ms": dec.sum() / max(dec.count(), 1) * 1e3,
            "launches": ops.launch_counts(), "counts": dict(engine.tp_counts),
            "hits": int(m.counter(METRIC_SERVE_PREFIX_HITS).value()),
            "peak_gib": peak_gib(device)}


def tp_chunk(engine, args, device, profile: bool) -> dict:
    """One steady decode chunk of the engine (every slot live with a
    100-token prompt, nothing to admit), as :func:`profile_phase` takes
    it: its all-reduces counted and timed on the host clock, and, with
    ``profile``, a device-only ``torch.profiler`` trace of it."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from repro_torch.serving import Request

    rng = np.random.default_rng(SEED + 2)
    chunk = args["decode_chunk"]
    for rid in range(args["slots"]):
        engine.submit(Request(
            rid=100 + rid, prompt=rng.integers(
                2, engine.cfg.vocab_size, 100).astype(np.int32),
            max_new_tokens=4 * chunk))
    engine.step()                          # prefill every slot + a chunk
    engine.step()                          # warm
    sync(device)
    engine.tp_counts.update(attn_out=0, mlp_out=0)
    real, spent = dist.all_reduce, []

    def timed(t, *a, **k):
        t0 = time.perf_counter()
        try:
            return real(t, *a, **k)
        finally:
            spent.append(time.perf_counter() - t0)

    dist.all_reduce = timed
    prof = None
    try:
        # device activity only on the card (see profile_phase)
        act = (ProfilerActivity.CUDA if torch.device(device).type == "cuda"
               else ProfilerActivity.CPU)
        ctx = (torch_profile(activities=[act]) if profile
               else contextlib.nullcontext())
        with ctx as prof:
            # both ranks start the chunk together, past the profiler's start
            dist.barrier(group=engine.mesh.cpu_group)
            t0 = time.perf_counter()
            engine.step()
            sync(device)
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        dist.all_reduce = real
    out = {"wall_ms": wall_ms, "counts": dict(engine.tp_counts),
           "allreduce_ms": sum(spent) * 1e3, "allreduces": len(spent),
           "busy_ms": None, "kernels": None}
    if profile:
        busy, spans, by_name = device_busy(prof)
        out.update(busy_ms=busy if spans else None, kernels=len(spans),
                   top=sorted(by_name.items(), key=lambda kv: -kv[1])[:5])
    engine.run_to_completion()
    return out


def tp_rank(mesh, cfg, f32cfg, args, ref_outputs) -> dict:
    """One rank of the TP phase, a process of its own: the bf16 runs of
    ``TP_RUNS`` (the weights built from the seed on the rank's device and
    sharded by the engine, the rest freed), a steady chunk after the
    dense run (traced on rank 0), then the f32 runs of ``TP_F32_RUNS``.
    After each bf16 run, the logits of the context of every request's
    first token that differs from ``ref_outputs`` (tp=1's), and, after
    the dense run, of phase 6's consistency prompt."""
    dev = mesh.device
    out = {"runs": [], "f32": []}
    for i, (label, kind, options) in enumerate(TP_RUNS):
        engine = tp_engine(cfg, args, options, dev, mesh)
        reqs = mode_requests(cfg, kind, args, greedy=True)
        r = tp_serve(engine, reqs, dev)
        r.update(label=label, weights_gib=tree_gib(engine.params),
                 kv_gib=kv_gib(engine), plan=engine.tp.describe(cfg),
                 per_token=engine.tp.psums_per_token(cfg), flips=[])
        for q, a in zip(reqs, ref_outputs[label]):
            if q.output != a:
                j = first_difference(a, q.output)
                ctx = torch.from_numpy(np.concatenate(
                    [q.prompt, np.asarray(a[:j], np.int32)])).to(dev)[None]
                r["flips"].append((q.rid, j, last_logits(
                    engine.params, cfg, ctx, True, engine)))
        if i == 0:
            r["consistency"] = last_logits(
                engine.params, cfg, consistency_prompt(cfg, dev), True,
                engine)
            r["chunk"] = tp_chunk(engine, args, dev, mesh.rank == 0)
        out["runs"].append(r)
        del engine
    for label, options in TP_F32_RUNS:
        engine = tp_engine(f32cfg, args, options, dev, mesh)
        r = tp_serve(engine, serve_requests(f32cfg, args, greedy=True), dev)
        out["f32"].append(dict(r, label=label))
        del engine
    return out


def tp_flip(cfg, params, toks, l2, what, flip=False):
    """Hold tp=2's bf16 logits ``l2`` at the last position of ``toks`` to
    tp=1's: their distance within phase 6's bf16 bound (0.05 + 2x tp=1's
    own distance from an f32 run of the same weights) and, where the
    argmax parted (``flip``), tp=1's top-2 gap within twice that distance:
    a token may differ only where the sums' rounding can move it."""
    l1 = last_logits(params, cfg, toks, True)
    l32 = last_logits(params, dataclasses.replace(cfg, dtype="float32"),
                      toks, False)
    d = float(np.abs(l2 - l1).max())
    bound = 0.05 + 2 * float(np.abs(l1 - l32).max())
    top = np.sort(l1)[-2:]
    gap = float(top[1] - top[0])
    log(f"  tp {what}: |tp=2 - tp=1| {d:.4f} (bound {bound:.4f}); tp=1 "
        f"top-2 gap {gap:.4f}")
    if d > bound or (flip and gap > 2 * d):
        raise AssertionError(f"tp {what}: |tp=2 - tp=1| {d} against a "
                             f"bound of {bound}, top-2 gap {gap}")


def tp_phase(args, device="cuda", reduced=False) -> dict:
    """Tensor-parallel serving of stablelm-3b at full width (``reduced``:
    the reduced config, for a rehearsal on the CPU) on two ranks over
    gloo, both on ``device`` (the one card): :func:`tp_rank` in each,
    through ``serving.tp.launch``; the tp=1 references run in this
    process first.  Gates: every request finishes with its token count;
    the ranks' outputs are identical; in f32 at 4 layers the tokens equal
    tp=1's, dense and paged; in bf16 the logits of phase 6's consistency
    prompt, and of the context of any token that differs from tp=1's, lie
    within :func:`tp_flip`'s bound of tp=1's, and a differing token's
    tp=1 top-2 gap within twice their distance (bf16 logits are
    quantised at 2^-4 from magnitude 8: an f32-sized gap does not exist
    there); one
    steady decode token step issues one all-reduce per layer at each
    reduction point; on the card every rank launched all three attention
    kernels, and a rank's peak memory exceeds its shard (its weights and
    its KV pool) by at most one KV pool + 1 GiB.  Returns the runs (their
    launches, summed over the ranks, are main-path launches) and the
    identity check."""
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.models import init_params
    from repro_torch.models.model import cast_for_compute, compute_dtype
    from repro_torch.serving import tp as tp_mod

    cfg = (get_reduced_config if reduced else get_config)("stablelm-3b")
    f32cfg = dataclasses.replace(
        cfg, num_layers=min(cfg.num_layers, 4), dtype="float32")
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    gc.collect()
    empty_cache(device)
    t_phase = time.perf_counter()
    # the tp=1 references, greedy, on the same requests
    params = cast_for_compute(init_params(cfg, SEED, device),
                              compute_dtype(cfg))
    ref = {label: tp_serve(tp_engine(cfg, args, options, device,
                                     params=params),
                           mode_requests(cfg, kind, args, greedy=True),
                           device)
           for label, kind, options in TP_RUNS}
    p32 = init_params(f32cfg, SEED, device)
    ref32 = {label: tp_serve(tp_engine(f32cfg, args, options, device,
                                       params=p32),
                             serve_requests(f32cfg, args, greedy=True),
                             device)
             for label, options in TP_F32_RUNS}
    del p32
    gc.collect()
    empty_cache(device)
    t0 = time.perf_counter()
    ranks = tp_mod.launch(tp_rank, 2, devices=[device] * 2, backend="gloo",
                          args=(cfg, f32cfg, args,
                                {k: r["outputs"] for k, r in ref.items()}),
                          threads=None if on_card else 1)
    launch_s = time.perf_counter() - t0
    # f32 first: there the reductions' order cannot move a token
    same = 0
    for i, (label, _) in enumerate(TP_F32_RUNS):
        want = ref32[label]["outputs"]
        for k, rk in enumerate(ranks):
            got = rk["f32"][i]
            if not got["done"] or got["outputs"] != want:
                raise AssertionError(f"tp identity: f32 {label} on rank "
                                     f"{k} differs from tp=1: "
                                     f"{got['outputs']} vs {want}")
        same += len(want)
    log(f"  f32, {f32cfg.num_layers} layers: {same}/{same} requests token "
        "for token equal to tp=1 on both ranks, dense and paged (a check, "
        "not the main path: its launches are not in the kernels line)")
    runs, flips = [], 0
    for i, (label, kind, options) in enumerate(TP_RUNS):
        per = [rk["runs"][i] for rk in ranks]
        one = ref[label]
        for k, r in enumerate(per):
            log(f"  tp=2 {label}, rank {k}: {r['tokens']} decode tokens in "
                f"{r['wall_s']:.3f} s = {r['tok_s']:.1f} tok/s (tp=1 in "
                f"this phase: {one['tok_s']:.1f}, peak "
                f"{one['peak_gib']:.2f} GiB); prefill mean "
                f"{r['prefill_ms']:.2f} ms, decode chunk mean "
                f"{r['decode_ms']:.2f} ms; prefix hits {r['hits']}; "
                f"weights {r['weights_gib']:.3f} GiB + KV "
                f"{r['kv_gib']:.3f} GiB a rank, peak {r['peak_gib']:.2f} "
                f"GiB; all-reduces {r['counts']}; launches "
                f"{r['launches']}")
            if not r["done"]:
                raise AssertionError(f"tp {label}: rank {k} returned a "
                                     "short request")
            if on_card and r["peak_gib"] > (r["weights_gib"]
                                            + 2 * r["kv_gib"] + 1):
                raise AssertionError(
                    f"tp {label}: rank {k} peaked at {r['peak_gib']:.2f} "
                    f"GiB, over its shard ({r['weights_gib']:.2f} + "
                    f"{r['kv_gib']:.2f} GiB) + a KV pool + 1 GiB")
        if per[0]["outputs"] != per[1]["outputs"]:
            raise AssertionError(f"tp {label}: the ranks' outputs differ")
        if options.get("prefix_cache") and per[0]["hits"] == 0:
            raise AssertionError(f"tp {label}: no prefix hit")
        reqs = {q.rid: q for q in mode_requests(cfg, kind, args,
                                                greedy=True)}
        for rid, j, l2 in per[0]["flips"]:
            q, a = reqs[rid], one["outputs"][rid]
            toks = torch.from_numpy(np.concatenate(
                [q.prompt, np.asarray(a[:j], np.int32)])).to(device)[None]
            tp_flip(cfg, params, toks, l2, f"{label}: request {rid} differs "
                    f"from tp=1 at token {j} ({a[j]} tp=1, "
                    f"{per[0]['outputs'][rid][j]} tp=2)", flip=True)
            flips += 1
        if i == 0:
            tp_flip(cfg, params, consistency_prompt(cfg, device),
                    per[0]["consistency"], "consistency prompt (phase 6's), "
                    "prefill logits")
        runs.append({"label": f"tp=2 {label}", "tok_s": per[0]["tok_s"],
                     "tp1_tok_s": one["tok_s"],
                     "peak_gib": [r["peak_gib"] for r in per],
                     "outputs": [r["outputs"] for r in per],
                     "launches": {n: sum(r["launches"][n] for r in per)
                                  for n in per[0]["launches"]}})
    if on_card:
        # what the per-rank sizes buy: KV slots that fit beside the
        # weights at equal memory a device (activations aside)
        hbm = torch.cuda.get_device_properties(device).total_memory / 2**30
        r = ranks[0]["runs"][0]
        w1, kv_slot = tree_gib(params), r["kv_gib"] / args["slots"]
        n1 = (hbm - w1) / (2 * kv_slot)
        n2 = (hbm - r["weights_gib"]) / kv_slot
        log(f"  at equal memory a device ({hbm:.1f} GiB), KV for "
            f"{n1:.0f} slots beside tp=1's {w1:.3f} GiB of weights, "
            f"{n2:.0f} a rank beside tp=2's {r['weights_gib']:.3f} GiB "
            f"({n2 / n1:.2f}x; {cfg.num_layers} layers x {args['cache_len']}"
            f" lines a slot, from the sizes measured above)")
    del params
    empty_cache(device)
    chunk = args["decode_chunk"]
    for k, rk in enumerate(ranks):
        c = rk["runs"][0]["chunk"]
        want = {n: m * chunk for n, m in rk["runs"][0]["per_token"].items()}
        share = c["allreduce_ms"] / c["wall_ms"]
        busy = ("" if c["busy_ms"] is None else
                f"; device busy {c['busy_ms']:.2f} ms "
                f"({c['busy_ms'] / c['wall_ms']:.1%}), {c['kernels']} "
                "device kernels")
        log(f"  rank {k}, one steady dense decode chunk ({chunk} tokens x "
            f"{args['slots']} slots): wall {c['wall_ms']:.2f} ms; "
            f"{c['allreduces']} all-reduces {c['counts']} taking "
            f"{c['allreduce_ms']:.2f} ms on the host ({share:.1%} of the "
            f"chunk, {c['allreduce_ms'] / max(c['allreduces'], 1):.3f} ms "
            f"each){busy}")
        for name, us in c.get("top") or ():
            log(f"    {us / 1e3:8.3f} ms  {name[:100]}")
        if c["counts"] != want:
            raise AssertionError(f"tp: rank {k} issued {c['counts']} "
                                 f"all-reduces in a chunk of {chunk} token "
                                 f"steps, not {want}")
    if on_card:
        for k, rk in enumerate(ranks):
            for name in ("flash_attention", "flash_decode",
                         "flash_decode_paged"):
                if sum(r["launches"][name] for r in rk["runs"]) == 0:
                    raise AssertionError(f"tp: kernel {name} never "
                                         f"launched on rank {k}")
    log(f"  plan {ranks[0]['runs'][0]['plan']}; bf16 requests that part "
        f"from tp=1 (each within the rounding, above): {flips}; ranks' "
        f"launch {launch_s:.1f} s, phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    c = ranks[0]["runs"][0]["chunk"]
    return {"runs": runs, "identity": {"same": same, "total": same,
                                       "flips": flips},
            "chunk": {"counts": c["counts"], "allreduces": c["allreduces"],
                      "per_token": ranks[0]["runs"][0]["per_token"],
                      "tokens": chunk}}


# ------------------------------------------------------- train parallel ----

#: the train-parallel phase's bf16 runs at full width (qwen2-moe-a2.7b cut
#: to ``MOE_LAYERS`` layers), the main path: (label, arch, (data, model),
#: strategy, ZeRO stage, RunConfig knobs)
TRAIN_PAR_RUNS = (
    ("stablelm-3b fsdp_tp z3 2x2", "stablelm-3b", (2, 2), "fsdp_tp", 3, {}),
    ("stablelm-3b tp 1x2", "stablelm-3b", (1, 2), "tp", 3, {}),
    ("stablelm-3b fsdp z3 2x1", "stablelm-3b", (2, 1), "fsdp", 3, {}),
    ("mamba2-780m dp z1 2x1", "mamba2-780m", (2, 1), "dp", 1, {}),
    ("mamba2-780m dp z2 2x1", "mamba2-780m", (2, 1), "dp", 2, {}),
    ("mamba2-780m tp 1x2", "mamba2-780m", (1, 2), "tp", 3, {}),
    ("qwen2-moe-a2.7b tp 1x2", "qwen2-moe-a2.7b", (1, 2), "tp", 3, {}),
    ("qwen2-moe-a2.7b fsdp z3 2x1", "qwen2-moe-a2.7b", (2, 1), "fsdp", 3,
     {}))
#: its f32 identity runs at 4 layers (qwen2-moe-a2.7b at
#: ``MOE_F32_LAYERS``), each against the one-rank run of the same config:
#: (label, arch, (data, model), strategy, ZeRO stage, RunConfig knobs)
TRAIN_PAR_F32 = (("dp z1 2x1", "stablelm-3b", (2, 1), "dp", 1, {}),
                 ("dp z2 2x1", "stablelm-3b", (2, 1), "dp", 2, {}),
                 ("fsdp z2 2x1", "stablelm-3b", (2, 1), "fsdp", 2, {}),
                 ("fsdp z3 2x1", "stablelm-3b", (2, 1), "fsdp", 3, {}),
                 ("tp 1x2", "stablelm-3b", (1, 2), "tp", 3, {}),
                 ("tp seq_parallel 1x2", "stablelm-3b", (1, 2), "tp", 3,
                  {"seq_parallel": True}),
                 ("mamba2-780m tp 1x2", "mamba2-780m", (1, 2), "tp", 3, {}),
                 ("fsdp_tp z3 2x2", "stablelm-3b", (2, 2), "fsdp_tp", 3,
                  {}),
                 ("qwen2-moe-a2.7b fsdp z3 2x1", "qwen2-moe-a2.7b", (2, 1),
                  "fsdp", 3, {}),
                 ("qwen2-moe-a2.7b tp 1x2", "qwen2-moe-a2.7b", (1, 2), "tp",
                  3, {}))
#: qwen2-moe-a2.7b's depth in the phase: 4 layers of 60 + 4 experts hold
#: ~2.91 B parameters, 43.3 GiB of f32 state on one rank
MOE_LAYERS = 4
#: its depth in the f32 identity runs: 2 layers hold ~1.76 B parameters,
#: 26.3 GiB of f32 state on one rank (ZeRO 3 gathers the f32 weights
#: through gloo, ~1 GiB/s: 4 layers would take about a minute a step)
MOE_F32_LAYERS = 2
#: f32 identity: losses and gradient norms relative, final parameters
#: against the largest magnitude of the one-rank run's, their update over
#: the run (final - initial, the whole tree) relative L2; bf16 runs:
#: losses against the one-rank bf16 run, phase 8's constant term, and
#: gradient norms relative.  The runs take the default optimizer, whose
#: first steps move a parameter by a few 1e-6: the update bound, relative
#: to the update, and the gradient norms see a wrong gradient at any
#: learning rate.  (At a peak rate of 1e-3 AdamW moves an element whose
#: first moment cancels by up to ~lr either way on a reduction-order
#: difference: 6.8e-4 of the largest magnitude over 2 x 2 ranks on an
#: H100, past ``PAR_PARAM_TOL``, with the update within 2.5e-4 L2.)
PAR_LOSS_TOL, PAR_PARAM_TOL, PAR_UPDATE_TOL, PAR_BF16_TOL = \
    1e-5, 1e-4, 1e-3, 0.05
#: the collectives counted: every one the dry run records
#: (``repro_torch.launch.dryrun.COLLECTIVES``)
_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
                "all_to_all_single", "batch_isend_irecv")


@contextlib.contextmanager
def timed_collectives(stats: dict, device):
    """Count and time, on the host, every ``torch.distributed`` collective
    of ``_COLLECTIVES`` the training path calls inside the block, and sum
    the bytes of the tensors each hands over (``stats["bytes"]``: the
    input, or the list of inputs, of each call, ``launch.dryrun.
    handed_bytes``): the device is synchronised before and after each, so
    a reading holds the collective alone (gloo copies CUDA tensors
    through the host and waits for them anyway)."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import handed_bytes

    orig = {name: getattr(dist, name) for name in _COLLECTIVES}

    def timed(name, fn):
        def call(*a, **kw):
            sync(device)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync(device)
            stats["s"] += time.perf_counter() - t0
            stats[name] += 1
            stats["bytes"] += handed_bytes(name, a)
            return out
        return call

    for name, fn in orig.items():
        setattr(dist, name, timed(name, fn))
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(dist, name, fn)


def _local_numel(shape, spec, mesh_shape) -> int:
    n = 1
    for size, e in zip(shape, spec):
        axes = e if isinstance(e, tuple) else (e,)
        for a in axes:
            if a is not None:
                size //= mesh_shape[a]
        n *= size
    return n


def reckon_train(cfg, layout, rows: int, S: int) -> dict:
    """A rank's reckoned bytes: ``shard`` (its f32 parameter shards,
    their gradients in the parameter layout and, from ZeRO 2, the reduced
    ones in the optimizer layout, AdamW's m and v; under ZeRO-3 one layer
    group gathered) and ``act`` (the activations of ``rows`` local rows x
    ``S``: the recomputed groups' inputs, the whole-vocab logits and
    their gradients in f32, and one layer's recompute and backward, with
    the plain attention backward's (rows, heads, S, S) f32 scores and the
    SSD scan's chunk matrices).  Temporaries have no term: AdamW and the
    checkpoint's gathers work a slice at a time."""
    sizes = layout.mesh.shape
    c = 2 if cfg.dtype == "bfloat16" else 4
    state = gathered = 0
    for leaf in layout.leaves:
        p = _local_numel(leaf.shape, leaf.param, sizes)
        o = _local_numel(leaf.shape, leaf.opt, sizes)
        state += 4 * (2 * p + 2 * o)
        if layout.run.zero_stage >= 2 and leaf.data_dim is None \
                and layout.n_data > 1:
            state += 4 * o
        if leaf.data_dim is not None and leaf.path.startswith("['layers']"):
            n_model = _local_numel(leaf.shape, tuple(
                e if e == "model" else None for e in leaf.param), sizes)
            gathered += 4 * n_model // leaf.shape[0]
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    tp = layout.tp

    def per_rank(n, sharded):          # a dim the model ranks split
        return n // layout.n_model if tp is not None and sharded else n

    act = L * rows * S * d * c + 16 * rows * S * V
    T = rows * S
    if cfg.ssm is None:
        H = per_rank(cfg.num_heads, tp and tp.attn)
        F_ = per_rank(cfg.d_ff, tp and tp.mlp)
        act += 16 * rows * H * S * S + 4 * (12 * T * d + 8 * T * F_)
    else:
        ssm = cfg.ssm
        H = per_rank(ssm.num_heads(d), tp and tp.ssm)
        di = per_rank(ssm.d_inner(d), tp and tp.ssm)
        act += 16 * T * H * ssm.chunk + 4 * 30 * T * di
    if cfg.moe is not None:
        # one MoE layer's recompute and backward: the routing tensors
        # (G, gs, E, C) whole on every rank (the f32 combine, its k one-hot
        # terms and their gradients, the bf16 dispatch), the rank's expert
        # slots (G, E/m, C, d | d_ff/m) and the shared experts' hidden
        moe = cfg.moe
        gs = min(moe.group_size, T)
        E = moe.num_experts
        C = max(4, -(-math.ceil(gs * moe.top_k / E * moe.capacity_factor)
                     // 4) * 4)
        slots = (T // gs) * per_rank(E, tp and tp.experts) * C
        f = per_rank(moe.d_ff, tp and tp.expert_ffn)
        fs = per_rank(moe.d_ff * moe.num_shared, tp and tp.shared)
        act += 4 * (2 * moe.top_k + 4) * T * E * C \
            + 4 * 8 * slots * (d + 3 * f) + 4 * 8 * T * fs
    return {"shard": state + gathered, "act": act}


def par_trainer(cfg, mesh, strategy, zero, S, B, device, knobs=None):
    from repro_torch.configs import InputShape, RunConfig
    from repro_torch.optim import OptimizerConfig
    from repro_torch.training import Trainer, TrainerConfig

    run = RunConfig(strategy=strategy, zero_stage=zero, use_kernels=True,
                    remat="layer", **(knobs or {}))
    return Trainer(cfg, run, mesh, InputShape("par", S, B, "train"),
                   OptimizerConfig(), TrainerConfig(steps=1, seed=SEED),
                   device=device)


def update_errors(final, ref, init) -> dict:
    """The whole final parameters of a run against the one-rank run's
    (``ref``), both from ``init``, leaf by leaf: ``param_err`` (max
    |diff|), ``param_scale`` (the one-rank run's largest magnitude),
    ``update_l2`` (|| (final - init) - (ref - init) || / || ref - init ||
    over the tree) and ``update_max`` (the largest element of the
    one-rank run's update)."""
    err = scale = num = den = umax = 0.0
    for a, b, i in zip(final, ref, init):
        err = max(err, max_err(a, b))
        scale = max(scale, float(b.abs().max()))
        num += float(torch.sum(torch.square(a.float() - b.float())))
        du = b.float() - i.float()
        den += float(torch.sum(torch.square(du)))
        umax = max(umax, float(du.abs().max()))
        del du
    return {"param_err": err, "param_scale": scale,
            "update_l2": math.sqrt(num / den) if den else float("inf"),
            "update_max": umax}


def par_run(trainer, steps: int, device) -> dict:
    """Initialise, then take ``steps`` steps with the launch counts, the
    peak memory and the collectives' count and host time set to 0 just
    before them.  No warm-up step: a step through gloo takes 5-40 s
    (``scripts/train_collectives.py``).  A first step also carries the
    process's one-time costs (8-11 s on an H100 for stablelm-3b), so
    the collectives' host time is the steadier reading."""
    from repro_torch.kernels import ops

    trainer.init_state()
    sync(device)
    on_card = torch.device(device).type == "cuda"
    held = torch.cuda.memory_allocated() if on_card else 0
    trainer.tcfg.steps = steps
    stats = dict(s=0.0, bytes=0, **{name: 0 for name in _COLLECTIVES})
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sync(device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with timed_collectives(stats, device):
        trainer.train(log=lambda *_: None)
    sync(device)
    wall = time.perf_counter() - t0
    kept = trainer.history
    return {"losses": [h["loss"] for h in trainer.history],
            "grad_norms": [h["grad_norm"] for h in trainer.history],
            "step_s": statistics.median(h["sec"] for h in kept),
            "collective_s": stats["s"] / len(kept),
            "collectives": {n: stats[n] // len(kept) for n in _COLLECTIVES
                            if stats[n]},
            "collective_bytes": stats["bytes"] // len(kept),
            "collective_gib": stats["bytes"] / len(kept) / 2**30,
            "coll_share": stats["s"] / wall,
            "launches": ops.launch_counts(),
            "held_gib": held / 2**30,
            "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if on_card else float("nan"))}


def _par_cfgs(reduced: bool):
    """The phase's configs: the bf16 runs' by arch (qwen2-moe-a2.7b cut
    to ``MOE_LAYERS`` layers) and the f32 identity runs' at 4 layers
    (qwen2-moe-a2.7b at ``MOE_F32_LAYERS``)."""
    from repro_torch.configs import get_config, get_reduced_config

    get = get_reduced_config if reduced else get_config
    cfgs = {a: get(a) for a in ("stablelm-3b", "mamba2-780m",
                                "qwen2-moe-a2.7b")}
    moe = cfgs["qwen2-moe-a2.7b"]
    cfgs["qwen2-moe-a2.7b"] = dataclasses.replace(
        moe, num_layers=min(moe.num_layers, MOE_LAYERS))
    f32cfgs = {a: dataclasses.replace(cfgs[a], dtype="float32",
                                      num_layers=min(cfgs[a].num_layers, (
                                          MOE_F32_LAYERS if cfgs[a].moe
                                          else 4)))
               for a in {e[1] for e in TRAIN_PAR_F32}}
    return cfgs, f32cfgs


def train_par_rank(mesh, jobs: dict, ref_paths: dict, S: int, B: int,
                   steps: dict, reduced: bool) -> dict:
    """One rank of the train-parallel phase: each of ``jobs["runs"]``
    (bf16, full width) and ``jobs["f32"]`` (4 layers, f32) through the
    port's ``Trainer`` on its mesh, ``steps[kind]`` steps each; for each,
    the rank's losses, step time, collectives, launches and peak memory
    against its reckoned bytes.  After an f32 run rank 0 holds the whole
    final parameters against the one-rank run's of the same config
    (``ref_paths[arch]``)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.tree import leaves

    dev = mesh.device
    world = mesh.devices.size
    shapes = [(world, 1), (1, world)] if world == 2 else [(2, 2)]
    meshes = {s: make_mesh(*s, devices=[dev] * world, backend="gloo")
              for s in shapes}
    cfgs, f32cfgs = _par_cfgs(reduced)
    out = {"runs": [], "f32": []}
    for kind, specs in (("runs", jobs["runs"]), ("f32", jobs["f32"])):
        for label, arch, shape, strategy, zero, knobs in specs:
            cfg = f32cfgs[arch] if kind == "f32" else cfgs[arch]
            m = meshes[shape]
            t = par_trainer(cfg, m, strategy, zero, S, B, dev, knobs)
            r = par_run(t, steps[kind], dev)
            rows = t.layout.batch_rows(B)[1]
            r.update(label=label, arch=arch,
                     reckon=reckon_train(cfg, t.layout, rows, S))
            if kind == "f32":
                whole = leaves(t.layout.gather_tree(t.params))
                if mesh.rank == 0:
                    ref = torch.load(ref_paths[arch], map_location=dev)
                    init = leaves(init_params(cfg, SEED, dev))
                    r.update(update_errors(whole, ref, init))
                    del ref, init
                del whole
            out[kind].append(r)
            del t
            gc.collect()
            empty_cache(dev)
    return out


def shard_kernel_checks(cfgs, m: int, B: int, S: int):
    """The two kernels of the tp runs at the shapes a rank of ``m`` hands
    them, bf16: ``ssd_scan`` on mamba2-780m's ``H/m`` SSD heads and
    ``flash_attention`` on qwen2-moe-a2.7b's ``H/m`` heads, each against
    its plain version (and attention against SDPA), with their device
    times and bounds, logged."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ssd

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    bf16 = torch.bfloat16
    cfg = cfgs["mamba2-780m"]
    ssm = cfg.ssm
    H, P, N = ssm.num_heads(cfg.d_model) // m, ssm.head_dim, ssm.state
    # strided as ssm_train hands them over: slices of one conv output
    u = rand(gen, (B, S, H * P + 2 * N), bf16)
    x = u[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = u[..., H * P:H * P + N], u[..., H * P + N:]
    dt = torch.rand((B, S, H), generator=gen, device="cuda") * 0.099 + 1e-3
    A = -(torch.rand((H,), generator=gen, device="cuda") * 3.5 + 0.5)
    a = dt * A
    Q = ops._pick_block(S, ssm.chunk)
    what = f"tp shard x({B},{S},{H},{P}) N {N} Q {Q} bf16"
    check("ssd_scan", ssd.ssd_scan_bshp(x, dt, a, Bm, Cm, Q),
          ref.ssd_scan_ref(x, dt, a, Bm, Cm, Q), bf16, what + " vs chunked",
          relative=True)
    ms = time_ms(lambda: ssd.ssd_scan_bshp(x, dt, a, Bm, Cm, Q))
    plain = time_ms(lambda: ref.ssd_scan_ref(x, dt, a, Bm, Cm, Q))
    T = B * S
    pairs = Q * (Q + 1) // 2
    b, by = bound_ms(2 * 2 * T * H * P + 4 * T * H + 4 * H + 2 * 2 * T * N,
                     B * (S // Q) * (2 * pairs * N + H * (
                         2 * pairs * P + 4 * Q * N * P)), bf16)
    log(f"  ssd_scan at the {what}: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, library n/a, bound {b:.4f} ms ({by})")
    cfg = cfgs["qwen2-moe-a2.7b"]
    h, k, Dh = cfg.num_heads // m, cfg.num_kv_heads // m, cfg.head_dim
    q, kk, v = (rand(gen, (B, S, n, Dh), bf16) for n in (h, k, k))
    what = f"tp shard q({B},{S},{h},{Dh}) kv {k} heads bf16"
    check("flash_attention", fa.flash_attention_bshd(q, kk, v),
          ref.attention_ref(q, kk, v, None), bf16, what)
    ms = time_ms(lambda: fa.flash_attention_bshd(q, kk, v))
    plain = time_ms(lambda: ref.attention_ref(q, kk, v, None))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), kk.transpose(1, 2), v.transpose(1, 2),
        is_causal=True))
    b, by = bound_ms(2 * (2 * T * h * Dh + 2 * T * k * Dh),
                     4 * Dh * h * B * S * (S + 1) / 2, bf16)
    log(f"  flash_attention at the {what}: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, SDPA {lib:.4f} ms, bound {b:.4f} ms ({by})")


def expert_gemm_share(trainer, device) -> None:
    """One more step of a one-rank MoE trainer under ``torch.profiler``
    (host ops with their input shapes, and the device): the device time
    of ``models.moe.moe_apply``'s einsums, forward, recomputation and
    backward, against the step's device-busy time.  The einsums run as
    ``aten::bmm``: the expert FFN's over the experts (both inputs lead
    with E, one holds the expert ``d_ff``), dispatch and combine over the
    token groups (one input holds the E x C slots).  Logged, not a
    gate."""
    from torch.profiler import ProfilerActivity, profile

    cfg = trainer.cfg
    moe = cfg.moe
    T = trainer.shape.global_batch * trainer.shape.seq_len
    gs = min(moe.group_size, T)
    E = moe.num_experts
    C = max(4, -(-math.ceil(gs * moe.top_k / E * moe.capacity_factor)
                 // 4) * 4)
    trainer.tcfg.steps = trainer.step + 1
    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        trainer.train(log=lambda *_: None)
        sync(device)
        wall = time.perf_counter() - t0
    busy_ms, spans, _ = device_busy(prof)
    ffn = route = 0.0
    n_ffn = n_route = 0
    for e in prof.events():
        if e.name != "aten::bmm" or len(e.input_shapes) < 2:
            continue
        a, b = e.input_shapes[:2]
        if not a or not b:
            continue
        if a[0] == b[0] == E and moe.d_ff in (*a, *b):
            ffn += e.device_time_total
            n_ffn += 1
        elif a[0] == b[0] and E * C in (*a, *b):
            route += e.device_time_total
            n_route += 1
    ffn, route = ffn / 1e3, route / 1e3
    if not spans:
        log("  expert GEMMs: device time not measured (the trace holds no "
            "device events)")
        return
    log(f"  expert GEMMs of one traced one-rank {cfg.name} step "
        f"({cfg.num_layers} layers, {E} experts, capacity {C} a group of "
        f"{gs}): expert FFN einsums {ffn:.2f} ms ({n_ffn} bmm), dispatch "
        f"and combine {route:.2f} ms ({n_route} bmm), together "
        f"{(ffn + route) / busy_ms:.1%} of the step's {busy_ms:.2f} ms of "
        f"device-busy time (wall {wall * 1e3:.1f} ms traced, host ops "
        "recorded)")


def one_rank_train(cfg, S, B, steps, device, strategy="fsdp_tp") -> tuple:
    """The one-rank run the parallel runs are held to: its result and its
    trainer."""
    from repro_torch.launch.mesh import single_device_mesh

    t = par_trainer(cfg, single_device_mesh(device), strategy, 3, S, B,
                    device)
    return par_run(t, steps, device), t


def train_parallel_phase(args, device="cuda", reduced=False) -> dict:
    """Training parallelism through the port's ``Trainer`` on ranks that
    share ``device`` over gloo (``launch.mesh.launch_ranks``; NCCL takes
    one rank per card), the runs of ``TRAIN_PAR_RUNS``: full-width
    stablelm-3b under fsdp_tp ZeRO 3 on 2 x 2 ranks, tp on 1 x 2 and fsdp
    ZeRO 3 on 2 x 1, full-width mamba2-780m under dp ZeRO 1 and 2 on 2 x
    1 and tp on 1 x 2, qwen2-moe-a2.7b at full width and ``MOE_LAYERS``
    layers under tp on 1 x 2 and fsdp ZeRO 3 on 2 x 1 (``reduced``: the
    reduced configs, for a rehearsal on the CPU), each ``args["steps"]``
    steps of ``args["batch"]`` x ``args["seq_len"]`` tokens; then the f32
    identity runs of ``TRAIN_PAR_F32`` at 4 layers (qwen2-moe-a2.7b at
    ``MOE_F32_LAYERS``), ``args["f32_steps"]`` steps each.  On the card the two kernels first run at the tp ranks'
    shard shapes against their plain versions
    (:func:`shard_kernel_checks`).  One-rank runs in this process first:
    each bf16 config and each f32 one; on the card the MoE config's takes
    one more step, traced (:func:`expert_gemm_share`).  Gates: finite losses, the first
    within 1.5 of ln(vocab); the ranks' losses and gradient norms equal;
    bf16 losses within ``PAR_BF16_TOL`` of the one-rank run's and
    gradient norms within ``PAR_BF16_TOL`` relative; f32 losses and
    gradient norms within ``PAR_LOSS_TOL`` relative, final parameters
    within ``PAR_PARAM_TOL`` of the largest magnitude and their update
    within ``PAR_UPDATE_TOL`` relative L2 of the one-rank run's; on the
    card a rank's peak memory within its reckoned shard + activations +
    1 GiB, and the attention (dense, MoE) or scan (SSM) kernel launched
    twice a layer a step (forward and recomputation) on every rank.
    Returns the bf16 runs (their launches, summed over the ranks, are
    main-path launches) and the identity check."""
    import tempfile

    from repro_torch.launch.mesh import launch_ranks

    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    S, B = args["seq_len"], args["batch"]
    steps = {"runs": args["steps"], "f32": args["f32_steps"]}
    cfgs, f32cfgs = _par_cfgs(reduced)
    gc.collect()
    empty_cache(device)
    t_phase = time.perf_counter()
    if on_card:
        shard_kernel_checks(cfgs, 2, B, S)
    refs = {}
    for arch, cfg in cfgs.items():
        refs[arch], t = one_rank_train(cfg, S, B, steps["runs"], device)
        r = refs[arch]
        log(f"  one rank, {arch} ({cfg.num_layers} layers): losses "
            + ", ".join(f"{x:.4f}" for x in r["losses"])
            + "; gradient norms "
            + ", ".join(f"{x:.5f}" for x in r["grad_norms"])
            + f"; {r['step_s']:.3f} s/step, {B * S / r['step_s']:,.0f} "
            f"tok/s; state {r['held_gib']:.2f} GiB, peak "
            f"{r['peak_gib']:.2f} GiB; launches {r['launches']}")
        if on_card and cfg.moe is not None:
            expert_gemm_share(t, device)
        del t
        gc.collect()
        empty_cache(device)
    from repro_torch.tree import leaves
    tmp = tempfile.mkdtemp(prefix="repro-train-par-")
    ref32, ref_paths = {}, {}
    for arch, f32cfg in f32cfgs.items():
        ref32[arch], t = one_rank_train(f32cfg, S, B, steps["f32"], device)
        ref_paths[arch] = str(Path(tmp) / f"{arch}-f32-params.pt")
        torch.save([p.cpu() for p in leaves(t.params)], ref_paths[arch])
        del t
        gc.collect()
        empty_cache(device)
        log(f"  one rank, {arch} f32 {f32cfg.num_layers} layers: losses "
            + ", ".join(f"{x:.6f}" for x in ref32[arch]["losses"])
            + "; gradient norms "
            + ", ".join(f"{x:.6f}" for x in ref32[arch]["grad_norms"]))
    threads = None if on_card else 1
    on = {4: lambda e: e[2] == (2, 2), 2: lambda e: e[2] != (2, 2)}
    jobs = {n: {"runs": [e for e in TRAIN_PAR_RUNS if on[n](e)],
                "f32": [e for e in TRAIN_PAR_F32 if on[n](e)]}
            for n in on}
    try:
        t0 = time.perf_counter()
        four = launch_ranks(train_par_rank, 2, 2, devices=[device] * 4,
                            backend="gloo", threads=threads, args=(
                                jobs[4], ref_paths, S, B, steps, reduced))
        t4 = time.perf_counter() - t0
        t0 = time.perf_counter()
        two = launch_ranks(train_par_rank, 2, 1, devices=[device] * 2,
                           backend="gloo", threads=threads, args=(
                               jobs[2], ref_paths, S, B, steps, reduced))
        t2 = time.perf_counter() - t0
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    runs = []
    for world, ranks in ((4, four), (2, two)):
        for i, spec in enumerate(jobs[world]["runs"]):
            label, arch = spec[0], spec[1]
            cfg = cfgs[arch]
            per = [rk["runs"][i] for rk in ranks]
            ref = refs[arch]
            log(f"  {label}: losses "
                + ", ".join(f"{x:.4f}" for x in per[0]["losses"])
                + " (one rank: " + ", ".join(
                    f"{x:.4f}" for x in ref["losses"]) + "); gradient "
                "norms " + ", ".join(f"{x:.5f}" for x in per[0]["grad_norms"])
                + " (one rank: " + ", ".join(
                    f"{x:.5f}" for x in ref["grad_norms"]) + ")")
            for k, r in enumerate(per):
                rk = r["reckon"]
                bound = (rk["shard"] + rk["act"]) / 2**30
                log(f"    rank {k}: {r['step_s']:.3f} s/step, collectives "
                    f"{r['collective_s']:.3f} s/step ({r['coll_share']:.1%} "
                    f"of the steps; {r['collectives']} a step, "
                    f"{r['collective_gib']:.3f} GiB handed over); peak "
                    f"{r['peak_gib']:.2f} GiB against reckoned shard "
                    f"{rk['shard'] / 2**30:.2f} + activations "
                    f"{rk['act'] / 2**30:.2f} = {bound:.2f} GiB (state "
                    f"held after init {r['held_gib']:.2f} GiB); launches "
                    f"{r['launches']}")
                if on_card and r["peak_gib"] > bound + 1:
                    raise AssertionError(
                        f"train parallel {label}: rank {k} peaked at "
                        f"{r['peak_gib']:.2f} GiB, over its reckoned "
                        f"{bound:.2f} GiB + 1 GiB")
                if r["losses"] != per[0]["losses"] or \
                        r["grad_norms"] != per[0]["grad_norms"]:
                    raise AssertionError(f"train parallel {label}: the "
                                         "ranks' losses or gradient norms "
                                         "differ")
                want = steps["runs"] * 2 * cfg.num_layers
                name = "ssd_scan" if cfg.ssm is not None \
                    else "flash_attention"
                if on_card and r["launches"][name] != want:
                    raise AssertionError(
                        f"train parallel {label}: {name} launched "
                        f"{r['launches'][name]} times on rank {k}, not "
                        f"{want}")
            ls = per[0]["losses"]
            if not all(math.isfinite(x) for x in ls) or abs(
                    ls[0] - math.log(cfg.vocab_size)) > 1.5:
                raise AssertionError(f"train parallel {label}: losses {ls}")
            gap = max(abs(a - b) for a, b in zip(ls, ref["losses"]))
            ggap = max(abs(a - b) / abs(b) for a, b in
                       zip(per[0]["grad_norms"], ref["grad_norms"]))
            log(f"    largest loss gap to the one-rank run {gap:.5f} "
                f"(tol {PAR_BF16_TOL}); largest relative gradient-norm gap "
                f"{ggap:.2e} (tol {PAR_BF16_TOL})")
            if not gap <= PAR_BF16_TOL or not ggap <= PAR_BF16_TOL:
                raise AssertionError(
                    f"train parallel {label}: losses {ls} and gradient "
                    f"norms {per[0]['grad_norms']} against one rank's "
                    f"{ref['losses']} and {ref['grad_norms']}")
            rk = per[0]["reckon"]
            runs.append({"label": label, "step_s": per[0]["step_s"],
                         "one_rank_step_s": ref["step_s"],
                         "coll_share": per[0]["coll_share"],
                         "collective_gib": per[0]["collective_gib"],
                         "collectives": per[0]["collectives"],
                         "collective_bytes": per[0]["collective_bytes"],
                         "limit_gib": (rk["shard"] + rk["act"]) / 2**30
                         + 1,
                         "peak_gib": [r["peak_gib"] for r in per],
                         "launches": {n: sum(r["launches"][n] for r in per)
                                      for n in per[0]["launches"]}})
    ident = []
    for ranks in (four, two):
        for r in (rk["f32"] for rk in ranks[:1]):
            for x in r:
                one = ref32[x["arch"]]
                rel = max(abs(a - b) / abs(b) for a, b in
                          zip(x["losses"], one["losses"]))
                grel = max(abs(a - b) / abs(b) for a, b in
                           zip(x["grad_norms"], one["grad_norms"]))
                perr = x["param_err"] / x["param_scale"]
                ident.append((x["label"], rel, grel, perr, x["update_l2"]))
                log(f"  f32 identity {x['label']}: losses "
                    + ", ".join(f"{v:.6f}" for v in x["losses"])
                    + f"; largest relative gap of the losses {rel:.2e}, of "
                    f"the gradient norms {grel:.2e} (tol "
                    f"{PAR_LOSS_TOL:g}); final params max|diff| "
                    f"{x['param_err']:.3e} = {perr:.2e} of the largest "
                    f"magnitude (tol {PAR_PARAM_TOL:g}); update (largest "
                    f"element {x['update_max']:.3e}) within "
                    f"{x['update_l2']:.2e} relative L2 (tol "
                    f"{PAR_UPDATE_TOL:g}); {x['step_s']:.3f} s/step, "
                    f"collectives {x['coll_share']:.1%} "
                    f"({x['collectives']} a step)")
                if not (rel <= PAR_LOSS_TOL and grel <= PAR_LOSS_TOL
                        and perr <= PAR_PARAM_TOL
                        and x["update_l2"] <= PAR_UPDATE_TOL):
                    raise AssertionError(f"train parallel identity "
                                         f"{x['label']}: beyond tolerance")
    log(f"  ranks' launches {t4:.1f} s (2 x 2) and {t2:.1f} s (2 ranks), "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    one_rank = {arch: {"step_s": r["step_s"], "peak_gib": r["peak_gib"]}
                for arch, r in refs.items()}
    return {"runs": runs, "identity": ident, "one_rank": one_rank}


# ---------------------------------------------------------------- resume ----

#: the resume phase: full-width mamba2-780m (f32 weights and AdamW, bf16
#: compute) saves under dp ZeRO 2 on 2 x 1 ranks after one step and
#: resumes on other meshes; then the same at ``RESUME_F32_LAYERS`` layers
#: in f32.  (label, (data, model), strategy, ZeRO stage) of the saving
#: run and of the resumed runs on ranks; one rank in this process too
RESUME_SAVE = ("dp z2 2x1", (2, 1), "dp", 2)
RESUME_ON = (("tp 1x2", (1, 2), "tp", 3),)
RESUME_F32_LAYERS = 4


def state_digests(trainer) -> list:
    """SHA-1 of the bytes of every whole leaf of a trainer's state (its
    parameters, AdamW m and v, the step counter), in the checkpoint's
    leaf order, each leaf gathered alone over the ranks (collective):
    rank 0's list ([] on the other ranks)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.tree import leaves_with_path

    def sha1(a):
        return hashlib.sha1(a.numpy()).hexdigest()

    specs = trainer._leaf_specs()
    out = []
    # hashlib lets go of the interpreter lock: the leaves hash in threads
    # while the next ones are gathered and copied to the host
    with ThreadPoolExecutor(4) as pool:
        for path, t in leaves_with_path({"params": trainer.params,
                                         "opt": trainer.opt_state}):
            whole = trainer.layout.gather(t, specs[path][0]) \
                if path in specs else t
            if trainer.rank == 0:
                a = whole.detach().cpu().contiguous()
                if a.dtype == torch.bfloat16:
                    a = a.view(torch.int16)
                out.append(pool.submit(sha1, a))
            del whole
    return [f.result() for f in out]


def timed_checkpoint(trainer, call, device) -> dict:
    """``call()`` (the trainer's ``save`` or ``maybe_resume``) with the
    peak memory reset just before it: its seconds on the host (ending in
    a synchronize), the memory held before it and its peak (on the card),
    and the largest part that ``Layout.gather_slices`` handed out during
    it, in bytes."""
    lay = trainer.layout
    gather_slices = lay.gather_slices
    biggest = [0]

    def recorded(local, spec):
        for index, part in gather_slices(local, spec):
            biggest[0] = max(biggest[0], part.numel() * part.element_size())
            yield index, part

    on_card = torch.device(device).type == "cuda"
    lay.gather_slices = recorded
    try:
        sync(device)
        held = torch.cuda.memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = call()
        sync(device)
        secs = time.perf_counter() - t0
    finally:
        del lay.gather_slices
    return {"s": secs, "held": held, "slice": biggest[0], "result": result,
            "peak": (torch.cuda.max_memory_allocated() if on_card
                     else float("nan"))}


def _resume_steps(trainer, steps: int) -> dict:
    """Train to ``steps`` with the launch counts set to 0 just before;
    the losses and gradient norms of the steps taken, and the launches."""
    from repro_torch.kernels import ops

    start = len(trainer.history)
    trainer.tcfg.steps = steps
    ops.reset_launch_counts()
    trainer.train(log=lambda *_: None)
    sync(trainer.device)
    kept = trainer.history[start:]
    return {"steps": [h["step"] for h in kept],
            "losses": [h["loss"] for h in kept],
            "grad_norms": [h["grad_norm"] for h in kept],
            "launches": ops.launch_counts()}


def _resumed(trainer, device) -> dict:
    """Resume a fresh trainer (its state initialised first) from its
    checkpoint directory, timed, digest its state and take the next
    step."""
    trainer.init_state()
    rest = timed_checkpoint(trainer, trainer.maybe_resume, device)
    if rest["result"] is not True or trainer.step != 1:
        raise AssertionError(f"resume: maybe_resume gave "
                             f"{rest['result']} at step {trainer.step}")
    digests = state_digests(trainer)
    return {"restore": rest, "digests": digests,
            **_resume_steps(trainer, 2)}


def resume_rank(mesh, jobs: list, S: int, B: int) -> list:
    """One rank of the resume phase, for each (kind, cfg, checkpoint dir)
    of ``jobs``: the saving run (``RESUME_SAVE``: a step, a save, the
    state's digests, a second step: the uninterrupted run), then each
    run of ``RESUME_ON`` resumed from its checkpoint."""
    from repro_torch.launch.mesh import make_mesh

    dev = mesh.device
    world = mesh.devices.size
    meshes = {s: make_mesh(*s, devices=[dev] * world, backend="gloo")
              for s in [RESUME_SAVE[1]] + [r[1] for r in RESUME_ON]}
    out = []
    for kind, cfg, ckpt_dir in jobs:
        label, shape, strategy, zero = RESUME_SAVE
        t = par_trainer(cfg, meshes[shape], strategy, zero, S, B, dev)
        t.tcfg.ckpt_dir = ckpt_dir
        t.init_state()
        first = _resume_steps(t, 1)
        save = timed_checkpoint(t, t.save, dev)
        digests = state_digests(t)
        second = _resume_steps(t, 2)
        run = {"kind": kind, "label": label, "save": save,
               "digests": digests, "first": first, "second": second,
               "resumed": []}
        del t
        gc.collect()
        empty_cache(dev)
        for _, shape, strategy, zero in RESUME_ON:
            t = par_trainer(cfg, meshes[shape], strategy, zero, S, B, dev)
            t.tcfg.ckpt_dir = ckpt_dir
            run["resumed"].append(_resumed(t, dev))
            del t
            gc.collect()
            empty_cache(dev)
        out.append(run)
    return out


def resume_phase(args, device="cuda", reduced=False) -> dict:
    """A sharded checkpoint resumed on other meshes, through the port's
    ``Trainer`` (``save``: ``Streamed`` leaves gathered a slice at a
    time; ``maybe_resume``: ``restore(select=)``, each rank reading its
    blocks), on 2 ranks that share ``device`` over gloo: full-width
    mamba2-780m (``reduced``: the reduced config, for a rehearsal on the
    CPU), f32 weights and AdamW state, bf16 compute, ``args["batch"]`` x
    ``args["seq_len"]`` tokens a step.  ``RESUME_SAVE`` takes a step,
    saves and takes step 2 (the uninterrupted run); each of
    ``RESUME_ON`` and one rank in this process resume step 1 and take
    step 2.  Then the same in f32 at ``RESUME_F32_LAYERS`` layers.  Free
    disk is checked first, and the checkpoints are removed at the end.
    Gates: the restored state's digests (every whole leaf) equal the
    saving run's at step 1; step 2's loss within ``PAR_BF16_TOL`` of the
    uninterrupted run's (f32: loss and gradient norm within
    ``PAR_LOSS_TOL`` relative); on the card each rank's peak while saving
    and while restoring at most the memory it held before the call + the
    largest slice handed out + 1 GiB, and the scan launched twice a layer
    a step on every rank.  Returns the bf16 runs' launches (main-path
    launches) and each resumed run's step-2 gaps."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.launch.mesh import launch_ranks, single_device_mesh

    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    S, B = args["seq_len"], args["batch"]
    cfg = (get_reduced_config if reduced else get_config)("mamba2-780m")
    f32cfg = dataclasses.replace(cfg, dtype="float32", num_layers=min(
        cfg.num_layers, RESUME_F32_LAYERS))
    t_phase = time.perf_counter()
    gc.collect()
    empty_cache(device)
    root = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    jobs = [("bf16", cfg, str(Path(root) / "bf16")),
            ("f32", f32cfg, str(Path(root) / "f32"))]
    # one checkpoint of each: f32 params + f32 AdamW m, v
    need = sum(3 * 4 * c.param_count() for _, c, _ in jobs)
    free = shutil.disk_usage(root).free
    log(f"  checkpoint dir {root}: {free / 1e9:.1f} GB free, the phase "
        f"writes {need / 1e9:.2f} GB")
    if free < need + 2**30:
        shutil.rmtree(root, ignore_errors=True)
        raise AssertionError(
            f"resume: {root} has {free / 1e9:.1f} GB free; the checkpoints "
            f"need {need / 1e9:.1f} GB (set TMPDIR to a larger disk)")
    try:
        t0 = time.perf_counter()
        ranks = launch_ranks(resume_rank, *RESUME_SAVE[1],
                             devices=[device] * 2, backend="gloo",
                             threads=None if on_card else 1,
                             args=(jobs, S, B))
        t_ranks = time.perf_counter() - t0
        for i, (kind, c, ckpt_dir) in enumerate(jobs):
            t = par_trainer(c, single_device_mesh(device), "fsdp_tp", 3, S,
                            B, device)
            t.tcfg.ckpt_dir = ckpt_dir
            ranks[0][i]["resumed"].append(_resumed(t, device))
            del t
            gc.collect()
            empty_cache(device)
        sizes = [sum(f.stat().st_size for f in Path(d).rglob("*")
                     if f.is_file()) for _, _, d in jobs]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches: dict = {}
    runs = []
    for i, (kind, c, _) in enumerate(jobs):
        per = [rk[i] for rk in ranks]
        ref = per[0]
        nbytes = sizes[i]
        ssm_layers = sum(k == "ssm" for k in c.layer_kinds())
        # the saving run, rank by rank: the save's seconds and peak
        for k, r in enumerate(per):
            sv = r["save"]
            limit = sv["held"] + sv["slice"] + 2**30
            log(f"  {kind} {c.num_layers} layers, {r['label']} rank {k}: "
                f"step 1 loss {r['first']['losses'][0]:.6f}; save "
                f"{sv['s']:.2f} s ({nbytes / 1e9:.2f} GB, "
                f"{nbytes / 1e9 / sv['s']:.2f} GB/s), peak "
                f"{sv['peak'] / 2**30:.2f} GiB against held "
                f"{sv['held'] / 2**30:.2f} + largest slice "
                f"{sv['slice'] / 2**20:.1f} MiB + 1 GiB = "
                f"{limit / 2**30:.2f} GiB; step 2 loss "
                f"{r['second']['losses'][0]:.6f} (uninterrupted)")
            if on_card and sv["peak"] > limit:
                raise AssertionError(f"resume {kind}: rank {k} peaked at "
                                     f"{sv['peak']} bytes saving, over "
                                     f"{limit}")
            want = 2 * 2 * ssm_layers           # 2 steps, remat reruns
            got = r["first"]["launches"]["ssd_scan"] + \
                r["second"]["launches"]["ssd_scan"]
            if on_card and got != want:
                raise AssertionError(f"resume {kind}: the saving run "
                                     f"launched ssd_scan {got} times on "
                                     f"rank {k}, not {want}")
            if kind == "bf16":
                for stage in ("first", "second"):
                    for name, n in r[stage]["launches"].items():
                        launches[name] = launches.get(name, 0) + n
        unint = ref["second"]
        # each resumed run's ranks (rank 0 holds the digests), then the
        # one-rank run of this process
        resumed = [(label, [rk[i]["resumed"][j] for rk in ranks])
                   for j, (label, *_) in enumerate(RESUME_ON)]
        resumed.append(("one rank", [ref["resumed"][-1]]))
        for label, everyone in resumed:
            x = everyone[0]
            same = x["digests"] == ref["digests"]
            gap = abs(x["losses"][0] - unint["losses"][0])
            rel = gap / abs(unint["losses"][0])
            grel = abs(x["grad_norms"][0] - unint["grad_norms"][0]) / abs(
                unint["grad_norms"][0])
            for k, y in enumerate(everyone):
                rs = y["restore"]
                limit = rs["held"] + ref["save"]["slice"] + 2**30
                log(f"  {kind}, resumed on {label}, rank {k}: restore "
                    f"{rs['s']:.2f} s ({nbytes / 1e9 / rs['s']:.2f} GB/s "
                    f"of the {nbytes / 1e9:.2f} GB checkpoint), peak "
                    f"{rs['peak'] / 2**30:.2f} GiB against held "
                    f"{rs['held'] / 2**30:.2f} + largest saved slice "
                    f"{ref['save']['slice'] / 2**20:.1f} MiB + 1 GiB = "
                    f"{limit / 2**30:.2f} GiB; launches {y['launches']}")
                if on_card and rs["peak"] > limit:
                    raise AssertionError(
                        f"resume {kind} on {label}: rank {k} peaked at "
                        f"{rs['peak']} bytes restoring, over {limit}")
                if on_card and y["launches"]["ssd_scan"] != 2 * ssm_layers:
                    raise AssertionError(
                        f"resume {kind} on {label}: ssd_scan launched "
                        f"{y['launches']['ssd_scan']} times on rank {k}, "
                        f"not {2 * ssm_layers}")
                if y["losses"] != x["losses"]:
                    raise AssertionError(f"resume {kind} on {label}: the "
                                         "ranks' losses differ")
                if kind == "bf16":
                    for name, n in y["launches"].items():
                        launches[name] = launches.get(name, 0) + n
            log(f"  {kind}, resumed on {label}: {len(x['digests'])} leaves' "
                f"digests {'equal' if same else 'DIFFER from'} the saving "
                f"run's at step 1; step 2 loss {x['losses'][0]:.6f} against "
                f"the uninterrupted {unint['losses'][0]:.6f} (difference "
                f"{gap:.2e}, {rel:.2e} relative), gradient norm "
                f"{x['grad_norms'][0]:.6f} against "
                f"{unint['grad_norms'][0]:.6f} ({grel:.2e} relative)")
            if x["steps"] != [2] or not same:
                raise AssertionError(f"resume {kind} on {label}: steps "
                                     f"{x['steps']}, digests equal {same}")
            if kind == "bf16" and not gap <= PAR_BF16_TOL:
                raise AssertionError(f"resume bf16 on {label}: step 2 loss "
                                     f"{gap} from the uninterrupted run's")
            if kind == "f32" and not (rel <= PAR_LOSS_TOL
                                      and grel <= PAR_LOSS_TOL):
                raise AssertionError(f"resume f32 on {label}: beyond "
                                     f"{PAR_LOSS_TOL} relative")
            runs.append({"kind": kind, "label": label, "gap": gap,
                         "rel": rel, "grel": grel})
    log(f"  ranks' launch {t_ranks:.1f} s, phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"runs": runs, "launches": launches}


# -------------------------------------------------------------- dry run ----

#: the production subset of the dry-run phase: (arch, shape, mesh), each a
#: rank of the production mesh on ``meta`` (``launch.dryrun.run_one``)
DRYRUN_SUBSET = (
    ("stablelm-3b", "train_4k", "single"),
    ("stablelm-3b", "prefill_32k", "single"),
    ("stablelm-3b", "decode_32k", "single"),
    ("stablelm-3b", "long_500k", "single"),
    ("mamba2-780m", "train_4k", "single"),
    ("qwen2-moe-a2.7b", "train_4k", "single"),
    ("jamba-1.5-large-398b", "train_4k", "single"),
    ("stablelm-3b", "train_4k", "multi"))
#: where the subset's records go (``results/`` is not committed)
DRYRUN_DIR = "results/dryrun_torch"
#: a dry-run peak against the measured one: at most this share apart
DRYRUN_PEAK_TOL = 0.10


def dryrun_subset(combos, outdir: str, reduced: bool = False) -> list:
    """Dry-run each (arch, shape, mesh) of ``combos`` as rank 0 of the
    production mesh, writing its record to ``outdir``: ``[(combo,
    seconds, record or the error)]``.  On ``meta`` only: no card is
    touched, so the card's phases may run beside it in another
    process."""
    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    out = []
    for arch, shape, mesh in combos:
        t0 = time.perf_counter()
        try:
            rec = dryrun.run_one(arch, shape, mesh, outdir, reduced=reduced)
        except Exception as e:         # noqa: BLE001 — reported, then fatal
            rec = f"{type(e).__name__}: {e}"
        out.append(((arch, shape, mesh), time.perf_counter() - t0, rec))
    return out


def _subset_main(combos, outdir, reduced, queue):
    queue.put(dryrun_subset(combos, outdir, reduced))


def start_dryrun_subset(outdir: str = DRYRUN_DIR, combos=DRYRUN_SUBSET,
                        reduced: bool = False):
    """Start the production subset in two processes of their own
    (``spawn``; CPU only), jamba-1.5-large-398b's step, the longest,
    alone in one, so that it runs beside the card's phases.  Returns
    ``(processes, queue)`` for :func:`dryrun_phase`."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    long = [c for c in combos if c[0] == "jamba-1.5-large-398b"]
    rest = [c for c in combos if c not in long]
    groups = [g for g in (long, rest) if g]
    procs = [ctx.Process(target=_subset_main,
                         args=(g, outdir, reduced, queue), daemon=True)
             for g in groups]
    for p in procs:
        p.start()
    return procs, queue


def _collect_subset(started, timeout: float) -> list:
    """The results of :func:`start_dryrun_subset`'s processes, which are
    then stopped; a process that dies without one fails the phase."""
    import queue as queue_mod

    procs, queue = started
    out, got, deadline = [], 0, time.perf_counter() + timeout
    try:
        while got < len(procs):
            try:
                out.extend(queue.get(timeout=1))
                got += 1
                continue
            except queue_mod.Empty:
                pass
            dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if dead or time.perf_counter() > deadline:
                raise AssertionError(
                    f"dry run: the production subset's processes ended "
                    f"{dead} without a result" if dead else
                    f"dry run: the production subset did not finish "
                    f"within {timeout:.0f} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    return out


def dryrun_phase(par, tp, args, device="cuda", reduced=False,
                 outdir=DRYRUN_DIR, runs=TRAIN_PAR_RUNS,
                 started=None, subset=DRYRUN_SUBSET) -> dict:
    """The production dry run (``repro_torch.launch.dryrun``: one rank's
    program on ``meta`` in a fake world) held to the card's runs.

    * Census: each of ``runs`` (phase 13's, ``par["runs"]`` by label) on
      the same config, mesh, strategy, ZeRO stage and ``args["batch"]`` x
      ``args["seq_len"]`` tokens (bf16 compute, f32 params, the plain
      route the dry run counts): its collectives by kind and the bytes
      handed over must equal phase 13's exactly; its peak (rank 0's) is
      printed beside the measured one and the reckoned limit, and on the
      card must lie within ``DRYRUN_PEAK_TOL`` of it.
    * The one-rank runs (``par["one_rank"]``): peak against the measured
      one (the same gate), counted flops a step, and the measured step's
      TF/s and MFU (6 N D model flops / step seconds / the data sheet's
      989e12 bf16 flop/s).
    * Decode census: the serve step of full-width stablelm-3b (reduced:
      the reduced config) under tp on 1 x 2, one token and a fused chunk
      of ``args["decode_chunk"]``, must reduce at attention-out and
      MLP-down ``psums_per_token`` times a token (``serving.tp``), as
      phase 12 counted (``tp["chunk"]``, where given); the training
      layout's vocab-parallel embedding adds one all-reduce and its head
      one all-gather a token.
    * The production subset (``subset``; reduced configs when
      ``reduced``), each combination timed, its record written to
      ``outdir`` and the roofline table printed: from ``started``
      (:func:`start_dryrun_subset`, run beside the card's phases) or
      here."""
    import dataclasses as dc

    from repro_torch.configs import InputShape, RunConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import virtual_mesh, virtual_world
    from repro_torch.serving import serve_step as ss
    from repro_torch.serving.tp import plan_tp

    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    cfgs, _ = _par_cfgs(reduced)
    S, B = args["seq_len"], args["batch"]
    shape = InputShape("par", S, B, "train")
    measured = {r["label"]: r for r in par["runs"]}

    def peak_line(what, dry, meas, limit=None):
        gap = (dry - meas) / meas if math.isfinite(meas) else float("nan")
        lim = "" if limit is None else f", reckoned limit {limit:.2f} GiB"
        log(f"    peak: dry run {dry:.2f} GiB, measured {meas:.2f} GiB "
            f"({gap:+.1%}){lim}")
        if on_card and not abs(gap) <= DRYRUN_PEAK_TOL:
            raise AssertionError(f"dry run {what}: peak {dry:.2f} GiB, "
                                 f"measured {meas:.2f} GiB")

    census = 0
    for label, arch, mesh_shape, strategy, zero, knobs in runs:
        run = RunConfig(strategy=strategy, zero_stage=zero, remat="layer",
                        **knobs)
        with virtual_world(0, mesh_shape[0] * mesh_shape[1]):
            got = dryrun.dry_run(cfgs[arch], run, shape,
                                 virtual_mesh(mesh_shape))
        want = measured[label]
        log(f"  {label}: dry run {got['calls']} a step, "
            f"{got['handed_bytes'] / 2**30:.3f} GiB handed over; phase 13 "
            f"{want['collectives']}, "
            f"{want['collective_bytes'] / 2**30:.3f} GiB; "
            f"{got['flops']:.4g} flops a step (rank 0)")
        if got["calls"] != want["collectives"] or \
                got["handed_bytes"] != want["collective_bytes"]:
            raise AssertionError(
                f"dry run {label}: census {got['calls']}, "
                f"{got['handed_bytes']} bytes; phase 13 counted "
                f"{want['collectives']}, {want['collective_bytes']} bytes")
        census += 1
        peaks = want["peak_gib"]
        meas = peaks[0] if isinstance(peaks, list) else peaks
        peak_line(label, got["peak_bytes"] / 2**30, meas, want["limit_gib"])
    for arch, one in par["one_rank"].items():
        cfg = cfgs[arch]
        with virtual_world(0, 1):
            got = dryrun.dry_run(cfg, RunConfig(remat="layer"), shape,
                                 virtual_mesh((1, 1)))
        model = dryrun.model_flops_global(cfg, shape)
        log(f"  one rank, {arch} ({cfg.num_layers} layers): dry run "
            f"{got['flops']:.4g} flops a step (model flops 6ND "
            f"{model:.4g}); measured {one['step_s']:.3f} s/step: "
            f"{got['flops'] / one['step_s'] / 1e12:.1f} TF/s counted, "
            f"{model / one['step_s'] / 1e12:.1f} TF/s model, MFU "
            f"{model / one['step_s'] / 989e12:.2%} of the data sheet's "
            "989e12 bf16 flop/s")
        peak_line(f"one rank {arch}", got["peak_bytes"] / 2**30,
                  one["peak_gib"])
    # ---- decode census: the TP phase's dense decode at 1 x 2
    cfg = cfgs["stablelm-3b"]
    chunk = args["decode_chunk"]
    run = RunConfig(strategy="tp", zero_stage=3)
    dshape = InputShape("d", args["cache_len"], args["slots"], "decode")
    with virtual_world(0, 2):
        mesh = virtual_mesh((1, 2))
        per_token = plan_tp(cfg, mesh).psums_per_token(cfg)
        got = {}
        for n, make, lower in ((1, ss.make_serve_step,
                                ss.serve_step_lowering_args),
                               (chunk, ss.make_fused_serve_step,
                                ss.fused_serve_step_lowering_args)):
            counts = {}
            kw = {} if n == 1 else {"num_tokens": n}
            step = make(cfg, run, mesh, dshape.global_batch,
                        dshape.seq_len, counts=counts, **kw)
            got[n] = (counts, dryrun.count_step(
                step, lower(cfg, run, mesh, dshape))["calls"])
        vocab = step.layout.plan.vocab
    for n, (counts, calls) in got.items():
        want = {k: v * n for k, v in per_token.items()}
        extra = {"all_reduce": n, "all_gather": n} if vocab else {}
        total = {k: v for k, v in {
            "all_reduce": sum(want.values()) + extra.get("all_reduce", 0),
            "all_gather": extra.get("all_gather", 0)}.items() if v}
        log(f"  decode, tp 1 x 2, {n} token step(s): reductions {counts} "
            f"(serving TP plan {want}"
            + ("" if tp is None else f"; phase 12 counted "
               f"{tp['chunk']['counts']} in a chunk of "
               f"{tp['chunk']['tokens']}")
            + f"); collectives {calls} (the vocab-parallel embedding and "
            f"head add {extra} under the training layout)")
        if counts != want or calls != total:
            raise AssertionError(f"dry run decode: {counts}, {calls}; "
                                 f"want {want}, {total}")
        if tp is not None and n == tp["chunk"]["tokens"] and \
                counts != tp["chunk"]["counts"]:
            raise AssertionError(f"dry run decode: {counts} against phase "
                                 f"12's {tp['chunk']['counts']}")
    # ---- the production subset
    if started is None:
        subset = dryrun_subset(subset, outdir, reduced)
    else:
        subset = _collect_subset(started, timeout=900)
    for (arch, sname, mesh), secs, rec in subset:
        if isinstance(rec, str):
            raise AssertionError(f"dry run {arch} x {sname} x {mesh}: {rec}")
        r, m = rec["roofline"], rec["memory"]
        log(f"  {arch} x {sname} x {mesh}: {secs:.1f} s; "
            f"{rec['cost']['flops_per_device']:.4g} flops, "
            f"{rec['cost']['hbm_bytes_per_device'] / 2**30:.1f} GiB moved, "
            f"{rec['cost']['link_bytes_per_device'] / 2**30:.2f} GiB over "
            f"links a rank; peak {m['peak_bytes'] / 2**30:.2f} GiB; "
            f"C {r['compute_s']:.3g} s, M {r['memory_s']:.3g} s, N "
            f"{r['collective_s']:.3g} s -> {r['bottleneck']} (data-sheet "
            "peaks)")
    root = str(Path(__file__).resolve().parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmarks import bench_roofline
    kept, bench_roofline.RESULTS = bench_roofline.RESULTS, outdir
    try:
        log(bench_roofline.table())
    finally:
        bench_roofline.RESULTS = kept
    log(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return {"census": census, "subset": [c for c, _, _ in subset]}


# -------------------------------------------------------------- examples ----

#: the examples phase: each twin of ``examples/torch`` that runs on the
#: card, the arguments it takes there (``train_cluster`` at full size
#: for 40 steps, in a fresh ``--ckpt-dir``; the serving tour's
#: sustained-load window 100 steps), and a pattern its last line of
#: output must match
EXAMPLES_CARD = (
    ("quickstart", (), r"^train_step_seconds\s+n=20\s"),
    ("train_cluster", ("--steps", "40"),
     r"^1\s+train_repro_100m\s.*\sCOMPLETED\s"),
    ("serve_batch", (), r"^req 2: prompt\[\d+\] -> \[.*\]\.\.\.$"),
    ("multi_tenant_serving", ("--load-steps", "100"),
     r"^\s*Tokens/round:\s"),
    ("elastic_serving", (), r"^replicas: \[.*\]  \(scale-ups total: \d+\)$"),
    ("tp_serving", (), r"^greedy outputs identical across TP degrees: True$"),
    ("pipeline_parallel", (), r"^after 10 steps: loss=\S+ \(decreasing\)$"))
#: the host-only twins (a simulated clock; no job touches a device), run
#: on the CPU beside the card's phases
EXAMPLES_HOST = (
    ("slurm_workflow", (), r"^1\s+long-train\s.*\sCOMPLETED\s"),
    ("multi_tenant", (), r"^preemptions: 1; sweep finished at t=\d+s"))
EXAMPLES_DIR = Path(__file__).resolve().parent / "examples" / "torch"


def _example_cmd(name: str, device: str, extra=()) -> list:
    return [sys.executable, str(EXAMPLES_DIR / f"{name}.py"), "--device",
            device, *extra]


def _example_env() -> dict:
    import os

    src = str(Path(__file__).resolve().parent / "src")
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=src + (os.pathsep + path if path
                                              else ""))


def start_examples(specs, device: str) -> list:
    """Start each twin of ``specs`` (``EXAMPLES_CARD`` or
    ``EXAMPLES_HOST``) as its own process with ``--device device``, all
    at once; a thread a process reads its output and notes when it
    ended.  ``train_cluster`` writes its checkpoints to a fresh
    directory.  Returns ``[(name, pattern, process, record)]`` for
    :func:`examples_phase` (and :func:`stop_processes`)."""
    import tempfile
    import threading

    started = []
    for name, extra, pattern in specs:
        record = {}
        if name == "train_cluster":
            record["tmp"] = tempfile.mkdtemp(prefix="chip_smoke_example_")
            extra = (*extra, "--ckpt-dir", record["tmp"])
        proc = subprocess.Popen(_example_cmd(name, device, extra),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                env=_example_env())
        record["t0"] = time.perf_counter()

        def wait(proc=proc, record=record):
            record["out"], record["err"] = proc.communicate()
            record["s"] = time.perf_counter() - record["t0"]

        record["thread"] = threading.Thread(target=wait, daemon=True)
        record["thread"].start()
        started.append((name, pattern, proc, record))
    return started


def stop_processes(started) -> None:
    """Kill what :func:`start_examples` started and is still running, and
    remove its checkpoint directories."""
    import shutil

    for _, _, proc, record in started or ():
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        if "tmp" in record:
            shutil.rmtree(record["tmp"], ignore_errors=True)


def _check_example(name, pattern, rc, out, err, secs, where) -> dict:
    lines = out.rstrip("\n").splitlines()
    last = lines[-1] if lines else ""
    log(f"  {name} ({where}): exit {rc}, {secs:.1f} s, {len(lines)} lines;"
        f" last: {last[:110]!r}")
    if rc != 0 or not re.search(pattern, last):
        tail = "\n    ".join((out + err).splitlines()[-30:])
        raise AssertionError(f"examples: {name} exited {rc} or its last "
                             f"line does not match {pattern!r}:\n    {tail}")
    return {"name": name, "s": secs, "where": where}


def examples_phase(started, where: str = "", timeout=600) -> list:
    """Wait for the twins :func:`start_examples` ``started`` and check
    each: fail on a non-zero exit or a last line that does not match its
    pattern.  Returns each run's seconds (from its start to its end;
    ``where`` says what ran beside it)."""
    out = []
    try:
        for name, pattern, proc, record in started:
            record["thread"].join(timeout)
            if record["thread"].is_alive():
                raise AssertionError(f"examples: {name} did not finish "
                                     f"within {timeout} s")
            out.append(_check_example(
                name, pattern, proc.returncode, record["out"],
                record["err"], record["s"],
                " ".join(proc.args[2:4]) + where))
    finally:
        stop_processes(started)
    return out


# -------------------------------------------------------------- cluster ----

def cluster_phase(tcfg, targs, scfg, sargs, reference, devices=None) -> dict:
    """The paper's §5.2.4 job-script workflow through the port's cluster
    layer in real mode, on a one-host inventory of the card(s): a
    scavenger job trains ``tcfg`` as phase 7 does (same seed, batches and
    options) to step ``2 * (requeue_count + 1)``, checkpointing every 2
    steps; at virtual t=600 s a high-QOS job that serves 4 requests of
    ``scfg`` (bf16, random weights, 16-line pages) preempts it; the
    training job requeues with the store's step as progress and, once the
    serve job ends, resumes from its checkpoint at step 3.  ``reference``
    holds phase 7's losses by step (index = step - 1); the job's losses
    must equal them bit for bit (the same seed, batches and options, the
    f32 state restored exactly).  The launch counts are set to 0 before
    each cluster action (submit, submit, run) and read after it; the
    phase's counts are their sums.  ``devices`` (default: every CUDA
    device) goes to ``mesh_for_job``."""
    import shutil
    import tempfile

    from repro_torch.cluster import (
        ClusterSpec, HostSpec, JobState, PartitionSpec, provision, validate,
    )
    from repro_torch.cluster import commands as C
    from repro_torch.cluster.meshbridge import mesh_for_job
    from repro_torch.configs import InputShape, RunConfig
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.models.model import cast_for_compute
    from repro_torch.monitoring import Tracer
    from repro_torch.optim import OptimizerConfig
    from repro_torch.training import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    n = torch.cuda.device_count() if devices is None else len(devices)
    spec = ClusterSpec("h100", (HostSpec("gpu-00", gres=(("gpu", n),)),),
                       (PartitionSpec("gpu", ("gpu-00",), default=True),))
    cluster = provision(spec, real_mode=True)
    report = validate(cluster, spec)
    log("  " + str(report).replace("\n", "\n  "))
    if not report.ok:
        raise AssertionError("cluster: the inventory failed validation")
    cluster.tracer = Tracer()
    log("  sinfo:\n    " + C.sinfo(cluster).replace("\n", "\n    "))

    B, S, micro = targs["batch"], targs["seq_len"], targs["microbatches"]
    run = RunConfig(use_kernels=True, remat="layer", microbatches=micro)
    times: dict = {"save": [], "restore": []}

    def train_script(job, alloc):
        device = mesh_for_job(cluster, job, devices=devices).devices.flat[0]
        trainer = Trainer(tcfg, run, None,
                          InputShape("cluster", S, B, "train"),
                          OptimizerConfig(), TrainerConfig(
                              steps=2 * (job.requeue_count + 1),
                              ckpt_every=2, ckpt_dir=job.checkpoint_dir,
                              seed=SEED), device=device)
        save = trainer.save

        def timed_save():
            t0 = time.perf_counter()
            save()
            times["save"].append(time.perf_counter() - t0)
        trainer.save = timed_save
        trainer.init_state()
        sync(device)
        t0 = time.perf_counter()
        resumed = trainer.maybe_resume()
        sync(device)
        if resumed:
            times["restore"].append(time.perf_counter() - t0)
        if resumed != (job.requeue_count > 0):
            raise RuntimeError(f"incarnation {job.requeue_count + 1}: "
                               f"resumed={resumed}")
        start = trainer.step
        trainer.train(log=lambda *_: None)
        for h in trainer.history:
            log(f"  train job {job.job_id} on {alloc[0]} ({device}), "
                f"incarnation {job.requeue_count + 1}: step {h['step']} "
                f"loss {h['loss']:.6f}, {h['sec']:.3f} s")
        return {"start": start, "history": [
            {k: h[k] for k in ("step", "loss", "sec")}
            for h in trainer.history]}

    def serve_script(job, alloc):
        device = mesh_for_job(cluster, job, devices=devices).devices.flat[0]
        t0 = time.perf_counter()
        params = cast_for_compute(init_params(scfg, SEED, device),
                                  torch.bfloat16)
        sync(device)
        load_s = time.perf_counter() - t0
        r = serve_phase(scfg, params, True, dict(sargs, requests=4),
                        device=device, label=f"serve job {job.job_id} on "
                        f"{alloc[0]} ({device}), paged")
        return dict(r, load_s=load_s)

    launches = dict.fromkeys(ops.launch_counts(), 0)
    first_device = devices[0] if devices else "cuda"

    def counted(action):
        gc.collect()
        torch.cuda.empty_cache()
        sync(first_device)
        ops.reset_launch_counts()
        out = action()
        sync(first_device)
        for name, k in ops.launch_counts().items():
            launches[name] += k
        return out

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # two checkpoints (steps 2 and 4) of f32 params + f32 AdamW m, v
        need = 2 * 3 * 4 * tcfg.param_count()
        free = shutil.disk_usage(ckpt_dir).free
        log(f"  checkpoint dir {ckpt_dir}: {free / 1e9:.1f} GB free, the "
            f"job writes 2 x {need / 2e9:.2f} GB")
        if free < need + 2**30:
            raise AssertionError(
                f"cluster: {ckpt_dir} has {free / 1e9:.1f} GB free; the "
                f"training job's two checkpoints need {need / 1e9:.1f} GB "
                "(set TMPDIR to a larger disk)")
        log("  " + counted(lambda: C.sbatch(
            cluster, name="mamba2-train", gres="gpu:1", time="02:00:00",
            run_time_s=3600, qos="scavenger", script=train_script,
            checkpoint_dir=ckpt_dir)))
        (train,) = [j for j in cluster.jobs.values()
                    if j.name == "mamba2-train"]
        if train.exit_code != 0:
            raise AssertionError(f"cluster: training job {train.job_id} "
                                 f"failed: {train.comment}")
        first = train.result          # the next incarnation replaces it
        cluster.clock = 600.0
        log("  " + counted(lambda: C.sbatch(
            cluster, name="stablelm-serve", gres="gpu:1", time="00:10:00",
            run_time_s=120, qos="high", script=serve_script)))
        (serve,) = [j for j in cluster.jobs.values()
                    if j.name == "stablelm-serve"]
        if serve.exit_code != 0:
            raise AssertionError(f"cluster: serve job {serve.job_id} "
                                 f"failed: {serve.comment}")
        track = ("cluster:root", f"job {train.job_id}")
        states = [sp for sp in cluster.tracer.spans(cat="state", track=track)]
        states += [sp for sp in cluster.tracer.open_spans()
                   if sp.cat == "state" and sp.track == track]
        log("  squeue:\n    " + C.squeue(cluster).replace("\n", "\n    "))
        log("  sprio:\n    " + C.sprio(cluster).replace("\n", "\n    "))
        names = [sp.name for sp in states]
        log(f"  train job {train.job_id}: {train.state.name}, requeue_count "
            f"{train.requeue_count}, progress_s {train.progress_s} (the "
            f"store's latest step), state spans {names}, last reason "
            f"{states[-1].attrs.get('reason')!r}")
        if (train.state != JobState.PENDING or train.requeue_count != 1
                or train.progress_s != 2.0
                or names != ["PENDING", "RUNNING", "PREEMPTED", "PENDING"]
                or states[-1].attrs.get("reason") != "Requeued"):
            raise AssertionError("cluster: the training job was not "
                                 "preempted and requeued with progress 2")
        stuck = counted(cluster.run)
        if stuck:
            raise AssertionError(f"cluster: jobs {stuck} never ran")
        failed = [j for j in cluster.jobs.values() if j.exit_code != 0]
        if failed:
            raise AssertionError("cluster: " + "; ".join(
                f"job {j.job_id} ({j.name}) exit {j.exit_code}: {j.comment}"
                for j in failed))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    log("  sacct:\n    " + C.sacct(cluster).replace("\n", "\n    "))
    log("  sshare:\n    " + C.sshare(cluster).replace("\n", "\n    "))
    log("  sdiag:\n    " + C.sdiag(cluster=cluster).replace("\n", "\n    "))
    segments = [r.state for r in cluster.accounting
                if r.job_id == train.job_id]
    if segments != ["PREEMPTED", "COMPLETED"]:
        raise AssertionError(f"cluster: training job segments {segments}")
    if train.result["start"] != 2 or serve.state != JobState.COMPLETED:
        raise AssertionError("cluster: the training job did not resume at "
                             "step 3, or the serve job did not complete")
    # both incarnations' losses against phase 7's uninterrupted run
    train_hist = first["history"] + train.result["history"]
    rows, worst, identical = [], 0.0, True
    for h in train_hist:
        want = reference[h["step"] - 1]
        rel = abs(h["loss"] - want) / abs(want)
        worst = max(worst, rel)
        identical &= h["loss"] == want
        rows.append(f"step {h['step']} {h['loss']!r} vs {want!r} "
                    f"(rel {rel:.3e})")
    log("  losses vs phase 7: " + "; ".join(rows) + (
        " — bit-identical" if identical else f" — max rel {worst:.3e}"))
    if [h["step"] for h in train_hist] != [1, 2, 3, 4] or not identical:
        raise AssertionError("cluster: the job's losses are not phase 7's "
                             "uninterrupted ones bit for bit")
    wall = time.perf_counter() - t_phase
    ssm_layers = sum(k == "ssm" for k in tcfg.layer_kinds())
    want = 4 * micro * ssm_layers * 2        # 4 steps, remat reruns
    on_card = torch.device(first_device).type == "cuda"
    log(f"  phase {wall:.1f} s; checkpoint save {times['save']} s, restore "
        f"{times['restore']} s; serve job {serve.result['tok_s']:.1f} tok/s "
        f"(weights {serve.result['load_s']:.2f} s); launches {launches}")
    if on_card and (launches["ssd_scan"] != want or not all(
            launches[k] for k in ("flash_attention", "flash_decode_paged"))):
        raise AssertionError(f"cluster: launches {launches}, expected "
                             f"ssd_scan {want} and the serve job's "
                             "attention kernels")
    return {"launches": launches, "wall_s": wall}


# ----------------------------------------------------------------- main ----

#: phase 13's shape and steps: one step a bf16 run and two an f32
#: identity run, no warm-up: gloo moves CUDA tensors through the host at
#: 0.2-1 GiB/s (scripts/train_collectives.py), a parallel step takes 10-40
#: s, and three a run put the script past half its time limit
PAR_ARGS = dict(seq_len=1024, batch=4, steps=1, f32_steps=2)


def run_train_parallel(tcfg, cfg, at) -> dict:
    """Phase 13's header and run on the card."""
    pargs = PAR_ARGS
    log(f"[13/17] {at()}: train parallel: full-width {cfg.name} (fsdp_tp "
        f"ZeRO 3 on 2 x 2 ranks, tp on 1 x 2, fsdp ZeRO 3 on 2 x 1), "
        f"{tcfg.name} (dp ZeRO 1 and 2 on 2 x 1, tp on 1 x 2) and "
        f"qwen2-moe-a2.7b at full width, {MOE_LAYERS} layers (one rank, "
        f"tp on 1 x 2: expert parallel, fsdp ZeRO 3 on 2 x 1), ranks "
        f"sharing the card over gloo, seed-{SEED} f32 weights, bf16 "
        f"compute, remat=layer, {pargs['batch']} x {pargs['seq_len']} "
        f"tokens a step, {pargs['steps']} step(s) a run; then f32 at 4 "
        f"layers ({MOE_F32_LAYERS} for qwen2-moe-a2.7b) against one rank, "
        f"{pargs['f32_steps']} steps a run")
    return train_parallel_phase(pargs)


def run_resume(tcfg, at) -> dict:
    """Phase 14's header and run."""
    log(f"[14/17] {at()}: resume: full-width {tcfg.name} (f32 weights and "
        f"AdamW, bf16 compute, {PAR_ARGS['batch']} x "
        f"{PAR_ARGS['seq_len']} tokens a step) saves under "
        f"{RESUME_SAVE[0]} after step 1 and takes step 2; resumed on "
        + ", ".join(r[0] for r in RESUME_ON) + " and one rank, each takes "
        f"step 2; then the same in f32 at {RESUME_F32_LAYERS} layers")
    return resume_phase(PAR_ARGS)


def run_dryrun(tpar, tp, args, at, started) -> dict:
    """Phase 15's header and run, after phase 13 in the same process."""
    log(f"[15/17] {at()}: dry run: each train-parallel run and one-rank "
        f"run of phase 13 on meta in a fake world (the plain route, bf16 "
        f"compute, {PAR_ARGS['batch']} x {PAR_ARGS['seq_len']} tokens), "
        f"census exact and peaks within {DRYRUN_PEAK_TOL:.0%} of phase "
        f"13's; the TP decode at 1 x 2; the production subset "
        f"({len(DRYRUN_SUBSET)} combinations, run beside the card's "
        "phases)")
    return dryrun_phase(tpar, tp, dict(PAR_ARGS, **args), started=started)


#: the phases ``--only`` may pick (``graphs``: phase 4's check of the
#: decode graphs)
ONLY = ("train-parallel", "resume", "examples", "graphs")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="build, then check and time every kernel "
                        "(phases 1-3 without the gradient checks) and "
                        "stop; prints no result line")
    parser.add_argument("--only", nargs="+", choices=ONLY,
                        help="build, then run these of phases 13-16 (or "
                        "phase 4's decode-graph check) alone "
                        "(train-parallel brings the dry run, which reads "
                        "its numbers) and stop; prints no result line")
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

    resolve_device("cuda")                 # pins TF32 off for f32 products
    t_start = time.perf_counter()

    def at() -> str:
        """Seconds since the start, for the phase headers."""
        return f"at {time.perf_counter() - t_start:.1f} s"

    log(f"[1/17] device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    build.build_all(verbose=True)
    log(f"[2/17] build: kernels built in {time.perf_counter() - t0:.1f} s "
        f"({build.BUILD_ROOT / build.source_hash()})")

    cfg = get_config("stablelm-3b")
    tcfg = get_config("mamba2-780m")
    targs = dict(batch=4, microbatches=2, seq_len=2048, steps=4)
    shape = dict(H=cfg.num_heads, K=cfg.num_kv_heads, Dh=cfg.head_dim,
                 slots=4, cache_len=512, prefill_len=128)
    only = set(opts.only or ONLY)
    started = hosts = None
    if not opts.kernels_only:
        # the dry run's production subset runs on meta, and the host-only
        # example twins on the CPU, beside the card
        if "train-parallel" in only:
            started = start_dryrun_subset()
        if "examples" in only:
            hosts = start_examples(EXAMPLES_HOST, "cpu")
    try:
        return _phases(opts, smi, cfg, tcfg, targs, shape, at, t_start,
                       started, hosts)
    finally:
        if started is not None:
            for p in started[0]:
                if p.is_alive():
                    p.terminate()
                p.join()
        stop_processes(hosts)


def run_examples(at, hosts, cards) -> list:
    """Phase 16's header and run: the card twins ``cards`` (started
    beside phase 15) and the host-only twins ``hosts``."""
    log(f"[16/17] {at()}: examples: each card twin of examples/torch as "
        f"its own process on the card ("
        + ", ".join(n for n, _, _ in EXAMPLES_CARD) + "), all started "
        "together beside phase 15 where it runs; the host-only twins ("
        + ", ".join(n for n, _, _ in EXAMPLES_HOST) + ") started on the "
        "CPU after the build, beside the card's phases")
    return (examples_phase(cards, ", beside each other and phase 15")
            + examples_phase(hosts, ", beside the card's phases"))


def main_path_launches(serve_runs, train, clus, par_runs,
                       resume) -> dict:
    """Each kernel's launches summed over the main path: the serve runs'
    (every kernel but the scan and the attention backward, which serving
    never runs), the kept train steps' scan and attention backward, the
    cluster phase's jobs, the train-parallel runs and the resume phase's
    steps."""
    from repro_torch.kernels import ops

    names = list(ops.launch_counts())
    trained = ("ssd_scan", "attention_bwd")
    launches = {name: sum(r["launches"][name] for r in serve_runs)
                for name in names if name not in trained}
    for name in trained:
        launches[name] = train["launches"].get(name, 0)
    for name in names:
        launches[name] += clus["launches"][name]
        launches[name] += sum(r["launches"][name] for r in par_runs)
        launches[name] += resume["launches"].get(name, 0)
    return launches


def _phases(opts, smi, cfg, tcfg, targs, shape, at, t_start,
            started, hosts) -> int:
    """Phases 3-17 of :func:`main`."""
    from repro_torch.models import init_params
    from repro_torch.models.model import cast_for_compute

    dargs = dict(slots=shape["slots"], cache_len=shape["cache_len"],
                 decode_chunk=8)
    if opts.only:
        if "graphs" in opts.only:
            log(f"[4/17] {at()}: decode graphs: full-width {cfg.name} and "
                "mamba2-780m, bf16, seed-0 weights")
            graph_phase(cfg, cast_for_compute(init_params(cfg, SEED, "cuda"),
                                              torch.bfloat16))
        if "train-parallel" in opts.only:
            tpar = run_train_parallel(tcfg, cfg, at)
        if "resume" in opts.only:
            run_resume(tcfg, at)
        cards = start_examples(EXAMPLES_CARD, "cuda") \
            if "examples" in opts.only else []
        try:
            if "train-parallel" in opts.only:
                run_dryrun(tpar, None, dargs, at, started)
            if "examples" in opts.only:
                run_examples(at, hosts, cards)
        finally:
            stop_processes(cards)
        log(f"only {' '.join(opts.only)}: stopped after "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    log(f"[3/17] {at()}: kernels vs plain versions (tolerance bf16 "
        f"{TOL[torch.bfloat16]}, f32 {TOL[torch.float32]}; times: median "
        "of 20 launches, L2 flushed, queued behind a sleep: device time "
        "only):")
    kernels = kernel_phase(shape)
    kernels.update(ssd_kernel_phase(tcfg, targs["batch"] //
                                    targs["microbatches"], targs["seq_len"]))
    # the decode step at granite-4.0-h-micro's serving shape (384 lanes)
    from repro_torch.configs import get_config as config_of
    kernels.update(ssd_decode_phase(config_of("granite-4.0-h-micro"), 384))
    kernels.update(attention_bwd_phase())
    grad_phase()
    if opts.kernels_only:
        log(f"kernels only: stopped after the kernels' checks and times "
            f"({time.perf_counter() - t_start:.1f} s)")
        return 0

    log(f"[4/17] {at()}: serve: full-width {cfg.name} ({cfg.num_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.num_heads} heads x "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), random "
        f"weights seed {SEED}, bf16 compute")
    params = cast_for_compute(init_params(cfg, SEED, "cuda"), torch.bfloat16)
    torch.cuda.synchronize()
    log(f"  params {cfg.param_count() / 1e9:.3f} B, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    args = dict(requests=8, slots=shape["slots"],
                cache_len=shape["cache_len"], max_new=32, decode_chunk=8)
    # the first run in the process pays one-time costs (cuBLAS set-up and
    # heuristics for each product shape), which would land on the dense
    # run; its first 5 requests use all three prefill buckets.  The dense
    # and paged runs take one wave of 4 requests (the serve modes' time
    # comes out of theirs); the budgeted mode runs all 8
    serve_phase(cfg, params, False, dict(args, requests=5),
                label="warm-up (dense, not kept)")
    dense = serve_phase(cfg, params, False, dict(args, requests=4))
    paged = serve_phase(cfg, params, True, dict(args, requests=4))
    profiles = {kind: profile_phase(cfg, params, args, kind == "paged")
                for kind in ("dense", "paged")}
    graph_phase(cfg, params)

    log(f"[5/17] {at()}: serve modes: full-width {cfg.name}, bf16, "
        f"{args['slots']} slots, cache {args['cache_len']}, 16-line pages, "
        f"decode chunk {args['decode_chunk']}, {args['requests']} requests "
        f"of {args['max_new']} tokens a run")
    modes = serve_modes_phase(cfg, params, args)
    plain_paths_phase(cfg, params, args)

    log(f"[6/17] {at()}: consistency at full width (kernels vs plain "
        "versions):")
    consistency_phase(cfg, params)
    del params
    torch.cuda.empty_cache()
    log(f"  {at()}: greedy identity of the serve modes with the classic "
        f"paged engine: full-width {cfg.name} in f32, depth cut to 4 layers")
    identity_phase(cfg, args)
    torch.cuda.empty_cache()

    ssm = tcfg.ssm
    log(f"[7/17] {at()}: train: full-width {tcfg.name} ({tcfg.num_layers} "
        f"layers, d_model {tcfg.d_model}, {ssm.num_heads(tcfg.d_model)} SSD "
        f"heads x {ssm.head_dim}, state {ssm.state}, chunk {ssm.chunk}, vocab "
        f"{tcfg.vocab_size}), f32 weights seed {SEED}, bf16 compute, f32 "
        f"AdamW, remat=layer, {targs['batch']} x {targs['seq_len']} tokens "
        f"in {targs['microbatches']} microbatches")
    train = train_phase(tcfg, targs, kernels["ssd_scan"]["ms"])
    torch.cuda.empty_cache()

    log(f"[8/17] {at()}: train consistency at full width (kernels vs plain "
        "vs f32):")
    train_consistency_phase(tcfg, targs)
    torch.cuda.empty_cache()

    log(f"[9/17] {at()}: cluster: a scavenger job trains {tcfg.name} as "
        f"phase 7 does, a high-QOS job serving {cfg.name} preempts it, it "
        "requeues and resumes from its checkpoint")
    clus = cluster_phase(tcfg, targs, cfg, args, train["losses"])
    torch.cuda.empty_cache()

    log(f"[10/17] {at()}: families: SSM serving of mamba2-780m, MoE "
        f"serving of qwen2-moe-a2.7b, starcoder2-3b; full width, "
        f"{args['slots']} slots, cache {args['cache_len']}, one wave of 4 "
        f"requests of {args['max_new']} tokens a run (two for n-gram "
        f"speculation), decode chunk {args['decode_chunk']}")
    fam = families_phase(dict(args, requests=4))

    log(f"[11/17] {at()}: elastic: full-width {cfg.name} replicas sharing "
        f"one card and one bf16 weight set behind the router; "
        f"{args['slots']} slots, cache {args['cache_len']}, decode chunk "
        f"{args['decode_chunk']} a replica; {args['requests']} requests "
        f"of {args['max_new']} tokens in two waves, behind two 64-token "
        "system prompts in turn")
    elastic = elastic_phase(args)

    log(f"[12/17] {at()}: tensor parallel: full-width {cfg.name} split "
        f"over two ranks sharing the card (gloo), {cfg.num_heads // 2} of "
        f"{cfg.num_heads} heads and {cfg.d_ff // 2} of d_ff {cfg.d_ff} a "
        f"rank, bf16; {args['slots']} slots, cache {args['cache_len']}, "
        f"decode chunk {args['decode_chunk']}, 4 greedy requests of "
        f"{args['max_new']} tokens a run; dense, then 16-line pages with "
        "the prefix cache; then f32 at 4 layers against tp=1")
    tp = tp_phase(dict(args, requests=4))

    tpar = run_train_parallel(tcfg, cfg, at)
    resume = run_resume(tcfg, at)
    # the card twins are small: they run beside the dry run, on meta
    cards = start_examples(EXAMPLES_CARD, "cuda")
    try:
        dry = run_dryrun(tpar, tp, dict(dargs, decode_chunk=args[
            "decode_chunk"]), at, started)
        examples = run_examples(at, hosts, cards)
    finally:
        stop_processes(cards)

    # the main path's serve runs: the f32 4-layer identity runs are a
    # check, not the path, and log their launches on their own line
    serve_runs = [dense, paged, *modes.values(), *fam["runs"],
                  *elastic["runs"], *tp["runs"]]
    launches = main_path_launches(serve_runs, train, clus, tpar["runs"],
                                  resume)
    summary = {name: {"max_abs_err": r["max_abs_err"],
                      "launches": launches[name]}
               for name, r in kernels.items()}
    mode_rates = ", ".join(f"{label} {r['tok_s']:.1f}"
                           for label, r in modes.items())
    fam_rates = ", ".join(f"{r['label']} {r['tok_s']:.1f}"
                          for r in fam["runs"])
    elastic_rates = ", ".join(f"{r['label']} {r['tok_s']:.1f}"
                              for r in elastic["runs"])
    tp_rates = ", ".join(f"{r['label']} {r['tok_s']:.1f} (tp=1 "
                         f"{r['tp1_tok_s']:.1f})" for r in tp["runs"])
    par_steps = ", ".join(f"{r['label']} {r['step_s']:.2f} s/step "
                          f"(collectives {r['coll_share']:.0%})"
                          for r in tpar["runs"])
    resumes = ", ".join(f"{r['kind']} on {r['label']} {r['gap']:.1e}"
                        for r in resume["runs"])
    ex_secs = ", ".join(f"{r['name']} {r['s']:.1f} s" for r in examples)
    log(f"[17/17] summary ({time.perf_counter() - t_start:.1f} s; serve "
        f"dense {dense['tok_s']:.1f} tok/s, paged {paged['tok_s']:.1f} "
        f"tok/s; modes {mode_rates} tok/s; decode kernel per token step "
        f"dense "
        f"{profiles['dense']['decode_ms_per_step']} ms, paged "
        f"{profiles['paged']['decode_ms_per_step']} ms; train "
        f"{train['tok_s']:,.0f} tok/s, {train['step_s']:.3f} s/step, peak "
        f"{train['peak_gib']:.2f} GiB; cluster phase {clus['wall_s']:.1f} "
        f"s, losses bit-identical to phase 7's; families {fam_rates} "
        f"tok/s; elastic {elastic_rates} tok/s wall; {tp_rates} tok/s; "
        f"train parallel {par_steps}; f32 identity "
        f"{len(tpar['identity'])}/{len(tpar['identity'])}; resumed "
        f"bit-identical, step 2 loss gaps {resumes}; dry run census "
        f"{dry['census']}/{len(TRAIN_PAR_RUNS)} exact, "
        f"{len(dry['subset'])} production combinations; examples "
        f"{ex_secs}; launches summed over the main path: the bf16 serve "
        "runs (dense, paged, the four modes, the families' five runs, the "
        "elastic phase's five, the TP phase's two on both ranks), the kept "
        "train steps, the cluster phase's two jobs, the train-parallel "
        f"phase's {len(TRAIN_PAR_RUNS)} runs on every rank and the resume "
        "phase's bf16 steps on every rank)")
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
