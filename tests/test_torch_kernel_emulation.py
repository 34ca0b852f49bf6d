"""The CUDA sources of the decode kernel (dense and paged), the attention
kernel, its backward and the SSD scan's four kernels, built for the CPU by
``kernels/host_emulation.py`` (g++ against stand-in CUDA headers: one
host thread per CUDA thread, the PTX helpers written from the PTX ISA's
fragment layouts), driven through the wrappers' own argument lists and
held against the plain versions on the same numpy inputs.  This checks
the kernels' indexing, masking, split plan and combine, the tensor-core
fragment layouts and races between threads, without a card; it says
nothing about speed, and a missing ``cp.async`` wait would not show.

The cases run in a subprocess with a time limit (a kernel whose
barriers do not match would hang its emulation), built once; the
backward's cases in a second one.

Tolerance: 2e-5 in f32 (summation order); 2e-2 in bf16 outputs (one
bf16 rounding of outputs of magnitude up to ~2); the scan relative, as
``chip_smoke.py`` checks it (each element within TOL * (1 + |plain|)).
The backward's bf16 gradients against autograd through the plain version
in f32: each element within 2^-8 |plain| (one bf16 rounding of the f32
gradient) + BWD_TOL x the largest |plain| (f32 sums in another order, P
and dS carried as two bf16 terms: 16 bits); its f32 LSE and D within
BWD_STAT_TOL x (1 + |plain|) (f32 sums in another order; D = dO . O over
an O whose P.V products keep 16 bits of P)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
BWD_TOL, BWD_STAT_TOL = 1e-5, 1e-4

# (B, S, H, K, Dh, window, q dtype, kv dtype, positions, SMs of the split
# plan)
DECODE_CASES = {
    "stablelm-splits-bf16": (3, 96, 4, 2, 80, None, "bfloat16", "bfloat16",
                             [95, 31, 32], 4),
    "split-edges-f32": (4, 96, 2, 2, 64, None, "float32", "float32",
                        [0, 31, 32, 63], 4),
    "f32-over-bf16": (2, 64, 2, 1, 80, None, "float32", "bfloat16",
                      [40, 63], 4),
    "qwen2-gqa7-dh128": (2, 64, 7, 1, 128, None, "bfloat16", "bfloat16",
                         [63, 10], 4),
    "ring-wrapped": (3, 64, 4, 2, 32, 64, "bfloat16", "bfloat16",
                     [200, 63, 5], 4),
    "ring-window-past-slots": (2, 48, 4, 2, 24, 64, "float32", "float32",
                               [150, 20], 4),
    "tail-bf16-dh20": (2, 70, 2, 1, 20, None, "bfloat16", "bfloat16",
                       [69, 33], 4),
    "tail-f32-dh3": (2, 70, 3, 1, 3, None, "float32", "float32", [69, 33],
                     4),
    "one-split": (2, 40, 2, 2, 64, None, "bfloat16", "bfloat16", [39, 0],
                  132),
    # the speculative draft model (1 layer, 2 heads of 32, its own dense
    # cache per slot): H = K = 2, Dh 32, in both compute dtypes
    "draft-dh32-bf16": (4, 96, 2, 2, 32, None, "bfloat16", "bfloat16",
                        [95, 40, 7, 0], 4),
    "draft-dh32-f32": (4, 96, 2, 2, 32, None, "float32", "float32",
                       [95, 40, 7, 0], 4),
    # the head layouts of qwen2-moe-a2.7b (MHA at Dh 128: one query head
    # a kv head) and starcoder2-3b (12 query heads a kv head of 128), with
    # fewer kv heads than the models (each kv head is its own block)
    "qwen2moe-mha-dh128-bf16": (2, 64, 4, 4, 128, None, "bfloat16",
                                "bfloat16", [63, 20], 4),
    "qwen2moe-mha-dh128-f32": (2, 64, 4, 4, 128, None, "float32",
                               "bfloat16", [63, 20], 4),
    "starcoder2-gqa12-bf16": (2, 64, 12, 1, 128, None, "bfloat16",
                              "bfloat16", [63, 31], 4),
    "starcoder2-gqa12-f32": (2, 64, 12, 1, 128, None, "float32",
                             "float32", [63, 31], 4),
}

# (B, n_pages in a table row, page size, H, K, Dh, q dtype, kv dtype,
# positions, SMs of the split plan).  Pages past a sequence's last live
# page are the null page (0), except where the table is wider than the
# live lines ("wide-table": real pages past pos); every pool line that no
# sequence attends holds NaN, so a read of one would show in the output.
PAGED_CASES = {
    "ps16-null-bf16": (3, 8, 16, 4, 2, 80, "bfloat16", "bfloat16",
                       [127, 40, 16], 4),
    "ps8-null-f32": (2, 12, 8, 2, 2, 64, "float32", "float32", [95, 7], 4),
    "f32-over-bf16": (2, 6, 16, 2, 1, 80, "float32", "bfloat16", [60, 95],
                      4),
    "qwen2-gqa7-dh128": (2, 4, 16, 7, 1, 128, "bfloat16", "bfloat16",
                         [63, 30], 4),
    "wide-table": (2, 16, 8, 4, 2, 80, "bfloat16", "bfloat16", [37, 100],
                   4),
    "dh20-tail-ps8": (2, 10, 8, 2, 1, 20, "bfloat16", "bfloat16", [79, 8],
                      4),
    "one-split": (2, 4, 16, 2, 2, 64, "bfloat16", "bfloat16", [63, 0], 132),
    "many-splits-ps8": (1, 32, 8, 3, 3, 32, "float32", "float32", [255],
                        32),
    # 12-line pages: split boundaries (multiples of 32 lines) fall inside
    # pages
    "ps12-straddles-splits": (2, 11, 12, 4, 2, 64, "bfloat16", "bfloat16",
                              [130, 50], 8),
    # qwen2-moe-a2.7b's MHA and starcoder2-3b's 12-way groups, Dh 128
    "qwen2moe-mha-dh128-bf16": (2, 4, 16, 4, 4, 128, "bfloat16",
                                "bfloat16", [63, 30], 4),
    "qwen2moe-mha-dh128-f32": (2, 4, 16, 4, 4, 128, "float32",
                               "float32", [63, 30], 4),
    "starcoder2-gqa12-bf16": (2, 4, 16, 12, 1, 128, "bfloat16", "bfloat16",
                              [63, 30], 4),
    "starcoder2-gqa12-f32": (2, 4, 16, 12, 1, 128, "float32", "bfloat16",
                             [63, 30], 4),
}

# (B, S, H, P, N, chunk target, dtype, A and dt or None): x, Bm and Cm
# are slices of one (B, S, H*P + 2N) buffer, as ``ssm_train`` hands them
# over; the chunk is ``ops._pick_block(S, target)``.  dt is drawn from
# [1e-3, 0.1) and A from (-4, -0.5] unless the case fixes them.
SCAN_CASES = {
    "n16-two-chunks-bf16": (2, 128, 2, 32, 16, 64, "bfloat16", None),
    "pick-block-48-n128-bf16": (1, 96, 2, 64, 128, 64, "bfloat16", None),
    "pick-block-48-n128-f32": (1, 96, 2, 64, 128, 64, "float32", None),
    # P 20: x's rows are not 16-byte aligned in bf16 (scalar loads)
    "p20-n8-bf16": (1, 96, 2, 20, 8, 32, "bfloat16", None),
    "p20-n8-f32": (1, 96, 2, 20, 8, 32, "float32", None),
    "eight-chunks-bf16": (1, 256, 1, 16, 16, 32, "bfloat16", None),
    # a chunk of two q tiles (the second ragged) and their k tiles
    "q96-two-tiles-bf16": (1, 192, 2, 16, 32, 96, "bfloat16", None),
    "q96-two-tiles-f32": (1, 192, 2, 16, 32, 96, "float32", None),
    # N 12: S_in rows of 24 bytes (element copies of the state)
    "n12-bf16": (1, 64, 2, 16, 12, 32, "bfloat16", None),
    # P 80: two P tiles, the second 16 wide
    "p80-two-p-tiles-bf16": (1, 64, 1, 80, 16, 64, "bfloat16", None),
    # a 256-token chunk whose decays span the f32 range: cs reaches -102
    "decays-span-f32-range-bf16": (1, 512, 1, 16, 16, 256, "bfloat16",
                                   (-4.0, 0.1)),
}

# (B, S, H, K, Dh, window[, dtype]): in bf16 a block is 16 q rows whose
# kv tiles of 16 lines its 4 warps take in turn; f32 runs the FMA kernel
ATTN_CASES = {
    "dh80": (1, 40, 2, 1, 80, None),
    "dh80-kv-heads": (1, 70, 2, 2, 80, None),
    "gqa-dh128": (2, 33, 4, 2, 128, None),
    "s1": (1, 1, 2, 1, 80, None),
    "dh72-window": (1, 50, 2, 1, 72, 16),
    "dh64-window": (1, 37, 2, 1, 64, 8),
    "dh20-tail": (1, 20, 2, 1, 20, None),
    "dh32-b2": (2, 29, 2, 1, 32, None),
    "several-tiles-a-warp": (1, 200, 1, 1, 80, None),
    # the draft model's prefill: H = K = 2, Dh 32, a bucket of 32
    "draft-dh32-bf16": (1, 32, 2, 2, 32, None),
    "draft-dh32-f32": (1, 32, 2, 2, 32, None, "float32"),
    # qwen2-moe-a2.7b's prefill layout (MHA at Dh 128) and starcoder2-3b's
    # (12 query heads a kv head of 128)
    "qwen2moe-mha-dh128-bf16": (1, 40, 2, 2, 128, None),
    "qwen2moe-mha-dh128-f32": (1, 40, 2, 2, 128, None, "float32"),
    "starcoder2-gqa12-bf16": (1, 40, 12, 1, 128, None),
    "starcoder2-gqa12-f32": (1, 40, 12, 1, 128, None, "float32"),
}

# (B, S, H, K, Dh, window, scale): the backward in bf16; a block owns 64
# rows, its 4 warps 16 each, and streams the other side's 64-line tiles
BWD_CASES = {
    "dh80-s100": (1, 100, 2, 2, 80, None, None),
    "dh128-s100": (1, 100, 2, 2, 128, None, None),
    "dh72-scale": (1, 100, 2, 2, 72, None, 1 / 64),
    "gqa4-dh80": (1, 100, 4, 1, 80, None, None),
    "window-dh80": (1, 100, 2, 2, 80, 24, None),
    "gqa4-window-dh128-scale": (1, 100, 4, 1, 128, 16, 1 / 64),
    "dh20-tail-b2": (2, 70, 2, 1, 20, None, None),
    "s1": (1, 1, 2, 1, 80, None, None),
    "four-tiles-dh64": (1, 200, 1, 1, 64, None, None),
    "four-tiles-window-dh64": (1, 200, 2, 1, 64, 80, None),
}


def _pad_view(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """x in storage whose last axis is padded to ``multiple`` elements,
    so every stride is a multiple of 16 bytes (as the wrappers demand)."""
    width = -(-x.shape[-1] // multiple) * multiple
    buf = torch.zeros(*x.shape[:-1], width, dtype=x.dtype)
    buf[..., :x.shape[-1]] = x
    return buf[..., :x.shape[-1]]


def _run_cases(out_dir: str) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import host_emulation, ops, ref
    from repro_torch.kernels import ssd_scan as ssd

    lib_d = host_emulation.build("flash_decode", out_dir)
    lib_a = host_emulation.build("flash_attention", out_dir)
    errs = {}
    for i, (name, case) in enumerate(DECODE_CASES.items()):
        B, S, H, K, Dh, window, qdt, kvdt, pos, sms = case
        rng = np.random.default_rng(100 + i)
        qdt, kvdt = getattr(torch, qdt), getattr(torch, kvdt)
        per16 = 16 // kvdt.itemsize
        q = torch.from_numpy(rng.standard_normal((B, 1, H, Dh),
                                                 np.float32)).to(qdt)
        k, v = (_pad_view(torch.from_numpy(rng.standard_normal(
            (B, S, K, Dh), np.float32)).to(kvdt), per16) for _ in range(2))
        p = torch.tensor(pos, dtype=torch.int32)
        chunk, n = fd.split_plan(S, B, K, sms)
        o = torch.empty_like(q)
        part = torch.full((B * K * n * (H // K) * (Dh + 2),), float("nan"))
        counter = torch.zeros(B * K, dtype=torch.int32)
        err = lib_d.repro_flash_decode(*fd.dense_args(
            q, k, v, o, p, part, counter, window, chunk, None))
        want = ref.decode_attention_ref(q, k, v, p, window=window)
        errs["decode/" + name] = dict(
            err=err, max_abs=float((o.float() - want.float()).abs().max()),
            dtype=str(qdt)[6:], counters=int(counter.abs().sum()), splits=n)
    for i, (name, case) in enumerate(PAGED_CASES.items()):
        B, n_tab, ps, H, K, Dh, qdt, kvdt, pos, sms = case
        rng = np.random.default_rng(300 + i)
        qdt, kvdt = getattr(torch, qdt), getattr(torch, kvdt)
        per16 = 16 // kvdt.itemsize
        num_pages = B * n_tab + 1
        table = (rng.permutation(num_pages - 1) + 1).reshape(B, n_tab)
        if name != "wide-table":
            for b, p_ in enumerate(pos):
                table[b, p_ // ps + 1:] = 0
        # live lines random, every other pool line NaN (zero for the plain
        # version, which masks by position after its gather)
        live = np.zeros((num_pages, ps), bool)
        for b, p_ in enumerate(pos):
            for j in range(p_ + 1):
                live[table[b, j // ps], j % ps] = True
        q = torch.from_numpy(rng.standard_normal((B, 1, H, Dh),
                                                 np.float32)).to(qdt)
        kv = []
        for _ in range(2):
            x = rng.standard_normal((num_pages, ps, K, Dh), np.float32)
            x = torch.from_numpy(x).to(kvdt)
            x[~torch.from_numpy(live)] = float("nan")
            kv.append(_pad_view(x, per16))
        k, v = kv
        tab = torch.from_numpy(table.astype(np.int32))
        p = torch.tensor(pos, dtype=torch.int32)
        chunk, n = fd.split_plan(n_tab * ps, B, K, sms)
        o = torch.empty_like(q)
        part = torch.full((B * K * n * (H // K) * (Dh + 2),), float("nan"))
        counter = torch.zeros(B * K, dtype=torch.int32)
        err = lib_d.repro_flash_decode_paged(*fd.paged_args(
            q, k, v, o, tab, p, part, counter, chunk, None))
        want = ref.paged_decode_attention_ref(
            q, k.nan_to_num(0.0), v.nan_to_num(0.0), tab, p)
        errs["paged/" + name] = dict(
            err=err, max_abs=float((o.float() - want.float()).abs().max()),
            dtype=str(qdt)[6:], counters=int(counter.abs().sum()), splits=n)
    lib_s = host_emulation.build("ssd_scan", out_dir)
    for i, (name, case) in enumerate(SCAN_CASES.items()):
        B, S, H, P, N, target, dtype, fixed = case
        rng = np.random.default_rng(400 + i)
        dtype = getattr(torch, dtype)
        u = torch.from_numpy(rng.standard_normal(
            (B, S, H * P + 2 * N), np.float32)).to(dtype)
        x = u[..., :H * P].reshape(B, S, H, P)
        Bm, Cm = u[..., H * P:H * P + N], u[..., H * P + N:]
        if fixed is None:
            dt = rng.uniform(1e-3, 0.1, (B, S, H)).astype(np.float32)
            A = -rng.uniform(0.5, 4.0, H).astype(np.float32)
        else:
            A = np.full(H, fixed[0], np.float32)
            dt = np.full((B, S, H), fixed[1], np.float32)
        dt = torch.from_numpy(dt)
        a = dt * torch.from_numpy(A)
        Q = ops._pick_block(S, target)
        y = torch.full(x.shape, float("nan"), dtype=dtype)
        scratch = [t.fill_(float("nan")) for t in ssd.scratch(x, N, Q)]
        err = lib_s.repro_ssd_scan(*ssd.scan_args(
            x, dt, a, Bm, Cm, y, *scratch, Q, None))
        want = ref.ssd_scan_ref(x, dt, a, Bm, Cm, Q).float()
        tol = TOL[str(dtype)[6:]]
        diff = (y.float() - want).abs()
        errs["scan/" + name] = dict(
            err=err, max_abs=float(diff.max()),
            excess=float((diff - tol * want.abs()).max()),
            dtype=str(dtype)[6:], counters=0, splits=0, chunk=Q)
    for i, (name, case) in enumerate(ATTN_CASES.items()):
        B, S, H, K, Dh, window = case[:6]
        dtype = getattr(torch, case[6] if len(case) > 6 else "bfloat16")
        rng = np.random.default_rng(200 + i)
        q, k, v = (_pad_view(torch.from_numpy(rng.standard_normal(
            (B, S, n, Dh), np.float32)).to(dtype), 16 // dtype.itemsize)
            for n in (H, K, K))
        o = torch.empty(q.shape, dtype=q.dtype)
        err = lib_a.repro_flash_attention(*fa.attention_args(
            q, k, v, o, window, None))
        want = ref.attention_ref(q, k, v, window=window)
        errs["attention/" + name] = dict(
            err=err, max_abs=float((o.float() - want.float()).abs().max()),
            dtype=str(dtype)[6:], counters=0, splits=0)
    return errs


def _run_bwd_cases(out_dir: str) -> dict:
    """The backward source on each case's bf16 inputs (NaN in every
    output and scratch element first), against autograd through
    ``ref.attention_ref`` in f32 on the same values."""
    from repro_torch.kernels import attention_bwd as ab
    from repro_torch.kernels import host_emulation, ref

    lib = host_emulation.build("attention_bwd", out_dir)
    errs = {}
    for i, (name, case) in enumerate(BWD_CASES.items()):
        B, S, H, K, Dh, window, scale = case
        rng = np.random.default_rng(500 + i)
        q, k, v, do = (_pad_view(torch.from_numpy(rng.standard_normal(
            (B, S, n, Dh), np.float32)).to(torch.bfloat16), 8)
            for n in (H, K, K, H))
        grads = [torch.full(t.shape, float("nan"), dtype=torch.bfloat16)
                 for t in (q, k, v)]
        lse, delta = torch.full((2, B, H, S), float("nan"))
        err = lib.repro_attention_bwd(*ab.bwd_args(
            q, k, v, do, *grads, lse, delta, window, None, scale))
        ins = [t.float().requires_grad_(True) for t in (q, k, v)]
        o = ref.attention_ref(*ins, window=window, scale=scale)
        want = torch.autograd.grad(o, ins, do.float())
        # the plain logits' logsumexp and rowsum(dO . O), (B, H, S)
        G = H // K
        logits = torch.einsum(
            "bqhd,bkhd->bhqk", ins[0].detach(),
            ins[1].detach().repeat_interleave(G, 2)) * \
            ref.logits_scale(Dh, scale)
        pos = torch.arange(S)
        mask = pos[None, :] <= pos[:, None]
        if window is not None:
            mask &= (pos[:, None] - pos[None, :]) < window
        lse_want = torch.logsumexp(logits.masked_fill(~mask, -torch.inf),
                                   -1)
        d_want = (do.float() * o.detach()).sum(-1).transpose(1, 2)
        r = dict(err=err)
        for n, g, w in zip(("dq", "dk", "dv"), grads, want):
            r[n] = float((((g.float() - w).abs() - 2.0 ** -8 * w.abs())
                          / max(1.0, float(w.abs().max()))).max())
        r["lse"] = float(((lse - lse_want).abs()
                          / (1 + lse_want.abs())).max())
        r["delta"] = float(((delta - d_want).abs() / (1 + d_want.abs()))
                           .max())
        errs[name] = r
    return errs


def _emulate(out, *mode):
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(out), *mode],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return _emulate(tmp_path_factory.mktemp("host_emulation"))


@pytest.fixture(scope="module")
def emulated_bwd(tmp_path_factory):
    return _emulate(tmp_path_factory.mktemp("host_emulation_bwd"), "bwd")


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_source_matches_plain(emulated, name):
    r = emulated["decode/" + name]
    assert r["err"] == 0                  # the launch was taken
    assert r["counters"] == 0             # every counter left at zero
    assert r["max_abs"] <= TOL[r["dtype"]], r


@pytest.mark.parametrize("name", list(PAGED_CASES))
def test_paged_decode_source_matches_plain(emulated, name):
    r = emulated["paged/" + name]
    assert r["err"] == 0
    assert r["counters"] == 0
    assert r["max_abs"] <= TOL[r["dtype"]], r


@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_ssd_scan_source_matches_plain(emulated, name):
    """Relative, as chip_smoke.py checks the scan: each element within
    TOL * (1 + |plain|); NaN anywhere (y and the scratch start as NaN)
    fails."""
    r = emulated["scan/" + name]
    assert r["err"] == 0
    assert r["excess"] <= TOL[r["dtype"]], r


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_attention_source_matches_plain(emulated, name):
    r = emulated["attention/" + name]
    assert r["err"] == 0
    assert r["max_abs"] <= TOL[r["dtype"]], r


@pytest.mark.parametrize("name", list(BWD_CASES))
def test_attention_bwd_source_matches_plain_autograd(emulated_bwd, name):
    """dq, dk, dv (bf16) within one bf16 rounding of autograd's f32
    gradients plus BWD_TOL of the largest; the pre-pass's LSE and D
    within BWD_STAT_TOL x (1 + |plain|).  NaN anywhere fails."""
    r = emulated_bwd[name]
    assert r["err"] == 0
    for n in ("dq", "dk", "dv"):
        assert r[n] <= BWD_TOL, (n, r)
    assert r["lse"] <= BWD_STAT_TOL, r
    assert r["delta"] <= BWD_STAT_TOL, r


if __name__ == "__main__":
    run = _run_bwd_cases if sys.argv[2:] == ["bwd"] else _run_cases
    print(json.dumps(run(sys.argv[1])))
