"""The CUDA sources of the dense decode kernel and the attention kernel,
built for the CPU by ``kernels/host_emulation.py`` (g++ against stand-in
CUDA headers: one host thread per CUDA thread, the PTX helpers written
from the PTX ISA's fragment layouts), driven through the wrappers' own
argument lists and held against the plain versions on the same numpy
inputs.  This checks the kernels' indexing, masking, split plan and
combine, and the tensor-core fragment layouts, without a card; it says
nothing about speed, and a missing ``cp.async`` wait would not show.

The cases run in one subprocess with a time limit (a kernel whose
barriers do not match would hang its emulation), built once.

Tolerance: 2e-5 in f32 (summation order); 2e-2 in bf16 outputs (one
bf16 rounding of outputs of magnitude up to ~2)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

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
}

# (B, S, H, K, Dh, window): a block is 16 q rows whose kv tiles of 16
# lines its 4 warps take in turn
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
    from repro_torch.kernels import host_emulation, ref

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
    for i, (name, case) in enumerate(ATTN_CASES.items()):
        B, S, H, K, Dh, window = case
        rng = np.random.default_rng(200 + i)
        q, k, v = (_pad_view(torch.from_numpy(rng.standard_normal(
            (B, S, n, Dh), np.float32)).to(torch.bfloat16), 8)
            for n in (H, K, K))
        o = torch.empty(q.shape, dtype=q.dtype)
        err = lib_a.repro_flash_attention(*fa.attention_args(
            q, k, v, o, window, None))
        want = ref.attention_ref(q, k, v, window=window)
        errs["attention/" + name] = dict(
            err=err, max_abs=float((o.float() - want.float()).abs().max()),
            dtype="bfloat16", counters=0, splits=0)
    return errs


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    out = tmp_path_factory.mktemp("host_emulation")
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_source_matches_plain(emulated, name):
    r = emulated["decode/" + name]
    assert r["err"] == 0                  # the launch was taken
    assert r["counters"] == 0             # every counter left at zero
    assert r["max_abs"] <= TOL[r["dtype"]], r


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_attention_source_matches_plain(emulated, name):
    r = emulated["attention/" + name]
    assert r["err"] == 0
    assert r["max_abs"] <= TOL[r["dtype"]], r


if __name__ == "__main__":
    print(json.dumps(_run_cases(sys.argv[1])))
