"""The check that decides ``correct``, driven through the rest of a run on
the CPU at a tiny size, against each cell's own limits: a sound run
passes, each fault its cell can have fails it, and the control (the
reference with float8 products in the program's place) reads far above
the program and is judged not correct.  Also: the command refuses to run
without a card and prints no result."""
import json
import os
import subprocess
import sys
import time

import pytest

import calibrate
from harness import bench
from reference import common
from tiny import tiny

SEED = 2**31 + 101


def run(cell, fault=None, seconds=1.0):
    result, checks = bench.run_cell(cell, SEED, seconds, False, "cpu",
                                    time.perf_counter(), fault)
    return result


@pytest.mark.parametrize("workload,fault", [
    ("stablelm-3b.decode", "token"),
    ("open_loop", "token"),
    ("stablelm-3b.train", "half"),
    ("stablelm-3b.train", "frozen"),
])
def test_a_fault_fails_the_run(one_thread, steady_clock, workload, fault):
    cell = tiny(workload)
    assert run(cell)["correct"] is True
    bad = run(cell, fault)
    assert bad["correct"] is False
    assert list(bad)[-1] == "checks"
    assert any(c["value"] > c["limit"] or c["value"] != c["value"]
               for c in bad["checks"].values())


@pytest.mark.parametrize("workload", ["stablelm-3b.decode",
                                      "open_loop",
                                      "stablelm-3b.train"])
def test_the_control_is_judged_not_correct(one_thread, steady_clock,
                                           workload):
    cell = tiny(workload)
    got = dict(calibrate.readings(cell, SEED, 1.0, True, [], "cpu"))
    prog, ctl = got["program"], got["control"]
    assert bench.judge(prog, cell.limits)[0] is True
    assert bench.judge(ctl, cell.limits)[0] is False
    key = "gap_max" if "gap_max" in prog else "grad_gap"
    assert ctl[key] > 3 * prog[key]


@pytest.mark.parametrize("value,correct", [
    (0.1, True), (0.35, True), (0.36, False), (float("inf"), False),
    (float("nan"), False)])
def test_judge_holds_each_number_to_its_limit(value, correct):
    limits = {"sample": 8, "numbers": {"gap_max": 0.35}}
    ok, checks = bench.judge({"gap_max": value, "tokens_checked": 9},
                             limits)
    assert ok is correct and list(checks) == ["gap_max"]
    assert checks["gap_max"]["limit"] == 0.35
    assert bench.check_lines(checks)[0].startswith("check gap_max ")


def test_fp8_rounds_both_operands():
    import torch
    w = torch.randn(64, 4, 8)               # contracts the first dim
    q = common.fp8.w(w)
    scale = w.abs().amax(0) / common.FP8_MAX
    assert torch.equal((q / scale).to(torch.float8_e4m3fn).float() * scale,
                       q)
    # three mantissa bits: within 2^-4 of each value, or of the column's
    # amax where a small value falls below e4m3's normal range
    err = (q - w).abs()
    assert 0 < err.max() and bool(
        (err <= 2**-4 * torch.maximum(w.abs(), w.abs().amax(0) / 2**8)).all())
    x = torch.randn(3, 5, 4, 8)             # contracts the last two
    qx = common.fp8.x(x, 2)
    sx = x.reshape(3, 5, 32).abs().amax(-1, keepdim=True) / common.FP8_MAX
    assert torch.equal(qx.reshape(3, 5, 32),
                       (x.reshape(3, 5, 32) / sx).to(torch.float8_e4m3fn)
                       .float() * sx)
    assert common.exact.w(w) is w and common.exact.x(x) is x


def test_without_a_card_it_exits_nonzero_and_prints_nothing(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run(
        [sys.executable, os.path.join(here, "run.py"), "--workload",
         "stablelm-3b.decode", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


@pytest.mark.card
def test_a_decode_run_on_the_card(card):
    """Run the decode cell briefly on the card: correct, with its metrics."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run(
        [sys.executable, os.path.join(here, "run.py"), "--workload",
         "stablelm-3b.decode", "--seed", str(SEED), "--seconds", "5",
         "--trace", "0"], capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["metrics"]["decode_tok_s"]["value"] > 0
