"""``python -m repro_torch.launch.serve --trace`` prints what the JAX CLI
prints under ``--trace``: ``sdiag``'s sections for its mode ("Admission
controller statistics:" always, "Serve-step utilization" with a token
budget, "Speculative decoding:" with ``--speculate``, the serving SLO
table last).  Both CLIs run on reduced stablelm-3b in f32 with the same
weights (the JAX init, passed through numpy into the port), so the
engines make the same decisions: every section's lines must be equal,
except the SLO table's latencies and attainment, which are wall-clock
readings (its tenant, QOS and request-count columns must be equal)."""
import contextlib
import dataclasses
import functools
import io

import jax
import numpy as np
import pytest

from repro.configs import get_reduced_config as jax_reduced
from repro.launch import serve as jserve
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_reduced_config
from repro_torch.launch import serve as tserve
from repro_torch.weights import params_from_jax

BASE = ["--reduced", "--slots", "2", "--cache-len", "64"]
#: mode -> (extra flags, the sections sdiag prints for it).  Odd request
#: ids sample at temperature 0.8, which the port cannot match draw for
#: draw, so the speculative run takes one (greedy) request, long enough
#: for drafts to be both accepted and rejected
MODES = {
    "classic": (["--requests", "3", "--max-new", "4"],
                ["Admission controller statistics:"]),
    "budgeted": (["--requests", "3", "--max-new", "4",
                  "--max-batch-tokens", "16"],
                 ["Admission controller statistics:",
                  "Serve-step utilization (token budget):"]),
    "speculative": (["--requests", "1", "--max-new", "16", "--speculate",
                     "2", "--shared-prefix", "24"],
                    ["Admission controller statistics:",
                     "Speculative decoding:"]),
}
SLO = "Serving SLO (per tenant/QOS):"


@functools.lru_cache(maxsize=None)
def _f32(get, arch):
    return dataclasses.replace(get(arch), dtype="float32")


@functools.lru_cache(maxsize=None)
def _jax_params(seed):
    return jax.tree.map(np.asarray, jax_init_params(
        _f32(jax_reduced, "stablelm-3b"), seed))


def _run(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def _sections(text: str) -> dict:
    """sdiag's sections, after the ``trace:`` line, by header."""
    tail = text.split("(load in ui.perfetto.dev)\n", 1)[1]
    return {s.splitlines()[0]: s.splitlines()
            for s in tail.strip("\n").split("\n\n")}


@pytest.mark.parametrize("mode", list(MODES))
def test_trace_prints_the_reference_sdiag(mode, tmp_path, monkeypatch):
    extra, want = MODES[mode]
    for mod, get in ((jserve, jax_reduced), (tserve, get_reduced_config)):
        monkeypatch.setattr(mod, "get_reduced_config",
                            functools.partial(_f32, get))
    monkeypatch.setattr(jserve, "init_params",
                        lambda cfg, seed: _jax_params(seed))
    monkeypatch.setattr(tserve, "init_params",
                        lambda cfg, seed, device: params_from_jax(
                            _jax_params(seed), device))
    ref = _sections(_run(jserve.main, BASE + extra + [
        "--trace", str(tmp_path / "jax.json")]))
    got = _sections(_run(tserve.main, BASE + extra + [
        "--device", "cpu", "--trace", str(tmp_path / "torch.json")]))
    assert list(got) == list(ref) == want + [SLO]
    for head in want:
        assert got[head] == ref[head], head
    if mode == "speculative":
        assert "\tVerify rounds:    2" in got[want[1]]
        assert "\tAccepted:         1 (50%)" in got[want[1]]
    # the SLO table: same header and rows; the numbers are wall clock
    assert got[SLO][:2] == ref[SLO][:2]
    assert [r[:29] for r in got[SLO][2::2]] == \
        [r[:29] for r in ref[SLO][2::2]]
    assert (tmp_path / "torch.json").exists()
