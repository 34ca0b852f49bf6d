"""The port's autoscaler and elastic CLI against the JAX package, on the
CPU.

* The five scenarios of ``tests/test_autoscale.py`` — ``capacity_now`` as
  a pure read, scale-up into idle nodes, a preempted replica job drained
  through the router, yielding to a scavenger peer's pressure, the
  ``min_replicas`` floor — on each package's cluster, router (over fake
  engines) and ``Autoscaler``: equal results, ``stats``, ``jobs`` maps and
  ``sdiag(cluster=, router=, autoscaler=)`` text after every action (its
  scheduler-cycle lines, wall-clock times, masked).
* ``python -m repro_torch.launch.serve --reduced --device cpu --replicas 2
  --affinity --autoscale --prefix-cache --shared-prefix 16`` prints the
  JAX CLI's lines with the same flags, the timed values masked.
* Replicas the CLI builds share one weight set (equal ``data_ptr`` for
  every leaf).
* ``chip_smoke.py``'s elastic phase at reduced size on the CPU."""
import contextlib
import importlib
import io
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.cluster as RC
import repro.serving as JS
import repro_torch.cluster as TC
import repro_torch.serving as TS
from repro.launch import serve as jserve
from repro_torch.launch import serve as tserve

from test_torch_router import SIDES

ROOT = Path(__file__).resolve().parents[1]
CLUSTERS = {"jax": RC, "torch": TC}
SERVING = {"jax": JS, "torch": TS}

#: sdiag's scheduler-cycle lines time each pass with ``time.perf_counter``
_WALL = re.compile(r"^(\t(?:Last|Mean|Max) cycle:\s+)\d+$", re.M)


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops under a loaded machine: torch's intra-op pool only
    waits (see tests/test_torch_cluster.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- autoscaler ----

def make_cluster(side, n_nodes=4):
    C = CLUSTERS[side]
    nodes = [C.Node(name=f"n{i:02d}", cpus=16, mem_mb=65536,
                    gres={"tpu": 4}, coord=(0, i)) for i in range(n_nodes)]
    parts = [C.Partition(name="serve", nodes=tuple(n.name for n in nodes),
                         default=True)]
    return C.Cluster(nodes, parts)


def replica_req(side, nodes=1):
    return CLUSTERS[side].ResourceRequest(
        nodes=nodes, gres_per_node={"tpu": 4}, cpus_per_node=1,
        mem_mb_per_node=1024, time_limit_s=36_000)


class Side:
    """One package's cluster, router over fake engines and autoscaler."""

    def __init__(self, side, n_nodes, min_replicas=1, max_replicas=4):
        self.side = side
        self.cluster = make_cluster(side, n_nodes)
        fake = SIDES[side][4]
        self.router = SERVING[side].Router(lambda adm: fake(adm),
                                           replicas=0, policy="rr")
        self.scaler = SERVING[side].Autoscaler(
            self.router, self.cluster, req=replica_req(side),
            min_replicas=min_replicas, max_replicas=max_replicas)

    def submit(self, rid):
        return self.router.submit(SERVING[self.side].Request(
            rid=rid, prompt=np.arange(8, dtype=np.int32), max_new_tokens=4))

    def batch(self, name, qos, nodes=1):
        return self.cluster.submit(name, replica_req(self.side, nodes),
                                   qos=qos, run_time_s=1e6)

    def view(self) -> dict:
        c, JobState = self.cluster, CLUSTERS[self.side].JobState
        return {
            "stats": dict(self.scaler.stats),
            "jobs": dict(self.scaler.jobs),
            "states": {j: c.jobs[j].state.name for j in sorted(c.jobs)},
            "running": [j for j in sorted(c.jobs)
                        if c.jobs[j].state == JobState.RUNNING],
            "kinds": [c.jobs[j].kind for j in sorted(c.jobs)],
            "replicas": sorted(self.router.replicas),
            "loads": [self.router.load(r) for r in
                      sorted(self.router.replicas)],
            "router": dict(self.router.stats),
            "preemptions": c.preemptions_total,
            "sdiag": _WALL.sub(r"\1#", CLUSTERS[self.side].commands.sdiag(
                cluster=c, router=self.router, autoscaler=self.scaler)),
        }


def _capacity_probe(s):
    c = s.cluster
    out = [c.capacity_now(replica_req(s.side)),
           c.capacity_now(replica_req(s.side, nodes=2)), len(c.jobs)]
    c.submit("batch", replica_req(s.side, nodes=3), run_time_s=1e6)
    out += [c.capacity_now(replica_req(s.side)),
            c.capacity_now(replica_req(s.side, nodes=2)),
            dict(c.probe_stats)]
    return out


def _scale_up(s):
    s.scaler.tick()
    first = s.view()
    s.scaler.tick()
    return first, s.cluster.capacity_now(replica_req(s.side))


def _preempted(s):
    s.scaler.tick()
    placed = [s.submit(i) for i in range(4)]
    before = s.view()
    s.batch("train", "high")
    after_preempt = s.view()
    s.scaler.tick()
    return placed, before, after_preempt


def _yield(s):
    s.scaler.tick()
    placed = s.submit(0)
    jid = s.batch("sweep", "scavenger")[0]
    pending = s.cluster.jobs[jid].state.name
    s.scaler.tick()
    return placed, pending, s.cluster.jobs[jid].state.name


def _floor(s):
    s.scaler.tick()
    s.batch("train", "high", nodes=2)
    lost = s.view()
    s.scaler.tick()
    mid = s.view()
    s.scaler.tick()
    return lost, mid


#: the five scenarios: (nodes, max_replicas, action)
SCENARIOS = {
    "capacity_now": (4, 4, _capacity_probe),
    "scale_up": (4, 3, _scale_up),
    "preempted_drains": (2, 2, _preempted),
    "yield_to_peer": (2, 2, _yield),
    "min_replicas_floor": (2, 2, _floor),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_autoscaler_matches_jax(name):
    n_nodes, max_replicas, action = SCENARIOS[name]
    runs = {}
    for side in ("jax", "torch"):
        s = Side(side, n_nodes, max_replicas=max_replicas)
        runs[side] = (action(s), s.view())
    assert runs["jax"] == runs["torch"]
    final = runs["torch"][1]
    # each scenario's outcome, as tests/test_autoscale.py states it
    if name == "scale_up":
        assert len(final["replicas"]) == 3
        assert set(final["kinds"]) == {"serve_replica"}
    elif name == "preempted_drains":
        assert final["stats"]["drains"] == 1
        assert final["stats"]["requeued_requests"] == 2
        assert final["loads"] == [4]
    elif name == "yield_to_peer":
        assert runs["torch"][0][1:] == ("PENDING", "RUNNING")
        assert len(final["replicas"]) == 1
    elif name == "min_replicas_floor":
        assert len(final["replicas"]) == 1
        assert final["stats"]["scale_ups"] == 2
    else:
        assert runs["torch"][0][:3] == [4, 4, 0]


# ------------------------------------------------------------------ CLI ----

FLAGS = ["--reduced", "--replicas", "2", "--affinity", "--autoscale",
         "--prefix-cache", "--shared-prefix", "16"]

#: the timed values of the elastic CLI's output: the "served" line's
#: seconds, tok/s and busy seconds, and sdiag's scheduler-cycle times
_TIMED = [
    (re.compile(r"tokens in [\d.]+s \([\d,.]+ tok/s wall, busiest replica "
                r"[\d.]+s busy\)"), "tokens in #s (# tok/s wall, busiest "
     "replica #s busy)"),
    (_WALL, r"\1#"),
]


def _masked(text: str) -> str:
    for pattern, repl in _TIMED:
        text = pattern.sub(repl, text)
    return text


def _run_cli(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def test_elastic_cli_matches_jax():
    """Every printed line equal, apart from the served line's seconds,
    tok/s and busy seconds and sdiag's cycle times (masked)."""
    want = _run_cli(jserve.main, FLAGS)
    got = _run_cli(tserve.main, FLAGS + ["--device", "cpu"])
    assert _masked(got) == _masked(want)
    for line in ("[serve] batch pressure: drained down to 1 replica(s)",
                 "Autoscaler (scavenger replicas):",
                 "Prefix-affinity router:"):
        assert line in got
    # the masks replace values inside lines, never whole lines
    assert len(got.splitlines()) == len(want.splitlines())


def test_elastic_cli_notice_names_port_flags():
    got = _run_cli(tserve.main, ["--reduced", "--device", "cpu",
                                 "--replicas", "2", "--speculate", "2",
                                 "--requests", "2", "--max-new", "2"])
    assert got.splitlines()[1] == (
        "[serve] --replicas/--autoscale path ignores --speculate and "
        "--trace (single-engine features)")


def _leaves(tree, name=""):
    """(key, tensor) for every leaf of a parameter tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v, name)
    else:
        yield name, tree


def test_cli_replicas_share_one_weight_set(monkeypatch):
    """The replicas of ``--replicas 2`` hold the same weight tensors, in
    the compute dtype (bf16 for stablelm-3b): one cast, not one each."""
    seen = {}
    run_waves = tserve.run_waves

    def spy(args, router, *rest):
        seen["engines"] = [rep.engine for rep in router.replicas.values()]
        return run_waves(args, router, *rest)

    monkeypatch.setattr(tserve, "run_waves", spy)
    _run_cli(tserve.main, ["--reduced", "--device", "cpu", "--replicas",
                           "2", "--requests", "2", "--max-new", "2"])
    a, b = (list(_leaves(e.params)) for e in seen["engines"])
    assert len(a) == len(b) > 10
    assert [t.data_ptr() for _, t in a] == [t.data_ptr() for _, t in b]
    # cast once to the compute dtype; norm scales stay f32, as the
    # engine's own cast leaves them
    for name, t in a:
        assert t.dtype == (torch.float32 if name == "scale"
                           else torch.bfloat16), name


# ----------------------------------------------------------- chip phase ----

def test_chip_smoke_elastic_phase_on_cpu():
    """``chip_smoke.py``'s elastic phase at reduced size on the CPU: every
    run finishes its requests, the affinity run routes all 8 to their
    affine replica, the autoscale run drains one replica mid-decode, and
    two replicas with one drained give one engine's greedy tokens.  (The
    peak-memory gate needs the card.)"""
    sys.path.insert(0, str(ROOT))
    cs = importlib.import_module("chip_smoke")
    args = dict(requests=8, slots=4, cache_len=512, max_new=32,
                decode_chunk=8)
    out = cs.elastic_phase(args, device="cpu", reduced=True)
    runs = out["runs"]
    assert [r["label"] for r in runs] == [r[0] for r in cs.ELASTIC_RUNS]
    assert [r["tokens"] for r in runs] == [8 * 31] * 5
    assert runs[2]["stats"]["affinity_hits"] == 8
    assert runs[4]["stats"]["drains"] == 1
    assert runs[4]["stats"]["resubmitted"] >= 1
    assert runs[4]["replicas"] == 1
    assert out["identity"]["moved"] > 0
    assert out["identity"]["same"] + out["identity"]["ties"] == 8
