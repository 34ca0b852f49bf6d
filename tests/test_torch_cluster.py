"""The PyTorch port's cluster layer (``repro_torch.cluster``) against the
JAX package's (``repro.cluster``), on the CPU.

* Differential parity: the CLI's demo scenario and 60 seeded random event
  sequences (sbatch with nodes, gres, limits, arrays, dependencies,
  priorities, accounts, QOS and checkpoint intervals; tick and run;
  scancel; drain and resume of nodes; sacctmgr accounts and users; clock
  jumps; an HA failover through snapshot/restore) drive a cluster of each
  package; after every event the two must print the same sinfo, squeue,
  sacct, sshare, sprio and scontrol text, hold the same accounting records
  field by field, and give the same sdiag with its wall-clock lines
  masked.  An event that raises must raise the same error on both sides.
* The CLI prints byte for byte what the JAX CLI prints.
* A traced preemption gives the same spans.
* The checkpoint-restore hook reads the port's store.
* Real mode: a scavenger job trains reduced mamba2-780m (f32) through the
  cluster, a high-QOS job preempts it, it requeues and resumes from its
  checkpoint — the JAX ``Trainer`` on one side, the port's on the other;
  the same sacct text, losses within 1e-5 of JAX's and within 1e-6 of the
  port's own uninterrupted run.
* The mesh bridge maps an allocation to ``torch.device`` grids."""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cluster as R
import repro_torch.cluster as T
from repro.checkpoint import store as jstore
from repro.cluster import cli as rcli
from repro.cluster import meshbridge as rmesh
from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_reduced_config as jax_reduced
from repro.configs.base import InputShape as JaxInputShape
from repro.models import init_params as jax_init_params
from repro.monitoring import Tracer as JaxTracer
from repro.optim import OptimizerConfig as JaxOptimizerConfig
from repro.optim import init_opt_state as jax_init_opt_state
from repro.training import Trainer as JaxTrainer
from repro.training import TrainerConfig as JaxTrainerConfig
from repro_torch.checkpoint import store as tstore
from repro_torch.cluster import cli as tcli
from repro_torch.cluster import meshbridge as tmesh
from repro_torch.configs import InputShape, RunConfig, get_reduced_config
from repro_torch.monitoring import Tracer
from repro_torch.optim import OptimizerConfig, init_opt_state
from repro_torch.training import Trainer, TrainerConfig
from repro_torch.weights import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": R, "torch": T}

# ------------------------------------------------- differential harness ---

#: sdiag's scheduler-cycle lines time each pass with ``time.perf_counter``
_WALL = re.compile(r"^(\t(?:Last|Mean|Max) cycle:\s+)\d+$", re.M)


def _views(pkg, c) -> dict:
    """Everything a user can read off cluster ``c``."""
    C = pkg.commands
    return {
        "sinfo": C.sinfo(c),
        "sinfo -N": C.sinfo(c, node_oriented=True),
        "squeue": C.squeue(c),
        "sacct": C.sacct(c),
        "sshare": C.sshare(c, tres=True),
        "sprio": C.sprio(c),
        "scontrol": [C.scontrol_show_job(c, j) for j in sorted(c.jobs)],
        "accounting": [dataclasses.asdict(r) for r in c.accounting],
        "sdiag": _WALL.sub(r"\1#", C.sdiag(cluster=c)),
        "clock": c.clock,
        "preemptions": c.preemptions_total,
    }


def _apply(pkg, side: dict, op) -> object:
    """Apply one event to ``side["c"]``; returns what it printed or
    returned, or the error it raised (which the other side must match)."""
    kind, kw = op
    C, c = pkg.commands, side["c"]
    try:
        if kind == "sbatch":
            return C.sbatch(c, **kw)
        if kind == "tick":
            return c.tick()
        if kind == "run":
            return c.run()
        if kind == "scancel":
            return C.scancel(c, **kw)
        if kind == "node":
            return C.scontrol_update_node(c, **kw)
        if kind == "account":
            return C.sacctmgr_add_account(c, **kw)
        if kind == "user":
            return C.sacctmgr_add_user(c, **kw)
        if kind == "qos":
            return C.sacctmgr_show_qos(c)
        if kind == "clock":
            c.clock = kw["to"]
            return None
        if kind == "failover":
            side["c"] = type(c).restore(c.snapshot())
            return None
        if kind == "validate":
            return str(pkg.validate(c, side["spec"]))
        raise KeyError(kind)
    except (AssertionError, KeyError, ValueError, RuntimeError) as e:
        return ("raised", type(e).__name__, str(e))


class _Pair:
    """One cluster of each package, provisioned from the same inventory."""

    def __init__(self, make_spec):
        self.sides = {}
        for name, pkg in PACKAGES.items():
            spec = make_spec(pkg)
            self.sides[name] = {"spec": spec, "c": pkg.provision(spec)}
        self.check("provision")

    @property
    def ref(self):
        return self.sides["jax"]["c"]

    def check(self, what):
        j, t = (_views(PACKAGES[n], self.sides[n]["c"])
                for n in ("jax", "torch"))
        for key in j:
            assert t[key] == j[key], f"after {what}: {key} differs"

    def step(self, op):
        outs = [_apply(PACKAGES[n], self.sides[n], op)
                for n in ("jax", "torch")]
        assert outs[1] == outs[0], f"{op}: {outs}"
        self.check(op)
        return outs[0]


USERS = ("ubuntu", "alice", "bob", "carol")
ACCOUNTS = ("prod", "research", "ops")
QOS_NAMES = ("normal", "normal", "high", "scavenger")
DEPS = ("afterok", "afterany", "afternotok", "after")
LIMITS = ("00:10:00", "01:00:00", "30:00", "1-00:00:00", "45")


def _random_inventory(rng):
    """(spec maker, gres kind, units per host, partitions) from the seed:
    a TPU pod of 2-3 x 2-3 hosts, or 2-4 GPU hosts without coordinates."""
    mode = ("easy", "conservative", "fifo")[int(rng.integers(3))]
    if rng.random() < 0.3:
        n = int(rng.integers(2, 5))

        def make(pkg):
            hosts = tuple(pkg.HostSpec(f"gpu-{i:02d}", gres=(("gpu", 8),))
                          for i in range(n))
            parts = (pkg.PartitionSpec("gpu", tuple(h.name for h in hosts),
                                       default=True),
                     pkg.PartitionSpec("debug", (hosts[0].name,),
                                       max_time_s=3600, priority_tier=2))
            return pkg.ClusterSpec("dgx", hosts, parts, sched_mode=mode)
        return make, "gpu", 8, (None, "debug")
    hx, hy = int(rng.integers(2, 4)), int(rng.integers(2, 4))

    def make(pkg):
        return pkg.tpu_pod_spec(hosts_x=hx, hosts_y=hy, sched_mode=mode)
    return make, "tpu", 4, (None, "interactive")


def _random_op(rng, c, gres, per_host, parts):
    """One event, drawn from the seed and the (shared) cluster state."""
    jobs = sorted(c.jobs)
    hosts = sorted(c.nodes)
    accounts = sorted(a for a in c.fairshare.accounts if a != "root")
    r = rng.random()
    if r < 0.40:
        kw = dict(name=f"j{len(jobs)}",
                  nodes=int(rng.integers(1, len(hosts) + 1)),
                  gres=f"{gres}:{int(rng.integers(1, per_host + 1))}",
                  time=LIMITS[int(rng.integers(len(LIMITS)))],
                  run_time_s=float(rng.integers(1, 4000)),
                  priority=int(rng.integers(0, 10)),
                  user=USERS[int(rng.integers(len(USERS)))],
                  qos=QOS_NAMES[int(rng.integers(len(QOS_NAMES)))])
        if rng.random() < 0.15:
            kw["array"] = int(rng.integers(2, 4))
        if jobs and rng.random() < 0.25:
            kw["dependency"] = (f"{DEPS[int(rng.integers(len(DEPS)))]}:"
                                f"{jobs[int(rng.integers(len(jobs)))]}")
        if accounts and rng.random() < 0.3:
            kw["account"] = accounts[int(rng.integers(len(accounts)))]
        if rng.random() < 0.3:
            kw["ckpt_interval_s"] = float(rng.integers(100, 700))
        if rng.random() < 0.15:
            kw["partition"] = parts[1]
        return "sbatch", kw
    if r < 0.55:
        return "tick", {}
    if r < 0.60:
        return "run", {}
    if r < 0.67 and jobs:
        return "scancel", {"job_id": jobs[int(rng.integers(len(jobs)))]}
    if r < 0.75:
        return "node", {"nodename": hosts[int(rng.integers(len(hosts)))],
                        "state": ("drain", "idle")[int(rng.integers(2))],
                        "reason": "maintenance"}
    if r < 0.80:
        parent = ("root",) + tuple(accounts)
        return "account", {
            "name": ACCOUNTS[int(rng.integers(len(ACCOUNTS)))],
            "parent": parent[int(rng.integers(len(parent)))],
            "fairshare": int(rng.integers(1, 11))}
    if r < 0.85 and accounts:
        return "user", {"user": USERS[int(rng.integers(len(USERS)))],
                        "account": accounts[int(rng.integers(len(accounts)))]}
    if r < 0.93:
        to = c.clock + float(rng.integers(1, 300))
        nxt = c.next_event_time()
        return "clock", {"to": to if nxt is None else min(to, nxt)}
    return "failover", {}


@pytest.mark.parametrize("seed", range(60))
def test_random_event_sequences_match_jax(seed):
    rng = np.random.default_rng(seed)
    make, gres, per_host, parts = _random_inventory(rng)
    pair = _Pair(make)
    if gres == "tpu":     # the JAX canary asks for a TPU, which GPU hosts
        pair.step(("validate", {}))          # lack (test_gpu_inventory_...)
    for _ in range(40):
        pair.step(_random_op(rng, pair.ref, gres, per_host, parts))
    pair.step(("run", {}))


def test_demo_scenario_matches_jax():
    """The JAX CLI's scripted scenario (``repro.cluster.cli``), event by
    event, with every view compared after each."""
    hosts = 4
    pair = _Pair(lambda pkg: pkg.tpu_pod_spec(hosts_x=hosts, hosts_y=hosts))
    sb = [dict(name="resnet-train", nodes=4, gres="tpu:4", time="04:00:00",
               run_time_s=3600),
          dict(name="llm-pretrain", nodes=16, gres="tpu:4",
               time="1-00:00:00", run_time_s=86_000, priority=10),
          dict(name="sweep", nodes=1, gres="tpu:4", time="00:30:00",
               array=6, run_time_s=600),
          dict(name="eval-after", nodes=2, gres="tpu:4", time="01:00:00",
               dependency="afterok:2", run_time_s=300)]
    ops = [("validate", {})] + [("sbatch", kw) for kw in sb] + [
        ("node", dict(nodename="tpu-00-00", state="drain",
                      reason="maintenance")),
        ("run", {}),
        ("node", dict(nodename="tpu-00-00", state="idle")),
        ("run", {}),
        ("account", dict(name="prod", fairshare=10)),
        ("account", dict(name="research", fairshare=1)),
        ("user", dict(user="alice", account="prod")),
        ("user", dict(user="bob", account="research")),
        ("qos", {}),
        ("sbatch", dict(name="bg-sweep", nodes=hosts ** 2, gres="tpu:4",
                        time="04:00:00", run_time_s=7200, user="bob",
                        qos="scavenger", ckpt_interval_s=600)),
        ("sbatch", dict(name="prod-train", nodes=hosts ** 2 // 2,
                        gres="tpu:4", time="02:00:00", run_time_s=1800,
                        user="alice", qos="high")),
        ("run", {}),
    ]
    for op in ops:
        pair.step(op)
    assert pair.ref.preemptions_total == 1


@pytest.mark.parametrize("hosts", [2, 4, 8])
def test_cli_output_is_byte_identical(hosts, capsys):
    assert rcli.main(["--hosts", str(hosts)]) == 0
    ref = capsys.readouterr().out
    assert tcli.main(["--hosts", str(hosts)]) == 0
    assert capsys.readouterr().out == ref
    assert "preemption" in ref and "sshare" in ref


def test_package_surface_matches_jax():
    """Every module of the JAX package's cluster layer has its twin, and
    the package exports the same names."""
    names = {p.name for p in (ROOT / "src" / "repro" / "cluster").glob(
        "*.py")}
    assert names == {p.name for p in (ROOT / "src" / "repro_torch" /
                                      "cluster").glob("*.py")}
    assert T.__all__ == R.__all__
    assert [f.name for f in dataclasses.fields(T.AccountingRecord)] == \
        [f.name for f in dataclasses.fields(R.AccountingRecord)]


def test_gpu_inventory_validates():
    """A one-host GPU inventory (``gres/gpu``, no coordinates) passes
    validation: its canary asks for a GPU, and a one-GPU job lands on the
    host."""
    spec = T.ClusterSpec("h100", (T.HostSpec("gpu-00", gres=(("gpu", 1),)),),
                         (T.PartitionSpec("gpu", ("gpu-00",), default=True),))
    c = T.provision(spec, real_mode=True)
    rep = T.validate(c, spec)
    assert rep.ok, str(rep)
    ran = []
    T.commands.sbatch(c, name="t", gres="gpu:1",
                      script=lambda job, alloc: ran.append(alloc))
    assert ran == [("gpu-00",)]
    # the TPU canary is unchanged: the same report as the JAX package's
    tpu = [pkg.tpu_pod_spec(hosts_x=2, hosts_y=2) for pkg in (R, T)]
    assert str(T.validate(T.provision(tpu[1]), tpu[1])) == \
        str(R.validate(R.provision(tpu[0]), tpu[0]))


# ----------------------------------------------------------------- tracer ----

def _span_record(tracer):
    spans = tracer.spans()
    names = {s.sid: s.name for s in spans}
    return [(s.name, s.cat, s.track, names.get(s.parent), s.start, s.end,
             dict(s.attrs), [(e.name, e.ts, e.attrs) for e in s.events])
            for s in spans]


def _traced_preemption(pkg, tracer_cls):
    """The scenario of ``tests/test_trace.py::
    test_cluster_jobs_emit_state_spans_on_virtual_clock``."""
    nodes = [pkg.Node(name=f"n{i:02d}", cpus=16, mem_mb=65536,
                      gres={"tpu": 4}, coord=(0, i)) for i in range(4)]
    c = pkg.Cluster(nodes, [pkg.Partition(name="gpu", default=True,
                                          nodes=tuple(n.name for n in nodes))])
    c.tracer = tracer = tracer_cls()
    req = pkg.ResourceRequest(nodes=4, gres_per_node={"tpu": 4},
                              cpus_per_node=1, mem_mb_per_node=1024,
                              time_limit_s=36_000)
    (sc,) = c.submit("scav", req, user="bob", qos="scavenger",
                     run_time_s=1000)
    c.clock = 250.0
    c.submit("prod", req, user="alice", qos="high", run_time_s=50)
    c.run()
    return sc, c, tracer


def test_cluster_spans_match_jax():
    sc, c, tracer = _traced_preemption(T, Tracer)
    _, _, jtracer = _traced_preemption(R, JaxTracer)
    rec = _span_record(tracer)
    assert rec == _span_record(jtracer)
    states = [(r[0], r[4], r[5]) for r in rec if r[1] == "state"
              and r[2] == ("cluster:root", f"job {sc}")]
    assert [s[0] for s in states] == ["PENDING", "RUNNING", "PREEMPTED",
                                      "PENDING", "RUNNING"]
    assert states[2] == ("PREEMPTED", 250.0, 250.0)
    assert any(r[0] == "schedule_pass" for r in rec)
    assert c.sched_stats["total_us"] >= c.sched_stats["max_us"] > 0


# ------------------------------------------------------- checkpoint hook ----

def test_preempted_job_restores_from_port_checkpoint_store(tmp_path):
    """``tests/test_multitenant.py::
    test_preempted_job_restores_from_checkpoint_store`` through the port's
    store: the requeued job keeps the store's latest step as progress."""
    ckpt = str(tmp_path / "job-ckpts")
    tstore.save(ckpt, step=450, tree={"w": torch.zeros(2)})
    nodes = [T.Node(name=f"n{i}", cpus=8, mem_mb=16384, gres={"tpu": 4},
                    coord=(0, i)) for i in range(2)]
    c = T.Cluster(nodes, [T.Partition(name="p", nodes=("n0", "n1"),
                                      default=True)])
    req = T.ResourceRequest(nodes=2, gres_per_node={"tpu": 4})
    (sc,) = c.submit("train", req, qos="scavenger", run_time_s=1000,
                     checkpoint_dir=ckpt)
    c.clock = 500.0
    c.submit("prod", req, qos="high", run_time_s=10)
    assert c.jobs[sc].state == T.JobState.PENDING
    assert c.jobs[sc].progress_s == 450.0
    c.run()
    assert c.jobs[sc].state == T.JobState.COMPLETED
    segs = [r for r in c.accounting if r.job_id == sc]
    assert segs[-1].elapsed == pytest.approx(550.0)
    # the JAX package's store writes the same layout: its hook reads ours
    assert jstore.latest_step(ckpt) == 450


# ----------------------------------------------------------- mesh bridge ----

def _one_host(pkg, gres):
    spec = pkg.ClusterSpec("one", (pkg.HostSpec("h0", gres=gres),),
                           (pkg.PartitionSpec("p", ("h0",), default=True),))
    c = pkg.provision(spec, real_mode=True)
    kind, n = gres[0]
    (jid,) = c.submit("j", pkg.ResourceRequest(gres_per_node={kind: n}))
    return c, c.jobs[jid]


def test_mesh_for_job_maps_gpu_allocation_to_devices():
    c, job = _one_host(T, (("gpu", 1),))
    mesh = tmesh.mesh_for_job(c, job, devices=["cpu"])
    assert mesh.devices.shape == (1, 1) and mesh.axis_names == ("data",
                                                                "model")
    assert mesh.devices.flat[0] == torch.device("cpu")
    # 4 cards, 4 devices: (data, model) as the reference factors it
    c, job = _one_host(T, (("gpu", 4),))
    devs = [torch.device("cuda", i) for i in range(4)]
    mesh = tmesh.mesh_for_job(c, job, model_parallel=2, devices=devs)
    assert mesh.devices.shape == rmesh.factor_mesh(4, 2) == (2, 2)
    assert list(mesh.devices.flat) == devs
    assert tmesh.allocation_chip_count(c, job, "gpu") == 4


@pytest.mark.parametrize("chips,have,want", [(4, 1, 1), (4, 3, 2),
                                             (16, 8, 8), (2, 4, 2)])
def test_mesh_for_job_folds_like_jax(chips, have, want):
    """Fewer devices than the allocation's chips: the grid folds onto the
    largest power of two of them, as the JAX mesh does; more devices than
    chips: the first ``chips`` of them."""
    c, job = _one_host(T, (("tpu", chips),))
    devs = [torch.device("cuda", i) for i in range(have)]
    mesh = tmesh.mesh_for_job(c, job, devices=devs)
    assert mesh.devices.shape == (want, 1)
    assert list(mesh.devices.flat) == devs[:want]
    if have == len(jax.devices()):          # the JAX mesh on this host
        rc, rjob = _one_host(R, (("tpu", chips),))
        ref = rmesh.mesh_for_job(rc, rjob)
        assert mesh.devices.shape == ref.devices.shape
    assert tmesh.factor_mesh(chips, 3) == rmesh.factor_mesh(chips, 3)


def test_mesh_for_job_needs_cuda_or_devices(monkeypatch):
    c, job = _one_host(T, (("gpu", 1),))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.mesh_for_job(c, job)
    pending = T.Job(job_id=99, name="p", user="u", partition="p",
                    req=job.req)
    with pytest.raises(ValueError, match="no allocation"):
        tmesh.mesh_for_job(c, pending, devices=["cpu"])


# ----------------------------------------------- real mode against JAX ----

OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=50)
SHAPE = (2, 32)                       # (global batch, seq) in 2 microbatches


@pytest.fixture(scope="module")
def one_thread():
    """The port's steps here are thousands of tiny ops; with the test
    workers sharing the cores, a pool of intra-op threads per op spends
    its time waiting for its own threads.  One thread while this
    module's training runs, the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(one_thread):
    jcfg = dataclasses.replace(jax_reduced("mamba2-780m"), dtype="float32")
    tcfg = dataclasses.replace(get_reduced_config("mamba2-780m"),
                               dtype="float32")
    params = jax.tree.map(np.asarray, jax.jit(
        jax_init_params, static_argnums=(0, 1))(jcfg, 0))
    return jcfg, tcfg, params


@pytest.fixture(scope="module")
def jax_step(weights, cpu_mesh):
    """One JAX trainer whose jitted step every incarnation of the JAX
    job reuses (one compile)."""
    jcfg, _, _ = weights
    return JaxTrainer(jcfg, JaxRunConfig(strategy="dp", microbatches=2,
                                         remat="none"), cpu_mesh,
                      JaxInputShape("t", SHAPE[1], SHAPE[0], "train"),
                      JaxOptimizerConfig(**OPT),
                      JaxTrainerConfig(steps=1)).step_fn


def _jax_script(weights, step_fn):
    jcfg, _, params = weights

    def script(cluster, job):
        mesh = rmesh.mesh_for_job(cluster, job)
        t = JaxTrainer(jcfg, JaxRunConfig(strategy="dp", microbatches=2,
                                          remat="none"), mesh,
                       JaxInputShape("t", SHAPE[1], SHAPE[0], "train"),
                       JaxOptimizerConfig(**OPT),
                       JaxTrainerConfig(steps=2 * (job.requeue_count + 1),
                                        log_every=100, ckpt_every=2,
                                        ckpt_dir=job.checkpoint_dir))
        t.step_fn = step_fn
        t.params = jax.tree.map(jnp.asarray, params)
        t.opt_state = jax_init_opt_state(t.params, t.opt)
        t.maybe_resume()
        with mesh:
            return t.train(log=lambda *_: None)
    return script


def _port_trainer(tcfg, steps, **kw):
    return Trainer(tcfg, RunConfig(use_kernels=True, microbatches=2), None,
                   InputShape("t", SHAPE[1], SHAPE[0], "train"),
                   OptimizerConfig(**OPT),
                   TrainerConfig(steps=steps, log_every=100, **kw),
                   device="cpu")


def _port_script(weights):
    _, tcfg, params = weights

    def script(cluster, job):
        mesh = tmesh.mesh_for_job(cluster, job,
                                  devices=[torch.device("cpu")])
        t = _port_trainer(tcfg, 2 * (job.requeue_count + 1), ckpt_every=2,
                          ckpt_dir=job.checkpoint_dir)
        assert t.device == mesh.devices.flat[0]
        t.params = params_from_jax(params)
        t.opt_state = init_opt_state(t.params, t.opt)
        t.maybe_resume()
        return t.train(log=lambda *_: None)
    return script


def _preempted_training(pkg, script, ckpt_dir):
    """A scavenger job trains to step 2 and checkpoints; a high-QOS job
    preempts it at t=100; it requeues with the store's step as progress
    and, once the high job ends, resumes at step 3 and trains to 4."""
    spec = pkg.ClusterSpec("one", (pkg.HostSpec("h0", gres=(("tpu", 1),)),),
                           (pkg.PartitionSpec("p", ("h0",), default=True),))
    c = pkg.provision(spec, real_mode=True)
    assert pkg.validate(c, spec).ok
    c.tracer = JaxTracer() if pkg is R else Tracer()
    pkg.commands.sbatch(c, name="train", gres="tpu:1", qos="scavenger",
                        run_time_s=600, checkpoint_dir=ckpt_dir,
                        script=lambda job, alloc: script(c, job))
    (train,) = [j for j in c.jobs.values() if j.name == "train"]
    first = list(train.result)
    c.clock = 100.0
    pkg.commands.sbatch(c, name="serve", gres="tpu:1", qos="high",
                        run_time_s=30, script=lambda job, alloc: "served")
    assert train.state == pkg.JobState.PENDING and train.requeue_count == 1
    assert train.progress_s == 2.0          # the store's step, as seconds
    # requeued (its reason turns to Resources once the high job holds the
    # host): the state spans of the preemption
    track = ("cluster:root", f"job {train.job_id}")
    states = [(sp.name, dict(sp.attrs)) for sp in c.tracer.spans(
        cat="state", track=track)] + [(sp.name, dict(sp.attrs)) for sp in
                                      c.tracer.open_spans()
                                      if sp.track == track
                                      and sp.cat == "state"]
    assert [n for n, _ in states] == ["PENDING", "RUNNING", "PREEMPTED",
                                      "PENDING"]
    assert states[-1][1]["reason"] == "Requeued"
    assert c.run() == []
    assert all(j.exit_code == 0 for j in c.jobs.values()), \
        [j.comment for j in c.jobs.values()]
    return c, first, list(train.result)


def test_preempted_training_resumes_like_jax(weights, jax_step, tmp_path):
    jc, jfirst, jsecond = _preempted_training(
        R, _jax_script(weights, jax_step), str(tmp_path / "jax"))
    tc, first, second = _preempted_training(
        T, _port_script(weights), str(tmp_path / "torch"))
    assert T.commands.sacct(tc) == R.commands.sacct(jc)
    states = [r.state for r in tc.accounting if r.name == "train"]
    assert states == ["PREEMPTED", "COMPLETED"]
    assert [h["step"] for h in first] == [1, 2]
    assert [h["step"] for h in second] == [3, 4]
    for got, want in zip(first + second, jfirst + jsecond):
        assert got["step"] == want["step"]
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    # the port's own uninterrupted run of 4 steps
    _, tcfg, params = weights
    straight = _port_trainer(tcfg, 4)
    straight.params = params_from_jax(params)
    flat = straight.train(log=lambda *_: None)
    for got, want in zip(first + second, flat):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)


# ------------------------------------- chip_smoke.py's phase on the CPU ----

@pytest.fixture(scope="module")
def smoke(one_thread):
    """``chip_smoke.py``'s cluster phase at reduced size on the CPU, with
    the uninterrupted run it is held to."""
    import importlib
    import sys
    sys.path.insert(0, str(ROOT))
    cs = importlib.import_module("chip_smoke")
    tcfg = get_reduced_config("mamba2-780m")
    targs = dict(batch=4, microbatches=2, seq_len=64, steps=4)
    t = Trainer(tcfg, RunConfig(use_kernels=True, remat="layer",
                                microbatches=2), None,
                InputShape("s", 64, 4, "train"), OptimizerConfig(),
                TrainerConfig(steps=5, seed=cs.SEED), device="cpu")
    reference = [h["loss"] for h in t.train(log=lambda *_: None)]
    args = (tcfg, targs, get_reduced_config("stablelm-3b"),
            dict(slots=4, cache_len=128, max_new=8, decode_chunk=4),
            reference)
    return cs, args


def test_chip_smoke_cluster_phase_on_cpu(smoke, capsys):
    cs, args = smoke
    out = cs.cluster_phase(*args, devices=[torch.device("cpu")])
    text = capsys.readouterr().out
    assert "validation: PASSED" in text and "bit-identical" in text
    assert "PREEMPTED" in text and "last reason 'Requeued'" in text
    assert set(out["launches"]) == {"flash_attention", "attention_bwd",
                                    "flash_decode", "flash_decode_paged",
                                    "ssd_scan", "ssd_decode_step"}


def test_chip_smoke_cluster_phase_fails_on_a_failed_job(smoke,
                                                        monkeypatch):
    """A job script that raises is accounted (exit code 1 and a comment)
    by the cluster; the phase must fail on it, naming the error."""
    cs, args = smoke

    def broken(*a, **k):
        raise RuntimeError("no pages")
    monkeypatch.setattr(cs, "serve_phase", broken)
    with pytest.raises(AssertionError, match="RuntimeError: no pages"):
        cs.cluster_phase(*args, devices=[torch.device("cpu")])
