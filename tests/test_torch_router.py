"""The port's prefix-affinity router (``repro_torch.serving.router``) and
the engine surface it drives, against the JAX package, on the CPU.

* ``HashRing``: over 60 seeded random replica sets with replicas added and
  removed, both packages map the same keys to the same replicas.
* ``Router`` over duck-typed fake engines (the JAX tests' ``FakeEngine``
  on the JAX side, the port's copy below on the other): 60 seeded random
  event sequences — submit, route, step, start, finish, usage charged on
  the shared fair-share tree, ``remove_replica``, ``add_replica`` — under
  all three policies, spill factors that spill, and GrpTRES caps with
  ``grp_scope`` "global" and "replica".  After every event both give the
  same placement, ``stats``, loads, running and queued requests, drained
  lists (rids, order, outputs kept), metrics text and ``sdiag(router=)``.
* Real engines, reduced stablelm-3b in f32, one set of weights: each
  scenario runs through the JAX router and the port's in the same mode —
  two replicas round robin (also held to one engine, the contract of
  ``tests/test_router.py``), a mid-decode drain on the dense cache, a
  drain of paged replicas with the prefix cache under affinity routing
  (two shared system prompts), and a drain in the token-budgeted mode
  while a prompt is mid-prefill.  Per-request greedy outputs, partial
  outputs kept across the drain, preemption counts, the router's stats,
  prefix counters and the ``serve_replica_load`` and
  ``serve_replica_kv_pages_in_use`` gauges after every step are equal.
* The engine surface the router and autoscaler call (``active``,
  ``pending``, ``load``, ``radix_occupancy``, ``queue``, ``drain``)
  equals the JAX engine's at the same points of one scripted run."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.serving as JS
import repro_torch.serving as TS
from repro.cluster import commands as JC
from repro.configs import get_reduced_config as jax_reduced
from repro.models import init_params as jax_init_params
from repro.monitoring import MetricsRegistry as JaxMetrics
from repro.policy import QOS as JaxQOS
from repro.policy import default_qos_table as jax_qos_table
from repro_torch.cluster import commands as TC
from repro_torch.configs import get_reduced_config
from repro_torch.monitoring import MetricsRegistry
from repro_torch.monitoring.metrics import (
    METRIC_SERVE_PREFIX_HITS, METRIC_SERVE_PREFIX_MISSES,
    METRIC_SERVE_PREFIX_REUSED_TOKENS, METRIC_SERVE_REPLICA_KV_PAGES,
    METRIC_SERVE_REPLICA_LOAD,
)
from repro_torch.policy import QOS, default_qos_table
from repro_torch.weights import params_from_jax

from test_router import FakeEngine as JaxFakeEngine


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops under a loaded machine: torch's intra-op pool only
    waits (see tests/test_torch_cluster.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeEngine:
    """The port's copy of ``tests/test_router.py::FakeEngine``: a
    duck-typed replica with a real admission controller and no device
    work; ``start()`` pulls queue heads into fake slots so load and drain
    see in-flight requests."""

    def __init__(self, admission, num_slots=4):
        self.admission = admission
        self.num_slots = num_slots
        self.paging = None
        self.running = []

    def submit(self, req):
        self.admission.submit(req)

    def start(self):
        while len(self.running) < self.num_slots:
            req = self.admission.next_request()
            if req is None:
                break
            self.running.append(req)

    def active(self):
        return len(self.running)

    def pending(self):
        return self.admission.pending()

    def step(self):
        return 0

    def radix_occupancy(self):
        return {"nodes": 0, "evictable_pages": 0}

    def drain(self):
        drained = list(self.running)
        self.running.clear()
        for t in self.admission.tenants.values():
            drained.extend(t.queue)
            t.queue.clear()
        drained.sort(key=lambda r: r._seq)
        return drained


def _recording(base):
    """``base`` whose ``drain`` also keeps what it handed back."""
    class Recording(base):
        drained = None

        def drain(self):
            out = super().drain()
            self.drained = [(r.rid, list(r.output)) for r in out]
            return out
    return Recording


#: package -> (serving, commands, QOS, default_qos_table, fake engine)
SIDES = {
    "jax": (JS, JC, JaxQOS, jax_qos_table, _recording(JaxFakeEngine)),
    "torch": (TS, TC, QOS, default_qos_table, _recording(FakeEngine)),
}


# ------------------------------------------------------------ hash ring ----

@pytest.mark.parametrize("first", range(0, 60, 10))
def test_hash_ring_matches_jax(first):
    """Ten seeds a case: a random replica set (sparse ids, 1-64 vnodes),
    then random adds and removes; after each, 40 random keys and the
    affinity keys of random prompts map to the same replica."""
    for seed in range(first, first + 10):
        rng = np.random.default_rng(seed)
        vnodes = int(rng.choice([1, 8, 64]))
        rings = {"jax": JS.HashRing(vnodes), "torch": TS.HashRing(vnodes)}
        ids = [int(i) for i in rng.choice(100, int(rng.integers(1, 7)),
                                          replace=False)]
        for rid in ids:
            for ring in rings.values():
                ring.add(rid)
        for _ in range(8):
            if len(ids) > 1 and rng.random() < 0.5:
                rid = ids.pop(int(rng.integers(len(ids))))
                for ring in rings.values():
                    ring.remove(rid)
            else:
                rid = int(rng.integers(100, 200))
                if rid not in ids:
                    ids.append(rid)
                    for ring in rings.values():
                        ring.add(rid)
            keys = [rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
                    for _ in range(40)]
            for _ in range(10):
                prompt = rng.integers(0, 50_000, int(rng.integers(1, 40)))
                ps = int(rng.choice([4, 8, 16]))
                ka, kb = JS.affinity_key(prompt, ps), \
                    TS.affinity_key(prompt, ps)
                assert ka == kb
                keys.append(ka)
            got = {name: [ring.lookup(k) for k in keys]
                   for name, ring in rings.items()}
            assert got["jax"] == got["torch"]
            assert rings["jax"].replicas == rings["torch"].replicas \
                == sorted(ids)
            assert len(rings["torch"]) == len(ids)


# ----------------------------------------------- router over fake engines --

def _view(side, router) -> dict:
    """Everything one can read off a router over fake engines."""
    _, commands, *_ = SIDES[side]
    reps = sorted(router.replicas)
    return {
        "stats": dict(router.stats),
        "replicas": reps,
        "loads": [router.load(r) for r in reps],
        "running": [[q.rid for q in router.replicas[r].engine.running]
                    for r in reps],
        "queued": [sorted(q.rid for t in
                          router.replicas[r].admission.tenants.values()
                          for q in t.queue) for r in reps],
        "sdiag": commands.sdiag(router=router),
        "metrics": router.metrics.expose(),
        "page_size": router.page_size,
    }


def _script(seed) -> tuple:
    """A seeded random router configuration and event list, the same
    for both packages."""
    rng = np.random.default_rng(1000 + seed)
    conf = {"policy": str(rng.choice(["affinity", "rr", "least"])),
            "spill_factor": float(rng.choice([0.25, 0.5, 1.0, 2.0])),
            "grp_scope": str(rng.choice(["global", "replica"])),
            "cap": int(rng.choice([0, 2, 3])),
            "slots": int(rng.integers(1, 5)),
            "replicas": int(rng.integers(1, 4)),
            "vnodes": int(rng.choice([8, 64]))}
    systems = [rng.integers(0, 1000, int(rng.integers(16, 25)))
               for _ in range(3)]
    tenants = [("acme", 1), ("blue", 2), ("cold", 1)]
    events, rid = [], 0
    for _ in range(int(rng.integers(30, 60))):
        u = rng.random()
        if u < 0.40:
            if rng.random() < 0.7:
                prompt = np.concatenate([
                    systems[int(rng.integers(3))],
                    rng.integers(0, 1000, int(rng.integers(1, 9)))])
            else:
                prompt = rng.integers(0, 1000, int(rng.integers(1, 12)))
            out = [int(t) for t in rng.integers(0, 1000,
                                                int(rng.integers(0, 3)))]
            events.append(("submit", rid, prompt.astype(np.int32),
                           tenants[int(rng.integers(3))][0],
                           str(rng.choice(["normal", "normal", "high",
                                           "scavenger"])), out))
            rid += 1
        elif u < 0.47:
            events.append(("route", rng.integers(0, 1000, 20)
                           .astype(np.int32)))
        elif u < 0.62:
            events.append(("start", int(rng.integers(8))))
        elif u < 0.72:
            events.append(("finish", int(rng.integers(8)),
                           int(rng.integers(8))))
        elif u < 0.80:
            events.append(("step",))
        elif u < 0.85:
            events.append(("charge", tenants[int(rng.integers(3))][0],
                           float(rng.integers(1, 5000))))
        elif u < 0.93:
            events.append(("remove", int(rng.integers(8))))
        else:
            events.append(("add",))
    return conf, tenants, events


def _build(side, conf, tenants):
    serving, _, qos_cls, table_fn, fake = SIDES[side]
    table = table_fn()
    if conf["cap"]:
        table["normal"] = qos_cls(name="normal",
                                  priority=table["normal"].priority,
                                  grp_tres={"slots": conf["cap"]})
    router = serving.Router(lambda adm: fake(adm, num_slots=conf["slots"]),
                            replicas=conf["replicas"],
                            policy=conf["policy"],
                            spill_factor=conf["spill_factor"],
                            qos_table=table, grp_scope=conf["grp_scope"],
                            vnodes=conf["vnodes"])
    for name, shares in tenants:
        router.add_tenant(name, shares=shares)
    return router


def _apply(side, router, event):
    """Apply one event; returns what a caller would see from it."""
    serving = SIDES[side][0]
    kind = event[0]
    reps = sorted(router.replicas)
    if kind == "submit":
        _, rid, prompt, tenant, qos, out = event
        req = serving.Request(rid=rid, prompt=prompt, max_new_tokens=4,
                              tenant=tenant, qos=qos, output=list(out))
        return router.submit(req)
    if kind == "route":
        return router.route(serving.Request(rid=-1, prompt=event[1]))
    if kind == "start":
        router.replicas[reps[event[1] % len(reps)]].engine.start()
        return None
    if kind == "finish":
        eng = router.replicas[reps[event[1] % len(reps)]].engine
        if not eng.running:
            return None
        req = eng.running.pop(event[2] % len(eng.running))
        req.done = True
        eng.admission.release(req)
        return req.rid
    if kind == "step":
        return router.step()
    if kind == "charge":
        router.tree.charge_tres(event[1], {"tokens": event[2]})
        return None
    if kind == "remove":
        if len(reps) < 2:
            return None
        rid = reps[event[1] % len(reps)]
        eng = router.replicas[rid].engine
        moved = router.remove_replica(rid)
        return moved, eng.drained
    return router.add_replica()


@pytest.mark.parametrize("first", range(0, 60, 10))
def test_router_matches_jax_over_random_events(first):
    """Ten seeded event sequences a case, through both packages' routers
    in lockstep: equal results and views after every event; the sequences
    as a whole spill, drain with outputs kept, hit GrpTRES caps in both
    scopes, and use all three policies."""
    seen = {"spills": 0, "drains": 0, "kept": 0, "policies": set(),
            "scopes": set()}
    for seed in range(first, first + 10):
        conf, tenants, events = _script(seed)
        routers = {side: _build(side, conf, tenants) for side in SIDES}
        for i, event in enumerate(events):
            got = {side: _apply(side, r, event)
                   for side, r in routers.items()}
            assert got["jax"] == got["torch"], (seed, i, event)
            views = {side: _view(side, r) for side, r in routers.items()}
            assert views["jax"] == views["torch"], (seed, i, event)
            if event[0] == "remove" and got["torch"]:
                seen["kept"] += sum(bool(out) for _, out in
                                    got["torch"][1])
        st = routers["torch"].stats
        seen["spills"] += st["spills"]
        seen["drains"] += st["drains"]
        seen["policies"].add(conf["policy"])
        if conf["cap"]:
            seen["scopes"].add(conf["grp_scope"])
    assert seen["drains"] and seen["kept"]
    if first == 0:
        # the first ten seeds cover every policy, a spill and both scopes
        assert seen["policies"] == {"affinity", "rr", "least"}
        assert seen["spills"] and seen["scopes"] == {"global", "replica"}


@pytest.mark.parametrize("scope", ["global", "replica"])
def test_grp_tres_scope_matches_jax(scope):
    """The scenario of ``tests/test_router.py``'s GrpTRES tests on both
    packages: a 2-slot cap on the account binds across replicas under
    "global" and per replica under "replica"."""
    def run(side):
        serving = SIDES[side][0]
        router = _build(side, {"policy": "affinity", "spill_factor": 2.0,
                               "grp_scope": scope, "cap": 2, "slots": 4,
                               "replicas": 2, "vnodes": 64}, [])
        r0, r1 = (router.replicas[r] for r in sorted(router.replicas))
        prompt = np.arange(8, dtype=np.int32)
        for i in range(2):
            r0.engine.submit(serving.Request(rid=i, prompt=prompt,
                                             tenant="acme"))
        r1.engine.submit(serving.Request(rid=2, prompt=prompt,
                                         tenant="acme"))
        r0.engine.start()
        shared = router.grp_ledger is not None and \
            r0.admission.grp_ledger is router.grp_ledger
        third = r1.admission.next_request()
        return shared, r0.engine.active(), \
            None if third is None else third.rid
    assert run("jax") == run("torch") == (
        (True, 2, None) if scope == "global" else (False, 2, 2))


# --------------------------------------------------------- real engines ----

@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_reduced("stablelm-3b"), dtype="float32")
    tcfg = dataclasses.replace(get_reduced_config("stablelm-3b"),
                               dtype="float32")
    jparams = jax_init_params(jcfg, 0)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return {"jax": (jcfg, jparams), "torch": (tcfg, tparams)}


def _prompts(kind, vocab):
    """Each scenario's prompts (the JAX tests' where it has them)."""
    if kind == "rr":
        rng = np.random.default_rng(11)
        return [rng.integers(0, vocab, 5 + i) for i in range(5)], 4
    if kind == "dense":
        rng = np.random.default_rng(12)
        return [rng.integers(0, vocab, 6 + i) for i in range(4)], 6
    rng = np.random.default_rng(13)
    if kind == "prefix":
        systems = [rng.integers(2, vocab, 16) for _ in range(2)]
        return [np.concatenate([systems[i % 2],
                                rng.integers(2, vocab, 3 + i)])
                for i in range(6)], 6
    # budgeted: prompts of several 8-token chunks beside short ones
    return [rng.integers(2, vocab, n) for n in (7, 5, 19, 30)], 5


#: scenario -> (engine options, router policy, router steps before the
#: drain: 0 = no drain)
SCENARIOS = {
    "rr": (dict(), "rr", 0),
    "dense": (dict(), "rr", 1),
    "prefix": (dict(kv_page_size=8, prefix_cache=True), "affinity", 1),
    "budgeted": (dict(kv_page_size=8, max_batch_tokens=8), "rr", 2),
}


def _surface(eng) -> dict:
    return {"active": eng.active(), "pending": eng.pending(),
            "load": eng.load(), "radix": eng.radix_occupancy(),
            "queue": [q.rid for q in eng.queue]}


def _scenario(side, models, kind) -> dict:
    """One scenario through one package's router: outputs, the partial
    outputs at the drain, preemptions, stats, prefix counters, the gauges
    and each replica's engine surface after every step."""
    serving = SIDES[side][0]
    cfg, params = models[side]
    options, policy, drain = SCENARIOS[kind]
    metrics = JaxMetrics() if side == "jax" else MetricsRegistry()
    extra = {"device": "cpu"} if side == "torch" else {}

    def make(adm):
        return serving.DecodeEngine(
            cfg, params, num_slots=2, cache_len=64, admission=adm,
            metrics=metrics, decode_chunk=2, prefill_buckets="auto",
            **options, **extra)

    router = serving.Router(make, replicas=2, policy=policy,
                            metrics=metrics)
    prompts, max_new = _prompts(kind, cfg.vocab_size)
    reqs = [serving.Request(rid=i, prompt=p.astype(np.int32),
                            max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    out = {"placed": [router.submit(q) for q in reqs], "trace": []}

    def snap(what):
        reps = sorted(router.replicas)
        gauges = {name: [metrics.gauge(name).value(replica=str(r))
                         for r in reps]
                  for name in (METRIC_SERVE_REPLICA_LOAD,
                               METRIC_SERVE_REPLICA_KV_PAGES)}
        out["trace"].append((what, reps, gauges,
                             [_surface(router.replicas[r].engine)
                              for r in reps]))

    snap("submitted")
    for _ in range(max(drain, 1)):
        router.step()
        snap("step")
    if drain:
        reps = sorted(router.replicas)
        engines = {r: router.replicas[r].engine for r in reps}
        if kind == "budgeted":
            # a replica with a prompt part-way through its prefill
            victim = next(r for r in reps if any(
                p.pos_filled for p in engines[r]._partials))
            out["mid_prefill"] = [p.req.rid for p in
                                  engines[victim]._partials
                                  if p.pos_filled]
        else:
            victim = max(reps, key=lambda r: (router.load(r), -r))
        held = [q for q in engines[victim].slots if q is not None]
        out["partial"] = {q.rid: list(q.output) for q in held}
        out["moved"] = router.remove_replica(victim)
        snap("drained")
        out["victim_after"] = _surface(engines[victim])
    for _ in range(100):
        made = router.step()
        snap("step")
        if made == 0 and not any(router.load(r) for r in router.replicas):
            break
    out.update(
        outputs=[list(q.output) for q in reqs],
        done=[q.done for q in reqs],
        preemptions=[q.preemptions for q in reqs],
        stats=dict(router.stats),
        prefix={name: int(metrics.counter(name).value())
                for name in (METRIC_SERVE_PREFIX_HITS,
                             METRIC_SERVE_PREFIX_MISSES,
                             METRIC_SERVE_PREFIX_REUSED_TOKENS)})
    return out


@pytest.fixture(scope="module")
def jax_runs(models):
    """Each scenario through the JAX router, once a module."""
    return {kind: _scenario("jax", models, kind) for kind in SCENARIOS}


@pytest.mark.parametrize("kind", list(SCENARIOS))
def test_router_real_engines_match_jax(models, jax_runs, kind):
    """Greedy outputs, placements, partial outputs kept across the drain,
    preemptions, router stats, prefix counters and both per-replica
    gauges after every step equal the JAX router's in the same mode."""
    want, got = jax_runs[kind], _scenario("torch", models, kind)
    assert all(got["done"])
    for key in ("placed", "outputs", "preemptions", "stats", "prefix"):
        assert got[key] == want[key], key
    assert [t[:3] for t in got["trace"]] == [t[:3] for t in want["trace"]]
    if SCENARIOS[kind][2]:
        assert got["moved"] == want["moved"] > 0
        assert got["partial"] == want["partial"]
        assert any(got["partial"].values())     # drained mid-decode
        for rid, part in got["partial"].items():
            assert got["outputs"][rid][:len(part)] == part
            assert got["preemptions"][rid] >= 1
    if kind == "prefix":
        assert got["prefix"][METRIC_SERVE_PREFIX_HITS] > 0
        pages = [g[METRIC_SERVE_REPLICA_KV_PAGES] for _, _, g, _ in
                 got["trace"]]
        assert any(any(p) for p in pages)       # the gauge is set
    if kind == "budgeted":
        assert got["mid_prefill"] == want["mid_prefill"]
        assert got["mid_prefill"]


def test_two_replicas_match_one_engine(models):
    """The port's side of ``tests/test_router.py``'s contract: greedy
    output through two round-robin replicas equals one engine's."""
    routed = _scenario("torch", models, "rr")["outputs"]
    cfg, params = models["torch"]
    prompts, max_new = _prompts("rr", cfg.vocab_size)
    single = TS.DecodeEngine(cfg, params, num_slots=2, cache_len=64,
                             decode_chunk=2, prefill_buckets="auto",
                             device="cpu")
    reqs = [TS.Request(rid=i, prompt=p.astype(np.int32),
                       max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for q in reqs:
        single.submit(q)
    single.run_to_completion()
    assert [list(q.output) for q in reqs] == routed


def test_engine_surface_matches_jax(models, jax_runs):
    """``active``, ``pending``, ``load``, ``radix_occupancy`` and
    ``queue`` of every replica after every step of the prefix scenario,
    and the drained engine's surface after ``drain``, equal the JAX
    engine's; ``drain`` leaves nothing behind."""
    want = jax_runs["prefix"]
    got = _scenario("torch", models, "prefix")
    assert [t[3] for t in got["trace"]] == [t[3] for t in want["trace"]]
    assert got["victim_after"] == want["victim_after"] == {
        "active": 0, "pending": 0, "load": 0,
        "radix": got["victim_after"]["radix"], "queue": []}
    assert any(s["radix"]["nodes"] for t in got["trace"] for s in t[3])
    assert any(s["queue"] for t in got["trace"] for s in t[3])
