"""The SLURM user-command surface from paper §5.2.1: sinfo, squeue, sbatch,
srun, salloc, scancel, scontrol, sacct — plus the multi-tenant accounting
surface (sacctmgr, sshare, sprio) — each returns the formatted text a user
would see, against a :class:`Cluster`.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.cluster.cluster import Cluster
from repro_torch.cluster.job import Job, JobState, ResourceRequest
from repro_torch.cluster.node import NodeState
from repro_torch.policy import format_tres


def _fmt_time(seconds: Optional[float]) -> str:
    if seconds is None:
        return "N/A"
    s = int(seconds)
    d, s = divmod(s, 86_400)
    h, s = divmod(s, 3_600)
    m, s = divmod(s, 60)
    if d:
        return f"{d}-{h:02d}:{m:02d}:{s:02d}"
    return f"{h:02d}:{m:02d}:{s:02d}"


def _compress(names) -> str:
    return ",".join(names) if names else ""


def sinfo(cluster: Cluster, partition: Optional[str] = None,
          node_oriented: bool = False, summarize: bool = False) -> str:
    """`sinfo` / `sinfo -N` / `sinfo -s`."""
    rows = []
    parts = ([cluster.partitions[partition]] if partition
             else list(cluster.partitions.values()))
    if node_oriented:
        rows.append(f"{'NODELIST':<14}{'PARTITION':<12}{'STATE':<8}"
                    f"{'CPUS':<6}{'GRES':<12}{'FREE_GRES':<10}")
        for p in parts:
            for nm in p.nodes:
                n = cluster.nodes[nm]
                gres = ",".join(f"{g}:{c}" for g, c in n.gres.items())
                free = ",".join(f"{g}:{n.free_gres(g)}" for g in n.gres)
                rows.append(f"{n.name:<14}{p.name:<12}{n.state.value:<8}"
                            f"{n.cpus:<6}{gres:<12}{free:<10}")
        return "\n".join(rows)
    rows.append(f"{'PARTITION':<12}{'AVAIL':<7}{'TIMELIMIT':<12}"
                f"{'NODES':<7}{'STATE':<8}NODELIST")
    for p in parts:
        by_state: dict[NodeState, list[str]] = {}
        for nm in p.nodes:
            by_state.setdefault(cluster.nodes[nm].state, []).append(nm)
        if summarize:
            alive = sum(len(v) for s, v in by_state.items()
                        if s != NodeState.DOWN)
            rows.append(f"{p.name + ('*' if p.default else ''):<12}"
                        f"{'up':<7}{_fmt_time(p.max_time_s):<12}"
                        f"{alive}/{len(p.nodes):<6}{'mixed':<8}")
            continue
        for state, names in sorted(by_state.items(), key=lambda kv: kv[0].value):
            rows.append(f"{p.name + ('*' if p.default else ''):<12}"
                        f"{'up':<7}{_fmt_time(p.max_time_s):<12}"
                        f"{len(names):<7}{state.value:<8}{_compress(names)}")
    return "\n".join(rows)


def squeue(cluster: Cluster, user: Optional[str] = None,
           states: Optional[list[str]] = None,
           partition: Optional[str] = None) -> str:
    """`squeue [-u user] [-t states] [-p partition]`."""
    rows = [f"{'JOBID':<8}{'PARTITION':<12}{'NAME':<20}{'USER':<10}"
            f"{'ACCOUNT':<10}{'QOS':<11}"
            f"{'ST':<4}{'TIME':<12}{'NODES':<7}NODELIST(REASON)"]
    for job in sorted(cluster.jobs.values(), key=Job.sort_key):
        if job.state.finished:
            continue
        if user and job.user != user:
            continue
        if partition and job.partition != partition:
            continue
        if states and job.state.value not in states:
            continue
        elapsed = (cluster.clock - job.start_time
                   if job.start_time is not None else 0)
        where = (_compress(job.nodes_alloc) if job.nodes_alloc
                 else f"({job.reason})")
        nm = job.name if job.array_index is None else \
            f"{job.name}[{job.array_index}]"
        rows.append(f"{job.job_id:<8}{job.partition:<12}{nm[:19]:<20}"
                    f"{job.user:<10}{job.account[:9]:<10}{job.qos[:10]:<11}"
                    f"{job.state.value:<4}"
                    f"{_fmt_time(elapsed):<12}{job.req.nodes:<7}{where}")
    return "\n".join(rows)


def sbatch(cluster: Cluster, name: str = "job", nodes: int = 1,
           gres: str = "", cpus_per_task: int = 1, mem: str = "1G",
           time: str = "01:00:00", partition: Optional[str] = None,
           dependency: str = "", array: int = 0, priority: int = 0,
           run_time_s: float = 60.0, script=None, user: str = "ubuntu",
           account: Optional[str] = None, qos: str = "normal",
           ckpt_interval_s: Optional[float] = None,
           checkpoint_dir: Optional[str] = None) -> str:
    """`sbatch` with the guide's §5.2.4 options (plus ``--account``/``--qos``).
    Returns the SLURM message."""
    req = ResourceRequest(
        nodes=nodes,
        gres_per_node=_parse_gres(gres),
        cpus_per_node=cpus_per_task,
        mem_mb_per_node=_parse_mem(mem),
        time_limit_s=_parse_time(time),
    )
    ids = cluster.submit(name, req, user=user, partition=partition,
                         priority=priority, run_time_s=run_time_s,
                         script=script, dependency=dependency, array=array,
                         account=account, qos=qos,
                         ckpt_interval_s=ckpt_interval_s,
                         checkpoint_dir=checkpoint_dir)
    if array:
        return f"Submitted batch job {ids[0]} (array {len(ids)} tasks)"
    return f"Submitted batch job {ids[0]}"


def srun(cluster: Cluster, script, name: str = "interactive", nodes: int = 1,
         gres: str = "tpu:4", time: str = "01:00:00",
         partition: Optional[str] = None, user: str = "ubuntu"):
    """`srun` — submit, run the queue until this job finishes, return its
    result (the interactive analogue of §5.2.2)."""
    req = ResourceRequest(nodes=nodes, gres_per_node=_parse_gres(gres),
                          time_limit_s=_parse_time(time))
    jid = cluster.submit(name, req, user=user, partition=partition,
                         script=script, run_time_s=1.0)[0]
    while not cluster.jobs[jid].state.finished:
        if not cluster.tick():
            break
    job = cluster.jobs[jid]
    if job.state != JobState.COMPLETED:
        raise RuntimeError(
            f"srun job {jid} {job.state.name}: {job.comment}")
    return job.result


salloc = srun     # salloc differs only in shell semantics; same allocation path


def scancel(cluster: Cluster, job_id: int) -> str:
    cluster.cancel(job_id)
    return f"scancel: job {job_id}"


def scontrol_show_job(cluster: Cluster, job_id: int) -> str:
    j = cluster.jobs[job_id]
    return (f"JobId={j.job_id} JobName={j.name} UserId={j.user} "
            f"Account={j.account} QOS={j.qos} Restarts={j.requeue_count} "
            f"Priority={j.priority} Partition={j.partition} "
            f"JobState={j.state.name} Reason={j.reason or 'None'} "
            f"NumNodes={j.req.nodes} "
            f"TRES=cpu={j.req.cpus_per_node},mem={j.req.mem_mb_per_node}M,"
            + ",".join(f"gres/{g}={n}" for g, n in
                       j.req.gres_per_node.items())
            + f" TimeLimit={_fmt_time(j.req.time_limit_s)} "
            f"NodeList={_compress(j.nodes_alloc) or '(null)'} "
            f"SubmitTime={j.submit_time:.0f} "
            f"StartTime={j.start_time if j.start_time is not None else 'N/A'} "
            f"EndTime={j.end_time if j.end_time is not None else 'N/A'}")


def scontrol_show_nodes(cluster: Cluster) -> str:
    rows = []
    for n in cluster.nodes.values():
        gres = ",".join(f"{g}:{c}" for g, c in n.gres.items())
        rows.append(
            f"NodeName={n.name} State={n.state.name} CPUTot={n.cpus} "
            f"CPUAlloc={n.alloc_cpus} RealMemory={n.mem_mb} "
            f"AllocMem={n.alloc_mem_mb} Gres={gres} "
            f"Coord={n.coord} Reason={n.reason or 'None'}")
    return "\n".join(rows)


def scontrol_update_node(cluster: Cluster, nodename: str, state: str,
                         reason: str = "") -> str:
    cluster.set_node_state(nodename, NodeState[state.upper()], reason)
    return f"scontrol: node {nodename} -> {state}"


def sacct(cluster: Cluster, user: Optional[str] = None,
          account: Optional[str] = None) -> str:
    """``sacct [-u user] [-A account]`` — one row per job *segment* (a
    preempted-then-requeued job shows a PREEMPTED row and a final row)."""
    rows = [f"{'JobID':<8}{'JobName':<20}{'Partition':<12}{'Account':<10}"
            f"{'QOS':<11}{'State':<12}"
            f"{'Elapsed':<12}{'NNodes':<8}{'ExitCode':<8}"]
    for r in cluster.accounting:
        if user and r.user != user:
            continue
        if account and r.account != account:
            continue
        rows.append(f"{r.job_id:<8}{r.name[:19]:<20}{r.partition:<12}"
                    f"{r.account[:9]:<10}{r.qos[:10]:<11}"
                    f"{r.state:<12}{_fmt_time(r.elapsed):<12}"
                    f"{len(r.nodes):<8}{r.exit_code or 0}:0")
    return "\n".join(rows)


# ----------------------------------------------- multi-tenant accounting ----

def sacctmgr_add_account(cluster: Cluster, name: str, parent: str = "root",
                         fairshare: int = 1, description: str = "") -> str:
    """``sacctmgr add account <name> parent=<p> fairshare=<n>``."""
    cluster.fairshare.add_account(name, parent=parent, shares=fairshare,
                                  description=description)
    return f" Adding Account(s)\n  {name}\n Settings\n  Fairshare={fairshare}"


def sacctmgr_add_user(cluster: Cluster, user: str, account: str) -> str:
    """``sacctmgr add user <u> account=<a>``."""
    cluster.fairshare.add_user(user, account)
    return f" Adding User(s)\n  {user}\n Settings\n  Account={account}"


def sacctmgr_modify_account(cluster: Cluster, name: str,
                            fairshare: Optional[int] = None,
                            parent: Optional[str] = None,
                            description: Optional[str] = None) -> str:
    """``sacctmgr modify account <name> set fairshare=<n> [parent=<p>]`` —
    live shares edit; the very next scheduling/sshare pass computes
    priorities from the new values (NormShares is derived on read)."""
    cluster.fairshare.modify_account(name, shares=fairshare, parent=parent,
                                     description=description)
    settings = []
    if fairshare is not None:
        settings.append(f"Fairshare={fairshare}")
    if parent is not None:
        settings.append(f"Parent={parent}")
    if description is not None:
        settings.append(f"Description={description}")
    return (" Modified account...\n  " + name + "\n Settings\n  "
            + "\n  ".join(settings or ["(no change)"]))


def sacctmgr_modify_qos(cluster: Cluster, name: str,
                        priority: Optional[int] = None,
                        preempt: Optional[tuple] = None,
                        grp_tres: Optional[dict] = None,
                        usage_factor: Optional[float] = None) -> str:
    """``sacctmgr modify qos <name> set priority=<n> grptres=... `` — live
    QOS edit.  QOS objects are frozen, so the catalogue entry is replaced
    wholesale; everything that consults ``cluster.qos_table`` (priority
    engine, preemption, GrpTRES holds) sees the new tier on its next
    pass."""
    import dataclasses as _dc

    assert name in cluster.qos_table, f"unknown QOS {name!r}"
    changes = {}
    if priority is not None:
        changes["priority"] = priority
    if preempt is not None:
        changes["preempt"] = tuple(preempt)
    if grp_tres is not None:
        changes["grp_tres"] = dict(grp_tres)
    if usage_factor is not None:
        changes["usage_factor"] = usage_factor
    cluster.qos_table[name] = _dc.replace(cluster.qos_table[name], **changes)
    settings = [f"{k}={v}" for k, v in changes.items()] or ["(no change)"]
    return (" Modified qos...\n  " + name + "\n Settings\n  "
            + "\n  ".join(settings))


def sacctmgr_show_assoc(cluster: Cluster) -> str:
    """``sacctmgr show assoc format=Account,ParentName,User,Fairshare``."""
    t = cluster.fairshare
    rows = [f"{'Account':<12}{'Par Name':<12}{'User':<10}{'Share':>6}"]
    for name in sorted(t.accounts):
        a = t.accounts[name]
        rows.append(f"{a.name:<12}{a.parent or '':<12}{'':<10}"
                    f"{a.shares:>6}")
        for u in sorted(u for u, acct in t.user_account.items()
                        if acct == name):
            rows.append(f"{a.name:<12}{'':<12}{u:<10}{1:>6}")
    return "\n".join(rows)


def sacctmgr_show_qos(cluster: Cluster) -> str:
    """``sacctmgr show qos format=Name,Priority,Preempt,PreemptMode,GrpTRES``."""
    rows = [f"{'Name':<12}{'Priority':>9} {'Preempt':<18}{'PreemptMode':<13}"
            "GrpTRES"]
    for name in sorted(cluster.qos_table):
        q = cluster.qos_table[name]
        rows.append(f"{q.name:<12}{q.priority:>9} "
                    f"{','.join(q.preempt) or '':<18}"
                    f"{q.preempt_mode:<13}{format_tres(q.grp_tres)}")
    return "\n".join(rows)


def sshare(cluster: Cluster, tres: bool = False) -> str:
    """``sshare -l``: the fair-share tree with live usage and factors.

    ``tres=True`` appends a TRESUsage column with the decayed raw
    per-resource consumption (``sshare -l -o ...,TRESRunMins``-style) —
    for a paged serving tenant, ``gres/kv_page`` there is its true HBM
    residency (page-steps held), not a whole-slot approximation."""
    t = cluster.fairshare
    t.decay_to(cluster.clock)
    header = (f"{'Account':<14}{'RawShares':>10}{'NormShares':>11}"
              f"{'RawUsage':>12}{'NormUsage':>10}{'FairShare':>10}")
    rows = [header + ("  TRESUsage" if tres else "")]

    def walk(name: str, depth: int):
        a = t.accounts[name]
        label = (" " * depth) + a.name
        row = (f"{label:<14}{a.shares:>10}{t.norm_shares(name):>11.4f}"
               f"{t.usage.get(name, 0.0):>12.0f}"
               f"{t.norm_usage(name):>10.4f}"
               f"{t.fair_share_factor(name):>10.4f}")
        if tres:
            usage = {k: round(v) for k, v in
                     t.tres_usage_of(name).items() if v >= 0.5}
            row += "  " + (format_tres(usage) if usage else "(none)")
        rows.append(row)
        for child in sorted(t.children(name), key=lambda c: c.name):
            walk(child.name, depth + 1)

    walk("root", 0)
    return "\n".join(rows)


def sdiag(cluster: Optional[Cluster] = None, tracer=None,
          admission=None, engine=None, router=None,
          autoscaler=None) -> str:
    """``sdiag``-style diagnostics: scheduler cycle statistics (from the
    cluster controller), admission-controller cycle statistics (from the
    serving layer), per-tenant serving SLO percentiles (from the
    tracer's derived histograms), serve-step utilization (from a
    budgeted DecodeEngine's per-iteration counters), speculative
    decoding acceptance (from a speculating engine), and tensor
    parallelism (from a mesh-attached engine — shard layout, per-device
    KV-pool occupancy, cross-shard reductions per token).  Any subset
    of sources may be given; sections for absent sources are simply
    omitted.  With the elastic tier, ``router`` adds routing decisions
    plus per-replica load/radix occupancy, and ``autoscaler`` adds
    capacity-probe and scale-up/drain counts."""
    sections = []
    if cluster is not None:
        st = cluster.sched_stats
        mean = st["total_us"] / st["passes"] if st["passes"] else 0.0
        sections.append("\n".join([
            "Main schedule statistics (microseconds):",
            f"\tTotal cycles:     {st['passes']}",
            f"\tLast cycle:       {st['last_us']:.0f}",
            f"\tMean cycle:       {mean:.0f}",
            f"\tMax cycle:        {st['max_us']:.0f}",
            f"\tJobs started:     {st['starts']}",
            f"\tJobs pending:     {len(cluster._pending())}",
            f"\tJobs running:     {len(cluster._running())}",
            f"\tPreemptions:      {cluster.preemptions_total}",
        ]))
    if admission is not None:
        st = admission.stats
        sections.append("\n".join([
            "Admission controller statistics:",
            f"\tCycles:           {st['cycles']}",
            f"\tPicks:            {st['picks']}",
            f"\tPreemptive picks: {st['preempt_picks']}",
            f"\tRequeues:         {st['requeues']}",
            f"\tQueued now:       {admission.pending()}",
        ]))
    if engine is not None and getattr(engine, "max_batch_tokens",
                                      None) is not None:
        st = engine.serve_stats
        it, T = st["iterations"], engine.max_batch_tokens
        spent = st["decode_tokens"] + st["prefill_tokens"]
        cap = it * T
        fill = spent / cap if cap else 0.0
        d_pct = st["decode_tokens"] / spent if spent else 0.0
        p_pct = st["prefill_tokens"] / spent if spent else 0.0
        sections.append("\n".join([
            "Serve-step utilization (token budget):",
            f"\tIterations:       {it}",
            f"\tToken budget:     {T}/step",
            f"\tBudget fill:      {spent}/{cap} ({fill:.0%})",
            f"\tDecode tokens:    {st['decode_tokens']} ({d_pct:.0%})",
            f"\tPrefill tokens:   {st['prefill_tokens']} ({p_pct:.0%}, "
            f"{st['prefill_chunks']} chunks)",
        ]))
    if engine is not None and getattr(engine, "speculate", 0):
        st = engine.spec_stats
        rate = st["accepted"] / st["proposed"] if st["proposed"] else 0.0
        run_len = st["emitted"] / st["rounds"] if st["rounds"] else 0.0
        by = ", ".join(f"{k}: {v}"
                       for k, v in sorted(st["proposed_by"].items()))
        sections.append("\n".join([
            "Speculative decoding:",
            f"\tDraft length (k): {engine.speculate}",
            f"\tVerify rounds:    {st['rounds']}",
            f"\tProposed:         {st['proposed']}"
            + (f" ({by})" if by else ""),
            f"\tAccepted:         {st['accepted']} ({rate:.0%})",
            f"\tTokens/round:     {run_len:.2f}",
        ]))
    if engine is not None and getattr(engine, "tp", None) is not None \
            and engine.tp.tp > 1:
        st = engine.tp_stats()
        ps = st["psums_per_token"]
        lines = [
            "Tensor parallelism:",
            f"\tPlan:             {st['plan']}",
            f"\tDevices:          {len(st['devices'])}"
            + (f" ({', '.join(st['devices'])})" if st["devices"] else ""),
            f"\tPsums/token:      {sum(ps.values())} "
            f"(attn_out {ps['attn_out']}, mlp_out {ps['mlp_out']})",
        ]
        if "kv_pages_in_use" in st:
            total = st["kv_pages_total"]
            for k, n in enumerate(st["kv_pages_in_use"]):
                pct = n / total if total else 0.0
                lines.append(f"\tKV pool shard {k}:  {n}/{total} pages "
                             f"({pct:.0%})")
        for note in st["notices"]:
            lines.append(f"\tNotice:           {note}")
        sections.append("\n".join(lines))
    if router is not None:
        st = router.stats
        routed = st["routed"]
        hit_pct = st["affinity_hits"] / routed if routed else 0.0
        lines = [
            "Prefix-affinity router:",
            f"\tReplicas:         {len(router.replicas)}",
            f"\tPolicy:           {router.policy} "
            f"(spill factor {router.spill_factor:g})",
            f"\tRouted:           {routed}",
            f"\tAffinity hits:    {st['affinity_hits']} ({hit_pct:.0%})",
            f"\tSpills:           {st['spills']}",
            f"\tDrains:           {st['drains']} "
            f"({st['resubmitted']} requests re-routed)",
        ]
        for rid in sorted(router.replicas):
            rep = router.replicas[rid]
            occ = rep.engine.radix_occupancy()
            lines.append(
                f"\tReplica {rid}:        load {router.load(rid)} "
                f"({rep.engine.active()} active, "
                f"{rep.engine.pending()} queued), "
                f"{occ['nodes']} radix nodes")
        sections.append("\n".join(lines))
    if autoscaler is not None:
        st = autoscaler.stats
        jobs = ", ".join(f"{rid}->job {jid}"
                         for rid, jid in sorted(autoscaler.jobs.items()))
        sections.append("\n".join([
            "Autoscaler (scavenger replicas):",
            f"\tTicks:            {st['ticks']}",
            f"\tLast probe:       {st['last_probe']} idle "
            f"node(s) @ {autoscaler.req.nodes}/replica",
            f"\tScale-ups:        {st['scale_ups']}",
            f"\tDrains:           {st['drains']} "
            f"({st['requeued_requests']} requests requeued)",
            f"\tReplica jobs:     {jobs or '(none)'}",
        ]))
    if tracer is not None:
        sections.append("Serving SLO (per tenant/QOS):\n"
                        + tracer.slo.format_report())
    return "\n\n".join(sections) if sections else "sdiag: nothing to report"


def sprio(cluster: Cluster) -> str:
    """``sprio -l``: multifactor priority breakdown for pending jobs."""
    rows = [f"{'JOBID':<8}{'USER':<10}{'ACCOUNT':<10}{'PRIORITY':>9}"
            f"{'AGE':>7}{'FAIRSHARE':>10}{'JOBSIZE':>8}{'PARTITION':>10}"
            f"{'QOS':>7}{'NICE':>6}"]
    engine = cluster.priority_engine
    pending = [j for j in cluster.jobs.values()
               if j.state == JobState.PENDING]
    for job in sorted(pending, key=lambda j: j.job_id):
        b = engine.breakdown(job, cluster.clock, cluster.partitions,
                             len(cluster.nodes))
        rows.append(f"{job.job_id:<8}{job.user:<10}{job.account[:9]:<10}"
                    f"{b.total:>9.0f}{b.age:>7.0f}{b.fairshare:>10.0f}"
                    f"{b.job_size:>8.0f}{b.partition:>10.0f}"
                    f"{b.qos:>7.0f}{b.nice:>6.0f}")
    return "\n".join(rows)


# ------------------------------------------------------------- parsing ------

def _parse_gres(text: str) -> dict:
    """``tpu:4`` or ``gpu:2,tpu:4`` -> {"tpu": 4, ...}."""
    out = {}
    if not text:
        return out
    for part in text.split(","):
        name, _, count = part.partition(":")
        out[name.strip()] = int(count or 1)
    return out


def _parse_mem(text: str) -> int:
    """``32G`` / ``512M`` -> MB."""
    text = text.strip().upper()
    if text.endswith("G"):
        return int(float(text[:-1]) * 1024)
    if text.endswith("M"):
        return int(float(text[:-1]))
    return int(text)


def _parse_time(text: str) -> int:
    """``D-HH:MM:SS`` / ``HH:MM:SS`` / ``MM:SS`` / minutes -> seconds."""
    text = text.strip()
    days = 0
    if "-" in text:
        d, text = text.split("-", 1)
        days = int(d)
    parts = [int(p) for p in text.split(":")]
    if len(parts) == 3:
        h, m, s = parts
    elif len(parts) == 2:
        h, (m, s) = 0, parts
    else:
        h, m, s = 0, parts[0], 0
    return days * 86_400 + h * 3_600 + m * 60 + s
