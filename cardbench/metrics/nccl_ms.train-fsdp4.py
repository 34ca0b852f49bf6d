"""Device time of the NCCL kernels (gathers, reduce-scatters,
all-reduces: names that hold ``nccl``) in rank 0's profiled step, in ms;
nothing where the trace has none (a gloo run)."""


def read(rec):
    t = rec.get("trace")
    comm = [(s, e) for s, e, n in (t["ops"] if t else [])
            if "nccl" in n.lower()]
    if not comm:
        return None
    return sum(e - s for s, e in comm) / 1e3
