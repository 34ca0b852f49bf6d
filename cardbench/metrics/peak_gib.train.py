"""max_memory_allocated over the window (reset at its start), in GiB; over
ranks, the rank that reads highest."""


def read(rec):
    return rec["window_peak_bytes"] / 2**30
