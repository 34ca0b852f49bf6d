"""max_memory_allocated over the window (reset at its start), in GiB."""


def read(rec):
    return rec["window_peak_bytes"] / 2**30
