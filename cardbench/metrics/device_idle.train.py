"""1 - (union of the device operations' intervals / the profiled
sub-window's wall time), in %; over ranks, rank 0's card."""
from harness.readers import idle_percent


def read(rec):
    return idle_percent(rec)
