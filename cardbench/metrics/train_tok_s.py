"""Tokens of every step in the window over those steps' total wall time
(each step ends in a synchronize)."""


def read(rec):
    steps = [s for s in rec["steps"] if not s["traced"]]
    return sum(s["tokens"] for s in steps) / \
        sum(s["t1"] - s["t0"] for s in steps)
