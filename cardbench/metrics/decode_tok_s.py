"""Output tokens the window's steps emitted (prefill's first tokens
included), over the window's length: from its start to the end of its
last step."""


def read(rec):
    w = rec["window"]
    return sum(s["tokens"] for s in rec["steps"]) / (w["t1"] - w["t0"])
