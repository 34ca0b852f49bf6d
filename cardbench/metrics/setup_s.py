"""Set-up: from the process's start to the window's start (weights,
engine or training step, warm-up of every shape, kernel builds)."""


def read(rec):
    return rec["setup_s"]
