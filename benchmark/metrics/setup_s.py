"""Seconds from the process's start to the window's open: imports, the pod's
env, the weights, the engine and its warm-up, and any priming pass."""


def read(run):
    return run.setup_s
