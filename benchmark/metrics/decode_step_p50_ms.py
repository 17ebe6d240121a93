"""Median (ceil rank) of the engine's decode-step wall times in the window
(``StepProfiler``: a host clock around each pool-wide decode dispatch,
which ends in the copy of its tokens to the host)."""

from benchmark.counts import ceil_rank


def read(run):
    p50 = ceil_rank(run.window.step_s, 0.50)
    return None if p50 is None else p50 * 1e3
