"""Rows a decode step advanced, on average: tokens decoded in the window (every
token after a request's first) over the window's decode steps
(``StepProfiler`` samples)."""


def read(run):
    steps = len(run.window.step_s)
    return len(run.window.decode_keys()) / steps if steps else None
