"""The share of the profiled stretch in which no device operation ran
(``torch.profiler``'s CUDA activity: kernels, copies, sets)."""


def read(run):
    tr = run.trace
    if tr is None or not tr["busy_s"] or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
