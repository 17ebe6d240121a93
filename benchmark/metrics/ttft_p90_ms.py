"""90th percentile (ceil rank) of time to first token over every request
that arrived while the window was open: from the wall time at which the
engine's tick clock reached its arrival to its first token; a request
still without one when the window closed counts with its wait until then."""

from benchmark.counts import ceil_rank


def read(run):
    w = run.window
    ttft = [(o.first_s if o.first_s is not None else w.t_close) - o.arrival_s
            for o in w.arrived()]
    p90 = ceil_rank(ttft, 0.90)
    return None if p90 is None else p90 * 1e3
