"""90th percentile (ceil rank), over the requests that finished in the
window with at least two tokens, of (finish - first token) / (tokens - 1)."""

from benchmark.counts import ceil_rank


def read(run):
    w = run.window
    tpot = [(o.finish_s - o.first_s) / (len(o.tokens) - 1) for o in w.outcomes
            if o.finish_s is not None and o.finish_s >= w.t_open and len(o.tokens) >= 2]
    p90 = ceil_rank(tpot, 0.90)
    return None if p90 is None else p90 * 1e3
