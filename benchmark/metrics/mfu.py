"""Model operations of the window over its wall seconds times the card's
bf16 peak (both configurations multiply in bf16): every prompt chunk the
engine ran (radix hits are not run, so not counted) and every decoded
token, each with attention at its own context length (``counts.py``)."""

from benchmark import counts


def read(run):
    w, m = run.window, run.dims
    peak = run.peaks.get("bf16_flops")
    if not peak:
        return None
    ops = sum(counts.chunk_flops(m, c.pos, c.n) for c in w.chunks)
    ops += sum(counts.decode_flops(m, k) for k in w.decode_keys())
    return 100.0 * ops / (w.seconds * peak)
