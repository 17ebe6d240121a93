"""The share of its roofline that ``flash_fwd`` (``ops/csrc/flash_fwd_sm90.cu``,
the device kernel ``fwd_kernel``) reaches in the profiled stretch: the least
time the card could take for the fresh prompt chunks' causal attention that
ran in the stretch (the larger of their operations over the bf16 peak and
their Q, K, V and O bytes over HBM's rate; ``counts.py``), over the device
time of those kernels in the trace. Nothing to read where no fresh chunk ran."""

import re

from benchmark import counts

# the tensor-core entry's kernel, not the scalar entry's flash_fwd_kernel
KERNEL = re.compile(r"(?<![A-Za-z0-9_])fwd_kernel(?![A-Za-z0-9_])")


def read(run):
    tr, st = run.trace, run.window.stretch
    if tr is None or st is None:
        return None
    secs = sum(s for name, s in tr["kernel_s"].items() if KERNEL.search(name))
    chunks = [c for c in run.window.chunks if c.fresh and st["t0"] <= c.t < st["t1"]]
    peak, bw = run.peaks.get("bf16_flops"), run.peaks.get("hbm_bytes_s")
    if not secs or not chunks or not peak or not bw:
        return None
    m = run.dims
    ops = sum(counts.causal_attention_flops(m, c.n) for c in chunks)
    nbytes = sum(counts.causal_attention_bytes(m, c.n) for c in chunks)
    return 100.0 * max(ops / peak, nbytes / bw) / secs
