"""The bytes the window's decode steps need over what HBM moves in their time:
each step reads the weights once at their stored width (int8 with its f32
scales, or bf16) and each decoding row's live K and V once (``counts.py``),
over the steps' summed wall seconds times the card's 3.35 TB/s. The port
gathers each row's whole ``max_len`` span; only the live part is needed."""

from benchmark import counts


def read(run):
    w, m = run.window, run.dims
    secs = sum(w.step_s)
    bw = run.peaks.get("hbm_bytes_s")
    if not secs or not bw:
        return None
    need = len(w.step_s) * counts.decode_weight_bytes(m, run.precision["weights"])
    need += sum(w.decode_keys()) * counts.kv_bytes_per_token(
        m, run.precision["kv_cache"])
    return 100.0 * need / (secs * bw)
