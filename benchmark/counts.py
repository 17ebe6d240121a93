"""Operations and bytes of the decoder's work, from shapes alone.

The yardstick of ``mfu``, ``decode_hbm_share`` and ``flash_fwd_roofline``:
a product of an [n, k] by a [k, m] matrix is 2·n·k·m operations; attention
of one query over ``keys`` keys is 4·H·Dh·keys (QKᵀ and PV); bytes count
each input once at its stored width (int8 values with their f32 scales).
``m`` is ``weights.model_dims`` of the configuration.
"""

from __future__ import annotations

import math


def layer_matmul_params(m: dict) -> int:
    d, H, Hkv, Dh, F = m["d"], m["H"], m["Hkv"], m["Dh"], m["F"]
    return d * H * Dh + d * 2 * Hkv * Dh + H * Dh * d + d * 2 * F + F * d


def layer_out_channels(m: dict) -> int:
    """Per-output-channel scales of one int8 layer (wq, wkv, wo, wi, wdown)."""
    return m["H"] * m["Dh"] + 2 * m["Hkv"] * m["Dh"] + m["d"] + 2 * m["F"] + m["d"]


def linear_flops(m: dict, tokens: int) -> float:
    """The layers' matrix products for ``tokens`` tokens."""
    return 2.0 * m["L"] * layer_matmul_params(m) * tokens


def head_flops(m: dict, tokens: int) -> float:
    return 2.0 * m["d"] * m["V"] * tokens


def attention_flops(m: dict, keys: float) -> float:
    """All layers' attention of one query over ``keys`` keys."""
    return 4.0 * m["L"] * m["H"] * m["Dh"] * keys


def chunk_flops(m: dict, pos: int, n: int) -> float:
    """A prompt chunk of ``n`` tokens after ``pos`` cached ones: the layers
    for every token, causal attention (token i sees pos + i + 1 keys) and
    the head for the one position whose logits the chunk returns."""
    keys = n * pos + n * (n + 1) / 2
    return linear_flops(m, n) + attention_flops(m, keys) + head_flops(m, 1)


def decode_flops(m: dict, keys: int) -> float:
    """One decoded token that attends ``keys`` keys (its own included)."""
    return linear_flops(m, 1) + head_flops(m, 1) + attention_flops(m, keys)


def causal_attention_flops(m: dict, n: int) -> float:
    """The fresh chunk's attention alone, over its own ``n`` real tokens."""
    return attention_flops(m, n * (n + 1) / 2)


def causal_attention_bytes(m: dict, n: int, itemsize: int = 2) -> float:
    """Q, K, V read once and O written once, every layer."""
    return float(m["L"] * n * (2 * m["H"] + 2 * m["Hkv"]) * m["Dh"] * itemsize)


def kv_bytes_per_token(m: dict, kv: str) -> int:
    """K and V of one position across layers, int8 with an f32 scale per
    (token, head), or bf16."""
    per = 2 * m["L"] * m["Hkv"] * m["Dh"]
    return per + 2 * m["L"] * m["Hkv"] * 4 if kv == "int8" else per * 2


def decode_weight_bytes(m: dict, weights: str) -> int:
    """What a decode step reads of the weights: every layer matrix and the
    head at their stored width (int8 with f32 per-channel scales), and the
    norm gains (f32)."""
    params = m["L"] * layer_matmul_params(m) + m["d"] * m["V"]
    norms = (2 * m["L"] + 1) * m["d"] * 4
    if weights == "int8":
        return params + 4 * (m["L"] * layer_out_channels(m) + m["V"]) + norms
    return 2 * params + norms


def page_bytes(m: dict, kv: str, page_size: int) -> int:
    """One KV page of ``page_size`` positions (the port's paged pool)."""
    return kv_bytes_per_token(m, kv) * page_size


def ceil_rank(vals: list[float], q: float) -> float | None:
    """The ceil-rank quantile (the port's convention); None when empty."""
    s = sorted(vals)
    if not s:
        return None
    return s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))]

