"""Plain grouped (GQA) attention, the port's shared attention math.

Counterpart of ``gpushare_device_plugin_tpu/parallel/ring.py::
grouped_attention``. The ring and Ulysses schedules of that module are
not ported yet.
"""

from __future__ import annotations

import math

import torch


def grouped_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """q [B, Tq, H, D]; k, v [B, Tk, Hkv, D], H a multiple of Hkv.

    ``mask`` ([B|1, Tq, Tk] bool, True = attend) composes with the causal
    mask; rows left fully masked produce zeros, never NaN. The score
    product comes out in the compute dtype and is then cast to f32, as in
    the reference; softmax and the PV product run in f32, with one cast
    back to q's dtype at the end.
    """
    B, Tq, H, D = q.shape
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"q heads {H} not a multiple of kv heads {Hkv}")
    g = H // Hkv
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Tq, Hkv, g, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * sc
    m = None
    if causal:
        m = torch.ones((Tq, k.shape[1]), dtype=torch.bool, device=q.device)
        m = torch.tril(m)[None]
    if mask is not None:
        m = mask if m is None else (m & mask)
    if m is not None:
        s = s.masked_fill(~m[:, None, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        dead = ~m.any(-1)  # [B|1, Tq]
        p = p.masked_fill(dead[:, None, None, :, None], 0.0)
    else:
        p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float()).to(q.dtype)
    return out.reshape(B, Tq, H, D)
