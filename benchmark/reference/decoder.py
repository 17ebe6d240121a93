"""The decoder both configurations are: RMSNorm, RoPE (rotate-half), grouped
or multi-head causal attention, SwiGLU, untied embeddings, in float32.

It follows the published Llama/Mistral block: ``h = x + Wo·attn(RoPE(Wq·n1),
RoPE(Wk·n1), Wv·n1)``, ``x' = h + Wdown·(silu(Wgate·n2) * Wup·n2)`` with
``n = x / sqrt(mean(x^2) + eps)`` (the norm gains are ones, as drawn), and
logits ``Wout·n(x)``. Departure, as in the configuration files: ``eps`` is
1e-6 in every configuration (the port's fixed value).

What the configuration states about precision is worked out here again:
``weight_bits`` 8 (or 4) is symmetric per-output-channel quantization of
every matrix (the embedding per row, the head per vocab column), ``kv_bits``
8 (or 4) the same per (token, head) over the head dim for K (after RoPE)
and V. The values are then used in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..weights import LAYER_LEAVES, draw_embed, draw_layer, draw_out

# contraction axes of each layer matrix: a scale per remaining channel
_AXES = {"wq": (0,), "wkv": (0,), "wo": (0, 1), "wi": (0,), "wdown": (0,)}
QUERY_BLOCK = 512
ROW_BLOCK = 4096


def fp32_only() -> None:
    """No TF32 anywhere: float32 products stay float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def qdq(w: torch.Tensor, axes: tuple[int, ...], bits: int | None) -> torch.Tensor:
    """``w`` in float32 after symmetric quantization to ``bits`` with one
    scale over ``axes`` (round half to even, clipped); unchanged for None."""
    w = w.float()
    if bits is None:
        return w
    qmax = 2 ** (bits - 1) - 1
    amax = w.abs().amax(dim=axes, keepdim=True)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    return torch.clamp(torch.round(w / scale), -qmax, qmax) * scale


def rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, heads, Dh] at positions 0..S-1, the halves rotated."""
    S, _, Dh = x.shape
    half = Dh // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [S, H, Dh], k and v [S, Hkv, Dh]; query head h reads kv head
    h // (H / Hkv)."""
    S, H, Dh = q.shape
    g = H // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)  # [H, S, Dh]
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for lo in range(0, S, QUERY_BLOCK):
        hi = min(S, lo + QUERY_BLOCK)
        s = torch.einsum("qhd,hkd->hqk", q[lo:hi], k[:, :hi]) / math.sqrt(Dh)
        keep = torch.arange(hi, device=q.device)[None, :] <= torch.arange(lo, hi, device=q.device)[:, None]
        s = s.masked_fill(~keep[None], float("-inf"))
        out[lo:hi] = torch.einsum("hqk,hkd->qhd", torch.softmax(s, dim=-1), v[:, :hi])
    return out


def logits_at(m: dict, seed: int, seqs: list[list[int]], positions: list[list[int]], *,
              weight_bits: int | None, kv_bits: int | None, device) -> list[torch.Tensor]:
    """Float32 logits [len(positions[i]), V] of each sequence ``seqs[i]``
    (a whole prompt and its served tokens) at ``positions[i]``, one layer
    at a time: each layer's weights are drawn again, quantized, used for
    every sequence and dropped."""
    fp32_only()
    eps, theta = m["eps"], m["theta"]
    lens = [len(s) for s in seqs]
    starts = [sum(lens[:i]) for i in range(len(seqs))]
    ids = torch.tensor([t for s in seqs for t in s], dtype=torch.long, device=device)
    embed = draw_embed(m, seed, device)
    x = qdq(embed[ids], (1,), weight_bits)  # a scale per vocab row
    del embed
    for layer in range(m["L"]):
        raw = draw_layer(m, seed, layer, device)
        w = {name: qdq(raw[name], _AXES[name], weight_bits) for name in LAYER_LEAVES}
        del raw
        attn = torch.empty((x.shape[0], m["H"], m["Dh"]), dtype=torch.float32, device=device)
        for lo, n in zip(starts, lens):
            h = rms(x[lo:lo + n], eps)
            q = rope(torch.einsum("nd,dhk->nhk", h, w["wq"]), theta)
            kv = torch.einsum("nd,dchk->nchk", h, w["wkv"])
            k = qdq(rope(kv[:, 0], theta), (-1,), kv_bits)
            v = qdq(kv[:, 1], (-1,), kv_bits)
            attn[lo:lo + n] = causal_attention(q, k, v)
        x = x + torch.einsum("nhk,hkd->nd", attn, w["wo"])
        del attn
        for lo in range(0, x.shape[0], ROW_BLOCK):
            h = rms(x[lo:lo + ROW_BLOCK], eps)
            gu = torch.einsum("nd,dcf->ncf", h, w["wi"])
            x[lo:lo + ROW_BLOCK] += (F.silu(gu[:, 0]) * gu[:, 1]) @ w["wdown"]
        del w
    out_w = qdq(draw_out(m, seed, device), (0,), weight_bits)  # a scale per vocab column
    return [rms(x[lo + torch.tensor(pos, dtype=torch.long, device=device)], eps) @ out_w
            for lo, pos in zip(starts, positions)]
