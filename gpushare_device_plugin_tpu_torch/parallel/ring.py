"""Ring attention over a mesh axis, and the port's shared attention math.

Counterpart of ``gpushare_device_plugin_tpu/parallel/ring.py``. The
sequence is tiled over the ``sp`` axis: rank i of the ring holds
positions ``[i*T, (i+1)*T)`` (block-major order). Each rank keeps its Q
block while the K/V blocks go round the ring, n-1 hops of
:func:`.collectives.shift` (K and V in one exchange), and it folds each
hop into its output exactly:

- ``"plain"`` hops: the einsum online softmax (:func:`_online_update`);
- ``"flash"`` hops: the flash kernel (``ops.flash_attention_lse``) per
  hop, the diagonal hop causal, earlier hops non-causal, future hops
  empty at lse = -inf, merged by their logsumexps (:func:`_ring_flash_hops`);
- ``"auto"``: flash for CUDA tensors whose blocks the kernel takes.

A causal hop whose whole K/V block lies in the rank's future is skipped
(no scores), yet the rank still takes part in that hop's exchange, in the
forward and in the backward.

PyTorch has no global array, so :func:`ring_attention` takes each rank's
local shard and returns the rank's shard of the output.
:func:`grouped_attention` is the shared single-device GQA attention;
:func:`full_attention` is the plain MHA oracle.
"""

from __future__ import annotations

import math

import torch

from ..ops.flash_attention import fits_kernel, flash_attention_lse
from .collectives import shift
from .mesh import Mesh

_NEG_INF = float("-inf")


def _online_update(o, m, l, s, v):
    """One online-softmax accumulation step (GQA-grouped shapes).

    o: [B,Hkv,g,Tq,D] f32 weighted-value accumulator, m: [B,Hkv,g,Tq]
    running max, l: [B,Hkv,g,Tq] running denominator, s: [B,Hkv,g,Tq,Tk]
    f32 scores (may be -inf), v: [B,Tk,Hkv,D]. MHA is the g=1 case.
    """
    m_new = torch.maximum(m, s.amax(-1))
    # Rows fully masked so far have m_new == -inf: 0 in its place makes
    # the exps below exact zeros instead of NaN ((-inf) - (-inf)).
    m_safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new), m_new)
    p = torch.exp(s - m_safe[..., None])
    alpha = torch.exp(m - m_safe)  # m_safe is finite, so m = -inf gives 0
    l_new = alpha * l + p.sum(-1)
    o_new = alpha[..., None] * o + torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return o_new, m_new, l_new


def _ring_uses_kernel(q: torch.Tensor, Tq: int, Tk: int, hop_attention: str) -> bool:
    """The flash-hop gate: "flash" always, "plain" never, "auto" for a
    CUDA tensor with ``Tq == Tk`` whose block the kernel takes
    (``fits_kernel``)."""
    if hop_attention not in ("auto", "plain", "flash"):
        raise ValueError(f"unknown hop_attention={hop_attention!r}: expected auto|plain|flash")
    if hop_attention != "auto":
        return hop_attention == "flash"
    return q.device.type == "cuda" and Tq == Tk and fits_kernel(Tq, q.shape[-1])


class _Keep(torch.autograd.Function):
    """``x`` unchanged, with ``tensors`` kept in the graph at a zero
    gradient: a skipped hop's K/V then still reach the backward, so this
    rank joins the exchange that brought them, as its neighbours do."""

    @staticmethod
    def forward(ctx, x, *tensors):
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in tensors]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad, *_):
        return (grad, *(torch.zeros(s, dtype=d, device=dev) for s, d, dev in ctx.shapes))


def _keep(x, *tensors):
    if not any(t.requires_grad for t in tensors):
        return x
    return _Keep.apply(x, *tensors)


def ring_attention_block(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    *,
    axis_name: str = "sp",
    causal: bool = True,
    scale: float | None = None,
    hop_attention: str = "auto",
) -> torch.Tensor:
    """One rank's ring attention: q [B, Tq, H, D] its query block; k, v
    [B, Tk, Hkv, D] its K/V block (GQA: Hkv divides H, and the ring moves
    only the grouped heads). Returns [B, Tq, H, D]."""
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"q heads {H} not a multiple of kv heads {Hkv}")
    g = H // Hkv
    n = mesh.shape[axis_name]
    idx = mesh.axis_index(axis_name)
    sc = scale if scale is not None else 1.0 / math.sqrt(D)

    if _ring_uses_kernel(q, Tq, Tk, hop_attention):
        return _ring_flash_hops(q, k, v, mesh=mesh, idx=idx, n=n, axis_name=axis_name,
                                causal=causal, sc=sc)

    q_pos = idx * Tq + torch.arange(Tq, device=q.device)  # global query positions
    qg = q.reshape(B, Tq, Hkv, g, D)
    o = torch.zeros((B, Hkv, g, Tq, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, Hkv, g, Tq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, g, Tq), dtype=torch.float32, device=q.device)

    def accumulate(o, m, l, k, v, src):
        # Causal hop skip: block ``src`` lies wholly in this rank's future
        # when its first key position is past the last query position.
        if causal and src * Tk > idx * Tq + (Tq - 1):
            return _keep(o, k, v), m, l
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * sc
        if causal:
            k_pos = src * Tk + torch.arange(Tk, device=q.device)
            s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), _NEG_INF)
        return _online_update(o, m, l, s, v)

    # n-1 hops rotate K/V; the last block is used where it lands.
    for i in range(n):
        if i:
            k, v = shift(mesh, axis_name, k, v)
        o, m, l = accumulate(o, m, l, k, v, (idx - i) % n)
    l = torch.where(l == 0.0, torch.ones_like(l), l)  # fully masked rows
    out = (o / l[..., None]).to(q.dtype)  # [B,Hkv,g,Tq,D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, D)


def _merge(o_a, lse_a, o_b, lse_b):
    """Exact merge of two attention partials by their logsumexps; a
    partial at lse = -inf (an empty hop) weighs 0. The 0 and 1 put in
    place of -inf and an empty denominator keep the unselected branch's
    gradients finite."""
    m = torch.maximum(lse_a, lse_b)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    wa = torch.exp(lse_a - m_safe)
    wb = torch.exp(lse_b - m_safe)
    denom = wa + wb
    empty = denom == 0.0
    denom_safe = torch.where(empty, torch.ones_like(denom), denom)
    o = (wa[..., None] * o_a + wb[..., None] * o_b) / denom_safe[..., None]
    lse = m_safe + torch.log(denom_safe)
    lse = torch.where(empty, torch.full_like(lse, _NEG_INF), lse)
    return o, lse


def _ring_flash_hops(q, k, v, *, mesh, idx, n, axis_name, causal, sc):
    """The ring through the flash kernel: per-hop (O, lse), merged exactly.

    Under block-major order (Tq == Tk), ``src < idx`` is fully visible
    (non-causal kernel), ``src == idx`` the diagonal (causal kernel: local
    causality is global there), ``src > idx`` fully future (empty: zero
    output at lse = -inf, no kernel).

    q, K and V are carried in f32 and cast to their own dtype for each
    kernel call (exactly), so that their gradients sum over the hops in
    f32: a bf16 sum would round once a hop where the single kernel rounds
    once. For bf16 inputs that doubles the bytes of each exchange.
    """
    dt = q.dtype
    q32, k, v = q.float(), k.float(), v.float()

    def flash(kk, vv, hop_causal):
        o, lse = flash_attention_lse(q32.to(dt), kk.to(dt), vv.to(dt), causal=hop_causal,
                                     scale=sc)
        return o.float(), lse

    # Hop 0: every rank starts with its own block, the diagonal.
    o_acc, lse_acc = flash(k, v, causal)
    for i in range(1, n):
        k, v = shift(mesh, axis_name, k, v)
        if causal and (idx - i) % n > idx:
            o_acc = _keep(o_acc, k, v)
            continue
        o_acc, lse_acc = _merge(o_acc, lse_acc, *flash(k, v, False))
    return o_acc.to(dt)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    *,
    axis_name: str = "sp",
    causal: bool = True,
    scale: float | None = None,
    batch_axes: tuple[str, ...] | None = None,
    head_axes: str | tuple[str, ...] | None = None,
    hop_attention: str = "auto",
) -> torch.Tensor:
    """Sequence-parallel attention over ``mesh``'s ``axis_name`` ring.

    The reference takes global ``[B, S, H, D]`` arrays sharded as
    ``(batch_axes, axis_name, head_axes, None)``. PyTorch has no global
    array: here each rank passes its local shard under that spec (as
    :func:`.mesh.shard` cuts it) and gets its shard of the output back.
    Each (batch, head) tile attends on its own, so ``batch_axes`` and
    ``head_axes`` only name how the caller tiled the global arrays
    (tensor parallelism composes with the ring: each (tp, sp) rank works
    on its own head and sequence tile). ``hop_attention`` as in
    :func:`ring_attention_block`.
    """
    del batch_axes, head_axes
    return ring_attention_block(q, k, v, mesh, axis_name=axis_name, causal=causal,
                                scale=scale, hop_attention=hop_attention)


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


def full_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain single-device MHA attention: the ring's correctness oracle."""
    B, S, H, D = q.shape
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * sc
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
        s = s.masked_fill(~mask[None, None], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
