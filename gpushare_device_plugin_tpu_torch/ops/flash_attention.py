"""Flash attention, forward and backward: hand-written CUDA kernels for
Hopper, their plain PyTorch versions, and the autograd Function that joins
them.

Counterpart of ``gpushare_device_plugin_tpu/ops/flash_attention.py``.
Each of its three Pallas kernels is two kernel entries here: one on the
tensor cores (wgmma, asynchronous copies; the helpers both sources share
are in ``csrc/sm90.cuh``) and one of scalar f32 FMAs:

- the forward ``_fwd_kernel``: ``flash_fwd`` in ``csrc/flash_fwd_sm90.cu``
  and ``flash_fwd_scalar`` in ``csrc/flash_fwd.cu``;
- the backward ``_dq_kernel`` and ``_dkv_kernel``: ``flash_bwd_dq`` /
  ``flash_bwd_dkv`` in ``csrc/flash_bwd_sm90.cu`` and
  ``flash_bwd_dq_scalar`` / ``flash_bwd_dkv_scalar`` in
  ``csrc/flash_bwd.cu``.

The reference's ``custom_vjp`` pair ``_flash`` / ``_flash_pair`` is
:class:`_Flash`. Each source's header states its bound on an H100 and
what the design does about it.

Both directions pick their entries by dtype and head dim alone
(:func:`fwd_entry`, :func:`bwd_entries`): bf16 with D in {64, 128}, what
serving and training run, takes the tensor-core kernels. f32 and every
other head dim take the scalar ones. f32 stays scalar because the tensor
cores' f32 route is TF32, whose 10-bit mantissa cannot meet the f32
tolerances the kernels are held to (1e-5 forward, 1e-4 of the largest
magnitude backward). A tensor-core entry raises on rows that are not
16-byte aligned; nothing drops to the scalar entry.

Layout is the reference's public one: q ``[B, S, H, D]``, k/v
``[B, S, Hkv, D]`` (GQA: query head ``h`` reads KV head ``h // (H //
Hkv)``), O in q's dtype, lse ``[B, S, H]`` float32. ``start`` ([B]) masks
keys before each row's first real position (left padding), ``kv_len``
([B]) masks keys at or after each row's length (right padding). A query
row that sees no key gets O = 0 and lse = -inf, and zero gradients.

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor takes
the plain version. Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

# Launches per kernel entry, counted where each wrapper launches it.
LAUNCHES = {
    "flash_fwd": 0,
    "flash_fwd_scalar": 0,
    "flash_bwd_dq": 0,
    "flash_bwd_dkv": 0,
    "flash_bwd_dq_scalar": 0,
    "flash_bwd_dkv_scalar": 0,
}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
# Head dims the tensor-core kernels are built for (bf16 only).
SM90_HEAD_DIMS = (64, 128)


def fits_kernel(S: int, D: int) -> bool:
    """True when the CUDA kernels take sequence length ``S`` and head dim
    ``D``: they mask their own ragged edges, so any ``S`` works; ``D`` must
    be a multiple of 8 and at most 128 (their register tile)."""
    return S >= 1 and D % 8 == 0 and 0 < D <= MAX_HEAD_DIM


def fwd_entry(dtype: torch.dtype, D: int) -> str:
    """The forward kernel entry for inputs of ``dtype`` and head dim ``D``:
    the tensor-core one for bf16 with D in :data:`SM90_HEAD_DIMS`, the
    scalar one otherwise."""
    if dtype == torch.bfloat16 and D in SM90_HEAD_DIMS:
        return "flash_fwd"
    return "flash_fwd_scalar"


def bwd_entries(dtype: torch.dtype, D: int) -> tuple[str, str]:
    """The (dQ, dK/dV) kernel entries the backward launches for inputs of
    ``dtype`` and head dim ``D``: the tensor-core ones for bf16 with D in
    :data:`SM90_HEAD_DIMS`, the scalar ones otherwise."""
    if dtype == torch.bfloat16 and D in SM90_HEAD_DIMS:
        return "flash_bwd_dq", "flash_bwd_dkv"
    return "flash_bwd_dq_scalar", "flash_bwd_dkv_scalar"


def _visible(B, S, *, causal, start, kv_len, device):
    """[B, Sq, Sk] bool: which keys each query row attends."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    vis = torch.ones((1, S, S), dtype=torch.bool, device=device)
    if causal:
        vis = vis & (kpos <= qpos)[None]
    if start is not None:
        vis = vis & (kpos[None] >= start.to(device).long()[:, None, None])
    if kv_len is not None:
        vis = vis & (kpos[None] < kv_len.to(device).long()[:, None, None])
    return vis.expand(B, S, S)


def _grouped(x, Hkv):
    """[B, S, H, ...] -> [B, Hkv, g, S, ...] f32: each KV head's query group."""
    B, S, H = x.shape[:3]
    return x.float().reshape(B, S, Hkv, H // Hkv, *x.shape[3:]).movedim(1, 3)


def flash_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
    scale: float, start: torch.Tensor | None = None,
    kv_len: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: scores and softmax
    in f32, probabilities cast to V's dtype before the PV product (as the
    reference kernel does), dead rows O = 0 / lse = -inf. Returns
    (O [B,S,H,D] in q's dtype, lse [B,S,H] f32)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qg = q.float().reshape(B, S, Hkv, g, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    vis = _visible(B, S, causal=causal, start=start, kv_len=kv_len, device=q.device)
    s = s.masked_fill(~vis[:, None, None], float("-inf"))
    m = s.amax(-1, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m_safe)
    l = p.sum(-1, keepdim=True)
    pv = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    l_q = l[..., 0].permute(0, 3, 1, 2)[..., None]  # [B, S, Hkv, g, 1]
    o = pv / torch.where(l_q == 0, torch.ones_like(l_q), l_q)
    lse = torch.where(l == 0, torch.full_like(l, float("-inf")), m + torch.log(l))
    lse = lse[..., 0].permute(0, 3, 1, 2).reshape(B, S, H)
    return o.reshape(B, S, H, D).to(q.dtype), lse


def flash_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool, scale: float,
    start: torch.Tensor | None = None, kv_len: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function in plain PyTorch, with their casts:
    P = exp(S·scale − lse) (a row with lse = −inf shifted by 0, so its P is
    0), dP = dO·Vᵀ, dS = P∘(dP − δ)·scale; dQ = dS·K with dS in K's dtype,
    dV = Pᵀ·dO with P in dO's dtype, dK = dSᵀ·Q with dS in Q's dtype, all
    summed in f32 and cast to the input's dtype. ``delta`` is
    rowsum(dO∘O) − dlse, [B, S, H] f32. Returns (dq, dk, dv)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qg, dog = _grouped(q, Hkv), _grouped(do, Hkv)  # [B, Hkv, g, S, D]
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bskd->bkgqs", qg, kf) * scale
    vis = _visible(B, S, causal=causal, start=start, kv_len=kv_len, device=q.device)
    s = s.masked_fill(~vis[:, None, None], float("-inf"))
    lse_g = _grouped(lse, Hkv)[..., None]
    p = torch.exp(s - torch.where(torch.isneginf(lse_g), torch.zeros_like(lse_g), lse_g))
    dp = torch.einsum("bkgqd,bskd->bkgqs", dog, vf)
    ds = p * (dp - _grouped(delta, Hkv)[..., None]) * scale
    dq = torch.einsum("bkgqs,bskd->bkgqd", ds.to(k.dtype).float(), kf)
    dk = torch.einsum("bkgqs,bkgqd->bskd", ds.to(q.dtype).float(), qg)
    dv = torch.einsum("bkgqs,bkgqd->bskd", p.to(do.dtype).float(), dog)
    dq = dq.movedim(3, 1).reshape(B, S, H, D)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, start, kv_len):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, heads, D]")
    B, S, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"q heads {H} not a multiple of kv heads {k.shape[2]}")
    for name, bound in (("start", start), ("kv_len", kv_len)):
        if bound is not None and tuple(bound.shape) != (B,):
            raise ValueError(f"{name} must be [{B}] (one bound per row)")


def _default_scale(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    scale: float | None = None, start: torch.Tensor | None = None,
    kv_len: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(O, lse) through the CUDA kernel :func:`fwd_entry` picks for CUDA
    tensors, through :func:`flash_fwd_plain` for CPU tensors."""
    _check(q, k, v, start, kv_len)
    sc = _default_scale(q, scale)
    if q.device.type == "cpu":
        return flash_fwd_plain(
            q, k, v, causal=causal, scale=sc, start=start, kv_len=kv_len
        )
    return _launch_fwd(fwd_entry(q.dtype, q.shape[3]), q, k, v, causal=causal, scale=sc,
                       start=start, kv_len=kv_len)


def flash_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool = True,
    scale: float | None = None, start: torch.Tensor | None = None,
    kv_len: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) through the two CUDA kernels :func:`bwd_entries` picks
    for CUDA tensors, through :func:`flash_bwd_plain` for CPU tensors.
    ``lse`` comes from the forward, ``delta`` is rowsum(dO∘O) − dlse; both
    [B, S, H] f32."""
    _check(q, k, v, start, kv_len)
    if do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} does not match q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 {tuple(q.shape[:3])}")
    sc = _default_scale(q, scale)
    if q.device.type == "cpu":
        return flash_bwd_plain(
            q, k, v, do, lse, delta, causal=causal, scale=sc, start=start, kv_len=kv_len
        )
    dq_entry, dkv_entry = bwd_entries(q.dtype, q.shape[3])
    dq = _launch_bwd(dq_entry, q, k, v, do, lse, delta, causal=causal,
                     scale=sc, start=start, kv_len=kv_len)
    dk, dv = _launch_bwd(dkv_entry, q, k, v, do, lse, delta, causal=causal,
                         scale=sc, start=start, kv_len=kv_len)
    return dq, dk, dv


_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_BWD_DQ_ARGS = [_PTR] * 9 + [_INT] * 5 + [_PTR, ctypes.c_float, _INT, _INT, _PTR]
_BWD_DKV_ARGS = [_PTR] * 10 + [_INT] * 5 + [_PTR, ctypes.c_float, _INT, _INT, _PTR]
_FWD_ARGS = [_PTR] * 7 + [_INT] * 5 + [_I64] * 9 + [ctypes.c_float, _INT, _INT, _PTR]
# Argument types of each C entry, in the order the sources declare them.
_ARGTYPES = {
    "flash_fwd": _FWD_ARGS,
    "flash_fwd_scalar": _FWD_ARGS,
    "flash_bwd_dq": _BWD_DQ_ARGS,
    "flash_bwd_dkv": _BWD_DKV_ARGS,
    "flash_bwd_dq_scalar": _BWD_DQ_ARGS,
    "flash_bwd_dkv_scalar": _BWD_DKV_ARGS,
}
# The source (``csrc/<name>.cu``) that defines each entry.
_SOURCE = {
    "flash_fwd": "flash_fwd_sm90",
    "flash_fwd_scalar": "flash_fwd",
    "flash_bwd_dq": "flash_bwd_sm90",
    "flash_bwd_dkv": "flash_bwd_sm90",
    "flash_bwd_dq_scalar": "flash_bwd",
    "flash_bwd_dkv_scalar": "flash_bwd",
}


@functools.cache
def _kernel(entry: str):
    """The built C entry ``entry``, with its argument types declared."""
    fn = getattr(_build.load(_SOURCE[entry]), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES[entry]
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _strides(t):
    """Element strides of ``t``'s (batch, seq, head) dims, 0 for a dim of
    size 1: its index is always 0, so whatever stride a view gave it is
    never used."""
    return [st if n > 1 else 0 for st, n in zip(t.stride()[:3], t.shape[:3])]


def _check_cuda(name, q, k, v, bounds, *extra):
    """Raise unless the kernel ``name`` takes these CUDA tensors: one
    device, bf16 or f32 q/k/v (and ``extra``) of one dtype, rows contiguous
    in their last dim, contiguous int32 bounds."""
    S, D = q.shape[1], q.shape[3]
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {q.device}")
    same = (k, v, *extra)
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in same):
        raise ValueError(
            f"{name} takes bf16 or f32 inputs of one dtype, got "
            f"{[str(t.dtype) for t in (q, *same)]}"
        )
    if not fits_kernel(S, D):
        raise ValueError(f"{name} kernel does not take S={S}, D={D}")
    for t in (*same, *bounds):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got {t.device}")
    for t in (q, *same):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs inputs contiguous in their last dim")
    for b in bounds:
        if b.dtype != torch.int32 or not b.is_contiguous():
            raise ValueError("start/kv_len must be contiguous int32")


def _check_sm90(entry, *tensors):
    """Raise unless the tensor-core entry ``entry`` takes these CUDA
    tensors: bf16, head dim in :data:`SM90_HEAD_DIMS`, and rows its
    16-byte copies can move (16-byte aligned base, strides a multiple of 8
    elements)."""
    D = tensors[0].shape[-1]
    if tensors[0].dtype != torch.bfloat16 or D not in SM90_HEAD_DIMS:
        raise ValueError(f"{entry} takes bf16 with D in {SM90_HEAD_DIMS}, "
                         f"got {tensors[0].dtype}, D={D}")
    for t in tensors:
        if t.data_ptr() % 16 or any(st % 8 for st in _strides(t)):
            raise ValueError(f"{entry} needs 16-byte aligned rows: strides "
                             f"{t.stride()} of a tensor at {t.data_ptr():#x}")


def _call(entry, device, *args):
    err = _kernel(entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
    LAUNCHES[entry] += 1


def _launch_fwd(entry, q, k, v, *, causal, scale, start, kv_len):
    """Launch a forward entry; returns (O, lse), both contiguous."""
    B, S, H, D = q.shape
    bounds = [b for b in (start, kv_len) if b is not None]
    _check_cuda(entry, q, k, v, bounds)
    if _SOURCE[entry].endswith("_sm90"):
        _check_sm90(entry, q, k, v)
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    _call(
        entry, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _ptr(start), _ptr(kv_len), B, S, H, k.shape[2], D,
        *_strides(q), *_strides(k), *_strides(v),
        float(scale), int(bool(causal)), _DTYPE_CODE[q.dtype],
    )
    return o, lse


def _launch_bwd(entry, q, k, v, do, lse, delta, *, causal, scale, start, kv_len):
    """Launch a dQ entry (returns dq) or a dK/dV entry (returns (dk, dv));
    outputs are contiguous."""
    B, S, H, D = q.shape
    bounds = [b for b in (start, kv_len) if b is not None]
    _check_cuda(entry, q, k, v, bounds, do)
    for t in (lse, delta):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{entry} needs contiguous lse/delta on {q.device}")
    if _SOURCE[entry].endswith("_sm90"):
        _check_sm90(entry, q, k, v, do)
    if entry in ("flash_bwd_dq", "flash_bwd_dq_scalar"):
        outs = [torch.empty_like(q, memory_format=torch.contiguous_format)]
    else:
        outs = [torch.empty(k.shape, dtype=k.dtype, device=k.device) for _ in range(2)]
    if q.numel() == 0:
        return outs[0] if len(outs) == 1 else tuple(outs)
    strides = (ctypes.c_int64 * 12)(*_strides(q), *_strides(k), *_strides(v), *_strides(do))
    _call(
        entry, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), _ptr(start), _ptr(kv_len), *(t.data_ptr() for t in outs),
        B, S, H, k.shape[2], D, ctypes.cast(strides, ctypes.c_void_p),
        float(scale), int(bool(causal)), _DTYPE_CODE[q.dtype],
    )
    return outs[0] if len(outs) == 1 else tuple(outs)


class _Flash(torch.autograd.Function):
    """(O, lse) = flash_fwd(q, k, v), differentiable in q, k and v.

    The counterpart of the reference's ``_flash`` and ``_flash_pair``
    ``custom_vjp``s in one Function: :func:`flash_attention` drops lse,
    and with materialized gradients off its absent dlse (or an absent dO)
    costs nothing. The backward folds dlse into δ = rowsum(dO∘O) − dlse
    outside the kernels, as the reference's ``_bwd`` does, then runs the
    two backward kernels (CUDA) or their plain version (CPU). ``start``
    and ``kv_len`` are integer bounds: no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, start, kv_len, causal, scale):
        o, lse = flash_fwd(q, k, v, causal=causal, scale=scale, start=start, kv_len=kv_len)
        ctx.save_for_backward(q, k, v, o, lse, start, kv_len)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, start, kv_len = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        if dlse is not None:
            delta = delta - dlse.float()
        dq, dk, dv = flash_bwd(
            q, k, v, do, lse, delta.contiguous(), causal=ctx.causal, scale=ctx.scale,
            start=start, kv_len=kv_len,
        )
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    scale: float | None = None, start: torch.Tensor | None = None,
    kv_len: torch.Tensor | None = None,
) -> torch.Tensor:
    """Flash attention over ``[B, S, H, D]`` (GQA-native), with the
    reference's ``start`` (left pad) and ``kv_len`` (right pad) bounds.
    Differentiable in q, k and v through the backward kernels."""
    return _Flash.apply(q, k, v, start, kv_len, causal, _default_scale(q, scale))[0]


def flash_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` that also returns the per-row logsumexp
    ``lse [B, S, H]`` f32 (the ring's merge input in the reference). Both
    outputs are differentiable: the lse cotangent folds into δ."""
    return _Flash.apply(q, k, v, None, None, causal, _default_scale(q, scale))
