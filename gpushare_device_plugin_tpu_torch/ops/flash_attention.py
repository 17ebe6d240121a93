"""Flash attention forward: a hand-written CUDA kernel for Hopper and its
plain PyTorch version.

Counterpart of ``gpushare_device_plugin_tpu/ops/flash_attention.py``
(``_fwd_kernel``, the forward Pallas kernel, and its public entries
``flash_attention`` / ``flash_attention_lse``). The kernel source is
``csrc/flash_fwd.cu``; its header states the bound on an H100 and what
the design does about it.

Layout is the reference's public one: q ``[B, S, H, D]``, k/v
``[B, S, Hkv, D]`` (GQA: query head ``h`` reads KV head ``h // (H //
Hkv)``), O in q's dtype, lse ``[B, S, H]`` float32. ``start`` ([B]) masks
keys before each row's first real position (left padding), ``kv_len``
([B]) masks keys at or after each row's length (right padding). A query
row that sees no key gets O = 0 and lse = -inf.

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor takes
the plain version. Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

# Launches per kernel, counted where each wrapper launches it.
LAUNCHES = {"flash_fwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def fits_kernel(S: int, D: int) -> bool:
    """True when the CUDA kernel takes sequence length ``S`` and head dim
    ``D``: it masks its own ragged edges, so any ``S`` works; ``D`` must
    be a multiple of 8 and at most 128 (its register tile)."""
    return S >= 1 and D % 8 == 0 and 0 < D <= MAX_HEAD_DIM


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


def flash_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
    scale: float, start: torch.Tensor | None = None,
    kv_len: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: scores and softmax in f32,
    probabilities cast to V's dtype before the PV product (as the
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


def flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    scale: float | None = None, start: torch.Tensor | None = None,
    kv_len: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(O, lse) through the CUDA kernel for CUDA tensors, through
    :func:`flash_fwd_plain` for CPU tensors."""
    _check(q, k, v, start, kv_len)
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_fwd_plain(
            q, k, v, causal=causal, scale=sc, start=start, kv_len=kv_len
        )
    return _launch(q, k, v, causal=causal, scale=sc, start=start, kv_len=kv_len)


@functools.cache
def _kernel():
    """The built ``flash_fwd`` C entry, with its argument types declared."""
    fn = _build.load("flash_fwd").flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    return fn


def _launch(q, k, v, *, causal, scale, start, kv_len):
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on CUDA or CPU tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_fwd takes bf16 or f32 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if not fits_kernel(S, D):
        raise ValueError(f"flash_fwd kernel does not take S={S}, D={D}")
    bounds = [b for b in (start, kv_len) if b is not None]
    for t in (k, v, *bounds):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got {t.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    for b in bounds:
        if b.dtype != torch.int32 or not b.is_contiguous():
            raise ValueError("start/kv_len must be contiguous int32")
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        ptr(start), ptr(kv_len), B, S, H, Hkv, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(scale), int(bool(causal)), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    scale: float | None = None, start: torch.Tensor | None = None,
    kv_len: torch.Tensor | None = None,
) -> torch.Tensor:
    """Flash attention over ``[B, S, H, D]`` (GQA-native), with the
    reference's ``start`` (left pad) and ``kv_len`` (right pad) bounds."""
    return flash_fwd(q, k, v, causal=causal, scale=scale, start=start, kv_len=kv_len)[0]


def flash_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` that also returns the per-row logsumexp
    ``lse [B, S, H]`` f32 (the ring's merge input in the reference)."""
    return flash_fwd(q, k, v, causal=causal, scale=scale)
