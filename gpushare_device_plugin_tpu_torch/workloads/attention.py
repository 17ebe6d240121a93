"""Choice between the flash kernel and plain grouped attention.

Counterpart of ``gpushare_device_plugin_tpu/workloads/attention.py``
without the mesh: ``"auto"`` takes the CUDA kernel when the tensors are on
a card and the kernel's ``fits_kernel`` holds, ``"flash"`` forces the
kernel (a misfit then fails loudly in its wrapper), ``"plain"`` forces the
plain path. On CPU tensors the kernel's wrapper runs its plain version.
"""

from __future__ import annotations

import torch

from ..ops.flash_attention import fits_kernel, flash_attention
from ..parallel.ring import grouped_attention


def grouped_full_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
) -> torch.Tensor:
    """Plain attention with grouped KV heads: q [B, S, H, Dh]; k, v
    [B, S, Hkv, Dh]."""
    return grouped_attention(q, k, v, causal=causal)


def chunk_prefill_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, n_real,
    attention: str = "auto",
) -> torch.Tensor:
    """Causal self-attention over a RIGHT-padded prompt chunk (a fresh
    slot's first chunk). Pads sit at the end, so causality already hides
    them from every real query; the flash route passes ``kv_len`` so the
    kernel skips pad KV tiles and keeps pad rows' outputs finite."""
    B = q.shape[0]
    kv_len = torch.as_tensor(n_real, dtype=torch.int32, device=q.device)
    kv_len = kv_len.reshape(-1).expand(B).contiguous()
    if use_flash(attention, q):
        return flash_attention(q, k, v, causal=True, kv_len=kv_len)
    return grouped_attention(q, k, v, causal=True)


def use_flash(attention: str, q: torch.Tensor) -> bool:
    """Pick the attention implementation for ``q`` ([B, S, H, Dh])."""
    if attention == "flash":
        return True
    if attention == "plain":
        return False
    if attention != "auto":
        raise ValueError(f"unknown attention={attention!r}: expected auto|flash|plain")
    return q.device.type == "cuda" and fits_kernel(q.shape[1], q.shape[-1])


def flash_or_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, attention: str,
    causal: bool,
) -> torch.Tensor:
    """[B, S, H, Dh] attention through the flash kernel or the plain path."""
    if use_flash(attention, q):
        return flash_attention(q, k, v, causal=causal)
    return grouped_full_attention(q, k, v, causal=causal)
