"""Ulysses all-to-all sequence parallelism (the DeepSpeed-Ulysses scheme).

Counterpart of ``gpushare_device_plugin_tpu/parallel/ulysses.py``: the
other context-parallel scheme beside the ring (``ring.py``), with the
opposite trade. Two all-to-alls swap the tiling from sequence to heads
and back; between them every rank holds the whole sequence for H/n
heads, so the inner attention runs once, over the whole sequence, through
any implementation (the flash kernel included). The ring instead sends
K/V round n-1 hops and runs attention per hop. Both are exact.

The ``sp`` axis size must divide the head count. Grouped K/V with
``Hkv % n == 0`` scatter as they are (1/g of the bytes of full heads);
otherwise K/V heads are block-replicated only ``r = n/gcd(Hkv, n)``-fold
(a scatter over the gcd with a broadcast within each group of r ranks),
never repeated up to the full query head count.

As with the ring, each rank passes its local shard ``[B, S/n, heads, D]``
and gets its shard of the output back.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from .collectives import all_to_all
from .mesh import Mesh
from .ring import grouped_attention


def ulysses_attention_block(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    *,
    axis_name: str = "sp",
    causal: bool = True,
    scale: float | None = None,
    attn_fn: Callable | None = None,
) -> torch.Tensor:
    """One rank's Ulysses attention: q [B, S/n, H, D]; k, v [B, S/n, Hkv,
    D] (grouped allowed). Returns [B, S/n, H, D]. ``attn_fn(q, k, v,
    causal=..., scale=...)`` runs on the head-split, whole-sequence
    layout; plain grouped attention unless given."""
    n = mesh.shape[axis_name]
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"q heads {H} not a multiple of kv heads {Hkv}")
    if H % n:
        raise ValueError(f"Ulysses needs heads {H} divisible by sp={n}")
    g = H // Hkv
    # [B, S/n, h, D] -> [B, S, h/n, D]; q, k and v in one Function, whose
    # backward runs the three inverse all-to-alls in the same order.
    swap = dict(split_dim=2, concat_dim=1)
    if Hkv % n == 0:
        q, k, v = all_to_all(mesh, axis_name, q, k, v, **swap)
    else:
        # Too few KV heads to scatter one to one: scatter over d = gcd(Hkv,
        # n), each block of hb heads replicated r = n/d times (r <= g wire
        # bytes), then take each rank's own heads out of its received
        # block. H % Hkv == 0 and H % n == 0 make (n/d) divide g, so the
        # local group size g*d/n is a positive integer.
        d = math.gcd(Hkv, n)
        r = n // d
        hb = Hkv // d  # kv heads per block: the kv head slots of a rank
        g_local = (H // n) // hb  # local q heads each kv slot serves

        def blocks(x):
            return x.reshape(B, T, d, hb, D).repeat_interleave(r, dim=2).reshape(B, T, n * hb, D)

        q, k, v = all_to_all(mesh, axis_name, q, blocks(k), blocks(v), **swap)
        # Rank j's q heads [j*H/n, (j+1)*H/n) need global kv heads
        # (j*H/n + t*g_local)//g, found at offset (j//r)*hb of its block.
        j = mesh.axis_index(axis_name)
        t = torch.arange(hb, device=q.device)
        local_idx = (j * (H // n) + t * g_local) // g - (j // r) * hb
        k = k.index_select(2, local_idx)
        v = v.index_select(2, local_idx)
    fn = attn_fn if attn_fn is not None else grouped_attention
    out = fn(q, k, v, causal=causal, scale=scale)
    # [B, S, H/n, D] -> [B, S/n, H, D]
    return all_to_all(mesh, axis_name, out, split_dim=1, concat_dim=2)[0]


def ulysses_attention(
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
    attn_fn: Callable | None = None,
) -> torch.Tensor:
    """Sequence-parallel attention by all-to-all over ``axis_name``, a
    drop-in for :func:`.ring.ring_attention`: the same arguments and the
    same local-shard contract (``batch_axes`` and ``head_axes`` name how
    the caller tiled the global arrays; each tile attends on its own)."""
    del batch_axes, head_axes
    return ulysses_attention_block(q, k, v, mesh, axis_name=axis_name, causal=causal,
                                   scale=scale, attn_fn=attn_fn)
