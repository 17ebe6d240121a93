"""Autoregressive generation with a KV cache, in PyTorch.

Counterpart of ``gpushare_device_plugin_tpu/workloads/generate.py``:
contiguous caches (``init_cache``), slot-pool caches (``init_slot_cache``,
one length per row) and paged pools (``init_paged_cache``, each row read
and written through a page table), bf16/f32 or int8 KV; prefill
through the flash kernel (left-padded batches via ``start``, right-padded
slot chunks via ``kv_len``); cached decode over the plain grouped
attention with an explicit visibility mask, as in the reference. The
paged functions take per-row LoRA adapters gathered from a paged slab
(:func:`lora_bgmv_views`), as the multi-LoRA engine runs them. Greedy
speculative decoding: :func:`speculative_generate` for one sequence, and
:func:`paged_verify_block`, the paged engine's verify step.

Unlike the reference's pure functions, the cache's K/V buffers are
written IN PLACE (one copy of a slot pool on the card, where the JAX
engine donates the buffer to get the same); each function returns the
cache dict with its new ``len``. Callers hand the cache over and use the
returned one.

Token tensors are int64 (PyTorch's index type); values match the
reference's int32 tokens.

Tensor parallelism: the slot and paged functions take a ``mesh`` (a tp
gang's, ``parallel/podenv.py::gang_mesh``) with params cut by
``transformer.shard_params``. A rank's caches hold its ``Hkv/tp`` kv
heads (all of them when tp does not divide them,
:func:`kv_heads_local`), its layers run on its shards with the tp
all-reduces of ``transformer``, and the logits a function returns are
gathered whole over tp, so every rank samples the same token.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..device import resolve_device
from ..ops.flash_attention import flash_attention
from ..parallel.ring import grouped_attention
from .attention import chunk_prefill_attention, flash_or_plain, use_flash
from ..parallel.mesh import Mesh
from . import quant
from .lora import LoraConfig, lora_layer_spans
from .quant import dequantize_kv, embed_lookup, quantize_kv
from .transformer import (
    TransformerConfig,
    _attn_out,
    _bgmv_delta,
    _embed,
    _logits,
    _mlp_block,
    _project_qkv,
    _rank_kv,
    _rms_norm,
    gather_logits,
    layer_params,
)

# {"k","v"}: [L, B, Smax, Hkv, Dh]; "len": [] (batch caches) or [B] (slot
# pools). int8 caches add {"k_scale","v_scale"}: [L, B, Smax, Hkv] f32.
KVCache = dict[str, torch.Tensor]

# Physical page id 0 of a paged pool: idle rows' page tables point every
# entry here, so a pool-wide decode step's masked, never-read writes land
# somewhere harmless without a dynamic dispatch shape. The page allocator
# (``serving/pages.py``) never hands it out.
SCRATCH = 0


def kv_heads_local(cfg: TransformerConfig, mesh: Mesh | None = None) -> int:
    """The kv heads a rank's cache holds: ``Hkv/tp`` on a tp mesh whose tp
    divides them, else all ``Hkv`` (replicated, the reference's prune rule)."""
    tp = 1 if mesh is None else mesh.shape["tp"]
    return cfg.kv_heads // tp if cfg.kv_heads % tp == 0 else cfg.kv_heads


def _out_logits(params, x, cfg: TransformerConfig, mesh: Mesh | None):
    """Whole-vocabulary f32 logits of ``x`` (gathered over tp on a mesh)."""
    return gather_logits(_logits(params, x, cfg, mesh), cfg, mesh)


def init_cache(
    cfg: TransformerConfig, batch: int, max_len: int,
    kv_dtype: str | None = None, *, device: str | torch.device | None = None,
    mesh: Mesh | None = None,
) -> KVCache:
    """Fresh cache; ``kv_dtype="int8"`` stores K/V as symmetric int8 with
    per-(token, head) scales. On a tp ``mesh``, the rank's kv heads
    (:func:`kv_heads_local`)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, kv_heads_local(cfg, mesh), cfg.head_dim)
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"unknown kv_dtype={kv_dtype!r}: expected None|'int8'")
    length = torch.zeros((), dtype=torch.int32, device=dev)
    if kv_dtype == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.ones(shape[:-1], dtype=torch.float32, device=dev),
            "v_scale": torch.ones(shape[:-1], dtype=torch.float32, device=dev),
            "len": length,
        }
    return {
        "k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
        "len": length,
    }


def init_slot_cache(
    cfg: TransformerConfig, slots: int, max_len: int,
    kv_dtype: str | None = None, *, device: str | torch.device | None = None,
    mesh: Mesh | None = None,
) -> KVCache:
    """Slot-pool cache for the continuous-batching engine: the buffers of
    :func:`init_cache` with ``len`` a ``[slots]`` vector, every row an
    independent sequence."""
    cache = init_cache(cfg, slots, max_len, kv_dtype=kv_dtype, device=device, mesh=mesh)
    cache["len"] = torch.zeros((slots,), dtype=torch.int32, device=cache["k"].device)
    return cache


def init_paged_cache(
    cfg: TransformerConfig, slots: int, pages: int, page_size: int,
    kv_dtype: str | None = None, *, device: str | torch.device | None = None,
    mesh: Mesh | None = None,
) -> KVCache:
    """Paged slot-pool cache for the paged serving engine: K/V live in
    ``pages`` fixed-size pages, physical ``[L, pages, page_size, Hkv, Dh]``
    (int8 scales ``[L, pages, page_size, Hkv]``), and each row reads and
    writes through a page table. ``pages`` counts physical pages including
    the scratch page (:data:`SCRATCH`, id 0). ``len`` is the
    per-row ``[slots]`` vector of the slot pool."""
    cache = init_cache(cfg, pages, page_size, kv_dtype=kv_dtype, device=device, mesh=mesh)
    cache["len"] = torch.zeros((slots,), dtype=torch.int32, device=cache["k"].device)
    return cache


def _cache_is_q8(cache: KVCache) -> bool:
    return "k_scale" in cache


def _row_update(cache_rows: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Write ``new[b]`` ([B, T, ...]) into ``cache_rows[b]`` ([B, Smax, ...])
    at row offset ``pos[b]``, in place. The start clamps to
    ``[0, Smax - T]`` as the reference's ``dynamic_update_slice`` does:
    the engine writes every row each decode step, and a retired row can
    sit at ``len == Smax``; its write then lands on the last position."""
    rows = torch.arange(new.shape[0], device=new.device)[:, None]
    cache_rows[rows, _write_index(pos, new.shape[1], cache_rows.shape[1])] = new.to(
        cache_rows.dtype)
    return cache_rows


def _write_index(pos: torch.Tensor, T: int, Smax: int) -> torch.Tensor:
    """[B, T] positions :func:`_row_update` writes a row's T entries to:
    ``pos[b]`` onwards, the start clamped to ``[0, Smax - T]``."""
    return pos.long().clamp(0, Smax - T)[:, None] + torch.arange(T, device=pos.device)[None, :]


def _write_prefix(cache: KVCache, layer: int, rows, k, v) -> None:
    """Write a layer's prompt K/V ([B, T, Hkv, Dh]) at positions 0..T-1 of
    cache rows ``rows`` (a slice or index), quantizing for int8 caches."""
    T = k.shape[1]
    if _cache_is_q8(cache):
        kq8, kscale = quantize_kv(k)
        vq8, vscale = quantize_kv(v)
        cache["k"][layer, rows, :T] = kq8
        cache["v"][layer, rows, :T] = vq8
        cache["k_scale"][layer, rows, :T] = kscale
        cache["v_scale"][layer, rows, :T] = vscale
    else:
        cache["k"][layer, rows, :T] = k.to(cache["k"].dtype)
        cache["v"][layer, rows, :T] = v.to(cache["v"].dtype)


def _padded_prefill_attention(q, k, v, pad, attention: str = "auto"):
    """Prompt self-attention with per-row LEFT padding (``pad`` [B] int32
    leading pad counts): the flash kernel's ``start``, or the plain path
    with an explicit key mask."""
    if use_flash(attention, q):
        return flash_attention(q, k, v, causal=True, start=pad)
    T = q.shape[1]
    live = torch.arange(T, device=q.device)[None, :] >= pad[:, None]  # [B, Tk]
    return grouped_attention(
        q, k, v, causal=True, mask=live[:, None, :].expand(q.shape[0], T, T)
    )


def prefill(
    params: Any,
    tokens: torch.Tensor,
    cache: KVCache,
    cfg: TransformerConfig,
    pad: torch.Tensor | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """tokens [B, Tp] -> (last-position logits [B, vocab] f32, cache with
    ``len = Tp``). ``pad`` ([B] int32) switches to left-padded mode: RoPE
    positions are offset per row and pad keys are masked."""
    dt = cfg.compute_dtype
    B, Tp = tokens.shape
    positions = torch.arange(Tp, device=tokens.device)
    if pad is not None:
        positions = (positions[None, :] - pad[:, None]).clamp(min=0)
    x = embed_lookup(params["embed"], tokens, dt)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        q, k, v = _project_qkv(_rms_norm(x, lp["ln1"]), lp, cfg, positions)
        if pad is None:
            attn = flash_or_plain(q, k, v, attention=cfg.attention, causal=True)
        else:
            attn = _padded_prefill_attention(q, k, v, pad, cfg.attention)
        x = _mlp_block(x + _attn_out(attn, lp, cfg), lp, cfg)
        _write_prefix(cache, i, slice(None), k, v)
    cache = {**cache, "len": torch.tensor(Tp, dtype=torch.int32, device=tokens.device)}
    return _logits(params, x[:, -1:], cfg)[:, 0], cache


def prefill_slot(
    params: Any,
    tokens: torch.Tensor,
    cache: KVCache,
    cfg: TransformerConfig,
    *,
    slot: int,
    n_real: int,
    mesh: Mesh | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """Pack one request's opening prompt chunk (``tokens`` [C], right-
    padded, ``n_real`` real) into row ``slot``, restarting the row at
    position 0: ``len[slot] = n_real``. Returns the last REAL position's
    logits [1, vocab] f32 and the cache. ``mesh``: a tp rank's shards
    (module docstring)."""
    slot, n_real = int(slot), int(n_real)
    C = tokens.shape[0]
    positions = torch.arange(C, device=tokens.device)[None, :]
    kv_len = torch.tensor([n_real], dtype=torch.int32, device=tokens.device)
    x = _embed(params["embed"], tokens[None, :], cfg, mesh)  # [1, C, d]
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        q, k, v = _project_qkv(_rms_norm(x, lp["ln1"]), lp, cfg, positions, mesh=mesh)
        attn = chunk_prefill_attention(q, *_rank_kv(k, v, cfg, mesh), n_real=kv_len,
                                       attention=cfg.attention)
        x = _mlp_block(x + _attn_out(attn, lp, cfg, mesh), lp, cfg, mesh=mesh)
        _write_prefix(cache, i, slice(slot, slot + 1), k, v)
    lens = cache["len"].clone()
    lens[slot] = n_real
    logits = _out_logits(params, x[:, n_real - 1 : n_real], cfg, mesh)
    return logits[:, 0], {**cache, "len": lens}


def extend_slot(
    params: Any,
    tokens: torch.Tensor,
    cache: KVCache,
    cfg: TransformerConfig,
    *,
    slot: int,
    n_real: int,
    mesh: Mesh | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """Continue row ``slot`` with its next prompt chunk (``tokens`` [C],
    ``n_real`` real): the row runs through :func:`decode_block` as a
    [1, C] block against its own prefix, and ``len[slot]`` advances by
    ``n_real``. Other rows are untouched. Returns position ``n_real - 1``'s
    logits [1, vocab] f32 and the cache."""
    slot, n_real = int(slot), int(n_real)
    row = {key: val[:, slot : slot + 1] for key, val in cache.items() if key != "len"}
    pos = cache["len"][slot : slot + 1]
    row["len"] = pos
    logits, _ = decode_block(params, tokens[None, :], row, cfg, mesh=mesh)
    lens = cache["len"].clone()
    lens[slot : slot + 1] = pos + n_real
    return logits[:, n_real - 1], {**cache, "len": lens}


def decode_block(
    params: Any,
    tokens: torch.Tensor,
    cache: KVCache,
    cfg: TransformerConfig,
    start: torch.Tensor | None = None,
    mesh: Mesh | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """Cached decode of a T-token block: tokens [B, T] -> (logits
    [B, T, vocab] f32, cache advanced by T; ``mesh``: a tp rank's). Block position t attends to
    the cache prefix plus block positions <= t. With a slot-pool cache
    (vector ``len``) every row writes, positions and masks from its own
    length. ``start`` ([B] leading pad counts) offsets RoPE positions and
    masks pad slots of a left-padded batch cache."""
    B, T = tokens.shape
    dev = tokens.device
    pos0 = cache["len"]
    per_slot = pos0.dim() == 1
    if per_slot and start is not None:
        raise ValueError(
            "start is the left-padded batch offset; slot-pool caches "
            "(vector len) already carry per-row offsets"
        )
    steps = torch.arange(T, device=dev)
    if per_slot:
        positions = pos0[:, None] + steps[None, :]  # [B, T]
    else:
        positions = pos0 + steps[None, :]  # [1, T]
        if start is not None:
            positions = positions - start[:, None]
    positions = positions.expand(B, T)
    x = _embed(params["embed"], tokens, cfg, mesh)  # [B, T, d]
    Smax = cache["k"].shape[2]
    idx = torch.arange(Smax, device=dev)
    # [B|1, T, Smax] visibility: cache prefix + block-causal, minus pads.
    if per_slot:
        vis = idx[None, None, :] < (pos0[:, None] + steps[None, :] + 1)[:, :, None]
    else:
        vis = idx[None, None, :] < (pos0 + steps + 1)[None, :, None]
        if start is not None:
            vis = vis & (idx[None, None, :] >= start[:, None, None])
    vis = vis.expand(B, T, Smax)
    wpos = pos0 if per_slot else pos0.expand(B)
    for i in range(cfg.n_layers):
        x, _ = _cached_layer(x, layer_params(params["layers"], i), cfg, positions, cache, i,
                             wpos, vis, mesh=mesh)
    return _out_logits(params, x, cfg, mesh), {**cache, "len": pos0 + T}


def _row_blocks(n_rows: int, row_elems: int) -> list[tuple[int, int]]:
    """``[lo, hi)`` blocks of cache rows of ``row_elems`` K elements each,
    a block holding at most ``quant.DEQUANT_BLOCK`` of them (one row if a
    row is larger)."""
    step = max(1, quant.DEQUANT_BLOCK // max(row_elems, 1))
    return [(lo, min(lo + step, n_rows)) for lo in range(0, n_rows, step)]


def _cached_layer(x, lp, cfg: TransformerConfig, positions, cache: KVCache, layer: int,
                  wpos, vis, tables: torch.Tensor | None = None, lora_l=None,
                  lora_scale: float = 1.0, mesh: Mesh | None = None,
                  live_rows: int | None = None):
    """One layer of a cached block over layer ``layer`` of ``cache``: the
    rows themselves (views, written in place), or with ``tables`` [B, MP]
    each row's pages gathered into a copy (:func:`_gather_paged`). The
    block's K/V entries (:func:`_kv_entries`) are written into the rows
    at ``wpos``, and the queries attend over them under the visibility
    mask ``vis`` [B, T, Smax]. Rows go a block at a time
    (:func:`_row_blocks`), so gathered pages, an int8 cache's dequantized
    K and V, and the attention's f32 up-casts exist for one block of rows
    only; every row's arithmetic is the whole batch's. With ``tables``,
    a block wholly at or past ``live_rows`` (idle rows, whose tables are
    all SCRATCH and whose outputs nobody reads) is not attended: its
    attention output is zeros. Returns the layer's output and the entries
    it wrote, [B, T, ...] each. ``lora_l``: this layer's per-row adapter
    views, applied at every projection."""
    q, k, v = _project_qkv(_rms_norm(x, lp["ln1"]), lp, cfg, positions,
                           lora=lora_l, lora_scale=lora_scale, mesh=mesh)
    B, T, Smax = k.shape[0], k.shape[1], vis.shape[-1]
    new = _kv_entries(cache, k, v)
    idx = _write_index(wpos, T, Smax)
    row = torch.arange(B, device=k.device)[:, None]
    parts = []
    for lo, hi in _row_blocks(B, Smax * k.shape[2] * k.shape[3]):
        if tables is not None and live_rows is not None and lo >= live_rows:
            parts.append(q.new_zeros(q[lo:hi].shape))
            continue
        if tables is None:
            r = {key: val[layer, lo:hi] for key, val in cache.items() if key != "len"}
        else:
            r = _gather_paged(cache, layer, tables[lo:hi])
        for key, val in new.items():
            r[key][row[: hi - lo], idx[lo:hi]] = val[lo:hi].to(r[key].dtype)
        if _cache_is_q8(r):
            k_mat = dequantize_kv(r["k"], r["k_scale"], q.dtype)
            v_mat = dequantize_kv(r["v"], r["v_scale"], q.dtype)
        else:
            k_mat, v_mat = r["k"], r["v"]
        parts.append(grouped_attention(q[lo:hi], *_rank_kv(k_mat, v_mat, cfg, mesh),
                                       causal=False, mask=vis[lo:hi]))
        del r, k_mat, v_mat
    attn = parts[0] if len(parts) == 1 else torch.cat(parts)
    x = x + _wo(attn, lp, cfg, lora_l, lora_scale, mesh)
    return _mlp_block(x, lp, cfg, lora=lora_l, lora_scale=lora_scale, mesh=mesh), new


def decode_step(
    params: Any,
    token: torch.Tensor,
    cache: KVCache,
    cfg: TransformerConfig,
    start: torch.Tensor | None = None,
    mesh: Mesh | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """One cached decode step: token [B] -> (logits [B, vocab], cache+1)."""
    logits, cache = decode_block(params, token[:, None], cache, cfg, start=start, mesh=mesh)
    return logits[:, 0], cache


# --- per-row LoRA adapters (the multi-LoRA engine) ----------------------------


def lora_layer_reads(cfg: TransformerConfig, lcfg: LoraConfig, page_floats: int,
                     mesh: Mesh | None = None, device=None) -> tuple:
    """Per layer ``i``: ``(cols, where)``. ``cols`` (a long tensor on
    ``device``) are the adapter page columns whose slab rows hold layer
    ``i``'s part of every target, in the order read; ``where`` is
    ``{target: ((start, (fi, r)), (start, (r, fo)))}``, each start an
    offset into those rows read back to back. An engine builds them once
    for its slab's ``page_floats``."""
    out = []
    for i in range(cfg.n_layers):
        cols: list[int] = []
        where = {}
        for name, parts in lora_layer_spans(cfg, lcfg, i, mesh).items():
            pair = []
            for off, shape in parts:
                first, last = off // page_floats, (off + shape[0] * shape[1] - 1) // page_floats
                pair.append((len(cols) * page_floats + off - first * page_floats, shape))
                cols.extend(range(first, last + 1))
            where[name] = tuple(pair)
        out.append((torch.tensor(cols, dtype=torch.long, device=device), where))
    return tuple(out)


class LoraRows(NamedTuple):
    """A dispatch's per-row adapters: the paged ``slab`` ``[pages,
    page_floats]`` f32 holding every resident adapter's flat vector
    (``lora.flatten_lora``) striped across pages of the KV pool's id
    space (row :data:`SCRATCH` stays zero), the rows' adapter page ids
    ``tables`` ``[B, AP]`` (long; an all-SCRATCH table reads zeros, the
    null adapter, whose delta is exactly zero) and the slab's
    :func:`lora_layer_reads`. Which adapter a row runs is table data,
    never a shape. On a tp ``mesh`` the slab holds the rank's views
    (``lora.lora_tp_shard``): its B slices of column-parallel targets and
    A slices of row-parallel ones."""

    slab: torch.Tensor
    tables: torch.Tensor
    reads: tuple


def lora_bgmv_views(
    slab: torch.Tensor, tables: torch.Tensor, cfg: TransformerConfig, lcfg: LoraConfig,
    mesh: Mesh | None = None,
) -> LoraRows:
    """The programs' ``lora`` argument for ``tables`` [B, AP] over
    ``slab`` (:class:`LoraRows`). Where the reference gathers every row's
    whole adapter for a dispatch, each layer is read when a program
    reaches it (:func:`_layer_lora`): at Llama-3-8B width, rank 8 on every
    target, a row's whole adapter is 75.5 MB at 32 layers."""
    return LoraRows(slab, tables.long(),
                    lora_layer_reads(cfg, lcfg, slab.shape[1], mesh, slab.device))


def _layer_lora(lora: LoraRows | None, i: int):
    """Layer ``i``'s ``{target: (a [B, fi, r], b [B, r, fo])}``: the slab
    rows that hold the layer's part of each row's adapter, two
    ``index_select`` (or None without adapters)."""
    if lora is None:
        return None
    cols, where = lora.reads[i]
    B = lora.tables.shape[0]
    rows = lora.slab.index_select(0, lora.tables.index_select(1, cols).reshape(-1))
    rows = rows.reshape(B, -1)
    return {name: tuple(rows[:, s:s + shape[0] * shape[1]].reshape(B, *shape)
                        for s, shape in pair) for name, pair in where.items()}


def _lora_wo_delta(attn, lora_l, lora_scale: float, dt):
    """The wo projection's delta: attn [B, T, H, Dh] -> [B, T, d], or None
    without a wo target."""
    if lora_l is None or "wo" not in lora_l:
        return None
    flat = attn.reshape(attn.shape[0], attn.shape[1], -1)  # [B, T, H*Dh]
    return _bgmv_delta(flat, *lora_l["wo"], lora_scale, dt)


def _wo(attn, lp, cfg: TransformerConfig, lora_l, lora_scale: float,
        mesh: Mesh | None = None):
    """The wo projection plus its adapter delta, before the residual (on
    a tp mesh both are the rank's partial sums, added before the sum)."""
    delta = _lora_wo_delta(attn, lora_l, lora_scale, cfg.compute_dtype)
    return _attn_out(attn, lp, cfg, mesh, delta)


# --- paged caches -----------------------------------------------------------
#
# The reference gathers every row's whole logical view [L, B, MP*ps, ...]
# before the layer loop and scatters the new positions back after it. Here
# one layer's view [B, MP*ps, ...] is gathered inside the loop and that
# layer's new positions are scattered back before the next layer: the same
# arithmetic, without a view of every layer at once (at Llama-3-8B width,
# 256 MiB per 2048-position row). The gathered view is a copy, so every
# write reaches the pool only through _paged_write.


def _gather_paged(cache: KVCache, layer: int, page_tables: torch.Tensor) -> KVCache:
    """Layer ``layer``'s logical rows through ``page_tables`` [B, MP]
    (physical page ids): ``{k, v, (scales)}`` of shape [B, MP*ps, ...],
    the contiguous slot-pool layout of that layer."""
    B, MP = page_tables.shape
    ids = page_tables.reshape(-1).long()
    out: KVCache = {}
    for key, val in cache.items():
        if key == "len":
            continue
        g = val[layer].index_select(0, ids)  # [B*MP, ps, ...]
        out[key] = g.reshape((B, MP * g.shape[1]) + g.shape[2:])
    return out


def _paged_write(
    cache: KVCache, layer: int, new: KVCache, pids: torch.Tensor, offs: torch.Tensor,
) -> None:
    """Write per-position entries (``new[key]`` [N, ...]) into layer
    ``layer``'s pages at ``(pids[n], offs[n])``, in place. Duplicate
    targets (idle rows parked on the scratch page) leave that page in an
    undefined state; nothing reads it."""
    ps = cache["k"].shape[2]
    flat = (pids * ps + offs).long()
    for key, val in new.items():
        buf = cache[key][layer]
        buf.view((-1,) + buf.shape[2:]).index_copy_(0, flat, val.to(buf.dtype))


def _page_slots(
    page_tables: torch.Tensor, logical: torch.Tensor, ps: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(page id, offset) of each logical position ``logical`` [B, T] through
    ``page_tables`` [B, MP]. A position past the table maps to the scratch
    page (the reference's gather reads a fill value there, and its scatter
    drops the write); an index is never out of range."""
    MP = page_tables.shape[1]
    pidx = logical // ps
    pids = torch.gather(page_tables.long(), 1, pidx.clamp(max=MP - 1))
    pids = torch.where(pidx < MP, pids, torch.full_like(pids, SCRATCH))
    return pids, logical % ps


def _kv_entries(cache: KVCache, k: torch.Tensor, v: torch.Tensor) -> KVCache:
    """The cache entries of K/V [..., Hkv, Dh]: the values, or for an int8
    cache the int8 values and their per-(token, head) scales."""
    if _cache_is_q8(cache):
        kq8, kscale = quantize_kv(k)
        vq8, vscale = quantize_kv(v)
        return {"k": kq8, "v": vq8, "k_scale": kscale, "v_scale": vscale}
    return {"k": k, "v": v}


def _paged_block(
    params: Any,
    tokens: torch.Tensor,
    cache: KVCache,
    cfg: TransformerConfig,
    page_tables: torch.Tensor,
    pos0: torch.Tensor,
    lora=None,
    lora_scale: float = 1.0,
    mesh: Mesh | None = None,
    live_rows: int | None = None,
) -> torch.Tensor:
    """:func:`decode_block` of a T-token block (``tokens`` [B, T]) for rows
    at logical lengths ``pos0`` [B], each read and written through its page
    table (``page_tables`` [B, MP]). Each layer runs on its gathered view,
    and the block's T entries per row go back into the pages. ``lora``:
    :func:`lora_bgmv_views` for the B rows. ``live_rows``: see
    :func:`paged_decode_step`. Returns the final hidden
    states [B, T, d], whose logits (:func:`_out_logits`) each caller takes
    at the positions it reads; the pool is updated in place."""
    B, T = tokens.shape
    dev = tokens.device
    ps = cache["k"].shape[2]
    Smax = page_tables.shape[1] * ps
    tables = page_tables.long()
    steps = torch.arange(T, device=dev)
    logical = pos0.long()[:, None] + steps[None, :]  # [B, T]
    idx = torch.arange(Smax, device=dev)
    vis = idx[None, None, :] < (logical + 1)[:, :, None]  # [B, T, Smax]
    pids, offs = _page_slots(tables, logical, ps)
    pids, offs = pids.reshape(-1), offs.reshape(-1)
    # The view's entries at the block's positions, as the view's write left
    # them: a row's T entries went in at its position clamped to [0, Smax -
    # T] (_write_index), and a position past the view reads the view's last
    # one (bound for SCRATCH), so position t reads entry back[b, t] of T.
    rows = torch.arange(B, device=dev)[:, None]
    back = logical.clamp(max=Smax - 1) - _write_index(pos0, T, Smax)[:, :1]
    x = _embed(params["embed"], tokens, cfg, mesh)
    for i in range(cfg.n_layers):
        x, entries = _cached_layer(x, layer_params(params["layers"], i), cfg, logical, cache, i,
                                   pos0, vis, tables, _layer_lora(lora, i), lora_scale, mesh,
                                   live_rows=live_rows)
        new = {key: val[rows, back].reshape((B * T,) + val.shape[2:])
               for key, val in entries.items()}
        _paged_write(cache, i, new, pids, offs)
    return x


def paged_prefill_slot(
    params: Any,
    tokens: torch.Tensor,
    cache: KVCache,
    cfg: TransformerConfig,
    *,
    slot: int,
    page_table: torch.Tensor,
    n_real: int,
    lora=None,
    lora_scale: float = 1.0,
    mesh: Mesh | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """:func:`prefill_slot` through a page table: one request's opening
    prompt chunk (``tokens`` [C] right-padded, ``n_real`` real) goes into
    the pages of row ``slot`` (``page_table`` [MP] physical ids),
    restarting the row at position 0. The chunk's attention is
    :func:`prefill_slot`'s (the flash kernel on the card); positions
    ``0..C-1`` scatter through the table, so the row pins only the pages
    its tokens occupy. ``lora``: the row's views (:func:`lora_bgmv_views`
    of a [1, AP] table), applied at every projection. Returns the last
    real position's logits [1, vocab] f32 and the cache with
    ``len[slot] = n_real``."""
    slot, n_real = int(slot), int(n_real)
    C = tokens.shape[0]
    ps = cache["k"].shape[2]
    logical = torch.arange(C, device=tokens.device)
    pids, offs = _page_slots(page_table[None, :], logical[None, :], ps)
    pids, offs = pids[0], offs[0]
    kv_len = torch.tensor([n_real], dtype=torch.int32, device=tokens.device)
    x = _embed(params["embed"], tokens[None, :], cfg, mesh)  # [1, C, d]
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        lora_l = _layer_lora(lora, i)
        q, k, v = _project_qkv(_rms_norm(x, lp["ln1"]), lp, cfg, logical[None, :],
                               lora=lora_l, lora_scale=lora_scale, mesh=mesh)
        attn = chunk_prefill_attention(q, *_rank_kv(k, v, cfg, mesh), n_real=kv_len,
                                       attention=cfg.attention)
        x = x + _wo(attn, lp, cfg, lora_l, lora_scale, mesh)
        x = _mlp_block(x, lp, cfg, lora=lora_l, lora_scale=lora_scale, mesh=mesh)
        _paged_write(cache, i, _kv_entries(cache, k[0], v[0]), pids, offs)
    lens = cache["len"].clone()
    lens[slot] = n_real
    logits = _out_logits(params, x[:, n_real - 1 : n_real], cfg, mesh)
    return logits[:, 0], {**cache, "len": lens}


def paged_extend_slot(
    params: Any,
    tokens: torch.Tensor,
    cache: KVCache,
    cfg: TransformerConfig,
    *,
    slot: int,
    page_table: torch.Tensor,
    pos: int,
    n_real: int,
    lora=None,
    lora_scale: float = 1.0,
    mesh: Mesh | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """:func:`extend_slot` through a page table: row ``slot`` continues
    with its next prompt chunk (``tokens`` [C], ``n_real`` real) against
    the prefix its pages hold. ``pos`` is the explicit continuation offset
    (the engine's host-side prefix length), which is what lets a radix
    prefix hit start a fresh occupant mid-row. The chunk attends to the
    prefix and to itself (plain grouped attention, as in the reference);
    only its C new positions are written, so shared prefix pages are read
    and never written. ``lora`` as in :func:`paged_prefill_slot`. Returns
    position ``n_real - 1``'s logits [1, vocab] f32 and the cache with
    ``len[slot] = pos + n_real``."""
    slot, pos, n_real = int(slot), int(pos), int(n_real)
    pos0 = torch.tensor([pos], dtype=torch.int32, device=tokens.device)
    x = _paged_block(params, tokens[None, :], cache, cfg, page_table[None, :], pos0,
                     lora, lora_scale, mesh)
    lens = cache["len"].clone()
    lens[slot] = pos + n_real
    return _out_logits(params, x[:, n_real - 1 : n_real], cfg, mesh)[:, 0], {**cache, "len": lens}


def paged_decode_step(
    params: Any,
    token: torch.Tensor,
    cache: KVCache,
    cfg: TransformerConfig,
    *,
    page_tables: torch.Tensor,
    lora=None,
    lora_scale: float = 1.0,
    mesh: Mesh | None = None,
    live_rows: int | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """Pool-wide decode step through per-row page tables (``page_tables``
    [B, MP]): each row's one new entry lands at ``(page_tables[b,
    len[b] // ps], len[b] % ps)``. Rows whose table points at the scratch
    page (free, or mid-prefill) write there, never read. ``len`` advances
    by one for every row; the engine freezes idle rows' lengths. ``lora``:
    :func:`lora_bgmv_views` of the [B, AP] adapter tables. ``live_rows``
    (the engine's host-side bound): every row at or past it is idle, with
    an all-SCRATCH table, and the row blocks of cache reads that hold only
    such rows are skipped, so a large pool with few rows decoding attends
    those few (its live rows' logits are unchanged; an idle row's logits
    are not meaningful). Returns logits [B, vocab] and the cache."""
    pos0 = cache["len"]
    x = _paged_block(params, token[:, None], cache, cfg, page_tables, pos0,
                     lora, lora_scale, mesh, live_rows)
    return _out_logits(params, x, cfg, mesh)[:, 0], {**cache, "len": pos0 + 1}


def paged_verify_block(
    params: Any,
    block: torch.Tensor,
    cache: KVCache,
    cfg: TransformerConfig,
    *,
    page_tables: torch.Tensor,
    lora=None,
    lora_scale: float = 1.0,
    mesh: Mesh | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """Pool-wide T-token verify step through per-row page tables, the
    target's half of the paged engine's speculative decode. ``block``
    [B, T] is each row's last verified token followed by its draft
    proposal. Every position is scored in one forward, whose logits at
    position ``t`` are those of ``t`` sequential :func:`paged_decode_step`
    calls, and all T new entries go back through the tables. ``len``
    advances by T; the engine rewinds it past rejected positions, whose
    stale entries sit beyond every later read's visibility mask until
    the row overwrites them. ``lora`` as in :func:`paged_decode_step`.
    Returns logits [B, T, vocab] f32 and the cache."""
    pos0 = cache["len"]
    x = _paged_block(params, block, cache, cfg, page_tables, pos0, lora, lora_scale, mesh)
    return _out_logits(params, x, cfg, mesh), {**cache, "len": pos0 + block.shape[1]}


def _mask_after_eos(gen: torch.Tensor, eos_id: int) -> torch.Tensor:
    """Overwrite positions strictly after each row's first EOS with EOS."""
    is_eos = (gen == eos_id).int()
    seen = torch.cumsum(is_eos, dim=1)
    return torch.where(seen - is_eos > 0, torch.full_like(gen, eos_id), gen)


def sample_logits(
    logits: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    temperature: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
) -> torch.Tensor:
    """Next tokens from [B, vocab] logits: greedy argmax at
    ``temperature=0`` (first index on ties, as in JAX), else softmax
    sampling from ``generator``, optionally cut to the ``top_k`` highest
    logits and/or the nucleus of mass ``top_p``. The random draws differ
    from JAX's; the filters are the reference's."""
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if top_k is not None:
        kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        floor = torch.where(keep, sorted_logits, -neg_inf).amin(-1, keepdim=True)
        logits = torch.where(logits < floor, neg_inf, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(
    params: Any,
    prompt,
    cfg: TransformerConfig,
    *,
    max_new: int,
    temperature: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
    generator: torch.Generator | None = None,
    eos_id: int | None = None,
    prompt_lens=None,
    kv_dtype: str | None = None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Generate ``max_new`` tokens after ``prompt`` ([B, Tp]).

    Returns [B, Tp + max_new]; with ``prompt_lens`` (right-padded
    variable-length batch, re-packed left-padded inside) only the
    generated [B, max_new]. ``max_new == 0`` returns the prompt, or an
    empty [B, 0] block with ``prompt_lens``, as the reference's
    zero-length scan does. ``eos_id`` overwrites positions after the
    first EOS with EOS. The reference's scan also runs a decode step
    after the last emitted token whose result it drops; this loop skips
    that step, which leaves the tokens unchanged.
    """
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs a generator")
    if max_new < 0:
        raise ValueError(f"max_new must be >= 0, got {max_new}")
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=dev).long()
    B, Tp = prompt.shape
    if max_new == 0:
        return prompt[:, :0] if prompt_lens is not None else prompt
    cache = init_cache(cfg, B, Tp + max_new, kv_dtype=kv_dtype, device=dev)
    pad = None
    if prompt_lens is not None:
        lens = torch.as_tensor(prompt_lens, device=dev)
        pad = (Tp - lens).to(torch.int32)
        idx = (torch.arange(Tp, device=dev)[None, :] - pad[:, None]) % Tp
        logits, cache = prefill(params, torch.gather(prompt, 1, idx.long()), cache, cfg, pad=pad)
    else:
        logits, cache = prefill(params, prompt, cache, cfg)

    def pick(lg):
        return sample_logits(
            lg, generator, temperature=temperature, top_k=top_k, top_p=top_p
        )

    token = pick(logits)
    out = [token]
    for _ in range(max_new - 1):
        logits, cache = decode_step(params, token, cache, cfg, start=pad)
        token = pick(logits)
        out.append(token)
    gen = torch.stack(out, dim=1)
    if eos_id is not None:
        gen = _mask_after_eos(gen, eos_id)
    if prompt_lens is not None:
        return gen
    return torch.cat([prompt, gen], dim=1)


def speculative_generate(
    target_params: Any,
    draft_params: Any,
    prompt,
    target_cfg: TransformerConfig,
    draft_cfg: TransformerConfig,
    *,
    max_new: int,
    k: int = 4,
    eos_id: int | None = None,
    return_stats: bool = False,
    device: str | torch.device | None = None,
):
    """Greedy speculative decoding of one sequence (``prompt`` [1, Tp]):
    each round the draft proposes ``k`` tokens, the target scores them in
    one :func:`decode_block` forward, and the longest prefix it agrees
    with plus its own next token are emitted. The tokens are the target's
    greedy continuation, those of :func:`generate`; the draft changes only
    how many target forwards it takes. Both caches rewind ``len`` past
    the rejected entries each round. Both configs must share a vocab.

    Returns [1, Tp + max_new]; with ``return_stats`` ``(tokens,
    {"rounds", "drafted", "accepted"})``. A perfect draft finishes in
    ceil((max_new - 1) / (k + 1)) rounds: an unwritten draft entry after
    a fully accepted round would show as extra rounds, not in the tokens.
    """
    if target_cfg.vocab != draft_cfg.vocab:
        raise ValueError(
            f"target/draft vocab mismatch: {target_cfg.vocab} vs {draft_cfg.vocab}"
        )
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=dev).long()
    B, Tp = prompt.shape
    if B != 1:
        raise ValueError(f"speculative_generate is single-sequence; got B={B}")
    if max_new < 0:
        raise ValueError(f"max_new must be >= 0, got {max_new}")

    width = max_new + k + 1  # the last round may overhang by <= k
    t_cache = init_cache(target_cfg, B, Tp + width, device=dev)
    d_cache = init_cache(draft_cfg, B, Tp + width, device=dev)
    t_logits, t_cache = prefill(target_params, prompt, t_cache, target_cfg)
    _, d_cache = prefill(draft_params, prompt, d_cache, draft_cfg)
    last = torch.argmax(t_logits, -1)  # [1]
    out = [int(last)]
    stats = {"rounds": 0, "drafted": 0, "accepted": 0}
    while len(out) < max_new:
        # k+1 draft steps for k proposals: the last step writes the last
        # proposal's own KV, which a fully accepted round leaves valid (an
        # unwritten entry there would poison every later proposal).
        tok, props = last, []
        for _ in range(k + 1):
            logits, d_cache = decode_step(draft_params, tok, d_cache, draft_cfg)
            tok = torch.argmax(logits, -1)
            props.append(tok)
        drafts = torch.stack(props[:k], dim=1)  # [1, k]
        block = torch.cat([last[:, None], drafts], dim=1)  # [1, k+1]
        logits, t_cache = decode_block(target_params, block, t_cache, target_cfg)
        greedy = torch.argmax(logits, -1)  # [1, k+1]
        # the longest agreeing prefix a, then drafts[:a] + greedy[a]
        match = (drafts == greedy[:, :k]).int()
        a = int(torch.cumprod(match, dim=1).sum())
        out += drafts[0, :a].tolist() + [int(greedy[0, a])]
        # the valid prefix ends before the new last token
        valid = torch.tensor(Tp + len(out) - 1, dtype=torch.int32, device=dev)
        t_cache = {**t_cache, "len": valid}
        d_cache = {**d_cache, "len": valid}
        last = greedy[:, a]
        stats["rounds"] += 1
        stats["drafted"] += k
        stats["accepted"] += a
    gen = torch.tensor([out[:max_new]], dtype=torch.long, device=dev)
    if eos_id is not None:
        gen = _mask_after_eos(gen, eos_id)
    tokens = torch.cat([prompt, gen], dim=1)
    return (tokens, stats) if return_stats else tokens


def make_speculative_generate(
    target_cfg: TransformerConfig,
    draft_cfg: TransformerConfig,
    *,
    max_new: int,
    k: int = 4,
    eos_id: int | None = None,
    return_stats: bool = False,
    device: str | torch.device | None = None,
):
    """Closure (target_params, draft_params, prompt) -> [1, Tp + max_new]
    (or (tokens, stats) with ``return_stats``). The reference jits it;
    nothing compiles here."""

    def run(target_params, draft_params, prompt):
        return speculative_generate(
            target_params, draft_params, prompt, target_cfg, draft_cfg, max_new=max_new, k=k,
            eos_id=eos_id, return_stats=return_stats, device=device,
        )

    return run


def make_generate(
    cfg: TransformerConfig,
    *,
    max_new: int,
    temperature: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
    eos_id: int | None = None,
    padded: bool = False,
    kv_dtype: str | None = None,
    device: str | torch.device | None = None,
):
    """The reference's generate closure, with a ``torch.Generator`` where it
    takes a key (None for greedy decoding). ``padded=False``: (params,
    prompt, generator) -> [B, Tp + max_new]; ``padded=True``: (params,
    prompt, prompt_lens, generator) -> [B, max_new], the right-padded
    variable-length serving path. ``kv_dtype="int8"`` serves from a
    quantized KV cache; sampling as :func:`sample_logits`. The reference
    jits it; nothing compiles here."""
    kw = dict(max_new=max_new, temperature=temperature, top_k=top_k, top_p=top_p,
              eos_id=eos_id, kv_dtype=kv_dtype, device=device)
    if padded:
        def run_padded(params, prompt, prompt_lens, generator=None):
            return generate(params, prompt, cfg, generator=generator, prompt_lens=prompt_lens,
                            **kw)

        return run_padded

    def run(params, prompt, generator=None):
        return generate(params, prompt, cfg, generator=generator, **kw)

    return run
