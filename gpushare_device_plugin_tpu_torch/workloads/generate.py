"""Autoregressive generation with a KV cache, in PyTorch.

Counterpart of ``gpushare_device_plugin_tpu/workloads/generate.py``:
contiguous caches (``init_cache``) and slot-pool caches
(``init_slot_cache``, one length per row), bf16/f32 or int8 KV; prefill
through the flash kernel (left-padded batches via ``start``, right-padded
slot chunks via ``kv_len``); cached decode over the plain grouped
attention with an explicit visibility mask, as in the reference.

Unlike the reference's pure functions, the cache's K/V buffers are
written IN PLACE (one copy of a slot pool on the card, where the JAX
engine donates the buffer to get the same); each function returns the
cache dict with its new ``len``. Callers hand the cache over and use the
returned one.

Token tensors are int64 (PyTorch's index type); values match the
reference's int32 tokens.
"""

from __future__ import annotations

from typing import Any

import torch

from ..device import resolve_device
from ..ops.flash_attention import flash_attention
from ..parallel.ring import grouped_attention
from .attention import chunk_prefill_attention, flash_or_plain, use_flash
from .quant import dequantize_kv, embed_lookup, quantize_kv
from .transformer import (
    TransformerConfig,
    _attn_out,
    _logits,
    _mlp_block,
    _project_qkv,
    _rms_norm,
    layer_params,
)

# {"k","v"}: [L, B, Smax, Hkv, Dh]; "len": [] (batch caches) or [B] (slot
# pools). int8 caches add {"k_scale","v_scale"}: [L, B, Smax, Hkv] f32.
KVCache = dict[str, torch.Tensor]


def init_cache(
    cfg: TransformerConfig, batch: int, max_len: int,
    kv_dtype: str | None = None, *, device: str | torch.device | None = None,
) -> KVCache:
    """Fresh cache; ``kv_dtype="int8"`` stores K/V as symmetric int8 with
    per-(token, head) scales."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
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
) -> KVCache:
    """Slot-pool cache for the continuous-batching engine: the buffers of
    :func:`init_cache` with ``len`` a ``[slots]`` vector, every row an
    independent sequence."""
    cache = init_cache(cfg, slots, max_len, kv_dtype=kv_dtype, device=device)
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
    B, T = new.shape[:2]
    Smax = cache_rows.shape[1]
    start = pos.long().clamp(0, Smax - T)
    idx = start[:, None] + torch.arange(T, device=new.device)[None, :]
    rows = torch.arange(B, device=new.device)[:, None]
    cache_rows[rows, idx] = new.to(cache_rows.dtype)
    return cache_rows


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
) -> tuple[torch.Tensor, KVCache]:
    """Pack one request's opening prompt chunk (``tokens`` [C], right-
    padded, ``n_real`` real) into row ``slot``, restarting the row at
    position 0: ``len[slot] = n_real``. Returns the last REAL position's
    logits [1, vocab] f32 and the cache."""
    slot, n_real = int(slot), int(n_real)
    dt = cfg.compute_dtype
    C = tokens.shape[0]
    positions = torch.arange(C, device=tokens.device)[None, :]
    kv_len = torch.tensor([n_real], dtype=torch.int32, device=tokens.device)
    x = embed_lookup(params["embed"], tokens[None, :], dt)  # [1, C, d]
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        q, k, v = _project_qkv(_rms_norm(x, lp["ln1"]), lp, cfg, positions)
        attn = chunk_prefill_attention(q, k, v, n_real=kv_len, attention=cfg.attention)
        x = _mlp_block(x + _attn_out(attn, lp, cfg), lp, cfg)
        _write_prefix(cache, i, slice(slot, slot + 1), k, v)
    lens = cache["len"].clone()
    lens[slot] = n_real
    logits = _logits(params, x[:, n_real - 1 : n_real], cfg)
    return logits[:, 0], {**cache, "len": lens}


def extend_slot(
    params: Any,
    tokens: torch.Tensor,
    cache: KVCache,
    cfg: TransformerConfig,
    *,
    slot: int,
    n_real: int,
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
    logits, _ = decode_block(params, tokens[None, :], row, cfg)
    lens = cache["len"].clone()
    lens[slot : slot + 1] = pos + n_real
    return logits[:, n_real - 1], {**cache, "len": lens}


def decode_block(
    params: Any,
    tokens: torch.Tensor,
    cache: KVCache,
    cfg: TransformerConfig,
    start: torch.Tensor | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """Cached decode of a T-token block: tokens [B, T] -> (logits
    [B, T, vocab] f32, cache advanced by T). Block position t attends to
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
    x = embed_lookup(params["embed"], tokens, cfg.compute_dtype)  # [B, T, d]
    q8 = _cache_is_q8(cache)
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
        lp = layer_params(params["layers"], i)
        q, k, v = _project_qkv(_rms_norm(x, lp["ln1"]), lp, cfg, positions)
        if q8:
            kq8, ks_new = quantize_kv(k)
            vq8, vs_new = quantize_kv(v)
            _row_update(cache["k"][i], kq8, wpos)
            _row_update(cache["v"][i], vq8, wpos)
            _row_update(cache["k_scale"][i], ks_new, wpos)
            _row_update(cache["v_scale"][i], vs_new, wpos)
            k_mat = dequantize_kv(cache["k"][i], cache["k_scale"][i], q.dtype)
            v_mat = dequantize_kv(cache["v"][i], cache["v_scale"][i], q.dtype)
        else:
            k_mat = _row_update(cache["k"][i], k, wpos)
            v_mat = _row_update(cache["v"][i], v, wpos)
        attn = grouped_attention(q, k_mat, v_mat, causal=False, mask=vis)
        x = _mlp_block(x + _attn_out(attn, lp, cfg), lp, cfg)
    return _logits(params, x, cfg), {**cache, "len": pos0 + T}


def decode_step(
    params: Any,
    token: torch.Tensor,
    cache: KVCache,
    cfg: TransformerConfig,
    start: torch.Tensor | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """One cached decode step: token [B] -> (logits [B, vocab], cache+1)."""
    logits, cache = decode_block(params, token[:, None], cache, cfg, start=start)
    return logits[:, 0], cache


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
    generated [B, max_new]. ``eos_id`` overwrites positions after the
    first EOS with EOS. The reference's scan also runs a decode step
    after the last emitted token whose result it drops; this loop skips
    that step, which leaves the tokens unchanged.
    """
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs a generator")
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=dev).long()
    B, Tp = prompt.shape
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
