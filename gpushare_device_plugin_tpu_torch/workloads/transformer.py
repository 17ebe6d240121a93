"""Llama-style decoder in PyTorch: inference and training.

Counterpart of ``gpushare_device_plugin_tpu/workloads/transformer.py``:
the config, the parameter layout, the layer math, ``forward``, and the
training half (``loss_fn``, ``make_optimizer``, ``make_train_step``,
``init_train_state``, ``demo_batch``). The weights keep the reference's
stacked einsum layout (``wq [L, d, H, Dh]``, ``wkv [L, d, 2, Hkv, Dh]``,
``wo [L, H, Dh, d]``, ``wi [L, d, 2, F]``, ``wdown [L, F, d]``, norm gains
``ln1``/``ln2`` ``[L, d]``), so a JAX tree crosses over by value
(``convert.from_jax_numpy``). A plain dict of tensors is the params tree
every function takes; :class:`Decoder` is the ``nn.Module`` that holds
one (as buffers to serve, as ``nn.Parameter``s to train). The layer loop
is a Python loop over the stacked weights (the reference's ``lax.scan``);
``remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``): "full" saves only the layer inputs, "dots"
saves the projections' outputs and recomputes only elementwise work.

With a mesh (``parallel/mesh.py``) each rank runs its ``[B/(dp·fsdp),
S/sp]`` tile of the global batch at its global positions and holds only
its shard of every weight, cut by :func:`param_shardings` (the
reference's ``param_specs``, pruned where an axis does not divide):

- tp shards heads, the MLP hidden width and the vocabulary. ``wq``,
  ``wkv``, ``wi`` and ``out`` are column-parallel behind
  ``collectives.copy_to_tp``; ``wo``, ``wdown`` and the embedding are
  row-parallel, followed by ``reduce_from_tp``. Attention runs on the
  rank's own q heads and the K/V heads they use. The logits stay cut on
  the vocabulary: the loss is a vocab-parallel cross-entropy, and
  serving gathers only the positions it samples.
- fsdp shards the model dim; a layer all-gathers each weight it uses,
  in the compute dtype, inside the remat'd layer, so the recompute
  gathers again and no whole weight outlives its layer.
- sp: attention goes round the ``sp`` ring (``parallel/ring.py``) or
  through Ulysses's all-to-alls (``parallel/ulysses.py``).

Each rank's loss is its share of the global mean; after the backward,
each leaf's gradient is summed over the replica axes its spec does not
shard (fsdp's share already came back through the gathers' backward; tp
is never summed). LoRA's serving hooks (per-row adapter deltas,
:func:`_bgmv_delta`) sit in :func:`_project_qkv` and :func:`_mlp_block`;
its training merges the adapter into the weights (``lora.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..device import resolve_device
from ..parallel.collectives import (
    all_gather,
    all_reduce,
    all_reduce_sum_,
    copy_to_tp,
    gather_whole,
    reduce_from_tp,
    sum_shares,
)
from ..parallel.mesh import (
    Mesh,
    batch_sharding,
    local_shape,  # noqa: F401  (re-exported)
    own_tile,
    prune_unshardable,
    shard,
    shard_axes,
    shard_tree,
    tree_specs,
)
from ..parallel.ring import ring_attention
from ..parallel.ulysses import ulysses_attention
from .attention import flash_or_plain, ulysses_inner_attn, use_flash
from .optim import AdamW, tree_leaves
from .optim import make_optimizer as _make_adamw
from .quant import embed_lookup, is_qtensor, matmul_weight, qmatmul

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    # Grouped-query attention: None = MHA.
    n_kv_heads: int | None = None
    d_ff: int = 352
    max_seq: int = 256
    rope_theta: float = 10000.0
    compute_dtype: torch.dtype = torch.bfloat16
    # "auto": the CUDA flash kernel for CUDA tensors it fits, plain
    # attention otherwise; "flash" / "plain" force one path.
    attention: str = "auto"
    # Under autograd, recompute each layer in the backward instead of
    # keeping its activations. "full" saves only the layer inputs (the
    # flash forward then runs twice per layer per step). "dots" saves the
    # reference's named outputs (q/k/v, the attention output, the wo
    # projection, the MLP gate/up) and recomputes only the elementwise
    # work: norms, RoPE, SiLU, residual adds.
    remat: bool = True
    remat_policy: str = "full"
    # Sequence parallelism over a mesh's sp axis; context_parallel picks
    # the scheme: "ring" (K/V round the ring, a flash kernel per hop on
    # the card) or "ulysses" (two all-to-alls to a whole-sequence layout,
    # one kernel per rank). Both exact.
    seq_parallel: bool = False
    context_parallel: str = "ring"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        kv = self.n_kv_heads if self.n_kv_heads is not None else self.n_heads
        if self.n_heads % kv:
            raise ValueError(f"n_heads={self.n_heads} not divisible by n_kv_heads={kv}")
        return kv


def llama3_8b() -> TransformerConfig:
    """The Llama-3-8B shape."""
    return TransformerConfig(
        vocab=128256, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        d_ff=14336, max_seq=8192, rope_theta=500000.0,
    )


def init_params(
    cfg: TransformerConfig,
    generator: torch.Generator,
    device: str | torch.device | None = None,
    dtype: torch.dtype = torch.float32,
    mesh: Mesh | None = None,
) -> Params:
    """Random weights scaled like the reference's ``init_params``
    (normal / sqrt(fan_in)), made on ``device`` from ``generator`` (which
    must live on that device). Matmul weights and the embedding are
    ``dtype``; norm gains are f32 ones. The numbers differ from JAX's
    for the same seed: tests move JAX weights across with
    ``convert.from_jax_numpy``. With a ``mesh``, each leaf is drawn whole,
    in the same order and so with the same values, and only this rank's
    shard (:func:`param_shardings`) is kept: the rank never holds more
    than one whole leaf at a time."""
    dev = resolve_device(device)
    d, H, Dh, Fd, L = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.n_layers
    Hkv = cfg.kv_heads
    specs = param_shardings(mesh, cfg) if mesh is not None else None

    def keep(w, *path):
        if specs is None:
            return w
        spec = specs
        for key in path:
            spec = spec[key]
        return own_tile(shard(w, mesh, spec), w)

    def norm(shape, fan_in, *path):
        w = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
        return keep(w.mul_(1.0 / math.sqrt(fan_in)), *path)

    def ones(shape, *path):
        return keep(torch.ones(shape, dtype=torch.float32, device=dev), *path)

    return {
        "embed": norm((cfg.vocab, d), d, "embed"),
        "layers": {
            "wq": norm((L, d, H, Dh), d, "layers", "wq"),
            "wkv": norm((L, d, 2, Hkv, Dh), d, "layers", "wkv"),
            "wo": norm((L, H, Dh, d), d, "layers", "wo"),
            "wi": norm((L, d, 2, Fd), d, "layers", "wi"),
            "wdown": norm((L, Fd, d), Fd, "layers", "wdown"),
            "ln1": ones((L, d), "layers", "ln1"),
            "ln2": ones((L, d), "layers", "ln2"),
        },
        "final_norm": ones((d,), "final_norm"),
        "out": norm((d, cfg.vocab), d, "out"),
    }


def param_specs(cfg: TransformerConfig) -> Params:
    """The reference's ``param_specs``, each spec a tuple with one entry
    per dim: tp shards heads, the MLP hidden width and the vocabulary;
    fsdp shards the model dim (ZeRO-style)."""
    del cfg
    return {
        "embed": ("tp", "fsdp"),
        "layers": {
            "wq": (None, "fsdp", "tp", None),
            "wkv": (None, "fsdp", None, "tp", None),
            "wo": (None, "tp", None, "fsdp"),
            "wi": (None, "fsdp", None, "tp"),
            "wdown": (None, "tp", "fsdp"),
            "ln1": (None, None),
            "ln2": (None, None),
        },
        "final_norm": (None,),
        "out": ("fsdp", "tp"),
    }


def param_shapes(cfg: TransformerConfig) -> Params:
    """The whole shape of every leaf of :func:`init_params`."""
    d, H, Dh, Fd, L = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.n_layers
    return {
        "embed": (cfg.vocab, d),
        "layers": {
            "wq": (L, d, H, Dh), "wkv": (L, d, 2, cfg.kv_heads, Dh), "wo": (L, H, Dh, d),
            "wi": (L, d, 2, Fd), "wdown": (L, Fd, d), "ln1": (L, d), "ln2": (L, d),
        },
        "final_norm": (d,),
        "out": (d, cfg.vocab),
    }


def param_shardings(mesh: Mesh, cfg: TransformerConfig) -> Params:
    """Each leaf's spec on ``mesh``: :func:`param_specs` pruned by
    ``prune_unshardable`` (an axis that does not divide its dim is
    dropped, the dim replicated)."""
    return prune_unshardable(param_specs(cfg), param_shapes(cfg), mesh)


def shard_params(params: Params, mesh: Mesh, cfg: TransformerConfig) -> Params:
    """This rank's shard of every leaf of a whole params tree (as
    ``convert.from_jax_numpy`` or :func:`init_params` without a mesh give
    it). A leaf that already has its shard's shape is kept as it is, so
    sharded params pass through unchanged."""
    check_mesh(mesh, cfg)
    if any(is_qtensor(w) for w in (params["embed"], params["out"], *params["layers"].values())):
        raise ValueError("int8 weights are not sharded: serve tp with float weights")
    return shard_tree(params, param_shardings(mesh, cfg), param_shapes(cfg), mesh)


def leaf_specs(params: Params, mesh: Mesh, cfg: TransformerConfig) -> list[tuple]:
    """The pruned spec (:func:`param_shardings`) of every leaf of
    ``params``, in ``tree_leaves`` order (a tree's key order is its own)."""
    return tree_specs(params, param_shardings(mesh, cfg))


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i``'s weights (views into the stacked tensors)."""
    return {
        name: {"q8": w["q8"][i], "scale": w["scale"][i]} if is_qtensor(w) else w[i]
        for name, w in layers.items()
    }


def _rms_norm(x, weight, eps=1e-6):
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, T, H, Dh]; positions [T] shared or [B, T] per row."""
    Dh = x.shape[-1]
    half = Dh // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., None].float() * freqs  # [*, T, half]
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)  # [B|1, T, 1, half]
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _bgmv_delta(x, a, b, scale: float, dt) -> torch.Tensor:
    """Per-row low-rank delta ``(x @ A) @ B * scale`` in the compute
    dtype ``dt``, ``x @ A`` rounded to ``dt`` before the second product.
    x [B, T, fi]; a [B, fi, r]; b [B, r, fo] -> [B, T, fo]. Each row
    contracts against its own adapter, so a batch that mixes adapters is
    one product; a row whose a/b are zero (the null adapter) gets an
    exactly-zero delta."""
    xa = torch.einsum("btd,bdr->btr", x, a.to(dt))
    return torch.einsum("btr,bro->bto", xa, b.to(dt)) * scale


def _full(w, cfg: TransformerConfig, mesh: Mesh | None, dim: int) -> torch.Tensor:
    """A weight in the compute dtype, whole along its model dim ``dim``:
    an fsdp shard is cast first, then all-gathered over fsdp (the cast
    commutes with the gather, at half the bytes in bf16)."""
    w = matmul_weight(w, cfg.compute_dtype)
    if mesh is not None and w.shape[dim] != cfg.d_model:
        w = all_gather(w, mesh, "fsdp", dim)
    return w


def _proj(eq: str, x, w, cfg: TransformerConfig, mesh: Mesh | None, dim: int) -> torch.Tensor:
    """``einsum(eq, x, w)`` in the compute dtype, where ``w``'s leading dims
    contract with ``x``'s trailing ones: a float weight whole
    (:func:`_full`), an int8 one (never sharded) dequantized a block of
    output channels at a time (``quant.qmatmul``), so serving from int8
    weights never holds a whole dequantized copy of one."""
    if is_qtensor(w):
        xs, ws = eq.split("->")[0].split(",")
        return qmatmul(x, w, len(set(xs) & set(ws)), cfg.compute_dtype)
    return torch.einsum(eq, x, _full(w, cfg, mesh, dim))


def _kv_replicated(wkv: torch.Tensor, cfg: TransformerConfig, mesh: Mesh | None) -> bool:
    """True on a tp mesh whose tp does not divide the kv heads: every rank
    holds all of them (``prune_unshardable``)."""
    return mesh is not None and mesh.shape["tp"] > 1 and wkv.shape[-2] == cfg.kv_heads


def _rank_kv(k, v, cfg: TransformerConfig, mesh: Mesh | None):
    """The K/V heads this rank's q heads use. With kv heads split over tp
    a rank already holds exactly those; when tp does not divide them it
    holds all of them, and selects: one head when its q heads share one,
    else one per q head (the reference's repeat, cut to the rank)."""
    if mesh is None or mesh.shape["tp"] == 1 or k.shape[2] != cfg.kv_heads:
        return k, v
    local = cfg.n_heads // mesh.shape["tp"]
    groups = cfg.n_heads // cfg.kv_heads
    first = mesh.axis_index("tp") * local
    heads = [(first + j) // groups for j in range(local)]
    if len(set(heads)) == 1:
        heads = heads[:1]
    idx = torch.tensor(heads, dtype=torch.long, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _project_qkv(h, lp, cfg: TransformerConfig, positions, lora=None,
                 lora_scale: float = 1.0, mesh: Mesh | None = None):
    """ln1-normalized hidden -> RoPE'd (q [B,T,H,Dh], k, v [B,T,Hkv,Dh]).
    ``lora`` (serving): this layer's per-row adapter views ``{target: (a
    [B, fi, r], b [B, r, fo])}``; their deltas go on the raw projections
    before RoPE, the order ``merge_lora`` bakes into the weights. With a
    tp ``mesh`` both products are column-parallel: q has the rank's H/tp
    heads, k and v its Hkv/tp (or, when tp does not divide them, all Hkv,
    with ``wkv``'s gradient summed over tp as it leaves)."""
    dt = cfg.compute_dtype
    h = copy_to_tp(h, mesh)
    wkv = lp["wkv"]
    if not is_qtensor(wkv):
        wkv = _full(wkv, cfg, mesh, 0)
        if _kv_replicated(wkv, cfg, mesh):
            wkv = copy_to_tp(wkv, mesh)
    q = _proj("btd,dhn->bthn", h, lp["wq"], cfg, mesh, 0)
    kv = _proj("btd,dchn->btchn", h, wkv, cfg, mesh, 0)
    if lora is not None and "wq" in lora:
        q = q + _bgmv_delta(h, *lora["wq"], lora_scale, dt).reshape(q.shape)
    if lora is not None and "wkv" in lora:
        kv = kv + _bgmv_delta(h, *lora["wkv"], lora_scale, dt).reshape(kv.shape)
    k, v = kv[:, :, 0], kv[:, :, 1]
    return _rope(q, positions, cfg.rope_theta), _rope(k, positions, cfg.rope_theta), v


def _mlp_block(x, lp, cfg: TransformerConfig, lora=None, lora_scale: float = 1.0,
               mesh: Mesh | None = None):
    """Residual SwiGLU MLP (ln2 -> gate/up -> silu -> down); ``lora`` as
    in :func:`_project_qkv`. With a tp ``mesh``: gate/up column-parallel
    over the rank's F/tp, down row-parallel, summed over tp."""
    dt = cfg.compute_dtype
    h = copy_to_tp(_rms_norm(x, lp["ln2"]), mesh)
    gate_up = _proj("btd,dcf->btcf", h, lp["wi"], cfg, mesh, 0)
    if lora is not None and "wi" in lora:
        gate_up = gate_up + _bgmv_delta(h, *lora["wi"], lora_scale, dt).reshape(gate_up.shape)
    ff = F.silu(gate_up[:, :, 0]) * gate_up[:, :, 1]
    down = _proj("btf,fd->btd", ff, lp["wdown"], cfg, mesh, 1)
    if lora is not None and "wdown" in lora:
        down = down + _bgmv_delta(ff, *lora["wdown"], lora_scale, dt)
    return x + reduce_from_tp(down, mesh)


def _attn_out(attn, lp, cfg: TransformerConfig, mesh: Mesh | None = None, delta=None):
    """The wo projection (plus an adapter's ``delta``), row-parallel over
    tp: each rank's heads contribute a partial sum."""
    out = _proj("bthn,hnd->btd", attn, lp["wo"], cfg, mesh, 2)
    if delta is not None:
        out = out + delta
    return reduce_from_tp(out, mesh)


def _embed(embed, tokens: torch.Tensor, cfg: TransformerConfig, mesh: Mesh | None = None):
    """Embedding rows in the compute dtype. A vocab-parallel table (its
    rows cut over tp) looks up the ids in this rank's range, zeroes the
    rest and sums over tp."""
    if mesh is None:
        return embed_lookup(embed, tokens, cfg.compute_dtype)
    table = _full(embed, cfg, mesh, 1)
    rows = table.shape[0]
    if rows == cfg.vocab:
        return table[tokens]
    local = tokens - mesh.axis_index("tp") * rows
    hit = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)]
    return reduce_from_tp(torch.where(hit[..., None], x, torch.zeros_like(x)), mesh)


def _logits(params: Params, x, cfg: TransformerConfig, mesh: Mesh | None = None):
    """f32 logits; with a tp ``mesh``, this rank's vocab/tp of them."""
    x = copy_to_tp(_rms_norm(x, params["final_norm"]), mesh)
    return _proj("btd,dv->btv", x, params["out"], cfg, mesh, 0).float()


def gather_logits(logits: torch.Tensor, cfg: TransformerConfig,
                  mesh: Mesh | None) -> torch.Tensor:
    """Whole-vocabulary logits from this rank's tp shard of them, the same
    on every rank (serving samples from these)."""
    if mesh is None or logits.shape[-1] == cfg.vocab:
        return logits
    return gather_whole(logits, mesh, "tp", logits.dim() - 1)


def _attention(q, k, v, cfg: TransformerConfig, mesh: Mesh | None):
    """Causal self-attention of one layer on the rank's q heads and the
    K/V heads they use: over the sp axis when ``cfg.seq_parallel``, else
    on the rank's tensors as they are."""
    k, v = _rank_kv(k, v, cfg, mesh)
    if not cfg.seq_parallel:
        return flash_or_plain(q, k, v, attention=cfg.attention, causal=True, mesh=mesh)
    if mesh is None:
        raise ValueError("seq_parallel=True requires a mesh")
    if cfg.context_parallel not in ("ring", "ulysses"):
        raise ValueError(
            f"unknown context_parallel={cfg.context_parallel!r}: expected ring|ulysses"
        )
    if cfg.context_parallel == "ulysses":
        return ulysses_attention(q, k, v, mesh, axis_name="sp", causal=True,
                                 batch_axes=("dp", "fsdp"), head_axes="tp",
                                 attn_fn=ulysses_inner_attn(cfg.attention))
    return ring_attention(q, k, v, mesh, axis_name="sp", causal=True,
                          batch_axes=("dp", "fsdp"), head_axes="tp",
                          hop_attention=cfg.attention)


def _layer(x, lp, cfg: TransformerConfig, positions, mesh: Mesh | None = None):
    """One decoder block."""
    q, k, v = _project_qkv(_rms_norm(x, lp["ln1"]), lp, cfg, positions, mesh=mesh)
    attn = _attention(q, k, v, cfg, mesh)
    return _mlp_block(x + _attn_out(attn, lp, cfg, mesh), lp, cfg, mesh=mesh)


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _save_matmuls(n: int) -> Callable:
    """A ``context_fn`` for ``checkpoint``: save the outputs of the first
    ``n`` matrix products of the checkpointed function, recompute every
    other op in the backward."""

    def context_fn():
        seen = {False: 0, True: 0}  # products so far, in the forward and in the recompute

        def policy(ctx, op, *args, **kwargs):
            if op in _MATMULS:
                seen[ctx.is_recompute] += 1
                if seen[ctx.is_recompute] <= n:
                    return CheckpointPolicy.MUST_SAVE
            return CheckpointPolicy.PREFER_RECOMPUTE

        return create_selective_checkpoint_contexts(policy)

    return context_fn


def _qkv_part(x, lp, cfg: TransformerConfig, positions, mesh: Mesh | None = None):
    return _project_qkv(_rms_norm(x, lp["ln1"]), lp, cfg, positions, mesh=mesh)


def _wo_part(x, attn, lp, cfg: TransformerConfig, mesh: Mesh | None = None):
    return x + _attn_out(attn, lp, cfg, mesh)


def _mlp_part(x, lp, cfg: TransformerConfig, mesh: Mesh | None = None):
    return _mlp_block(x, lp, cfg, mesh=mesh)


def _dots_layer(x, lp, cfg: TransformerConfig, positions, mesh: Mesh | None = None):
    """The decoder block under the reference's "dots" policy, as three
    pieces: ln1 and the q/kv products (their outputs saved, the norm and
    RoPE recomputed); attention, outside any recompute on the flash path
    (the kernel saves q, k, v, O and lse itself, so it runs once, and so
    do the ring's or Ulysses's exchanges around it) and recomputed whole
    on the plain path (no [S, S] matrix is kept; a sequence-parallel
    recompute makes its exchanges again, on every rank alike); then the
    wo product and residual (its output saved) and the MLP (its gate/up
    output saved, ln2 and SiLU recomputed). Each piece gathers its fsdp
    weights inside its checkpoint, so what it saves are products of the
    rank's own shards, and the backward gathers each weight again rather
    than keep it."""
    q, k, v = checkpoint(_qkv_part, x, lp, cfg, positions, mesh, use_reentrant=False,
                         context_fn=_save_matmuls(2))
    if use_flash(cfg.attention, q):
        attn = _attention(q, k, v, cfg, mesh)
    else:
        attn = checkpoint(_attention, q, k, v, cfg, mesh, use_reentrant=False)
    x = checkpoint(_wo_part, x, attn, lp, cfg, mesh, use_reentrant=False,
                   context_fn=_save_matmuls(1))
    return checkpoint(_mlp_part, x, lp, cfg, mesh, use_reentrant=False,
                      context_fn=_save_matmuls(1))


def _layer_fn(cfg: TransformerConfig) -> Callable:
    """The layer, wrapped for the backward as ``cfg.remat`` asks."""
    if not cfg.remat:
        return _layer
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy={cfg.remat_policy!r}: expected full|dots")
    if not torch.is_grad_enabled():
        return _layer  # nothing to save, nothing to recompute
    if cfg.remat_policy == "dots":
        return _dots_layer
    return lambda *args: checkpoint(_layer, *args, use_reentrant=False)


# The batch axes: the loss's shares are summed over these, never over tp.
REPLICA_AXES = ("dp", "fsdp", "sp")


def check_mesh(mesh: Mesh, cfg: TransformerConfig) -> None:
    """Raise unless ``cfg``'s decoder runs on ``mesh``: tp must divide the
    heads, the MLP hidden width and the vocabulary (the kv heads may stay
    whole: each rank then selects the ones its q heads use)."""
    tp = mesh.shape["tp"]
    for name, n in (("n_heads", cfg.n_heads), ("d_ff", cfg.d_ff), ("vocab", cfg.vocab)):
        if n % tp:
            raise ValueError(f"tp={tp} does not divide {name}={n}: the decoder shards "
                             "heads, MLP width and vocabulary over tp")


def grad_sum_axes(params: Params, mesh: Mesh, cfg: TransformerConfig) -> list[tuple[str, ...]]:
    """For each leaf of ``params``, in ``tree_leaves`` order, the axes its gradient is
    summed over after the backward: the batch axes its pruned spec does
    not shard. An fsdp-sharded leaf's fsdp sum came back through its
    gather's backward; tp is never summed (``copy_to_tp`` already made
    every tp rank's gradient of a replicated leaf whole)."""
    return [tuple(a for a in REPLICA_AXES if a not in shard_axes(spec))
            for spec in leaf_specs(params, mesh, cfg)]


def sum_grads_(grads: list[torch.Tensor], params: Params, mesh: Mesh,
               cfg: TransformerConfig) -> None:
    """Sum the gradient of each leaf of ``params`` in place over
    :func:`grad_sum_axes`, one all-reduce per leaf and axis, in leaf order
    on every rank."""
    for g, axes in zip(grads, grad_sum_axes(params, mesh, cfg)):
        all_reduce_sum_([g], mesh, axes)


def _tile(tokens: torch.Tensor, cfg: TransformerConfig, mesh: Mesh):
    """This rank's tile of the global tokens and the global position of
    its first column."""
    check_mesh(mesh, cfg)
    if mesh.shape["sp"] > 1 and not cfg.seq_parallel:
        raise ValueError(f"a mesh with sp={mesh.shape['sp']} needs seq_parallel=True")
    tile = batch_sharding(tokens, mesh, seq_parallel=cfg.seq_parallel)
    return tile, mesh.axis_index("sp") * tile.shape[1]


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            mesh: Mesh | None = None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, vocab] f32. With a ``mesh``, the
    global tokens in (the same on every rank), the logits of this rank's
    ``[B/(dp·fsdp), S/sp]`` tile out, computed at its global positions,
    on this rank's vocab/tp (:func:`gather_logits` makes them whole)."""
    start = 0
    if mesh is not None:
        tokens, start = _tile(tokens, cfg, mesh)
    positions = start + torch.arange(tokens.shape[1], device=tokens.device)
    layer = _layer_fn(cfg)
    x = _embed(params["embed"], tokens, cfg, mesh)
    for i in range(cfg.n_layers):
        x = layer(x, layer_params(params["layers"], i), cfg, positions, mesh)
    return _logits(params, x, cfg, mesh)


def _nll_sum(logits: torch.Tensor, targets: torch.Tensor, cfg: TransformerConfig,
             mesh: Mesh | None) -> torch.Tensor:
    """The summed next-token nll of ``logits`` [B, T, V] at ``targets``
    [B, T]. Logits cut on the vocabulary over tp give a vocab-parallel
    cross-entropy: the max, the sum of exponentials and the target's
    logit are each combined over tp, and ``[B, T, vocab]`` is never
    gathered. Every tp rank returns the same sum and differentiates its
    own logits."""
    if mesh is None or logits.shape[-1] == cfg.vocab:
        return F.cross_entropy(logits.flatten(0, 1), targets.flatten().long(), reduction="sum")
    return token_nll(logits, targets, cfg.vocab, mesh).sum()


def token_nll(logits: torch.Tensor, targets: torch.Tensor, vocab: int,
              mesh: Mesh | None) -> torch.Tensor:
    """The cross-entropy of ``logits`` [..., V] at ``targets`` [...], one
    value per target. Logits cut on the vocabulary (V = vocab/tp) are
    vocab-parallel: the max, the sum of exponentials and the target's
    logit are each combined over tp, and every tp rank returns the same
    values while differentiating its own logits. Whole logits (no mesh,
    or a vocabulary that tp does not divide) take ``F.cross_entropy``."""
    width = logits.shape[-1]
    if mesh is None or width == vocab:
        return F.cross_entropy(logits.reshape(-1, width), targets.reshape(-1).long(),
                               reduction="none").view(targets.shape)
    top = all_reduce(logits.detach().amax(-1), mesh, "tp", op="max", kind="tp_all_reduce")
    z = logits - top[..., None]
    sumexp = reduce_from_tp(z.exp().sum(-1), mesh)
    local = targets.long() - mesh.axis_index("tp") * width
    hit = (local >= 0) & (local < width)
    picked = torch.gather(z, -1, local.clamp(0, width - 1)[..., None])[..., 0]
    target = reduce_from_tp(torch.where(hit, picked, torch.zeros_like(picked)), mesh)
    return sumexp.log() - target


def loss_fn(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            mesh: Mesh | None = None) -> torch.Tensor:
    """Next-token cross-entropy on the f32 logits, mean over [B, S-1].

    With a ``mesh``: ``tokens`` is the global batch, the same on every
    rank. A rank's targets are the T tokens after its T inputs, the first
    of them the next rank's first input; the last rank of the sp ring has
    one target fewer. Each rank divides its nll sum by the global count
    B*(S-1), so the ranks' shares sum to the mean, which every rank
    returns; its backward is the rank's own share (the gradients are
    summed over the mesh afterwards, :func:`make_train_step`). The shares
    are summed over the batch axes, never over tp: the tp ranks of one
    tile hold the same share (:func:`_nll_sum`)."""
    logits = forward(params, tokens, cfg, mesh)
    if mesh is None:
        return F.cross_entropy(logits[:, :-1].flatten(0, 1), tokens[:, 1:].flatten().long())
    T = logits.shape[1]
    start = mesh.axis_index("sp") * T
    targets = batch_sharding(tokens, mesh)[:, start + 1:start + T + 1]
    n = targets.shape[1]
    nll = _nll_sum(logits[:, :n], targets, cfg, mesh)
    B, S = tokens.shape
    return sum_shares(nll / (B * (S - 1)), mesh, REPLICA_AXES)


# --- training ---------------------------------------------------------------


def make_optimizer(lr: float = 3e-4, **kw) -> AdamW:
    """AdamW (+ clip, + warmup-cosine with ``total_steps=``): ``optim.py``."""
    return _make_adamw(lr, **kw)


def make_train_step(cfg: TransformerConfig, optimizer: AdamW | None = None,
                    accum_steps: int = 1, mesh: Mesh | None = None) -> Callable:
    """Train step ``(params, opt_state, tokens) -> (params, opt_state,
    loss)``; params and optimizer state are updated in place.

    ``accum_steps > 1`` splits the batch into that many microbatches (the
    reference's strided split: microbatch i takes every accum_steps-th
    row) and sums their gradients before the one optimizer update: the
    full-batch step up to f32 summation order, at one microbatch's
    activation memory.

    With a ``mesh``, ``tokens`` is the global batch, the same on every
    rank, and params and optimizer state are the rank's shards
    (:func:`init_train_state`, :func:`shard_params`); each rank runs its
    tile, each leaf's gradient is summed over the axes of
    :func:`grad_sum_axes` (in leaf order), and every rank applies AdamW to
    its shards, clipping by the global norm over all of them."""
    opt = optimizer or make_optimizer()
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if mesh is not None:
        check_mesh(mesh, cfg)

    def grads_of(params, tokens):
        loss = loss_fn(params, tokens, cfg, mesh)
        return loss.detach(), list(torch.autograd.grad(loss, tree_leaves(params)))

    def step(params, opt_state, tokens):
        if accum_steps == 1:
            loss, grads = grads_of(params, tokens)
        else:
            B = tokens.shape[0]
            if B % accum_steps:
                raise ValueError(f"batch {B} not divisible by accum_steps={accum_steps}")
            micros = tokens.reshape(B // accum_steps, accum_steps, -1).transpose(0, 1)
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in tree_leaves(params)]
            for micro in micros:
                micro_loss, micro_grads = grads_of(params, micro)
                loss = loss + micro_loss
                for acc, g in zip(grads, micro_grads):
                    acc.add_(g)
            loss = loss / accum_steps
            for g in grads:
                g.div_(accum_steps)
        owned = None
        if mesh is not None:
            sum_grads_(grads, params, mesh, cfg)
            owned = [shard_axes(spec) for spec in leaf_specs(params, mesh, cfg)]
        opt.update(grads, opt_state, params, mesh=mesh, shard_axes=owned)
        return params, opt_state, loss

    return step


def init_train_state(
    cfg: TransformerConfig, generator: torch.Generator,
    optimizer: AdamW | None = None, device: str | torch.device | None = None,
    mesh: Mesh | None = None,
) -> tuple[Params, dict[str, Any]]:
    """(params, opt_state) for :func:`make_train_step`: f32 params made on
    ``device`` (the mesh's device, with a ``mesh``) from ``generator``
    (which must live there), held as the ``nn.Parameter``s of a trainable
    :class:`Decoder`. With a mesh every rank draws every leaf whole and
    keeps its shard (:func:`init_params`), so every rank must pass a
    generator seeded alike, and the shards hold exactly the values of
    the unsharded state."""
    opt = optimizer or make_optimizer()
    if mesh is not None:
        check_mesh(mesh, cfg)
        device = mesh.device if device is None else device
    params = Decoder(init_params(cfg, generator, device=device, mesh=mesh), cfg,
                     trainable=True).params
    return params, opt.init(params)


def demo_batch(generator: torch.Generator, batch: int, seq: int, vocab: int) -> torch.Tensor:
    """Synthetic structured tokens [batch, seq] int64 on the generator's
    device: each row counts up from a random start (no dataset needed)."""
    dev = generator.device
    base = torch.randint(0, vocab // 2, (batch, 1), generator=generator, device=dev)
    return (base + torch.arange(seq, device=dev)[None, :]) % vocab


def _flatten(tree: Params, prefix: str = "") -> dict[str, torch.Tensor]:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + "__"))
        else:
            out[name] = val
    return out


class Decoder(torch.nn.Module):
    """``nn.Module`` holding a stacked decoder params tree, so ``.to()``
    and ``state_dict()`` work on the whole tree: as buffers (inference
    weights, no gradients), or with ``trainable=True`` as
    ``nn.Parameter``s. ``params`` is the tree every function of the port
    takes; ``forward`` is :func:`forward`."""

    def __init__(self, params: Params, cfg: TransformerConfig, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self._names = list(_flatten(params))
        for name, val in _flatten(params).items():
            if trainable:
                self.register_parameter(name, torch.nn.Parameter(val))
            else:
                self.register_buffer(name, val)

    @property
    def params(self) -> Params:
        tree: Params = {}
        for name in self._names:
            *path, leaf = name.split("__")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = getattr(self, name)
        return tree

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.params, tokens, self.cfg)
