"""BERT-style bidirectional encoder with a masked-LM head, in PyTorch.

Counterpart of ``gpushare_device_plugin_tpu/workloads/bert.py``: post-LN
encoder blocks over stacked layer weights (a Python loop, the reference's
``lax.scan``), bf16 compute over f32 params, the MLM head tied to the
token embedding, the training half (AdamW from ``optim.py``), and the
mesh helpers (``param_specs``, ``param_shardings``, ``shard_params``).

With a mesh (``parallel/mesh.py``) each rank runs its ``B/(dp·fsdp)``
rows of the global batch, the whole sequence (BERT has no sequence
parallelism: an ``sp`` axis raises), on its shard of every weight, cut
by :func:`param_shardings`: the reference's ``param_specs`` pruned where
an axis does not divide its dim, the dim then whole on every rank of
that axis. The layout is the reference's shard_map of the flash kernel
(batch over ``(dp, fsdp)``, heads over ``tp``):

- tp cuts the heads (``wqkv`` column-, ``wo`` row-parallel), the MLP
  width (``wi``, ``wdown``), the vocabulary (``embed``, ``out_bias``) and
  the MLM dense layer's output features. A cut projection sits between
  ``copy_to_tp`` and ``reduce_from_tp``; an uncut one runs whole on every
  tp rank with neither. A vocab-cut embedding looks up the ids in the
  rank's rows and sums over tp; the tied head's logits then stay cut and
  the loss is a vocab-parallel cross-entropy. The dense layer's weight is
  gathered whole over tp (its layer norm needs every feature) by
  ``gather_from_tp``, whose backward keeps the rank's block.
- fsdp cuts the model dim; each weight is cast and all-gathered over
  fsdp where it is used (inside the remat'd layer for the layers).

Each rank's loss is its share of the global masked mean, divided by the
global batch's mask count; after the backward each leaf's gradient is
summed over the batch axes its spec does not cut (:func:`grad_sum_axes`).

Attention is non-causal and goes through ``attention.flash_or_plain``: on
the card ``"auto"`` takes the tensor-core flash kernels (bf16, D 64 at
BERT-base), on the CPU their plain version. ``remat`` recomputes each
layer in the backward (``torch.utils.checkpoint``), as the decoder's
"full" policy, so the flash forward runs twice per layer per step.

Where PyTorch's defaults differ from JAX's, this follows JAX: gelu is the
tanh approximation (``jax.nn.gelu``'s default), the layer-norm variance is
the biased one, and its epsilon is 1e-6.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..parallel.collectives import (
    all_reduce_sum_,
    copy_to_tp,
    gather_from_tp,
    reduce_from_tp,
    sum_shares,
)
from ..parallel.mesh import (
    Mesh,
    batch_sharding,
    own_tile,
    prune_unshardable,
    shard,
    shard_axes,
    shard_tree,
    tree_specs,
)
from .attention import flash_or_plain
from .optim import AdamW, make_optimizer as _make_adamw, tree_index, tree_leaves
from .transformer import REPLICA_AXES, _embed, _full, token_nll

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab: int = 256
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 512
    max_seq: int = 512
    n_segments: int = 2
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    attention: str = "auto"  # auto | flash | plain
    mask_token_id: int = 1  # [MASK] for demo MLM batches

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def bert_base(vocab: int = 30522) -> BertConfig:
    """The BERT-base (L=12, H=768, A=12) shape."""
    return BertConfig(vocab=vocab, d_model=768, n_layers=12, n_heads=12, d_ff=3072, max_seq=512)


# --- shapes and init ---------------------------------------------------------


def param_shapes(cfg: BertConfig) -> Params:
    """The params shape tree, in :func:`init_params`' (and the reference's)
    layout."""
    d, H, Dh, Fd, L = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.n_layers

    def ln(*lead):
        return {"scale": (*lead, d), "bias": (*lead, d)}

    return {
        "embed": (cfg.vocab, d),
        "pos_embed": (cfg.max_seq, d),
        "seg_embed": (cfg.n_segments, d),
        "embed_ln": ln(),
        "layers": {
            "wqkv": (L, d, 3, H, Dh),
            "wo": (L, H, Dh, d),
            "wi": (L, d, Fd),
            "wdown": (L, Fd, d),
            "ln1": ln(L),
            "ln2": ln(L),
        },
        "mlm": {"dense": (d, d), "ln": ln(), "out_bias": (cfg.vocab,)},
    }


def init_params(
    cfg: BertConfig, generator: torch.Generator, device: str | torch.device | None = None,
    mesh: Mesh | None = None,
) -> Params:
    """f32 params on ``device`` made from ``generator`` (which must live
    there), scaled as the reference's: normal / sqrt(d), ``wdown`` normal /
    sqrt(d_ff), layer-norm scale 1 and bias 0, the MLM output bias 0. The
    numbers differ from JAX's: tests move JAX weights across with
    ``convert.bert_from_jax_numpy``. With a ``mesh`` each leaf is drawn
    whole, in the same order and so with the same values, and only this
    rank's shard (:func:`param_shardings`) is kept."""
    dev = resolve_device(device)
    specs = param_shardings(mesh, cfg) if mesh is not None else None

    def make(name, shape, parent):
        if parent.startswith("ln") or parent.endswith("_ln") or name == "out_bias":
            return torch.full(shape, 1.0 if name == "scale" else 0.0, device=dev)
        fan_in = cfg.d_ff if name == "wdown" else cfg.d_model
        w = torch.randn(shape, generator=generator, device=dev)
        return w.div_(math.sqrt(fan_in))

    def build(tree, spec, parent=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = build(v, None if spec is None else spec[k], k)
            else:
                w = make(k, v, parent)
                out[k] = w if spec is None else own_tile(shard(w, mesh, spec[k]), w)
        return out

    return build(param_shapes(cfg), specs)


# --- sharding ---------------------------------------------------------------


def param_specs(cfg: BertConfig) -> Params:
    """The reference's ``param_specs``, each spec a tuple with one entry
    per dim."""
    del cfg
    ln = {"scale": (None,), "bias": (None,)}
    layer_ln = {"scale": (None, None), "bias": (None, None)}
    return {
        "embed": ("tp", "fsdp"),
        "pos_embed": (None, "fsdp"),
        "seg_embed": (None, "fsdp"),
        "embed_ln": ln,
        "layers": {
            "wqkv": (None, "fsdp", None, "tp", None),
            "wo": (None, "tp", None, "fsdp"),
            "wi": (None, "fsdp", "tp"),
            "wdown": (None, "tp", "fsdp"),
            "ln1": layer_ln,
            "ln2": layer_ln,
        },
        "mlm": {"dense": ("fsdp", "tp"), "ln": ln, "out_bias": ("tp",)},
    }


def param_shardings(mesh: Mesh, cfg: BertConfig) -> Params:
    """Each leaf's spec on ``mesh``: :func:`param_specs` pruned by
    ``prune_unshardable`` (vocab 30,522 under tp=4 leaves ``embed`` whole
    over tp and ``out_bias`` whole)."""
    return prune_unshardable(param_specs(cfg), param_shapes(cfg), mesh)


def shard_params(params: Params, mesh: Mesh, cfg: BertConfig) -> Params:
    """This rank's shard of every leaf of a whole params tree; a leaf that
    already has its shard's shape passes through."""
    check_mesh(mesh, cfg)
    return shard_tree(params, param_shardings(mesh, cfg), param_shapes(cfg), mesh)


def leaf_specs(params: Params, mesh: Mesh, cfg: BertConfig) -> list[tuple]:
    """The pruned spec of every leaf of ``params``, in ``tree_leaves`` order."""
    return tree_specs(params, param_shardings(mesh, cfg))


def grad_sum_axes(params: Params, mesh: Mesh, cfg: BertConfig) -> list[tuple[str, ...]]:
    """For each leaf, in ``tree_leaves`` order, the batch axes its gradient
    is summed over after the backward: those its pruned spec does not cut
    (an fsdp-cut leaf's fsdp sum came back through its gather's backward;
    tp is never summed)."""
    return [tuple(a for a in REPLICA_AXES if a not in shard_axes(spec))
            for spec in leaf_specs(params, mesh, cfg)]


def check_mesh(mesh: Mesh, cfg: BertConfig) -> None:
    """Raise unless BERT runs on ``mesh``: it has no sequence parallelism."""
    del cfg
    if mesh.shape["sp"] > 1:
        raise ValueError(f"BERT has no sequence parallelism: mesh sp={mesh.shape['sp']}")


# --- model ------------------------------------------------------------------


def _layer_norm(x, p, eps=1e-6):
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _tp_cut(mesh: Mesh | None, n: int, whole: int) -> bool:
    """True when a weight dim of local size ``n`` (whole: ``whole``) is cut
    over tp on ``mesh``."""
    return mesh is not None and n != whole


def _layer(x, lp, cfg: BertConfig, mesh: Mesh | None = None):
    """One post-LN encoder block. x: [B, T, d]. On a mesh, attention runs
    on this rank's heads when tp cuts them and the MLP on its share of
    d_ff; the fsdp shards are gathered here (inside the remat)."""
    heads = _tp_cut(mesh, lp["wqkv"].shape[-2], cfg.n_heads)
    qkv = torch.einsum("btd,dchn->btchn", copy_to_tp(x, mesh) if heads else x,
                       _full(lp["wqkv"], cfg, mesh, 0))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    attn = flash_or_plain(q, k, v, attention=cfg.attention, causal=False, mesh=mesh)
    out = torch.einsum("bthn,hnd->btd", attn, _full(lp["wo"], cfg, mesh, 2))
    x = _layer_norm(x + (reduce_from_tp(out, mesh) if heads else out), lp["ln1"])
    ffn = _tp_cut(mesh, lp["wi"].shape[-1], cfg.d_ff)
    ff = _gelu(torch.einsum("btd,df->btf", copy_to_tp(x, mesh) if ffn else x,
                            _full(lp["wi"], cfg, mesh, 0)))
    down = torch.einsum("btf,fd->btd", ff, _full(lp["wdown"], cfg, mesh, 1))
    return _layer_norm(x + (reduce_from_tp(down, mesh) if ffn else down), lp["ln2"])


def forward(
    params: Params, tokens: torch.Tensor, cfg: BertConfig,
    segments: torch.Tensor | None = None, mesh: Mesh | None = None,
) -> torch.Tensor:
    """tokens [B, S] -> contextual embeddings [B, S, d] in the compute
    dtype. With a ``mesh``, the global tokens (and segments) in, the same
    on every rank, and this rank's ``B/(dp·fsdp)`` rows out."""
    S = tokens.shape[1]
    if mesh is not None:
        check_mesh(mesh, cfg)
        tokens = batch_sharding(tokens, mesh)
        segments = None if segments is None else batch_sharding(segments, mesh)
    x = _embed(params["embed"], tokens, cfg, mesh)
    x = x + _full(params["pos_embed"], cfg, mesh, 1)[:S][None]
    if segments is not None:
        x = x + _full(params["seg_embed"], cfg, mesh, 1)[segments]
    x = _layer_norm(x, params["embed_ln"])
    layer = _layer
    if cfg.remat and torch.is_grad_enabled():
        layer = lambda *args: checkpoint(_layer, *args, use_reentrant=False)  # noqa: E731
    for i in range(cfg.n_layers):
        x = layer(x, tree_index(params["layers"], i), cfg, mesh)
    return x


def mlm_logits(params: Params, hidden: torch.Tensor, cfg: BertConfig,
               mesh: Mesh | None = None) -> torch.Tensor:
    """[B, S, d] -> [B, S, vocab] f32 through the tied-embedding MLM head;
    on a mesh whose tp cuts the vocabulary, this rank's vocab/tp of them."""
    dense = _full(params["mlm"]["dense"], cfg, mesh, 0)
    if _tp_cut(mesh, dense.shape[1], cfg.d_model):
        dense = gather_from_tp(dense, mesh, 1)
    h = _gelu(torch.einsum("btd,de->bte", hidden, dense))
    h = _layer_norm(h, params["mlm"]["ln"])
    embed = _full(params["embed"], cfg, mesh, 1)
    if _tp_cut(mesh, embed.shape[0], cfg.vocab):
        h = copy_to_tp(h, mesh)
    logits = torch.einsum("btd,vd->btv", h, embed)
    return logits.float() + params["mlm"]["out_bias"]


def loss_fn(params: Params, tokens, targets, mask, cfg: BertConfig,
            mesh: Mesh | None = None) -> torch.Tensor:
    """Masked-LM cross-entropy over the positions where ``mask`` is 1.

    With a ``mesh`` the global batch in, the same on every rank: each rank
    divides the nll summed over its rows' masked positions by the global
    batch's mask count, so the shares summed over the batch axes are the
    mean, which every rank returns; its backward is the rank's own share."""
    logits = mlm_logits(params, forward(params, tokens, cfg, mesh=mesh), cfg, mesh)
    denom = torch.clamp(mask.sum(), min=1.0)
    if mesh is None:
        nll = F.cross_entropy(logits.flatten(0, 1), targets.flatten().long(), reduction="none")
        return (nll * mask.flatten()).sum() / denom
    nll = token_nll(logits, batch_sharding(targets, mesh), cfg.vocab, mesh)
    return sum_shares((nll * batch_sharding(mask, mesh)).sum() / denom, mesh, REPLICA_AXES)


# --- training ---------------------------------------------------------------


def make_optimizer(lr: float = 1e-4, **kw) -> AdamW:
    """AdamW (+ clip, + warmup-cosine with ``total_steps=``): ``optim.py``."""
    return _make_adamw(lr, **kw)


def make_train_step(cfg: BertConfig, optimizer: AdamW | None = None,
                    mesh: Mesh | None = None) -> Callable:
    """``(params, opt_state, tokens, targets, mask) -> (params, opt_state,
    loss)``; params and the AdamW state update in place. With a ``mesh``
    the batch is the global one, the same on every rank, and params and
    optimizer state are the rank's shards: each leaf's gradient is summed
    over :func:`grad_sum_axes` (in leaf order), and AdamW clips, if asked,
    by the global norm over every shard."""
    opt = optimizer or make_optimizer()
    if mesh is not None:
        check_mesh(mesh, cfg)

    def step(params, opt_state, tokens, targets, mask):
        loss = loss_fn(params, tokens, targets, mask, cfg, mesh)
        # seg_embed is unused without segments: its gradient is zero, as in JAX
        grads = list(torch.autograd.grad(loss, tree_leaves(params), materialize_grads=True))
        owned = None
        if mesh is not None:
            for g, axes in zip(grads, grad_sum_axes(params, mesh, cfg)):
                all_reduce_sum_([g], mesh, axes)
            owned = [shard_axes(spec) for spec in leaf_specs(params, mesh, cfg)]
        opt.update(grads, opt_state, params, mesh=mesh, shard_axes=owned)
        return params, opt_state, loss.detach()

    return step


def init_train_state(
    cfg: BertConfig, generator: torch.Generator, optimizer: AdamW | None = None,
    device: str | torch.device | None = None, mesh: Mesh | None = None,
) -> tuple[Params, dict[str, Any]]:
    """(params, opt_state) for :func:`make_train_step`; params require
    grad. With a ``mesh`` (its device unless ``device`` is given) each rank
    keeps its shards of the whole draw (:func:`init_params`), so every rank
    must pass a generator seeded alike."""
    opt = optimizer or make_optimizer()
    if mesh is not None:
        check_mesh(mesh, cfg)
        device = mesh.device if device is None else device
    params = init_params(cfg, generator, device=device, mesh=mesh)
    for p in tree_leaves(params):
        p.requires_grad_()
    return params, opt.init(params)


def demo_batch(generator: torch.Generator, batch: int, seq: int, cfg: BertConfig):
    """Synthetic MLM batch (tokens, targets, mask) on the generator's
    device: each row counts up from a random start, 15% of positions
    masked (mask f32, the rest int64)."""
    dev = generator.device
    base = torch.randint(2, cfg.vocab // 2, (batch, 1), generator=generator, device=dev)
    ramp = torch.arange(seq, device=dev)[None, :]
    targets = (base + ramp) % (cfg.vocab - 2) + 2
    mask = (torch.rand((batch, seq), generator=generator, device=dev) < 0.15).float()
    tokens = torch.where(mask == 1.0, torch.full_like(targets, cfg.mask_token_id), targets)
    return tokens, targets, mask
