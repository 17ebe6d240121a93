"""LoRA adapters for the decoder: low-rank fine-tuning, and the flat
layout the multi-LoRA serving engine pages.

Counterpart of ``gpushare_device_plugin_tpu/workloads/lora.py``. Per
target weight ``W`` an adapter holds ``A [L, *in, r]`` and ``B [L, r,
*out]``, stacked over the layers like every weight of the decoder, and
the adapted weight is ``W + (alpha / r) * A @ B``:

- ``B`` starts at zero, so a fresh adapter is exactly the base model.
- Training merges the adapter into the frozen base on every step
  (:func:`lora_loss_fn`); gradients reach only the adapter, and the
  optimizer state is adapter-sized (:func:`make_lora_train_step`).
- Serving either merges one adapter into the weights
  (:func:`merge_lora`), or keeps many adapters as flat f32 vectors
  (:func:`flatten_lora`) striped across the pages of the paged engine's
  slab, which every dispatch gathers per row, a layer at a time
  (``generate.lora_bgmv_views``). On a tp mesh the flat vector is the
  rank's view (:func:`lora_tp_shard`): the ``B`` slices of its
  column-parallel targets, the ``A`` slices of its row-parallel ones,
  and the rest whole.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..device import resolve_device
from .optim import AdamW, make_optimizer, tree_leaves
from .transformer import TransformerConfig, loss_fn

Params = dict[str, Any]

# target -> (A's shape suffix on the contraction side, B's on the output
# side), relative to the stacked [L, ...] layer weights of init_params
_TARGET_SHAPES = {
    "wq": (("d",), ("H", "Dh")),
    "wkv": (("d",), ("two", "Hkv", "Dh")),
    "wo": (("H", "Dh"), ("d",)),
    "wi": (("d",), ("two", "F")),
    "wdown": (("F",), ("d",)),
}

# target -> (the factor cut over tp, its dim in the [L, ...] tree): B's
# output heads or width for the column-parallel projections, A's input
# for the row-parallel ones (transformer.param_specs).
_TP_CUT = {"wq": ("b", 2), "wkv": ("b", 3), "wi": ("b", 3), "wo": ("a", 1), "wdown": ("a", 1)}


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    # which layer projections get adapters; any subset of _TARGET_SHAPES
    targets: tuple[str, ...] = ("wq", "wo")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _dims(cfg: TransformerConfig) -> dict[str, int]:
    return {
        "d": cfg.d_model, "H": cfg.n_heads, "Dh": cfg.head_dim,
        "Hkv": cfg.kv_heads, "F": cfg.d_ff, "two": 2,
    }


def _check(lcfg: LoraConfig) -> None:
    if lcfg.rank < 1:
        raise ValueError(f"rank must be >= 1, got {lcfg.rank}")
    if len(set(lcfg.targets)) != len(lcfg.targets):
        raise ValueError(f"duplicate LoRA targets in {lcfg.targets}")
    for name in lcfg.targets:
        if name not in _TARGET_SHAPES:
            raise ValueError(
                f"unknown LoRA target {name!r}: expected one of "
                f"{sorted(_TARGET_SHAPES)}"
            )


def target_shapes(cfg: TransformerConfig, lcfg: LoraConfig) -> dict[str, dict[str, tuple]]:
    """``{target: {"a": [L, *in, r], "b": [L, r, *out]}}`` shapes."""
    _check(lcfg)
    dims = _dims(cfg)
    L, r = cfg.n_layers, lcfg.rank
    out = {}
    for name in lcfg.targets:
        in_names, out_names = _TARGET_SHAPES[name]
        out[name] = {
            "a": (L, *(dims[n] for n in in_names), r),
            "b": (L, r, *(dims[n] for n in out_names)),
        }
    return out


def init_lora(
    cfg: TransformerConfig, lcfg: LoraConfig, generator: torch.Generator,
    device: str | torch.device | None = None,
) -> Params:
    """Adapter tree ``{target: {"a": [L, *in, r], "b": [L, r, *out]}}``,
    f32 on ``device`` (which ``generator`` must live on): ``a`` normal /
    sqrt(fan_in), ``b`` zeros, so the merged model starts exactly at the
    base weights. The numbers differ from JAX's for the same seed."""
    dev = resolve_device(device)
    out = {}
    for name, shp in target_shapes(cfg, lcfg).items():
        fan_in = 1
        for s in shp["a"][1:-1]:
            fan_in *= s
        a = torch.randn(shp["a"], generator=generator, device=dev, dtype=torch.float32)
        out[name] = {
            "a": a.div_(fan_in ** 0.5),
            "b": torch.zeros(shp["b"], dtype=torch.float32, device=dev),
        }
    return out


def _delta(a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """``scale * A @ B`` over the rank dim, in the ``[L, *in, *out]``
    layout of the stacked base weight."""
    L, r = a.shape[0], a.shape[-1]
    d = torch.einsum("lir,lro->lio", a.reshape(L, -1, r), b.reshape(L, r, -1)) * scale
    return d.reshape(*a.shape[:-1], *b.shape[2:])


def merge_lora(params: Params, lora: Params, lcfg: LoraConfig) -> Params:
    """Base params plus the adapter's deltas: each target weight in f32
    plus its delta, cast back to the weight's dtype. Every other leaf is
    the same tensor object, not a copy. The deltas are made a layer at a
    time, so the f32 transient is one layer's, not the stack's."""
    layers = dict(params["layers"])
    for name, ab in lora.items():
        w = layers[name]
        layers[name] = torch.stack([
            (w[i].float() + _delta(ab["a"][i : i + 1], ab["b"][i : i + 1], lcfg.scale)[0])
            .to(w.dtype)
            for i in range(w.shape[0])
        ])
    return {**params, "layers": layers}


def _detach(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach()


def lora_loss_fn(
    lora: Params, params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
    lcfg: LoraConfig,
) -> torch.Tensor:
    """Next-token loss of the merged model, differentiable in ``lora``
    only: the base rides through detached."""
    return loss_fn(merge_lora(_detach(params), lora, lcfg), tokens, cfg)


def make_lora_train_step(
    cfg: TransformerConfig, lcfg: LoraConfig, optimizer: AdamW | None = None,
    lr: float = 1e-3,
) -> tuple[Callable, Callable]:
    """``(step, init_opt_state)`` for adapter-only training, returned
    together so a custom optimizer is never paired with another's state.

    ``step(params, lora, opt_state, tokens) -> (lora, opt_state, loss)``
    updates the adapter and its AdamW state in place; the base ``params``
    are frozen (never updated, never given a gradient). The adapter's
    leaves are made to require grad on the first step."""
    opt = optimizer or make_optimizer(lr)

    def step(params, lora, opt_state, tokens):
        leaves = tree_leaves(lora)
        for t in leaves:
            if not t.requires_grad:
                t.requires_grad_()
        loss = lora_loss_fn(lora, params, tokens, cfg, lcfg)
        grads = torch.autograd.grad(loss, leaves)
        opt.update(list(grads), opt_state, lora)
        return lora, opt_state, loss.detach()

    return step, opt.init


def lora_param_count(lora: Params) -> int:
    return sum(t.numel() for t in tree_leaves(lora))


# --- the flat layout the paged serving engine stores -------------------------
# One adapter is one flat f32 vector: targets in lcfg.targets order, each
# target's ``a`` then ``b``, in C order. unflatten_lora's views are then in
# the layout _delta contracts, so the serving path's per-row deltas are
# the ones merge_lora bakes into the weights.


def _tp(mesh) -> int:
    return 1 if mesh is None else mesh.shape["tp"]


def _cut_over_tp(cfg: TransformerConfig, name: str, tp: int) -> bool:
    """Whether target ``name``'s tp factor is cut (``wkv`` only when tp
    divides the kv heads, as the weight itself)."""
    return tp > 1 and not (name == "wkv" and cfg.kv_heads % tp)


def _target_flat_dims(cfg: TransformerConfig, name: str, tp: int = 1) -> tuple[int, int]:
    """(fan-in, fan-out) of one target's projection, flattened, as a tp
    rank holds it."""
    dims = _dims(cfg)
    in_names, out_names = _TARGET_SHAPES[name]
    fi = fo = 1
    for n in in_names:
        fi *= dims[n]
    for n in out_names:
        fo *= dims[n]
    if _cut_over_tp(cfg, name, tp):
        if _TP_CUT[name][0] == "b":
            fo //= tp
        else:
            fi //= tp
    return fi, fo


def lora_flat_len(cfg: TransformerConfig, lcfg: LoraConfig, mesh=None) -> int:
    """Float count of one adapter in the flat layout (a tp rank's view on
    a ``mesh``)."""
    L, r = cfg.n_layers, lcfg.rank
    total = 0
    for name in lcfg.targets:
        fi, fo = _target_flat_dims(cfg, name, _tp(mesh))
        total += L * fi * r + L * r * fo
    return total


def lora_tp_shard(lora: Params, cfg: TransformerConfig, mesh) -> Params:
    """This tp rank's view of an adapter tree: each target's tp factor
    (:data:`_TP_CUT`) narrowed to the rank's block, the other whole."""
    tp = _tp(mesh)
    if tp == 1:
        return lora
    out = {}
    for name, ab in lora.items():
        ab = dict(ab)
        if _cut_over_tp(cfg, name, tp):
            which, dim = _TP_CUT[name]
            n = ab[which].shape[dim] // tp
            ab[which] = ab[which].narrow(dim, mesh.axis_index("tp") * n, n)
        out[name] = ab
    return out


def flatten_lora(lora: Params, cfg: TransformerConfig, lcfg: LoraConfig,
                 mesh=None) -> torch.Tensor:
    """One adapter tree -> its flat f32 vector ``[lora_flat_len]`` (on a
    tp ``mesh``, of the rank's view); raises on a tree missing a
    configured target (a half-loaded adapter fails at load, not at
    decode)."""
    parts = []
    for name in lcfg.targets:
        if name not in lora:
            raise ValueError(
                f"adapter tree has no {name!r} entry but lcfg.targets="
                f"{lcfg.targets}"
            )
    lora = lora_tp_shard({name: lora[name] for name in lcfg.targets}, cfg, mesh)
    for name in lcfg.targets:
        ab = lora[name]
        parts.append(ab["a"].detach().float().reshape(-1))
        parts.append(ab["b"].detach().float().reshape(-1))
    return torch.cat(parts)


def lora_layer_spans(
    cfg: TransformerConfig, lcfg: LoraConfig, layer: int, mesh=None,
) -> dict[str, tuple[tuple[int, tuple[int, int]], tuple[int, tuple[int, int]]]]:
    """Where layer ``layer``'s part of each target sits in the flat layout
    (:func:`unflatten_lora`'s, a tp rank's view on a ``mesh``): ``{target:
    ((offset of a, (fi, r)), (offset of b, (r, fo)))}``, each a contiguous
    run of floats."""
    L, r = cfg.n_layers, lcfg.rank
    out = {}
    off = 0
    for name in lcfg.targets:
        fi, fo = _target_flat_dims(cfg, name, _tp(mesh))
        na, nb = L * fi * r, L * r * fo
        out[name] = ((off + layer * fi * r, (fi, r)), (off + na + layer * r * fo, (r, fo)))
        off += na + nb
    return out


def unflatten_lora(
    flat: torch.Tensor, cfg: TransformerConfig, lcfg: LoraConfig, mesh=None,
) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """Flat vector(s) -> ``{target: (a [..., L, fi, r], b [..., L, r,
    fo])}`` views, the in/out dims flattened (a tp rank's view's dims on a
    ``mesh``). Leading dims ride through, so a gathered ``[B, F]`` slab
    read gives per-row views."""
    L, r = cfg.n_layers, lcfg.rank
    lead = flat.shape[:-1]
    out = {}
    off = 0
    for name in lcfg.targets:
        fi, fo = _target_flat_dims(cfg, name, _tp(mesh))
        na, nb = L * fi * r, L * r * fo
        a = flat[..., off : off + na].reshape(*lead, L, fi, r)
        off += na
        b = flat[..., off : off + nb].reshape(*lead, L, r, fo)
        off += nb
        out[name] = (a, b)
    return out
