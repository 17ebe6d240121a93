"""Weight-only int8 quantization and int8 KV, in PyTorch.

Counterpart of ``gpushare_device_plugin_tpu/workloads/quant.py``, same
scheme: symmetric per-output-channel int8, ``scale = max|w| / 127``
reduced over the matmul's contraction axes (keepdims), ``q8 =
clip(round(w / scale), -127, 127)``. ``torch.round`` rounds half to even,
as ``jnp.round`` does. A quantized tensor is the dict ``{"q8", "scale"}``;
norm gains stay f32.

The KV cache uses the same recipe per (token, head) over the head dim.

Under XLA the reference's dequantize fuses into the consuming matmul's
operand read. Here nothing fuses, so a whole dequantized weight would be
a transient copy: the Llama-3-8B head's alone is 2.1 GB in f32 and 1.05
GB in bf16, more than a pod sized by the reference's slice plan has left
(``ROADMAP.md`` §3 fault 10). :func:`qmatmul` therefore dequantizes a
block of output channels at a time, straight into the compute dtype, and
multiplies it; :func:`quantize_decoder` quantizes one layer (or one block
of embedding rows or head columns) at a time. :data:`DEQUANT_BLOCK`
bounds the elements of a block, and ``generate.py`` bounds the int8 KV
cache's dequantized rows by it too.
"""

from __future__ import annotations

import math
from typing import Any

import torch

Params = dict[str, Any]

# Elements dequantized (or quantized) at once: 2^25, a 64 MiB bf16 block.
DEQUANT_BLOCK = 1 << 25

# Contraction axes per stacked layer weight (axis 0 is the layer axis).
_LAYER_AXES = {
    "wq": (1,),      # [L, d, H, Dh] contracts d
    "wkv": (1,),     # [L, d, 2, Hkv, Dh] contracts d
    "wo": (1, 2),    # [L, H, Dh, d] contracts (H, Dh)
    "wi": (1,),      # [L, d, 2, F] contracts d
    "wdown": (1,),   # [L, F, d] contracts F
}
_KEEP_FP = ("ln1", "ln2")


def quantize(w: torch.Tensor, axes: tuple[int, ...]) -> Params:
    """Symmetric int8 with a per-channel scale over ``axes`` (keepdims)."""
    amax = w.float().abs().amax(dim=axes, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q8 = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q8": q8, "scale": scale.float()}


def is_qtensor(x: Any) -> bool:
    return isinstance(x, dict) and set(x) == {"q8", "scale"}


def dequantize(qt: Params, dtype=torch.float32) -> torch.Tensor:
    """``(q8.float() * scale).to(dtype)`` in one pass: int8 times an f32
    scale is computed in f32 and rounded to ``dtype`` as it is stored, so
    no f32 copy of the tensor is made."""
    q8, scale = qt["q8"], qt["scale"]
    out = torch.empty(torch.broadcast_shapes(q8.shape, scale.shape), dtype=dtype,
                      device=q8.device)
    return torch.mul(q8, scale, out=out)


def _quantize_in_slices(w: torch.Tensor, axes: tuple[int, ...], dim: int) -> Params:
    """``quantize(w, axes)`` computed over slices of ``w`` along ``dim``, a
    dim not in ``axes``, of at most :data:`DEQUANT_BLOCK` elements (one
    index of ``dim`` if that is larger): no scale reduces across ``dim``,
    so the codes and scales are the whole call's, and its f32
    temporaries are one slice's."""
    out = {
        "q8": torch.empty(w.shape, dtype=torch.int8, device=w.device),
        "scale": torch.empty([1 if a in axes else n for a, n in enumerate(w.shape)],
                             dtype=torch.float32, device=w.device),
    }
    step = max(1, DEQUANT_BLOCK * w.shape[dim] // max(w.numel(), 1))
    for lo in range(0, w.shape[dim], step):
        n = min(step, w.shape[dim] - lo)
        part = quantize(w.narrow(dim, lo, n), axes)
        for key, val in part.items():
            out[key].narrow(dim, lo, n).copy_(val)
    return out


def quantize_leaf(name: str, w: torch.Tensor) -> Params:
    """One decoder weight's int8 form as :func:`quantize_decoder` gives it:
    ``"embed"`` per row, ``"out"`` per vocab column, a stacked layer
    weight (``"wq"``, ``"wkv"``, ``"wo"``, ``"wi"``, ``"wdown"``) per output
    channel of each layer, computed a layer (or a block of rows or
    columns) at a time."""
    if name == "embed":
        return _quantize_in_slices(w, (1,), 0)
    if name == "out":
        return _quantize_in_slices(w, (0,), 1)
    return _quantize_in_slices(w, _LAYER_AXES[name], 0)


def quantize_decoder(params: Params) -> Params:
    """Layer matmul weights and the embed/out projections go int8 (embed
    per row, out per vocab column); norm gains stay f32. Each leaf is
    quantized a slice at a time (:func:`quantize_leaf`), so a whole f32
    copy of a leaf never exists."""
    layers = {
        name: w if name in _KEEP_FP else quantize_leaf(name, w)
        for name, w in params["layers"].items()
    }
    return {
        "embed": quantize_leaf("embed", params["embed"]),
        "layers": layers,
        "final_norm": params["final_norm"],
        "out": quantize_leaf("out", params["out"]),
    }


def cast_decoder(params: Params, dtype=torch.bfloat16) -> Params:
    """Serving-precision copy: matmul weights and embeddings in ``dtype``,
    norm gains kept f32."""
    layers = {
        name: w if name in _KEEP_FP else w.to(dtype)
        for name, w in params["layers"].items()
    }
    return {
        "embed": params["embed"].to(dtype),
        "layers": layers,
        "final_norm": params["final_norm"],
        "out": params["out"].to(dtype),
    }


def dequantize_tree(tree: Any, dtype=torch.float32) -> Any:
    """The tree with every quantized tensor replaced by its full-precision
    values in ``dtype``; other leaves as they are."""
    if is_qtensor(tree):
        return dequantize(tree, dtype)
    if isinstance(tree, dict):
        return {k: dequantize_tree(v, dtype) for k, v in tree.items()}
    return tree


def param_bytes(tree: Any) -> int:
    """The bytes of a tree's tensors (dicts, lists and tuples of them); a
    quantized tensor counts its int8 values and its f32 scales."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(param_bytes(v) for v in tree)
    return 0


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., Dh] -> (q8 [..., Dh] int8, scale [...] f32), one scale per
    (..., token, head)."""
    qt = quantize(x, (-1,))
    return qt["q8"], qt["scale"][..., 0]


def dequantize_kv(q8: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """``(q8.float() * scale[..., None]).to(dtype)``, as :func:`dequantize`."""
    return dequantize({"q8": q8, "scale": scale[..., None]}, dtype)


def embed_lookup(embed: Any, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Embedding gather. Quantized tables gather int8 rows and their
    scales, then dequantize; fp tables are cast, then gathered."""
    if is_qtensor(embed):
        rows = embed["q8"][tokens].float()
        return (rows * embed["scale"][tokens]).to(dtype)
    return embed.to(dtype)[tokens]


def matmul_weight(w: Any, dtype) -> torch.Tensor:
    """A (possibly quantized) matmul operand in the compute dtype."""
    if is_qtensor(w):
        return dequantize(w, dtype)
    return w.to(dtype)


def qmatmul(x: torch.Tensor, qt: Params, n_in: int, dtype) -> torch.Tensor:
    """``x [..., *in] @ dequantize(qt, dtype) [*in, *out] -> [..., *out]``
    for a quantized weight whose first ``n_in`` dims contract (its scales
    are 1 there). The weight's output channels are dequantized a block of
    columns at a time, each holding at most :data:`DEQUANT_BLOCK`
    elements (one column if a column is larger), and each block is
    multiplied as soon as it exists: every element is
    :func:`dequantize`'s before its product, and no whole dequantized
    copy of the weight is made."""
    q8, scale = qt["q8"], qt["scale"]
    k = math.prod(q8.shape[:n_in])
    n = math.prod(q8.shape[n_in:])
    q8, scale = q8.reshape(k, n), scale.reshape(1, n)
    x2 = x.reshape(-1, k)
    cols = max(1, DEQUANT_BLOCK // k)
    parts = [
        x2 @ dequantize({"q8": q8[:, lo:lo + cols], "scale": scale[:, lo:lo + cols]}, dtype)
        for lo in range(0, n, cols)
    ]
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    return out.reshape(*x.shape[:x.dim() - n_in], *qt["q8"].shape[n_in:])
