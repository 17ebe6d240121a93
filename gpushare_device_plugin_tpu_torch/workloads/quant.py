"""Weight-only int8 quantization and int8 KV, in PyTorch.

Counterpart of ``gpushare_device_plugin_tpu/workloads/quant.py``, same
scheme: symmetric per-output-channel int8, ``scale = max|w| / 127``
reduced over the matmul's contraction axes (keepdims), ``q8 =
clip(round(w / scale), -127, 127)``. ``torch.round`` rounds half to even,
as ``jnp.round`` does. A quantized tensor is the dict ``{"q8", "scale"}``;
norm gains stay f32.

The KV cache uses the same recipe per (token, head) over the head dim.
"""

from __future__ import annotations

from typing import Any

import torch

Params = dict[str, Any]

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
    return (qt["q8"].float() * qt["scale"]).to(dtype)


def quantize_decoder(params: Params) -> Params:
    """Layer matmul weights and the embed/out projections go int8 (embed
    per row, out per vocab column); norm gains stay f32."""
    layers = {
        name: w if name in _KEEP_FP else quantize(w, _LAYER_AXES[name])
        for name, w in params["layers"].items()
    }
    return {
        "embed": quantize(params["embed"], (1,)),
        "layers": layers,
        "final_norm": params["final_norm"],
        "out": quantize(params["out"], (0,)),
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


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., Dh] -> (q8 [..., Dh] int8, scale [...] f32), one scale per
    (..., token, head)."""
    qt = quantize(x, (-1,))
    return qt["q8"], qt["scale"][..., 0]


def dequantize_kv(q8: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q8.float() * scale[..., None]).to(dtype)


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
