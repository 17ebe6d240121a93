"""JAX decoder weights -> the port's params tree, by value.

The reference's tree, turned into numpy arrays (``np.asarray`` on every
leaf), has the same stacked layout as the port's (``transformer.py``), so
conversion is a copy per leaf: no reshape, no transpose. Quantized leaves
(``{"q8", "scale"}`` dicts) cross as int8 and f32. bfloat16 arrays, which
numpy holds as the 2-byte ``ml_dtypes`` type, cross bit for bit.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..device import resolve_device
from .quant import is_qtensor
from .transformer import Params, TransformerConfig

_NORMS = ("ln1", "ln2", "final_norm")


def _expected_shapes(cfg: TransformerConfig) -> dict[str, tuple[int, ...]]:
    d, H, Dh, F, L = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.n_layers
    return {
        "embed": (cfg.vocab, d),
        "wq": (L, d, H, Dh),
        "wkv": (L, d, 2, cfg.kv_heads, Dh),
        "wo": (L, H, Dh, d),
        "wi": (L, d, 2, F),
        "wdown": (L, F, d),
        "ln1": (L, d),
        "ln2": (L, d),
        "final_norm": (d,),
        "out": (d, cfg.vocab),
    }


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")  # writable, contiguous
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_jax_numpy(
    tree: Mapping[str, Any],
    cfg: TransformerConfig,
    *,
    device: str | torch.device | None = None,
    dtype: torch.dtype | None = None,
) -> Params:
    """Convert a reference params tree of numpy arrays to the port's tree
    on ``device``. ``dtype`` (optional) casts the full-precision matmul
    weights and the embedding, as ``quant.cast_decoder`` would; norm gains
    and quantized leaves keep their types. Shapes are checked against
    ``cfg``."""
    dev = resolve_device(device)
    shapes = _expected_shapes(cfg)

    def leaf(name: str, val: Any):
        if is_qtensor(val):
            q8 = _tensor(val["q8"], dev)
            if tuple(q8.shape) != shapes[name]:
                raise ValueError(f"{name}: shape {tuple(q8.shape)} != {shapes[name]}")
            return {"q8": q8, "scale": _tensor(val["scale"], dev).float()}
        t = _tensor(val, dev)
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shapes[name]}")
        if dtype is not None and name not in _NORMS:
            t = t.to(dtype)
        return t

    return {
        "embed": leaf("embed", tree["embed"]),
        "layers": {name: leaf(name, val) for name, val in tree["layers"].items()},
        "final_norm": leaf("final_norm", tree["final_norm"]),
        "out": leaf("out", tree["out"]),
    }
