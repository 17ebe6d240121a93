"""JAX weights -> the port's params trees, by value.

The reference's trees, turned into numpy arrays (``np.asarray`` on every
leaf), have the port's layouts, so conversion is a copy per leaf, checked
against the shapes the port's config gives: the decoder
(:func:`from_jax_numpy`; quantized ``{"q8", "scale"}`` leaves cross as
int8 and f32), its LoRA adapters (:func:`lora_from_jax_numpy`), BERT
(:func:`bert_from_jax_numpy`) and the MNIST MLP
(:func:`mnist_from_jax_numpy`). The one transpose is ResNet's
(:func:`resnet_from_jax_numpy`): convolution kernels cross from the
reference's HWIO to PyTorch's OIHW, its BN state with them. bfloat16
arrays, which numpy holds as the 2-byte ``ml_dtypes`` type, cross bit for
bit.

HF-Llama state dicts (``model.layers.{i}.self_attn.q_proj.weight``, each
a ``[out, in]`` matrix) cross both ways with :func:`from_hf_llama` and
:func:`to_hf_llama`: names, reshapes and transposes only, as the
reference's (the RoPE pairs are HF's "rotate_half" layout, so no
permutation).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..device import resolve_device
from . import bert as B
from . import lora as La
from . import mnist as M
from . import resnet as R
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


def _copy_tree(tree: Mapping[str, Any], shapes: Mapping[str, Any], dev: torch.device,
               prefix: str = "", transform=None) -> Params:
    """``tree`` (numpy leaves) as tensors on ``dev`` in the nesting of
    ``shapes``, each leaf passed through ``transform`` (if any) and then
    checked against its shape there."""
    if set(tree) != set(shapes):
        raise ValueError(f"{prefix or 'tree'}: keys {sorted(tree)} != {sorted(shapes)}")
    out = {}
    for key, want in shapes.items():
        name = f"{prefix}{key}"
        if isinstance(want, dict):
            out[key] = _copy_tree(tree[key], want, dev, name + ".", transform)
            continue
        t = _tensor(tree[key], dev)
        if transform is not None:
            t = transform(t)
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(want)}")
        out[key] = t.contiguous()
    return out


def bert_from_jax_numpy(
    tree: Mapping[str, Any], cfg: B.BertConfig, *, device: str | torch.device | None = None,
) -> Params:
    """A reference BERT params tree of numpy arrays as the port's tree on
    ``device``; the layouts are the same, shapes are checked against
    ``cfg``."""
    return _copy_tree(tree, B.param_shapes(cfg), resolve_device(device))


def _hwio_to_oihw(t: torch.Tensor) -> torch.Tensor:
    """Convolution kernels ``[(L,) kh, kw, cin, cout]`` -> ``[(L,) cout, cin,
    kh, kw]``; other leaves unchanged."""
    if t.dim() == 4:
        return t.permute(3, 2, 0, 1)
    if t.dim() == 5:
        return t.permute(0, 4, 3, 1, 2)
    return t


def resnet_from_jax_numpy(
    params: Mapping[str, Any], state: Mapping[str, Any], cfg: R.ResNetConfig, *,
    device: str | torch.device | None = None,
) -> tuple[Params, Params]:
    """A reference ResNet (params, BN state) pair of numpy trees as the
    port's on ``device``: convolution kernels HWIO -> OIHW, the rest as
    they are; shapes are checked against ``cfg``."""
    dev = resolve_device(device)
    pshapes, sshapes = R.param_shapes(cfg)
    return (_copy_tree(params, pshapes, dev, transform=_hwio_to_oihw),
            _copy_tree(state, sshapes, dev))


def lora_from_jax_numpy(
    tree: Mapping[str, Any], cfg: TransformerConfig, lcfg: La.LoraConfig, *,
    device: str | torch.device | None = None,
) -> Params:
    """A reference LoRA adapter tree of numpy arrays as the port's on
    ``device``: exactly ``lcfg.targets``, each ``{"a", "b"}`` checked
    against its shape for ``cfg`` and ``lcfg``."""
    return _copy_tree(tree, La.target_shapes(cfg, lcfg), resolve_device(device))


def mnist_from_jax_numpy(
    tree: Mapping[str, Any], hidden: int = 128, *, device: str | torch.device | None = None,
) -> Params:
    """A reference MNIST MLP params tree of numpy arrays as the port's on
    ``device``; shapes are checked against ``hidden``."""
    shapes = {"w1": (M.IMAGE_DIM, hidden), "b1": (hidden,),
              "w2": (hidden, M.N_CLASSES), "b2": (M.N_CLASSES,)}
    return _copy_tree(tree, shapes, resolve_device(device))


def _hf_names(i: int) -> dict[str, str]:
    p = f"model.layers.{i}."
    return {
        "wq": p + "self_attn.q_proj.weight",
        "wk": p + "self_attn.k_proj.weight",
        "wv": p + "self_attn.v_proj.weight",
        "wo": p + "self_attn.o_proj.weight",
        "wgate": p + "mlp.gate_proj.weight",
        "wup": p + "mlp.up_proj.weight",
        "wdown": p + "mlp.down_proj.weight",
        "ln1": p + "input_layernorm.weight",
        "ln2": p + "post_attention_layernorm.weight",
    }


def from_hf_llama(
    state: Mapping[str, Any], cfg: TransformerConfig, *,
    device: str | torch.device | None = None,
) -> Params:
    """An HF-Llama name -> matrix mapping (torch tensors or numpy arrays,
    ``[out, in]`` each) as the port's decoder tree, f32 on ``device``:
    ``model.embed_tokens.weight``, ``model.layers.{i}.*`` for each of
    ``cfg``'s layers, ``model.norm.weight`` and ``lm_head.weight``. Raises
    KeyError with the missing name when the mapping lacks one."""
    dev = resolve_device(device)
    d, H, Dh, Hkv, L = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.kv_heads, cfg.n_layers

    def arr(name: str) -> torch.Tensor:
        val = state[name]
        t = val.detach() if isinstance(val, torch.Tensor) else _tensor(np.asarray(val), dev)
        return t.to(dev, torch.float32)

    layers: dict[str, list] = {k: [] for k in ("wq", "wkv", "wo", "wi", "wdown", "ln1", "ln2")}
    for i in range(L):
        n = _hf_names(i)
        layers["wq"].append(arr(n["wq"]).reshape(H, Dh, d).permute(2, 0, 1))  # [d, H, Dh]
        wk = arr(n["wk"]).reshape(Hkv, Dh, d).permute(2, 0, 1)
        wv = arr(n["wv"]).reshape(Hkv, Dh, d).permute(2, 0, 1)
        layers["wkv"].append(torch.stack([wk, wv], dim=1))  # [d, 2, Hkv, Dh]
        layers["wo"].append(arr(n["wo"]).reshape(d, H, Dh).permute(1, 2, 0))  # [H, Dh, d]
        layers["wi"].append(torch.stack([arr(n["wgate"]).T, arr(n["wup"]).T], dim=1))  # [d, 2, F]
        layers["wdown"].append(arr(n["wdown"]).T)  # [F, d]
        layers["ln1"].append(arr(n["ln1"]))
        layers["ln2"].append(arr(n["ln2"]))
    return {
        "embed": arr("model.embed_tokens.weight").contiguous(),
        "layers": {k: torch.stack(v).contiguous() for k, v in layers.items()},
        "final_norm": arr("model.norm.weight").contiguous(),
        "out": arr("lm_head.weight").T.contiguous(),  # [V, d] -> [d, V]
    }


def to_hf_llama(params: Params, cfg: TransformerConfig) -> dict[str, torch.Tensor]:
    """The exact inverse of :func:`from_hf_llama`: the HF-Llama state dict
    of a decoder tree, contiguous f32 tensors on the host."""
    d, H, Dh, Hkv, L = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.kv_heads, cfg.n_layers

    def host(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu", torch.float32).contiguous()

    lp = params["layers"]
    out = {
        "model.embed_tokens.weight": host(params["embed"]),
        "model.norm.weight": host(params["final_norm"]),
        "lm_head.weight": host(params["out"].T),
    }
    for i in range(L):
        n = _hf_names(i)
        out[n["wq"]] = host(lp["wq"][i].permute(1, 2, 0).reshape(H * Dh, d))
        out[n["wk"]] = host(lp["wkv"][i, :, 0].permute(1, 2, 0).reshape(Hkv * Dh, d))
        out[n["wv"]] = host(lp["wkv"][i, :, 1].permute(1, 2, 0).reshape(Hkv * Dh, d))
        out[n["wo"]] = host(lp["wo"][i].permute(2, 0, 1).reshape(d, H * Dh))
        out[n["wgate"]] = host(lp["wi"][i, :, 0].T)
        out[n["wup"]] = host(lp["wi"][i, :, 1].T)
        out[n["wdown"]] = host(lp["wdown"][i].T)
        out[n["ln1"]] = host(lp["ln1"][i])
        out[n["ln2"]] = host(lp["ln2"][i])
    return out
