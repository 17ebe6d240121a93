"""Raw decoder weights from ``--seed``, made on the device in bf16.

One ``torch.randn`` call per layer (its five matrices in one flat buffer),
one for the embedding and one for the output head, each from its own
generator seeded from ``(seed, part)``: the program's set-up and the plain
reference draw any part alone and get the same values. Scales follow the
port's ``init_params``: normal over ``sqrt(fan_in)``, norm gains one. The
layout is the port's stacked einsum layout, one layer's slice of it:
``wq [d, H, Dh]``, ``wkv [d, 2, Hkv, Dh]``, ``wo [H, Dh, d]``,
``wi [d, 2, F]``, ``wdown [F, d]``, ``embed [V, d]``, ``out [d, V]``.
"""

from __future__ import annotations

import hashlib
import math

import torch

LAYER_LEAVES = ("wq", "wkv", "wo", "wi", "wdown")


def model_dims(cfg: dict) -> dict:
    """The sizes a configuration file states, under short names."""
    d = int(cfg["hidden_size"])
    heads = int(cfg["num_attention_heads"])
    return {
        "d": d, "H": heads, "Hkv": int(cfg.get("num_key_value_heads") or heads),
        "Dh": int(cfg.get("head_dim") or d // heads), "F": int(cfg["intermediate_size"]),
        "L": int(cfg["num_hidden_layers"]), "V": int(cfg["vocab_size"]),
        "theta": float(cfg["rope_theta"]), "eps": float(cfg["rms_norm_eps"]),
    }


def layer_shapes(m: dict) -> dict[str, tuple[int, ...]]:
    d, H, Hkv, Dh, F = m["d"], m["H"], m["Hkv"], m["Dh"], m["F"]
    return {"wq": (d, H, Dh), "wkv": (d, 2, Hkv, Dh), "wo": (H, Dh, d),
            "wi": (d, 2, F), "wdown": (F, d)}


def fan_in(name: str, m: dict) -> int:
    return m["F"] if name == "wdown" else m["d"]


def part_seed(seed: int, part: str) -> int:
    """A 63-bit generator seed for one part of the weights."""
    digest = hashlib.sha256(f"{int(seed)}/{part}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _normal(numel: int, seed: int, part: str, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(part_seed(seed, part))
    return torch.randn(numel, generator=gen, device=device, dtype=torch.bfloat16)


def draw_layer(m: dict, seed: int, layer: int, device) -> dict[str, torch.Tensor]:
    """Layer ``layer``'s five matrices, views into one bf16 buffer."""
    shapes = layer_shapes(m)
    flat = _normal(sum(math.prod(s) for s in shapes.values()), seed, f"layer{layer}", device)
    out, at = {}, 0
    for name in LAYER_LEAVES:
        n = math.prod(shapes[name])
        out[name] = flat[at:at + n].view(shapes[name]).mul_(1.0 / math.sqrt(fan_in(name, m)))
        at += n
    return out


def draw_embed(m: dict, seed: int, device) -> torch.Tensor:
    return _normal(m["V"] * m["d"], seed, "embed", device).view(m["V"], m["d"]).mul_(
        1.0 / math.sqrt(m["d"]))


def draw_out(m: dict, seed: int, device) -> torch.Tensor:
    return _normal(m["d"] * m["V"], seed, "out", device).view(m["d"], m["V"]).mul_(
        1.0 / math.sqrt(m["d"]))
