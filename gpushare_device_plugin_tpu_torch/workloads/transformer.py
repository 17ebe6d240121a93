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
(``torch.utils.checkpoint``). No sharding or LoRA here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .attention import flash_or_plain
from .optim import AdamW, make_optimizer, tree_leaves
from .quant import embed_lookup, is_qtensor, matmul_weight

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
    # flash forward then runs twice per layer per step); the reference's
    # "dots" (save the named projections) is not ported.
    remat: bool = True
    remat_policy: str = "full"

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
) -> Params:
    """Random weights scaled like the reference's ``init_params``
    (normal / sqrt(fan_in)), made on ``device`` from ``generator`` (which
    must live on that device). Matmul weights and the embedding are
    ``dtype``; norm gains are f32 ones. The numbers differ from JAX's
    for the same seed: tests move JAX weights across with
    ``convert.from_jax_numpy``."""
    dev = resolve_device(device)
    d, H, Dh, Fd, L = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.n_layers
    Hkv = cfg.kv_heads

    def norm(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
        return w.mul_(1.0 / math.sqrt(fan_in))

    return {
        "embed": norm((cfg.vocab, d), d),
        "layers": {
            "wq": norm((L, d, H, Dh), d),
            "wkv": norm((L, d, 2, Hkv, Dh), d),
            "wo": norm((L, H, Dh, d), d),
            "wi": norm((L, d, 2, Fd), d),
            "wdown": norm((L, Fd, d), Fd),
            "ln1": torch.ones((L, d), dtype=torch.float32, device=dev),
            "ln2": torch.ones((L, d), dtype=torch.float32, device=dev),
        },
        "final_norm": torch.ones((d,), dtype=torch.float32, device=dev),
        "out": norm((d, cfg.vocab), d),
    }


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


def _project_qkv(h, lp, cfg: TransformerConfig, positions):
    """ln1-normalized hidden -> RoPE'd (q [B,T,H,Dh], k, v [B,T,Hkv,Dh])."""
    dt = cfg.compute_dtype
    q = torch.einsum("btd,dhn->bthn", h, matmul_weight(lp["wq"], dt))
    kv = torch.einsum("btd,dchn->btchn", h, matmul_weight(lp["wkv"], dt))
    k, v = kv[:, :, 0], kv[:, :, 1]
    return _rope(q, positions, cfg.rope_theta), _rope(k, positions, cfg.rope_theta), v


def _mlp_block(x, lp, cfg: TransformerConfig):
    """Residual SwiGLU MLP (ln2 -> gate/up -> silu -> down)."""
    dt = cfg.compute_dtype
    h = _rms_norm(x, lp["ln2"])
    gate_up = torch.einsum("btd,dcf->btcf", h, matmul_weight(lp["wi"], dt))
    ff = F.silu(gate_up[:, :, 0]) * gate_up[:, :, 1]
    return x + torch.einsum("btf,fd->btd", ff, matmul_weight(lp["wdown"], dt))


def _attn_out(attn, lp, cfg: TransformerConfig):
    return torch.einsum("bthn,hnd->btd", attn, matmul_weight(lp["wo"], cfg.compute_dtype))


def _logits(params: Params, x, cfg: TransformerConfig):
    x = _rms_norm(x, params["final_norm"])
    out = matmul_weight(params["out"], cfg.compute_dtype)
    return torch.einsum("btd,dv->btv", x, out).float()


def _layer(x, lp, cfg: TransformerConfig, positions):
    """One decoder block."""
    q, k, v = _project_qkv(_rms_norm(x, lp["ln1"]), lp, cfg, positions)
    attn = flash_or_plain(q, k, v, attention=cfg.attention, causal=True)
    return _mlp_block(x + _attn_out(attn, lp, cfg), lp, cfg)


def _layer_fn(cfg: TransformerConfig) -> Callable:
    """The layer, wrapped for the backward as ``cfg.remat`` asks."""
    if not cfg.remat:
        return _layer
    if cfg.remat_policy != "full":
        raise ValueError(
            f"unknown remat_policy={cfg.remat_policy!r}: expected full "
            "(the reference's dots policy is not ported)"
        )
    if not torch.is_grad_enabled():
        return _layer  # nothing to save, nothing to recompute
    return lambda *args: checkpoint(_layer, *args, use_reentrant=False)


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, vocab] f32."""
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    layer = _layer_fn(cfg)
    x = embed_lookup(params["embed"], tokens, cfg.compute_dtype)
    for i in range(cfg.n_layers):
        x = layer(x, layer_params(params["layers"], i), cfg, positions)
    return _logits(params, x, cfg)


def loss_fn(params: Params, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """Next-token cross-entropy on the f32 logits, mean over [B, S-1]."""
    logits = forward(params, tokens, cfg)
    return F.cross_entropy(logits[:, :-1].flatten(0, 1), tokens[:, 1:].flatten().long())


# --- training (make_optimizer comes from optim.py) ---------------------------


def make_train_step(cfg: TransformerConfig, optimizer: AdamW | None = None,
                    accum_steps: int = 1) -> Callable:
    """Train step ``(params, opt_state, tokens) -> (params, opt_state,
    loss)``; params and optimizer state are updated in place.

    ``accum_steps > 1`` splits the batch into that many microbatches (the
    reference's strided split: microbatch i takes every accum_steps-th
    row) and sums their gradients before the one optimizer update: the
    full-batch step up to f32 summation order, at one microbatch's
    activation memory."""
    opt = optimizer or make_optimizer()
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def grads_of(params, tokens):
        loss = loss_fn(params, tokens, cfg)
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
        opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return step


def init_train_state(
    cfg: TransformerConfig, generator: torch.Generator,
    optimizer: AdamW | None = None, device: str | torch.device | None = None,
) -> tuple[Params, dict[str, Any]]:
    """(params, opt_state) for :func:`make_train_step`: f32 params made on
    ``device`` from ``generator`` (which must live there), held as the
    ``nn.Parameter``s of a trainable :class:`Decoder`."""
    opt = optimizer or make_optimizer()
    params = Decoder(init_params(cfg, generator, device=device), cfg, trainable=True).params
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
