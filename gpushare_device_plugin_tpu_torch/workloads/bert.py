"""BERT-style bidirectional encoder with a masked-LM head, in PyTorch.

Counterpart of ``gpushare_device_plugin_tpu/workloads/bert.py`` without the
mesh helpers (``param_specs``, ``param_shardings``, ``shard_params``):
post-LN encoder blocks over stacked layer weights (a Python loop, the
reference's ``lax.scan``), bf16 compute over f32 params, the MLM head
tied to the token embedding, and the training half (AdamW from
``optim.py``).

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
from .attention import flash_or_plain
from .optim import AdamW, make_optimizer as _make_adamw, tree_index, tree_leaves

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
) -> Params:
    """f32 params on ``device`` made from ``generator`` (which must live
    there), scaled as the reference's: normal / sqrt(d), ``wdown`` normal /
    sqrt(d_ff), layer-norm scale 1 and bias 0, the MLM output bias 0. The
    numbers differ from JAX's: tests move JAX weights across with
    ``convert.bert_from_jax_numpy``."""
    dev = resolve_device(device)

    def make(name, shape, parent):
        if parent.startswith("ln") or parent.endswith("_ln") or name == "out_bias":
            return torch.full(shape, 1.0 if name == "scale" else 0.0, device=dev)
        fan_in = cfg.d_ff if name == "wdown" else cfg.d_model
        w = torch.randn(shape, generator=generator, device=dev)
        return w.div_(math.sqrt(fan_in))

    def build(tree, parent=""):
        return {k: build(v, k) if isinstance(v, dict) else make(k, v, parent)
                for k, v in tree.items()}

    return build(param_shapes(cfg))


# --- model ------------------------------------------------------------------


def _layer_norm(x, p, eps=1e-6):
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _layer(x, lp, cfg: BertConfig):
    """One post-LN encoder block. x: [B, T, d]."""
    dt = cfg.compute_dtype
    qkv = torch.einsum("btd,dchn->btchn", x, lp["wqkv"].to(dt))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    attn = flash_or_plain(q, k, v, attention=cfg.attention, causal=False)
    x = _layer_norm(x + torch.einsum("bthn,hnd->btd", attn, lp["wo"].to(dt)), lp["ln1"])
    ff = _gelu(torch.einsum("btd,df->btf", x, lp["wi"].to(dt)))
    return _layer_norm(x + torch.einsum("btf,fd->btd", ff, lp["wdown"].to(dt)), lp["ln2"])


def forward(
    params: Params, tokens: torch.Tensor, cfg: BertConfig,
    segments: torch.Tensor | None = None,
) -> torch.Tensor:
    """tokens [B, S] -> contextual embeddings [B, S, d] in the compute dtype."""
    dt = cfg.compute_dtype
    S = tokens.shape[1]
    x = params["embed"].to(dt)[tokens]
    x = x + params["pos_embed"].to(dt)[:S][None]
    if segments is not None:
        x = x + params["seg_embed"].to(dt)[segments]
    x = _layer_norm(x, params["embed_ln"])
    layer = _layer
    if cfg.remat and torch.is_grad_enabled():
        layer = lambda *args: checkpoint(_layer, *args, use_reentrant=False)  # noqa: E731
    for i in range(cfg.n_layers):
        x = layer(x, tree_index(params["layers"], i), cfg)
    return x


def mlm_logits(params: Params, hidden: torch.Tensor, cfg: BertConfig) -> torch.Tensor:
    """[B, S, d] -> [B, S, vocab] f32 through the tied-embedding MLM head."""
    dt = cfg.compute_dtype
    h = _gelu(torch.einsum("btd,de->bte", hidden, params["mlm"]["dense"].to(dt)))
    h = _layer_norm(h, params["mlm"]["ln"])
    logits = torch.einsum("btd,vd->btv", h, params["embed"].to(dt))
    return logits.float() + params["mlm"]["out_bias"]


def loss_fn(params: Params, tokens, targets, mask, cfg: BertConfig) -> torch.Tensor:
    """Masked-LM cross-entropy over the positions where ``mask`` is 1."""
    logits = mlm_logits(params, forward(params, tokens, cfg), cfg)
    nll = F.cross_entropy(logits.flatten(0, 1), targets.flatten().long(), reduction="none")
    denom = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask.flatten()).sum() / denom


# --- training ---------------------------------------------------------------


def make_optimizer(lr: float = 1e-4, **kw) -> AdamW:
    """AdamW (+ clip, + warmup-cosine with ``total_steps=``): ``optim.py``."""
    return _make_adamw(lr, **kw)


def make_train_step(cfg: BertConfig, optimizer: AdamW | None = None) -> Callable:
    """``(params, opt_state, tokens, targets, mask) -> (params, opt_state,
    loss)``; params and the AdamW state update in place."""
    opt = optimizer or make_optimizer()

    def step(params, opt_state, tokens, targets, mask):
        loss = loss_fn(params, tokens, targets, mask, cfg)
        # seg_embed is unused without segments: its gradient is zero, as in JAX
        grads = torch.autograd.grad(loss, tree_leaves(params), materialize_grads=True)
        opt.update(grads, opt_state, params)
        return params, opt_state, loss.detach()

    return step


def init_train_state(
    cfg: BertConfig, generator: torch.Generator, optimizer: AdamW | None = None,
    device: str | torch.device | None = None,
) -> tuple[Params, dict[str, Any]]:
    """(params, opt_state) for :func:`make_train_step`; params require grad."""
    opt = optimizer or make_optimizer()
    params = init_params(cfg, generator, device=device)
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
