"""ResNet-50 image classifier, in PyTorch.

Counterpart of ``gpushare_device_plugin_tpu/workloads/resnet.py`` without
the mesh helpers (``param_specs``, ``param_shardings``, ``shard_params``):
the config, params and batch-norm state, ``forward``, ``loss_fn`` and the
training half (SGD with Nesterov momentum).

Layout: the port's images are the reference's ``[B, H, W, 3]``; the model
runs them as an NCHW view of that memory, which is PyTorch's channels-last
format, the one cuDNN's tensor-core convolutions take. Convolution
weights are OIHW (``[cout, cin, kh, kw]``; ``convert.resnet_from_jax_numpy``
transposes the reference's HWIO). A stage's shape-identical tail blocks
keep the reference's stacking on a leading axis and run as a Python loop
over it (the reference's ``lax.scan``).

Where PyTorch's defaults differ from JAX's, this follows JAX:

- ``padding="SAME"`` pads ``(total // 2, total - total // 2)``, so a
  stride-2 window on an even input pads more on the high side (the 7x7
  stem (2, 3), a 3x3 (0, 1), a 1x1 nothing). Pads are computed and
  applied with ``F.pad`` where they are not symmetric.
- The 3x3 stride-2 max pool pads with -inf the same way.
- Batch norm runs in f32 under bf16 compute and casts back; the batch
  variance is the biased one, and so is the running variance it folds in
  (``F.batch_norm`` would fold in the unbiased one). Train mode returns
  the new running statistics; nothing is updated in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .optim import SGD, tree_index, tree_leaves

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    # (3, 4, 6, 3) is ResNet-50; tests use tiny nets.
    stage_sizes: tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    num_classes: int = 1000
    compute_dtype: torch.dtype = torch.bfloat16
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5

    @property
    def stage_features(self) -> tuple[int, ...]:
        return tuple(self.width * (2**i) for i in range(len(self.stage_sizes)))


def resnet50(num_classes: int = 1000) -> ResNetConfig:
    return ResNetConfig(stage_sizes=(3, 4, 6, 3), width=64, num_classes=num_classes)


# --- shapes and init ---------------------------------------------------------


def _bottleneck_shapes(cin, cmid, *, project, lead=()):
    """(param shapes, BN-state channel counts) of one bottleneck;
    ``lead`` is the stacking axis of a stage's tail blocks."""
    cout = cmid * 4
    convs = {"conv1": (cmid, cin, 1, 1), "conv2": (cmid, cmid, 3, 3), "conv3": (cout, cmid, 1, 1)}
    bns = {"bn1": cmid, "bn2": cmid, "bn3": cout}
    if project:
        convs["proj"] = (cout, cin, 1, 1)
        bns["bn_proj"] = cout
    p: Params = {}
    for conv, bn in zip(convs, bns):
        p[conv] = lead + convs[conv]
        p[bn] = {"scale": lead + (bns[bn],), "bias": lead + (bns[bn],)}
    state = {bn: {"mean": lead + (c,), "var": lead + (c,)} for bn, c in bns.items()}
    return p, state


def param_shapes(cfg: ResNetConfig) -> tuple[Params, Params]:
    """(params, state) shape trees, in :func:`init_params`' layout."""
    params: Params = {"stem": {"conv": (cfg.width, 3, 7, 7),
                               "bn": {"scale": (cfg.width,), "bias": (cfg.width,)}}}
    state: Params = {"stem": {"bn": {"mean": (cfg.width,), "var": (cfg.width,)}}}
    cin = cfg.width
    for i, (n_blocks, cmid) in enumerate(zip(cfg.stage_sizes, cfg.stage_features)):
        hp, hs = _bottleneck_shapes(cin, cmid, project=True)
        params[f"stage{i}"], state[f"stage{i}"] = {"head": hp}, {"head": hs}
        if n_blocks > 1:
            tp, ts = _bottleneck_shapes(cmid * 4, cmid, project=False, lead=(n_blocks - 1,))
            params[f"stage{i}"]["tail"], state[f"stage{i}"]["tail"] = tp, ts
        cin = cmid * 4
    params["head"] = {"kernel": (cin, cfg.num_classes), "bias": (cfg.num_classes,)}
    return params, state


def init_params(
    cfg: ResNetConfig, generator: torch.Generator, device: str | torch.device | None = None,
) -> tuple[Params, Params]:
    """(params, state), f32 on ``device``, made from ``generator`` (which
    must live there): convolutions normal / sqrt(kh·kw·cin), the head
    normal / sqrt(cin), BN scale 1 and bias 0, running mean 0 and var 1,
    as the reference's init (the numbers differ: tests move JAX weights
    across with ``convert.resnet_from_jax_numpy``)."""
    dev = resolve_device(device)
    pshapes, sshapes = param_shapes(cfg)

    def make(name, shape, parent):
        if parent.startswith("bn") or name in ("bias", "mean"):
            fill = 1.0 if name in ("scale", "var") else 0.0
            return torch.full(shape, fill, device=dev)
        fan_in = shape[:1] if name == "kernel" else shape[-3:]  # (cin,) or (cin, kh, kw)
        w = torch.randn(shape, generator=generator, device=dev)
        return w.div_(math.sqrt(math.prod(fan_in)))

    def build(tree, parent=""):
        return {k: build(v, k) if isinstance(v, dict) else make(k, v, parent)
                for k, v in tree.items()}

    return build(pshapes), build(sshapes)


# --- model ------------------------------------------------------------------


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``padding="SAME"`` along one axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, *, stride=1, dtype):
    """SAME convolution of an NCHW (channels-last) ``x`` by OIHW ``w``,
    cast to ``dtype``."""
    kh = w.shape[-1]
    (ht, hb), (wl, wr) = (_same_pads(n, kh, stride) for n in x.shape[2:])
    w = w.to(dtype, memory_format=torch.channels_last)
    if (ht, wl) == (hb, wr):
        return F.conv2d(x, w, stride=stride, padding=(ht, wl))
    return F.conv2d(F.pad(x, (wl, wr, ht, hb)), w, stride=stride)


def _max_pool(x):
    """3x3, stride 2, SAME, padded with -inf."""
    (ht, hb), (wl, wr) = (_same_pads(n, 3, 2) for n in x.shape[2:])
    return F.max_pool2d(F.pad(x, (wl, wr, ht, hb), value=float("-inf")), 3, 2)


def _batch_norm(x, p, s, *, train, momentum, eps):
    """Returns (y, new_state); statistics in f32 whatever the compute
    dtype, the biased batch variance, y cast back to x's dtype."""
    xf = x.float()
    if train:
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        new_s = {
            "mean": momentum * s["mean"] + (1 - momentum) * mean.detach(),
            "var": momentum * s["var"] + (1 - momentum) * var.detach(),
        }
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    inv = torch.rsqrt(var + eps) * p["scale"]
    y = (xf - mean[:, None, None]) * inv[:, None, None] + p["bias"][:, None, None]
    return y.to(x.dtype), new_s


def _bottleneck(x, p, s, cfg: ResNetConfig, *, stride=1, train):
    def bn(h, name):
        return _batch_norm(h, p[name], s[name], train=train, momentum=cfg.bn_momentum,
                           eps=cfg.bn_eps)

    dt = cfg.compute_dtype
    ns = {}
    h, ns["bn1"] = bn(_conv(x, p["conv1"], dtype=dt), "bn1")
    h, ns["bn2"] = bn(_conv(torch.relu(h), p["conv2"], stride=stride, dtype=dt), "bn2")
    h, ns["bn3"] = bn(_conv(torch.relu(h), p["conv3"], dtype=dt), "bn3")
    if "proj" in p:
        x, ns["bn_proj"] = bn(_conv(x, p["proj"], stride=stride, dtype=dt), "bn_proj")
    return torch.relu(x + h), ns


def _stack(trees):
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


def forward(
    params: Params, state: Params, images: torch.Tensor, cfg: ResNetConfig, *, train: bool = True,
) -> tuple[torch.Tensor, Params]:
    """images [B, H, W, 3] -> (logits [B, classes] f32, new_state)."""
    dt = cfg.compute_dtype
    x = images.to(dt).permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels-last
    x = _conv(x, params["stem"]["conv"], stride=2, dtype=dt)
    x, stem_bn = _batch_norm(x, params["stem"]["bn"], state["stem"]["bn"], train=train,
                             momentum=cfg.bn_momentum, eps=cfg.bn_eps)
    new_state: Params = {"stem": {"bn": stem_bn}}
    x = _max_pool(torch.relu(x))
    for i, n_blocks in enumerate(cfg.stage_sizes):
        sp, ss = params[f"stage{i}"], state[f"stage{i}"]
        x, head_ns = _bottleneck(x, sp["head"], ss["head"], cfg, stride=1 if i == 0 else 2,
                                 train=train)
        stage_ns = {"head": head_ns}
        if n_blocks > 1:
            tails = []
            for j in range(n_blocks - 1):
                x, ns = _bottleneck(x, tree_index(sp["tail"], j), tree_index(ss["tail"], j),
                                    cfg, train=train)
                tails.append(ns)
            stage_ns["tail"] = _stack(tails)
        new_state[f"stage{i}"] = stage_ns
    x = x.float().mean(dim=(2, 3))  # global average pool
    return x @ params["head"]["kernel"] + params["head"]["bias"], new_state


def loss_fn(params, state, images, labels, cfg: ResNetConfig):
    """(mean cross-entropy, new_state), train mode."""
    logits, new_state = forward(params, state, images, cfg, train=True)
    return F.cross_entropy(logits, labels.long()), new_state


# --- training ---------------------------------------------------------------


def make_optimizer(lr: float = 0.1) -> SGD:
    return SGD(lr, momentum=0.9, nesterov=True)


def make_train_step(cfg: ResNetConfig, optimizer: SGD | None = None):
    """``(params, state, opt_state, images, labels) -> (params, new_state,
    opt_state, loss)``; params and the momentum trace update in place."""
    opt = optimizer or make_optimizer()

    def step(params, state, opt_state, images, labels):
        loss, new_state = loss_fn(params, state, images, labels, cfg)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        opt.update(grads, opt_state, params)
        return params, new_state, opt_state, loss.detach()

    return step


def init_train_state(
    cfg: ResNetConfig, generator: torch.Generator, optimizer: SGD | None = None,
    device: str | torch.device | None = None,
) -> tuple[Params, Params, dict[str, Any]]:
    """(params, state, opt_state) for :func:`make_train_step`; params
    require grad."""
    opt = optimizer or make_optimizer()
    params, state = init_params(cfg, generator, device=device)
    for p in tree_leaves(params):
        p.requires_grad_()
    return params, state, opt.init(params)


def demo_batch(generator: torch.Generator, batch: int, size: int = 32):
    """Synthetic (images [batch, size, size, 3] uniform in [0, 1), labels
    [batch] in 0..9) on the generator's device."""
    dev = generator.device
    images = torch.rand((batch, size, size, 3), generator=generator, device=dev)
    labels = torch.randint(0, 10, (batch,), generator=generator, device=dev)
    return images, labels
