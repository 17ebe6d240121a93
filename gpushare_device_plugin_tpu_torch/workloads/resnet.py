"""ResNet-50 image classifier, in PyTorch.

Counterpart of ``gpushare_device_plugin_tpu/workloads/resnet.py``: the
config, params and batch-norm state, ``forward``, ``loss_fn``, the
training half (SGD with Nesterov momentum) and the mesh helpers
(``param_specs``, ``param_shardings``, ``shard_params``).

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

With a mesh (``parallel/mesh.py``) each rank runs its ``B/(dp·fsdp)``
images on its shards, cut by :func:`param_shardings` (the reference's
``param_specs`` pruned where an axis does not divide): every convolution
cuts its output channels over fsdp (the reference's HWIO kernels cut
their last dim; here that is O, dim 0, or dim 1 of a stage's stacked
tail) and is all-gathered where it is used; the classifier's kernel is
``("fsdp", "tp")`` and its bias ``("tp",)``, so its logits are cut on the
classes and the loss is a vocab-parallel cross-entropy. Batch-norm
parameters and state are whole on every rank. Under GSPMD the
reference's training batch norm takes its mean and biased variance over
the global batch; here they are synchronized: each rank's sums go
through ``collectives.psum`` over ``(dp, fsdp)``, whose backward sums the
gradients over the same axes, so the running statistics are the 1-rank
run's on every rank. The convolution trunk runs whole on every tp rank.
Each rank's loss is its share of the global mean; after the backward each
leaf's gradient is summed over the batch axes its spec does not cut.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..parallel.collectives import all_gather, all_reduce_sum_, copy_to_tp, psum, sum_shares
from ..parallel.mesh import (
    Mesh,
    prune_unshardable,
    shard,
    shard_axes,
    shard_tree,
    tree_specs,
)
from .optim import SGD, tree_index, tree_leaves
from .transformer import REPLICA_AXES, token_nll

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
    mesh: Mesh | None = None,
) -> tuple[Params, Params]:
    """(params, state), f32 on ``device``, made from ``generator`` (which
    must live there): convolutions normal / sqrt(kh·kw·cin), the head
    normal / sqrt(cin), BN scale 1 and bias 0, running mean 0 and var 1,
    as the reference's init (the numbers differ: tests move JAX weights
    across with ``convert.resnet_from_jax_numpy``). With a ``mesh`` the
    params are this rank's shards of the same draw."""
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

    params, state = build(pshapes), build(sshapes)
    return params if mesh is None else shard_params(params, state, mesh, cfg)[0], state


# --- sharding ---------------------------------------------------------------

_BN_NAMES = ("bn1", "bn2", "bn3", "bn_proj", "bn")


def param_specs(cfg: ResNetConfig) -> Params:
    """The reference's ``param_specs`` in the port's layout, each spec a
    tuple with one entry per dim: convolutions cut their output channels
    (O: dim 0, or dim 1 of a stacked tail) over fsdp, the classifier's
    kernel is ``("fsdp", "tp")`` and its bias ``("tp",)``, BN parameters
    are whole."""

    def spec(name, shape, parent):
        if parent in _BN_NAMES:
            return (None,) * len(shape)
        if name == "kernel":
            return ("fsdp", "tp")
        if name == "bias":
            return ("tp",)
        lead = len(shape) - 4  # 1 for a stage's stacked tail blocks
        return (None,) * lead + ("fsdp", None, None, None)

    def walk(tree, parent=""):
        return {k: walk(v, k) if isinstance(v, dict) else spec(k, v, parent)
                for k, v in tree.items()}

    return walk(param_shapes(cfg)[0])


def param_shardings(mesh: Mesh, cfg: ResNetConfig) -> Params:
    """Each param's spec on ``mesh``: :func:`param_specs` pruned by
    ``prune_unshardable``."""
    return prune_unshardable(param_specs(cfg), param_shapes(cfg)[0], mesh)


def shard_params(params: Params, state: Params, mesh: Mesh,
                 cfg: ResNetConfig) -> tuple[Params, Params]:
    """(This rank's shard of every param of a whole tree, the BN state
    whole); a param already cut passes through."""
    check_mesh(mesh, cfg)
    return shard_tree(params, param_shardings(mesh, cfg), param_shapes(cfg)[0], mesh), state


def leaf_specs(params: Params, mesh: Mesh, cfg: ResNetConfig) -> list[tuple]:
    """The pruned spec of every param, in ``tree_leaves`` order."""
    return tree_specs(params, param_shardings(mesh, cfg))


def grad_sum_axes(params: Params, mesh: Mesh, cfg: ResNetConfig) -> list[tuple[str, ...]]:
    """For each param, in ``tree_leaves`` order, the batch axes its
    gradient is summed over after the backward: those its spec does not
    cut (tp never)."""
    return [tuple(a for a in REPLICA_AXES if a not in shard_axes(spec))
            for spec in leaf_specs(params, mesh, cfg)]


def check_mesh(mesh: Mesh, cfg: ResNetConfig) -> None:
    """Raise unless ResNet runs on ``mesh``: it has no sequence axis."""
    del cfg
    if mesh.shape["sp"] > 1:
        raise ValueError(f"ResNet has no sequence parallelism: mesh sp={mesh.shape['sp']}")


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


DATA_AXES = ("dp", "fsdp")  # the axes the batch is cut over; BN syncs over them


def _sync_moments(xf: torch.Tensor, mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, biased variance) of ``xf`` [b, C, H, W] over the
    global batch: every rank's sums added over the data axes (two passes:
    the mean, then the squared deviations from it)."""
    n = xf.shape[0] * xf.shape[2] * xf.shape[3] * math.prod(mesh.shape[a] for a in DATA_AXES)
    mean = psum(xf.sum((0, 2, 3)), mesh, DATA_AXES) / n
    dev = xf - mean[:, None, None]
    return mean, psum(dev.square().sum((0, 2, 3)), mesh, DATA_AXES) / n


def _batch_norm(x, p, s, *, train, momentum, eps, mesh: Mesh | None = None):
    """Returns (y, new_state); statistics in f32 whatever the compute
    dtype, the biased batch variance, y cast back to x's dtype. With a
    ``mesh``, train mode's statistics are the global batch's."""
    xf = x.float()
    if train:
        if mesh is None:
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        else:
            mean, var = _sync_moments(xf, mesh)
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


def _conv_bn(x, w, bn, s, cfg: ResNetConfig, *, stride=1, train, mesh: Mesh | None = None):
    """The convolution by ``w`` and the batch norm after it: (y, new BN
    state). On a mesh an fsdp-cut kernel (fewer output channels than its
    BN) is cast and all-gathered over fsdp first."""
    dt = cfg.compute_dtype
    if mesh is not None and w.shape[0] != bn["scale"].shape[0]:
        w = all_gather(w.to(dt), mesh, "fsdp", 0)
    return _batch_norm(_conv(x, w, stride=stride, dtype=dt), bn, s, train=train,
                       momentum=cfg.bn_momentum, eps=cfg.bn_eps, mesh=mesh)


def _bottleneck(x, p, s, cfg: ResNetConfig, *, stride=1, train, mesh: Mesh | None = None):
    def conv_bn(h, conv, bn, stride=1):
        return _conv_bn(h, p[conv], p[bn], s[bn], cfg, stride=stride, train=train, mesh=mesh)

    ns = {}
    h, ns["bn1"] = conv_bn(x, "conv1", "bn1")
    h, ns["bn2"] = conv_bn(torch.relu(h), "conv2", "bn2", stride)
    h, ns["bn3"] = conv_bn(torch.relu(h), "conv3", "bn3")
    if "proj" in p:
        x, ns["bn_proj"] = conv_bn(x, "proj", "bn_proj", stride)
    return torch.relu(x + h), ns


def _stack(trees):
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


def forward(
    params: Params, state: Params, images: torch.Tensor, cfg: ResNetConfig, *, train: bool = True,
    mesh: Mesh | None = None,
) -> tuple[torch.Tensor, Params]:
    """images [B, H, W, 3] -> (logits [B, classes] f32, new_state). With a
    ``mesh``, the global images in, the same on every rank, and this
    rank's ``B/(dp·fsdp)`` rows of logits out, on its classes/tp when tp
    cuts them; the new state is the global batch's, on every rank."""
    dt = cfg.compute_dtype
    if mesh is not None:
        check_mesh(mesh, cfg)
        images = shard(images, mesh, (DATA_AXES,))
    x = images.to(dt).permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels-last
    x, stem_bn = _conv_bn(x, params["stem"]["conv"], params["stem"]["bn"], state["stem"]["bn"],
                          cfg, stride=2, train=train, mesh=mesh)
    new_state: Params = {"stem": {"bn": stem_bn}}
    x = _max_pool(torch.relu(x))
    for i, n_blocks in enumerate(cfg.stage_sizes):
        sp, ss = params[f"stage{i}"], state[f"stage{i}"]
        x, head_ns = _bottleneck(x, sp["head"], ss["head"], cfg, stride=1 if i == 0 else 2,
                                 train=train, mesh=mesh)
        stage_ns = {"head": head_ns}
        if n_blocks > 1:
            tails = []
            for j in range(n_blocks - 1):
                x, ns = _bottleneck(x, tree_index(sp["tail"], j), tree_index(ss["tail"], j),
                                    cfg, train=train, mesh=mesh)
                tails.append(ns)
            stage_ns["tail"] = _stack(tails)
        new_state[f"stage{i}"] = stage_ns
    x = x.float().mean(dim=(2, 3))  # global average pool
    kernel = params["head"]["kernel"]
    if mesh is not None:
        if kernel.shape[0] != x.shape[1]:
            kernel = all_gather(kernel, mesh, "fsdp", 0)
        if kernel.shape[1] != cfg.num_classes:
            x = copy_to_tp(x, mesh)
    return x @ kernel + params["head"]["bias"], new_state


def loss_fn(params, state, images, labels, cfg: ResNetConfig, mesh: Mesh | None = None):
    """(mean cross-entropy, new_state), train mode. With a ``mesh`` the
    global batch in: each rank's share is its rows' nll summed over the
    global batch size, the shares summed over the batch axes give the
    mean, which every rank returns (its backward is the rank's share)."""
    logits, new_state = forward(params, state, images, cfg, train=True, mesh=mesh)
    if mesh is None:
        return F.cross_entropy(logits, labels.long()), new_state
    nll = token_nll(logits, shard(labels, mesh, (DATA_AXES,)), cfg.num_classes, mesh)
    return sum_shares(nll.sum() / labels.shape[0], mesh, REPLICA_AXES), new_state


# --- training ---------------------------------------------------------------


def make_optimizer(lr: float = 0.1) -> SGD:
    return SGD(lr, momentum=0.9, nesterov=True)


def make_train_step(cfg: ResNetConfig, optimizer: SGD | None = None, mesh: Mesh | None = None):
    """``(params, state, opt_state, images, labels) -> (params, new_state,
    opt_state, loss)``; params and the momentum trace update in place.
    With a ``mesh`` the batch is the global one and params and trace are
    the rank's shards; each param's gradient is summed over
    :func:`grad_sum_axes` (in leaf order) before the update."""
    opt = optimizer or make_optimizer()
    if mesh is not None:
        check_mesh(mesh, cfg)

    def step(params, state, opt_state, images, labels):
        loss, new_state = loss_fn(params, state, images, labels, cfg, mesh)
        grads = list(torch.autograd.grad(loss, tree_leaves(params)))
        if mesh is not None:
            for g, axes in zip(grads, grad_sum_axes(params, mesh, cfg)):
                all_reduce_sum_([g], mesh, axes)
        opt.update(grads, opt_state, params)
        return params, new_state, opt_state, loss.detach()

    return step


def init_train_state(
    cfg: ResNetConfig, generator: torch.Generator, optimizer: SGD | None = None,
    device: str | torch.device | None = None, mesh: Mesh | None = None,
) -> tuple[Params, Params, dict[str, Any]]:
    """(params, state, opt_state) for :func:`make_train_step`; params
    require grad. With a ``mesh`` (its device unless ``device`` is given)
    the params are this rank's shards of the whole draw, so every rank
    must pass a generator seeded alike."""
    opt = optimizer or make_optimizer()
    if mesh is not None:
        check_mesh(mesh, cfg)
        device = mesh.device if device is None else device
    params, state = init_params(cfg, generator, device=device, mesh=mesh)
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
