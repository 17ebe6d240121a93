"""AdamW with opt-in global-norm clipping and warmup-cosine decay.

Counterpart of ``gpushare_device_plugin_tpu/workloads/optim.py``, which
composes optax: ``adamw(schedule, b1, b2, weight_decay)`` (``eps`` 1e-8,
decay on every leaf, norm gains included), chained after
``clip_by_global_norm`` when ``clip_norm`` is set. The update here is
written out with optax's arithmetic, in optax's order:

- clip: ``g * max_norm / ‖g‖`` (as ``(g / ‖g‖) * max_norm``) when ‖g‖ is
  not below ``max_norm``; ``clip_grad_norm_``'s ``+1e-6`` is not optax's;
- moments ``mu = (1 - b1)·g + b1·mu``, ``nu = (1 - b2)·g² + b2·nu``, bias
  corrected with t = count + 1;
- ``u = mu_hat / (sqrt(nu_hat) + eps) + wd·p``, then ``p += -lr(count)·u``,
  where the schedule's count starts at 0 (with ``total_steps`` set, the
  first update has LR 0).

It updates params and moments in place (the reference donates them), so a
step holds no second copy of the optimizer state.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

EPS = 1e-8


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for val in tree.values() for x in tree_leaves(val)]
    if isinstance(tree, (list, tuple)):
        return [x for val in tree for x in tree_leaves(val)]
    raise TypeError(f"not a tensor tree leaf: {type(tree).__name__}")


def warmup_cosine(
    lr: float, warmup_steps: int, total_steps: int, min_lr_ratio: float
) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule(0, lr, max(1, warmup_steps),
    total_steps, lr * min_lr_ratio)``: linear from 0 over the warmup, then
    a cosine down to ``lr * min_lr_ratio`` at ``total_steps``."""
    warm = max(1, warmup_steps)
    decay = total_steps - warm
    if decay <= 0:
        raise ValueError(
            f"total_steps={total_steps} must exceed the {warm} warmup step(s): "
            "the cosine decay needs positive decay steps"
        )
    alpha = 0.0 if lr == 0.0 else lr * min_lr_ratio / lr

    def schedule(count: int) -> float:
        if count < warm:
            frac = 1 - min(max(count, 0), warm) / warm
            return (0.0 - lr) * frac + lr
        c = min(count - warm, decay)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay))
        return lr * ((1 - alpha) * cosine + alpha)

    return schedule


class AdamW:
    """The optimizer :func:`make_optimizer` returns: ``init(params)`` makes
    the state ``{"count", "mu", "nu"}`` (moments f32, one per leaf);
    ``update(grads, state, params)`` applies one step in place and
    returns ``(params, state)``; ``lr(count)`` is the schedule."""

    def __init__(self, lr: Callable[[int], float], *, weight_decay: float,
                 clip_norm: float | None, b1: float, b2: float):
        self.lr = lr
        self.weight_decay, self.clip_norm, self.b1, self.b2 = weight_decay, clip_norm, b1, b2

    def init(self, params: Any) -> dict[str, Any]:
        leaves = tree_leaves(params)
        return {
            "count": torch.zeros((), dtype=torch.int64),
            "mu": [torch.zeros_like(p, dtype=torch.float32) for p in leaves],
            "nu": [torch.zeros_like(p, dtype=torch.float32) for p in leaves],
        }

    @torch.no_grad()
    def update(self, grads: Any, state: dict[str, Any], params: Any):
        leaves, gs = tree_leaves(params), tree_leaves(grads)
        if len(gs) != len(leaves):
            raise ValueError(f"{len(gs)} gradients for {len(leaves)} parameters")
        if self.clip_norm is not None:
            norm = torch.sqrt(sum(g.float().square().sum() for g in gs))
            if not bool(norm < self.clip_norm):
                gs = [(g / norm.to(g.dtype)) * self.clip_norm for g in gs]
        count = int(state["count"])
        t = count + 1
        bc1, bc2 = 1 - self.b1 ** t, 1 - self.b2 ** t
        step = -self.lr(count)
        for p, g, mu, nu in zip(leaves, gs, state["mu"], state["nu"]):
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_(g.square().mul_(1 - self.b2))
            u = (mu / bc1).div_((nu / bc2).sqrt_().add_(EPS))
            u.add_(self.weight_decay * p)
            p.add_(u.mul_(step).to(p.dtype))
        state["count"] += 1
        return params, state


def make_optimizer(
    lr: float = 3e-4,
    *,
    weight_decay: float = 0.01,
    clip_norm: float | None = None,
    warmup_steps: int = 0,
    total_steps: int | None = None,
    min_lr_ratio: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.999,
) -> AdamW:
    """AdamW with opt-in global-norm clipping and warmup-cosine decay, as
    the reference builds it from optax. Without ``total_steps`` the LR is
    constant; ``warmup_steps`` without ``total_steps`` is an error."""
    if warmup_steps and total_steps is None:
        raise ValueError(
            "warmup_steps requires total_steps (otherwise the LR would "
            "silently stay constant at full peak)"
        )
    if total_steps is not None:
        schedule = warmup_cosine(lr, warmup_steps, total_steps, min_lr_ratio)
    else:
        schedule = lambda count: lr  # noqa: E731
    return AdamW(schedule, weight_decay=weight_decay, clip_norm=clip_norm, b1=b1, b2=b2)
