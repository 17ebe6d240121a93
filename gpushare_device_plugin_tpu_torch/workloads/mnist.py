"""MNIST-scale MLP demo workload, in PyTorch.

Counterpart of ``gpushare_device_plugin_tpu/workloads/mnist.py``: the
small classifier of the ``demo/binpack-1`` pods, trained with SGD
(momentum 0.9) on synthetic class-conditional Gaussian blobs (no dataset
download), so the loss curve is a real training signal. No mesh: a pod
trains on the one card it was granted.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .optim import SGD, tree_leaves
from .trainer import fold_in

IMAGE_DIM = 784
N_CLASSES = 10
PROTOTYPE_SEED = 42  # the class prototypes: the same 10-class problem every batch


def init_params(
    generator: torch.Generator, hidden: int = 128, device: str | torch.device | None = None,
) -> dict[str, torch.Tensor]:
    """Weights normal / sqrt(fan_in), biases zero, f32, made on ``device``
    from ``generator`` (which must live there)."""
    dev = resolve_device(device)

    def norm(shape, fan_in):
        return torch.randn(shape, generator=generator, device=dev).div_(math.sqrt(fan_in))

    return {
        "w1": norm((IMAGE_DIM, hidden), IMAGE_DIM),
        "b1": torch.zeros((hidden,), device=dev),
        "w2": norm((hidden, N_CLASSES), hidden),
        "b2": torch.zeros((N_CLASSES,), device=dev),
    }


def forward(params, images: torch.Tensor) -> torch.Tensor:
    h = torch.relu(images @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def loss_fn(params, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(forward(params, images), labels.long())


def make_train_step(lr: float = 1e-2) -> tuple[Callable, SGD]:
    """``(step, optimizer)``: ``step(params, opt_state, images, labels) ->
    (params, opt_state, loss)`` updates params and the momentum trace in
    place."""
    opt = SGD(lr, momentum=0.9)

    def step(params, opt_state, images, labels):
        loss = loss_fn(params, images, labels)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        opt.update(grads, opt_state, params)
        return params, opt_state, loss.detach()

    return step, opt


def synthetic_batch(generator: torch.Generator, batch: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(images [batch, 784] f32, labels [batch] int64) on the generator's
    device: each image is its class's prototype plus noise 0.3·N(0, 1).
    The prototypes come from a fixed generator (seed 42), so every batch
    samples the same problem."""
    dev = generator.device
    labels = torch.randint(0, N_CLASSES, (batch,), generator=generator, device=dev)
    protos = torch.randn(
        (N_CLASSES, IMAGE_DIM), generator=torch.Generator().manual_seed(PROTOTYPE_SEED)
    ).to(dev)
    noise = torch.randn((batch, IMAGE_DIM), generator=generator, device=dev)
    return protos[labels] + 0.3 * noise, labels


def train(
    steps: int = 50, batch: int = 256, seed: int = 0, *,
    device: str | torch.device | None = None,
    on_metrics: Callable[[int, float], Any] | None = None,
) -> float:
    """The demo pod's loop on ``device`` (``cuda`` unless ``"cpu"``);
    returns the final loss. ``on_metrics(step, loss)`` sees every step's
    loss (reading it waits for the step)."""
    dev = resolve_device(device)
    params = init_params(torch.Generator(device=dev).manual_seed(seed), device=dev)
    for p in params.values():
        p.requires_grad_()
    step_fn, opt = make_train_step()
    opt_state = opt.init(params)
    loss = torch.tensor(float("nan"))
    for i in range(steps):
        gen = torch.Generator(device=dev).manual_seed(fold_in(seed + 1, i))
        params, opt_state, loss = step_fn(params, opt_state, *synthetic_batch(gen, batch))
        if on_metrics is not None:
            on_metrics(i, float(loss))
    return float(loss)
