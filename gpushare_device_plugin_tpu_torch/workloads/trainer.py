"""Training-loop runner: steps, logging, checkpoint and resume.

Counterpart of ``gpushare_device_plugin_tpu/workloads/trainer.py``
without the mesh: a uniform :class:`Task` protocol (opaque state in,
(state, loss) out), batches deterministic in (seed, step) so an
interrupted and resumed run reproduces the uninterrupted one, and opt-in
checkpoints. Where the reference saves asynchronously with orbax, this
writes one ``torch.save`` file of the state's tensors and the step per
checkpoint, through a temporary file and an atomic rename, keeps the
newest ``ckpt_keep`` and resumes from the latest.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from pathlib import Path
from typing import Any, Callable, Protocol

import numpy as np
import torch

from ..device import resolve_device
from . import transformer as T
from .optim import tree_leaves

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_dir: str = ""  # empty: checkpointing off
    ckpt_every: int = 50
    ckpt_keep: int = 3


class Task(Protocol):
    """Adapter between a workload module and the generic loop."""

    def init_state(self, generator: torch.Generator) -> Any:
        """Training state (params, optimizer state, ...) on the generator's
        device, made from it."""
        ...

    def make_step(self) -> Callable[[Any, Any], tuple[Any, torch.Tensor]]:
        """(state, batch) -> (state, loss)."""
        ...

    def make_batch(self, generator: torch.Generator, step: int) -> Any:
        """Batch for this step, made from ``generator`` (a CPU generator
        seeded from (seed, step))."""
        ...


def fold_in(seed: int, n: int) -> int:
    """A seed derived from (seed, n): the counterpart of ``jax.random.fold_in``."""
    return int(np.random.SeedSequence([seed, n]).generate_state(1, np.uint64)[0] >> 1)


def _ckpt_path(ckpt_dir: str, step: int) -> Path:
    return Path(ckpt_dir) / f"step_{step:09d}.pt"


def _ckpt_steps(ckpt_dir: str) -> list[int]:
    d = Path(ckpt_dir)
    if not d.is_dir():
        return []
    return sorted(int(p.stem[5:]) for p in d.glob("step_*.pt") if p.stem[5:].isdigit())


def _save(cfg: TrainLoopConfig, step: int, state: Any) -> None:
    """Write the state's tensors and ``step`` atomically, then drop all but
    the newest ``ckpt_keep`` checkpoints."""
    path = _ckpt_path(cfg.ckpt_dir, step)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    torch.save({"step": step, "tensors": [t.detach() for t in tree_leaves(state)]}, tmp)
    os.replace(tmp, path)
    for old in _ckpt_steps(cfg.ckpt_dir)[:-max(1, cfg.ckpt_keep)]:
        _ckpt_path(cfg.ckpt_dir, old).unlink(missing_ok=True)


@torch.no_grad()
def _restore(state: Any, path: Path, device: torch.device) -> int:
    """Copy a checkpoint's tensors into ``state`` in place; returns its step."""
    saved = torch.load(path, map_location=device, weights_only=True)
    dst = tree_leaves(state)
    if len(saved["tensors"]) != len(dst):
        raise ValueError(f"{path}: {len(saved['tensors'])} tensors, state has {len(dst)}")
    for d, s in zip(dst, saved["tensors"]):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"{path}: {s.dtype}{list(s.shape)} != {d.dtype}{list(d.shape)}")
        d.copy_(s)
    return int(saved["step"])


def run_train_loop(
    task: Task,
    cfg: TrainLoopConfig,
    seed: int,
    *,
    device: str | torch.device | None = None,
    on_metrics: Callable[[int, float], None] | None = None,
) -> tuple[Any, float]:
    """Run (or resume) training on ``device`` (``cuda`` unless ``"cpu"`` is
    passed); returns (final_state, last_loss)."""
    dev = resolve_device(device)
    state = task.init_state(torch.Generator(device=dev).manual_seed(fold_in(seed, 0)))
    data_seed = fold_in(seed, 1)
    step_fn = task.make_step()
    start = 0
    if cfg.ckpt_dir:
        steps = _ckpt_steps(cfg.ckpt_dir)
        if steps:
            start = _restore(state, _ckpt_path(cfg.ckpt_dir, steps[-1]), dev) + 1
            log.info("resumed from checkpoint step %d", start - 1)

    loss_t = None
    for step in range(start, cfg.total_steps):
        gen = torch.Generator().manual_seed(fold_in(data_seed, step))
        state, loss_t = step_fn(state, task.make_batch(gen, step))
        if cfg.log_every and (step % cfg.log_every == 0 or step == cfg.total_steps - 1):
            loss = float(loss_t)
            log.info("step %d loss %.4f", step, loss)
            if on_metrics is not None:
                on_metrics(step, loss)
        if cfg.ckpt_dir and cfg.ckpt_every and (step + 1) % cfg.ckpt_every == 0:
            _save(cfg, step, state)
    if cfg.ckpt_dir and cfg.total_steps > start:
        # Persist the final step too (already saved if it matched ckpt_every).
        if _ckpt_steps(cfg.ckpt_dir)[-1:] != [cfg.total_steps - 1]:
            _save(cfg, cfg.total_steps - 1, state)
    return state, float("nan") if loss_t is None else float(loss_t)


# --- task adapters for the workloads ----------------------------------------


class DecoderTask:
    """Llama-style decoder LM (``workloads/transformer.py``) on
    ``demo_batch`` tokens."""

    def __init__(self, cfg: T.TransformerConfig, batch: int, seq: int):
        self.cfg, self.batch, self.seq = cfg, batch, seq

    def init_state(self, generator: torch.Generator):
        return T.init_train_state(self.cfg, generator, device=generator.device)

    def make_step(self):
        step = T.make_train_step(self.cfg)

        def fn(state, batch):
            params, opt_state, loss = step(*state, batch.to(state[0]["embed"].device))
            return (params, opt_state), loss

        return fn

    def make_batch(self, generator: torch.Generator, step: int) -> torch.Tensor:
        return T.demo_batch(generator, self.batch, self.seq, self.cfg.vocab)
