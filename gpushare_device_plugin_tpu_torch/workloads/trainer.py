"""Training-loop runner: steps, logging, checkpoint and resume.

Counterpart of ``gpushare_device_plugin_tpu/workloads/trainer.py``: a
uniform :class:`Task` protocol (opaque state in, (state, loss) out),
batches deterministic in (seed, step) so an interrupted and resumed run
reproduces the uninterrupted one, and opt-in checkpoints. With a mesh
(``parallel/mesh.py``) every rank makes the same global batch and its
step runs the rank's tile of it, on its shards of the state. A
checkpoint is always whole: every rank sends its shard of each leaf to
rank 0 (``mesh.unshard_to``), which writes the whole, and every rank
restores its own shard of it, so a checkpoint taken on one mesh restores on another
(fsdp=2 and fsdp=1, say). Where the reference saves asynchronously with orbax, this
writes one ``torch.save`` file of the state's tensors and the step per
checkpoint, through a temporary file and an atomic rename, keeps the
newest ``ckpt_keep`` and resumes from the latest. The tasks are the
reference's three: :class:`DecoderTask`, :class:`BertTask` and
:class:`ResNetTask` (whose state carries the batch-norm running
statistics, so a checkpoint holds them too).
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
from ..parallel.mesh import Mesh, shard, unshard_to
from . import bert as B
from . import resnet as R
from . import transformer as T
from .optim import SGD, AdamW, tree_leaves

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

    def init_state(self, generator: torch.Generator, mesh: Mesh | None) -> Any:
        """Training state (params, optimizer state, ...) on the generator's
        device, made from it; on a ``mesh``, this rank's shards of it."""
        ...

    def make_step(self, mesh: Mesh | None) -> Callable[[Any, Any], tuple[Any, torch.Tensor]]:
        """(state, batch) -> (state, loss); with ``mesh``, the batch is the
        global one and the step runs this rank's tile."""
        ...

    def make_batch(self, generator: torch.Generator, step: int) -> Any:
        """Batch for this step, made from ``generator`` (a CPU generator
        seeded from (seed, step))."""
        ...

    # Optional: ``state_specs(state, mesh) -> list`` gives the spec of
    # every leaf of the state (``tree_leaves`` order) on a mesh that shards
    # it; a task without it holds whole replicas.


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


def _state_specs(task: Task, state: Any, mesh: Mesh | None) -> list | None:
    """Each state leaf's spec on ``mesh`` (None without a mesh)."""
    if mesh is None:
        return None
    fn = getattr(task, "state_specs", None)
    return fn(state, mesh) if fn is not None else [()] * len(tree_leaves(state))


def _save(cfg: TrainLoopConfig, step: int, state: Any, mesh: Mesh | None = None,
          specs: list | None = None) -> None:
    """Write the state's tensors (whole: on a mesh every rank sends its
    shard of each leaf to rank 0, which assembles and writes it) and
    ``step`` atomically, then drop all but the newest ``ckpt_keep``
    checkpoints."""
    if mesh is not None:
        tensors = [unshard_to(t, mesh, spec) for t, spec in zip(tree_leaves(state), specs)]
        if mesh.rank != 0:
            return
    else:
        tensors = [t.detach() for t in tree_leaves(state)]
    path = _ckpt_path(cfg.ckpt_dir, step)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    torch.save({"step": step, "tensors": tensors}, tmp)
    os.replace(tmp, path)
    for old in _ckpt_steps(cfg.ckpt_dir)[:-max(1, cfg.ckpt_keep)]:
        _ckpt_path(cfg.ckpt_dir, old).unlink(missing_ok=True)


@torch.no_grad()
def _restore(state: Any, path: Path, device: torch.device, mesh: Mesh | None = None,
             specs: list | None = None) -> int:
    """Copy a checkpoint's tensors (on a mesh, this rank's shard of each)
    into ``state`` in place; returns its step."""
    saved = torch.load(path, map_location="cpu" if mesh is not None else device,
                       weights_only=True)
    dst = tree_leaves(state)
    if len(saved["tensors"]) != len(dst):
        raise ValueError(f"{path}: {len(saved['tensors'])} tensors, state has {len(dst)}")
    for i, (d, s) in enumerate(zip(dst, saved["tensors"])):
        if mesh is not None:
            s = shard(s, mesh, specs[i])
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
    mesh: Mesh | None = None,
) -> tuple[Any, float]:
    """Run (or resume) training on ``device`` (``cuda`` unless ``"cpu"`` is
    passed; the mesh's device with a ``mesh``); returns (final_state,
    last_loss). With a mesh every rank runs this with the same arguments:
    the same seed makes the same replica and the same global batches."""
    dev = mesh.device if mesh is not None and device is None else resolve_device(device)
    state = task.init_state(torch.Generator(device=dev).manual_seed(fold_in(seed, 0)), mesh)
    data_seed = fold_in(seed, 1)
    step_fn = task.make_step(mesh)
    specs = _state_specs(task, state, mesh)
    start = 0
    if cfg.ckpt_dir:
        steps = _ckpt_steps(cfg.ckpt_dir)
        if steps:
            start = _restore(state, _ckpt_path(cfg.ckpt_dir, steps[-1]), dev, mesh, specs) + 1
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
            _save(cfg, step, state, mesh, specs)
    if cfg.ckpt_dir and cfg.total_steps > start:
        # Persist the final step too, unless ckpt_every just saved it (a
        # rule of the step count, so every rank of a mesh agrees).
        if not (cfg.ckpt_every and cfg.total_steps % cfg.ckpt_every == 0):
            _save(cfg, cfg.total_steps - 1, state, mesh, specs)
    if mesh is not None and cfg.ckpt_dir:
        mesh.barrier()  # rank 0's files are whole before any rank goes on
    return state, float("nan") if loss_t is None else float(loss_t)


# --- task adapters for the workloads ----------------------------------------


class DecoderTask:
    """Llama-style decoder LM (``workloads/transformer.py``) on
    ``demo_batch`` tokens, trained by ``optimizer`` (AdamW at its defaults
    unless given)."""

    def __init__(self, cfg: T.TransformerConfig, batch: int, seq: int,
                 optimizer: AdamW | None = None):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.optimizer = optimizer

    def init_state(self, generator: torch.Generator, mesh: Mesh | None = None):
        return T.init_train_state(self.cfg, generator, self.optimizer, device=generator.device,
                                  mesh=mesh)

    def make_step(self, mesh: Mesh | None = None):
        step = T.make_train_step(self.cfg, self.optimizer, mesh=mesh)

        def fn(state, batch):
            params, opt_state, loss = step(*state, batch.to(state[0]["embed"].device))
            return (params, opt_state), loss

        return fn

    def make_batch(self, generator: torch.Generator, step: int) -> torch.Tensor:
        return T.demo_batch(generator, self.batch, self.seq, self.cfg.vocab)

    def state_specs(self, state, mesh: Mesh) -> list:
        """Specs of ``(params, opt_state)``'s leaves: the params', AdamW's
        replicated count, then the moments, cut as their params."""
        params = T.leaf_specs(state[0], mesh, self.cfg)
        return params + [()] + params + params


def _on(device: torch.device, batch: tuple) -> tuple:
    return tuple(t.to(device) for t in batch)


class BertTask:
    """BERT MLM encoder (``workloads/bert.py``) on ``demo_batch`` batches,
    trained by ``optimizer`` (AdamW at BERT's defaults unless given);
    state ``(params, opt_state)``."""

    def __init__(self, cfg: B.BertConfig, batch: int, seq: int,
                 optimizer: AdamW | None = None):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.optimizer = optimizer

    def init_state(self, generator: torch.Generator, mesh: Mesh | None = None):
        return B.init_train_state(self.cfg, generator, self.optimizer, device=generator.device,
                                  mesh=mesh)

    def make_step(self, mesh: Mesh | None = None):
        step = B.make_train_step(self.cfg, self.optimizer, mesh=mesh)

        def fn(state, batch):
            params, opt_state, loss = step(*state, *_on(state[0]["embed"].device, batch))
            return (params, opt_state), loss

        return fn

    def make_batch(self, generator: torch.Generator, step: int):
        return B.demo_batch(generator, self.batch, self.seq, self.cfg)

    def state_specs(self, state, mesh: Mesh) -> list:
        """Specs of ``(params, opt_state)``'s leaves: the params', AdamW's
        replicated count, then the moments, cut as their params."""
        params = B.leaf_specs(state[0], mesh, self.cfg)
        return params + [()] + params + params


class ResNetTask:
    """ResNet classifier (``workloads/resnet.py``) on ``demo_batch``
    images, trained by ``optimizer`` (the reference's SGD recipe unless
    given); state ``(params, bn_state, opt_state)``."""

    def __init__(self, cfg: R.ResNetConfig, batch: int, image_size: int = 32,
                 optimizer: SGD | None = None):
        self.cfg, self.batch, self.image_size = cfg, batch, image_size
        self.optimizer = optimizer

    def init_state(self, generator: torch.Generator, mesh: Mesh | None = None):
        return R.init_train_state(self.cfg, generator, self.optimizer, device=generator.device,
                                  mesh=mesh)

    def make_step(self, mesh: Mesh | None = None):
        step = R.make_train_step(self.cfg, self.optimizer, mesh=mesh)

        def fn(state, batch):
            params, bn, opt_state, loss = step(
                *state, *_on(state[0]["head"]["kernel"].device, batch)
            )
            return (params, bn, opt_state), loss

        return fn

    def make_batch(self, generator: torch.Generator, step: int):
        return R.demo_batch(generator, self.batch, self.image_size)

    def state_specs(self, state, mesh: Mesh) -> list:
        """Specs of ``(params, bn_state, opt_state)``'s leaves: the
        params', the BN state whole, then the momentum traces (if any),
        cut as their params."""
        params = R.leaf_specs(state[0], mesh, self.cfg)
        traces = params if state[2]["trace"] else []
        return params + [()] * len(tree_leaves(state[1])) + traces
