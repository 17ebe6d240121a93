"""The device mesh over the ranks of a ``torch.distributed`` world.

Counterpart of ``gpushare_device_plugin_tpu/parallel/mesh.py``. The
reference lays its devices out as one ``jax.sharding.Mesh`` with the axes
``("dp", "fsdp", "tp", "sp")`` and lets XLA insert the collectives from
the arrays' shardings. PyTorch has no global array: here every rank holds
its own tile, a :class:`Mesh` places the ranks on the same grid (rank ``r``
sits where device ``r`` sits in the reference's ``reshape(dp, fsdp, tp,
sp)``), and the collectives are explicit calls on one process group per
axis slice (``parallel/collectives.py``).

- ``dp``: data parallelism (parameters replicated);
- ``fsdp``: fully sharded data parallelism (weights cut on the model
  dim, gathered a layer at a time);
- ``tp``: tensor parallelism (heads, MLP hidden width and vocabulary);
- ``sp``: sequence parallelism (ring attention, Ulysses).

:func:`batch_sharding` cuts a rank's ``[B/(dp·fsdp), S/sp]`` tile out of
the global tokens; :func:`shard` cuts any tile (or a tree of them) by a
spec written like a ``PartitionSpec``, as a tuple of axis names, and
:func:`unshard` gathers it whole again on every rank (:func:`unshard_to`
on one rank alone). The reference's ``commit_to_mesh`` has no counterpart:
an optimizer's state is made beside its parameter on the rank's device,
so nothing is ever left on another device to commit.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

AXES = ("dp", "fsdp", "tp", "sp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. Any axis may be 1 (inactive)."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp

    @property
    def axis_names(self) -> tuple[str, ...]:
        return AXES

    @classmethod
    def auto(cls, n_devices: int, *, max_tp: int = 4, want_sp: bool = False) -> "MeshSpec":
        """Factor ``n_devices`` as the reference does: tp takes the largest
        power of two up to ``max_tp``; sp (when asked) a factor of 2; fsdp
        the rest; dp appears only when fsdp would exceed 8."""
        rem = n_devices
        tp = 1
        while tp * 2 <= max_tp and rem % 2 == 0:
            tp *= 2
            rem //= 2
        sp = 1
        if want_sp and rem % 2 == 0 and rem > 1:
            sp = 2
            rem //= 2
        fsdp, dp = rem, 1
        while fsdp > 8 and fsdp % 2 == 0:
            fsdp //= 2
            dp *= 2
        return cls(dp=dp, fsdp=fsdp, tp=tp, sp=sp)


@dataclasses.dataclass
class Traffic:
    """What one kind of exchange moved on this rank: calls, the bytes of
    the buffers it handed the exchange, and host seconds from the call to
    the exchange's end (host staging included)."""

    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0

    def add(self, nbytes: int, seconds: float) -> None:
        self.calls += 1
        self.bytes += nbytes
        self.seconds += seconds


class Mesh:
    """This rank's place on the ``(dp, fsdp, tp, sp)`` grid, with one
    process group per axis slice it belongs to (None for an axis of size
    1). ``shape`` maps each axis to its size, as the reference's
    ``mesh.shape`` does. ``backend`` is the groups' backend: with
    ``"gloo"`` a CUDA tensor is copied to the host, exchanged and copied
    back (``collectives.py``). ``traffic`` counts each kind of exchange."""

    def __init__(self, spec: MeshSpec, rank: int, device: torch.device, backend: str,
                 groups: dict[str, object], ranks: dict[str, list[int]], world_group=None):
        self.spec, self.rank, self.device, self.backend = spec, rank, device, backend
        self.shape = {a: getattr(spec, a) for a in AXES}
        self._groups, self._ranks = groups, ranks
        self.world_group = world_group
        coords = np.unravel_index(rank, tuple(self.shape.values()))
        self.coords = {a: int(c) for a, c in zip(AXES, coords)}
        self.traffic: dict[str, Traffic] = {}

    @property
    def size(self) -> int:
        return self.spec.size

    def axis_index(self, axis: str) -> int:
        """This rank's index along ``axis`` (the reference's ``axis_index``)."""
        return self.coords[axis]

    def axis_ranks(self, axis: str) -> list[int]:
        """The global ranks of this rank's slice along ``axis``, by index."""
        return self._ranks[axis]

    def group(self, axis: str):
        """The process group of this rank's slice along ``axis``."""
        return self._groups[axis]

    def staged(self, t: torch.Tensor) -> bool:
        """True when an exchange of ``t`` goes through host memory: a CUDA
        tensor on a gloo mesh (gloo has no CUDA send, receive or
        all-to-all)."""
        return self.backend == "gloo" and t.device.type == "cuda"

    def record(self, kind: str, nbytes: int, seconds: float) -> None:
        self.traffic.setdefault(kind, Traffic()).add(nbytes, seconds)

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()


def make_mesh(
    spec: MeshSpec | None = None,
    *,
    device: str | torch.device | None = None,
    backend: str | None = None,
) -> Mesh:
    """The mesh over the ranks of the initialized ``torch.distributed``
    world (a world of one when none is initialized), on ``device``
    (``cuda`` unless the caller passes ``"cpu"``; a CUDA rank takes card
    ``rank % device_count``). ``backend`` is the axis groups' backend,
    ``"nccl"`` for CUDA and ``"gloo"`` for the CPU unless given. Every rank
    must call this with the same arguments: each creates every axis
    group, in one order. Raises when ``spec.size`` is not the world
    size."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if spec is None:
        spec = MeshSpec.auto(world)
    if spec.size != world:
        raise ValueError(f"mesh spec {spec} needs {spec.size} ranks, have {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    grid = np.arange(spec.size).reshape(spec.dp, spec.fsdp, spec.tp, spec.sp)
    groups: dict[str, object] = {}
    ranks: dict[str, list[int]] = {}
    for i, axis in enumerate(AXES):
        # Each slice along ``axis``: the ranks that share every other
        # coordinate, in axis order (so group rank == axis index).
        slices = np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i])
        for members in slices.tolist():
            group = dist.new_group(members, backend=backend) if len(members) > 1 else None
            if rank in members:
                groups[axis], ranks[axis] = group, members
    world_group = dist.new_group(list(range(spec.size)), backend=backend) if spec.size > 1 else None
    return Mesh(spec, rank, dev, backend, groups, ranks, world_group)


def _block(mesh: Mesh, axes, coords: dict[str, int] | None = None) -> tuple[int, int]:
    """(index, count) of this rank's block (or, with ``coords``, the block
    of the rank at those coordinates) along a dim tiled over ``axes`` (one
    name, a tuple of names taken major to minor, or None)."""
    if axes is None:
        return 0, 1
    coords = mesh.coords if coords is None else coords
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    index, count = 0, 1
    for a in names:
        index = index * mesh.shape[a] + coords[a]
        count *= mesh.shape[a]
    return index, count


def shard(x, mesh: Mesh, spec):
    """This rank's tile of the global ``x`` under ``spec`` (one entry per
    leading dim, as in a ``PartitionSpec``: an axis name, a tuple of names,
    or None). ``x`` may be a tree (dicts) of tensors with a matching tree
    of specs. A tile is a view of ``x``. Raises when a dim does not
    divide."""
    if isinstance(x, dict):
        return {k: shard(v, mesh, spec[k]) for k, v in x.items()}
    out = x
    for dim, axes in enumerate(spec):
        index, count = _block(mesh, axes)
        if count == 1:
            continue
        if x.shape[dim] % count:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not divide over {axes}={count}")
        step = x.shape[dim] // count
        out = out.narrow(dim, index * step, step)
    return out


def unshard(x, mesh: Mesh, spec):
    """The inverse of :func:`shard`: the global tensor (or tree) from every
    rank's tile, the same on every rank. Every rank of the mesh must call
    it, with the same specs: each sharded dim is gathered over its axes,
    minor axis first. Not differentiable (checkpoints, tests)."""
    from .collectives import gather_whole

    if isinstance(x, dict):
        return {k: unshard(v, mesh, spec[k]) for k, v in x.items()}
    out = x
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in reversed(names):
            out = gather_whole(out, mesh, a, dim)
    return out


def unshard_to(x: torch.Tensor, mesh: Mesh, spec, root: int = 0) -> torch.Tensor | None:
    """:func:`unshard` of one tensor, assembled in host memory on rank
    ``root`` alone (None on every other rank): each rank sends its tile to
    ``root`` in one ``dist.gather`` over the mesh, so no other rank ever
    holds the whole. Every rank must call it, with the same spec
    (checkpoints)."""
    tile = x.detach()
    if mesh.size == 1 or not shard_axes(spec):
        return tile.cpu() if mesh.rank == root else None
    send = (tile.cpu() if mesh.backend == "gloo" else tile).contiguous()
    parts = [torch.empty_like(send) for _ in range(mesh.size)] if mesh.rank == root else None
    dist.gather(send, parts, dst=root, group=mesh.world_group)
    if mesh.rank != root:
        return None
    counts = [_block(mesh, axes)[1] for axes in spec] + [1] * (send.dim() - len(spec))
    whole = torch.empty([n * c for n, c in zip(send.shape, counts)], dtype=send.dtype)
    grid = tuple(mesh.shape.values())
    for r, part in enumerate(parts):
        coords = {a: int(c) for a, c in zip(AXES, np.unravel_index(r, grid))}
        view = whole
        for dim, axes in enumerate(spec):
            index, count = _block(mesh, axes, coords)
            if count > 1:
                view = view.narrow(dim, index * send.shape[dim], send.shape[dim])
        view.copy_(part)
    return whole


def shard_axes(spec) -> frozenset[str]:
    """The mesh axes a (pruned) spec shards its leaf over."""
    out: set[str] = set()
    for axes in spec:
        if axes is not None:
            out.update((axes,) if isinstance(axes, str) else axes)
    return frozenset(out)


def batch_sharding(tokens: torch.Tensor, mesh: Mesh, *, seq_parallel: bool = False) -> torch.Tensor:
    """This rank's ``[B/(dp·fsdp), S/sp]`` tile of the global ``[B, S]``
    tokens: the batch over ``(dp, fsdp)``, the sequence over ``sp`` when
    ``seq_parallel`` (else whole)."""
    return shard(tokens, mesh, (("dp", "fsdp"), "sp" if seq_parallel else None))


def prune_unshardable(specs, shapes, mesh: Mesh):
    """Drop sharding axes that do not divide the dim they shard: a pure
    function on shapes. ``specs`` is a tree (dicts) of tuples, one entry
    per dim (an axis name, a tuple of names, or None); ``shapes`` the
    matching tree of shapes. A non-dividing axis falls back to
    replication for that dim only."""
    if isinstance(specs, dict):
        return {k: prune_unshardable(v, shapes[k], mesh) for k, v in specs.items()}
    out = []
    for i, axis in enumerate(specs):
        if axis is None:
            out.append(None)
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        total = math.prod(mesh.shape[a] for a in axes)
        ok = i < len(shapes) and shapes[i] % total == 0
        out.append(axis if ok else None)
    return tuple(out)


def own_tile(tile: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """A tile that owns its memory (a view would keep the whole leaf)."""
    return tile if tile.shape == whole.shape else tile.clone()


def local_shape(shape, spec, mesh: Mesh) -> tuple[int, ...]:
    """The shape of a rank's tile of a ``shape`` leaf under ``spec``."""
    out = []
    for n, axes in zip(shape, spec):
        names = () if axes is None else (axes,) if isinstance(axes, str) else axes
        out.append(n // math.prod(mesh.shape[a] for a in names))
    return tuple(out) + tuple(shape[len(spec):])


def shard_tree(tree, specs, shapes, mesh: Mesh):
    """This rank's shard of every leaf of ``tree`` (dicts of tensors) under
    the matching tree of (pruned) ``specs``, whose whole shapes are
    ``shapes``. A whole leaf is cut (its tile owns its memory); a leaf
    that already has its shard's shape is kept as it is, so a sharded tree
    passes through unchanged; any other shape raises."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], shapes[k], mesh) for k, v in tree.items()}
    if tuple(tree.shape) == tuple(shapes):
        return own_tile(shard(tree, mesh, specs), tree)
    if tuple(tree.shape) != local_shape(shapes, specs, mesh):
        raise ValueError(f"leaf of shape {tuple(tree.shape)} is neither whole {tuple(shapes)} "
                         f"nor this rank's shard {local_shape(shapes, specs, mesh)}")
    return tree


def tree_specs(tree, specs) -> list[tuple]:
    """The spec of every leaf of ``tree``, in ``tree_leaves`` order (a
    tree's key order is its own), from the matching tree of ``specs``."""
    if isinstance(tree, dict):
        return [s for key, val in tree.items() for s in tree_specs(val, specs[key])]
    return [specs]


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    dp_total = mesh.shape["dp"] * mesh.shape["fsdp"]
    if global_batch % dp_total:
        raise ValueError(f"global batch {global_batch} not divisible by dp*fsdp={dp_total}")
    return global_batch // dp_total
