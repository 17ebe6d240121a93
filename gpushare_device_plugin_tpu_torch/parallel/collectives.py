"""Differentiable collectives over a mesh axis.

The port's counterparts of ``jax.lax.ppermute``, ``all_to_all``,
``psum`` and ``all_gather``, which XLA schedules from shardings in the
reference and which here are explicit ``torch.distributed`` calls on a
:class:`~.mesh.Mesh`'s axis groups. (``axis_index`` is
:meth:`~.mesh.Mesh.axis_index`.)

Each differentiable one is a ``torch.autograd.Function`` whose backward
is the transposed collective: :func:`shift` sends its tensors to the next
rank of the ring and its backward sends the gradients back to the
previous one; :func:`all_to_all` swaps a split dim for a concat dim and
its backward swaps them back. The tensor-parallel pair brackets a
sharded projection: :func:`copy_to_tp` (identity forward, all-reduce
backward) at the input of a column-parallel one, :func:`reduce_from_tp`
(all-reduce forward, identity backward) after a row-parallel one.
:func:`all_gather` makes an FSDP shard whole; its backward is the
reduce-scatter. :func:`gather_from_tp` makes a tp-cut tensor whole where
everything after it is alike on every tp rank; its backward keeps the
rank's own block. :func:`psum` sums over the batch axes and its backward
sums the gradients over them too (synchronized batch norm). Sums run in
f32 whatever the dtype. Every rank must make the same collectives
in the same order, forward and backward. So one call moves all its
tensors in one exchange (K and V travel together), and a Function's
backward makes its exchanges in a fixed order: two exchanges in
separate autograd nodes could run in another order on another rank and
deadlock.

On a ``"gloo"`` mesh a CUDA tensor is copied to the host, exchanged and
copied back (gloo has no CUDA send, receive or all-to-all). That is
chosen by the mesh's backend, never by catching an error. Each exchange
adds its bytes and host seconds to ``mesh.traffic``.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from .mesh import Mesh


def _host(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the exchange can reach it: a staged CUDA tensor copied
    into page-locked host memory (the card's copy engines reach it at full
    rate, and PyTorch's host allocator caches the blocks), anything else
    ``t`` itself."""
    if not mesh.staged(t):
        return t
    buf = _host_empty(mesh, t, t.shape)
    buf.copy_(t)
    return buf


def _host_empty(mesh: Mesh, like: torch.Tensor, shape) -> torch.Tensor:
    """An empty buffer of ``like``'s dtype on ``like``'s side of the
    exchange: page-locked host memory for a staged CUDA tensor."""
    if mesh.staged(like):
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _back(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A received buffer on ``device`` (an asynchronous copy from
    page-locked memory when it was staged)."""
    return t.to(device, non_blocking=True)


def _sum_f32(parts: torch.Tensor) -> torch.Tensor:
    """The f32 sum of ``parts`` over dim 0, in index order."""
    out = parts[0].to(torch.float32)
    for p in parts[1:]:
        out = out + p.to(torch.float32)
    return out


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str, *, op: str = "sum",
               kind: str = "all_reduce") -> torch.Tensor:
    """The reduction (``"sum"`` or ``"max"``) of ``x`` over the ranks of
    ``axis``, out of place, returned in ``x``'s dtype. One
    ``dist.all_reduce`` of an f32 copy on every backend (gloo has no bf16
    sum; a staged copy goes through host memory), so every rank gets the
    same bits and a bf16 partial is summed in f32. Not differentiable;
    counted in ``mesh.traffic[kind]``."""
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}: expected sum|max")
    if mesh.shape[axis] == 1:
        return x
    t0 = time.perf_counter()
    src = x.detach()
    if mesh.staged(src):
        buf = _host(mesh, src.to(torch.float32))
    else:
        buf = src.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(buf, op=_OPS[op], group=mesh.group(axis))
    out = _back(buf, x.device).to(x.dtype)
    mesh.record(kind, buf.numel() * buf.element_size(), time.perf_counter() - t0)
    return out


def _gather_parts(mesh: Mesh, axis: str, x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``[n, *x.shape]`` on ``x``'s device: every rank of ``axis``'s ``x``,
    by axis index; and the bytes this rank handed the exchange."""
    send = _host(mesh, x.detach()).contiguous()
    parts = _host_empty(mesh, x, (mesh.shape[axis], *send.shape))
    dist.all_gather(list(parts.unbind(0)), send, group=mesh.group(axis))
    return _back(parts, x.device), send.numel() * send.element_size()


def _gather(mesh: Mesh, axis: str, x: torch.Tensor, dim: int, kind: str) -> torch.Tensor:
    """The blocks of ``x`` of every rank of ``axis``, joined along ``dim``
    in axis order (a byte copy, in ``x``'s dtype)."""
    t0 = time.perf_counter()
    parts, nbytes = _gather_parts(mesh, axis, x)
    out = torch.cat(parts.unbind(0), dim)
    mesh.record(kind, nbytes, time.perf_counter() - t0)
    return out


def _reduce_scatter(mesh: Mesh, axis: str, g: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block (along ``dim``) of the sum over ``axis`` of every
    rank's ``g``, in f32: each rank sends every other its block of ``g``
    in ``g``'s dtype (one all-to-all) and adds what arrives in f32."""
    t0 = time.perf_counter()
    n = mesh.shape[axis]
    send = _host(mesh, torch.stack(g.detach().chunk(n, dim))).contiguous()
    recv = _host_empty(mesh, g, send.shape)
    dist.all_to_all_single(recv, send, group=mesh.group(axis))
    out = _sum_f32(_back(recv, g.device))
    mesh.record("reduce_scatter", send.numel() * send.element_size(), time.perf_counter() - t0)
    return out


def _shift_flat(mesh: Mesh, axis: str, flat: torch.Tensor, step: int) -> torch.Tensor:
    """Send ``flat`` ``step`` places along the ring of ``axis`` (+1: to the
    next rank) and return what arrives from the other side."""
    t0 = time.perf_counter()
    ranks, i = mesh.axis_ranks(axis), mesh.axis_index(axis)
    n = len(ranks)
    send = _host(mesh, flat).contiguous()
    recv = _host_empty(mesh, flat, send.shape)
    group = mesh.group(axis)
    ops = [dist.P2POp(dist.isend, send, ranks[(i + step) % n], group),
           dist.P2POp(dist.irecv, recv, ranks[(i - step) % n], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = _back(recv, flat.device)
    mesh.record("shift", send.numel() * send.element_size(), time.perf_counter() - t0)
    return out


def _shift_all(mesh, axis, tensors, step):
    """Move every tensor of ``tensors`` (one dtype) in one exchange."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    out = _shift_flat(mesh, axis, flat, step)
    return tuple(p.view(t.shape) for p, t in zip(out.split([t.numel() for t in tensors]), tensors))


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, *tensors):
        ctx.mesh, ctx.axis = mesh, axis
        return _shift_all(mesh, axis, tensors, +1)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_shift_all(ctx.mesh, ctx.axis, grads, -1))


def shift(mesh: Mesh, axis: str, *tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Each rank's ``tensors`` to the next rank of ``axis``'s ring
    (``ppermute`` with ``perm = [(j, (j + 1) % n)]``), all in one exchange;
    returns the previous rank's. The backward sends the gradients the
    other way, also in one exchange. The tensors share one dtype."""
    return _Shift.apply(mesh, axis, *tensors)


def _all_to_all(mesh: Mesh, axis: str, x: torch.Tensor, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    """Tiled all-to-all: chunk ``split_dim`` of ``x`` into n blocks, send
    block j to the rank at index j of ``axis``, and join the blocks
    received, by sender index, along ``concat_dim``."""
    t0 = time.perf_counter()
    n = mesh.shape[axis]
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of size {x.shape[split_dim]} does not split over {n}")
    blocks = _host(mesh, torch.stack(x.chunk(n, split_dim)))
    out = _host_empty(mesh, x, blocks.shape)
    dist.all_to_all_single(out, blocks, group=mesh.group(axis))
    result = torch.cat(_back(out, x.device).unbind(0), dim=concat_dim)
    mesh.record("all_to_all", blocks.numel() * blocks.element_size(), time.perf_counter() - t0)
    return result


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, split_dim, concat_dim, *tensors):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return tuple(_all_to_all(mesh, axis, t, split_dim, concat_dim) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        mesh, axis, split_dim, concat_dim = ctx.args
        back = tuple(_all_to_all(mesh, axis, g, concat_dim, split_dim) for g in grads)
        return (None, None, None, None, *back)


def all_to_all(mesh: Mesh, axis: str, *tensors: torch.Tensor, split_dim: int,
               concat_dim: int) -> tuple[torch.Tensor, ...]:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``
    of each tensor, in order; the backward runs the inverse all-to-alls in
    the same order. With one axis of size 1 it is the identity."""
    if mesh.shape[axis] == 1:
        return tensors
    return _AllToAll.apply(mesh, axis, split_dim, concat_dim, *tensors)


def all_reduce_sum_(tensors, mesh: Mesh, axes) -> None:
    """Sum each tensor in place over the ranks of ``axes`` (one axis after
    another; axes of size 1 are skipped), through :func:`all_reduce`. Not
    differentiable: for gradients after the backward."""
    for axis in axes:
        if mesh.shape[axis] == 1:
            continue
        for t in tensors:
            t.copy_(all_reduce(t, mesh, axis))


class _SumShares(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        out = x.detach().clone()
        all_reduce_sum_([out], mesh, axes)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def sum_shares(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """The sum over ``axes`` of each rank's share ``x`` of a total (a
    loss), the same on every rank. The backward is the identity: each rank
    differentiates its own share, and the gradients are summed over the
    same axes after the backward (:func:`all_reduce_sum_`)."""
    return _SumShares.apply(x, mesh, axes)


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.mesh, "tp", kind="tp_all_reduce"), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, mesh, "tp", kind="tp_all_reduce")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _tp_active(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.shape["tp"] > 1


def copy_to_tp(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The input of a column-parallel projection: ``x`` itself (the same
    on every tp rank), whose backward sums the ranks' partial gradients
    over tp. The identity without a tp axis."""
    return _CopyToTp.apply(x, mesh) if _tp_active(mesh) else x


def reduce_from_tp(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The output of a row-parallel projection: the sum over tp of each
    rank's partial ``x``, the same on every rank; the backward hands each
    rank the gradient unchanged. The identity without a tp axis."""
    return _ReduceFromTp.apply(x, mesh) if _tp_active(mesh) else x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim, x.shape[dim], x.dtype)
        return _gather(mesh, axis, x, dim, "all_gather")

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, dim, n, dtype = ctx.args
        # The reduce-scatter (gloo has none: an all-to-all of the blocks).
        return _reduce_scatter(mesh, axis, grad, dim).to(dtype), None, None, None


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """The blocks of ``x`` of every rank of ``axis`` joined along ``dim``
    (``jax.lax.all_gather(..., tiled=True)``). The backward is the
    reduce-scatter: this rank's block of the gradient summed over ``axis``
    in f32, returned in ``x``'s dtype. The identity on an axis of size 1."""
    if mesh.shape[axis] == 1:
        return x
    return _AllGather.apply(x, mesh, axis, dim)


class _GatherFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.args = (mesh, dim, x.shape[dim])
        return _gather(mesh, "tp", x, dim, "all_gather")

    @staticmethod
    def backward(ctx, grad):
        mesh, dim, n = ctx.args
        return grad.narrow(dim, mesh.axis_index("tp") * n, n), None, None


def gather_from_tp(x: torch.Tensor, mesh: Mesh | None, dim: int) -> torch.Tensor:
    """The tp ranks' blocks of ``x`` joined along ``dim``, for a tensor
    that everything after uses whole and alike on every tp rank (BERT's
    MLM dense weight, cut on its output features, ahead of a layer norm).
    The backward hands each rank its own block of the gradient, which is
    already whole there: a sum over tp would count it tp times. The
    identity without a tp axis."""
    return _GatherFromTp.apply(x, mesh, dim) if _tp_active(mesh) else x


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        out = x.detach().clone()
        all_reduce_sum_([out], mesh, axes)
        return out

    @staticmethod
    def backward(ctx, grad):
        mesh, axes = ctx.args
        out = grad.clone()
        all_reduce_sum_([out], mesh, axes)
        return out, None, None


def psum(x: torch.Tensor, mesh: Mesh | None, axes) -> torch.Tensor:
    """``jax.lax.psum`` over the batch ``axes``: the sum of every rank's
    partial ``x``, the same on every rank; the backward sums the ranks'
    gradients over the same axes (psum's transpose), since each rank's
    loss share depends on the total. Synchronized batch norm's statistics
    go through it. The identity without a mesh or on axes of size 1."""
    if mesh is None or all(mesh.shape[a] == 1 for a in axes):
        return x
    return _Psum.apply(x, mesh, tuple(axes))


def gather_whole(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """:func:`all_gather`'s forward alone, for tensors outside autograd
    (serving's logits, :func:`~.mesh.unshard`)."""
    if mesh.shape[axis] == 1:
        return x
    return _gather(mesh, axis, x, dim, "all_gather")
