"""Differentiable collectives over a mesh axis.

The port's counterparts of ``jax.lax.ppermute``, ``all_to_all`` and
``psum``, which XLA schedules from shardings in the reference and which
here are explicit ``torch.distributed`` calls on a :class:`~.mesh.Mesh`'s
axis groups. (``axis_index`` is :meth:`~.mesh.Mesh.axis_index`.)

Each differentiable one is a ``torch.autograd.Function`` whose backward
is the transposed collective: :func:`shift` sends its tensors to the next
rank of the ring and its backward sends the gradients back to the
previous one; :func:`all_to_all` swaps a split dim for a concat dim and
its backward swaps them back. Every rank must make the same collectives
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
    return t.cpu() if mesh.staged(t) else t


def _shift_flat(mesh: Mesh, axis: str, flat: torch.Tensor, step: int) -> torch.Tensor:
    """Send ``flat`` ``step`` places along the ring of ``axis`` (+1: to the
    next rank) and return what arrives from the other side."""
    t0 = time.perf_counter()
    ranks, i = mesh.axis_ranks(axis), mesh.axis_index(axis)
    n = len(ranks)
    send = _host(mesh, flat).contiguous()
    recv = torch.empty_like(send)
    group = mesh.group(axis)
    ops = [dist.P2POp(dist.isend, send, ranks[(i + step) % n], group),
           dist.P2POp(dist.irecv, recv, ranks[(i - step) % n], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = recv.to(flat.device)
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
    out = torch.empty_like(blocks)
    dist.all_to_all_single(out, blocks, group=mesh.group(axis))
    result = torch.cat(out.to(x.device).unbind(0), dim=concat_dim)
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
    another; axes of size 1 are skipped). Not differentiable: for
    gradients after the backward."""
    for axis in axes:
        if mesh.shape[axis] == 1:
            continue
        for t in tensors:
            t0 = time.perf_counter()
            buf = _host(mesh, t)
            dist.all_reduce(buf, group=mesh.group(axis))
            if buf is not t:
                t.copy_(buf)
            mesh.record("all_reduce", buf.numel() * buf.element_size(), time.perf_counter() - t0)


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
