"""Gloo ranks on the CPU for the port's parallel tests.

:func:`spawn` starts ``world`` Python processes, each a rank of one gloo
world (a ``file://`` rendezvous in the test's temporary directory, so
parallel test workers never race for a port), and runs a list of jobs in
every rank, in order; each job builds its mesh, runs one of :data:`JOBS`
and hands back numpy results. One spawn runs every case of a test file.
This module imports torch and the port and nothing of JAX: the ranks
never load JAX, while the test process computes the reference.

A job is ``(name, function name, keyword arguments)``; its result is what
the function returns, or ``{"error": ...}`` when it raises ValueError (the
same on every rank before any exchange, so no rank is left waiting).
"""

from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
RENDEZVOUS_S = 30  # init_process_group's timeout, also each collective's
JOIN_S = 240  # the whole spawn


def spawn(world: int, jobs: list, workdir: Path, env: dict | None = None) -> list[dict]:
    """Run ``jobs`` on ``world`` gloo ranks; returns each rank's results by
    job name, by rank. Raises with the ranks' output if any rank fails or
    the spawn outlasts JOIN_S (every rank is then killed)."""
    return collect(start(world, jobs, workdir, env))


def start(world: int, jobs: list, workdir: Path, env: dict | None = None):
    """Start ``world`` ranks on ``jobs`` and return at once (a handle for
    :func:`collect`), so that spawns of several world sizes overlap."""
    workdir = Path(workdir)
    (workdir / "jobs.pkl").write_bytes(pickle.dumps(jobs))
    code = "import sys, torch_ranks; torch_ranks.main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))"
    penv = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]),
                OMP_NUM_THREADS="1", **(env or {}))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(workdir), str(r), str(world)],
                              cwd=ROOT, env=penv, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return workdir, procs


def collect(handle) -> list[dict]:
    """Wait for the ranks of :func:`start`; as :func:`spawn` returns."""
    workdir, procs = handle
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise RuntimeError(f"{len(procs)} ranks outlasted {JOIN_S} s") from None
    failed = [(r, p.returncode, out[-3000:]) for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        raise RuntimeError(f"rank(s) failed: {failed}")
    return [pickle.loads((workdir / f"rank{r}.pkl").read_bytes()) for r in range(len(procs))]


def main(workdir: str, rank: int, world: int) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=RENDEZVOUS_S))
    meshes: dict = {}
    results = {}
    for name, fn, kw in pickle.loads(Path(workdir, "jobs.pkl").read_bytes()):
        try:
            results[name] = JOBS[fn](meshes, **kw)
        except ValueError as e:
            results[name] = {"error": str(e)}
    Path(workdir, f"rank{rank}.pkl").write_bytes(pickle.dumps(results))
    dist.barrier()
    dist.destroy_process_group()


def _mesh(meshes: dict, spec: dict):
    """The mesh of ``spec`` (MeshSpec fields), made once per spawn: every
    rank meets the jobs, so the groups, in one order."""
    from gpushare_device_plugin_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    key = tuple(sorted(spec.items()))
    if key not in meshes:
        meshes[key] = make_mesh(MeshSpec(**spec), device="cpu", backend="gloo")
    return meshes[key]


def block(spec: dict, rank: int, axes) -> tuple[int, int]:
    """(index, count) of ``rank``'s block along a dim tiled over ``axes``
    on the mesh ``spec``: the reference's ``PartitionSpec`` rule, axes
    major to minor."""
    from gpushare_device_plugin_tpu_torch.parallel.mesh import AXES

    shape = [spec.get(a, 1) for a in AXES]
    coords = dict(zip(AXES, np.unravel_index(rank, shape)))
    if axes is None:
        return 0, 1
    index, count = 0, 1
    for a in (axes,) if isinstance(axes, str) else axes:
        index = index * spec.get(a, 1) + int(coords[a])
        count *= spec.get(a, 1)
    return index, count


def tile_slices(shape, spec: dict, rank: int, dims) -> tuple:
    out = []
    for n, axes in zip(shape, dims):
        index, count = block(spec, rank, axes)
        out.append(slice(index * (n // count), (index + 1) * (n // count)))
    return tuple(out)


def assemble(shards: list, shape, spec: dict, dims) -> np.ndarray:
    """The global array from every rank's tile (ranks that hold the same
    tile must agree)."""
    out = np.full(shape, np.nan, dtype=np.float64)
    for rank, tile in enumerate(shards):
        sl = tile_slices(shape, spec, rank, dims)
        if not np.isnan(out[sl]).all():
            np.testing.assert_array_equal(out[sl], tile)
        out[sl] = tile
    return out


# --- jobs -------------------------------------------------------------------


def attention(meshes, *, spec, scheme, q, k, v, dims, causal=True, hop_attention="plain",
              inner=None, grad=False):
    """Ring or Ulysses attention on this rank's tiles of the global q, k,
    v (``dims``: the spec of their first three dims). Returns the output
    tile, with ``grad`` the tiles of d(sum(out^2))/d(q, k, v), the hop
    computations made (plain updates, flash calls) and the traffic."""
    from gpushare_device_plugin_tpu_torch.parallel import ring as ring_mod
    from gpushare_device_plugin_tpu_torch.parallel.ring import ring_attention
    from gpushare_device_plugin_tpu_torch.parallel.ulysses import ulysses_attention
    from gpushare_device_plugin_tpu_torch.workloads.attention import ulysses_inner_attn

    mesh = _mesh(meshes, spec)
    mesh.traffic.clear()
    calls = {"plain": 0, "flash": 0}
    saved = ring_mod._online_update, ring_mod.flash_attention_lse

    def counted(kind, fn):
        def wrapped(*args, **kw):
            calls[kind] += 1
            return fn(*args, **kw)
        return wrapped

    ring_mod._online_update = counted("plain", saved[0])
    ring_mod.flash_attention_lse = counted("flash", saved[1])
    try:
        sl = tile_slices(q.shape, spec, mesh.rank, dims)
        x = [torch.from_numpy(np.ascontiguousarray(a[tile_slices(a.shape, spec, mesh.rank, dims)]))
             .requires_grad_(grad) for a in (q, k, v)]
        kw = dict(causal=causal, batch_axes=dims[0], head_axes=dims[2])
        if scheme == "ring":
            out = ring_attention(*x, mesh, hop_attention=hop_attention, **kw)
        else:
            fn = ulysses_inner_attn(inner) if inner else None
            out = ulysses_attention(*x, mesh, attn_fn=fn, **kw)
        res = {"out": out.detach().numpy(), "slices": sl}
        if grad:
            res["grads"] = [g.numpy() for g in torch.autograd.grad((out ** 2).sum(), x)]
    finally:
        ring_mod._online_update, ring_mod.flash_attention_lse = saved
    res["calls"] = calls
    res["traffic"] = {kind: (t.calls, t.bytes) for kind, t in mesh.traffic.items()}
    return res


def _decoder(params, cfg):
    from gpushare_device_plugin_tpu_torch.workloads import convert
    from gpushare_device_plugin_tpu_torch.workloads import transformer as T

    tcfg = T.TransformerConfig(**cfg, compute_dtype=torch.float32)
    tree = convert.from_jax_numpy(params, tcfg, device="cpu")
    return T, tcfg, T.Decoder(tree, tcfg, trainable=True).params


def decoder_grads(meshes, *, spec, params, tokens, cfg):
    """The decoder's loss and its gradients summed over the mesh."""
    from gpushare_device_plugin_tpu_torch.parallel.collectives import all_reduce_sum_
    from gpushare_device_plugin_tpu_torch.workloads.optim import tree_leaves

    mesh = _mesh(meshes, spec)
    T, tcfg, tp = _decoder(params, cfg)
    loss = T.loss_fn(tp, torch.from_numpy(tokens), tcfg, mesh)
    grads = list(torch.autograd.grad(loss, tree_leaves(tp)))
    all_reduce_sum_(grads, mesh, T.REPLICA_AXES)
    return {"loss": float(loss.detach()),
            "grads": {n: g.numpy() for n, g in zip(T._flatten(tp), grads)}}


def train_steps(meshes, *, spec, params, tokens, cfg, steps, accum_steps=1, lr=3e-4):
    """``steps`` steps of ``make_train_step`` with AdamW at ``lr`` on the
    same global batch; returns the losses and the parameters after."""
    from gpushare_device_plugin_tpu_torch.workloads.optim import make_optimizer

    mesh = _mesh(meshes, spec)
    T, tcfg, tp = _decoder(params, cfg)
    opt = make_optimizer(lr)
    step = T.make_train_step(tcfg, opt, accum_steps=accum_steps, mesh=mesh)
    state = opt.init(tp)
    losses = []
    for _ in range(steps):
        tp, state, loss = step(tp, state, torch.from_numpy(tokens))
        losses.append(float(loss))
    return {"losses": losses,
            "params": {n: t.detach().numpy() for n, t in T._flatten(tp).items()}}


JOBS = {"attention": attention, "decoder_grads": decoder_grads, "train_steps": train_steps}
