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


def _sharded(meshes, spec, params, cfg):
    """The mesh, the port's decoder module and config, and this rank's
    trainable shards of the reference-made ``params``."""
    from gpushare_device_plugin_tpu_torch.workloads import convert
    from gpushare_device_plugin_tpu_torch.workloads import transformer as T

    mesh = _mesh(meshes, spec)
    tcfg = T.TransformerConfig(**cfg, compute_dtype=torch.float32)
    whole = convert.from_jax_numpy(params, tcfg, device="cpu")
    return mesh, T, tcfg, T.Decoder(T.shard_params(whole, mesh, tcfg), tcfg, trainable=True).params


def _whole(T, tcfg, mesh, params, leaves):
    """Each of ``leaves`` (this rank's shards of the leaves of ``params``,
    in leaf order) gathered whole."""
    from gpushare_device_plugin_tpu_torch.parallel.mesh import unshard

    return [unshard(t.detach(), mesh, spec).numpy()
            for t, spec in zip(leaves, T.leaf_specs(params, mesh, tcfg))]


def shard_blocks(meshes, *, spec, params, cfg):
    """This rank's ``shard_params`` blocks; whether ``unshard`` gives the
    whole leaves back bit for bit; and, by leaf, what ``unshard_to``
    hands this rank (the whole leaf's bits on rank 0, None elsewhere)."""
    from gpushare_device_plugin_tpu_torch.parallel.mesh import unshard_to

    mesh, T, tcfg, tp = _sharded(meshes, spec, params, cfg)
    blocks = T._flatten(tp)
    whole = _whole(T, tcfg, mesh, tp, list(blocks.values()))
    ref = T._flatten(params)
    to_root = {}
    for (n, t), s in zip(blocks.items(), T.leaf_specs(tp, mesh, tcfg)):
        got = unshard_to(t, mesh, s)
        to_root[n] = None if got is None else bool(np.array_equal(got.numpy(), np.asarray(ref[n])))
    return {"blocks": {n: t.detach().numpy() for n, t in blocks.items()},
            "roundtrip": all(np.array_equal(w, np.asarray(ref[n])) for n, w in zip(blocks, whole)),
            "to_root": to_root}


def collectives(meshes, *, spec, seed):
    """``all_reduce`` (sum of bf16 partials, max) over tp, and
    ``all_reduce_sum_`` of a strided view over dp, on rank-seeded inputs;
    the results as f32 numpy, for the test to hold against its own sums."""
    from gpushare_device_plugin_tpu_torch.parallel.collectives import all_reduce, all_reduce_sum_

    mesh = _mesh(meshes, spec)
    x = torch.from_numpy(np.random.default_rng(seed + mesh.rank).normal(size=(3, 5))
                         .astype(np.float32))
    part = x.to(torch.bfloat16)
    total = all_reduce(part, mesh, "tp")
    top = all_reduce(x, mesh, "tp", op="max")
    base = x.clone()
    view = base[:, 1:4]  # strided: the sum must land in these elements only
    all_reduce_sum_([view], mesh, ("dp",))
    return {"x": x.numpy(), "sum_dtype": str(total.dtype), "sum": total.float().numpy(),
            "max": top.numpy(), "strided": base.numpy(),
            "traffic": {k: (v.calls, v.bytes) for k, v in mesh.traffic.items()}}


def tp_grads(meshes, *, spec, params, tokens, cfg):
    """The sharded decoder's loss and every leaf's gradient after
    ``sum_grads_``, gathered whole, with the traffic of the exchanges."""
    from gpushare_device_plugin_tpu_torch.workloads.optim import tree_leaves

    mesh, T, tcfg, tp = _sharded(meshes, spec, params, cfg)
    mesh.traffic.clear()
    leaves = tree_leaves(tp)
    loss = T.loss_fn(tp, torch.from_numpy(tokens), tcfg, mesh)
    grads = list(torch.autograd.grad(loss, leaves))
    T.sum_grads_(grads, tp, mesh, tcfg)
    return {"loss": float(loss.detach()),
            "grads": dict(zip(T._flatten(tp), _whole(T, tcfg, mesh, tp, grads))),
            "traffic": {kind: (t.calls, t.bytes) for kind, t in mesh.traffic.items()}}


def tp_train_steps(meshes, *, spec, params, tokens, cfg, steps, accum_steps=1, lr=3e-4,
                   clip_norm=None):
    """``steps`` sharded steps of ``make_train_step`` (AdamW at ``lr``,
    optionally clipped) on the same global batch; the losses, and the
    parameters after, gathered whole."""
    from gpushare_device_plugin_tpu_torch.workloads.optim import make_optimizer, tree_leaves

    mesh, T, tcfg, tp = _sharded(meshes, spec, params, cfg)
    opt = make_optimizer(lr, clip_norm=clip_norm)
    step = T.make_train_step(tcfg, opt, accum_steps=accum_steps, mesh=mesh)
    state = opt.init(tp)
    losses = []
    for _ in range(steps):
        tp, state, loss = step(tp, state, torch.from_numpy(tokens))
        losses.append(float(loss))
    return {"losses": losses,
            "params": dict(zip(T._flatten(tp), _whole(T, tcfg, mesh, tp, tree_leaves(tp)))),
            "state_bytes": nbytes(tp) + sum(nbytes(t) for t in tree_leaves(state))}


def tp_checkpoint(meshes, *, spec, cfg, batch, seq, steps, ckpt_dir):
    """``run_train_loop`` of a ``DecoderTask`` on the mesh for ``steps``
    steps, checkpointing into ``ckpt_dir``; the last loss, and the state
    after, gathered whole."""
    from gpushare_device_plugin_tpu_torch.workloads import transformer as T
    from gpushare_device_plugin_tpu_torch.workloads.optim import tree_leaves
    from gpushare_device_plugin_tpu_torch.workloads.trainer import (
        DecoderTask, TrainLoopConfig, run_train_loop)

    mesh = _mesh(meshes, spec)
    tcfg = T.TransformerConfig(**cfg, compute_dtype=torch.float32)
    task = DecoderTask(tcfg, batch, seq)
    state, loss = run_train_loop(task, TrainLoopConfig(total_steps=steps, log_every=1,
                                                       ckpt_dir=ckpt_dir, ckpt_every=2),
                                 seed=0, mesh=mesh)
    from gpushare_device_plugin_tpu_torch.parallel.mesh import unshard

    whole = [unshard(t.detach(), mesh, s).numpy()
             for t, s in zip(tree_leaves(state), task.state_specs(state, mesh))]
    return {"loss": loss, "state": whole}


def gang_env(tp: int) -> dict:
    """The plugin's env of a ``tp``-chip gang grant (one unit a chip)."""
    chips = ",".join(str(i) for i in range(tp))
    return {"TPU_VISIBLE_CHIPS": chips, "ALIYUN_COM_TPU_GANG_CHIPS": chips,
            "ALIYUN_COM_TPU_GANG_SHAPE": f"{tp}x1x1", "ALIYUN_COM_TPU_GANG_PER_CHIP": "1",
            "ALIYUN_COM_TPU_MEM_CONTAINER": str(tp), "ALIYUN_COM_TPU_MEM_DEV": "16"}


def nbytes(tree) -> int:
    """Bytes of a tree's tensors (a cache's ``len`` vector excluded)."""
    if isinstance(tree, dict):
        return sum(nbytes(v) for k, v in tree.items() if k != "len")
    return tree.numel() * tree.element_size()


def tp_serve(meshes, *, tp, kind, cfg, params, engine, trace, lora=None, draft=None,
             snapshot=None, pages=None):
    """Serve the port's ``trace`` (a trace function's name and keyword
    arguments) on a ``kind`` ("slot" or "paged") engine over the gang
    mesh of a ``tp``-chip grant, from the reference-made ``params``
    (``lora``: (LoraConfig fields, {id: tree}); ``draft``: (config fields,
    tree)). With ``snapshot``, restore it instead (no warmup). Returns
    the tokens by rid, the shape guard after warmup and after the run, and
    the bytes this rank holds of each buffer. ``pages``: (page ids, a
    single-chip engine's exported pages) to import after the run; the
    rank's export of them comes back as ``imported``."""
    from gpushare_device_plugin_tpu_torch.parallel.podenv import gang_mesh
    from gpushare_device_plugin_tpu_torch.serving import engine as E
    from gpushare_device_plugin_tpu_torch.workloads import convert
    from gpushare_device_plugin_tpu_torch.workloads import lora as L
    from gpushare_device_plugin_tpu_torch.workloads import transformer as T

    mesh = gang_mesh(env=gang_env(tp), device="cpu", backend="gloo")
    tcfg = T.TransformerConfig(**cfg, compute_dtype=torch.float32)
    kw = dict(engine, mesh=mesh, device="cpu")
    if lora is not None:
        lcfg = L.LoraConfig(**lora[0])
        kw.update(lora_cfg=lcfg, lora_store={
            aid: convert.lora_from_jax_numpy(tree, tcfg, lcfg, device="cpu")
            for aid, tree in lora[1].items()})
    if draft is not None:
        dcfg = T.TransformerConfig(**draft[0], compute_dtype=torch.float32)
        kw.update(draft_cfg=dcfg, draft_params=convert.from_jax_numpy(draft[1], dcfg, device="cpu"))
    whole = convert.from_jax_numpy(params, tcfg, device="cpu")
    eng = (E.SlotEngine if kind == "slot" else E.PagedSlotEngine)(whole, tcfg, **kw)
    if snapshot is None:
        eng.warmup()
        warm = dict(eng.trace_counts)
        stats = eng.run(getattr(E, trace[0])(**trace[1]))
    else:
        warm = None
        stats = eng.restore_snapshot(snapshot)
    out = {"tokens": {r.rid: list(r.tokens) for r in stats.results}, "warm": warm,
           "after": dict(eng.trace_counts), "weights": nbytes(eng.params),
           "cache": nbytes(eng.cache)}
    if pages is not None:
        eng.import_kv_pages(*pages)
        out["imported"] = eng.export_kv_pages(pages[0])
    if kind == "paged":
        out["pages_per_adapter"] = getattr(eng, "pages_per_adapter", 0)
        out["slab"] = nbytes(eng._lora_slab) if eng.adapters is not None else 0
        out["draft"] = nbytes(eng.draft_cache) if eng.draft_cache is not None else 0
        out["draft_weights"] = nbytes(eng.draft_params) if eng.draft_cache is not None else 0
        if eng.adapters is not None:
            out["leak_free"] = (eng.allocator.used_pages
                                == eng.radix.cached_pages + eng.adapters.cached_pages)
        else:
            out["leak_free"] = eng.allocator.used_pages == eng.radix.cached_pages
    return out


def _model(kind: str):
    """The port's module for ``kind`` ("bert" or "resnet")."""
    from gpushare_device_plugin_tpu_torch.workloads import bert, resnet

    return {"bert": bert, "resnet": resnet}[kind]


def _model_shards(meshes, kind, spec, params, cfg, state=None):
    """The mesh, the module, its f32 config, and this rank's trainable
    shards of the reference-made ``params`` (ResNet's: and its BN state)."""
    from gpushare_device_plugin_tpu_torch.workloads import convert

    mesh = _mesh(meshes, spec)
    M = _model(kind)
    if kind == "bert":
        mcfg = M.BertConfig(**cfg, compute_dtype=torch.float32)
        whole, bn = convert.bert_from_jax_numpy(params, mcfg, device="cpu"), None
        shards = M.shard_params(whole, mesh, mcfg)
    else:
        mcfg = M.ResNetConfig(**cfg, compute_dtype=torch.float32)
        whole, bn = convert.resnet_from_jax_numpy(params, state, mcfg, device="cpu")
        shards, bn = M.shard_params(whole, bn, mesh, mcfg)
    from gpushare_device_plugin_tpu_torch.workloads.optim import tree_leaves

    for t in tree_leaves(shards):
        t.requires_grad_()
    return mesh, M, mcfg, shards, bn


def _by_name(M, mcfg, mesh, tree, leaves):
    """``leaves`` (this rank's shards of ``tree``'s leaves, in order)
    gathered whole, by flattened leaf name."""
    from gpushare_device_plugin_tpu_torch.parallel.mesh import unshard
    from gpushare_device_plugin_tpu_torch.workloads.transformer import _flatten

    return {n: unshard(t.detach(), mesh, spec).numpy() for n, t, spec in
            zip(_flatten(tree), leaves, M.leaf_specs(tree, mesh, mcfg))}


def _flat_numpy(tree) -> dict:
    from gpushare_device_plugin_tpu_torch.workloads.transformer import _flatten

    return {n: t.detach().numpy() for n, t in _flatten(tree).items()}


def _batch_tensors(batch) -> tuple:
    return tuple(torch.from_numpy(np.asarray(a)) for a in batch)


def model_grads(meshes, *, kind, spec, params, cfg, batch, state=None):
    """BERT's or ResNet's sharded loss and every leaf's gradient after the
    sums of ``grad_sum_axes``, gathered whole (ResNet's: and its new BN
    state); with the traffic of the exchanges and the rank's specs."""
    from gpushare_device_plugin_tpu_torch.parallel.collectives import all_reduce_sum_
    from gpushare_device_plugin_tpu_torch.workloads.optim import tree_leaves

    mesh, M, mcfg, shards, bn = _model_shards(meshes, kind, spec, params, cfg, state)
    mesh.traffic.clear()
    leaves = tree_leaves(shards)
    args = _batch_tensors(batch)
    out = {}
    if kind == "bert":
        loss = M.loss_fn(shards, *args, mcfg, mesh)
    else:
        loss, new_bn = M.loss_fn(shards, bn, *args, mcfg, mesh)
        out["bn"] = _flat_numpy(new_bn)
    grads = list(torch.autograd.grad(loss, leaves, materialize_grads=True))
    for g, axes in zip(grads, M.grad_sum_axes(shards, mesh, mcfg)):
        all_reduce_sum_([g], mesh, axes)
    out.update(loss=float(loss.detach()), grads=_by_name(M, mcfg, mesh, shards, grads),
               specs=dict(zip(_flat_numpy(shards), M.leaf_specs(shards, mesh, mcfg))),
               shard_bytes=nbytes(shards),
               traffic={k: (t.calls, t.bytes) for k, t in mesh.traffic.items()})
    return out


def model_train_steps(meshes, *, kind, spec, params, cfg, batch, steps, lr, state=None):
    """``steps`` sharded steps of BERT's (AdamW at ``lr``) or ResNet's (SGD,
    Nesterov 0.9 at ``lr``) ``make_train_step`` on the same global batch;
    the losses, the params after, gathered whole (ResNet's: and the BN
    state)."""
    mesh, M, mcfg, shards, bn = _model_shards(meshes, kind, spec, params, cfg, state)
    opt = M.make_optimizer(lr)
    step = M.make_train_step(mcfg, opt, mesh=mesh)
    opt_state = opt.init(shards)
    args = _batch_tensors(batch)
    losses = []
    for _ in range(steps):
        if kind == "bert":
            shards, opt_state, loss = step(shards, opt_state, *args)
        else:
            shards, bn, opt_state, loss = step(shards, bn, opt_state, *args)
        losses.append(float(loss))
    from gpushare_device_plugin_tpu_torch.workloads.optim import tree_leaves

    out = {"losses": losses,
           "params": _by_name(M, mcfg, mesh, shards, tree_leaves(shards))}
    if bn is not None:
        out["bn"] = _flat_numpy(bn)
    return out


def task_checkpoint(meshes, *, kind, spec, cfg, batch, size, steps, ckpt_dir):
    """``run_train_loop`` of a ``BertTask`` (``size``: the sequence) or a
    ``ResNetTask`` (``size``: the image side) on the mesh for ``steps``
    steps, checkpointing into ``ckpt_dir`` every 2; the state after,
    gathered whole."""
    from gpushare_device_plugin_tpu_torch.parallel.mesh import unshard
    from gpushare_device_plugin_tpu_torch.workloads.optim import tree_leaves
    from gpushare_device_plugin_tpu_torch.workloads.trainer import (
        BertTask, ResNetTask, TrainLoopConfig, run_train_loop)

    mesh = _mesh(meshes, spec)
    M = _model(kind)
    if kind == "bert":
        task = BertTask(M.BertConfig(**cfg, compute_dtype=torch.float32), batch, size)
    else:
        task = ResNetTask(M.ResNetConfig(**cfg, compute_dtype=torch.float32), batch, size)
    state, loss = run_train_loop(task, TrainLoopConfig(total_steps=steps, log_every=1,
                                                       ckpt_dir=ckpt_dir, ckpt_every=2),
                                 seed=0, mesh=mesh)
    whole = [unshard(t.detach(), mesh, s).numpy()
             for t, s in zip(tree_leaves(state), task.state_specs(state, mesh))]
    return {"loss": loss, "state": whole}


JOBS = {"attention": attention, "decoder_grads": decoder_grads, "train_steps": train_steps,
        "shard_blocks": shard_blocks, "tp_grads": tp_grads, "tp_train_steps": tp_train_steps,
        "tp_checkpoint": tp_checkpoint, "tp_serve": tp_serve,
        "collectives": collectives, "model_grads": model_grads,
        "model_train_steps": model_train_steps, "task_checkpoint": task_checkpoint}
