"""The decoder's tensor-parallel and FSDP training (gpushare_device_plugin_
tpu_torch/workloads/transformer.py on tp, fsdp, fsdp x tp, dp x tp and
fsdp x tp x sp meshes) on gloo ranks, against the reference's sharded
``loss_fn`` and ``make_train_step`` on host devices: the port's
counterparts of tests/test_workloads.py's mesh training tests, with the
same weights (reference-made, crossed over with
``convert.from_jax_numpy`` and cut by ``shard_params``) and the same numpy
tokens.

Three spawns, started together, run every case: two ranks (tp=2, fsdp=2,
and the checkpoints), four (fsdp=2 x tp=2, dp=2 x tp=2 and tp=4, where tp
does not divide the two kv heads, so ``wkv`` is replicated and each rank
selects the head its q heads use) and eight (fsdp=2 x tp=2 x sp=2 with
the ring). Remat "full" and "dots"; ``accum_steps=2``; AdamW with and
without ``clip_norm``.

Tolerances, f32: loss rtol 1e-5; every leaf's gradient, summed by
``sum_grads_`` and gathered whole, within 1e-4 relative Frobenius norm of
the reference's; after AdamW steps the losses rtol 1e-5 and the
parameters atol 1e-5 (the update of a near-zero gradient can flip sign,
so Adam's step of lr there is allowed on at most 0.1% of the entries).
"""

import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpushare_device_plugin_tpu.parallel import MeshSpec as JMeshSpec
from gpushare_device_plugin_tpu.parallel import make_mesh as jmake_mesh
from gpushare_device_plugin_tpu.workloads import optim as JO
from gpushare_device_plugin_tpu.workloads import transformer as JT
from gpushare_device_plugin_tpu_torch.workloads import transformer as T
from gpushare_device_plugin_tpu_torch.workloads.optim import tree_leaves
from gpushare_device_plugin_tpu_torch.workloads.trainer import (
    DecoderTask,
    TrainLoopConfig,
    run_train_loop,
)

import torch_ranks
from torch_parity import SHAPE, to_numpy, tokens

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
PARAM_ATOL = 1e-5
LR = 1e-2
TOKENS = tokens((4, 16), seed=5)
RING = dict(seq_parallel=True, context_parallel="ring")

# name: (mesh spec, remat policy, config overrides)
GRAD_CASES = {
    "tp2_full": (dict(tp=2), "full", {}),
    "tp2_dots": (dict(tp=2), "dots", {}),
    "fsdp2_full": (dict(fsdp=2), "full", {}),
    "fsdp2_dots": (dict(fsdp=2), "dots", {}),
    "fsdp2_tp2_full": (dict(fsdp=2, tp=2), "full", {}),
    "fsdp2_tp2_dots": (dict(fsdp=2, tp=2), "dots", {}),
    "dp2_tp2_full": (dict(dp=2, tp=2), "full", {}),
    "tp4_replicated_wkv_full": (dict(tp=4), "full", {}),
    "tp4_replicated_wkv_dots": (dict(tp=4), "dots", {}),
    "fsdp2_tp2_sp2_ring": (dict(fsdp=2, tp=2, sp=2), "full", RING),
}
# name: (mesh spec, steps, accum_steps, clip_norm, config overrides)
STEP_CASES = {
    "step_tp2": (dict(tp=2), 2, 1, None, {}),
    "step_fsdp2_clip": (dict(fsdp=2), 2, 1, 1.0, {}),
    "step_fsdp2_tp2_clip": (dict(fsdp=2, tp=2), 2, 1, 1.0, {}),
    "step_dp2_tp2_accum2": (dict(dp=2, tp=2), 2, 2, None, {}),
    "step_tp4_replicated_wkv_clip": (dict(tp=4), 2, 1, 1.0, {}),
    "step_fsdp2_tp2_sp2_ring": (dict(fsdp=2, tp=2, sp=2), 1, 1, 1.0, RING),
}
CKPT_CFG = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, max_seq=32)
CKPT_BATCH, CKPT_SEQ = 4, 16


def _world(spec):
    return int(np.prod(list(spec.values())))


@functools.cache
def _params():
    return to_numpy(JT.init_params(jax.random.key(0), JT.TransformerConfig(**SHAPE)))


def _cfg(remat="full", **kw):
    return dict(SHAPE, remat_policy=remat, **kw)


def _jobs(world, tmp):
    jobs = [(name, "tp_grads", dict(spec=spec, params=_params(), tokens=TOKENS,
                                    cfg=_cfg(remat, **kw)))
            for name, (spec, remat, kw) in GRAD_CASES.items() if _world(spec) == world]
    jobs += [(name, "tp_train_steps", dict(spec=spec, params=_params(), tokens=TOKENS,
                                           cfg=_cfg(**kw), steps=steps, accum_steps=accum,
                                           lr=LR, clip_norm=clip))
             for name, (spec, steps, accum, clip, kw) in STEP_CASES.items()
             if _world(spec) == world]
    if world == 2:
        jobs.append(("shards", "shard_blocks", dict(spec=dict(fsdp=2), params=_params(),
                                                   cfg=_cfg())))
        ck = dict(spec=dict(fsdp=2), cfg=CKPT_CFG, batch=CKPT_BATCH, seq=CKPT_SEQ)
        jobs.append(("ckpt_written_at_fsdp2", "tp_checkpoint",
                     dict(ck, steps=2, ckpt_dir=str(tmp / "fsdp2"))))
        jobs.append(("ckpt_restored_at_fsdp2", "tp_checkpoint",
                     dict(ck, steps=4, ckpt_dir=str(tmp / "fsdp1"))))
    return jobs


@functools.cache
def _uninterrupted():
    return [t.detach().numpy() for t in tree_leaves(_loop(4)[0])]


def _loop(steps, ckpt_dir=""):
    """The one-process (fsdp=1) run of the checkpoint cases."""
    cfg = T.TransformerConfig(**CKPT_CFG, compute_dtype=torch.float32)
    return run_train_loop(DecoderTask(cfg, CKPT_BATCH, CKPT_SEQ),
                          TrainLoopConfig(total_steps=steps, log_every=1, ckpt_dir=str(ckpt_dir),
                                          ckpt_every=2), 0, device="cpu")


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("tpckpt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, tmp):
    """The three spawns' results, each rank's by job name, by world size."""
    _loop(2, tmp / "fsdp1")  # a one-process checkpoint at step 1, for fsdp=2 to resume
    handles = {world: torch_ranks.start(world, _jobs(world, tmp),
                                        tmp_path_factory.mktemp(f"tp{world}"))
               for world in (2, 4, 8)}
    try:
        # The reference's side (cached for the tests) while the ranks run.
        for name in GRAD_CASES:
            _reference_grads(name)
        for name in STEP_CASES:
            _reference_steps(name)
        _uninterrupted()
    finally:
        out = {world: torch_ranks.collect(h) for world, h in handles.items()}
    return out


def _jcfg(remat="full", **kw):
    return JT.TransformerConfig(**SHAPE, compute_dtype=jnp.float32, remat_policy=remat, **kw)


def _jmesh(spec):
    return jmake_mesh(JMeshSpec(**spec), devices=jax.devices()[:_world(spec)])


@functools.cache
def _reference_grads(name):
    spec, remat, kw = GRAD_CASES[name]
    cfg, mesh = _jcfg(remat, **kw), _jmesh(spec)
    params = JT.shard_params(jax.tree.map(jnp.asarray, _params()), mesh, cfg)
    fn = jax.jit(lambda p, t: jax.value_and_grad(JT.loss_fn)(p, t, cfg, mesh))
    loss, grads = fn(params, jnp.asarray(TOKENS))
    return float(loss), to_numpy(grads)


@functools.cache
def _reference_steps(name):
    spec, steps, accum, clip, kw = STEP_CASES[name]
    cfg, mesh = _jcfg(**kw), _jmesh(spec)
    params = JT.shard_params(jax.tree.map(jnp.asarray, _params()), mesh, cfg)
    opt = JO.make_optimizer(LR, clip_norm=clip)
    state = opt.init(params)
    step = JT.make_train_step(mesh, cfg, opt, accum_steps=accum)
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, jnp.asarray(TOKENS))
        losses.append(float(loss))
    return losses, to_numpy(params)


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_loss_matches_reference_on_every_rank(ranks, name):
    spec = GRAD_CASES[name][0]
    want, _ = _reference_grads(name)
    for r in ranks[_world(spec)]:
        np.testing.assert_allclose(r[name]["loss"], want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_every_leaf_gradient_matches_reference(ranks, name):
    """The norms' gains catch a missing copy_to_tp (their gradient left
    partial on each tp rank) or a doubled reduce_from_tp; the tp x fsdp
    cases, a leaf summed over the wrong axes."""
    spec = GRAD_CASES[name][0]
    _, want = _reference_grads(name)
    for r in ranks[_world(spec)]:
        got = r[name]["grads"]
        for leaf, w in T._flatten(want).items():
            w = np.asarray(w)
            rel = np.linalg.norm(got[leaf] - w) / np.linalg.norm(w)
            assert rel <= GRAD_REL, (name, leaf, rel)


@pytest.mark.parametrize("name", [n for n in GRAD_CASES if "tp" in n])
def test_tp_ranks_exchange_all_reduces(ranks, name):
    spec = GRAD_CASES[name][0]
    for r in ranks[_world(spec)]:
        calls, nbytes = r[name]["traffic"]["tp_all_reduce"]
        assert calls > 0 and nbytes > 0
        if spec.get("fsdp", 1) > 1:
            assert r[name]["traffic"]["reduce_scatter"][0] > 0


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_adamw_steps_match_reference_make_train_step(ranks, name):
    spec = STEP_CASES[name][0]
    want_losses, want_params = _reference_steps(name)
    for r in ranks[_world(spec)]:
        np.testing.assert_allclose(r[name]["losses"], want_losses, rtol=LOSS_RTOL)
        for leaf, w in T._flatten(want_params).items():
            diff = np.abs(r[name]["params"][leaf] - np.asarray(w))
            assert diff.max() <= 2 * LR, (name, leaf, diff.max())
            assert (diff > PARAM_ATOL).mean() <= 1e-3, (name, leaf, (diff > PARAM_ATOL).mean())


def test_shards_are_the_reference_addressable_shards(ranks):
    """Each rank's ``shard_params`` block is bit-equal to the matching
    addressable shard of the reference's ``shard_params`` (fsdp=2), and
    ``unshard`` gives every leaf back whole."""
    cfg, mesh = _jcfg(), _jmesh(dict(fsdp=2))
    ref = JT.shard_params(jax.tree.map(jnp.asarray, _params()), mesh, cfg)
    for rank, r in enumerate(ranks[2]):
        assert r["shards"]["roundtrip"]
        for leaf, arr in T._flatten(ref).items():
            (want,) = [np.asarray(s.data) for s in arr.addressable_shards
                       if s.device == jax.devices()[rank]]
            np.testing.assert_array_equal(r["shards"]["blocks"][leaf], want)


def _assert_state_close(got, want):
    for g, w in zip(got, want):
        diff = np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64))
        assert diff.max() <= 2 * 3e-4 and (diff > PARAM_ATOL).mean() <= 1e-3


def test_checkpoint_written_at_fsdp2_restores_at_fsdp1(ranks, tmp):
    whole = _uninterrupted()
    for r in ranks[2]:
        assert [np.shape(x) for x in r["ckpt_written_at_fsdp2"]["state"]] == \
            [np.shape(x) for x in whole]
    resumed = tmp / "fsdp2_resumed"
    shutil.copytree(tmp / "fsdp2", resumed)
    state, _ = _loop(4, resumed)
    _assert_state_close([t.detach().numpy() for t in tree_leaves(state)], whole)


def test_checkpoint_written_at_fsdp1_restores_at_fsdp2(ranks):
    whole = _uninterrupted()
    for r in ranks[2]:
        _assert_state_close(r["ckpt_restored_at_fsdp2"]["state"], whole)
