"""BERT's sharded training (gpushare_device_plugin_tpu_torch/workloads/
bert.py on fsdp, tp and fsdp x tp meshes) on gloo ranks, against the
reference's sharded ``loss_fn`` and ``make_train_step`` on host devices,
at tests/test_workloads_vision_nlp.py's TINY_BERT (f32), with the same
weights (reference-made, crossed over with ``convert.bert_from_jax_numpy``
and cut by ``shard_params``) and the same numpy batch.

The meshes: fsdp=2, tp=2, the reference test's fsdp=2 x tp=4, and tp=4 at
vocab 62, which tp does not divide: pruning leaves ``embed`` and
``out_bias`` whole over tp, the layout BERT-base's 30,522 takes at tp=4,
so the lookup and the tied head run unsharded while the heads and the
MLP stay cut. Three spawns run every case, started together: two ranks
(fsdp=2, tp=2 and the checkpoints), four and eight.

Tolerances, f32: the first loss rtol 1e-5; every leaf's gradient, summed
over ``grad_sum_axes`` and gathered whole, atol 1e-5 (f32 sums in another
order); after two AdamW steps the losses rtol 1e-5 and the params atol
1e-5, as tests/test_torch_tp_train.py (Adam turns a sign flip of a
near-zero gradient into a step of up to 2·lr, allowed on at most 0.1% of
the entries).
"""

import functools
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpushare_device_plugin_tpu.parallel import MeshSpec as JMeshSpec
from gpushare_device_plugin_tpu.parallel import make_mesh as jmake_mesh
from gpushare_device_plugin_tpu.workloads import bert as JB
from gpushare_device_plugin_tpu_torch.parallel.mesh import AXES, local_shape, shard_axes
from gpushare_device_plugin_tpu_torch.workloads import bert as B
from gpushare_device_plugin_tpu_torch.workloads.optim import tree_leaves
from gpushare_device_plugin_tpu_torch.workloads.transformer import _flatten
from gpushare_device_plugin_tpu_torch.workloads.trainer import (
    BertTask,
    TrainLoopConfig,
    run_train_loop,
)

import torch_ranks
from torch_parity import to_numpy

TINY_BERT = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_seq=32)
VOCAB62 = dict(TINY_BERT, vocab=62)
LOSS_RTOL = 1e-5
ATOL = 1e-5
LR = 1e-2
BATCH, SEQ = 8, 16

# name: (mesh spec, config)
CASES = {
    "fsdp2": (dict(fsdp=2), TINY_BERT),
    "tp2": (dict(tp=2), TINY_BERT),
    "fsdp2_tp4": (dict(fsdp=2, tp=4), TINY_BERT),
    "tp4_vocab62": (dict(tp=4), VOCAB62),
}
CKPT_STEPS = 4


def _world(spec):
    return int(np.prod(list(spec.values())))


def _batch(vocab, seed=3):
    rng = np.random.RandomState(seed)
    targets = rng.randint(2, vocab, size=(BATCH, SEQ)).astype(np.int32)
    mask = (rng.rand(BATCH, SEQ) < 0.3).astype(np.float32)
    tokens = np.where(mask == 1.0, 1, targets).astype(np.int32)
    return tokens, targets, mask


@functools.cache
def _params(vocab):
    cfg = JB.BertConfig(**dict(TINY_BERT, vocab=vocab), compute_dtype=jnp.float32)
    return to_numpy(JB.init_params(jax.random.key(0), cfg))


def _job_kw(name):
    spec, cfg = CASES[name]
    return dict(kind="bert", spec=spec, params=_params(cfg["vocab"]), cfg=cfg,
                batch=_batch(cfg["vocab"]))


def _jobs(world, tmp):
    jobs = []
    for name, (spec, _) in CASES.items():
        if _world(spec) == world:
            jobs.append((name, "model_grads", _job_kw(name)))
            jobs.append((f"{name}_steps", "model_train_steps",
                         dict(_job_kw(name), steps=2, lr=LR)))
    if world == 2:
        ck = dict(kind="bert", cfg=TINY_BERT, batch=4, size=SEQ)
        jobs.append(("ckpt_written_at_fsdp2", "task_checkpoint",
                     dict(ck, spec=dict(fsdp=2), steps=2, ckpt_dir=str(tmp / "fsdp2"))))
        jobs.append(("ckpt_restored_at_tp2", "task_checkpoint",
                     dict(ck, spec=dict(tp=2), steps=CKPT_STEPS, ckpt_dir=str(tmp / "one"))))
    return jobs


def _loop(steps, ckpt_dir=""):
    """The one-process run of the checkpoint cases."""
    task = BertTask(B.BertConfig(**TINY_BERT, compute_dtype=torch.float32), 4, SEQ)
    return run_train_loop(task, TrainLoopConfig(total_steps=steps, log_every=1,
                                                ckpt_dir=str(ckpt_dir), ckpt_every=2),
                          0, device="cpu")


@functools.cache
def _uninterrupted():
    return [t.detach().numpy() for t in tree_leaves(_loop(CKPT_STEPS)[0])]


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("bertckpt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, tmp):
    """The three spawns' results, each rank's by job name, by world size."""
    _loop(2, tmp / "one")  # a one-process checkpoint at step 1, for tp=2 to resume
    handles = {world: torch_ranks.start(world, _jobs(world, tmp),
                                        tmp_path_factory.mktemp(f"bert{world}"))
               for world in (2, 4, 8)}
    try:
        # The reference's side (cached for the tests) while the ranks run.
        for name in CASES:
            _reference_grads(name)
            _reference_steps(name)
        _uninterrupted()
    finally:
        out = {world: torch_ranks.collect(h) for world, h in handles.items()}
    return out


def _jsetup(name):
    spec, cfg = CASES[name]
    jcfg = JB.BertConfig(**cfg, compute_dtype=jnp.float32)
    mesh = jmake_mesh(JMeshSpec(**spec), devices=jax.devices()[:_world(spec)])
    params = JB.shard_params(jax.tree.map(jnp.asarray, _params(cfg["vocab"])), mesh, jcfg)
    return jcfg, mesh, params, tuple(jnp.asarray(a) for a in _batch(cfg["vocab"]))


@functools.cache
def _reference_grads(name):
    jcfg, mesh, params, batch = _jsetup(name)
    fn = jax.jit(lambda p, *b: jax.value_and_grad(JB.loss_fn)(p, *b, jcfg, mesh))
    loss, grads = fn(params, *batch)
    return float(loss), to_numpy(grads)


@functools.cache
def _reference_steps(name):
    jcfg, mesh, params, batch = _jsetup(name)
    opt = JB.make_optimizer(LR)
    state = opt.init(params)
    step = JB.make_train_step(mesh, jcfg, opt)
    losses = []
    for _ in range(2):
        params, state, loss = step(params, state, *batch)
        losses.append(float(loss))
    return losses, to_numpy(params)


def _reference_specs(spec, cfg):
    """The reference's pruned specs for ``cfg`` on ``spec``, each a tuple
    with one entry per dim."""
    jcfg = JB.BertConfig(**cfg, compute_dtype=jnp.float32)
    mesh = jmake_mesh(JMeshSpec(**spec), devices=jax.devices()[:_world(spec)])
    shardings = JB.param_shardings(mesh, jcfg)
    shapes = jax.eval_shape(lambda: JB.init_params(jax.random.key(0), jcfg))
    return {n: tuple(s.spec) + (None,) * (len(shapes_n.shape) - len(s.spec))
            for (n, s), shapes_n in zip(_flatten(shardings).items(),
                                        _flatten(shapes).values())}


def _fake_mesh(spec):
    return types.SimpleNamespace(shape={a: spec.get(a, 1) for a in AXES})


@pytest.mark.parametrize("name", list(CASES))
def test_pruned_specs_equal_the_reference(name):
    spec, cfg = CASES[name]
    tcfg = B.BertConfig(**cfg, compute_dtype=torch.float32)
    got = _flatten(B.param_shardings(_fake_mesh(spec), tcfg))
    assert got == _reference_specs(spec, cfg)
    if name == "tp4_vocab62":
        assert "tp" not in shard_axes(got["embed"]) and got["mlm__out_bias"] == (None,)
        assert got["layers__wqkv"][3] == "tp" and got["layers__wi"][2] == "tp"


@pytest.mark.parametrize("name", list(CASES))
def test_first_loss_matches_reference_on_every_rank(ranks, name):
    spec = CASES[name][0]
    want, _ = _reference_grads(name)
    for r in ranks[_world(spec)]:
        np.testing.assert_allclose(r[name]["loss"], want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_every_leaf_gradient_matches_reference(ranks, name):
    """The layer norms' gains catch a missing ``copy_to_tp`` (their
    gradient left partial on each tp rank) or a sum over tp; ``mlm.dense``
    the MLM head's gather over tp; the fsdp cases, a leaf summed over the
    wrong axes or a mask count taken per rank."""
    spec = CASES[name][0]
    _, want = _reference_grads(name)
    for r in ranks[_world(spec)]:
        got = r[name]["grads"]
        assert set(got) == set(_flatten(want))
        for leaf, w in _flatten(want).items():
            np.testing.assert_allclose(got[leaf], np.asarray(w), atol=ATOL, rtol=0,
                                       err_msg=f"{name} {leaf}")


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_shards(ranks, name):
    spec, cfg = CASES[name]
    tcfg = B.BertConfig(**cfg, compute_dtype=torch.float32)
    mesh = _fake_mesh(spec)
    specs = _flatten(B.param_shardings(mesh, tcfg))
    want = sum(int(np.prod(local_shape(shape, specs[n], mesh))) * 4
               for n, shape in _flatten(B.param_shapes(tcfg)).items())
    for r in ranks[_world(spec)]:
        assert r[name]["shard_bytes"] == want
        if spec.get("tp", 1) > 1:
            assert r[name]["traffic"]["tp_all_reduce"][0] > 0
        if spec.get("fsdp", 1) > 1:
            assert r[name]["traffic"]["reduce_scatter"][0] > 0


@pytest.mark.parametrize("name", list(CASES))
def test_adamw_steps_match_reference_make_train_step(ranks, name):
    spec = CASES[name][0]
    want_losses, want_params = _reference_steps(name)
    for r in ranks[_world(spec)]:
        got = r[f"{name}_steps"]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
        for leaf, w in _flatten(want_params).items():
            diff = np.abs(got["params"][leaf] - np.asarray(w))
            assert diff.max() <= 2 * LR, (name, leaf, diff.max())
            assert (diff > ATOL).mean() <= 1e-3, (name, leaf, (diff > ATOL).mean())


def _assert_state_close(got, want):
    assert [np.shape(x) for x in got] == [np.shape(x) for x in want]
    for g, w in zip(got, want):
        diff = np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64))
        assert diff.max() <= 2 * 1e-4 and (diff > ATOL).mean() <= 1e-3


def test_checkpoint_written_at_fsdp2_restores_on_one_rank(ranks, tmp):
    resumed = tmp / "fsdp2_resumed"
    shutil.copytree(tmp / "fsdp2", resumed)
    state, _ = _loop(CKPT_STEPS, resumed)
    _assert_state_close([t.detach().numpy() for t in tree_leaves(state)], _uninterrupted())


def test_checkpoint_written_on_one_rank_restores_at_tp2(ranks):
    for r in ranks[2]:
        _assert_state_close(r["ckpt_restored_at_tp2"]["state"], _uninterrupted())
