"""ResNet's sharded training (gpushare_device_plugin_tpu_torch/workloads/
resnet.py on dp, fsdp and dp x fsdp x tp meshes) on gloo ranks, against
the reference's sharded ``loss_fn`` and ``make_train_step`` on host
devices, at tests/test_workloads_vision_nlp.py's TINY_RESNET (f32), with
the same weights (reference-made, crossed from HWIO to OIHW with
``convert.resnet_from_jax_numpy`` and cut by ``shard_params``) and the
same numpy images.

Under GSPMD the reference's training batch norm takes its statistics
over the global batch; the port's is synchronized over the data axes
(``collectives.psum``), so its loss, gradients and new BN state must be
the reference's on every mesh. On dp=2 x fsdp=2 x tp=2 the classifier's
logits are cut on the classes and go through the vocab-parallel
cross-entropy. Two spawns run every case, started together: two ranks
(dp=2, fsdp=2 and the checkpoints) and eight.

Tolerances, f32, as tests/test_torch_resnet.py: the first loss rtol
1e-5; every leaf's gradient, summed over ``grad_sum_axes`` and gathered
whole, atol 1e-5; the BN state atol 1e-5; after two SGD steps (Nesterov
0.9 at 0.1) the losses rtol 1e-5 and the params and BN state atol 1e-5.
A checkpoint written at dp=2 (fsdp=2) after two steps and resumed on one
rank (fsdp=2) for a third: the whole state within atol 1e-4 of the
uninterrupted one-rank run (the recipe's first steps amplify the f32
summation order that the meshes change, tests/test_torch_resnet.py).
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
from gpushare_device_plugin_tpu.workloads import resnet as JR
from gpushare_device_plugin_tpu_torch.parallel.mesh import AXES, local_shape
from gpushare_device_plugin_tpu_torch.workloads import resnet as R
from gpushare_device_plugin_tpu_torch.workloads.optim import tree_leaves
from gpushare_device_plugin_tpu_torch.workloads.transformer import _flatten
from gpushare_device_plugin_tpu_torch.workloads.trainer import (
    ResNetTask,
    TrainLoopConfig,
    run_train_loop,
)

import torch_ranks
from torch_parity import to_numpy

TINY_RESNET = dict(stage_sizes=(1, 2), width=8, num_classes=10)
LOSS_RTOL = 1e-5
ATOL = 1e-5
LR = 0.1
BATCH, SIZE = 8, 32

CASES = {"dp2": dict(dp=2), "fsdp2": dict(fsdp=2), "dp2_fsdp2_tp2": dict(dp=2, fsdp=2, tp=2)}
CKPT_STEPS = 3
CKPT_ATOL = 1e-4


def _world(spec):
    return int(np.prod(list(spec.values())))


def _batch(seed=4):
    rng = np.random.RandomState(seed)
    images = rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
    labels = rng.randint(0, 10, size=(BATCH,)).astype(np.int32)
    return images, labels


def _jcfg():
    return JR.ResNetConfig(**TINY_RESNET, compute_dtype=jnp.float32)


@functools.cache
def _params():
    params, state = JR.init_params(jax.random.key(0), _jcfg())
    return to_numpy(params), to_numpy(state)


def _job_kw(name):
    params, state = _params()
    return dict(kind="resnet", spec=CASES[name], params=params, state=state, cfg=TINY_RESNET,
                batch=_batch())


def _jobs(world, tmp):
    jobs = []
    for name, spec in CASES.items():
        if _world(spec) == world:
            jobs.append((name, "model_grads", _job_kw(name)))
            jobs.append((f"{name}_steps", "model_train_steps",
                         dict(_job_kw(name), steps=2, lr=LR)))
    if world == 2:
        ck = dict(kind="resnet", cfg=TINY_RESNET, batch=4, size=16)
        jobs.append(("ckpt_written_at_dp2", "task_checkpoint",
                     dict(ck, spec=dict(dp=2), steps=2, ckpt_dir=str(tmp / "dp2"))))
        jobs.append(("ckpt_restored_at_fsdp2", "task_checkpoint",
                     dict(ck, spec=dict(fsdp=2), steps=CKPT_STEPS, ckpt_dir=str(tmp / "one"))))
    return jobs


def _loop(steps, ckpt_dir=""):
    """The one-process run of the checkpoint cases."""
    task = ResNetTask(R.ResNetConfig(**TINY_RESNET, compute_dtype=torch.float32), 4, 16)
    return run_train_loop(task, TrainLoopConfig(total_steps=steps, log_every=1,
                                                ckpt_dir=str(ckpt_dir), ckpt_every=2),
                          0, device="cpu")


@functools.cache
def _uninterrupted():
    return [t.detach().numpy() for t in tree_leaves(_loop(CKPT_STEPS)[0])]


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("resnetckpt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, tmp):
    """The two spawns' results, each rank's by job name, by world size."""
    _loop(2, tmp / "one")  # a one-process checkpoint at step 1, for fsdp=2 to resume
    handles = {world: torch_ranks.start(world, _jobs(world, tmp),
                                        tmp_path_factory.mktemp(f"resnet{world}"))
               for world in (2, 8)}
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
    spec = CASES[name]
    mesh = jmake_mesh(JMeshSpec(**spec), devices=jax.devices()[:_world(spec)])
    params, state = jax.tree.map(jnp.asarray, _params())
    params, state = JR.shard_params(params, state, mesh, _jcfg())
    return mesh, params, state, tuple(jnp.asarray(a) for a in _batch())


@functools.cache
def _reference_grads(name):
    mesh, params, state, batch = _jsetup(name)
    fn = jax.jit(lambda p, s, *b: jax.value_and_grad(JR.loss_fn, has_aux=True)(
        p, s, *b, _jcfg()))
    (loss, new_state), grads = fn(params, state, *batch)
    return float(loss), to_numpy(grads), to_numpy(new_state)


@functools.cache
def _reference_steps(name):
    mesh, params, state, batch = _jsetup(name)
    opt = JR.make_optimizer(LR)
    opt_state = opt.init(params)
    step = JR.make_train_step(mesh, _jcfg(), opt)
    losses = []
    for _ in range(2):
        params, state, opt_state, loss = step(params, state, opt_state, *batch)
        losses.append(float(loss))
    return losses, to_numpy(params), to_numpy(state)


def _to_oihw(a):
    a = np.asarray(a)
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 5:
        return a.transpose(0, 4, 3, 1, 2)
    return a


def _spec_to_oihw(spec):
    """A reference HWIO spec (one entry per dim) in the port's OIHW order."""
    if len(spec) == 4:
        return (spec[3], spec[2], spec[0], spec[1])
    if len(spec) == 5:
        return (spec[0], spec[4], spec[3], spec[1], spec[2])
    return spec


def _fake_mesh(spec):
    return types.SimpleNamespace(shape={a: spec.get(a, 1) for a in AXES})


def _assert_close(got, want, atol, label, oihw=False):
    want = _flatten(want)
    assert set(got) == set(want), label
    for leaf, w in want.items():
        np.testing.assert_allclose(got[leaf], _to_oihw(w) if oihw else np.asarray(w),
                                   atol=atol, rtol=0, err_msg=f"{label} {leaf}")


@pytest.mark.parametrize("name", list(CASES))
def test_pruned_specs_equal_the_reference_after_hwio_to_oihw(name):
    """The reference cuts each conv kernel's last dim (HWIO's cout); the
    port's OIHW spec must cut O (dim 0, or dim 1 of a stacked tail)."""
    spec = CASES[name]
    mesh = jmake_mesh(JMeshSpec(**spec), devices=jax.devices()[:_world(spec)])
    shapes, _ = jax.eval_shape(lambda: JR.init_params(jax.random.key(0), _jcfg()))
    want = {n: _spec_to_oihw(tuple(s.spec) + (None,) * (len(shp.shape) - len(s.spec)))
            for (n, s), shp in zip(_flatten(JR.param_shardings(mesh, _jcfg())).items(),
                                   _flatten(shapes).values())}
    tcfg = R.ResNetConfig(**TINY_RESNET, compute_dtype=torch.float32)
    got = _flatten(R.param_shardings(_fake_mesh(spec), tcfg))
    assert got == want
    if spec.get("fsdp", 1) > 1:
        assert got["stem__conv"][0] == "fsdp" and got["stage1__tail__conv2"][1] == "fsdp"


@pytest.mark.parametrize("name", list(CASES))
def test_first_loss_and_bn_state_match_reference_on_every_rank(ranks, name):
    want, _, want_bn = _reference_grads(name)
    for r in ranks[_world(CASES[name])]:
        np.testing.assert_allclose(r[name]["loss"], want, rtol=LOSS_RTOL)
        _assert_close(r[name]["bn"], want_bn, ATOL, name)


@pytest.mark.parametrize("name", list(CASES))
def test_every_leaf_gradient_matches_reference(ranks, name):
    """BN's scale and bias catch statistics taken per rank (their
    gradients flow back through the synchronized sums); the head, a
    cross-entropy counted twice over tp or summed over the wrong axes."""
    _, want, _ = _reference_grads(name)
    for r in ranks[_world(CASES[name])]:
        _assert_close(r[name]["grads"], want, ATOL, name, oihw=True)


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_shards(ranks, name):
    spec = CASES[name]
    tcfg = R.ResNetConfig(**TINY_RESNET, compute_dtype=torch.float32)
    mesh = _fake_mesh(spec)
    specs = _flatten(R.param_shardings(mesh, tcfg))
    want = sum(int(np.prod(local_shape(shape, specs[n], mesh))) * 4
               for n, shape in _flatten(R.param_shapes(tcfg)[0]).items())
    for r in ranks[_world(spec)]:
        assert r[name]["shard_bytes"] == want
        if spec.get("fsdp", 1) > 1:
            assert r[name]["traffic"]["reduce_scatter"][0] > 0


@pytest.mark.parametrize("name", list(CASES))
def test_sgd_steps_match_reference_make_train_step(ranks, name):
    want_losses, want_params, want_bn = _reference_steps(name)
    for r in ranks[_world(CASES[name])]:
        got = r[f"{name}_steps"]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
        _assert_close(got["params"], want_params, ATOL, name, oihw=True)
        _assert_close(got["bn"], want_bn, ATOL, name)


def _assert_state_close(got, want):
    assert [np.shape(x) for x in got] == [np.shape(x) for x in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=CKPT_ATOL, rtol=0)


def test_checkpoint_written_at_dp2_restores_on_one_rank(ranks, tmp):
    resumed = tmp / "dp2_resumed"
    shutil.copytree(tmp / "dp2", resumed)
    state, _ = _loop(CKPT_STEPS, resumed)
    _assert_state_close([t.detach().numpy() for t in tree_leaves(state)], _uninterrupted())


def test_checkpoint_written_on_one_rank_restores_at_fsdp2(ranks):
    for r in ranks[2]:
        _assert_state_close(r["ckpt_restored_at_fsdp2"]["state"], _uninterrupted())
