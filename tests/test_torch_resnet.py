"""The port's ResNet (gpushare_device_plugin_tpu_torch/workloads/resnet.py)
and its trainer task against the reference, f32 on the CPU, at the
reference's TINY_RESNET width (tests/test_workloads_vision_nlp.py) with
stages that have stacked tail blocks, on images of size 32 (even: SAME
pads more on the high side under stride 2) and 33 (odd: symmetric), the
same numpy images on both sides. The JAX side runs without a mesh,
through ``jax.value_and_grad`` and optax directly; its HWIO kernels cross
to the port's OIHW through ``convert.resnet_from_jax_numpy``.

Tolerances, as tests/test_torch_train.py: logits and BN state atol 1e-5,
loss rtol 1e-5, every gradient atol 1e-5 (f32 sums in another order);
params after one SGD step atol 1e-5 (the gradient tolerance times
lr·(1 + momentum) < 1, plus f32 rounding). Over two steps of the
reference's recipe at ResNet-50's width, loss rtol 1e-4: the recipe's
first steps amplify f32 rounding (a third step already differs by 1%).
The resumed run is held to bitwise equality.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpushare_device_plugin_tpu.workloads import resnet as JR
from gpushare_device_plugin_tpu_torch.workloads import convert
from gpushare_device_plugin_tpu_torch.workloads import resnet as R
from gpushare_device_plugin_tpu_torch.workloads.optim import tree_leaves
from gpushare_device_plugin_tpu_torch.workloads.transformer import _flatten
from gpushare_device_plugin_tpu_torch.workloads.trainer import (
    ResNetTask,
    TrainLoopConfig,
    run_train_loop,
)

from torch_parity import to_numpy

ATOL = 1e-5
STAGES = [(1, 2), (2, 3)]  # TINY_RESNET's, and one with a tail in every stage


def _configs(stage_sizes):
    kw = dict(stage_sizes=stage_sizes, width=8, num_classes=10)
    return (JR.ResNetConfig(**kw, compute_dtype=jnp.float32),
            R.ResNetConfig(**kw, compute_dtype=torch.float32))


def _pair(stage_sizes, seed=0):
    jcfg, tcfg = _configs(stage_sizes)
    jp, js = JR.init_params(jax.random.key(seed), jcfg)
    tp, ts = convert.resnet_from_jax_numpy(to_numpy(jp), to_numpy(js), tcfg, device="cpu")
    for p in tree_leaves(tp):
        p.requires_grad_()
    return jcfg, tcfg, jp, js, tp, ts


def _images(seed, size, batch=3):
    rng = np.random.RandomState(seed)
    images = rng.rand(batch, size, size, 3).astype(np.float32)
    labels = rng.randint(0, 10, size=(batch,)).astype(np.int32)
    return images, labels


def _to_oihw(name, a):
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 5:
        return a.transpose(0, 4, 3, 1, 2)
    return a


def _assert_trees_close(got, want, atol, oihw=False):
    got, want = _flatten(got), _flatten(want)
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name].detach().numpy()
        np.testing.assert_allclose(g, _to_oihw(name, w) if oihw else w, atol=atol, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("stage_sizes", STAGES)
def test_train_and_eval_logits_and_bn_state_match_reference(stage_sizes, size):
    jcfg, tcfg, jp, js, tp, ts = _pair(stage_sizes)
    images, _ = _images(1, size)
    jl, jns = JR.forward(jp, js, jnp.asarray(images), jcfg, train=True)
    tl, tns = R.forward(tp, ts, torch.from_numpy(images), tcfg, train=True)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    _assert_trees_close(tns, to_numpy(jns), atol=ATOL)
    assert not torch.equal(tns["stem"]["bn"]["mean"], ts["stem"]["bn"]["mean"])
    # eval mode reads the updated statistics and changes none
    jl, jes = JR.forward(jp, jns, jnp.asarray(images), jcfg, train=False)
    tl, tes = R.forward(tp, tns, torch.from_numpy(images), tcfg, train=False)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tes), tree_leaves(tns), strict=True))
    _assert_trees_close(tes, to_numpy(jes), atol=ATOL)


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("stage_sizes", STAGES)
def test_loss_every_gradient_and_one_sgd_step_match_reference(stage_sizes, size):
    jcfg, tcfg, jp, js, tp, ts = _pair(stage_sizes, seed=2)
    images, labels = _images(3, size)
    (jloss, jns), jgrads = jax.value_and_grad(JR.loss_fn, has_aux=True)(
        jp, js, jnp.asarray(images), jnp.asarray(labels), jcfg
    )
    ti, tlab = torch.from_numpy(images), torch.from_numpy(labels).long()
    loss, tns = R.loss_fn(tp, ts, ti, tlab, tcfg)
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    names = list(_flatten(tp))
    _assert_trees_close(dict(zip(names, grads)), _flatten(to_numpy(jgrads)), atol=ATOL, oihw=True)
    _assert_trees_close(tns, to_numpy(jns), atol=ATOL)

    jopt = JR.make_optimizer()
    updates, _ = jopt.update(jgrads, jopt.init(jp), jp)
    want = jax.tree.map(lambda p, u: p + u, jp, updates)
    opt = R.make_optimizer()
    params, new_state, opt_state, step_loss = R.make_train_step(tcfg, opt)(
        tp, ts, opt.init(tp), ti, tlab)
    np.testing.assert_allclose(float(step_loss), float(jloss), rtol=1e-5)
    _assert_trees_close(params, to_numpy(want), atol=ATOL, oihw=True)
    _assert_trees_close(new_state, to_numpy(jns), atol=ATOL)
    assert len(opt_state["trace"]) == len(names)


def test_resnet50_shapes_init_and_demo_batch():
    cfg = R.resnet50()
    jcfg = JR.resnet50()
    assert (cfg.stage_sizes, cfg.width, cfg.num_classes, cfg.bn_momentum, cfg.bn_eps) == (
        jcfg.stage_sizes, jcfg.width, jcfg.num_classes, jcfg.bn_momentum, jcfg.bn_eps)
    assert cfg.compute_dtype == torch.bfloat16
    jcfg, tcfg = _configs((2, 3))
    jp, js = jax.eval_shape(lambda: JR.init_params(jax.random.key(0), jcfg))
    pshapes, sshapes = R.param_shapes(tcfg)
    assert _flatten(pshapes) == {k: _to_oihw(k, np.empty(v.shape)).shape for k, v in _flatten(jp).items()}
    assert _flatten(sshapes) == {k: v.shape for k, v in _flatten(js).items()}
    params, state = R.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in _flatten(params).items()} == _flatten(pshapes)
    assert torch.equal(state["stage1"]["tail"]["bn2"]["var"], torch.ones(2, 16))
    assert R._same_pads(224, 7, 2) == (2, 3) and R._same_pads(32, 3, 2) == (0, 1)
    assert R._same_pads(32, 1, 2) == (0, 0) and R._same_pads(33, 3, 2) == (1, 1)
    images, labels = R.demo_batch(torch.Generator().manual_seed(1), 4, size=8)
    assert images.shape == (4, 8, 8, 3) and labels.shape == (4,)
    assert 0 <= float(images.min()) and float(images.max()) < 1 and int(labels.max()) < 10
    with pytest.raises(ValueError, match=r"^stem.conv: shape"):
        convert.resnet_from_jax_numpy(
            to_numpy(JR.init_params(jax.random.key(0), jcfg)[0]), to_numpy(js),
            dataclasses.replace(tcfg, width=4), device="cpu")


def test_resnet_task_resume_reproduces_uninterrupted_run_bn_state_included(tmp_path):
    _, tcfg = _configs((1, 2))
    task = ResNetTask(tcfg, batch=4, image_size=16)
    ref_losses = []
    ref_state, _ = run_train_loop(task, TrainLoopConfig(total_steps=6, log_every=1), 5,
                                  device="cpu", on_metrics=lambda s, l: ref_losses.append(l))
    ckpt = str(tmp_path / "ckpt")
    run_train_loop(task, TrainLoopConfig(total_steps=3, log_every=0, ckpt_dir=ckpt), 5,
                   device="cpu")
    losses = []
    state, _ = run_train_loop(task, TrainLoopConfig(total_steps=6, log_every=1, ckpt_dir=ckpt),
                              5, device="cpu", on_metrics=lambda s, l: losses.append(l))
    assert losses == ref_losses[3:]
    assert len(state) == 3  # params, BN state, optimizer state
    for a, b in zip(tree_leaves(ref_state), tree_leaves(state), strict=True):
        assert torch.equal(a, b)
    assert not torch.equal(state[1]["stem"]["bn"]["var"], torch.ones(8))


def test_full_width_sgd_recipe_first_steps_follow_reference():
    """ResNet-50's widths (64 to 2,048 channels, 1,000 classes) at one
    block a stage: two steps of the reference's SGD recipe (Nesterov 0.9
    at 0.1) on fresh random batches give the reference's losses, which
    rise at first: the head's step grows with the squared norm of 2,048
    nearly constant features, so random images drive the logits of the
    batch's classes apart before the loss falls (chip_smoke.py trains
    ResNet-50 32 steps for this)."""
    kw = dict(stage_sizes=(1, 1, 1, 1), width=64, num_classes=1000)
    jcfg = JR.ResNetConfig(**kw, compute_dtype=jnp.float32)
    tcfg = R.ResNetConfig(**kw, compute_dtype=torch.float32)
    jp, js = JR.init_params(jax.random.key(0), jcfg)
    tp, ts = convert.resnet_from_jax_numpy(to_numpy(jp), to_numpy(js), tcfg, device="cpu")
    for p in tree_leaves(tp):
        p.requires_grad_()
    jopt, opt = JR.make_optimizer(), R.make_optimizer()
    jos, tos = jopt.init(jp), opt.init(tp)
    step = R.make_train_step(tcfg, opt)
    jlosses, losses = [], []
    for seed in range(2):
        images, labels = _images(10 + seed, 32, batch=8)
        (jl, js), g = jax.value_and_grad(JR.loss_fn, has_aux=True)(
            jp, js, jnp.asarray(images), jnp.asarray(labels), jcfg)
        updates, jos = jopt.update(g, jos, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        tp, ts, tos, loss = step(tp, ts, tos, torch.from_numpy(images),
                                 torch.from_numpy(labels).long())
        jlosses.append(float(jl))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert jlosses[1] > 2 * jlosses[0] and losses[1] > 2 * losses[0]

