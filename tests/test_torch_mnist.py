"""The port's MNIST MLP (gpushare_device_plugin_tpu_torch/workloads/
mnist.py) against the reference, f32 on the CPU, the same numpy images on
both sides; the JAX side runs without a mesh, through
``jax.value_and_grad`` and ``optax.sgd`` directly.

Tolerances, as tests/test_torch_train.py: logits atol 1e-5, loss rtol
1e-5, gradients atol 1e-5; params after one SGD step atol 1e-6 (the
gradients differ by f32 rounding and lr = 1e-2 scales them down).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from gpushare_device_plugin_tpu.workloads import mnist as JM
from gpushare_device_plugin_tpu_torch.workloads import convert
from gpushare_device_plugin_tpu_torch.workloads import mnist as M
from gpushare_device_plugin_tpu_torch.workloads.optim import tree_leaves

from torch_parity import to_numpy


def _batch(seed, batch=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, M.IMAGE_DIM).astype(np.float32),
            rng.randint(0, M.N_CLASSES, size=(batch,)).astype(np.int32))


def _pair(seed=0):
    jp = JM.init_params(jax.random.key(seed))
    tp = convert.mnist_from_jax_numpy(to_numpy(jp), device="cpu")
    for p in tp.values():
        p.requires_grad_()
    return jp, tp


def test_forward_loss_gradients_and_two_steps_match_reference():
    jp, tp = _pair()
    jstep_opt = optax.sgd(1e-2, momentum=0.9)
    jstate = jstep_opt.init(jp)
    step, opt = M.make_train_step()
    state = opt.init(tp)
    for seed in (1, 2):
        images, labels = _batch(seed)
        ji, jl = jnp.asarray(images), jnp.asarray(labels)
        ti, tl = torch.from_numpy(images), torch.from_numpy(labels)
        np.testing.assert_allclose(M.forward(tp, ti).detach().numpy(),
                                   np.asarray(JM.forward(jp, ji)), atol=1e-5, rtol=0)
        jloss, jgrads = jax.value_and_grad(JM.loss_fn)(jp, ji, jl)
        loss = M.loss_fn(tp, ti, tl)
        grads = torch.autograd.grad(loss, tree_leaves(tp))
        np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
        for (name, w), g in zip(tp.items(), grads):
            np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[name]), atol=1e-5, rtol=0)
        updates, jstate = jstep_opt.update(jgrads, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tp, state, step_loss = step(tp, state, ti, tl)
        assert float(step_loss) == float(loss.detach())
        for name, w in tp.items():
            np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp[name]), atol=1e-6, rtol=0)


def test_synthetic_batch_and_train_falls():
    gen = torch.Generator().manual_seed(3)
    images, labels = M.synthetic_batch(gen, 64)
    assert images.shape == (64, M.IMAGE_DIM) and labels.shape == (64,)
    protos = torch.randn((M.N_CLASSES, M.IMAGE_DIM),
                         generator=torch.Generator().manual_seed(M.PROTOTYPE_SEED))
    # every image sits within 0.3-scaled noise of its class prototype
    assert float((images - protos[labels]).std()) < 0.35
    losses = []
    final = M.train(steps=20, batch=64, device="cpu", on_metrics=lambda s, l: losses.append(l))
    assert len(losses) == 20 and final == losses[-1]
    assert losses[-1] < 0.5 * losses[0]
