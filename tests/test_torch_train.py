"""The port's training half (gpushare_device_plugin_tpu_torch/workloads/
transformer.py, optim.py, trainer.py) against the reference, f32, with the
same numpy tokens on both sides.

Tolerances: loss rtol 1e-5 and gradients atol 1e-5 (f32 sums in another
order over two layers); optimizer updates atol 1e-6 on the same gradients
(f32 rounding of the same formula); params after train steps atol 5e-4,
the reference's own reason (tests/test_workloads.py): Adam turns a sign
flip of a near-zero gradient into a step of up to 2·lr. The "dots" remat
policy recomputes the same ops in the same order as no remat: its loss
and gradients are held to bitwise equality with "full" and with none.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpushare_device_plugin_tpu.parallel import MeshSpec, make_mesh
from gpushare_device_plugin_tpu.workloads import optim as JO
from gpushare_device_plugin_tpu.workloads import transformer as JT
from gpushare_device_plugin_tpu_torch.workloads import convert, optim
from gpushare_device_plugin_tpu_torch.workloads import transformer as T
from gpushare_device_plugin_tpu_torch.workloads.trainer import (
    DecoderTask,
    TrainLoopConfig,
    run_train_loop,
)

from torch_parity import configs, params_pair, to_numpy, tokens


def _trainable(tree):
    return T.Decoder(tree, T.TransformerConfig(), trainable=True).params


def _assert_trees_close(got, want, atol):
    got, want = T._flatten(got), T._flatten(want)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].detach().numpy()
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("attention", ["plain", "flash"])
def test_loss_and_every_gradient_match_reference(attention, remat):
    jcfg, tcfg = configs(attention=attention, remat=remat)
    jp, tp = params_pair(jcfg, tcfg)
    toks = tokens((2, 24), seed=1)
    jloss, jgrads = jax.value_and_grad(JT.loss_fn)(jp, jnp.asarray(toks), jcfg)
    tp = _trainable(tp)
    loss = T.loss_fn(tp, torch.from_numpy(toks), tcfg)
    grads = torch.autograd.grad(loss, optim.tree_leaves(tp))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    names = list(T._flatten(tp))
    _assert_trees_close(dict(zip(names, grads)), to_numpy(jgrads), atol=1e-5)
    assert all(g.abs().sum() > 0 for g in grads)


def test_unknown_remat_policy_raises_like_reference():
    _, tcfg = configs(remat_policy="bogus")
    params = T.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        T.forward(params, torch.zeros((1, 8), dtype=torch.long), tcfg)


@pytest.mark.parametrize("clip_norm", [None, 0.5])
@pytest.mark.parametrize("warmup_steps", [0, 3])
def test_optimizer_schedule_and_updates_match_optax(clip_norm, warmup_steps):
    kw = dict(weight_decay=0.1, clip_norm=clip_norm, warmup_steps=warmup_steps,
              total_steps=10, min_lr_ratio=0.2)
    opt = optim.make_optimizer(1e-2, **kw)
    want_lr = optax.warmup_cosine_decay_schedule(0.0, 1e-2, max(1, warmup_steps), 10, 2e-3)
    for n in range(13):
        assert opt.lr(n) == pytest.approx(float(want_lr(n)), rel=1e-6, abs=1e-12), n
    assert opt.lr(0) == 0.0  # the schedule's count starts at 0

    rng = np.random.RandomState(0)
    tree = {"w": rng.randn(8, 4).astype(np.float32), "g": np.ones(4, np.float32)}
    jopt = JO.make_optimizer(1e-2, **kw)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    tstate = opt.init(tparams)
    for step in range(12):
        # Norms above and below clip_norm, so the clip both fires and not.
        scale = 0.05 if step % 2 else 2.0
        grads = {k: (rng.randn(*v.shape) * scale).astype(np.float32) for k, v in tree.items()}
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = {k: v.clone() for k, v in tparams.items()}
        opt.update({k: torch.from_numpy(v) for k, v in grads.items()}, tstate, tparams)
        if step == 0:  # LR 0 on the first update: nothing moves
            assert all(torch.equal(before[k], tparams[k]) for k in tree)
        _assert_trees_close(tparams, to_numpy(jparams), atol=1e-6)
    assert int(tstate["count"]) == 12


def test_optimizer_constant_lr_and_validation_like_reference():
    opt = optim.make_optimizer(3e-4)
    assert opt.lr(0) == opt.lr(1000) == 3e-4
    with pytest.raises(ValueError, match="warmup_steps requires total_steps"):
        optim.make_optimizer(warmup_steps=5)
    with pytest.raises(ValueError, match="decay"):
        optim.make_optimizer(warmup_steps=5, total_steps=5)
    with pytest.raises(ValueError, match="3 gradients"):
        opt.update([torch.zeros(1)] * 3, opt.init([torch.zeros(1)]), [torch.zeros(1)])


@pytest.mark.parametrize("momentum,nesterov", [(None, False), (0.9, False), (0.9, True)])
def test_sgd_matches_optax_over_three_steps(momentum, nesterov):
    rng = np.random.RandomState(1)
    tree = {"w": rng.randn(8, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    jopt = optax.sgd(0.1, momentum=momentum, nesterov=nesterov)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    opt = optim.SGD(0.1, momentum=momentum, nesterov=nesterov)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    tstate = opt.init(tparams)
    assert len(tstate["trace"]) == (0 if momentum is None else 2)
    for _ in range(3):
        grads = {k: rng.randn(*v.shape).astype(np.float32) for k, v in tree.items()}
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.update({k: torch.from_numpy(v) for k, v in grads.items()}, tstate, tparams)
        _assert_trees_close(tparams, to_numpy(jparams), atol=1e-6)
    with pytest.raises(ValueError, match="1 gradients for 2"):
        opt.update([torch.zeros(1)], tstate, tparams)


def _loss_grads_flops(cfg, params, toks):
    loss = T.loss_fn(params, toks, cfg)
    with FlopCounterMode(display=False) as flops:
        grads = torch.autograd.grad(loss, optim.tree_leaves(params))
    return loss.detach(), grads, flops.get_total_flops()


@pytest.mark.parametrize("attention", ["plain", "flash"])
def test_dots_remat_equals_full_and_no_remat_and_recomputes_no_projection(attention):
    jcfg, tcfg = configs(attention=attention, remat_policy="dots")
    jp, tp = params_pair(jcfg, tcfg)
    tp = _trainable(tp)
    toks = torch.from_numpy(tokens((2, 24), seed=1))
    dots = _loss_grads_flops(tcfg, tp, toks)
    full = _loss_grads_flops(dataclasses.replace(tcfg, remat_policy="full"), tp, toks)
    none = _loss_grads_flops(dataclasses.replace(tcfg, remat=False), tp, toks)
    for other in (full, none):
        assert torch.equal(dots[0], other[0])
        assert all(torch.equal(a, b) for a, b in zip(dots[1], other[1], strict=True))
    # The backward's products: "full" recomputes every projection; "dots"
    # none of them, and on the plain path only attention's two products.
    if attention == "flash":
        assert none[2] == dots[2] < full[2]
    else:
        assert none[2] < dots[2] < full[2]
    jloss, jgrads = jax.value_and_grad(JT.loss_fn)(jp, jnp.asarray(toks.numpy()), jcfg)
    np.testing.assert_allclose(float(dots[0]), float(jloss), rtol=1e-5)
    _assert_trees_close(dict(zip(T._flatten(tp), dots[1])), to_numpy(jgrads), atol=1e-5)


def _reference_steps(jcfg, batches, accum_steps=1):
    mesh = make_mesh(MeshSpec(dp=1, fsdp=1, tp=1), devices=jax.devices()[:1])
    jparams, jstate = JT.init_train_state(jax.random.key(0), mesh, jcfg)
    start = to_numpy(jparams)  # before the donating step consumes them
    step = JT.make_train_step(mesh, jcfg, accum_steps=accum_steps)
    losses = []
    for toks in batches:
        jparams, jstate, loss = step(jparams, jstate, jnp.asarray(toks))
        losses.append(float(loss))
    return start, losses, to_numpy(jparams)


@pytest.mark.parametrize("accum_steps,n_steps", [(1, 3), (2, 1)])
def test_train_steps_match_reference(accum_steps, n_steps):
    jcfg, tcfg = configs()
    batches = [tokens((4, 16), seed=10 + i) for i in range(n_steps)]
    start, want_losses, want_params = _reference_steps(jcfg, batches, accum_steps)
    params = _trainable(convert.from_jax_numpy(start, tcfg, device="cpu"))
    opt = T.make_optimizer()
    opt_state = opt.init(params)
    step = T.make_train_step(tcfg, opt, accum_steps=accum_steps)
    losses = []
    for toks in batches:
        params, opt_state, loss = step(params, opt_state, torch.from_numpy(toks))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _assert_trees_close(params, want_params, atol=5e-4)


def test_accum_steps_validation_like_reference():
    _, tcfg = configs()
    with pytest.raises(ValueError, match="accum_steps"):
        T.make_train_step(tcfg, accum_steps=0)
    params, opt_state = T.init_train_state(tcfg, torch.Generator().manual_seed(0), device="cpu")
    step = T.make_train_step(tcfg, accum_steps=3)
    with pytest.raises(ValueError, match="not divisible"):
        step(params, opt_state, torch.from_numpy(tokens((4, 16))))


def test_train_state_is_trainable_parameters_on_the_asked_device():
    _, tcfg = configs()
    params, opt_state = T.init_train_state(tcfg, torch.Generator().manual_seed(0), device="cpu")
    leaves = optim.tree_leaves(params)
    assert all(isinstance(p, torch.nn.Parameter) and p.dtype == torch.float32 for p in leaves)
    assert len(leaves) == len(opt_state["mu"]) == len(opt_state["nu"]) == 10
    mod = T.Decoder(params, tcfg, trainable=True)
    assert len(list(mod.parameters())) == 10 and not list(mod.buffers())
    toks = T.demo_batch(torch.Generator().manual_seed(3), 3, 16, tcfg.vocab)
    assert toks.shape == (3, 16) and toks.dtype == torch.long
    assert torch.equal(toks[:, 1:], (toks[:, :-1] + 1) % tcfg.vocab)


def test_run_train_loop_loss_decreases():
    _, tcfg = configs()
    losses = []
    run_train_loop(
        DecoderTask(tcfg, batch=8, seq=32), TrainLoopConfig(total_steps=12, log_every=1), 0,
        device="cpu", on_metrics=lambda s, l: losses.append(l),
    )
    assert len(losses) == 12 and losses[-1] < losses[0]


def test_resume_reproduces_uninterrupted_run_bit_for_bit(tmp_path):
    """Interrupted after step 4 and resumed == one uninterrupted 10-step
    run, to bitwise equality of every tensor of the state (batches are
    deterministic in (seed, step))."""
    _, tcfg = configs(n_layers=1)
    task = DecoderTask(tcfg, batch=4, seq=16)
    ref_state, ref_loss = run_train_loop(
        task, TrainLoopConfig(total_steps=10, log_every=0), 7, device="cpu"
    )
    ckpt = str(tmp_path / "ckpt")
    run_train_loop(
        task, TrainLoopConfig(total_steps=5, log_every=0, ckpt_dir=ckpt, ckpt_every=2),
        7, device="cpu",
    )
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_000000001.pt", "step_000000003.pt", "step_000000004.pt"
    ]
    cfg = TrainLoopConfig(total_steps=10, log_every=0, ckpt_dir=ckpt, ckpt_every=2, ckpt_keep=2)
    state, loss = run_train_loop(task, cfg, 7, device="cpu")
    for a, b in zip(optim.tree_leaves(ref_state), optim.tree_leaves(state), strict=True):
        assert torch.equal(a, b)
    assert loss == ref_loss
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_000000007.pt", "step_000000009.pt"
    ]
