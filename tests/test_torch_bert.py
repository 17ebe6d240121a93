"""The port's BERT encoder (gpushare_device_plugin_tpu_torch/workloads/
bert.py) and its trainer task against the reference, f32 on the CPU, at
the reference's TINY_BERT shape (tests/test_workloads_vision_nlp.py), the
same numpy tokens on both sides. The JAX side runs without a mesh, through
``jax.value_and_grad`` and optax directly; with ``attention="flash"`` it
runs the Pallas kernel in interpret mode, and the port the kernel's plain
version (the CPU path of its wrapper).

Tolerances, as tests/test_torch_train.py: hidden states and MLM logits
atol 1e-5, loss rtol 1e-5 and every gradient atol 1e-5 (f32 sums in
another order over two layers); params after one AdamW step atol 5e-4
(Adam turns a sign flip of a near-zero gradient into a step of up to
2·lr). The resumed run is held to bitwise equality.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gpushare_device_plugin_tpu.workloads import bert as JB
from gpushare_device_plugin_tpu_torch.workloads import bert as B
from gpushare_device_plugin_tpu_torch.workloads import convert
from gpushare_device_plugin_tpu_torch.workloads.optim import tree_leaves
from gpushare_device_plugin_tpu_torch.workloads.transformer import _flatten
from gpushare_device_plugin_tpu_torch.workloads.trainer import (
    BertTask,
    TrainLoopConfig,
    run_train_loop,
)

from torch_parity import to_numpy

TINY = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_seq=32)
ATOL = 1e-5


def _configs(**kw):
    shape = {**TINY, **kw}
    return (JB.BertConfig(**shape, compute_dtype=jnp.float32),
            B.BertConfig(**shape, compute_dtype=torch.float32))


def _batch(seed, batch=2, seq=24):
    rng = np.random.RandomState(seed)
    targets = rng.randint(2, TINY["vocab"], size=(batch, seq)).astype(np.int32)
    mask = (rng.rand(batch, seq) < 0.3).astype(np.float32)
    tokens = np.where(mask == 1.0, 1, targets).astype(np.int32)
    segments = rng.randint(0, 2, size=(batch, seq)).astype(np.int32)
    return tokens, targets, mask, segments


def _params(jcfg, tcfg, seed=0):
    jp = JB.init_params(jax.random.key(seed), jcfg)
    tp = convert.bert_from_jax_numpy(to_numpy(jp), tcfg, device="cpu")
    for p in tree_leaves(tp):
        p.requires_grad_()
    return jp, tp


def _assert_trees_close(got, want, atol):
    got, want = _flatten(got), _flatten(want)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("attention", ["plain", "flash"])
def test_hidden_states_and_mlm_logits_match_reference(attention):
    jcfg, tcfg = _configs(attention=attention)
    jp, tp = _params(jcfg, tcfg)
    tokens, _, _, segments = _batch(1)
    for seg in (None, segments):
        jh = JB.forward(jp, jnp.asarray(tokens), jcfg,
                        segments=None if seg is None else jnp.asarray(seg))
        th = B.forward(tp, torch.from_numpy(tokens).long(), tcfg,
                       segments=None if seg is None else torch.from_numpy(seg).long())
        np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), atol=ATOL, rtol=0)
        jl = JB.mlm_logits(jp, jh, jcfg)
        tl = B.mlm_logits(tp, th, tcfg)
        assert tl.dtype == torch.float32 and tl.shape == (2, 24, TINY["vocab"])
        np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=ATOL, rtol=0)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("attention", ["plain", "flash"])
def test_loss_every_gradient_and_one_adamw_step_match_reference(attention, remat):
    jcfg, tcfg = _configs(attention=attention, remat=remat)
    jp, tp = _params(jcfg, tcfg, seed=2)
    tokens, targets, mask, _ = _batch(3)
    jloss, jgrads = jax.value_and_grad(JB.loss_fn)(
        jp, jnp.asarray(tokens), jnp.asarray(targets), jnp.asarray(mask), jcfg
    )
    tb = (torch.from_numpy(tokens).long(), torch.from_numpy(targets).long(),
          torch.from_numpy(mask))
    loss = B.loss_fn(tp, *tb, tcfg)
    grads = torch.autograd.grad(loss, tree_leaves(tp), materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    names = list(_flatten(tp))
    _assert_trees_close(dict(zip(names, grads)), _flatten(to_numpy(jgrads)), atol=ATOL)
    # every leaf but the segment table (no segments here) gets a gradient
    assert [n for n, g in zip(names, grads) if not g.abs().sum() > 0] == ["seg_embed"]

    jopt = JB.make_optimizer()
    updates, _ = jopt.update(jgrads, jopt.init(jp), jp)
    want = optax.apply_updates(jp, updates)
    opt = B.make_optimizer()
    params, opt_state, step_loss = B.make_train_step(tcfg, opt)(tp, opt.init(tp), *tb)
    np.testing.assert_allclose(float(step_loss), float(jloss), rtol=1e-5)
    _assert_trees_close(params, to_numpy(want), atol=5e-4)
    assert int(opt_state["count"]) == 1


def test_bert_base_shape_init_and_demo_batch():
    cfg = B.bert_base()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.vocab,
            cfg.max_seq) == (12, 768, 12, 64, 3072, 30522, 512)
    assert cfg == dataclasses.replace(B.BertConfig(), **{
        f.name: getattr(JB.bert_base(), f.name) for f in dataclasses.fields(JB.BertConfig)
        if f.name != "compute_dtype"})
    jcfg, tcfg = _configs()
    jshapes = jax.tree.map(lambda x: tuple(x.shape),
                           jax.eval_shape(lambda: JB.init_params(jax.random.key(0), jcfg)))
    params = B.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert _flatten(B.param_shapes(tcfg)) == _flatten(jshapes)
    assert {k: tuple(v.shape) for k, v in _flatten(params).items()} == _flatten(jshapes)
    assert torch.equal(params["layers"]["ln1"]["scale"], torch.ones(2, 32))
    tokens, targets, mask = B.demo_batch(torch.Generator().manual_seed(1), 4, 16, tcfg)
    assert tokens.shape == targets.shape == mask.shape == (4, 16)
    assert torch.equal(tokens, torch.where(mask == 1, 1, targets))
    assert bool(((targets >= 2) & (targets < tcfg.vocab)).all())
    with pytest.raises(ValueError, match=r"^embed: shape"):
        convert.bert_from_jax_numpy(
            to_numpy(JB.init_params(jax.random.key(0), jcfg)),
            dataclasses.replace(tcfg, d_model=16, n_heads=2), device="cpu")


def test_bert_task_resume_reproduces_uninterrupted_run(tmp_path):
    _, tcfg = _configs(n_layers=1)
    task = BertTask(tcfg, batch=2, seq=16)
    ref_losses = []
    ref_state, _ = run_train_loop(task, TrainLoopConfig(total_steps=6, log_every=1), 3,
                                  device="cpu", on_metrics=lambda s, l: ref_losses.append(l))
    ckpt = str(tmp_path / "ckpt")
    run_train_loop(task, TrainLoopConfig(total_steps=3, log_every=0, ckpt_dir=ckpt), 3,
                   device="cpu")
    losses = []
    state, _ = run_train_loop(task, TrainLoopConfig(total_steps=6, log_every=1, ckpt_dir=ckpt),
                              3, device="cpu", on_metrics=lambda s, l: losses.append(l))
    assert losses == ref_losses[3:]
    for a, b in zip(tree_leaves(ref_state), tree_leaves(state), strict=True):
        assert torch.equal(a, b)
