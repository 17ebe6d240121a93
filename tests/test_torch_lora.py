"""The port's LoRA module (gpushare_device_plugin_tpu_torch/workloads/
lora.py) against the reference's, f32 on the CPU, on the reference's own
test decoder (2 layers, d 32) with adapters on all five targets.

Adapters are made by the reference and cross to the port only through
``np.asarray`` -> ``convert.lora_from_jax_numpy``. Tolerances: merged
weights atol 1e-6 (an f32 product over the rank plus one add, per layer
here and over the stack there); loss atol 1e-5 and adapter gradients
atol 1e-6 (f32 sums in another order over two layers); the flat layout
bit for bit; adapters after three AdamW steps rtol 1e-4 with atol 1e-6
for the entries near zero (the same update formula on gradients that
agree to f32 rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpushare_device_plugin_tpu.workloads import lora as JL
from gpushare_device_plugin_tpu.workloads import transformer as JT
from gpushare_device_plugin_tpu_torch.workloads import convert
from gpushare_device_plugin_tpu_torch.workloads import lora as L
from gpushare_device_plugin_tpu_torch.workloads import transformer as T
from gpushare_device_plugin_tpu_torch.workloads.optim import tree_leaves

from torch_parity import to_numpy, tokens

SHAPE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, max_seq=64)
TARGETS = ("wq", "wo", "wkv", "wi", "wdown")


def rand_lora(jcfg, jlcfg, seed, scale):
    """A reference adapter tree with every leaf random (``b`` too), normal
    times ``scale``, as the reference's engine tests draw them."""
    tree = JL.init_lora(jax.random.key(seed), jcfg, jlcfg)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    keys = jax.random.split(jax.random.key(seed + 10_000), len(leaves))
    return jax.tree_util.tree_unflatten(
        treedef, [jax.random.normal(k, x.shape, x.dtype) * scale for k, x in zip(keys, leaves)]
    )


@pytest.fixture(scope="module")
def setup():
    jcfg = JT.TransformerConfig(**SHAPE, compute_dtype=jnp.float32)
    tcfg = T.TransformerConfig(**SHAPE, compute_dtype=torch.float32)
    jlcfg = JL.LoraConfig(rank=4, targets=TARGETS)
    tlcfg = L.LoraConfig(rank=4, targets=TARGETS)
    jp = JT.init_params(jax.random.key(0), jcfg)
    tp = convert.from_jax_numpy(to_numpy(jp), tcfg, device="cpu")
    jlora = rand_lora(jcfg, jlcfg, 1, 0.1)
    tlora = convert.lora_from_jax_numpy(to_numpy(jlora), tcfg, tlcfg, device="cpu")
    return jcfg, tcfg, jlcfg, tlcfg, jp, tp, jlora, tlora


def test_shapes_and_param_count_equal_reference(setup):
    jcfg, tcfg, jlcfg, tlcfg, jp, *_ = setup
    want = JL.init_lora(jax.random.key(1), jcfg, jlcfg)
    got = L.init_lora(tcfg, tlcfg, torch.Generator().manual_seed(1), device="cpu")
    assert list(got) == list(TARGETS)
    for name in TARGETS:
        for part in ("a", "b"):
            assert tuple(got[name][part].shape) == want[name][part].shape, (name, part)
            assert got[name][part].dtype == torch.float32
        assert not got[name]["b"].any()
    assert L.lora_param_count(got) == JL.lora_param_count(want)
    assert L.lora_flat_len(tcfg, tlcfg) == JL.lora_flat_len(jcfg, jlcfg) == L.lora_param_count(got)
    # fan-in scaled like the reference's: a's rows have variance 1/fan_in
    assert abs(float(got["wdown"]["a"].std()) * SHAPE["d_ff"] ** 0.5 - 1.0) < 0.1
    with pytest.raises(ValueError, match="shape"):
        convert.lora_from_jax_numpy(to_numpy(want), tcfg, L.LoraConfig(rank=2, targets=TARGETS),
                                    device="cpu")
    with pytest.raises(ValueError, match="keys"):
        convert.lora_from_jax_numpy(to_numpy(want), tcfg, L.LoraConfig(rank=4), device="cpu")


@pytest.mark.parametrize("bad", [dict(rank=0), dict(targets=("wq", "wq")),
                                 dict(targets=("embed",))])
def test_validation_errors_equal_reference(setup, bad):
    jcfg, tcfg, *_ = setup
    with pytest.raises(ValueError) as jerr:
        JL.init_lora(jax.random.key(0), jcfg, JL.LoraConfig(**bad))
    with pytest.raises(ValueError) as terr:
        L.init_lora(tcfg, L.LoraConfig(**bad), torch.Generator(), device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_zero_init_merge_is_identity(setup):
    _, tcfg, _, tlcfg, _, tp, *_ = setup
    lora = L.init_lora(tcfg, tlcfg, torch.Generator().manual_seed(3), device="cpu")
    merged = L.merge_lora(tp, lora, tlcfg)
    for name in TARGETS:
        assert torch.equal(merged["layers"][name], tp["layers"][name])
    assert merged["layers"]["ln1"] is tp["layers"]["ln1"] and merged["embed"] is tp["embed"]
    toks = torch.from_numpy(tokens((2, 16), seed=2)).long()
    assert float(L.lora_loss_fn(lora, tp, toks, tcfg, tlcfg)) == float(T.loss_fn(tp, toks, tcfg))


def test_merge_loss_and_gradients_equal_reference(setup):
    jcfg, tcfg, jlcfg, tlcfg, jp, tp, jlora, tlora = setup
    jm, tm = JL.merge_lora(jp, jlora, jlcfg), L.merge_lora(tp, tlora, tlcfg)
    for name in TARGETS:
        np.testing.assert_allclose(tm["layers"][name].numpy(), np.asarray(jm["layers"][name]),
                                   atol=1e-6, rtol=0, err_msg=name)
        assert not torch.equal(tm["layers"][name], tp["layers"][name])
    assert tm["out"] is tp["out"]
    toks = tokens((2, 16), seed=2)
    jloss, jgrad = jax.value_and_grad(JL.lora_loss_fn)(jlora, jp, jnp.asarray(toks), jcfg, jlcfg)
    lora = {n: {k: v.clone().requires_grad_() for k, v in ab.items()} for n, ab in tlora.items()}
    params = {**tp, "layers": {k: v.clone().requires_grad_() for k, v in tp["layers"].items()}}
    loss = L.lora_loss_fn(lora, params, torch.from_numpy(toks).long(), tcfg, tlcfg)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5, rtol=0)
    loss.backward()
    for name in TARGETS:
        for part in ("a", "b"):
            np.testing.assert_allclose(lora[name][part].grad.numpy(), np.asarray(jgrad[name][part]),
                                       atol=1e-6, rtol=0, err_msg=f"{name}.{part}")
    # the base rides through detached: no gradient reaches it
    assert all(t.grad is None for t in params["layers"].values())


def test_flat_layout_equals_reference_bit_for_bit(setup):
    jcfg, tcfg, jlcfg, tlcfg, _, _, jlora, tlora = setup
    flat = L.flatten_lora(tlora, tcfg, tlcfg)
    want = np.asarray(JL.flatten_lora(jlora, jcfg, jlcfg))
    assert flat.dtype == torch.float32 and np.array_equal(flat.numpy(), want)
    views = L.unflatten_lora(flat, tcfg, tlcfg)
    jviews = JL.unflatten_lora(jnp.asarray(want), jcfg, jlcfg)
    for name in TARGETS:
        for got, ref, part in zip(views[name], jviews[name], ("a", "b")):
            assert np.array_equal(got.numpy(), np.asarray(ref)), (name, part)
            assert torch.equal(got.reshape(tlora[name][part].shape), tlora[name][part])
    # batched: leading dims ride through
    both = L.unflatten_lora(torch.stack([flat, 2 * flat]), tcfg, tlcfg)
    assert torch.equal(both["wi"][1][1], 2 * views["wi"][1])
    with pytest.raises(ValueError, match="no 'wdown' entry"):
        L.flatten_lora({n: tlora[n] for n in TARGETS[:-1]}, tcfg, tlcfg)


def test_three_train_steps_equal_reference(setup):
    """Both sides train the same adapter three steps on the same tokens:
    the adapters agree, the base is bitwise unchanged, the loss falls."""
    jcfg, tcfg, jlcfg, tlcfg, jp, tp, *_ = setup
    jlora = JL.init_lora(jax.random.key(5), jcfg, jlcfg)
    tlora = convert.lora_from_jax_numpy(to_numpy(jlora), tcfg, tlcfg, device="cpu")
    toks = tokens((2, 16), seed=4)
    jstep, jinit = JL.make_lora_train_step(None, jcfg, jlcfg)
    tstep, tinit = L.make_lora_train_step(tcfg, tlcfg)
    jopt, topt = jinit(jlora), tinit(tlora)
    base = {k: v.clone() for k, v in T._flatten(tp).items()}
    losses = []
    for _ in range(3):
        jlora, jopt, jloss = jstep(jp, jlora, jopt, jnp.asarray(toks))
        tlora, topt, tloss = tstep(tp, tlora, topt, torch.from_numpy(toks).long())
        np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5, rtol=0)
        losses.append(float(tloss))
    assert losses[-1] < losses[0]
    for name in TARGETS:
        for part in ("a", "b"):
            np.testing.assert_allclose(tlora[name][part].detach().numpy(),
                                       np.asarray(jlora[name][part]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name}.{part}")
    assert float(tlora["wq"]["b"].detach().abs().sum()) > 0
    assert all(torch.equal(base[k], v) for k, v in T._flatten(tp).items())
    assert all(t.requires_grad for t in tree_leaves(tlora))
    assert not any(t.requires_grad for t in tree_leaves(tp))
    assert int(topt["count"]) == 3 and len(topt["mu"]) == 2 * len(TARGETS)
