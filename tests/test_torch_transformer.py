"""The port's decoder (gpushare_device_plugin_tpu_torch/workloads/
transformer.py, parallel/ring.py, convert.py) against the reference, f32.

Logits agree within 1e-4 (f32 sums in another order over two layers);
layer pieces within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpushare_device_plugin_tpu.parallel.ring import grouped_attention as jgrouped
from gpushare_device_plugin_tpu.workloads import quant as JQ
from gpushare_device_plugin_tpu.workloads import transformer as JT
from gpushare_device_plugin_tpu_torch.parallel.ring import grouped_attention
from gpushare_device_plugin_tpu_torch.workloads import convert
from gpushare_device_plugin_tpu_torch.workloads import transformer as T

from torch_parity import configs, params_pair, to_numpy, tokens


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_rms_norm_and_rope_match_reference():
    x, w = _rand((2, 5, 4, 16), 0), _rand((16,), 1)
    np.testing.assert_allclose(
        T._rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(JT._rms_norm(jnp.asarray(x), jnp.asarray(w))), atol=1e-5,
    )
    shared = np.arange(5)
    per_row = np.array([[3, 4, 5, 6, 7], [0, 0, 1, 2, 3]])
    for pos in (shared, per_row):
        np.testing.assert_allclose(
            T._rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0).numpy(),
            np.asarray(JT._rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)), atol=1e-5,
        )


@pytest.mark.parametrize("causal", [True, False])
def test_grouped_attention_with_mask_and_dead_rows_matches_reference(causal):
    q, k, v = _rand((2, 6, 4, 8), 2), _rand((2, 6, 2, 8), 3), _rand((2, 6, 2, 8), 4)
    mask = np.random.RandomState(5).rand(2, 6, 6) > 0.4
    mask[1, 2] = False  # a dead row
    want = np.asarray(jgrouped(
        *map(jnp.asarray, (q, k, v)), causal=causal, mask=jnp.asarray(mask)
    ))
    got = grouped_attention(
        *map(torch.from_numpy, (q, k, v)), causal=causal, mask=torch.from_numpy(mask)
    ).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.all(got[1, 2] == 0)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("attention", ["plain", "flash"])
def test_forward_logits_match_reference(quantized, attention):
    jcfg, tcfg = configs(attention=attention)
    jp, tp = params_pair(jcfg, tcfg, transform=JQ.quantize_decoder if quantized else None)
    toks = tokens((2, 24))
    want = np.asarray(JT.forward(jp, jnp.asarray(toks), jcfg))
    got = T.forward(tp, torch.from_numpy(toks).long(), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_decoder_module_holds_the_tree():
    jcfg, tcfg = configs()
    jp, tp = params_pair(jcfg, tcfg, transform=JQ.quantize_decoder)
    mod = T.Decoder(tp, tcfg)
    assert torch.equal(mod.params["layers"]["wq"]["q8"], tp["layers"]["wq"]["q8"])
    assert "layers__wq__scale" in mod.state_dict()
    toks = torch.from_numpy(tokens((1, 9))).long()
    assert torch.equal(mod(toks), T.forward(tp, toks, tcfg))


def test_from_jax_numpy_layout_dtypes_and_shape_check():
    jcfg, tcfg = configs()
    jp = JT.init_params(jax.random.key(1), jcfg)
    bf = to_numpy(JQ.cast_decoder(jp))
    tp = convert.from_jax_numpy(bf, tcfg, device="cpu")
    assert tp["layers"]["wkv"].shape == (2, 64, 2, 2, 16)
    assert tp["layers"]["wq"].dtype == torch.bfloat16  # bit for bit
    np.testing.assert_array_equal(
        tp["layers"]["wq"].float().numpy(), bf["layers"]["wq"].astype(np.float32)
    )
    cast = convert.from_jax_numpy(to_numpy(jp), tcfg, device="cpu", dtype=torch.bfloat16)
    assert cast["out"].dtype == torch.bfloat16 and cast["layers"]["ln2"].dtype == torch.float32
    wrong = T.TransformerConfig(**{**tcfg.__dict__, "d_ff": 96})
    with pytest.raises(ValueError, match="shape"):
        convert.from_jax_numpy(to_numpy(jp), wrong, device="cpu")


def test_init_params_layout_and_scale():
    _, tcfg = configs()
    gen = torch.Generator().manual_seed(0)
    p = T.init_params(tcfg, gen, device="cpu")
    assert p["layers"]["wo"].shape == (2, 4, 16, 64)
    assert p["layers"]["ln1"].dtype == torch.float32
    assert abs(float(p["layers"]["wdown"].std()) - 128 ** -0.5) < 0.01
    cfg8b = T.llama3_8b()
    assert (cfg8b.head_dim, cfg8b.kv_heads, cfg8b.compute_dtype) == (128, 8, torch.bfloat16)
