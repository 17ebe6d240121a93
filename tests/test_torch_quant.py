"""The port's int8 weight and KV quantization against the reference
(gpushare_device_plugin_tpu/workloads/quant.py).

int8 codes must match exactly (both round half to even) and scales to
f32 rounding (atol 1e-7 relative to O(1) values); dequantized values to
1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpushare_device_plugin_tpu.workloads import quant as JQ
from gpushare_device_plugin_tpu_torch.workloads import quant as Q

from torch_parity import configs, params_pair, to_numpy


def _pair(shape, seed=0):
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(w), torch.from_numpy(w)


@pytest.mark.parametrize("axes", [(0,), (1,), (1, 2), (-1,)])
def test_quantize_matches_reference(axes):
    jw, tw = _pair((5, 6, 7))
    tw[:, 0] = 0.0  # an all-zero channel keeps scale 1
    jw = jw.at[:, 0].set(0.0)
    jq, tq = JQ.quantize(jw, axes), Q.quantize(tw, axes)
    assert tq["q8"].dtype == torch.int8 and tq["scale"].dtype == torch.float32
    np.testing.assert_array_equal(tq["q8"].numpy(), np.asarray(jq["q8"]))
    np.testing.assert_allclose(tq["scale"].numpy(), np.asarray(jq["scale"]), rtol=1e-7)
    np.testing.assert_allclose(
        Q.dequantize(tq).numpy(), np.asarray(JQ.dequantize(jq)), atol=1e-6
    )
    assert Q.is_qtensor(tq) and not Q.is_qtensor(tw)


def test_round_half_to_even_like_jnp():
    w = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5]], np.float32)
    jq = JQ.quantize(jnp.asarray(w), (1,))
    tq = Q.quantize(torch.from_numpy(w), (1,))
    np.testing.assert_array_equal(tq["q8"].numpy(), np.asarray(jq["q8"]))
    assert tq["q8"][0, 1:4].tolist() == [0, 2, 2]


def test_quantize_and_cast_decoder_trees_match_reference():
    jcfg, tcfg = configs()
    jp, tp = params_pair(jcfg, tcfg)
    jq, tq = to_numpy(JQ.quantize_decoder(jp)), Q.quantize_decoder(tp)
    for path, jleaf in jax.tree_util.tree_leaves_with_path(jq):
        node = tq
        for key in path:
            node = node[key.key]
        if jleaf.dtype == np.int8:
            np.testing.assert_array_equal(node.numpy(), jleaf)
        else:
            np.testing.assert_allclose(node.numpy(), jleaf, rtol=1e-6)
    tc = Q.cast_decoder(tp)
    assert tc["embed"].dtype == torch.bfloat16 and tc["layers"]["wq"].dtype == torch.bfloat16
    assert tc["layers"]["ln1"].dtype == torch.float32 and tc["final_norm"].dtype == torch.float32


def test_kv_quantization_matches_reference():
    jx, tx = _pair((2, 3, 5, 2, 16), seed=1)
    jq8, js = JQ.quantize_kv(jx)
    tq8, ts = Q.quantize_kv(tx)
    assert ts.shape == (2, 3, 5, 2)
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(
        Q.dequantize_kv(tq8, ts, torch.float32).numpy(),
        np.asarray(JQ.dequantize_kv(jq8, js, jnp.float32)), atol=1e-6,
    )


@pytest.mark.parametrize("quantized", [False, True])
def test_embed_lookup_and_matmul_weight_match_reference(quantized):
    jw, tw = _pair((16, 8), seed=2)
    if quantized:
        jw, tw = JQ.quantize(jw, (1,)), Q.quantize(tw, (1,))
    toks = np.array([[0, 5, 15], [3, 3, 1]], np.int32)
    np.testing.assert_allclose(
        Q.embed_lookup(tw, torch.from_numpy(toks).long(), torch.float32).numpy(),
        np.asarray(JQ.embed_lookup(jw, jnp.asarray(toks), jnp.float32)), atol=1e-6,
    )
    np.testing.assert_allclose(
        Q.matmul_weight(tw, torch.float32).numpy(),
        np.asarray(JQ.matmul_weight(jw, jnp.float32)), atol=1e-6,
    )


@pytest.mark.parametrize("tree_kind", ["float", "int8", "bf16"])
def test_param_bytes_and_dequantize_tree_match_reference(tree_kind):
    """``param_bytes`` counts a quantized leaf's int8 values and f32
    scales, and gives the reference's count for the same tree;
    ``dequantize_tree`` leaves float leaves as they are."""
    jcfg, tcfg = configs()
    transform = {"float": None, "int8": JQ.quantize_decoder, "bf16": JQ.cast_decoder}[tree_kind]
    jp, tp = params_pair(jcfg, tcfg, transform=transform)
    assert Q.param_bytes(tp) == JQ.param_bytes(jp)
    jd = to_numpy(JQ.dequantize_tree(jp))
    td = Q.dequantize_tree(tp)
    assert not any(Q.is_qtensor(v) for v in (td["embed"], td["out"], *td["layers"].values()))
    for name in ("embed", "out"):
        np.testing.assert_allclose(td[name].float().numpy(), np.asarray(jd[name], np.float32),
                                   atol=1e-6, rtol=0)
    for name, w in jd["layers"].items():
        np.testing.assert_allclose(td["layers"][name].float().numpy(), np.asarray(w, np.float32),
                                   atol=1e-6, rtol=0, err_msg=name)
    if tree_kind == "int8":
        assert Q.dequantize_tree(tp, torch.bfloat16)["embed"].dtype == torch.bfloat16
        assert Q.param_bytes(tp) < Q.param_bytes(Q.dequantize_tree(tp)) / 3
