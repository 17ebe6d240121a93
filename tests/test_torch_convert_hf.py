"""HF-Llama state dicts to the port's decoder tree and back
(gpushare_device_plugin_tpu_torch/workloads/convert.py) against the
reference's ``from_hf_llama`` / ``to_hf_llama``, on synthetic state dicts
(names, reshapes and transposes only: every comparison is bit-exact).
Also the small names the port mirrors: ``PagedPlan.max_pages_per_row``,
``pages.SCRATCH``, ``ADAPTER_COUNTER_FAMILIES``, ``DrainHandshake.doc``
and ``flash_attention.NEG_INF``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpushare_device_plugin_tpu.serving import adapters as JA
from gpushare_device_plugin_tpu.serving import drainproto as JD
from gpushare_device_plugin_tpu.serving import pages as JPg
from gpushare_device_plugin_tpu.workloads import convert as JC
from gpushare_device_plugin_tpu.workloads import transformer as JT
from gpushare_device_plugin_tpu_torch.ops import flash_attention as fa
from gpushare_device_plugin_tpu_torch.serving import adapters as A
from gpushare_device_plugin_tpu_torch.serving import drainproto as D
from gpushare_device_plugin_tpu_torch.serving import pages as Pg
from gpushare_device_plugin_tpu_torch.workloads import convert
from gpushare_device_plugin_tpu_torch.workloads import generate as G
from gpushare_device_plugin_tpu_torch.workloads import transformer as T

SHAPES = [dict(vocab=48, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=40, max_seq=32),
          dict(vocab=40, d_model=24, n_layers=3, n_heads=3, d_ff=56, max_seq=16)]


def _hf_state(shape, seed=0):
    """A synthetic HF-Llama state dict (numpy f32) for ``shape``."""
    cfg = T.TransformerConfig(**shape)
    rng = np.random.RandomState(seed)
    d, H, Dh, Hkv, F = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.kv_heads, cfg.d_ff
    state = {"model.embed_tokens.weight": (cfg.vocab, d), "model.norm.weight": (d,),
             "lm_head.weight": (cfg.vocab, d)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        state.update({
            p + "self_attn.q_proj.weight": (H * Dh, d), p + "self_attn.k_proj.weight": (Hkv * Dh, d),
            p + "self_attn.v_proj.weight": (Hkv * Dh, d), p + "self_attn.o_proj.weight": (d, H * Dh),
            p + "mlp.gate_proj.weight": (F, d), p + "mlp.up_proj.weight": (F, d),
            p + "mlp.down_proj.weight": (d, F), p + "input_layernorm.weight": (d,),
            p + "post_attention_layernorm.weight": (d,),
        })
    return {k: rng.randn(*v).astype(np.float32) for k, v in state.items()}


def _configs(shape):
    return (JT.TransformerConfig(**shape, compute_dtype=jnp.float32),
            T.TransformerConfig(**shape, compute_dtype=torch.float32))


@pytest.mark.parametrize("as_torch", [False, True])
@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_from_hf_llama_equals_reference_tree_and_round_trips(shape, as_torch):
    jcfg, tcfg = _configs(SHAPES[shape])
    state = _hf_state(SHAPES[shape], seed=shape)
    src = {k: torch.from_numpy(v) for k, v in state.items()} if as_torch else state
    tree = convert.from_hf_llama(src, tcfg, device="cpu")
    want = JC.from_hf_llama(state, jcfg)
    assert list(tree["layers"]) == list(T.param_shapes(tcfg)["layers"])
    for name, shp in T._flatten(T.param_shapes(tcfg)).items():
        got = T._flatten(tree)[name]
        assert tuple(got.shape) == shp and got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(T._flatten(want)[name]))
    back = convert.to_hf_llama(tree, tcfg)
    assert set(back) == set(state)
    for k, v in state.items():
        assert back[k].dtype == torch.float32 and back[k].is_contiguous()
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    ref_back = JC.to_hf_llama(want, jcfg)
    assert all(np.array_equal(back[k].numpy(), ref_back[k]) for k in ref_back)


def test_converted_tree_generates_the_reference_tokens():
    jcfg, tcfg = _configs(SHAPES[0])
    state = {k: v * 0.2 for k, v in _hf_state(SHAPES[0], seed=4).items()}
    prompt = np.random.RandomState(1).randint(0, 48, size=(2, 6)).astype(np.int32)
    want = np.asarray(G.generate(convert.from_hf_llama(state, tcfg, device="cpu"), prompt, tcfg,
                                 max_new=5, device="cpu"))
    from gpushare_device_plugin_tpu.workloads import generate as JG

    ref = np.asarray(JG.generate(JC.from_hf_llama(state, jcfg), jnp.asarray(prompt), jcfg,
                                 max_new=5))
    np.testing.assert_array_equal(want, ref)


@pytest.mark.parametrize("missing", ["lm_head.weight", "model.layers.1.mlp.up_proj.weight"])
def test_missing_name_raises_key_error_naming_it(missing):
    jcfg, tcfg = _configs(SHAPES[0])
    state = _hf_state(SHAPES[0])
    del state[missing]
    with pytest.raises(KeyError, match=missing):
        JC.from_hf_llama(state, jcfg)
    with pytest.raises(KeyError, match=missing):
        convert.from_hf_llama(state, tcfg, device="cpu")


def test_the_small_names_equal_the_reference():
    for slots, width in ((0, 0), (3, 5), (8, 129)):
        kw = dict(slots=slots, total_pages=10, page_size=16, page_bytes=64, kv_bytes=640,
                  table_bytes=slots * (width * 4 + 4), freelist_bytes=40)
        assert Pg.PagedPlan(**kw).max_pages_per_row == JPg.PagedPlan(**kw).max_pages_per_row
        assert Pg.PagedPlan(**kw).max_pages_per_row == width
    assert Pg.SCRATCH == JPg.SCRATCH == G.SCRATCH == 0
    assert A.ADAPTER_COUNTER_FAMILIES == JA.ADAPTER_COUNTER_FAMILIES
    port, ref = D.DrainHandshake(), JD.DrainHandshake()
    for step in (lambda h: None, lambda h: h.request(), lambda h: h.publish({"rows": 1}),
                 lambda h: h.wait(0.1), lambda h: h.finish_run()):
        step(port)
        step(ref)
        assert port.doc() == ref.doc()
    assert fa.NEG_INF == float("-inf")
