"""Serving from int8 weights and an int8 KV cache with bounded
dequantization (gpushare_device_plugin_tpu_torch/workloads/quant.py
``qmatmul``, ``quantize_decoder``; workloads/generate.py's row blocks)
against the reference (gpushare_device_plugin_tpu/workloads/quant.py and
generate.py), on the CPU.

The port dequantizes an int8 weight a block of output channels at a time
and an int8 cache a block of rows at a time, where the reference
dequantizes whole tensors. ``quant.DEQUANT_BLOCK`` is set here to 1 (every
column, slice and row its own block, the most the blocking can split) and
to a ragged size between, so any block edge the code gets wrong shows.
Codes must be equal, products within 1e-6 in f32, and the paged
primitives' logits within 1e-5 and pages within ``assert_cache_close``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpushare_device_plugin_tpu.workloads import generate as JG
from gpushare_device_plugin_tpu.workloads import quant as JQ
from gpushare_device_plugin_tpu_torch.serving.pages import SCRATCH
from gpushare_device_plugin_tpu_torch.workloads import generate as G
from gpushare_device_plugin_tpu_torch.workloads import quant as Q
from gpushare_device_plugin_tpu_torch.workloads import transformer as T

from torch_parity import assert_cache_close, configs, params_pair, to_numpy, tokens

# The reference transformer's product of each weight: (equation, contracted dims).
PRODUCTS = {
    "wq": ("btd,dhn->bthn", 1),
    "wkv": ("btd,dchn->btchn", 1),
    "wo": ("bthn,hnd->btd", 2),
    "wi": ("btd,dcf->btcf", 1),
    "wdown": ("btf,fd->btd", 1),
    "out": ("btd,dv->btv", 1),
}
DIM = {"wdown": 1, "wo": 2}  # the model dim of each weight, for _proj (0 otherwise)
BLOCKS = [1, 1000]  # elements dequantized at once: one column, or a ragged block


@pytest.fixture(scope="module")
def model():
    """The small decoder's int8 tree, made by the reference and crossed by
    value, beside the reference's."""
    jcfg, tcfg = configs()
    jq, tq = params_pair(jcfg, tcfg, transform=JQ.quantize_decoder)
    return jcfg, tcfg, jq, tq


@pytest.mark.parametrize("block", BLOCKS)
def test_sliced_quantize_decoder_codes_equal_reference(block, monkeypatch):
    """``quantize_decoder`` a layer, a block of embedding rows or a block of
    head columns at a time gives the reference's whole-tree codes and
    scales."""
    monkeypatch.setattr(Q, "DEQUANT_BLOCK", block)
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


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", sorted(PRODUCTS))
def test_blocked_product_equals_reference_dequantize_then_product(model, name, block,
                                                                  monkeypatch):
    """Each layer weight of each layer, and the output head: the port's
    blocked ``qmatmul`` (through ``transformer._proj``, as the layers call
    it) against the reference's ``dequantize`` followed by the product."""
    monkeypatch.setattr(Q, "DEQUANT_BLOCK", block)
    _, tcfg, jq, tq = model
    eq, n_in = PRODUCTS[name]
    if name == "out":
        pairs = [(jq["out"], tq["out"])]
    else:
        pairs = [({k: v[i] for k, v in jq["layers"][name].items()},
                  T.layer_params(tq["layers"], i)[name]) for i in range(tcfg.n_layers)]
    for jw, tw in pairs:
        np.testing.assert_array_equal(tw["q8"].numpy(), np.asarray(jw["q8"]))
        x = np.random.RandomState(5).randn(2, 3, *jw["q8"].shape[:n_in]).astype(np.float32)
        want = np.asarray(jnp.einsum(eq, jnp.asarray(x), JQ.dequantize(jw, jnp.float32)))
        got = T._proj(eq, torch.from_numpy(x), tw, tcfg, None, DIM.get(name, 0))
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_one_pass_dequantize_is_the_two_pass_arithmetic(dtype):
    """``dequantize`` (and ``dequantize_kv``) compute ``q8 * scale`` in f32
    and round to ``dtype`` as they store: bit for bit the values of
    ``(q8.float() * scale).to(dtype)``, the reference's arithmetic."""
    w = torch.from_numpy(np.random.RandomState(6).randn(67, 45).astype(np.float32) * 3)
    qt = Q.quantize(w, (0,))
    assert torch.equal(Q.dequantize(qt, dtype), (qt["q8"].float() * qt["scale"]).to(dtype))
    q8, scale = Q.quantize_kv(w.reshape(3, 5, 3, 67))
    assert torch.equal(Q.dequantize_kv(q8, scale, dtype),
                       (q8.float() * scale[..., None]).to(dtype))


PS, C, SLOTS, PAGES, ROW_PAGES = 4, 8, 3, 13, 4  # test_torch_paged.py's pool


def _table(*pages):
    out = np.full((ROW_PAGES,), SCRATCH, np.int32)
    out[: len(pages)] = pages
    return out


@pytest.mark.parametrize("block", BLOCKS)
def test_blocked_int8_pages_equal_reference(model, block, monkeypatch):
    """The int8 tree over an int8 paged pool: two prompt chunks, an extend
    that reads another row's pages, two pool-wide decode steps (an idle row
    on the scratch page) and a verify block, each row's gathered pages
    dequantized in its own block. Logits within 1e-5 for every row that
    reads real pages, pages (but the scratch page) within one quantization
    step, lengths equal."""
    monkeypatch.setattr(Q, "DEQUANT_BLOCK", block)
    jcfg, tcfg, jq, tq = model
    jc = JG.init_paged_cache(jcfg, SLOTS, PAGES, PS, kv_dtype="int8")
    tc = G.init_paged_cache(tcfg, SLOTS, PAGES, PS, kv_dtype="int8", device="cpu")
    toks = tokens((3, C), seed=4)

    def close(tl, jl, rows):
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
        assert_cache_close({k: v[:, SCRATCH + 1:] for k, v in tc.items() if k != "len"},
                           {k: v[:, SCRATCH + 1:] for k, v in jc.items() if k != "len"})

    for slot, table, n_real in ((0, _table(9, 3), C), (2, _table(5), 3)):
        jl, jc = JG.paged_prefill_slot(jq, jnp.asarray(toks[slot]), jc, jcfg, slot=slot,
                                       page_table=jnp.asarray(table), n_real=n_real)
        tl, tc = G.paged_prefill_slot(tq, torch.from_numpy(toks[slot]).long(), tc, tcfg,
                                      slot=slot, page_table=torch.from_numpy(table),
                                      n_real=n_real)
        close(tl, jl, [0])
    t1 = _table(9, 3, 12, 7)
    jl, jc = JG.paged_extend_slot(jq, jnp.asarray(toks[1]), jc, jcfg, slot=1,
                                  page_table=jnp.asarray(t1), pos=C, n_real=5)
    tl, tc = G.paged_extend_slot(tq, torch.from_numpy(toks[1]).long(), tc, tcfg, slot=1,
                                 page_table=torch.from_numpy(t1), pos=C, n_real=5)
    close(tl, jl, [0])

    tables = np.stack([_table(9, 3, 2), t1, _table()])
    jc = {**jc, "len": jnp.asarray([8, 13, ROW_PAGES * PS], jnp.int32)}
    tc = {**tc, "len": torch.tensor([8, 13, ROW_PAGES * PS], dtype=torch.int32)}
    for step in range(2):
        tok = tokens((3,), seed=10 + step)
        jl, jc = JG.paged_decode_step(jq, jnp.asarray(tok), jc, jcfg,
                                      page_tables=jnp.asarray(tables))
        tl, tc = G.paged_decode_step(tq, torch.from_numpy(tok).long(), tc, tcfg,
                                     page_tables=torch.from_numpy(tables))
        close(tl, jl, [0, 1])
    block_toks = tokens((3, 3), seed=20)
    jl, jc = JG.paged_verify_block(jq, jnp.asarray(block_toks), jc, jcfg,
                                   page_tables=jnp.asarray(tables))
    tl, tc = G.paged_verify_block(tq, torch.from_numpy(block_toks).long(), tc, tcfg,
                                  page_tables=torch.from_numpy(tables))
    close(tl, jl, [0, 1])


@pytest.mark.parametrize("block", BLOCKS)
def test_blocked_int8_generate_equals_reference(model, block, monkeypatch):
    """The contiguous path: int8 weights and an int8 KV cache, a batch of
    three left-padded prompts (``prompt_lens``) and three full ones, every
    cache row and weight column dequantized in blocks: the reference's
    greedy tokens."""
    monkeypatch.setattr(Q, "DEQUANT_BLOCK", block)
    jcfg, tcfg, jq, tq = model
    prompt = tokens((3, 6), seed=3)
    lens = np.array([6, 4, 2], np.int32)
    for kw in ({}, {"prompt_lens": lens}):
        want = np.asarray(JG.generate(jq, jnp.asarray(prompt), jcfg, max_new=5,
                                      kv_dtype="int8", **{k: jnp.asarray(v) for k, v in kw.items()}))
        got = G.generate(tq, prompt, tcfg, max_new=5, kv_dtype="int8", device="cpu",
                         **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_array_equal(got.numpy(), want)
