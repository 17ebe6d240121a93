"""The port's paged-cache primitives (gpushare_device_plugin_tpu_torch/
workloads/generate.py: ``paged_prefill_slot``, ``paged_extend_slot``,
``paged_decode_step``) against the reference's, f32 on the CPU.

The same pool goes through both: shuffled page tables, a radix-style
shared prefix (row 1 reads row 0's two prompt pages and extends past
them), and an idle row parked at ``len == row_span`` on an all-scratch
table. After each primitive: logits of every row that reads real pages
within 1e-5, and every physical page except the scratch page (page 0,
undefined by contract: idle rows and pad tails all write there) within
``assert_cache_close`` (1e-5; int8 within one quantization step). The
``len`` vector must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpushare_device_plugin_tpu.workloads import generate as JG
from gpushare_device_plugin_tpu_torch.serving.pages import SCRATCH
from gpushare_device_plugin_tpu_torch.workloads import generate as G

from torch_parity import assert_cache_close, configs, params_pair, tokens

PS, C, SLOTS, PAGES = 4, 8, 3, 13  # page size, chunk width, rows, physical pages
ROW_PAGES = 4  # a 16-position row span


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = configs()
    jp, tp = params_pair(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


def _table(*pages):
    out = np.full((ROW_PAGES,), SCRATCH, np.int32)
    out[: len(pages)] = pages
    return out


def _pages_close(tcache, jcache):
    """Every buffer but the scratch page, and ``len`` exactly."""
    np.testing.assert_array_equal(tcache["len"].numpy(), np.asarray(jcache["len"]))
    assert_cache_close(
        {k: v[:, SCRATCH + 1 :] for k, v in tcache.items() if k != "len"},
        {k: v[:, SCRATCH + 1 :] for k, v in jcache.items() if k != "len"},
    )


def _logits_close(tl, jl, rows):
    np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows], atol=1e-5, rtol=0)


@pytest.mark.parametrize("upto", ["prefill", "extend", "decode"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_primitives_match_reference(model, kv_dtype, upto):
    jcfg, tcfg, jp, tp = model
    jc = JG.init_paged_cache(jcfg, SLOTS, PAGES, PS, kv_dtype=kv_dtype)
    tc = G.init_paged_cache(tcfg, SLOTS, PAGES, PS, kv_dtype=kv_dtype, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {k: v.shape for k, v in jc.items()}
    toks = tokens((3, C), seed=4)

    # Row 0: an 8-token prompt chunk into shuffled pages 9 and 3.
    t0 = _table(9, 3)
    jl, jc = JG.paged_prefill_slot(
        jp, jnp.asarray(toks[0]), jc, jcfg, slot=0, page_table=jnp.asarray(t0), n_real=C
    )
    tl, tc = G.paged_prefill_slot(
        tp, torch.from_numpy(toks[0]).long(), tc, tcfg, slot=0,
        page_table=torch.from_numpy(t0), n_real=C,
    )
    _logits_close(tl, jl, [0])
    # Row 2: a 3-token chunk; its pad tail runs through SCRATCH entries.
    t2 = _table(5)
    jl, jc = JG.paged_prefill_slot(
        jp, jnp.asarray(toks[2]), jc, jcfg, slot=2, page_table=jnp.asarray(t2), n_real=3
    )
    tl, tc = G.paged_prefill_slot(
        tp, torch.from_numpy(toks[2]).long(), tc, tcfg, slot=2,
        page_table=torch.from_numpy(t2), n_real=3,
    )
    _logits_close(tl, jl, [0])
    _pages_close(tc, jc)
    if upto == "prefill":
        return

    # Row 1 shares row 0's two prompt pages and extends at position 8 with a
    # 5-token chunk into fresh pages 12 and 7: the shared pages are read only.
    t1 = _table(9, 3, 12, 7)
    jl, jc = JG.paged_extend_slot(
        jp, jnp.asarray(toks[1]), jc, jcfg, slot=1, page_table=jnp.asarray(t1), pos=C, n_real=5
    )
    tl, tc = G.paged_extend_slot(
        tp, torch.from_numpy(toks[1]).long(), tc, tcfg, slot=1,
        page_table=torch.from_numpy(t1), pos=C, n_real=5,
    )
    _logits_close(tl, jl, [0])
    _pages_close(tc, jc)
    if upto == "extend":
        return

    # Two pool-wide steps: rows 0 and 1 decode (row 0 opens page 2), row 2
    # is idle at len == row_span (16) on an all-scratch table.
    tables = np.stack([_table(9, 3, 2), t1, _table()])
    jc = {**jc, "len": jnp.asarray([8, 13, ROW_PAGES * PS], jnp.int32)}
    tc = {**tc, "len": torch.tensor([8, 13, ROW_PAGES * PS], dtype=torch.int32)}
    for step in range(2):
        tok = tokens((3,), seed=10 + step)
        jl, jc = JG.paged_decode_step(jp, jnp.asarray(tok), jc, jcfg, page_tables=jnp.asarray(tables))
        tl, tc = G.paged_decode_step(
            tp, torch.from_numpy(tok).long(), tc, tcfg, page_tables=torch.from_numpy(tables)
        )
        _logits_close(tl, jl, [0, 1])
        assert np.isfinite(tl.numpy()).all()
        _pages_close(tc, jc)


def test_decode_step_never_writes_past_its_table(model):
    """A row at ``len == row_span`` whose table maps real pages writes
    nothing into them (its write goes to the scratch page, where the
    reference drops it); the read of its view raises nothing."""
    jcfg, tcfg, jp, tp = model
    tc = G.init_paged_cache(tcfg, 1, PAGES, PS, device="cpu")
    tc["k"][:, 1:] = 1.0
    before = tc["k"][:, 1:].clone()
    tc = {**tc, "len": torch.tensor([ROW_PAGES * PS], dtype=torch.int32)}
    table = torch.from_numpy(_table(4, 6, 8, 10)[None, :])
    logits, tc = G.paged_decode_step(tp, torch.tensor([5]), tc, tcfg, page_tables=table)
    assert torch.isfinite(logits).all()
    assert torch.equal(tc["k"][:, 1:], before)
    assert tc["len"].tolist() == [ROW_PAGES * PS + 1]
