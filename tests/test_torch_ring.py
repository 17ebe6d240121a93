"""The port's ring attention (gpushare_device_plugin_tpu_torch/parallel/
ring.py, collectives.py) on four gloo ranks against the reference's
ring_attention on four host devices, with the same numpy inputs.

One spawn of four ranks runs every case: rings of 4 (sp=4) and of 2
(dp=2 x sp=2, and tp=2 x sp=2 with heads split over tp), the 1-rank axis
(dp=4), causal and not, MHA and GQA, plain and flash hops (on CPU tensors
the flash wrapper runs the kernel's plain version; the reference runs its
Pallas kernel in interpret mode). Tolerances, f32: outputs 1e-5 (the same
exact softmax summed in another order); gradients 1e-4 of the largest
magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from gpushare_device_plugin_tpu.parallel.ring import full_attention, ring_attention

import torch_ranks

OUT_ATOL = 1e-5
GRAD_REL = 1e-4
SEQ = (None, "sp", None)

# name: (mesh spec, dims of [B, S, H], B, S, H, Hkv, D, causal, hops, grad)
CASES = {
    "mha_causal_n4": (dict(sp=4), SEQ, 2, 32, 4, 4, 8, True, "plain", False),
    "mha_noncausal_n4": (dict(sp=4), SEQ, 2, 32, 4, 4, 8, False, "plain", False),
    "gqa_causal_n4": (dict(sp=4), SEQ, 2, 32, 8, 2, 8, True, "plain", False),
    "gqa_noncausal_n4": (dict(sp=4), SEQ, 2, 32, 8, 2, 8, False, "plain", False),
    "gqa_causal_dp2_sp2": (dict(dp=2, sp=2), (("dp",), "sp", None), 2, 16, 8, 2, 8, True,
                           "plain", False),
    "mha_noncausal_dp2_sp2": (dict(dp=2, sp=2), (("dp",), "sp", None), 2, 16, 4, 4, 8, False,
                              "plain", False),
    "mha_causal_tp2_sp2": (dict(tp=2, sp=2), (None, "sp", "tp"), 2, 16, 4, 4, 8, True,
                           "plain", False),
    "gqa_causal_tp2_sp2": (dict(tp=2, sp=2), (None, "sp", "tp"), 2, 16, 8, 2, 8, True,
                           "plain", False),
    "one_rank_axis": (dict(dp=4), (("dp",), "sp", None), 4, 16, 4, 4, 8, True, "plain", False),
    "flash_causal_n4": (dict(sp=4), SEQ, 2, 64, 4, 2, 16, True, "flash", False),
    "flash_noncausal_n4": (dict(sp=4), SEQ, 2, 64, 4, 2, 16, False, "flash", False),
    "auto_causal_n4": (dict(sp=4), SEQ, 1, 32, 4, 2, 8, True, "auto", False),
    "grad_gqa_causal_n4": (dict(sp=4), SEQ, 1, 16, 4, 2, 4, True, "plain", True),
    "grad_gqa_causal_flash_n4": (dict(sp=4), SEQ, 1, 64, 2, 1, 8, True, "flash", True),
    "grad_gqa_noncausal_flash_n4": (dict(sp=4), SEQ, 1, 32, 4, 2, 8, False, "flash", True),
    "grad_mha_noncausal_dp2_sp2": (dict(dp=2, sp=2), (("dp",), "sp", None), 2, 16, 2, 2, 4,
                                   False, "plain", True),
}
# The case whose reference runs the Pallas kernel (interpret mode) per hop.
REFERENCE_FLASH = "flash_causal_n4"


def _inputs(name):
    _, _, B, S, H, Hkv, D, *_ = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name))
    return [rng.randn(B, S, h, D).astype(np.float32) for h in (H, Hkv, Hkv)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jobs = []
    for name, (spec, dims, *_, causal, hops, grad) in CASES.items():
        q, k, v = _inputs(name)
        jobs.append((name, "attention", dict(spec=spec, scheme="ring", q=q, k=k, v=v, dims=dims,
                                             causal=causal, hop_attention=hops, grad=grad)))
    q, k, v = _inputs("mha_causal_n4")
    jobs.append(("bad_hops", "attention", dict(spec=dict(sp=4), scheme="ring", q=q, k=k, v=v,
                                               dims=SEQ, hop_attention="bogus")))
    return torch_ranks.spawn(4, jobs, tmp_path_factory.mktemp("ring4"))


def _reference_mesh(spec):
    axes = [a for a in ("dp", "tp", "sp") if a in spec or a == "sp"]
    devs = np.array(jax.devices()[:4]).reshape([spec.get(a, 1) for a in axes])
    return Mesh(devs, tuple(axes))


def _reference(name, q, k, v, hops):
    spec, dims, *_, causal, _, _ = CASES[name]
    return ring_attention(q, k, v, _reference_mesh(spec), causal=causal,
                          batch_axes=dims[0], head_axes=dims[2], hop_attention=hops)


def _jit_reference(name, hops):
    return jax.jit(lambda q, k, v: _reference(name, q, k, v, hops))


def _global(ranks, name, key="out", i=None):
    spec, dims = CASES[name][:2]
    shards = [r[name][key] if i is None else r[name][key][i] for r in ranks]
    shape = _inputs(name)[0 if i is None else i].shape
    return torch_ranks.assemble(shards, shape, spec, dims)


def _grouped_oracle(q, k, v, causal):
    g = q.shape[2] // k.shape[2]
    rep = lambda x: jnp.repeat(jnp.asarray(x), g, axis=2)  # noqa: E731
    oracle = jax.jit(lambda q, k, v: full_attention(q, rep(k), rep(v), causal=causal))
    return np.asarray(oracle(q, k, v))


@pytest.mark.parametrize("name", [n for n in CASES if not CASES[n][-1]])
def test_ring_matches_reference_ring_and_oracle(ranks, name):
    q, k, v = _inputs(name)
    hops = "flash" if name == REFERENCE_FLASH else "plain"
    want = np.asarray(_jit_reference(name, hops)(q, k, v))
    got = _global(ranks, name)
    np.testing.assert_allclose(got, want, atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(got, _grouped_oracle(q, k, v, CASES[name][7]), atol=OUT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][-1]])
def test_ring_gradients_match_jax_grad(ranks, name):
    x = list(map(jnp.asarray, _inputs(name)))
    loss = lambda q, k, v: jnp.sum(_reference(name, q, k, v, "plain") ** 2)  # noqa: E731
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*x)
    for i, w in enumerate(want):
        got = _global(ranks, name, "grads", i)
        w = np.asarray(w)
        np.testing.assert_allclose(got, w, atol=GRAD_REL * np.abs(w).max(), rtol=0)
        assert np.abs(got).sum() > 0


@pytest.mark.parametrize("name", ["mha_causal_n4", "mha_noncausal_n4", "flash_causal_n4",
                                  "flash_noncausal_n4", "gqa_causal_dp2_sp2"])
def test_causal_hops_into_the_future_are_skipped_per_rank(ranks, name):
    """Rank i of a causal ring of n computes i+1 hops (its own block and
    the i before it), a non-causal one n; every rank still joins all n-1
    exchanges."""
    spec, _, *_, causal, hops, _ = CASES[name]
    n = spec["sp"]
    kind = "flash" if hops == "flash" else "plain"
    for rank, r in enumerate(ranks):
        i = torch_ranks.block(spec, rank, "sp")[0]
        assert r[name]["calls"][kind] == (i + 1 if causal else n), (rank, r[name]["calls"])
        assert r[name]["traffic"]["shift"][0] == n - 1


def test_k_and_v_travel_in_one_exchange_per_hop(ranks):
    _, _, B, S, H, Hkv, D, *_ = CASES["gqa_causal_n4"]
    T = S // 4
    for r in ranks:
        calls, nbytes = r["gqa_causal_n4"]["traffic"]["shift"]
        assert calls == 3 and nbytes == 3 * 2 * B * T * Hkv * D * 4  # grouped heads only


def test_gradient_exchanges_run_backward_on_every_rank(ranks):
    """The backward sends each hop's dK/dV back: 2(n-1) exchanges a rank,
    skipped hops included (rank 0 of a causal ring uses no hop but its
    own, and still takes part)."""
    for r in ranks:
        assert r["grad_gqa_causal_n4"]["traffic"]["shift"][0] == 6
        assert r["grad_gqa_causal_flash_n4"]["traffic"]["shift"][0] == 6


def test_one_rank_axis_moves_nothing(ranks):
    for r in ranks:
        assert r["one_rank_axis"]["traffic"] == {}
        assert r["one_rank_axis"]["calls"]["plain"] == 1


def test_auto_hops_stay_plain_on_cpu_tensors(ranks):
    for rank, r in enumerate(ranks):
        assert r["auto_causal_n4"]["calls"] == {"plain": rank + 1, "flash": 0}


def test_unknown_hop_attention_raises_like_reference(ranks):
    for r in ranks:
        assert "hop_attention" in r["bad_hops"]["error"]
    q = jnp.zeros((1, 16, 2, 4))
    with pytest.raises(ValueError, match="hop_attention"):
        ring_attention(q, q, q, _reference_mesh(dict(sp=4)), hop_attention="bogus")
