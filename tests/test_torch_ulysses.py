"""The port's Ulysses attention (gpushare_device_plugin_tpu_torch/parallel/
ulysses.py) on eight gloo ranks against the reference's ulysses_attention
on host devices, with the same numpy inputs.

One spawn of eight ranks runs every case: sp=8, and sp=4 rings beside a
dp=2 axis (dp=2 x sp=4) or a tp=2 axis (tp=2 x sp=4), MHA and GQA, the
gcd scatter for Hkv % n != 0, the plain inner attention and the flash
one (on CPU tensors its wrapper runs the kernel's plain version).
Tolerances, f32: outputs 1e-5 (the same exact softmax summed in another
order); gradients 1e-4 of the largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from gpushare_device_plugin_tpu.parallel.ring import full_attention
from gpushare_device_plugin_tpu.parallel.ulysses import ulysses_attention

import torch_ranks

OUT_ATOL = 1e-5
GRAD_REL = 1e-4
SEQ = (None, "sp", None)
DP_SEQ = (("dp",), "sp", None)

# name: (mesh spec, dims of [B, S, H], B, S, H, Hkv, D, causal, inner, grad)
CASES = {
    "mha_causal_n8": (dict(sp=8), SEQ, 2, 32, 8, 8, 8, True, None, False),
    "mha_noncausal_n8": (dict(sp=8), SEQ, 2, 32, 8, 8, 8, False, None, False),
    "gqa_grouped_n8": (dict(sp=8), SEQ, 2, 32, 16, 8, 8, True, None, False),
    "gcd_n8_hkv2_h8": (dict(sp=8), SEQ, 2, 16, 8, 2, 8, True, None, False),
    "gcd_n4_hkv2_h8": (dict(dp=2, sp=4), DP_SEQ, 2, 8, 8, 2, 8, True, None, False),
    "gcd_n8_hkv4_h16": (dict(sp=8), SEQ, 2, 16, 16, 4, 8, True, None, False),
    "gcd_n8_hkv6_h24": (dict(sp=8), SEQ, 2, 16, 24, 6, 8, True, None, False),
    "tp2_sp4": (dict(tp=2, sp=4), (None, "sp", "tp"), 2, 16, 8, 8, 8, True, None, False),
    "flash_inner_n8": (dict(sp=8), SEQ, 1, 64, 8, 8, 8, True, "flash", False),
    "grad_mha_n8": (dict(sp=8), SEQ, 1, 16, 8, 8, 4, True, None, True),
    "grad_gcd_n4": (dict(dp=2, sp=4), DP_SEQ, 2, 8, 8, 2, 4, True, None, True),
    "grad_flash_inner_n8": (dict(sp=8), SEQ, 1, 32, 8, 4, 8, False, "flash", True),
}


def _inputs(name):
    _, _, B, S, H, Hkv, D, *_ = CASES[name]
    rng = np.random.RandomState(100 + sorted(CASES).index(name))
    return [rng.randn(B, S, h, D).astype(np.float32) for h in (H, Hkv, Hkv)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jobs = []
    for name, (spec, dims, *_, causal, inner, grad) in CASES.items():
        q, k, v = _inputs(name)
        jobs.append((name, "attention", dict(spec=spec, scheme="ulysses", q=q, k=k, v=v,
                                             dims=dims, causal=causal, inner=inner, grad=grad)))
    z = np.zeros((1, 16, 8, 4), np.float32)
    kv3 = np.zeros((1, 16, 3, 4), np.float32)
    jobs.append(("bad_ratio", "attention", dict(spec=dict(sp=8), scheme="ulysses", q=z, k=kv3,
                                                v=kv3, dims=SEQ)))
    q4 = np.zeros((1, 16, 4, 4), np.float32)
    jobs.append(("heads_below_sp", "attention", dict(spec=dict(sp=8), scheme="ulysses", q=q4,
                                                     k=q4, v=q4, dims=SEQ)))
    return torch_ranks.spawn(8, jobs, tmp_path_factory.mktemp("ulysses8"))


def _reference(name):
    spec, dims, *_, causal, _, _ = CASES[name]
    axes = [a for a in ("dp", "tp", "sp") if a in spec]
    mesh = Mesh(np.array(jax.devices()).reshape([spec[a] for a in axes]), tuple(axes))
    return lambda q, k, v: ulysses_attention(q, k, v, mesh, causal=causal, batch_axes=dims[0],
                                             head_axes=dims[2])


def _global(ranks, name, key="out", i=None):
    spec, dims = CASES[name][:2]
    shards = [r[name][key] if i is None else r[name][key][i] for r in ranks]
    return torch_ranks.assemble(shards, _inputs(name)[i or 0].shape, spec, dims)


@pytest.mark.parametrize("name", [n for n in CASES if not CASES[n][-1]])
def test_ulysses_matches_reference_and_oracle(ranks, name):
    q, k, v = _inputs(name)
    got = _global(ranks, name)
    np.testing.assert_allclose(got, np.asarray(jax.jit(_reference(name))(q, k, v)),
                               atol=OUT_ATOL, rtol=0)
    g = q.shape[2] // k.shape[2]
    oracle = jax.jit(lambda q, k, v: full_attention(
        q, jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2), causal=CASES[name][7]))
    np.testing.assert_allclose(got, np.asarray(oracle(q, k, v)), atol=OUT_ATOL, rtol=0)


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][-1]])
def test_ulysses_gradients_match_jax_grad(ranks, name):
    ref = _reference(name)
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(ref(q, k, v) ** 2), argnums=(0, 1, 2)))(
        *_inputs(name))
    for i, w in enumerate(want):
        w = np.asarray(w)
        got = _global(ranks, name, "grads", i)
        np.testing.assert_allclose(got, w, atol=GRAD_REL * np.abs(w).max(), rtol=0)
        assert np.abs(got).sum() > 0


@pytest.mark.parametrize("name,below_full", [
    ("gcd_n4_hkv2_h8", True), ("gcd_n8_hkv4_h16", True), ("gcd_n8_hkv2_h8", False),
    ("gcd_n8_hkv6_h24", False)])
def test_gcd_scatter_never_sends_full_heads(ranks, name, below_full):
    """Hkv % n != 0: K and V go out as n * Hkv/gcd(Hkv, n) head slots
    (block replication, r = n/gcd <= g times the grouped bytes), never
    repeated to the H query heads: fewer slots than H wherever r < g (at
    r == g the two coincide). Each rank's all-to-alls carry q, K, V and
    the output, each whole."""
    spec, _, B, S, H, Hkv, D, *_ = CASES[name]
    n, dp = spec["sp"], spec.get("dp", 1)
    slots = n * (Hkv // np.gcd(Hkv, n))
    assert (slots < H) if below_full else (slots == H)
    per_head = (B // dp) * (S // n) * D * 4
    for r in ranks:
        calls, nbytes = r[name]["traffic"]["all_to_all"]
        assert calls == 4
        assert nbytes == per_head * (H + 2 * slots + H)


def test_grouped_kv_scatter_as_they_are(ranks):
    _, _, B, S, H, Hkv, D, *_ = CASES["gqa_grouped_n8"]
    for r in ranks:
        assert r["gqa_grouped_n8"]["traffic"]["all_to_all"] == (4, B * (S // 8) * D * 4
                                                                * (2 * H + 2 * Hkv))


def test_backward_runs_the_inverse_all_to_alls(ranks):
    for r in ranks:
        assert r["grad_mha_n8"]["traffic"]["all_to_all"][0] == 8  # 4 forward, 4 backward


def test_bad_head_ratio_raises_like_reference(ranks):
    for r in ranks:
        assert "not a multiple" in r["bad_ratio"]["error"]
        assert "divisible by sp=8" in r["heads_below_sp"]["error"]
    mesh = Mesh(np.array(jax.devices()), ("sp",))
    with pytest.raises(ValueError, match="not a multiple"):
        ulysses_attention(jnp.zeros((1, 16, 8, 4)), jnp.zeros((1, 16, 3, 4)),
                          jnp.zeros((1, 16, 3, 4)), mesh)
