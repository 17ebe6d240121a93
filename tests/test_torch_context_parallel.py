"""The decoder's context-parallel training path (gpushare_device_plugin_tpu_
torch/workloads/transformer.py with a mesh) on gloo ranks against the
reference's loss_fn(..., mesh) and make_train_step on host devices, with
the same weights (reference-made, crossed over with convert.from_jax_numpy)
and the same numpy tokens.

Two spawns, started together, run every case: two ranks (sp=2; dp=2 without sequence
parallelism) and four (dp=2 x sp=2; sp=4, where Ulysses scatters the two
KV heads by their gcd). Ring and Ulysses, remat "full" and "dots".
Tolerances, f32: loss rtol 1e-5; gradients summed over the mesh 1e-4 of
each leaf's largest magnitude (the same f32 sums cut into rank shares and
added in another order); after AdamW steps the losses rtol 1e-5 and the
parameters atol 1e-5 (the update of a near-zero gradient can flip sign,
so Adam's step of lr there is allowed on at most 0.1% of the entries).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpushare_device_plugin_tpu.parallel import MeshSpec as JMeshSpec
from gpushare_device_plugin_tpu.parallel import make_mesh as jmake_mesh
from gpushare_device_plugin_tpu.workloads import optim as JO
from gpushare_device_plugin_tpu.workloads import transformer as JT
from gpushare_device_plugin_tpu_torch.parallel.mesh import Mesh, MeshSpec
from gpushare_device_plugin_tpu_torch.workloads import transformer as T

import torch_ranks
from torch_parity import SHAPE, tokens, to_numpy

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
PARAM_ATOL = 1e-5
LR = 1e-2
TOKENS = tokens((4, 16), seed=5)

# name: (mesh spec, context_parallel or None (no sequence parallelism), remat policy)
GRAD_CASES = {
    "sp2_ring_full": (dict(sp=2), "ring", "full"),
    "sp2_ring_dots": (dict(sp=2), "ring", "dots"),
    "sp2_ulysses_full": (dict(sp=2), "ulysses", "full"),
    "sp2_ulysses_dots": (dict(sp=2), "ulysses", "dots"),
    "dp2": (dict(dp=2), None, "full"),
    "dp2_sp2_ring_full": (dict(dp=2, sp=2), "ring", "full"),
    "dp2_sp2_ring_dots": (dict(dp=2, sp=2), "ring", "dots"),
    "dp2_sp2_ulysses_full": (dict(dp=2, sp=2), "ulysses", "full"),
    "dp2_sp2_ulysses_dots": (dict(dp=2, sp=2), "ulysses", "dots"),
    "sp4_ulysses_gcd": (dict(sp=4), "ulysses", "full"),
    "sp4_ring": (dict(sp=4), "ring", "dots"),
}
# name: (mesh spec, context_parallel, steps, accum_steps)
STEP_CASES = {
    "step_sp2_ring": (dict(sp=2), "ring", 2, 1),
    "step_sp2_ulysses_accum2": (dict(sp=2), "ulysses", 2, 2),
    "step_dp2_sp2_ring": (dict(dp=2, sp=2), "ring", 2, 1),
}


def _cfg(cp, remat_policy="full"):
    seq = dict(seq_parallel=True, context_parallel=cp) if cp else {}
    return dict(SHAPE, remat_policy=remat_policy, **seq)


def _world(spec):
    return int(np.prod(list(spec.values())))


@functools.cache
def _params():
    return to_numpy(JT.init_params(jax.random.key(0), JT.TransformerConfig(**SHAPE)))


def _jobs(world):
    jobs = [(name, "decoder_grads", dict(spec=spec, params=_params(), tokens=TOKENS,
                                          cfg=_cfg(cp, remat)))
            for name, (spec, cp, remat) in GRAD_CASES.items() if _world(spec) == world]
    jobs += [(name, "train_steps", dict(spec=spec, params=_params(), tokens=TOKENS,
                                         cfg=_cfg(cp), steps=steps, accum_steps=accum, lr=LR))
             for name, (spec, cp, steps, accum) in STEP_CASES.items() if _world(spec) == world]
    return jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both spawns' results, each rank's by job name, by world size."""
    handles = {}
    for world in (2, 4):
        jobs = _jobs(world)
        if world == 2:
            jobs.append(("sp_without_seq_parallel", "decoder_grads",
                         dict(spec=dict(sp=2), params=_params(), tokens=TOKENS, cfg=_cfg(None))))
        handles[world] = torch_ranks.start(world, jobs, tmp_path_factory.mktemp(f"cp{world}"))
    return {world: torch_ranks.collect(h) for world, h in handles.items()}


def _jcfg(cp, **kw):
    seq = dict(seq_parallel=True, context_parallel=cp) if cp else {}
    return JT.TransformerConfig(**SHAPE, compute_dtype=jnp.float32, **seq, **kw)


def _jmesh(spec):
    return jmake_mesh(JMeshSpec(**spec), devices=jax.devices()[:_world(spec)])


@functools.cache
def _reference_grads(spec_items, cp):
    spec = dict(spec_items)
    cfg, mesh = _jcfg(cp), _jmesh(spec)
    fn = jax.jit(lambda p, t: jax.value_and_grad(JT.loss_fn)(p, t, cfg, mesh))
    loss, grads = fn(jax.tree.map(jnp.asarray, _params()), jnp.asarray(TOKENS))
    return float(loss), to_numpy(grads)


def _flat(tree):
    return T._flatten(tree)


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_loss_matches_reference_on_every_rank(ranks, name):
    spec, cp, _ = GRAD_CASES[name]
    want, _ = _reference_grads(tuple(spec.items()), cp)
    for r in ranks[_world(spec)]:
        np.testing.assert_allclose(r[name]["loss"], want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_summed_gradients_match_reference_on_every_rank(ranks, name):
    spec, cp, _ = GRAD_CASES[name]
    _, want = _reference_grads(tuple(spec.items()), cp)
    for r in ranks[_world(spec)]:
        got = r[name]["grads"]
        for leaf, w in _flat(want).items():
            w = np.asarray(w)
            np.testing.assert_allclose(got[leaf], w, atol=GRAD_REL * np.abs(w).max(), rtol=0,
                                       err_msg=f"{name}: {leaf}")
        assert all(np.abs(g).sum() > 0 for g in got.values())


@functools.cache
def _reference_steps(name):
    spec, cp, steps, accum = STEP_CASES[name]
    cfg, mesh = _jcfg(cp), _jmesh(spec)
    params = jax.tree.map(jnp.asarray, _params())
    opt = JO.make_optimizer(LR)
    state = opt.init(params)
    step = JT.make_train_step(mesh, cfg, opt, accum_steps=accum)
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, jnp.asarray(TOKENS))
        losses.append(float(loss))
    return losses, to_numpy(params)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_adamw_steps_match_reference_make_train_step(ranks, name):
    spec = STEP_CASES[name][0]
    want_losses, want_params = _reference_steps(name)
    for r in ranks[_world(spec)]:
        np.testing.assert_allclose(r[name]["losses"], want_losses, rtol=LOSS_RTOL)
        for leaf, w in _flat(want_params).items():
            diff = np.abs(r[name]["params"][leaf] - np.asarray(w))
            assert diff.max() <= 2 * LR, (name, leaf, diff.max())
            assert (diff > PARAM_ATOL).mean() <= 1e-3, (name, leaf, (diff > PARAM_ATOL).mean())


def test_replicas_stay_bitwise_equal(ranks):
    """Every rank applies the same summed gradients to its replica."""
    for world in (2, 4):
        for name in (n for n, c in STEP_CASES.items() if _world(c[0]) == world):
            first = ranks[world][0][name]["params"]
            for r in ranks[world][1:]:
                assert all(np.array_equal(first[k], r[name]["params"][k]) for k in first)


def test_sp_mesh_without_seq_parallel_raises(ranks):
    for r in ranks[2]:
        assert "seq_parallel=True" in r["sp_without_seq_parallel"]["error"]


@pytest.mark.parametrize("spec", [dict(tp=2), dict(fsdp=2), dict(dp=2, tp=2)])
def test_tensor_parallel_and_fsdp_meshes_raise_naming_the_later_slice(spec):
    """tp and fsdp meshes train since the tensor-parallel / FSDP slice
    (tests/test_torch_tp_train.py): a train step builds on each. What
    still raises is a tp that does not divide what the decoder cuts over
    it (here the vocabulary), named in the error."""
    mesh = Mesh(MeshSpec(**spec), rank=0, device="cpu", backend="gloo", groups={}, ranks={})
    tcfg = T.TransformerConfig(**_cfg("ring"))
    assert callable(T.make_train_step(tcfg, mesh=mesh))
    odd = dataclasses.replace(tcfg, vocab=63)
    if spec.get("tp", 1) > 1:
        with pytest.raises(ValueError, match="does not divide vocab=63"):
            T.make_train_step(odd, mesh=mesh)
        with pytest.raises(ValueError, match="does not divide vocab=63"):
            T.loss_fn({}, torch.zeros((2, 8), dtype=torch.long), odd, mesh)
    else:
        assert callable(T.make_train_step(odd, mesh=mesh))


def test_seq_parallel_without_mesh_raises_like_reference():
    tcfg = T.TransformerConfig(**_cfg("ring"), compute_dtype=torch.float32)
    params = T.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
        T.loss_fn(params, torch.zeros((1, 8), dtype=torch.long), tcfg)
    with pytest.raises(ValueError, match="requires a mesh"):
        JT.loss_fn(to_numpy(JT.init_params(jax.random.key(0), _jcfg("ring"))),
                   jnp.zeros((1, 8), jnp.int32), _jcfg("ring"))


def test_unknown_context_parallel_raises_like_reference():
    mesh = Mesh(MeshSpec(), rank=0, device="cpu", backend="gloo", groups={}, ranks={})
    tcfg = dataclasses.replace(T.TransformerConfig(**_cfg("bogus")), compute_dtype=torch.float32)
    params = T.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="context_parallel"):
        T.loss_fn(params, torch.zeros((1, 8), dtype=torch.long), tcfg, mesh)
