"""The decoder's parameter specs and shards in the port
(``transformer.param_specs`` / ``param_shardings`` / ``shard_params``,
``init_params(mesh=...)``, ``mesh.shard`` / ``unshard``, and the tp view of
LoRA's flat layout) against the reference's ``param_specs``,
``param_shardings`` and ``shard_params`` on host devices.

Exact throughout: specs equal, every rank's block bit-equal to the
reference's addressable shard on the device of the same index, and
``unshard`` of the shards bit-equal to the whole leaves. A rank's block
needs no exchange, so those cases build each rank's :class:`Mesh` in this
process; ``unshard`` runs on one spawn of four gloo ranks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpushare_device_plugin_tpu.parallel import MeshSpec as JMeshSpec
from gpushare_device_plugin_tpu.parallel import make_mesh as jmake_mesh
from gpushare_device_plugin_tpu.workloads import lora as JL
from gpushare_device_plugin_tpu.workloads import transformer as JT
from gpushare_device_plugin_tpu_torch.parallel.mesh import Mesh, MeshSpec, shard_axes
from gpushare_device_plugin_tpu_torch.workloads import convert
from gpushare_device_plugin_tpu_torch.workloads import lora as L
from gpushare_device_plugin_tpu_torch.workloads import transformer as T

import torch_ranks
from torch_parity import SHAPE, to_numpy

CONFIGS = {
    "llama3_8b": dict(vars(T.llama3_8b())),
    "tiny": SHAPE,
    "engine_kv4": dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4, d_ff=64,
                       max_seq=64),
    "odd_widths": dict(vocab=30, d_model=24, n_layers=1, n_heads=2, n_kv_heads=1, d_ff=36,
                       max_seq=16),
}
for c in CONFIGS.values():
    c.pop("compute_dtype", None)
MESHES = [dict(tp=tp, fsdp=fsdp) for tp in (1, 2, 4) for fsdp in (1, 2)]
SHARD_MESHES = [dict(tp=2), dict(fsdp=2), dict(fsdp=2, tp=2), dict(tp=4), dict(dp=2, tp=2)]


def _world(spec):
    return int(np.prod(list(spec.values())))


def _pmesh(spec, rank=0):
    """This process's stand-in for rank ``rank`` of the mesh (no groups:
    only its shape and coordinates, which is all a block needs)."""
    return Mesh(MeshSpec(**spec), rank=rank, device=torch.device("cpu"), backend="gloo",
                groups={}, ranks={})


def _jmesh(spec):
    return jmake_mesh(JMeshSpec(**spec), devices=jax.devices()[:_world(spec)])


def _as_tuple(spec):
    return tuple(spec)


def test_param_specs_are_the_reference_specs():
    want = jax.tree.map(_as_tuple, JT.param_specs(JT.TransformerConfig()),
                        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert T.param_specs(T.TransformerConfig()) == want


@pytest.mark.parametrize("spec", MESHES, ids=lambda s: f"tp{s['tp']}_fsdp{s['fsdp']}")
@pytest.mark.parametrize("name", list(CONFIGS))
def test_pruned_specs_are_the_reference_param_shardings(name, spec):
    jcfg = JT.TransformerConfig(**CONFIGS[name])
    want = jax.tree.map(lambda s: _as_tuple(s.spec), JT.param_shardings(_jmesh(spec), jcfg),
                        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    got = T.param_shardings(_pmesh(spec), T.TransformerConfig(**CONFIGS[name]))
    assert got == want


@functools.cache
def _whole():
    jcfg = JT.TransformerConfig(**SHAPE, compute_dtype=jnp.float32)
    return to_numpy(JT.init_params(jax.random.key(0), jcfg))


@pytest.mark.parametrize("spec", SHARD_MESHES, ids=lambda s: "_".join(f"{k}{v}" for k, v in s.items()))
def test_each_rank_block_is_the_reference_addressable_shard(spec):
    jcfg = JT.TransformerConfig(**SHAPE, compute_dtype=jnp.float32)
    tcfg = T.TransformerConfig(**SHAPE, compute_dtype=torch.float32)
    ref = JT.shard_params(jax.tree.map(jnp.asarray, _whole()), _jmesh(spec), jcfg)
    whole = convert.from_jax_numpy(_whole(), tcfg, device="cpu")
    for rank in range(_world(spec)):
        got = T._flatten(T.shard_params(whole, _pmesh(spec, rank), tcfg))
        for leaf, arr in T._flatten(ref).items():
            (want,) = [np.asarray(s.data) for s in arr.addressable_shards
                       if s.device == jax.devices()[rank]]
            np.testing.assert_array_equal(got[leaf].numpy(), want, err_msg=f"{spec} {rank} {leaf}")
            # a block owns its memory: no view keeps the whole leaf alive
            assert got[leaf].untyped_storage().nbytes() == want.nbytes


@pytest.mark.parametrize("spec", SHARD_MESHES, ids=lambda s: "_".join(f"{k}{v}" for k, v in s.items()))
def test_init_params_on_a_mesh_keeps_the_shard_of_the_whole_draw(spec):
    """Each leaf drawn whole from the same generator, then cut: a rank's
    sharded init holds exactly its block of the unsharded init."""
    tcfg = T.TransformerConfig(**SHAPE, compute_dtype=torch.float32)
    whole = T.init_params(tcfg, torch.Generator().manual_seed(3), device="cpu")
    for rank in range(_world(spec)):
        mesh = _pmesh(spec, rank)
        got = T._flatten(T.init_params(tcfg, torch.Generator().manual_seed(3), device="cpu",
                                       mesh=mesh))
        want = T._flatten(T.shard_params(whole, mesh, tcfg))
        for leaf in want:
            assert torch.equal(got[leaf], want[leaf]), (spec, rank, leaf)


def test_shard_params_passes_shards_through_and_refuses_other_shapes():
    tcfg = T.TransformerConfig(**SHAPE, compute_dtype=torch.float32)
    mesh = _pmesh(dict(fsdp=2, tp=2), rank=3)
    once = T.shard_params(T.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu"),
                          mesh, tcfg)
    twice = T.shard_params(once, mesh, tcfg)
    assert all(a is b for a, b in zip(T._flatten(once).values(), T._flatten(twice).values()))
    bad = dict(once, out=once["out"][:, :1])
    with pytest.raises(ValueError, match="neither whole"):
        T.shard_params(bad, mesh, tcfg)


def test_check_mesh_refuses_a_tp_that_does_not_divide_the_heads():
    tcfg = T.TransformerConfig(**dict(SHAPE, n_heads=2, n_kv_heads=1, d_model=32))
    with pytest.raises(ValueError, match="does not divide n_heads=2"):
        T.check_mesh(_pmesh(dict(tp=4)), tcfg)
    T.check_mesh(_pmesh(dict(tp=2)), tcfg)


def test_grad_sum_axes_follow_each_leafs_pruned_spec():
    """fsdp is summed only where a leaf is not cut over it (its gathers'
    backward summed it), tp never, dp and sp always."""
    tcfg = T.TransformerConfig(**SHAPE, compute_dtype=torch.float32)
    mesh = _pmesh(dict(dp=2, fsdp=2, tp=2))
    params = T.shard_params(T.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu"),
                            mesh, tcfg)
    axes = dict(zip(T._flatten(params), T.grad_sum_axes(params, mesh, tcfg)))
    for name in ("embed", "layers__wq", "layers__wkv", "layers__wo", "layers__wi",
                 "layers__wdown", "out"):
        assert axes[name] == ("dp", "sp"), name
    for name in ("layers__ln1", "layers__ln2", "final_norm"):
        assert axes[name] == ("dp", "fsdp", "sp"), name
    specs = T.leaf_specs(params, mesh, tcfg)
    assert [shard_axes(s) for s in specs][0] == frozenset({"tp", "fsdp"})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jobs = [("fsdp2_tp2", "shard_blocks", dict(spec=dict(fsdp=2, tp=2), params=_whole(),
                                                cfg=SHAPE)),
            ("tp4", "shard_blocks", dict(spec=dict(tp=4), params=_whole(), cfg=SHAPE)),
            ("dp2_tp2", "shard_blocks", dict(spec=dict(dp=2, tp=2), params=_whole(), cfg=SHAPE)),
            ("collectives", "collectives", dict(spec=dict(dp=2, tp=2), seed=11))]
    return torch_ranks.spawn(4, jobs, tmp_path_factory.mktemp("specs"))


@pytest.mark.parametrize("name", ["fsdp2_tp2", "tp4", "dp2_tp2"])
def test_unshard_of_shard_is_the_identity(ranks, name):
    for r in ranks:
        assert r[name]["roundtrip"]


@pytest.mark.parametrize("name", ["fsdp2_tp2", "tp4", "dp2_tp2"])
def test_unshard_to_assembles_every_leaf_on_rank_0_alone(ranks, name):
    """The checkpoint's gather: rank 0 gets each whole leaf bit for bit
    (replicated ones and those whose shards repeat over dp too), every
    other rank gets nothing."""
    assert all(ok is True for ok in ranks[0][name]["to_root"].values())
    for r in ranks[1:]:
        assert all(got is None for got in r[name]["to_root"].values())


def _tp_pairs():
    """Global ranks by tp slice of the dp=2 x tp=2 mesh: rank = 2·dp + tp."""
    return [(0, 1), (2, 3)]


def test_all_reduce_sums_bf16_partials_in_f32_alike_on_every_rank(ranks):
    """A tp sum of bf16 partials is their f32 sum rounded once to bf16, the
    same bits on both ranks of each slice; a max is exact; the f32 copy is
    what the wire carries (4 bytes an element)."""
    for pair in _tp_pairs():
        xs = [ranks[r]["collectives"]["x"] for r in pair]
        parts = [torch.from_numpy(x).to(torch.bfloat16).float() for x in xs]
        want = (parts[0] + parts[1]).to(torch.bfloat16).float().numpy()
        for r in pair:
            got = ranks[r]["collectives"]
            assert got["sum_dtype"] == "torch.bfloat16"
            np.testing.assert_array_equal(got["sum"], want)
            np.testing.assert_array_equal(got["max"], np.maximum(*xs))
            # two tp reductions of 15 and a dp one of 9 elements, all as f32
            assert got["traffic"]["all_reduce"] == (3, (2 * 15 + 9) * 4)


def test_all_reduce_sum_of_a_strided_view_lands_in_its_elements_only(ranks):
    """``all_reduce_sum_`` over dp of a column slice (not contiguous):
    those columns become the sum over the dp slice, the rest stay this
    rank's own."""
    for r in range(4):
        got = ranks[r]["collectives"]
        peer = ranks[r ^ 2]["collectives"]["x"]  # the other dp index, same tp index
        want = got["x"].copy()
        want[:, 1:4] = got["x"][:, 1:4] + peer[:, 1:4]
        np.testing.assert_array_equal(got["strided"], want)


LCFG = dict(rank=2, alpha=4.0, targets=("wq", "wkv", "wo", "wi", "wdown"))


@functools.cache
def _lora():
    jcfg = JT.TransformerConfig(**SHAPE, compute_dtype=jnp.float32)
    tree = JL.init_lora(jax.random.key(4), jcfg, JL.LoraConfig(**LCFG))
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    keys = jax.random.split(jax.random.key(5), len(leaves))
    return to_numpy(jax.tree_util.tree_unflatten(
        treedef, [jax.random.normal(k, x.shape) for k, x in zip(keys, leaves)]))


@pytest.mark.parametrize("tp", [2, 4])
def test_lora_tp_view_holds_each_ranks_slices(tp):
    """A rank's flat view unflattens to its B slices of the column-parallel
    targets and A slices of the row-parallel ones (wkv whole where tp does
    not divide the kv heads); the ranks' views cover the adapter."""
    tcfg = T.TransformerConfig(**SHAPE, compute_dtype=torch.float32)
    lcfg = L.LoraConfig(**LCFG)
    tree = convert.lora_from_jax_numpy(_lora(), tcfg, lcfg, device="cpu")
    whole = L.unflatten_lora(L.flatten_lora(tree, tcfg, lcfg), tcfg, lcfg)
    for rank in range(tp):
        mesh = _pmesh(dict(tp=tp), rank)
        flat = L.flatten_lora(tree, tcfg, lcfg, mesh)
        assert flat.numel() == L.lora_flat_len(tcfg, lcfg, mesh)
        views = L.unflatten_lora(flat, tcfg, lcfg, mesh)
        for name, (a, b) in views.items():
            wa, wb = whole[name]
            cut = L._cut_over_tp(tcfg, name, tp)
            if name in ("wq", "wkv", "wi") and cut:
                assert torch.equal(a, wa)
                full = wb.reshape(tree[name]["b"].shape)
                dim = L._TP_CUT[name][1]
                n = full.shape[dim] // tp
                assert torch.equal(b, full.narrow(dim, rank * n, n).reshape(b.shape))
            elif cut:
                assert torch.equal(b, wb)
                full = wa.reshape(tree[name]["a"].shape)
                n = full.shape[1] // tp
                assert torch.equal(a, full.narrow(1, rank * n, n).reshape(a.shape))
            else:
                assert torch.equal(a, wa) and torch.equal(b, wb)
    assert (tp == 4) == (not L._cut_over_tp(tcfg, "wkv", tp))
