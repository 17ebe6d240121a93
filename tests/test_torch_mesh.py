"""The port's mesh (gpushare_device_plugin_tpu_torch/parallel/mesh.py) and
the pod env's mesh half (parallel/podenv.py: gang_mesh_spec, gang_mesh,
multihost_spec, initialize_multihost) against the reference's, on the
reference tests' cases (tests/test_parallel.py).

Exact: the same counts factor to the same mesh shape, the same specs
prune alike, the same envs give equal bootstrap specs or equal errors.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from gpushare_device_plugin_tpu import const as JC
from gpushare_device_plugin_tpu.parallel import MeshSpec as JMeshSpec
from gpushare_device_plugin_tpu.parallel import gang_mesh_spec as jgang_mesh_spec
from gpushare_device_plugin_tpu.parallel import make_mesh as jmake_mesh
from gpushare_device_plugin_tpu.parallel import multihost_spec as jmultihost_spec
from gpushare_device_plugin_tpu.parallel.mesh import local_batch_size as jlocal_batch_size
from gpushare_device_plugin_tpu.parallel.mesh import prune_unshardable as jprune
from gpushare_device_plugin_tpu_torch import const
from gpushare_device_plugin_tpu_torch.parallel import podenv
from gpushare_device_plugin_tpu_torch.parallel.mesh import (
    Mesh,
    MeshSpec,
    batch_sharding,
    local_batch_size,
    make_mesh,
    prune_unshardable,
    shard,
)


def _mesh(rank=0, **spec):
    """One rank's mesh of ``spec``, without a process group (pure tests)."""
    return Mesh(MeshSpec(**spec), rank=rank, device=torch.device("cpu"), backend="gloo",
                groups={}, ranks={})


def _fields(spec):
    return (spec.dp, spec.fsdp, spec.tp, spec.sp)


@pytest.mark.parametrize("want_sp", [False, True])
@pytest.mark.parametrize("max_tp", [1, 2, 4, 8])
def test_mesh_spec_auto_factors_like_reference(max_tp, want_sp):
    for n in range(1, 65):
        got = MeshSpec.auto(n, max_tp=max_tp, want_sp=want_sp)
        want = JMeshSpec.auto(n, max_tp=max_tp, want_sp=want_sp)
        assert _fields(got) == _fields(want), n
        assert got.size == want.size == n
    assert MeshSpec().axis_names == JMeshSpec().axis_names


def test_prune_unshardable_like_reference():
    jmesh = jmake_mesh(JMeshSpec(dp=1, fsdp=2, tp=4))
    specs = {"kernel": P("fsdp", "tp"), "bias": P("tp"), "big": P(("dp", "fsdp"), "tp"),
             "short": P("fsdp", "tp", "tp")}
    shapes = {"kernel": (16, 10), "bias": (10,), "big": (8, 8), "short": (4, 4)}
    abstract = {k: jax.ShapeDtypeStruct(v, jnp.float32) for k, v in shapes.items()}
    want = jprune(specs, abstract, jmesh)
    got = prune_unshardable({k: tuple(v) for k, v in specs.items()}, shapes,
                            _mesh(fsdp=2, tp=4))
    assert got == {k: tuple(v) for k, v in want.items()}
    assert got["kernel"] == ("fsdp", None) and got["big"] == (("dp", "fsdp"), "tp")


@pytest.mark.parametrize("batch", [16, 8, 6, 4])
def test_local_batch_size_like_reference(batch):
    jmesh = jmake_mesh(JMeshSpec(dp=2, fsdp=2, tp=2))
    mesh = _mesh(dp=2, fsdp=2, tp=2)
    if batch % 4:
        with pytest.raises(ValueError, match="not divisible"):
            jlocal_batch_size(batch, jmesh)
        with pytest.raises(ValueError, match="not divisible"):
            local_batch_size(batch, mesh)
    else:
        assert local_batch_size(batch, mesh) == jlocal_batch_size(batch, jmesh)


def test_batch_sharding_cuts_the_reference_tiles():
    """Rank r sits where device r sits in the reference's mesh: its tile
    is the one the reference's batch sharding puts on that device."""
    spec = dict(dp=2, fsdp=1, tp=2, sp=2)
    tokens = torch.arange(4 * 8).reshape(4, 8)
    jmesh = jmake_mesh(JMeshSpec(**spec))
    from gpushare_device_plugin_tpu.parallel.mesh import batch_sharding as jbatch_sharding

    placed = jax.device_put(jnp.asarray(tokens.numpy()),
                            jbatch_sharding(jmesh, seq_parallel=True))
    by_device = {s.device: s.data for s in placed.addressable_shards}
    for rank, dev in enumerate(jmesh.devices.reshape(-1)):
        got = batch_sharding(tokens, _mesh(rank=rank, **spec), seq_parallel=True)
        assert got.tolist() == by_device[dev].tolist()
        assert shard(tokens, _mesh(rank=rank, **spec), (("dp",), None)).shape == (2, 8)


def test_make_mesh_world_of_one_and_size_mismatch():
    assert not dist.is_initialized()
    mesh = make_mesh(MeshSpec(), device="cpu")
    assert mesh.shape == {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1}
    assert mesh.backend == "gloo" and mesh.device == torch.device("cpu")
    assert mesh.axis_index("sp") == 0 and mesh.group("sp") is None
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        make_mesh(MeshSpec(dp=2), device="cpu")
    with pytest.raises(ValueError):
        jmake_mesh(JMeshSpec(dp=3), devices=jax.devices()[:2])


MULTIHOST_ENVS = {
    "explicit": {"COORDINATOR_ADDRESS": "llama3-fsdp-0.llama3-fsdp:8476",
                 "NUM_PROCESSES": "4", "PROCESS_ID": "3"},
    "ordinal": {"COORDINATOR_ADDRESS": "llama3-fsdp-0.llama3-fsdp:8476",
                "NUM_PROCESSES": "4", "HOSTNAME": "llama3-fsdp-2"},
    "single_host": {},
    "no_process_id": {"COORDINATOR_ADDRESS": "c:1234", "NUM_PROCESSES": "2",
                      "HOSTNAME": "worker"},
    "out_of_range": {"COORDINATOR_ADDRESS": "c:1234", "NUM_PROCESSES": "2",
                     "PROCESS_ID": "2"},
    "garbled_count": {"COORDINATOR_ADDRESS": "c:1234", "NUM_PROCESSES": "two",
                      "PROCESS_ID": "0"},
}


def _env(case, names):
    out = {}
    for k, v in MULTIHOST_ENVS[case].items():
        out[k if k == "HOSTNAME" else getattr(names, f"ENV_{k}")] = v
    return out


@pytest.mark.parametrize("case", list(MULTIHOST_ENVS))
def test_multihost_spec_like_reference(case):
    assert _env(case, const) == _env(case, JC)
    try:
        want = jmultihost_spec(_env(case, JC))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            podenv.multihost_spec(_env(case, const))
        assert str(got.value) == str(e)
        return
    got = podenv.multihost_spec(_env(case, const))
    assert (got.coordinator_address, got.num_processes, got.process_id, got.is_multihost) == (
        want.coordinator_address, want.num_processes, want.process_id, want.is_multihost)


def test_initialize_multihost_single_host_is_a_no_op():
    assert podenv.initialize_multihost({}, backend="gloo") == podenv.multihost_spec({})
    assert not dist.is_initialized()


def test_initialize_multihost_calls_init_process_group(monkeypatch):
    calls = {}
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.update(kw))
    podenv.initialize_multihost(_env("explicit", const), backend="gloo", timeout_s=20)
    assert calls["backend"] == "gloo"
    assert calls["init_method"] == "tcp://llama3-fsdp-0.llama3-fsdp:8476"
    assert (calls["world_size"], calls["rank"]) == (4, 3)
    assert calls["timeout"].total_seconds() == 20


GANG_ENVS = {
    "gang_of_4": {"ENV_GANG_CHIPS": "0,1,2,3", "ENV_GANG_SHAPE": "2x2x1"},
    "gang_of_2": {"ENV_GANG_CHIPS": "4,5", "ENV_GANG_SHAPE": "2"},
    "single_chip": {"ENV_GANG_CHIPS": "3"},
    "no_gang": {},
}


@pytest.mark.parametrize("case", list(GANG_ENVS))
def test_gang_mesh_spec_like_reference(case):
    want = jgang_mesh_spec(env={getattr(JC, k): v for k, v in GANG_ENVS[case].items()})
    got = podenv.gang_mesh_spec(env={getattr(const, k): v for k, v in GANG_ENVS[case].items()})
    assert (got is None) == (want is None)
    if want is not None:
        assert _fields(got) == _fields(want)


def test_gang_mesh_raises_when_the_world_is_not_the_gang():
    """A world of one process against a gang of four: the reference's
    device-count check, on the world size."""
    env = {getattr(const, k): v for k, v in GANG_ENVS["gang_of_4"].items()}
    with pytest.raises(ValueError, match="gang grant spans 4 chips but the process group has 1"):
        podenv.gang_mesh(env=env, device="cpu")
    assert podenv.gang_mesh(env={}, device="cpu") is None
    one = {getattr(const, k): v for k, v in GANG_ENVS["single_chip"].items()}
    assert podenv.gang_mesh(env=one, device="cpu") is None
