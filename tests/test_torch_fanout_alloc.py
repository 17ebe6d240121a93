"""The port's fan-out and placement (gpushare_device_plugin_tpu_torch:
``device/fanout.py``, ``allocator/{binpack,env,local}.py``) against the
reference's, on the same inputs: device ids, units, binpack choices and
envs exactly equal.
"""

from __future__ import annotations

import dataclasses

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gpushare_device_plugin_tpu import const as JC
from gpushare_device_plugin_tpu.allocator import binpack as JB
from gpushare_device_plugin_tpu.allocator import env as JE
from gpushare_device_plugin_tpu.allocator.local import LocalAllocator as JLocal
from gpushare_device_plugin_tpu.device import DeviceInventory as JInventory
from gpushare_device_plugin_tpu.discovery import MockBackend as JMock
from gpushare_device_plugin_tpu.discovery.base import ChipHealth as JHealth
from gpushare_device_plugin_tpu.discovery.base import TpuChip as JChip
from gpushare_device_plugin_tpu_torch import const
from gpushare_device_plugin_tpu_torch.allocator import binpack as B
from gpushare_device_plugin_tpu_torch.allocator import env as E
from gpushare_device_plugin_tpu_torch.allocator.local import LocalAllocator
from gpushare_device_plugin_tpu_torch.device import (
    DeviceInventory,
    extract_real_chip_id,
    generate_fake_device_id,
)
from gpushare_device_plugin_tpu_torch.discovery import MockBackend
from gpushare_device_plugin_tpu_torch.discovery.base import ChipHealth, TpuChip

GIB = 1 << 30
POLICIES = ("first-fit", "best-fit", "spread")

chip_specs = st.lists(
    st.tuples(st.integers(0, 96), st.integers(0, GIB - 1), st.booleans()),
    min_size=0, max_size=5,
)


def _pair(specs):
    """The same chips in both packages: (GiB, extra bytes, device file)."""
    port, ref = [], []
    for i, (gib, extra, has_path) in enumerate(specs):
        kw = dict(id=f"GPU-{i:04d}", index=i, device_path=f"/dev/nvidia{i}" if has_path else "",
                  hbm_bytes=gib * GIB + extra)
        port.append(TpuChip(**kw))
        ref.append(JChip(**kw))
    return port, ref


def _devs(devices):
    return [dataclasses.astuple(d) for d in devices]


@settings(max_examples=60, deadline=None)
@given(chip_specs, st.sampled_from(["GiB", "MiB"]), st.data())
def test_inventory_matches_reference(specs, unit, data):
    port_chips, ref_chips = _pair(specs)
    port = DeviceInventory(port_chips, const.MemoryUnit(unit))
    ref = JInventory(ref_chips, JC.MemoryUnit(unit))
    assert port.units_by_index() == ref.units_by_index()
    assert port.total_units() == ref.total_units() and port.chip_count == ref.chip_count
    sick = data.draw(st.sets(st.sampled_from([c.id for c in port_chips]))) if specs else set()
    well = data.draw(st.sets(st.sampled_from([c.id for c in port_chips]))) if specs else set()
    port_health = {**{c: ChipHealth.UNHEALTHY for c in sick}, **{c: ChipHealth.HEALTHY for c in well}}
    ref_health = {c: JHealth(h.value) for c, h in port_health.items()}
    for health, jhealth in ((None, None), (port_health, ref_health)):
        if unit == "GiB":  # MiB fans a card out into tens of thousands of devices
            assert _devs(port.mem_fake_devices(health)) == _devs(ref.mem_fake_devices(jhealth))
        assert _devs(port.core_devices(health)) == _devs(ref.core_devices(jhealth))
    for chip in port_chips:
        assert port.id_of_index(chip.index) == ref.id_of_index(chip.index)
        fake = generate_fake_device_id(chip.id, 3)
        assert extract_real_chip_id(fake) == chip.id == port.chip_by_id(chip.id).id


def test_inventory_refuses_duplicates_as_the_reference_does():
    a = TpuChip(id="GPU-a", index=0, device_path="", hbm_bytes=GIB)
    for chips in ([a, a], [a, dataclasses.replace(a, id="GPU-b")]):
        with pytest.raises(ValueError, match="duplicate chip"):
            DeviceInventory(chips)
        with pytest.raises(ValueError, match="duplicate chip"):
            JInventory([JChip(**{**dataclasses.asdict(c), "health": JHealth.HEALTHY})
                        for c in chips])


@settings(max_examples=300, deadline=None)
@given(
    st.dictionaries(st.integers(0, 7), st.integers(0, 80), max_size=6),
    st.dictionaries(st.integers(-1, 9), st.integers(0, 90), max_size=8),
    st.lists(st.integers(0, 7), max_size=4),
    st.integers(-2, 90),
    st.sampled_from(POLICIES),
)
def test_assign_chip_matches_reference(capacity, used, unhealthy, request, policy):
    assert B.available_units(capacity, used, unhealthy) == JB.available_units(
        capacity, used, unhealthy)
    try:
        want = JB.assign_chip(request, capacity, used, unhealthy, policy)
    except JB.AssignmentError as e:
        with pytest.raises(B.AssignmentError) as got:
            B.assign_chip(request, capacity, used, unhealthy, policy)
        assert str(got.value) == str(e)
    else:
        assert B.assign_chip(request, capacity, used, unhealthy, policy) == want


def test_unknown_policy_raises_in_both():
    for mod in (B, JB):
        with pytest.raises(ValueError, match="unknown binpack policy"):
            mod.assign_chip(1, {0: 4}, {}, policy="worst-fit")


def _alloc_doc(alloc) -> dict:
    return {"envs": alloc.envs, "annotations": alloc.annotations,
            "devices": [dataclasses.astuple(d) for d in alloc.devices]}


@settings(max_examples=80, deadline=None)
@given(
    chip_specs.filter(lambda s: len(s) >= 1),
    st.integers(0, 96), st.integers(0, 96), st.integers(0, 96), st.booleans(),
    st.sampled_from(["", "latency-critical", "best-effort"]),
    st.sampled_from(["", "tenant-a"]),
    st.lists(st.integers(1, 4), min_size=1, max_size=3),
)
def test_envs_match_reference(specs, total, pod, container, isolation_off, wclass, adapter,
                              shape):
    port_chips, ref_chips = _pair(specs)
    common = dict(chip_total_units=total, pod_units=pod, container_units=container,
                  disable_isolation=isolation_off, workload_class=wclass, lora_adapter=adapter)
    assert _alloc_doc(E.build_mem_allocation(chip=port_chips[-1], **common)) == _alloc_doc(
        JE.build_mem_allocation(chip=ref_chips[-1], **common))
    bounds = dict(process_bounds="1,1,1" if isolation_off else "",
                  chips_per_process_bounds="2,1,1" if adapter else "")
    assert _alloc_doc(E.build_core_allocation(chips=port_chips, **bounds)) == _alloc_doc(
        JE.build_core_allocation(chips=ref_chips, **bounds))
    gang = dict(shape=shape, per_chip_units=max(1, total // 2), **common)
    assert _alloc_doc(E.build_gang_allocation(chips=port_chips, **gang)) == _alloc_doc(
        JE.build_gang_allocation(chips=ref_chips, **gang))
    assert E.visible_chips_value([3, 0, 2]) == JE.visible_chips_value([3, 0, 2]) == "0,2,3"


ops = st.lists(st.one_of(
    st.tuples(st.just("allocate"), st.lists(st.integers(0, 40), min_size=1, max_size=3),
              st.sampled_from(["p0", "p1", "p2", None])),
    st.tuples(st.just("release"), st.sampled_from(["p0", "p1", "p2", "nobody"])),
    st.tuples(st.just("hold"), st.lists(st.integers(0, 3), min_size=1, max_size=2)),
    st.tuples(st.just("release_chips"), st.lists(st.integers(0, 3), max_size=2)),
    st.tuples(st.just("health"), st.integers(0, 3), st.booleans()),
), max_size=25)


def _step(alloc, op):
    """One operation; its result, or the exception's type name and text."""
    try:
        if op[0] == "allocate":
            return [_alloc_doc(a) for a in alloc.allocate(op[1], pod_key=op[2])]
        if op[0] == "release":
            return alloc.release(op[1])
        if op[0] == "hold":
            return alloc.hold_chips(op[1])
        if op[0] == "release_chips":
            return alloc.release_chips(op[1])
        return alloc.set_chip_health(op[1], op[2])
    except Exception as e:  # noqa: BLE001 — compared across the packages
        return type(e).__name__, str(e)


@settings(max_examples=80, deadline=None)
@given(ops, st.sampled_from(POLICIES), st.booleans())
def test_local_allocator_sequences_match_reference(sequence, policy, isolation_off):
    port = LocalAllocator(DeviceInventory(MockBackend(num_chips=4, hbm_bytes=32 * GIB).chips()),
                          policy=policy, disable_isolation=isolation_off)
    ref = JLocal(JInventory(JMock(num_chips=4, hbm_bytes=32 * GIB).chips()),
                 policy=policy, disable_isolation=isolation_off)
    for op in sequence:
        assert _step(port, op) == _step(ref, op), op
        assert port.used_by_chip() == ref.used_by_chip()
        assert port.core_held() == ref.core_held()
        assert port.utilization() == ref.utilization()


def test_demo_binpack_1_four_small_pods_land_on_chip_0():
    """The verify skill's demo/binpack-1 case: 4 x 2 GiB on a mock
    4 x 32 GiB host all land on chip 0 (first-fit), out of 128 fake
    devices advertised."""
    inv = DeviceInventory(MockBackend(num_chips=4, hbm_bytes=32 * GIB).chips())
    jinv = JInventory(JMock(num_chips=4, hbm_bytes=32 * GIB).chips())
    assert len(inv.mem_fake_devices()) == len(jinv.mem_fake_devices()) == 128
    port, ref = LocalAllocator(inv), JLocal(jinv)
    for i in range(4):
        got = port.allocate([2], pod_key=f"pod-{i}")
        assert [_alloc_doc(a) for a in got] == [
            _alloc_doc(a) for a in ref.allocate([2], pod_key=f"pod-{i}")]
        assert got[0].envs[const.ENV_TPU_VISIBLE_CHIPS] == "0"
        assert got[0].envs[const.ENV_MEM_DEV] == "32"
    assert port.used_by_chip() == {0: 8} and port.utilization() == 8 / 128
    port.release("pod-0")
    assert port.used_by_chip() == {0: 6}


def test_the_plugins_lock_ranks_fault_points_and_backoff_are_the_references():
    import random

    from gpushare_device_plugin_tpu.utils import faults as JF
    from gpushare_device_plugin_tpu.utils import lockrank as JL
    from gpushare_device_plugin_tpu.utils.retry import Backoff as JBackoff
    from gpushare_device_plugin_tpu_torch.utils import faults, lockrank
    from gpushare_device_plugin_tpu_torch.utils.retry import Backoff

    for name in ("plugin.stream", "manager.health", "allocator.local"):
        assert dataclasses.astuple(lockrank.RANKS[name]) == dataclasses.astuple(JL.RANKS[name])
    for point in ("discovery.probe", "discovery.watch_health", "plugin.allocate"):
        assert point in faults.POINTS and point in JF.POINTS
    port, ref = (Backoff(0.1, 5.0, rng=random.Random(7)),
                 JBackoff(0.1, 5.0, rng=random.Random(7)))
    delays = [(port.next(), ref.next()) for _ in range(70)]
    port.reset()
    ref.reset()
    delays.append((port.next(), ref.next()))
    assert all(a == b for a, b in delays) and max(a for a, _ in delays) <= 5.0
