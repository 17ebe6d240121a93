"""The port's pod-env reader (gpushare_device_plugin_tpu_torch/parallel/
podenv.py) against the reference's, on the env dicts of the reference's
own tests (tests/test_parallel.py) and a few gang grants.

Exact: the same strings parse to the same record, field for field, and
the memory cap is the reference's XLA_PYTHON_CLIENT_MEM_FRACTION string.
The apply mode runs against a monkeypatched ``torch.cuda``.
"""

import dataclasses
import os

import pytest
import torch

from gpushare_device_plugin_tpu import const as JC
from gpushare_device_plugin_tpu.parallel.podenv import PodTpuEnv as JPod
from gpushare_device_plugin_tpu.parallel.podenv import configure_jax_from_env
from gpushare_device_plugin_tpu.topology import parse_shape as jparse
from gpushare_device_plugin_tpu_torch import const
from gpushare_device_plugin_tpu_torch.parallel import podenv
from gpushare_device_plugin_tpu_torch.parallel.podenv import PodTpuEnv, configure_torch_from_env
from gpushare_device_plugin_tpu_torch.parallel.topology import parse_shape


def injected_env(chips="1", container=8, dev=32, bounds=""):
    """The reference test's helper: what Allocate() injects for a slice."""
    env = {
        const.ENV_TPU_VISIBLE_CHIPS: chips,
        const.ENV_MEM_IDX: chips.split(",")[0] if chips else "-1",
        const.ENV_MEM_CONTAINER: str(container),
        const.ENV_MEM_DEV: str(dev),
    }
    if bounds:
        env[const.ENV_TPU_PROCESS_BOUNDS] = bounds
    return env


def _with(env, **extra):
    return {**env, **{getattr(const, k): v for k, v in extra.items()}}


def _gang(per_chip="4", shape="2x2x1", pod="", container="16"):
    env = {
        const.ENV_TPU_VISIBLE_CHIPS: "0,1,2,3",
        const.ENV_GANG_CHIPS: "0,1,2,3",
        const.ENV_GANG_SHAPE: shape,
        const.ENV_GANG_PER_CHIP: per_chip,
        const.ENV_MEM_CONTAINER: container,
        const.ENV_MEM_DEV: "32",
        const.ENV_TPU_CHIPS_PER_PROCESS_BOUNDS: "2,2,1",
    }
    if pod:
        env[const.ENV_MEM_POD] = pod
    return env


ENVS = {
    "fractional": injected_env(chips="2", container=8, dev=32),
    "explicit_above": _with(injected_env(container=8, dev=32), ENV_XLA_MEM_FRACTION="0.5"),
    "explicit_below": _with(injected_env(container=8, dev=32), ENV_XLA_MEM_FRACTION="0.125"),
    "explicit_garbled": _with(injected_env(), ENV_XLA_MEM_FRACTION="half"),
    "whole_chip": injected_env(container=32, dev=32),
    "whole_host": injected_env(chips="0,1,2,3", container=32, dev=32, bounds="2,2,1"),
    "strings": _with(
        injected_env(), ENV_TPU_PROCESS_BOUNDS="  2,2,1  ", ENV_GANG_SHAPE=" 2x2 ",
        ENV_WORKLOAD_CLASS=f"  {const.WORKLOAD_BEST_EFFORT}  ", ENV_LORA_ADAPTER="  tenant-a  ",
    ),
    "garbled_strings": _with(injected_env(), ENV_WORKLOAD_CLASS="turbo", ENV_LORA_ADAPTER="   "),
    "bad_shape": _with(injected_env(), ENV_GANG_SHAPE="2x0"),
    "too_many_axes": _with(injected_env(), ENV_GANG_SHAPE="2x2x1x1"),
    "gang": _gang(),
    "gang_two_containers": _gang(pod="32", container="16"),
    "gang_explicit": _with(_gang(), ENV_XLA_MEM_FRACTION="0.05"),
    "bare_count_gang": _gang(shape="4"),
    "garbled_ints": {const.ENV_MEM_CONTAINER: "eight", const.ENV_MEM_DEV: "32",
                     const.ENV_TPU_VISIBLE_CHIPS: "0,x,2"},
    "empty": {},
}


def test_env_names_are_the_plugins():
    for name in ("ENV_MEM_IDX", "ENV_MEM_POD", "ENV_MEM_CONTAINER", "ENV_MEM_DEV",
                 "ENV_GANG_CHIPS", "ENV_GANG_SHAPE", "ENV_GANG_PER_CHIP",
                 "ENV_TPU_VISIBLE_CHIPS", "ENV_TPU_PROCESS_BOUNDS",
                 "ENV_TPU_CHIPS_PER_PROCESS_BOUNDS", "ENV_XLA_MEM_FRACTION",
                 "ENV_WORKLOAD_CLASS", "ENV_LORA_ADAPTER", "WORKLOAD_LATENCY_CRITICAL",
                 "WORKLOAD_BEST_EFFORT", "WORKLOAD_CLASSES"):
        assert getattr(const, name) == getattr(JC, name), name
    for unit in ("GiB", "MiB"):
        assert const.MemoryUnit(unit).num_bytes == JC.MemoryUnit(unit).num_bytes


@pytest.mark.parametrize("name", sorted(ENVS))
def test_from_env_matches_reference_field_by_field(name):
    env = ENVS[name]
    got, want = PodTpuEnv.from_env(env), JPod.from_env(env)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("exclusive", "is_gang", "is_best_effort"):
        assert getattr(got, prop) == getattr(want, prop), prop
    for unit in ("GiB", "MiB"):
        u, ju = const.MemoryUnit(unit), JC.MemoryUnit(unit)
        assert got.mem_bytes(u) == want.mem_bytes(ju)
        assert got.gang_per_chip_bytes(u) == want.gang_per_chip_bytes(ju)
        assert got.gang_container_per_chip_bytes(u) == want.gang_container_per_chip_bytes(ju)


def test_from_env_reads_os_environ_without_a_mapping(monkeypatch):
    env = ENVS["strings"]
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    assert PodTpuEnv.from_env() == PodTpuEnv.from_env(env)


@pytest.mark.parametrize("raw", ["2x2x1", "4", " 2X2 ", "1x1x1", "2x0", "2x2x1x1", "", "axb", "-1"])
def test_parse_shape_matches_reference(raw):
    try:
        want = jparse(raw)
    except ValueError:
        with pytest.raises(ValueError, match="invalid gang shape"):
            parse_shape(raw)
    else:
        assert parse_shape(raw) == want


@pytest.mark.parametrize("name", sorted(ENVS))
def test_configure_pure_mode_matches_configure_jax(name, monkeypatch):
    monkeypatch.delenv(const.ENV_CUDA_VISIBLE_DEVICES, raising=False)
    env = ENVS[name]
    got = configure_torch_from_env(env)
    want = configure_jax_from_env(env)
    assert got.get(podenv.MEMORY_FRACTION) == want.get(JC.ENV_XLA_PYTHON_MEM_FRACTION)
    assert got.get(const.ENV_CUDA_VISIBLE_DEVICES) == want.get(JC.ENV_TPU_VISIBLE_CHIPS)
    assert set(got) <= {podenv.MEMORY_FRACTION, const.ENV_CUDA_VISIBLE_DEVICES,
                        const.ENV_CUDA_DEVICE_ORDER}
    assert (const.ENV_CUDA_DEVICE_ORDER in got) == (const.ENV_CUDA_VISIBLE_DEVICES in got)
    assert const.ENV_CUDA_VISIBLE_DEVICES not in os.environ  # pure


def test_configure_pure_mode_values():
    got = configure_torch_from_env(injected_env(container=8, dev=32))
    assert float(got[podenv.MEMORY_FRACTION]) == pytest.approx(0.2375, abs=1e-3)
    assert got[const.ENV_CUDA_VISIBLE_DEVICES] == "1"
    assert podenv.MEMORY_FRACTION not in configure_torch_from_env(ENVS["whole_host"])
    assert configure_torch_from_env(injected_env(container=8, dev=32), headroom=1.0)[
        podenv.MEMORY_FRACTION] == "0.250"


class _FakeCuda:
    """Stands in for the calls configure_torch_from_env makes on torch.cuda."""

    def __init__(self, monkeypatch, *, available=True, initialized=False, count=1):
        self.calls = []
        monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: initialized)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        monkeypatch.setattr(torch.cuda, "set_per_process_memory_fraction",
                            lambda frac, device=None: self.calls.append((frac, device)))


def _inject(monkeypatch, env):
    for key in (const.ENV_TPU_VISIBLE_CHIPS, const.ENV_MEM_IDX, const.ENV_MEM_POD,
                const.ENV_MEM_CONTAINER, const.ENV_MEM_DEV, const.ENV_GANG_CHIPS,
                const.ENV_GANG_SHAPE, const.ENV_GANG_PER_CHIP, const.ENV_XLA_MEM_FRACTION,
                const.ENV_TPU_PROCESS_BOUNDS, const.ENV_TPU_CHIPS_PER_PROCESS_BOUNDS,
                const.ENV_WORKLOAD_CLASS, const.ENV_LORA_ADAPTER,
                const.ENV_CUDA_VISIBLE_DEVICES, const.ENV_CUDA_DEVICE_ORDER):
        monkeypatch.delenv(key, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)


def test_apply_mode_sets_visible_devices_and_caps_once(monkeypatch):
    _inject(monkeypatch, injected_env(chips="2", container=8, dev=32))
    cuda = _FakeCuda(monkeypatch)
    settings = configure_torch_from_env()
    assert os.environ[const.ENV_CUDA_VISIBLE_DEVICES] == "2"
    assert cuda.calls == [(float(settings[podenv.MEMORY_FRACTION]), 0)]
    assert cuda.calls[0][0] == pytest.approx(0.25 * 0.95, abs=1e-3)


def test_granted_index_is_read_in_pci_bus_order(monkeypatch):
    """The plugin numbers cards as NVML does, by PCI bus id; CUDA numbers
    them fastest first unless told otherwise. So wherever the env names
    the visible cards it also fixes the order, in both modes, and a pod
    with no grant is left to CUDA's default."""
    env = injected_env(chips="1,3", container=8, dev=32)
    pure = configure_torch_from_env(env)
    assert pure[const.ENV_CUDA_DEVICE_ORDER] == "PCI_BUS_ID"
    assert pure[const.ENV_CUDA_VISIBLE_DEVICES] == "1,3"
    assert const.ENV_CUDA_DEVICE_ORDER not in configure_torch_from_env(
        {const.ENV_MEM_CONTAINER: "8", const.ENV_MEM_DEV: "32"})
    _inject(monkeypatch, env)
    _FakeCuda(monkeypatch, count=2)
    configure_torch_from_env()
    assert os.environ[const.ENV_CUDA_DEVICE_ORDER] == "PCI_BUS_ID"
    assert os.environ[const.ENV_CUDA_VISIBLE_DEVICES] == "1,3"


def test_apply_mode_exclusive_pod_sets_no_cap(monkeypatch):
    _inject(monkeypatch, injected_env(chips="0", container=32, dev=32))
    cuda = _FakeCuda(monkeypatch, available=False)
    assert podenv.MEMORY_FRACTION not in configure_torch_from_env()
    assert cuda.calls == []


def test_apply_mode_refuses_to_run_uncapped_without_cuda(monkeypatch):
    _inject(monkeypatch, injected_env(container=8, dev=32))
    cuda = _FakeCuda(monkeypatch, available=False)
    with pytest.raises(RuntimeError, match="uncapped"):
        configure_torch_from_env()
    assert cuda.calls == []


def test_apply_mode_refuses_cuda_initialized_under_another_visible_set(monkeypatch):
    _inject(monkeypatch, injected_env(chips="2", container=8, dev=32))
    monkeypatch.setenv(const.ENV_CUDA_VISIBLE_DEVICES, "0")
    cuda = _FakeCuda(monkeypatch, initialized=True)
    with pytest.raises(RuntimeError, match="before the pod's grant"):
        configure_torch_from_env()
    assert cuda.calls == []
    monkeypatch.setenv(const.ENV_CUDA_VISIBLE_DEVICES, "2")  # already the grant: fine
    configure_torch_from_env()
    assert len(cuda.calls) == 1
