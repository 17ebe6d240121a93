"""The port's discovery (gpushare_device_plugin_tpu_torch: ``discovery/``,
``native/nvml.py``) against the reference's ``discovery/``.

- ``MockBackend`` from the same ``TPUSHARE_MOCK_*`` env: equal chips and
  topology.
- ``native/nvml.py`` over a stand-in for ``libnvidia-ml.so.1`` (the same
  entry points, writing through the pointers it is handed): what it reads,
  and that every failing call raises.
- ``NvmlBackend`` over a fake NVML: one chip a card, ordered by PCI bus
  id, the NVML UUID as id, ``/dev/nvidia<minor>``, NVML's total memory;
  cards that share a UUID are refused by the fan-out.
- Health classification: one scripted sequence of polls (device files and
  error counters) through ``NvmlBackend`` and through the reference's
  ``TpuVmBackend`` on a fake sysfs root and ``/dev``; the events must be
  equal, (chip index, health, reason, severity) exactly. A hypothesis
  sweep does the same for random sequences.
- ``CudaBackend.probe()`` is False here; over a stand-in for ``torch``
  its device path is the driver's minor for the card's PCI bus, or none.
- ``pair_with_cuda`` pairs the two backends' cards and names each
  disagreement; ``from_name`` resolves each name.
"""

from __future__ import annotations

import ctypes
import dataclasses
import types
from pathlib import Path

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gpushare_device_plugin_tpu.discovery import MockBackend as JMock
from gpushare_device_plugin_tpu.discovery.tpuvm import TpuVmBackend
from gpushare_device_plugin_tpu_torch import discovery
from gpushare_device_plugin_tpu_torch.discovery import MockBackend, from_name
from gpushare_device_plugin_tpu_torch.discovery import nvmldev
from gpushare_device_plugin_tpu_torch.discovery import cudadev
from gpushare_device_plugin_tpu_torch.discovery.base import ChipHealth, TpuChip
from gpushare_device_plugin_tpu_torch.discovery.cudadev import CudaBackend, nvml_uuid
from gpushare_device_plugin_tpu_torch.discovery.nvmldev import NvmlBackend
from gpushare_device_plugin_tpu_torch.native import nvml
from gpushare_device_plugin_tpu_torch.native.nvml import NvmlDevice, NvmlError

GIB = 1 << 30


def _chip_doc(chip) -> dict:
    doc = dataclasses.asdict(chip)
    doc["health"] = chip.health.value
    return doc


@pytest.mark.parametrize("chips,gib", [(None, None), ("2", "16"), ("0", "8"), ("3", "x")])
def test_mock_backend_matches_reference(monkeypatch, chips, gib):
    for key, val in (("TPUSHARE_MOCK_CHIPS", chips), ("TPUSHARE_MOCK_HBM_GIB", gib)):
        if val is None:
            monkeypatch.delenv(key, raising=False)
        else:
            monkeypatch.setenv(key, val)
    port, ref = MockBackend(), JMock()
    assert [_chip_doc(c) for c in port.chips()] == [_chip_doc(c) for c in ref.chips()]
    assert dataclasses.asdict(port.topology()) == dataclasses.asdict(ref.topology())
    assert port.probe() and ref.probe()
    kw = dict(num_chips=5, hbm_bytes=80 * GIB, generation="h100", host_index=1, num_hosts=2)
    assert ([_chip_doc(c) for c in MockBackend(**kw).chips()]
            == [_chip_doc(c) for c in JMock(**kw).chips()])


# --- native/nvml.py over a stand-in library ----------------------------------


def _fake_lib(cards: list[dict], *, fail: dict | None = None) -> types.SimpleNamespace:
    """The NVML entry points ``native/nvml.py`` calls, as plain functions
    (ctypes sets ``argtypes`` on them as on a CDLL's), over ``cards``
    (NVML's order). ``fail`` maps an entry point to the code it returns."""
    fail = fail or {}
    calls: list[str] = []

    def entry(name, body):
        def fn(*args):
            calls.append(name)
            if name in fail:
                return fail[name]
            body(*args)
            return nvml.NVML_SUCCESS
        return fn

    def card(handle) -> dict:
        return cards[handle.value - 1]

    def count(ptr):
        ptr._obj.value = len(cards)

    def handle(index, ptr):
        ptr._obj.value = index + 1  # a handle is an opaque non-null pointer

    def text(key):
        def fn(h, buf, length):
            buf.value = card(h)[key].encode()[: length - 1]
        return fn

    def minor(h, ptr):
        ptr._obj.value = card(h)["minor"]

    def pci(h, ptr):
        ptr._obj.busId = card(h)["bus"].encode()

    def memory(h, ptr):
        ptr._obj.total = card(h)["total"]
        ptr._obj.free = card(h)["total"] // 2

    def ecc(h, kind, counter, ptr):
        assert counter == nvml.VOLATILE_ECC
        ptr._obj.value = card(h)["ecc"][kind]

    lib = types.SimpleNamespace(
        nvmlInit_v2=entry("nvmlInit_v2", lambda: None),
        nvmlShutdown=entry("nvmlShutdown", lambda: None),
        nvmlDeviceGetCount_v2=entry("nvmlDeviceGetCount_v2", count),
        nvmlDeviceGetHandleByIndex_v2=entry("nvmlDeviceGetHandleByIndex_v2", handle),
        nvmlDeviceGetUUID=entry("nvmlDeviceGetUUID", text("uuid")),
        nvmlDeviceGetName=entry("nvmlDeviceGetName", text("name")),
        nvmlDeviceGetMinorNumber=entry("nvmlDeviceGetMinorNumber", minor),
        nvmlDeviceGetPciInfo_v3=entry("nvmlDeviceGetPciInfo_v3", pci),
        nvmlDeviceGetMemoryInfo=entry("nvmlDeviceGetMemoryInfo", memory),
        nvmlDeviceGetTotalEccErrors=entry("nvmlDeviceGetTotalEccErrors", ecc),
        nvmlErrorString=lambda rc: b"Not Supported" if rc == 3 else b"Unknown Error",
    )
    lib.calls = calls
    return lib


CARDS = [  # NVML's order is not the PCI order here
    dict(uuid="GPU-bbbbbbbb-0000-0000-0000-000000000002", name="NVIDIA H100 80GB HBM3",
         minor=3, bus="00000000:9A:00.0", total=85520809984, ecc=(4, 0)),
    dict(uuid="GPU-aaaaaaaa-0000-0000-0000-000000000001", name="NVIDIA H100 80GB HBM3",
         minor=0, bus="00000000:18:00.0", total=85520809984, ecc=(0, 1)),
]


def test_nvml_reads_every_card_through_ctypes():
    lib = _fake_lib(CARDS)
    handle = nvml.Nvml(lib)
    assert lib.calls == ["nvmlInit_v2"]
    assert lib.nvmlDeviceGetPciInfo_v3.argtypes[1]._type_ is nvml._PciInfo
    assert all(getattr(lib, name).restype is ctypes.c_int for name in nvml._SIGNATURES)
    assert handle.device_count() == 2
    assert handle.devices() == [
        NvmlDevice(index=i, uuid=c["uuid"], name=c["name"], minor=c["minor"],
                   pci_bus_id=c["bus"], memory_total=c["total"])
        for i, c in enumerate(CARDS)
    ]
    assert handle.ecc_errors(0) == (4, 0) and handle.ecc_errors(1) == (0, 1)
    handle.shutdown()
    assert lib.calls[-1] == "nvmlShutdown"


@pytest.mark.parametrize("call", ["nvmlInit_v2", "nvmlDeviceGetCount_v2", "nvmlDeviceGetUUID",
                                  "nvmlDeviceGetPciInfo_v3", "nvmlDeviceGetMemoryInfo"])
def test_every_failing_nvml_call_raises(call):
    lib = _fake_lib(CARDS, fail={call: 999})
    with pytest.raises(NvmlError) as err:
        nvml.Nvml(lib).devices()
    assert err.value.call == call and err.value.code == 999
    assert "Unknown Error" in str(err.value)


def test_ecc_off_raises_not_supported_and_reads_as_no_counters(tmp_path):
    lib = _fake_lib(CARDS, fail={"nvmlDeviceGetTotalEccErrors": nvml.NVML_ERROR_NOT_SUPPORTED})
    handle = nvml.Nvml(lib)
    with pytest.raises(NvmlError) as err:
        handle.ecc_errors(0)
    assert err.value.code == nvml.NVML_ERROR_NOT_SUPPORTED
    backend = NvmlBackend(nvml=handle, dev_root=str(tmp_path))
    assert backend.error_counters() == {c["uuid"]: {} for c in CARDS}


def test_a_hidden_pci_bus_orders_by_nvml_index(tmp_path):
    """A virtualized driver answers NOT_SUPPORTED for PCI info: the cards
    are still listed, in NVML's order. Cards that share a UUID are refused
    by the fan-out, since their ids could not tell them apart."""
    hidden = {"nvmlDeviceGetPciInfo_v3": nvml.NVML_ERROR_NOT_SUPPORTED}
    lib = _fake_lib(CARDS, fail=hidden)
    devices = nvml.Nvml(lib).devices()
    assert [(d.index, d.pci_bus_id, d.minor) for d in devices] == [(0, "", 3), (1, "", 0)]
    backend = NvmlBackend(nvml=nvml.Nvml(lib), dev_root=str(tmp_path))
    assert [(c.id, c.device_path) for c in backend.chips()] == [
        (CARDS[0]["uuid"], str(tmp_path / "nvidia3")),
        (CARDS[1]["uuid"], str(tmp_path / "nvidia0"))]
    twins = [dict(c, uuid=CARDS[0]["uuid"]) for c in CARDS]
    both = NvmlBackend(nvml=nvml.Nvml(_fake_lib(twins, fail=hidden)), dev_root=str(tmp_path))
    assert both.probe()
    from gpushare_device_plugin_tpu_torch.device import DeviceInventory

    with pytest.raises(ValueError, match="duplicate chip id"):
        DeviceInventory(both.chips())


def test_load_raises_without_the_driver_library(tmp_path):
    with pytest.raises(OSError):
        nvml.load(str(tmp_path / "libnvidia-ml.so.1"))
    assert not NvmlBackend(library=str(tmp_path / "libnvidia-ml.so.1")).probe()


# --- NvmlBackend over a fake NVML --------------------------------------------


class FakeNvml:
    """Stands in for ``native.nvml.Nvml``: cards in NVML's order, their
    volatile ECC counts (corrected, uncorrected), and NVML going down."""

    def __init__(self, cards: list[NvmlDevice]):
        self.cards = cards
        self.ecc = {d.uuid: [0, 0] for d in cards}
        self.down = False

    def devices(self) -> list[NvmlDevice]:
        if self.down:
            raise NvmlError("nvmlDeviceGetCount_v2", 999)
        return list(self.cards)

    def ecc_errors(self, index: int) -> tuple[int, int]:
        corrected, uncorrected = self.ecc[self.cards[index].uuid]
        return corrected, uncorrected


def _devices(n: int, minors=None, gib=80) -> list[NvmlDevice]:
    minors = minors or list(range(n))
    # NVML's index order runs against the PCI order: the backend must sort
    return [
        NvmlDevice(index=i, uuid=f"GPU-{i:08x}-1111-2222-3333-444444444444",
                   name="NVIDIA H100 80GB HBM3", minor=minors[i],
                   pci_bus_id=f"00000000:{0x90 - 16 * i:02X}:00.0", memory_total=gib * GIB)
        for i in range(n)
    ]


def test_nvml_backend_chips_ordered_by_pci_bus_id(tmp_path):
    devs = _devices(3, minors=[5, 1, 7])
    backend = NvmlBackend(nvml=FakeNvml(devs), dev_root=str(tmp_path))
    chips = backend.chips()
    by_bus = sorted(devs, key=lambda d: d.pci_bus_id)
    assert [c.id for c in chips] == [d.uuid for d in by_bus]
    assert [c.index for c in chips] == [0, 1, 2]
    assert [c.device_path for c in chips] == [str(tmp_path / f"nvidia{d.minor}") for d in by_bus]
    assert all(c.hbm_bytes == 80 * GIB and c.health == ChipHealth.HEALTHY for c in chips)
    topo = backend.topology()
    assert (topo.generation, topo.chips_per_host, topo.num_hosts, topo.process_bounds) == (
        "NVIDIA H100 80GB HBM3", 3, 1, "")
    assert backend.probe()
    assert not NvmlBackend(nvml=FakeNvml([]), dev_root=str(tmp_path)).probe()


def test_nvml_backend_over_the_ctypes_layer(tmp_path):
    backend = NvmlBackend(nvml=nvml.Nvml(_fake_lib(CARDS)), dev_root=str(tmp_path))
    assert [(c.id, c.index, c.device_path) for c in backend.chips()] == [
        (CARDS[1]["uuid"], 0, str(tmp_path / "nvidia0")),
        (CARDS[0]["uuid"], 1, str(tmp_path / "nvidia3")),
    ]
    assert backend.error_counters() == {
        CARDS[0]["uuid"]: {"corrected": 4, "uncorrected": 0},
        CARDS[1]["uuid"]: {"corrected": 0, "uncorrected": 1},
    }


# --- health classification parity -------------------------------------------


class Rig:
    """Two chips as both backends see them: the reference's ``/dev/accel<i>``
    and sysfs counters, the port's ``/dev/nvidia<i>`` and NVML's ECC
    counts. ``apply(step)`` sets one poll's state on both."""

    def __init__(self, root: Path, n: int = 2):
        self.root, self.n = root, n
        (root / "dev").mkdir(parents=True, exist_ok=True)
        # NVML lists the card at PCI position i as its (n-1-i)th device,
        # whose minor is i: /dev/nvidia<i> is the port's chip i
        self.nvml = FakeNvml(_devices(n, minors=list(reversed(range(n)))))
        self.ref = TpuVmBackend(
            dev_glob=str(root / "dev" / "accel*"),
            env={"TPU_ACCELERATOR_TYPE": "v5e-8"},
            sysfs_root=str(root / "sys"),
            poll_s=0.0,
        )
        self.port = NvmlBackend(nvml=self.nvml, dev_root=str(root / "dev"), poll_s=0.0)
        self.apply({"present": [True] * n, "ecc": [(0, 0)] * n})
        self.ref_ids = {f"tpu-v5e-host0-chip{i}": i for i in range(n)}
        self.port_ids = {c.id: c.index for c in self.port.chips()}

    def apply(self, step: dict) -> None:
        for i in range(self.n):
            for name in (f"accel{i}", f"nvidia{i}"):
                path = self.root / "dev" / name
                if step["present"][i]:
                    path.touch()
                elif path.exists():
                    path.unlink()
            corrected, uncorrected = step["ecc"][i]
            sysfs = self.root / "sys" / "class" / "accel" / f"accel{i}" / "device"
            sysfs.mkdir(parents=True, exist_ok=True)
            (sysfs / "correctable_errors").write_text(f"{corrected}\n")
            (sysfs / "uncorrectable_errors").write_text(f"{uncorrected}\n")
            self.nvml.ecc[self.nvml.cards[self.n - 1 - i].uuid] = [corrected, uncorrected]

    def run(self, backend, ids: dict, steps: list[dict]) -> list[tuple]:
        """Drive one backend through ``steps``, one poll each: its stop()
        is asked once at the top of every poll (``poll_s=0``), so it sets
        that poll's state there."""
        todo = iter(steps)

        def stop() -> bool:
            step = next(todo, None)
            if step is None:
                return True
            self.apply(step)
            return False

        return [(None if e.chip_id is None else ids[e.chip_id], e.health.value, e.reason,
                 e.severity) for e in backend.watch_health(stop)]


def _step(present=(True, True), ecc=((0, 0), (0, 0))) -> dict:
    return {"present": list(present), "ecc": list(ecc)}


def test_health_classification_matches_tpuvm(tmp_path):
    """A device file gone within grace (a blip) and past it (gone, then
    restored), an uncorrected rise and its quiet heal, a corrected rise,
    and both counters at once."""
    steps = [
        _step(),  # first observation: counters baseline
        _step(present=(False, True)),  # chip 0 gone one poll: within grace
        _step(),  # back: a transient blip
        _step(present=(True, False)),
        _step(present=(True, False)),  # chip 1 gone two polls: Unhealthy
        _step(present=(True, False)),
        _step(),  # restored
        _step(ecc=((0, 2), (0, 0))),  # chip 0 uncorrected +2: hard
        *[_step(ecc=((0, 2), (0, 0)))] * 6,  # six quiet polls heal it
        _step(ecc=((0, 2), (3, 0))),  # chip 1 corrected +3: app, health kept
        _step(ecc=((1, 3), (3, 0))),  # chip 0 both: app, then hard
        _step(ecc=((1, 3), (3, 0))),
    ]
    rig = Rig(tmp_path)
    want = rig.run(rig.ref, rig.ref_ids, steps)
    got = rig.run(rig.port, rig.port_ids, steps)
    assert got == want
    assert want == [
        (0, "Healthy", "device-file-blip(1 polls)", "transient"),
        (1, "Unhealthy", "device-file-gone(2 polls)", "hard"),
        (1, "Healthy", "device-file-restored", "hard"),
        (0, "Unhealthy", "uncorrectable-errors+2", "hard"),
        (0, "Healthy", "error-counter-quiet(6 polls)", "hard"),
        (1, "Healthy", "correctable-errors+3", "app"),
        (0, "Healthy", "correctable-errors+1", "app"),
        (0, "Unhealthy", "uncorrectable-errors+1", "hard"),
    ]


@settings(max_examples=25, deadline=None)
@given(st.lists(
    st.tuples(st.lists(st.booleans(), min_size=2, max_size=2),
              st.lists(st.tuples(st.integers(0, 2), st.integers(0, 1)), min_size=2, max_size=2)),
    min_size=1, max_size=14))
def test_health_classification_matches_tpuvm_on_random_polls(polls):
    """Counters only rise (they are cumulative); files come and go."""
    import tempfile

    steps, total = [_step()], [[0, 0], [0, 0]]
    for present, rises in polls:
        for i, (c, u) in enumerate(rises):
            total[i][0] += c
            total[i][1] += u
        steps.append(_step(present=present, ecc=[tuple(t) for t in total]))
    with tempfile.TemporaryDirectory() as tmp:
        rig = Rig(Path(tmp))
        want = rig.run(rig.ref, rig.ref_ids, steps)
        got = rig.run(rig.port, rig.port_ids, steps)
    assert got == want


def test_nvml_going_down_is_a_whole_host_fault(tmp_path):
    rig = Rig(tmp_path)
    steps = [_step(), _step(), _step(), _step()]
    polls = iter([False, True, True, False])

    def step_down(step):
        rig.nvml.down = next(polls)
        Rig.apply(rig, step)

    rig.apply = step_down
    events = rig.run(rig.port, rig.port_ids, steps)
    assert events == [(None, "Unhealthy", "nvml-runtime", "hard"),
                      (None, "Healthy", "nvml-runtime", "hard")]


# --- the CUDA backend and from_name ------------------------------------------


def test_cuda_backend_probe_is_false_without_a_card():
    assert not torch.cuda.is_available()
    assert CudaBackend().probe() is False


class FakeCuda:
    """Stands in for ``torch`` inside ``CudaBackend``: cards as
    ``get_device_properties`` reports them."""

    def __init__(self, props: list):
        self.cuda = types.SimpleNamespace(
            device_count=lambda: len(props),
            get_device_properties=lambda i: props[i],
            get_device_name=lambda i: props[i].name,
        )


def _props(uuid: str, bus: int, gib: int = 79):
    return types.SimpleNamespace(
        uuid=uuid, name="NVIDIA H100 80GB HBM3", total_memory=gib * GIB + 12345,
        pci_domain_id=0, pci_bus_id=bus, pci_device_id=0)


def test_cuda_device_path_is_the_drivers_minor_not_cudas_index(monkeypatch, tmp_path):
    """CUDA's index 0 is the host's /dev/nvidia7 here. A card whose
    driver entry is not readable gets no device path, so the env builder
    mounts nothing rather than another card's file."""
    entry = tmp_path / "0000:db:00.0"
    entry.mkdir()
    (entry / "information").write_text(
        "Model: \t\t NVIDIA H100 80GB HBM3\nBus Location: \t 0000:db:00.0\n"
        "Device Minor: \t 7\nGPU Excluded:\t No\n")
    cards = [_props("GPU-aaaaaaaa-0000-0000-0000-000000000001", 0xDB),
             _props("GPU-bbbbbbbb-0000-0000-0000-000000000002", 0x18)]
    backend = CudaBackend(proc_root=str(tmp_path))
    monkeypatch.setattr(backend, "_torch", lambda: FakeCuda(cards))
    assert [(c.id, c.index, c.device_path, c.hbm_bytes // GIB) for c in backend.chips()] == [
        (cards[0].uuid, 0, "/dev/nvidia7", 79), (cards[1].uuid, 1, "", 79)]
    assert cudadev.pci_bus_id(types.SimpleNamespace(uuid="x")) == ""
    assert cudadev.device_minor(str(tmp_path), "") is None
    (entry / "information").write_text("Device Minor: \t ?\n")
    assert cudadev.device_minor(str(tmp_path), "0000:db:00.0") is None


def _chip(cid: str, index: int = 0, path: str = "/dev/nvidia7", gib: int = 79, extra: int = 0):
    return TpuChip(id=cid, index=index, device_path=path, hbm_bytes=gib * GIB + extra)


def test_pairing_nvml_with_cuda_names_each_disagreement():
    a, b = "GPU-aaaaaaaa-0000-0000-0000-000000000001", "GPU-bbbbbbbb-0000-0000-0000-000000000002"
    nv = [_chip(a, 0, "/dev/nvidia2", extra=503316480), _chip(b, 1, "/dev/nvidia5")]
    # CUDA may see fewer cards, and may not know a device file
    pairs, problems = nvmldev.pair_with_cuda(nv, [_chip(b, 0, "/dev/nvidia5"), _chip(a, 1, "")])
    assert [(n.id, c.id) for n, c in pairs] == [(b, b), (a, a)] and problems == []
    assert nvmldev.pair_with_cuda(nv, [_chip(a, 0, "/dev/nvidia2")]) == ([(nv[0], _chip(
        a, 0, "/dev/nvidia2"))], [])
    _, problems = nvmldev.pair_with_cuda(
        nv, [_chip(a, 0, "/dev/nvidia0"), _chip(b, 1, "/dev/nvidia5", gib=78),
             _chip("GPU-c", 2)])
    assert problems == [
        "CUDA's card 2 (GPU-c) is not one of NVML's",
        f"card {a}: NVML's device file /dev/nvidia2, CUDA's /dev/nvidia0",
        f"card {b}: NVML's 79 GiB, CUDA's 78",
    ]


def test_cuda_uuid_is_formatted_as_nvml_formats_it():
    props = types.SimpleNamespace(uuid="0123abcd-1111-2222-3333-444444444444")
    assert nvml_uuid(props) == "GPU-0123abcd-1111-2222-3333-444444444444"
    assert nvml_uuid(types.SimpleNamespace(uuid="GPU-x")) == "GPU-x"


def test_from_name_resolves_each_backend(monkeypatch, tmp_path):
    assert isinstance(from_name("mock", num_chips=2), MockBackend)
    assert isinstance(from_name("nvml", dev_root=str(tmp_path)), NvmlBackend)
    assert isinstance(from_name("cuda"), CudaBackend)
    with pytest.raises(ValueError, match="unknown discovery backend"):
        from_name("tpuvm")

    def no_driver(path=None):
        raise OSError("libnvidia-ml.so.1: cannot open shared object file")

    monkeypatch.setattr(nvmldev.nvml_lib, "load", no_driver)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    parked = from_name("auto")
    assert isinstance(parked, MockBackend) and parked.chips() == []

    monkeypatch.setattr(nvmldev.nvml_lib, "load", lambda path=None: FakeNvml(_devices(1)))
    picked = from_name("auto")
    assert isinstance(picked, NvmlBackend)
    assert [c.id for c in picked.chips()] == [_devices(1)[0].uuid]
    assert discovery.__all__.count("from_name") == 1
