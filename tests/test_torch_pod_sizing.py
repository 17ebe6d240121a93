"""Slice sizing from the pod env (gpushare_device_plugin_tpu_torch/serving/
engine.py ``slots_for_gang``, ``slots_from_pod_env``,
``paged_plan_from_pod_env``; serving/pages.py ``paged_plan_for_slice`` with
``n_chips``) against the reference's, on the cases of the reference's own
tests (tests/test_serving_engine.py, tests/test_pages_radix.py) and a
grid around them.

Exact: the same env and config give the same slot count, the same plan
field for field, and the same error text. The Llama-3-8B case is sized
from byte counts alone (meta tensors and ``jax.eval_shape``).
"""

import jax
import pytest
import torch

from gpushare_device_plugin_tpu.const import MemoryUnit as JUnit
from gpushare_device_plugin_tpu.parallel.podenv import PodTpuEnv as JPod
from gpushare_device_plugin_tpu.serving import engine as JE
from gpushare_device_plugin_tpu.serving import pages as JPG
from gpushare_device_plugin_tpu.workloads import quant as JQ
from gpushare_device_plugin_tpu.workloads import transformer as JT
from gpushare_device_plugin_tpu_torch.const import MemoryUnit
from gpushare_device_plugin_tpu_torch.parallel.podenv import PodTpuEnv
from gpushare_device_plugin_tpu_torch.serving import engine as E
from gpushare_device_plugin_tpu_torch.serving import pages as PG
from gpushare_device_plugin_tpu_torch.workloads import quant as Q
from gpushare_device_plugin_tpu_torch.workloads import transformer as T

from torch_parity import configs

SHAPE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_seq=64)


def _cfgs(n_kv_heads=2):
    return configs(**SHAPE, n_kv_heads=n_kv_heads)


def _gang_env(tp, per_chip=8, chip_units=32):
    """The reference test's gang grant (tests/test_serving_engine.py)."""
    return {
        "TPU_VISIBLE_CHIPS": ",".join(str(i) for i in range(tp)),
        "ALIYUN_COM_TPU_GANG_CHIPS": ",".join(str(i) for i in range(tp)),
        "ALIYUN_COM_TPU_GANG_SHAPE": f"{tp}x1x1",
        "ALIYUN_COM_TPU_GANG_PER_CHIP": str(per_chip),
        "ALIYUN_COM_TPU_MEM_CONTAINER": str(per_chip * tp),
        "ALIYUN_COM_TPU_MEM_DEV": str(chip_units),
    }


ENVS = {
    "slice_2_of_16": {"ALIYUN_COM_TPU_MEM_CONTAINER": "2", "ALIYUN_COM_TPU_MEM_DEV": "16"},
    "slice_1_of_16": {"ALIYUN_COM_TPU_MEM_CONTAINER": "1", "ALIYUN_COM_TPU_MEM_DEV": "16"},
    "gang2": _gang_env(2),
    "gang4_1_of_16": _gang_env(4, per_chip=1, chip_units=16),
    "gang4_2_of_16": _gang_env(4, per_chip=2, chip_units=16),
    "gang4_half_container": {
        "ALIYUN_COM_TPU_GANG_CHIPS": "0,1,2,3",
        "ALIYUN_COM_TPU_GANG_SHAPE": "4x1x1",
        "ALIYUN_COM_TPU_GANG_PER_CHIP": "2",
        "ALIYUN_COM_TPU_MEM_POD": "8",
        "ALIYUN_COM_TPU_MEM_CONTAINER": "4",
        "ALIYUN_COM_TPU_MEM_DEV": "16",
    },
}


def _outcome(fn, *args, **kw):
    try:
        out = fn(*args, **kw)
    except ValueError as e:
        return ("ValueError", str(e))
    return ("ok", out.__dict__ if hasattr(out, "__dict__") else out)


def _pair(env):
    return PodTpuEnv.from_env(env), JPod.from_env(env)


@pytest.mark.parametrize("n_kv_heads", [2, 4])
@pytest.mark.parametrize("env_name", sorted(ENVS))
def test_slots_from_pod_env_equals_reference(env_name, n_kv_heads):
    jcfg, tcfg = _cfgs(n_kv_heads)
    pod, jpod = _pair(ENVS[env_name])
    per = E.kv_slot_bytes(tcfg, 32)
    assert per == JE.kv_slot_bytes(jcfg, 32)
    for weights in (0, 1 << 30, 64 * per, 4 << 30, 40 << 30):
        for headroom in (1.0, 0.9):
            for unit in ("GiB", "MiB"):
                kw = dict(weight_bytes=weights, headroom=headroom)
                got = _outcome(E.slots_from_pod_env, tcfg, 32, env=pod, unit=MemoryUnit(unit), **kw)
                want = _outcome(JE.slots_from_pod_env, jcfg, 32, env=jpod, unit=JUnit(unit), **kw)
                assert got == want, (weights, headroom, unit)


def test_slots_from_pod_env_reads_os_environ(monkeypatch):
    _, tcfg = _cfgs()
    for key, val in ENVS["slice_2_of_16"].items():
        monkeypatch.setenv(key, val)
    per = E.kv_slot_bytes(tcfg, 32)
    assert E.slots_from_pod_env(tcfg, 32, weight_bytes=1 << 30, headroom=1.0) == (1 << 30) // per
    with pytest.raises(ValueError, match="aliyun.com/tpu-mem"):
        E.slots_from_pod_env(tcfg, 32, weight_bytes=4 << 30)


@pytest.mark.parametrize("n_kv_heads", [1, 2, 4])
def test_slots_for_gang_equals_reference(n_kv_heads):
    jcfg, tcfg = _cfgs(n_kv_heads)
    per = E.kv_slot_bytes(tcfg, 32)
    for n_chips in (0, 1, 2, 3, 4):
        for per_chip in (0, 10 * per, 1 << 30):
            for weights in (0, 7 * per + 3, 1 << 29):
                for headroom in (0.0, 0.9, 1.0):
                    args = (per_chip, n_chips)
                    kw = dict(weight_bytes=weights, headroom=headroom)
                    got = _outcome(E.slots_for_gang, *args, tcfg, 32, **kw)
                    want = _outcome(JE.slots_for_gang, *args, jcfg, 32, **kw)
                    assert got == want, (n_chips, per_chip, weights, headroom)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("n_kv_heads", [2, 4])
def test_paged_plan_for_slice_per_chip_share_equals_reference(n_kv_heads, kv_dtype):
    jcfg, tcfg = _cfgs(n_kv_heads)
    for n_chips in (1, 2, 3, 4):
        for slice_bytes in (60_000, 400_000, 3_000_000):
            for slots in (None, 3):
                kw = dict(page_size=8, weight_bytes=50_001, prefill_chunk=16,
                          kv_dtype=kv_dtype, slots=slots, n_chips=n_chips)
                want = JPG.paged_plan_for_slice(slice_bytes, jcfg, 64, **kw)
                got = PG.paged_plan_for_slice(slice_bytes, tcfg, 64, **kw)
                assert got.__dict__ == {k: v for k, v in want.__dict__.items()
                                        if k in got.__dict__}, kw
                assert want.draft_bytes == want.adapter_bytes == 0
    kw = dict(page_size=8, weight_bytes=0, n_chips=0)
    assert _outcome(PG.paged_plan_for_slice, 10**6, tcfg, 64, **kw) == _outcome(
        JPG.paged_plan_for_slice, 10**6, jcfg, 64, **kw)


@pytest.mark.parametrize("n_kv_heads", [2, 4])
@pytest.mark.parametrize("env_name", sorted(ENVS))
def test_paged_plan_from_pod_env_equals_reference(env_name, n_kv_heads):
    jcfg, tcfg = _cfgs(n_kv_heads)
    pod, jpod = _pair(ENVS[env_name])
    row_b = E.kv_slot_bytes(tcfg, 64)
    for weights in (row_b, 4 * row_b, 1 << 30, (1 << 20) - 5):
        for unit in ("GiB", "MiB"):
            for headroom in (1.0, 0.9):
                kw = dict(weight_bytes=weights, page_size=8, prefill_chunk=8, headroom=headroom)
                got = _outcome(E.paged_plan_from_pod_env, tcfg, 64, env=pod,
                               unit=MemoryUnit(unit), **kw)
                want = _outcome(JE.paged_plan_from_pod_env, jcfg, 64, env=jpod,
                                unit=JUnit(unit), **kw)
                if want[0] == "ok":
                    want = ("ok", {k: v for k, v in want[1].items() if k in got[1]})
                assert got == want, (weights, unit, headroom)


def test_paged_plan_from_pod_env_reference_cases():
    """The reference's own assertions (tests/test_pages_radix.py): the plan
    holds a max_len row within the budget; a slice the weights fill raises;
    a 4-chip gang buys about 4x the pages of one chip at the same per-chip
    share."""
    _, tcfg = _cfgs()
    row_b = E.kv_slot_bytes(tcfg, 64)
    pod = PodTpuEnv.from_env(ENVS["slice_1_of_16"])
    plan = E.paged_plan_from_pod_env(tcfg, 64, weight_bytes=row_b, page_size=8,
                                     prefill_chunk=8, env=pod)
    assert plan.total_pages >= PG.pages_for(64, 8)
    assert row_b + plan.pool_bytes <= int(pod.mem_bytes(MemoryUnit.GiB) * 0.90)
    with pytest.raises(ValueError, match="cannot hold"):
        E.paged_plan_from_pod_env(tcfg, 64, weight_bytes=pod.mem_bytes(MemoryUnit.MiB),
                                  page_size=8, env=pod, unit=MemoryUnit.MiB)
    _, tcfg = _cfgs(n_kv_heads=4)
    w = 4 * E.kv_slot_bytes(tcfg, 64)
    gang = PodTpuEnv.from_env({**ENVS["gang4_1_of_16"], "ALIYUN_COM_TPU_MEM_CONTAINER": "4"})
    p1 = E.paged_plan_from_pod_env(tcfg, 64, weight_bytes=w, page_size=8, env=pod, headroom=1.0)
    p4 = E.paged_plan_from_pod_env(tcfg, 64, weight_bytes=w, page_size=8, env=gang, headroom=1.0)
    assert p4.total_pages >= 3 * p1.total_pages
    assert -(-w // 4) + p4.pool_bytes <= gang.gang_container_per_chip_bytes()


POD_16_OF_79 = {"ALIYUN_COM_TPU_MEM_CONTAINER": "16", "ALIYUN_COM_TPU_MEM_DEV": "79"}


def _8b_param_bytes():
    """(int8, bf16) parameter bytes of the Llama-3-8B trees in each package,
    counted from shapes: the port's on the meta device, the reference's
    under ``jax.eval_shape``. Nothing 8B-sized is allocated."""

    def meta(shapes, name=None):
        if isinstance(shapes, dict):
            return {k: meta(v, k) for k, v in shapes.items()}
        dtype = torch.float32 if name in ("ln1", "ln2", "final_norm") else torch.bfloat16
        return torch.empty(shapes, dtype=dtype, device="meta")

    bf16 = meta(T.param_shapes(T.llama3_8b()))
    port = (Q.param_bytes(Q.quantize_decoder(bf16)), Q.param_bytes(bf16))
    jcfg = JT.llama3_8b()
    masters = jax.eval_shape(lambda: JT.init_params(jax.random.key(0), jcfg))
    ref = tuple(JQ.param_bytes(jax.eval_shape(fn, masters))
                for fn in (JQ.quantize_decoder, JQ.cast_decoder))
    return port, ref


@pytest.mark.parametrize("weights", ["int8", "bf16"])
def test_8b_sizing_of_a_16_gib_pod_equals_reference(weights):
    """The int8 Llama-3-8B in a 16-GiB slice of a 79-unit card (the chip
    smoke's int8 pod, paged at max_len 2,048, 16-token pages, 512-token
    chunks, int8 KV): the reference's plan, 212 slots over 6,864 pages.
    The bf16 tree is refused by both packages, with the same message
    naming quantization, by the slot pool and the paged plan alike."""
    port, ref = _8b_param_bytes()
    assert port == ref == (8_037_591_040, 16_061_054_976)
    jcfg, tcfg = JT.llama3_8b(), T.llama3_8b()
    pod, jpod = _pair(POD_16_OF_79)
    nbytes = port[0] if weights == "int8" else port[1]
    geo = dict(weight_bytes=nbytes, page_size=16, prefill_chunk=512, kv_dtype="int8")
    got = _outcome(E.paged_plan_from_pod_env, tcfg, 2048, env=pod, **geo)
    want = _outcome(JE.paged_plan_from_pod_env, jcfg, 2048, env=jpod, **geo)
    if want[0] == "ok":
        want = ("ok", {k: v for k, v in want[1].items() if k in got[1]})
    assert got == want
    slots = [_outcome(fn, c, 2048, env=p, weight_bytes=nbytes)
             for fn, c, p in ((E.slots_from_pod_env, tcfg, pod),
                              (JE.slots_from_pod_env, jcfg, jpod))]
    assert slots[0] == slots[1]
    if weights == "int8":
        assert (got[1]["slots"], got[1]["total_pages"]) == (212, 6864)
        assert slots[0][0] == "ok"
    else:
        for outcome in (got, slots[0]):
            assert outcome[0] == "ValueError" and "quantize" in outcome[1]
