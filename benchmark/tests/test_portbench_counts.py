"""The yardstick's arithmetic: each configuration's bytes against the port's
pool sizing on the CPU, and operation counts against hand-worked cases."""

from __future__ import annotations

import json
import math
from types import SimpleNamespace

import pytest

from benchmark import counts, manifest, serve
from benchmark import weights as W
from gpushare_device_plugin_tpu_torch.parallel.podenv import PodTpuEnv, configure_torch_from_env
from gpushare_device_plugin_tpu_torch.serving.engine import paged_plan_from_pod_env
from gpushare_device_plugin_tpu_torch.serving.pages import paged_plan_for_slice

M = manifest.load_manifest()
CONFIGS = {c["name"]: json.loads((manifest.ROOT / c["file"]).read_text()) for c in M["configs"]}
PAGE = {"mistral7b-int8-pod16": 1_081_344, "deepseek7b-bf16-pod40": 7_864_320}


def _weight_bytes(m: dict, weights: str) -> int:
    """The served tree's bytes from shapes: matrices at their width (int8
    with an f32 scale per output channel, the embedding per row, the head
    per column), norm gains f32."""
    mats = m["L"] * counts.layer_matmul_params(m) + 2 * m["V"] * m["d"]
    norms = (2 * m["L"] + 1) * m["d"] * 4
    if weights == "int8":
        return mats + 4 * (m["L"] * counts.layer_out_channels(m) + 2 * m["V"]) + norms
    return 2 * mats + norms


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_page_bytes_equal_the_ports_plan(name):
    doc = CONFIGS[name]
    m, serving = W.model_dims(doc), doc["serving"]
    kv = serving["precision"]["kv_cache"]
    cfg = serve.model_config(doc)
    plan = paged_plan_for_slice(
        serving["pod_gib"] * 2**30, cfg, serving["max_len"], page_size=serving["page_size"],
        prefill_chunk=serving["prefill_chunk"], weight_bytes=doc["slice"]["weight_bytes"],
        kv_dtype=None if kv == "bf16" else kv, slots=serving["slots"])
    assert counts.page_bytes(m, kv, serving["page_size"]) == plan.page_bytes == PAGE[name]
    assert doc["slice"]["page_bytes"] == PAGE[name]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plan_in_the_config_file_is_the_ports_from_the_plugin_env(name):
    doc = CONFIGS[name]
    serving, sl = doc["serving"], doc["slice"]
    m = W.model_dims(doc)
    assert _weight_bytes(m, serving["precision"]["weights"]) == sl["weight_bytes"]
    envs = serve.plugin_env(serving["pod_gib"], "mock", num_chips=1, hbm_bytes=79 * 2**30)
    for key, val in sl["plugin_env_on_one_h100"].items():
        assert envs[key] == val
    assert float(configure_torch_from_env(envs)["memory_fraction"]) == sl["memory_fraction"]
    kv = serving["precision"]["kv_cache"]
    plan = paged_plan_from_pod_env(
        serve.model_config(doc), serving["max_len"], weight_bytes=sl["weight_bytes"],
        page_size=serving["page_size"], prefill_chunk=serving["prefill_chunk"],
        env=PodTpuEnv.from_env(envs), kv_dtype=None if kv == "bf16" else kv,
        slots=serving["slots"], headroom=serving.get("headroom", 0.90))
    assert (plan.slots, plan.total_pages, plan.kv_bytes) == (
        sl["plan"]["slots"], sl["plan"]["total_pages"], sl["plan"]["kv_bytes"])
    assert sl["weight_bytes"] + plan.pool_bytes == sl["plan"]["planned_bytes"]
    assert sl["plan"]["planned_bytes"] <= sl["plan"]["budget_bytes"] == int(
        serving["pod_gib"] * 2**30 * serving.get("headroom", 0.90))


def test_served_tree_bytes_equal_the_ports_param_bytes():
    """The int8 and bf16 trees the pod serves, at a small size, weigh what
    the byte formula says."""
    from gpushare_device_plugin_tpu_torch.workloads import quant

    doc = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
           "intermediate_size": 96, "num_hidden_layers": 3, "vocab_size": 80,
           "rope_theta": 1e4, "rms_norm_eps": 1e-6}
    m = W.model_dims(doc)
    for prec in ("int8", "bf16"):
        tree = serve.program_weights(m, 5, "cpu", prec)
        assert quant.param_bytes(tree) == _weight_bytes(m, prec)


def test_flops_by_hand():
    m = {"d": 4, "H": 2, "Hkv": 1, "Dh": 2, "F": 6, "L": 3, "V": 10}
    # per layer: wq 4*2*2 + wkv 4*2*1*2 + wo 2*2*4 + wi 4*2*6 + wdown 6*4 = 16+16+16+48+24
    assert counts.layer_matmul_params(m) == 120
    assert counts.linear_flops(m, 5) == 2 * 3 * 120 * 5
    assert counts.head_flops(m, 1) == 80
    # one query over 7 keys: QK^T and PV, 2 heads of 2, 3 layers
    assert counts.attention_flops(m, 7) == 4 * 3 * 2 * 2 * 7
    # a chunk of 3 tokens after 10 cached: keys 11 + 12 + 13 = 36
    assert counts.chunk_flops(m, 10, 3) == 2 * 3 * 120 * 3 + 4 * 3 * 2 * 2 * 36 + 80
    assert counts.decode_flops(m, 9) == 2 * 3 * 120 + 80 + 4 * 3 * 2 * 2 * 9
    # causal 4 tokens: 1 + 2 + 3 + 4 = 10 query-key pairs
    assert counts.causal_attention_flops(m, 4) == 4 * 3 * 2 * 2 * 10
    assert counts.causal_attention_bytes(m, 4) == 3 * 4 * (2 * 2 + 2 * 1) * 2 * 2


def test_bytes_by_hand():
    m = {"d": 4, "H": 2, "Hkv": 1, "Dh": 2, "F": 6, "L": 3, "V": 10}
    assert counts.kv_bytes_per_token(m, "bf16") == 2 * 3 * 1 * 2 * 2
    assert counts.kv_bytes_per_token(m, "int8") == 2 * 3 * 1 * 2 + 2 * 3 * 1 * 4
    # 3 layers x 120 + head 40 values; int8 scales: per layer 4 + 4 + 4 + 12 + 4, head 10
    assert counts.decode_weight_bytes(m, "bf16") == 2 * 400 + 7 * 4 * 4
    assert counts.decode_weight_bytes(m, "int8") == 400 + 4 * (3 * 28 + 10) + 7 * 4 * 4


def test_window_counts_only_its_own_tokens_and_quantile():
    outs = [SimpleNamespace(prompt_len=5, tokens=[1, 2, 3], before=0, arrival_s=1.0),
            SimpleNamespace(prompt_len=2, tokens=[9], before=0, arrival_s=2.0),
            SimpleNamespace(prompt_len=7, tokens=[4, 5, 6, 7], before=2, arrival_s=0.5)]
    w = serve.Window(t_open=1.0, t_close=3.0, outcomes=outs, chunks=[], step_s=[],
                     dispatches=0, drained=True, stretch=None)
    # the third request had 2 tokens at the open: its 3rd and 4th were decoded
    # at positions 9 and 10 (keys 9 and 10)
    assert w.decode_keys() == [6, 7, 9, 10]
    assert w.served() == 3 + 1 + 2 and len(w.arrived()) == 2
    assert counts.ceil_rank([5.0, 1.0, 3.0, 2.0, 4.0], 0.5) == 3.0
    assert counts.ceil_rank(list(range(1, 101)), 0.9) == 90
    assert counts.ceil_rank([], 0.5) is None
    assert math.isclose(counts.ceil_rank([0.25], 0.9), 0.25)
