"""A tiny cell that the harness runs on the CPU: the port's plain paths, a
mock card of 80 GiB, a few seconds of window."""

from __future__ import annotations

import copy
import time

import pytest

from benchmark import harness, manifest

TINY_CONFIG = {
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
    "intermediate_size": 128, "num_hidden_layers": 2, "vocab_size": 256,
    "max_position_embeddings": 512, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
    "serving": {"pod_gib": 16, "precision": {"weights": "int8", "kv_cache": "int8"},
                "max_len": 256, "prefill_chunk": 32, "page_size": 8, "slots": 4},
    "control": {"bits": "int4"},
    # the tiny model's sound runs read 0.0 (no near tie at this size); its
    # int4 control reads above 1
    "check": {"limits": {"max_logit_gap": 0.25}},
}
TINY_TRAFFIC = {
    "requests": 400, "prefixes": [2, 64], "tail_lens": [4, 24], "max_new": [4, 12],
    "arrival": {"kind": "poisson", "rate_per_tick": 0.5}, "prime_prefixes": True, "open_at_tick": 20,
    "trace_stretch": {"start_frac": 0.3, "min_s": 0.3, "max_s": 1.0},
}
MOCK = {"num_chips": 1, "hbm_bytes": 80 * 2**30}
CELL = "mistral7b-int8-pod16.rag"


def tiny_cell(config=None, traffic=None, name=CELL) -> manifest.Cell:
    e2e, layer = manifest.cell_metrics(manifest.load_manifest(), name)
    return manifest.Cell(name, "tiny", "tiny", 1, copy.deepcopy(config or TINY_CONFIG),
                         copy.deepcopy(traffic or TINY_TRAFFIC), e2e, layer)


def run_tiny(cell=None, *, seed=123456789012, seconds=2.0, trace=False, **kw):
    """``harness.run`` of the tiny cell on the CPU: (result, readings)."""
    return harness.run(cell or tiny_cell(), seed, seconds, trace, time.perf_counter(),
                       device="cpu", discovery="mock", discovery_kwargs=MOCK,
                       log=lambda msg: None, **kw)


@pytest.fixture
def card():
    """Skip unless an NVIDIA card is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
