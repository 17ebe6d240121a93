"""The controls, at a size a test run holds: the configuration's precision
one step down must come out not correct, and the timed path broken
underneath must too."""

from __future__ import annotations

import pytest
import torch

from gpushare_device_plugin_tpu_torch.serving.engine import PagedSlotEngine
from gpushare_device_plugin_tpu_torch.workloads import generate as G

from .conftest import TINY_CONFIG, TINY_TRAFFIC, run_tiny, tiny_cell


# longer answers, so a fault in the decode step has many steps to show in
LONGER = dict(TINY_TRAFFIC, max_new=[12, 24])


def test_the_int4_reference_in_the_programs_place_is_not_correct():
    """The control's picks go through the same checks as served tokens."""
    sound, ours = run_tiny()
    doc, readings = run_tiny(control=True)
    limit = doc["checks"]["max_logit_gap"]["limit"]
    assert sound["correct"] and ours["max_logit_gap"] <= limit
    assert readings["judged"] == "control" and ours["judged"] == "program"
    assert not doc["correct"] and doc["checks"]["max_logit_gap"]["value"] > 3 * limit


def test_the_programs_own_int8_path_is_the_bf16_configurations_control():
    """A bf16 configuration is compared on its mean gap, as DeepSeek's is. At
    d 512 and 8 layers on the CPU the bf16 program reads 0.00016-0.00082 and
    its own int8 path 0.0019-0.0044 (smaller models do not separate them)."""
    cfg = dict(TINY_CONFIG, hidden_size=512, num_attention_heads=8, num_key_value_heads=8,
               intermediate_size=1024, num_hidden_layers=8, vocab_size=8192,
               control={"bits": "int8"},
               serving=dict(TINY_CONFIG["serving"],
                            precision={"weights": "bf16", "kv_cache": "bf16"}),
               check=dict(TINY_CONFIG["check"], limits={"mean_logit_gap": 0.0013}))
    mix = dict(TINY_TRAFFIC, max_new=[8, 24])
    sound, ours = run_tiny(tiny_cell(cfg, mix), seconds=4.0)
    low, theirs = run_tiny(tiny_cell(cfg, mix), seconds=4.0,
                           precision={"weights": "int8", "kv_cache": "int8"})
    assert sound["correct"] and not low["correct"]
    assert theirs["mean_logit_gap"] > ours["mean_logit_gap"]


def test_a_decode_step_that_keeps_its_state_is_not_correct(monkeypatch):
    step = G.paged_decode_step

    def stale(*args, **kwargs):
        # the step's K and V never reach the pool
        real = G._paged_write
        G._paged_write = lambda *a, **k: None
        try:
            return step(*args, **kwargs)
        finally:
            G._paged_write = real

    monkeypatch.setattr(G, "paged_decode_step", stale)
    doc, readings = run_tiny(tiny_cell(traffic=LONGER))
    assert not doc["correct"]


def test_a_token_altered_where_it_is_produced_is_not_correct(monkeypatch):
    decode = PagedSlotEngine._decode
    calls = [0]

    def altered(self, *args, **kwargs):
        out = decode(self, *args, **kwargs)
        calls[0] += 1
        if calls[0] % 3 == 0:  # every third step, every row's token moves
            out = (out + 1) % self.cfg.vocab
        return out

    monkeypatch.setattr(PagedSlotEngine, "_decode", altered)
    doc, readings = run_tiny(tiny_cell(traffic=LONGER))
    assert not doc["correct"] and readings["max_logit_gap"] > 1.0


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    """One short run of the first cell on the card, through the command."""
    import subprocess
    import sys

    from benchmark import manifest

    name = manifest.load_manifest()["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                          "2147483659", "--seconds", "10", "--trace", "0"],
                         capture_output=True, text=True, cwd=manifest.ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    assert '"correct": true' in out.stdout.strip().splitlines()[-1]
    assert torch.cuda.is_available()
