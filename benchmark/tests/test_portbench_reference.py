"""The plain reference against tiny hand-made cases, and the port's served
tokens against it at a tiny size."""

from __future__ import annotations

import math
import types

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark.reference import decoder as R

from .conftest import run_tiny


def test_qdq_rounds_half_to_even_per_channel():
    w = torch.tensor([[1.0, -0.5], [0.25, 0.1]])
    got = R.qdq(w, (1,), 8)
    s0, s1 = 1.0 / 127, 0.25 / 127
    # -0.5 / s0 = -63.5 -> -64 (half to even); 0.1 / s1 = 50.8 -> 51
    want = torch.tensor([[127 * s0, -64 * s0], [127 * s1, 51 * s1]])
    assert torch.allclose(got, want, rtol=0, atol=1e-7)
    assert torch.equal(R.qdq(w, (1,), None), w)
    four = R.qdq(torch.tensor([[1.0, -0.25]]), (1,), 4)  # 7 levels a side: -1.75 -> -2
    assert torch.allclose(four[0], torch.tensor([1.0, -2 / 7]), atol=1e-7)


def test_rope_rotates_the_halves():
    x = torch.zeros(2, 1, 4)
    x[:, 0, 0] = 1.0
    out = R.rope(x, 10000.0)
    assert torch.allclose(out[0, 0], torch.tensor([1.0, 0.0, 0.0, 0.0]))
    assert torch.allclose(out[1, 0], torch.tensor([math.cos(1.0), 0.0, math.sin(1.0), 0.0]))


def test_a_hand_made_decoder(monkeypatch):
    """One layer: q = k = 0 (so attention averages the causal prefix), v the
    normed input, wo the identity, no MLP, an identity head."""
    m = {"d": 2, "H": 1, "Hkv": 1, "Dh": 2, "F": 1, "L": 1, "V": 2, "theta": 1e4, "eps": 1e-6}
    embed = torch.tensor([[3.0, 4.0], [1.0, 0.0]])
    layer = {"wq": torch.zeros(2, 1, 2), "wkv": torch.zeros(2, 2, 1, 2),
             "wo": torch.eye(2).reshape(1, 2, 2), "wi": torch.zeros(2, 2, 1),
             "wdown": torch.zeros(1, 2)}
    layer["wkv"][:, 1, 0, :] = torch.eye(2)
    monkeypatch.setattr(R, "draw_embed", lambda m, seed, dev: embed.clone())
    monkeypatch.setattr(R, "draw_layer", lambda m, seed, i, dev: {k: v.clone()
                                                                  for k, v in layer.items()})
    monkeypatch.setattr(R, "draw_out", lambda m, seed, dev: torch.eye(2))
    (got,) = R.logits_at(m, 0, [[0, 1, 1]], [[0, 1, 2]], weight_bits=None, kv_bits=None,
                         device="cpu")
    x = embed[[0, 1, 1]].numpy().astype(np.float64)

    def rms(a):
        return a / np.sqrt((a ** 2).mean(-1, keepdims=True) + 1e-6)

    n = rms(x)
    h = x + np.stack([n[: t + 1].mean(0) for t in range(3)])
    assert np.allclose(got.numpy(), rms(h), atol=1e-5)


def test_the_ports_served_tokens_sit_at_the_references_best():
    doc, readings = run_tiny()
    assert doc["correct"] and readings["judged_tokens"] >= 20
    assert readings["max_logit_gap"] <= doc["checks"]["max_logit_gap"]["limit"]
    # the tiny pod has 4 rows: the sample covers every one that served
    assert readings["slots"] == [0, 1, 2, 3]


def test_the_sample_spreads_over_the_rows_that_served():
    def outcome(rid, slot, n=40):
        return types.SimpleNamespace(rid=rid, slot=slot, tokens=[1] * n, before=0)

    served = [outcome(rid, rid % 64) for rid in range(192)]  # 3 requests a row
    idle = outcome(501, 5, n=7)
    idle.before = 7  # served nothing in the window
    served += [outcome(500, 3, 0), idle]
    for seed in (1, 2**31 + 5):
        chosen = check.sample(served, seed)
        assert len(chosen) == check.REQUESTS
        # one request from each eighth of the rows, by slot
        assert sorted(o.slot // 8 for o in chosen) == list(range(8))
        assert all(o.rid < 192 for o in chosen)
    assert check.sample([outcome(1, 0, 0)], 3) == []


@pytest.mark.parametrize("bits", [8, 4])
def test_kv_quantization_is_per_token_and_head(bits):
    k = torch.randn(5, 3, 8)
    q = R.qdq(k, (-1,), bits)
    qmax = 2 ** (bits - 1) - 1
    scale = k.abs().amax(-1, keepdim=True) / qmax
    assert torch.allclose(q / scale, torch.round(q / scale), atol=1e-4)
