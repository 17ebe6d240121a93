"""The generator against the port's own trace functions, draw for draw."""

from __future__ import annotations

import collections

import pytest

from benchmark import traffic as TR
from gpushare_device_plugin_tpu_torch.serving.engine import poisson_trace, shared_prefix_trace

SHARED = {"requests": 40, "prefixes": [3, 20], "tail_lens": [4, 30], "max_new": [2, 9],
          "arrival": {"kind": "poisson", "rate_per_tick": 0.4}}
PLAIN = {"requests": 40, "prefixes": None, "prompt_lens": [5, 60], "max_new": [3, 11],
         "arrival": {"kind": "poisson", "rate_per_tick": 0.7}}


def _tuples(reqs):
    return [(r.rid, tuple(r.prompt), r.max_new, r.arrival) for r in reqs]


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_shared_prefix_draws_equal_shared_prefix_trace(seed):
    ours, pres = TR.draw(SHARED, seed, vocab=500)
    theirs = shared_prefix_trace(40, seed=seed, rate=0.4, vocab=500, prefixes=(3, 20),
                                 tail_lens=(4, 30), max_new=(2, 9))
    assert _tuples(ours) == _tuples(theirs)
    assert len(pres) == 3 and all(r.prompt[:20] in pres for r in ours)


@pytest.mark.parametrize("seed", [1, 99])
def test_plain_draws_equal_poisson_trace(seed):
    ours, pres = TR.draw(PLAIN, seed, vocab=300)
    theirs = poisson_trace(40, seed=seed, rate=0.7, vocab=300, prompt_lens=(5, 60),
                           max_new=(3, 11))
    assert _tuples(ours) == _tuples(theirs) and pres == []


def test_backlog_arrives_at_tick_zero():
    reqs, _ = TR.generate(dict(PLAIN, arrival={"kind": "backlog"}), 3, vocab=300)
    assert reqs == TR.generate(dict(PLAIN, arrival={"kind": "backlog"}), 3, vocab=300)[0]
    assert {r.arrival for r in reqs} == {0.0}
    assert all(5 <= len(r.prompt) <= 60 and 3 <= r.max_new <= 11 for r in reqs)


def test_sizes_seed_keeps_arrivals_and_sizes_and_changes_order_and_ids():
    mix = SHARED
    a, pa = TR.generate(mix, 11, vocab=500)
    b, pb = TR.generate(mix, 2**31 + 12, vocab=500)  # a seed over 32 signed bits

    def sizes(reqs):
        return collections.Counter((len(r.prompt), r.max_new) for r in reqs)

    assert sizes(a) == sizes(b)
    blk = TR.DEAL_BLOCK
    for lo in range(0, 40, blk):  # each block of arrivals holds the same sizes
        assert sizes(a[lo:lo + blk]) == sizes(b[lo:lo + blk])
    # the sizes and arrivals are those the port's draws give for SIZES_SEED
    port, _ = TR.draw(mix, TR.SIZES_SEED, vocab=500)
    assert sizes(a) == sizes(port)
    assert [r.arrival for r in a] == [r.arrival for r in b] == [r.arrival for r in port]
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    assert pa != pb
    again, _ = TR.generate(mix, 11, vocab=500)
    assert _tuples(again) == _tuples(a)


def test_unknown_arrival_kind_is_refused():
    with pytest.raises(ValueError):
        TR.generate(dict(PLAIN, arrival={"kind": "bursty"}), 0, vocab=10)
