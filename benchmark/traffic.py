"""The one traffic generator; every mix is a data file (``traffic/<name>.json``).

Keys of a mix:

- ``requests``: how many requests the trace holds (more than any window serves);
- ``prefixes``: ``[count, length]`` shared system prompts, or null. With
  prefixes each prompt is a prefix drawn uniformly plus a tail of
  ``tail_lens`` (lo, hi inclusive) tokens; without, a prompt of
  ``prompt_lens`` tokens;
- ``max_new``: (lo, hi) inclusive, uniform;
- ``arrival``: ``{"kind": "poisson", "rate_per_tick": r}`` (engine ticks,
  one per model dispatch) or ``{"kind": "backlog"}`` (all at tick 0);
- ``prime_prefixes``: serve each prefix once in set-up, so they are in the
  prefix cache before the first request (the cache adopts a prompt's
  pages only when its request retires);
- ``open_at_tick``: the window opens at the first dispatch once the
  engine's tick clock has reached this value, so it measures a pool that
  has filled as a deployment's has (serving until then is set-up);
- ``trace_stretch``: where a ``--trace 1`` run profiles (``start_frac`` of
  the window, at least ``min_s`` seconds, and with ``until_fresh_prefill``
  until a fresh prompt's first chunk ran in it, at most ``max_s``).

Every run of a mix has the same arrival times and the same lengths: both
are drawn from ``SIZES_SEED``. The run's seed deals the lengths out within
each block of ``DEAL_BLOCK`` consecutive arrivals and draws the token ids,
so seeds change what is served and not how much or when, even over a
window's few tens of requests.

The draws (``draw``) follow ``gpushare_device_plugin_tpu_torch/serving/
engine.py``'s ``shared_prefix_trace`` (with prefixes) and ``poisson_trace``
(without), numpy ``RandomState`` call for call, so the same seed gives their
requests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SIZES_SEED = 20240917  # the arrivals and lengths of every run of a mix
DEAL_BLOCK = 8  # a run's seed deals lengths out within blocks of this many arrivals


@dataclasses.dataclass(frozen=True)
class Req:
    rid: int
    prompt: tuple[int, ...]
    max_new: int
    arrival: float  # engine ticks


def rng_seed(seed: int) -> int:
    """A ``RandomState`` seed from any whole number (it takes 32 bits)."""
    return int(seed) % (2**32)


def _draws(mix: dict, seed: int, vocab: int) -> tuple[list[tuple[int, ...]], list[dict]]:
    """The prefixes and each request's draws, in the generators' order."""
    rng = np.random.RandomState(rng_seed(seed))
    n = int(mix["requests"])
    arrival = mix["arrival"]
    poisson = arrival["kind"] == "poisson"
    if not poisson and arrival["kind"] != "backlog":
        raise ValueError(f"unknown arrival kind {arrival['kind']!r}")
    lo_new, hi_new = mix["max_new"]
    pres: list[tuple[int, ...]] = []
    rows = []
    if mix.get("prefixes"):
        n_pre, pre_len = mix["prefixes"]
        pres = [tuple(int(x) for x in rng.randint(0, vocab, size=pre_len)) for _ in range(n_pre)]
        lo, hi = mix["tail_lens"]
        for _ in range(n):
            gap = float(rng.exponential(1.0 / arrival["rate_per_tick"])) if poisson else 0.0
            pre = int(rng.randint(n_pre))
            tlen = int(rng.randint(lo, hi + 1))
            tail = tuple(int(x) for x in rng.randint(0, vocab, size=tlen))
            mn = int(rng.randint(lo_new, hi_new + 1))
            rows.append({"gap": gap, "pre": pre, "len": tlen, "tokens": tail, "max_new": mn})
    else:
        lo, hi = mix["prompt_lens"]
        for _ in range(n):
            gap = float(rng.exponential(1.0 / arrival["rate_per_tick"])) if poisson else 0.0
            plen = int(rng.randint(lo, hi + 1))
            mn = int(rng.randint(lo_new, hi_new + 1))
            prompt = tuple(int(x) for x in rng.randint(0, vocab, size=plen))
            rows.append({"gap": gap, "pre": None, "len": plen, "tokens": prompt, "max_new": mn})
    return pres, rows


def _trace(pres: list[tuple[int, ...]], rows: list[dict]) -> list[Req]:
    out, t = [], 0.0
    for rid, row in enumerate(rows):
        t += row["gap"]
        prompt = row["tokens"] if row["pre"] is None else pres[row["pre"]] + row["tokens"]
        out.append(Req(rid=rid, prompt=prompt, max_new=row["max_new"], arrival=t))
    return out


def draw(mix: dict, seed: int, vocab: int) -> tuple[list[Req], list[tuple[int, ...]]]:
    """The port's trace functions' requests for ``seed``, and the prefixes."""
    pres, rows = _draws(mix, seed, vocab)
    return _trace(pres, rows), pres


def generate(mix: dict, seed: int, vocab: int) -> tuple[list[Req], list[tuple[int, ...]]]:
    """The trace of ``mix`` for ``seed`` and the shared prefixes (empty
    without prefixes), each prompt's ids drawn below ``vocab``: the
    arrivals and sizes of ``SIZES_SEED``, dealt out in an order of ``seed``,
    with ``seed``'s token ids."""
    pres, rows = _draws(mix, SIZES_SEED, vocab)
    rng = np.random.RandomState(rng_seed(seed))
    order = [lo + int(i) for lo in range(0, len(rows), DEAL_BLOCK)
             for i in rng.permutation(min(DEAL_BLOCK, len(rows) - lo))]
    pres = [tuple(int(x) for x in rng.randint(0, vocab, size=len(p))) for p in pres]
    rows = [dict(rows[i], gap=row["gap"]) for i, row in zip(order, rows)]
    for row in rows:
        row["tokens"] = tuple(int(x) for x in rng.randint(0, vocab, size=row["len"]))
    return _trace(pres, rows), pres
