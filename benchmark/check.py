"""Whether what the window served is right: the served tokens against the
plain reference.

The sample: ``REQUESTS`` of the requests that served tokens in the window,
spread over the slots they were served from (sorted by slot, cut into
``REQUESTS`` runs of equal count, one drawn from each run by the seed), so
every live row block has its turn; of each, its last ``TOKENS_EACH`` served
tokens are judged (all, where it served fewer). The reference
(``reference/decoder.py``, float32, TF32 off, weights drawn again and
quantized as the configuration states) reads each prompt with its served
tokens once. A judged token's gap is how far its reference logit lies below
the reference's best at that position. Two numbers come of it: the widest
gap of the sample (``max_logit_gap``) and the mean over its tokens
(``mean_logit_gap``); a configuration compares those its ``check.limits``
names. A token the program altered, or a step that lost the cache, reads a
gap of the logits' whole spread; bf16 arithmetic, a near tie now and then.

The control (``control_bits``): the same reference in the precision below
the configuration's is put in the program's place. At each judged position
of the same sequences the token it puts first is judged instead of the
served one, under the same names, so the same limits decide it.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import decoder as R
from .traffic import rng_seed

BITS = {"int8": 8, "int4": 4, "bf16": None}
REQUESTS = 8  # requests judged a run
TOKENS_EACH = 32  # the last served tokens judged of each


def sample(outcomes: list, seed: int) -> list:
    """The requests to judge (see the module doc): of ``outcomes``, those
    that served tokens while the window was open."""
    rng = np.random.RandomState(rng_seed(seed) ^ 0x5A5A5A5A)
    served = sorted((o for o in outcomes if len(o.tokens) > o.before),
                    key=lambda o: (o.slot, o.rid))
    if not served:
        return []
    runs = np.array_split(np.arange(len(served)), min(REQUESTS, len(served)))
    return [served[int(rng.choice(run))] for run in runs]


def widest_gaps(m: dict, seed: int, chosen: list, precision: dict, device, *,
                control_bits: int | None = None) -> dict:
    """``max_logit_gap`` and ``mean_logit_gap`` of the judged tokens: the
    served ones, or with ``control_bits`` the control's picks."""
    seqs = [list(o.prompt) + o.tokens[:-1] for o in chosen]
    judged = [min(TOKENS_EACH, len(o.tokens)) for o in chosen]
    pos = [list(range(o.prompt_len - 1 + len(o.tokens) - n, o.prompt_len - 1 + len(o.tokens)))
           for o, n in zip(chosen, judged)]
    wb, kb = BITS[precision["weights"]], BITS[precision["kv_cache"]]
    ref = R.logits_at(m, seed, seqs, pos, weight_bits=wb, kv_bits=kb, device=device)
    def gaps(picks: list[torch.Tensor]) -> torch.Tensor:
        return torch.cat([lg.max(-1).values - lg.gather(1, p[:, None])[:, 0]
                          for lg, p in zip(ref, picks)])

    served = gaps([torch.tensor(o.tokens[-n:], dtype=torch.long, device=lg.device)
                   for lg, o, n in zip(ref, chosen, judged)])
    out = {"judged": "program", "judged_tokens": sum(judged), "requests": len(chosen),
           "slots": sorted({o.slot for o in chosen})}
    if control_bits is not None:
        # the program's own, for the record; the control's are judged
        out["program_max_gap"], out["program_mean_gap"] = (float(served.max()),
                                                           float(served.mean()))
        ctl = R.logits_at(m, seed, seqs, pos, weight_bits=control_bits,
                          kv_bits=control_bits, device=device)
        served = gaps([c.argmax(-1).to(lg.device) for c, lg in zip(ctl, ref)])
        out["judged"] = "control"
    out["max_logit_gap"], out["mean_logit_gap"] = float(served.max()), float(served.mean())
    return out
