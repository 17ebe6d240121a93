"""Decision provenance through one admission: the port's against the
reference's.

Every case of the reference's ``tests/test_decisions_smoke.py`` runs on
each package through ``torch_cluster_mirror``: the extender's filter and
bind records, the allocator's record with the same trace id, the
``/decisions`` endpoint and ``inspect why``'s render, the ring's bound
under a verb storm and a rejected bind's "why". The apiserver records, the
envs and what ``inspect why`` printed (trace ids and record clocks by
form) must be equal.
"""

import re
from pathlib import Path

import pytest

from torch_cluster_mirror import cases, mirror_case

NAMES = re.findall(r"^def (test_\w+)",
                   (Path(__file__).parent / "test_decisions_smoke.py").read_text(), re.M)


@pytest.mark.parametrize("name, params", cases("test_decisions_smoke", NAMES))
def test_decisions_smoke_matches_reference(name, params, tmp_path_factory):
    mirror_case("test_decisions_smoke", name, params, tmp_path_factory,
                compare=("servers", "allocations", "output"))


def test_mirror_covers_every_reference_case():
    assert len(NAMES) == 6
