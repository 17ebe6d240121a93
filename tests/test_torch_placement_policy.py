"""Placement policies through the extender: the port's against the
reference's.

Every case of the reference's ``tests/test_placement_policy.py`` (the
registry, the legacy names' scores bit for bit, the multi-objective and
learned policies, each policy placing validly through ``ExtenderCore``,
gang scoring moving with the policy) runs on each package through
``torch_cluster_mirror``, with equal apiserver records.
"""

import re
from pathlib import Path

import pytest

from torch_cluster_mirror import cases, mirror_case

NAMES = re.findall(r"^def (test_\w+)",
                   (Path(__file__).parent / "test_placement_policy.py").read_text(), re.M)


@pytest.mark.parametrize("name, params", cases("test_placement_policy", NAMES))
def test_placement_policy_matches_reference(name, params, tmp_path_factory):
    mirror_case("test_placement_policy", name, params, tmp_path_factory)


def test_mirror_covers_every_reference_case():
    assert len(NAMES) == 11
