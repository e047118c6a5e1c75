"""The open-loop arrival schedule: the same work for every seed, in another order."""
from __future__ import annotations

import pytest

from benchmark.core import inputs

MIX = {"min_images": 1, "max_images": 16, "rate_img_per_s": 4000}


def test_every_seed_offers_the_same_work_over_the_window():
    due_a, sizes_a = inputs.schedule(MIX, 10.0, 3)
    due_b, sizes_b = inputs.schedule(MIX, 10.0, 2 ** 31 + 7)
    assert sizes_a != sizes_b and sorted(sizes_a) == sorted(sizes_b)
    # the gaps are drawn once and fill the window whatever their order
    assert due_a[0] == due_b[0] == 0.0 and 9.9 < max(due_a) < 10.0 and 9.9 < max(due_b) < 10.0
    assert len(sizes_a) == round(4000 * 10.0 / 8.5)
    assert sum(sizes_a) / 10.0 == pytest.approx(4000, rel=0.05)
    assert min(sizes_a) == 1 and max(sizes_a) == 16

