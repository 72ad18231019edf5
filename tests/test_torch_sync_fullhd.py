"""The port's sync schedules against the JAX package's at the paper's setting.

The small corpora of ``test_torch_sync.py`` have chains of a few chunks.
Here the first two frames of ``chip_smoke.py``'s full-width batch
(1920x1080, q95, 4:2:0, the paper's ``newyork`` setting) go through one
shared plan at chunk_bits 1024, about 15,000 lanes, and the port's
faithful and specmap schedules must give ``repro``'s exits,
``sync_rounds`` and ``converged`` bit for bit (jacobi's full-width
rounds are held against the plain path on the card by
``chip_smoke.py``). Verification repairs any wrong entry phase, so
correct exits alone cannot show a faulty phase-map prefix; equal round
counts can, and ``test_specmap_entry_phases_at_full_hd_match_repro``
holds the prefix's own result, before any verification round, against
JAX's ``associative_scan``. Faithful's case is here; specmap's two are
in ``test_torch_sync_fullhd_specmap.py`` (the two halves take about as
long); the plan is ``tests/_torch_sync.full_hd_plan``.
"""
import pytest

from _torch_sync import one_thread  # noqa: F401 (autouse)
from _torch_sync import check_full_hd_schedule


@pytest.mark.parametrize("sync", ["faithful"])
def test_schedule_at_full_hd_matches_repro(sync):
    check_full_hd_schedule(sync)
