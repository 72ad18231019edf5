"""The port's specmap schedule against the JAX package's at the paper's
setting: the half of ``test_torch_sync_fullhd.py``'s cases split off so
that the two files take about as long (the plan:
``tests/_torch_sync.full_hd_plan``, two 1920x1080 q95 frames at
chunk_bits 1024). Verification repairs any wrong entry phase, so correct
exits alone cannot show a faulty phase-map prefix; equal round counts
can, and ``test_specmap_entry_phases_at_full_hd_match_repro`` holds the
prefix's own result, before any verification round, against JAX's
``associative_scan``.
"""
import pytest

from repro.core import bitstream as RB
from repro.core import sync as RS
from repro_torch.core import bitstream as TB
from repro_torch.core import decode as D
from repro_torch.core.sync import specmap_sync
from repro_torch.kernels.huffman import ops as HK

from _torch_sync import one_thread  # noqa: F401 (autouse)
from _torch_sync import assert_same_exits, check_full_hd_schedule, \
    full_hd_plan


@pytest.mark.parametrize("sync", ["specmap"])
def test_schedule_at_full_hd_matches_repro(sync):
    check_full_hd_schedule(sync)


def test_specmap_entry_phases_at_full_hd_match_repro():
    """With ``max_verify = max_upm`` no verification round runs, so the
    exits are those the phase-map prefix selects."""
    sh, jdev, tdev = full_hd_plan()
    kw = dict(max_upm=TB.MAX_UPM, max_verify=TB.MAX_UPM,
              permuted=sh.permuted)
    exp = RS.specmap_sync(jdev, s_max=sh.s_max,
                          min_code_bits=sh.min_code_bits, **kw)
    meta = D.chunk_meta(tdev)

    def decode_exits(d, entry, idx=None):
        return HK.decode_exits_plain(d, meta, entry, idx, s_max=sh.s_max,
                                     min_code_bits=sh.min_code_bits)

    got = specmap_sync(tdev, decode_exits=decode_exits, **kw)
    assert TB.MAX_UPM == RB.MAX_UPM
    assert_same_exits(exp, got)
    assert got.rounds == int(exp.rounds) == TB.MAX_UPM
    assert got.converged is bool(exp.converged)
