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
JAX's ``associative_scan``.
"""
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import bitstream as RB
from repro.core import sync as RS
from repro.jpeg import codec_ref as cr
from repro_torch.core import bitstream as TB
from repro_torch.core import decode as D
from repro_torch.core.bitstream import dev_from_numpy
from repro_torch.core.sync import specmap_sync
# chip_smoke.py draws its frames with it: these are the frames the card runs
from repro_torch.jpeg.encoder import synth_frame
from repro_torch.kernels.huffman import ops as HK

from test_torch_sync import _jax_sync, _plan, _torch_sync

CHUNK_BITS = 1024


@lru_cache(maxsize=1)
def _shared_plan():
    """One plan of two full-HD frames, as JAX arrays and as the port's."""
    rng = np.random.default_rng(0)  # chip_smoke.py's default --seed
    blobs = [cr.encode_baseline(synth_frame(rng, 1920, 1080, t=0.13 * i),
                                quality=95, subsampling="4:2:0").jpeg_bytes
             for i in range(2)]
    sh, data = _plan(blobs, "jacobi", CHUNK_BITS)
    arrays = dict(data.arrays, words=data.words)
    jdev = {k: jnp.asarray(v) for k, v in arrays.items()}
    return sh, jdev, dev_from_numpy(arrays, "cpu")


def _assert_same_exits(exp, got):
    for f, a, g in zip("puzn", exp.exits, got.exits):
        np.testing.assert_array_equal(np.asarray(a), g.numpy(), err_msg=f)


@pytest.mark.parametrize("sync", ["faithful", "specmap"])
def test_schedule_at_full_hd_matches_repro(sync):
    sh, jdev, tdev = _shared_plan()
    assert sh.n_chunks > 10_000 and not sh.permuted
    exp = _jax_sync(jdev, sh, sync)
    got = _torch_sync(tdev, sh, sync)
    _assert_same_exits(exp, got)
    assert got.rounds == int(exp.rounds)
    assert got.converged is bool(exp.converged) is True


def test_specmap_entry_phases_at_full_hd_match_repro():
    """With ``max_verify = max_upm`` no verification round runs, so the
    exits are those the phase-map prefix selects."""
    sh, jdev, tdev = _shared_plan()
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
    _assert_same_exits(exp, got)
    assert got.rounds == int(exp.rounds) == TB.MAX_UPM
    assert got.converged is bool(exp.converged)
