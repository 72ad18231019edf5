"""Resilient decode in the port against the JAX package, on the CPU.

Validation reports and validated plans equal ``repro``'s on every variant
of the deterministic corruption corpus (``tests/_corrupt.py``); mixed,
recovered and all-rejected batches decode to ``repro``'s
``backend="jnp"`` coefficients and status (integer stages bit-identical,
RGB within 1 of ``decode_baseline``); a quarantined batch adds no program;
and ``emit="planes"`` returns ``repro``'s planes with ``rgb=None``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _corrupt as cc
from repro.core import bitstream as RB
from repro.core import decode_batch as repro_decode_batch
from repro.jpeg import codec_ref as cr
from repro.jpeg.format import M_APP0
import repro_torch
from repro_torch.core import api
from repro_torch.core import bitstream as TB
from repro_torch.core.bitstream import (STATUS_OK, STATUS_RECOVERED,
                                        STATUS_REJECTED)

from _torch_corpus import corpus, oracle_coeffs, synth_image

BASES = dict(cc.base_blobs(synth_image))


def _blob(seed=1, restart=2, quality=85, size=(32, 32)):
    return cr.encode_baseline(synth_image(*size, seed=seed), quality=quality,
                              subsampling="4:4:4",
                              restart_interval=restart).jpeg_bytes


def _zero_app0_len(blob):
    """Fatal header damage: APP0 length 0 (below the minimum 2)."""
    bad = bytearray(blob)
    off = dict(cc.marker_map(blob))[M_APP0]
    bad[off + 2: off + 4] = (0).to_bytes(2, "big")
    return bytes(bad)


def _cut_scan(blob, frac=3):
    """Truncate inside the entropy data (keeps all headers)."""
    start, end = cc.scan_span(blob)
    return blob[: start + (end - start) * (frac - 1) // frac]


def _report(r):
    """A report's fields, the parsed image left out (its class differs)."""
    arr = (lambda a: None if a is None else np.asarray(a).tolist())
    return (r.status, r.error, r.error_offset, r.error_marker,
            r.n_segments_expected, r.n_segments_actual, r.seg_ranges,
            arr(r.seg_valid), arr(r.clean), arr(r.rst_bits))


def _same_plan(got, exp):
    ga, ea = got.device_arrays(), exp.device_arrays()
    assert ga.keys() == ea.keys()
    for k in ea:
        np.testing.assert_array_equal(ga[k], ea[k], err_msg=k)
    for k in ("image_status", "seg_valid", "unit_valid"):
        np.testing.assert_array_equal(getattr(got, k), getattr(exp, k),
                                      err_msg=k)
    assert (got.uniform, got.total_units, got.n_segments, got.n_chunks) == \
        (exp.uniform, exp.total_units, exp.n_segments, exp.n_chunks)
    geo = (lambda g: None if g is None else dataclasses.astuple(g))
    assert geo(got.geometry) == geo(exp.geometry)
    for a, b in zip(got.comp_unit_idx or (), exp.comp_unit_idx or ()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("base", sorted(BASES))
def test_validation_and_plan_match_repro_on_the_corpus(base):
    """Every corpus variant: the report, and the validated plan of the
    variant beside its clean base, equal ``repro``'s."""
    blob = BASES[base]
    for vname, bad in cc.corpus(blob, seed=0):
        got, exp = TB.validate_blob(bad), RB.validate_blob(bad)
        assert _report(got) == _report(exp), vname
        batch = [blob, bad]
        tv, rv = TB.validate_batch(batch), RB.validate_batch(batch)
        assert tv.status.tolist() == rv.status.tolist(), vname
        assert tv.errors() == rv.errors(), vname
        assert (tv.n_ok, tv.n_recovered, tv.n_rejected, tv.all_ok) == \
            (rv.n_ok, rv.n_recovered, rv.n_rejected, rv.all_ok)
        _same_plan(TB.build_batch_plan(batch, chunk_bits=256, validation=tv),
                   RB.build_batch_plan(batch, chunk_bits=256, validation=rv))


def test_clean_validated_plan_is_the_plain_plan():
    blobs = [_blob(seed=1), _blob(seed=2)]
    plain = TB.build_batch_plan(blobs, chunk_bits=256)
    val = TB.build_batch_plan(blobs, chunk_bits=256,
                              validation=TB.validate_batch(blobs))
    for k, a in plain.device_arrays().items():
        np.testing.assert_array_equal(val.device_arrays()[k], a, err_msg=k)
    assert val.seg_valid.all() and val.unit_valid.all()
    assert list(val.image_status) == [STATUS_OK, STATUS_OK]


@pytest.mark.parametrize("sync", ["jacobi", "faithful", "sequential"])
def test_mixed_batch_matches_repro(sync):
    """ok, recovered (a cut scan and a flipped bit) and rejected images in
    one batch: status and coefficients equal ``repro``'s, and each valid
    image equals decoding it alone."""
    clean = [_blob(seed=s) for s in (1, 2, 3, 4)]
    blobs = [clean[0], _cut_scan(clean[1]), cc.bit_flips(clean[2], n=1)[0][1],
             _zero_app0_len(clean[3]), clean[2]]
    kw = dict(chunk_bits=256, seq_chunks=4, sync=sync, validate=True)
    got = repro_torch.decode_batch(blobs, emit="rgb", device="cpu", **kw)
    exp = repro_decode_batch(blobs, emit="coeffs", backend="jnp", **kw)
    np.testing.assert_array_equal(got.status, np.asarray(exp.status))
    assert got.status[0] == STATUS_OK and got.status[3] == STATUS_REJECTED
    assert got.status[1] == STATUS_RECOVERED
    np.testing.assert_array_equal(got.coeffs.numpy(), np.asarray(exp.coeffs))
    assert (got.sync_rounds, got.converged) == (int(exp.sync_rounds), True)
    np.testing.assert_array_equal(got.plan.unit_valid, exp.plan.unit_valid)
    n = cr.parse_jpeg(clean[0]).n_units
    coeffs = got.coeffs.numpy()
    for i in (0, 4):
        alone = repro_torch.decode_batch([blobs[i]], chunk_bits=256,
                                         seq_chunks=4, sync=sync,
                                         device="cpu")
        np.testing.assert_array_equal(coeffs[i * n:(i + 1) * n],
                                      alone.coeffs.numpy())
        np.testing.assert_array_equal(got.rgb[i].numpy(),
                                      alone.rgb[0].numpy())
        d = np.abs(got.rgb[i].numpy().astype(int)
                   - cr.decode_baseline(blobs[i]).astype(int))
        assert d.max() <= 1
    # the quarantined lane is inert: zero coefficients, gray pixels
    assert not coeffs[3 * n:4 * n].any()
    assert (got.rgb[3] == 128).all()
    # the recovered image's intact units equal the undamaged stream's
    mask = got.plan.unit_valid[n:2 * n]
    assert 0 < mask.sum() < n
    np.testing.assert_array_equal(coeffs[n:2 * n][mask],
                                  oracle_coeffs([clean[1]])[mask])


def test_all_rejected_batch_degrades_to_coefficients():
    blobs = [b"junk", _zero_app0_len(_blob())]
    got = repro_torch.decode_batch(blobs, chunk_bits=256, validate=True,
                                   device="cpu")
    exp = repro_decode_batch(blobs, chunk_bits=256, validate=True,
                             backend="jnp")
    assert list(got.status) == [STATUS_REJECTED, STATUS_REJECTED]
    np.testing.assert_array_equal(got.status, np.asarray(exp.status))
    assert got.rgb is None and exp.rgb is None
    assert got.coeffs.shape == np.asarray(exp.coeffs).shape


def test_without_validate_a_damaged_batch_raises():
    from repro_torch.jpeg.format import JpegFormatError
    with pytest.raises(JpegFormatError):
        repro_torch.decode_batch([_zero_app0_len(_blob())], chunk_bits=256,
                                 device="cpu")


def test_quarantined_batches_add_no_program():
    """A damaged batch in a steady stream borrows the cached bucket that
    covers it: the cache gains no program and no allocation."""
    api.clear_decode_programs()
    kw = dict(chunk_bits=256, emit="coeffs", validate=True, device="cpu")
    for seeds in ((1, 2), (3, 4), (5, 6)):
        repro_torch.decode_batch([_blob(seed=s) for s in seeds], **kw)
    before = api.decode_program_stats()
    assert (before["programs"], before["allocations"]) == (1, 1)
    clean = [_blob(seed=7), _blob(seed=8)]
    for damage in (_zero_app0_len, _cut_scan):
        out = repro_torch.decode_batch([clean[0], damage(clean[1])], **kw)
        assert int(out.status[1]) != STATUS_OK
        n = cr.parse_jpeg(clean[0]).n_units
        np.testing.assert_array_equal(out.coeffs.numpy()[:n],
                                      oracle_coeffs([clean[0]]))
    after = api.decode_program_stats()
    assert (after["programs"], after["allocations"]) == (1, 1)
    assert after["decodes"] == before["decodes"] + 2


@pytest.mark.parametrize("name", ["420", "gray", "restart"])
def test_emit_planes_matches_repro(name):
    """``emit="planes"`` runs the pixel stage and returns the planes with
    ``rgb=None``: the JAX package's planes within 1, under 1% of the
    samples off by one (its own tolerance)."""
    blobs = corpus(name)
    got = repro_torch.decode_batch(blobs, chunk_bits=256, emit="planes",
                                   device="cpu")
    exp = repro_decode_batch(blobs, chunk_bits=256, emit="planes",
                             backend="jnp")
    assert got.rgb is None and exp.rgb is None
    assert len(got.planes) == len(exp.planes)
    for a, b in zip(got.planes, exp.planes):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == torch.float32
        d = np.abs(a.numpy() - b)
        assert d.max() <= 1 and (d > 0).mean() < 0.01
    np.testing.assert_array_equal(got.coeffs.numpy(), oracle_coeffs(blobs))


@pytest.mark.parametrize("fuse,fused", [("post", True), ("none", False)])
def test_emit_planes_on_the_kernel_path(fuse, fused):
    """Where the fused pixel kernel runs, ``planes`` is None, as in the
    JAX package's ``fuse="post"``; the unfused chain returns them (the
    kernel backend on CPU tensors, where each wrapper is its plain
    version)."""
    blobs = corpus("420")
    dec = api.ParallelDecoder.from_bytes(blobs, chunk_bits=256, device="cpu")
    dec.backend, dec.fuse = "cuda", fuse  # as on a card
    out = dec.decode(emit="planes")
    assert out.rgb is None and out.pixels_fused == fused
    assert (out.planes is None) == fused
