"""The port's host planner against the JAX package's, array for array."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.analysis import contracts as RC
from repro.core import bitstream as RB
from repro_torch.core import bitstream as TB
from repro_torch.core import contracts as TC

from _torch_corpus import CORPORA, corpus


def _plans(name, chunk_bits=256):
    blobs = corpus(name)
    return (RB.build_batch_plan(blobs, chunk_bits=chunk_bits),
            TB.build_batch_plan(blobs, chunk_bits=chunk_bits))


def _assert_arrays_equal(exp, got):
    assert exp.keys() == got.keys()
    for k in exp:
        a, b = np.asarray(exp[k]), np.asarray(got[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("name", CORPORA)
@pytest.mark.parametrize("chunk_bits", [256, 1024])
def test_device_arrays_equal(name, chunk_bits):
    ref, got = _plans(name, chunk_bits)
    _assert_arrays_equal(ref.device_arrays(), got.device_arrays())
    for f in ("chunk_bits", "seq_chunks", "s_max", "min_code_bits",
              "n_images", "n_segments", "n_chunks", "total_units", "uniform",
              "n_sequences", "n_real_chunks", "balance", "n_lanes"):
        assert getattr(ref, f) == getattr(got, f), f
    assert (dataclasses.asdict(ref.geometry) if ref.geometry else None) == \
        (dataclasses.asdict(got.geometry) if got.geometry else None)
    np.testing.assert_array_equal(ref.unit_image, got.unit_image)
    np.testing.assert_array_equal(ref.seg_image, got.seg_image)
    if ref.uniform:
        assert ref.comp_grid == got.comp_grid
        for a, b in zip(ref.comp_unit_idx + ref.comp_block_idx,
                        got.comp_unit_idx + got.comp_block_idx):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", CORPORA)
@pytest.mark.parametrize("bucket", [True, False])
def test_plan_shape_and_data_equal(name, bucket):
    ref, got = _plans(name)
    rs, gs = RB.plan_shape(ref, bucket=bucket), TB.plan_shape(got, bucket=bucket)
    assert dataclasses.asdict(rs) == dataclasses.asdict(gs)
    assert rs.block == gs.block
    rd, gd = RB.build_plan_data(ref, rs), TB.build_plan_data(got, gs)
    np.testing.assert_array_equal(rd.words, gd.words)
    assert rd.words.dtype == gd.words.dtype
    _assert_arrays_equal(rd.arrays, gd.arrays)
    for f in ("n_words", "n_segments", "n_chunks", "n_sequences",
              "total_units"):
        assert getattr(rd, f) == getattr(gd, f), f


def test_bucket_capacity_ladder_matches():
    assert [TB.bucket_capacity(n) for n in range(-1, 400)] == \
        [RB.bucket_capacity(n) for n in range(-1, 400)]


@pytest.mark.parametrize("units", [RC.INT32_MAX // 64, RC.INT32_MAX // 64 + 1])
def test_coeff_capacity_guard_matches(units):
    def outcome(fn, exc):
        try:
            fn(units, s_max=0)
            return "ok"
        except exc:
            return "raised"
    assert outcome(TC.checked_coeff_capacity, TC.ContractViolation) == \
        outcome(RC.checked_coeff_capacity, RC.ContractViolation)


def _starts(first):
    out, s = [], 0
    for i, f in enumerate(first):
        s = i if f else s
        out.append(s)
    return np.asarray(out, np.int64)


@pytest.mark.parametrize("name", CORPORA)
@pytest.mark.parametrize("bucket", [True, False])
def test_derived_arrays(name, bucket):
    plan = TB.build_batch_plan(corpus(name), chunk_bits=256)
    arrays = TB.build_plan_data(plan, TB.plan_shape(plan, bucket=bucket)).arrays
    got = TB.derived_arrays(arrays)
    order = arrays["chunk_order"]
    np.testing.assert_array_equal(got["chunk_seg_start"],
                                  _starts(arrays["chunk_first"][order]))
    np.testing.assert_array_equal(got["unit_seg_start"],
                                  _starts(arrays["unit_seg_first"]))
    np.testing.assert_array_equal(got["m_matrices_t"],
                                  arrays["m_matrices"].transpose(0, 2, 1))
    dev = TB.dev_from_numpy(arrays, "cpu")
    assert dev.keys() == arrays.keys() | got.keys()
    assert dev["m_matrices_t"].is_contiguous()


def test_dev_from_numpy_keeps_bits_and_dtypes():
    arrays = {
        "words": np.array([0, 1, 0x80000000, 0xFFFFFFFF], np.uint32),
        "flags": np.array([True, False]),
        "m": np.arange(6, dtype=np.float32).reshape(2, 3),
        "units_end": np.asarray(640, np.int32),
    }
    dev = TB.dev_from_numpy(arrays, "cpu")
    assert dev["words"].dtype == torch.int32
    np.testing.assert_array_equal(dev["words"].numpy().view(np.uint32),
                                  arrays["words"])
    assert dev["flags"].dtype == torch.bool
    assert dev["m"].dtype == torch.float32
    assert dev["units_end"].shape == () and int(dev["units_end"]) == 640
