"""The port end to end on the CPU against the JAX package and the oracle."""
import numpy as np
import pytest
import torch

from repro.core import bitstream as RB
from repro.core import decode_batch as repro_decode_batch
from repro.jpeg import codec_ref as cr
import repro_torch
from repro_torch.core.api import ParallelDecoder, decode_coefficients
from repro_torch.core.bitstream import dev_from_numpy

from _torch_corpus import CORPORA, corpus, oracle_coeffs


@pytest.mark.parametrize("name", CORPORA)
@pytest.mark.parametrize("bucket", [True, False])
def test_decode_batch_matches_repro_and_oracle(name, bucket):
    blobs = corpus(name)
    got = repro_torch.decode_batch(blobs, chunk_bits=256, bucket=bucket,
                                   device="cpu")
    exp = repro_decode_batch(blobs, chunk_bits=256, bucket=bucket,
                             backend="jnp")
    np.testing.assert_array_equal(got.coeffs.numpy(), np.asarray(exp.coeffs))
    np.testing.assert_array_equal(got.coeffs.numpy(), oracle_coeffs(blobs))
    assert got.sync_rounds == int(exp.sync_rounds)
    assert got.converged and bool(exp.converged)
    rgb = got.rgb.numpy().astype(int)
    assert rgb.shape == np.asarray(exp.rgb).shape
    assert np.abs(rgb - np.asarray(exp.rgb).astype(int)).max() <= 1
    base = np.stack([cr.decode_baseline(b) for b in blobs]).astype(int)
    assert np.abs(rgb - base).max() <= 1
    assert not got.store_fused and not got.pixels_fused


@pytest.mark.parametrize("name", ["420", "restart"])
def test_dev_from_numpy_carries_the_reference_plan(name):
    """The JAX package's padded plan, carried across, decodes the same."""
    blobs = corpus(name)
    shape, data = RB.split_plan(RB.build_batch_plan(blobs, chunk_bits=256))
    dev = dev_from_numpy(dict(data.arrays, words=data.words), "cpu")
    coeffs, rounds, converged = decode_coefficients(dev, shape,
                                                    backend="torch",
                                                    fuse="none")
    own = ParallelDecoder.from_bytes(blobs, chunk_bits=256,
                                     device="cpu").coefficients()
    np.testing.assert_array_equal(coeffs[:data.total_units].numpy(),
                                  own.coeffs.numpy())
    assert (rounds, converged) == (own.sync_rounds, own.converged)


def test_default_chunk_bits_and_coeffs_emit():
    blobs = corpus("420")
    dec = ParallelDecoder.from_bytes(blobs, device="cpu")
    assert dec.backend == "torch" and dec.fuse == "none"
    out = dec.decode(emit="coeffs")
    assert out.rgb is None and out.planes is None
    assert out.coeffs.dtype == torch.int32
    np.testing.assert_array_equal(out.coeffs.numpy(), oracle_coeffs(blobs))


def test_mixed_geometry_decodes_coefficients_only():
    blobs = corpus("420") + corpus("444")
    out = repro_torch.decode_batch(blobs, chunk_bits=256, emit="coeffs",
                                   device="cpu")
    np.testing.assert_array_equal(out.coeffs.numpy(), oracle_coeffs(blobs))
    with pytest.raises(NotImplementedError, match="geometry-uniform"):
        repro_torch.decode_batch(blobs, chunk_bits=256, device="cpu")
