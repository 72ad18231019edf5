"""The unfused pixel chain: IDCT, plane assembly, color, and grayscale.

The plain versions of the IDCT kernel (``kernels/idct``) and of the color
kernel (``kernels/color``) against the JAX package's Pallas kernels in
interpret mode and their ``jnp`` references on the same seeded inputs,
within 1 and with under 1% of the samples off by one (the JAX package's
own tolerance: a sample whose f32 value lands within rounding of a half
may round either way under another summation order). Then
``decode_batch(fuse="none")`` and grayscale batches end to end against
``decode_baseline``, and the dispatch of the kernel backend's pixel stage
(run here on CPU tensors, where every wrapper takes its plain version).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitstream as RB
from repro.kernels.color.color import upsample_color as pallas_color
from repro.kernels.color.ref import upsample_color_ref
from repro.kernels.idct.idct import fused_idct
from repro.kernels.idct.ref import fused_idct_ref
from repro.jpeg import codec_ref as cr
import repro_torch
from repro_torch.core import decode as D
from repro_torch.core.api import ParallelDecoder
from repro_torch.core.bitstream import dev_from_numpy
from repro_torch.kernels.color import ops as CK
from repro_torch.kernels.idct import ops as IK

from _torch_corpus import CORPORA, RGB_CORPORA, corpus, oracle_coeffs

#: the largest share of samples off by one that the tests accept
OFF_BY_ONE_SHARE = 0.01


def _within_one(got: np.ndarray, exp: np.ndarray) -> None:
    """Assert |got - exp| <= 1 with under 1% of the samples off by one."""
    d = np.abs(got.astype(np.int64) - exp.astype(np.int64))
    assert d.max() <= 1
    assert (d > 0).mean() < OFF_BY_ONE_SHARE


def _idct_inputs(name):
    blobs = corpus(name)
    plan = RB.build_batch_plan(blobs, chunk_bits=256)
    arrays = plan.device_arrays()
    coeffs = oracle_coeffs(blobs).astype(np.int32)
    return coeffs, arrays["m_matrices"], arrays["unit_mrow"], arrays


@pytest.mark.parametrize("name", CORPORA)
def test_idct_plain_within_one_of_pallas_and_reference(name):
    coeffs, m, mrow, arrays = _idct_inputs(name)
    tdev = dev_from_numpy(arrays, "cpu")
    got = IK.idct_units_plain(torch.from_numpy(coeffs), tdev["m_matrices_t"],
                              tdev["unit_mrow"]).numpy()
    assert got.dtype == np.float32 and got.shape == coeffs.shape
    pallas = np.asarray(fused_idct(jnp.asarray(coeffs), jnp.asarray(m),
                                   jnp.asarray(mrow), interpret=True))
    ref = np.asarray(fused_idct_ref(jnp.asarray(coeffs), jnp.asarray(m),
                                    jnp.asarray(mrow)))
    for exp in (pallas, ref):
        _within_one(got, exp)
    # on a CPU tensor the wrapper is the plain version, and launches nothing
    before = IK.idct_units.launches
    same = IK.idct_units(torch.from_numpy(coeffs), tdev["m_matrices_t"],
                         tdev["unit_mrow"])
    assert IK.idct_units.launches == before
    np.testing.assert_array_equal(same.numpy(), got)


def test_idct_plain_on_random_coefficients():
    """Wide random coefficients over several matrices: the rounding share
    stays under 1%, and the plain version is the folded product."""
    rng = np.random.default_rng(7)
    u, nq = 512, 3
    coeffs = rng.integers(-300, 300, (u, 64)).astype(np.int32)
    coeffs[:, 20:] //= 16  # high frequencies small, as in real images
    m = rng.normal(0, 0.05, (nq, 64, 64)).astype(np.float32)
    mrow = rng.integers(0, nq, u).astype(np.int32)
    m_t = torch.from_numpy(np.ascontiguousarray(m.transpose(0, 2, 1)))
    got = IK.idct_units_plain(torch.from_numpy(coeffs), m_t,
                              torch.from_numpy(mrow)).numpy()
    exp = D.idct_units_folded(torch.from_numpy(coeffs), torch.from_numpy(m),
                              torch.from_numpy(mrow)).numpy()
    np.testing.assert_array_equal(got, exp)
    pallas = np.asarray(fused_idct(jnp.asarray(coeffs), jnp.asarray(m),
                                   jnp.asarray(mrow), interpret=True))
    _within_one(got, pallas)


@pytest.mark.parametrize("fh,fv", [(1, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("shape", [(1, 16, 256), (2, 24, 300), (1, 8, 64)])
def test_color_plain_within_one_of_pallas(fh, fv, shape):
    """JAX's own grid (``tests/test_kernels.py::TestColorKernel``): luma at
    full resolution, both chroma planes subsampled by (fh, fv)."""
    rng = np.random.default_rng(0)
    b, h, w = shape
    h = -(-h // (8 * fv)) * (8 * fv)
    w = -(-w // (8 * fh)) * (8 * fh)
    y = rng.uniform(0, 255, (b, h, w)).astype(np.float32)
    cb = rng.uniform(0, 255, (b, h // fv, w // fh)).astype(np.float32)
    cr_ = rng.uniform(0, 255, (b, h // fv, w // fh)).astype(np.float32)
    got = CK.upsample_color_plain(
        [torch.from_numpy(a) for a in (y, cb, cr_)], comp_h=(fh, 1, 1),
        comp_v=(fv, 1, 1), h_max=fh, v_max=fv, height=h, width=w).numpy()
    assert got.dtype == np.uint8 and got.shape == (b, h, w, 3)
    js = [jnp.asarray(a) for a in (y, cb, cr_)]
    _within_one(got, np.asarray(pallas_color(*js, fh=fh, fv=fv,
                                             interpret=True)))
    _within_one(got, np.asarray(upsample_color_ref(*js, fh, fv)))


def test_color_covers_every_component_layout():
    """Per-component factors: a layout the JAX kernel's (fh, fv) cannot
    express (chroma subsampled differently per plane) is the plain
    upsample, and planes that do not cover the image are refused."""
    rng = np.random.default_rng(1)
    y = torch.from_numpy(rng.uniform(0, 255, (2, 16, 32)).astype(np.float32))
    cb = torch.from_numpy(rng.uniform(0, 255, (2, 8, 16)).astype(np.float32))
    cr_ = torch.from_numpy(rng.uniform(0, 255, (2, 16, 16))
                           .astype(np.float32))
    geo = dict(comp_h=(2, 1, 1), comp_v=(2, 1, 2), h_max=2, v_max=2,
               height=15, width=30)
    got = CK.upsample_color_plain([y, cb, cr_], **geo)
    full_cb = cb.repeat_interleave(2, 1).repeat_interleave(2, 2)
    full_cr = cr_.repeat_interleave(2, 2)
    exp = D.ycbcr_to_rgb(y, full_cb, full_cr)[:, :15, :30]
    assert torch.equal(got, exp)
    assert torch.equal(CK.upsample_color([y, cb, cr_], **geo), got)
    with pytest.raises(ValueError, match="cover"):
        CK.upsample_color_plain([y, cb[:, :4], cr_], **geo)
    with pytest.raises(ValueError, match="three planes"):
        CK.upsample_color_plain([y, cb], **geo)


@pytest.mark.parametrize("name", CORPORA)
def test_fuse_none_end_to_end_within_one_of_baseline(name):
    blobs = corpus(name)
    out = repro_torch.decode_batch(blobs, chunk_bits=256, fuse="none",
                                   device="cpu")
    np.testing.assert_array_equal(out.coeffs.numpy(), oracle_coeffs(blobs))
    base = np.stack([cr.decode_baseline(b) for b in blobs])
    assert out.rgb.shape == base.shape
    _within_one(out.rgb.numpy(), base)
    assert len(out.planes) == (1 if name == "gray" else 3)


@pytest.mark.parametrize("fuse", ["none", "post", "full"])
@pytest.mark.parametrize("name", ["420", "444", "gray"])
def test_kernel_backend_pixel_dispatch(name, fuse):
    """What the kernel backend runs for each fuse mode and layout: the
    fused pixel kernel for three components under "post"/"full", else
    the IDCT kernel, plane assembly and (three planes) the color kernel.
    On CPU tensors each wrapper takes its plain version, so the result
    equals the plain backend's exactly."""
    blobs = corpus(name)
    plain = ParallelDecoder.from_bytes(blobs, chunk_bits=256,
                                       device="cpu").decode()
    dec = ParallelDecoder.from_bytes(blobs, chunk_bits=256, device="cpu")
    dec.backend, dec.fuse = "cuda", fuse  # as on a card
    out = dec.decode()
    gray = name == "gray"
    fused = fuse != "none" and not gray
    assert out.pixels_fused == fused
    assert out.idct_kernel == (not fused)
    assert out.color_kernel == (not fused and not gray)
    assert out.store_fused == (fuse == "full")
    assert (out.planes is None) == fused
    assert torch.equal(out.coeffs, plain.coeffs)
    # the fused kernel's plain version sums in the same order as well
    assert torch.equal(out.rgb, plain.rgb)
    for a, b in zip(out.planes or (), plain.planes):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", RGB_CORPORA)
def test_plain_pixel_chain_is_the_unfused_chain(name):
    """The plain backend's RGB is IDCT + assembly + color of the plain
    versions, which the kernels are held against on the card."""
    blobs = corpus(name)
    dec = ParallelDecoder.from_bytes(blobs, chunk_bits=256, device="cpu")
    out = dec.decode()
    g, dev = dec.plan.geometry, dec.dev
    pix = IK.idct_units_plain(out.coeffs, dev["m_matrices_t"],
                              dev["unit_mrow"][:dec.plan.total_units])
    grid = [(g.mcus_y * v, g.mcus_x * h) for h, v in zip(g.comp_h, g.comp_v)]
    planes = D.assemble_planes(pix, dec.plan.n_images, dec._comp_unit_idx,
                               dec._comp_block_idx, grid)
    rgb = CK.upsample_color_plain(planes, g.comp_h, g.comp_v, g.h_max,
                                  g.v_max, g.height, g.width)
    assert torch.equal(rgb, out.rgb)
