"""Small JPEG corpora for the port's tests, encoded with the JAX package's
reference codec from images made with numpy from a seed.

Imports no JAX (``repro.jpeg`` is numpy only) and not ``conftest``, so the
card's tests also run with ``--noconftest`` where JAX is not installed.
"""
import numpy as np

from repro.jpeg import codec_ref as cr


def synth_image(height: int, width: int, seed: int = 0, noise: float = 10.0):
    """Photographic-like synthetic RGB test image (as conftest.synth_image)."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    img = np.stack(
        [
            128 + 100 * np.sin(xx / 7.0) * np.cos(yy / 9.0),
            128 + 80 * np.cos(xx / 5.0 + yy / 11.0),
            np.clip(xx * 3 + yy * 2, 0, 255),
        ],
        axis=-1,
    )
    return np.clip(img + r.normal(0, noise, img.shape), 0, 255).astype(np.uint8)


def _enc(img, **kw):
    return cr.encode_baseline(img, **kw).jpeg_bytes


def corpus(name: str):
    """The blobs of one named corpus (each decodes in well under a second)."""
    if name == "420":
        return [_enc(synth_image(48, 64, seed=s), quality=q)
                for s, q in ((0, 70), (1, 90))]
    if name == "422":
        return [_enc(synth_image(40, 64, seed=7), quality=85,
                     subsampling="4:2:2")]
    if name == "444":
        return [_enc(synth_image(40, 48, seed=2), quality=85,
                     subsampling="4:4:4")]
    if name == "gray":
        gray = synth_image(40, 56, seed=3)[..., 0]
        return [_enc(gray, quality=80)]
    if name == "restart":
        return [_enc(synth_image(48, 64, seed=4), quality=90,
                     restart_interval=2)]
    if name == "optimized":
        return [_enc(synth_image(48, 64, seed=5), quality=85,
                     optimize_huffman=True)]
    if name == "mixed":
        return [_enc(synth_image(48, 64, seed=6), quality=q) for q in (50, 95)]
    raise KeyError(name)


CORPORA = ("420", "444", "gray", "restart", "optimized", "mixed")
RGB_CORPORA = ("420", "444", "restart", "optimized", "mixed")


def oracle_coeffs(blobs):
    """Absolute-DC zig-zag coefficients of the sequential oracle."""
    out = []
    for b in blobs:
        img = cr.parse_jpeg(b)
        out.append(cr.undiff_dc(img, cr.decode_coefficients(img)))
    return np.concatenate(out)
