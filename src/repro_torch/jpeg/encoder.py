"""Synthetic datasets after the paper's evaluation corpora (numpy).

A copy of the JAX package's ``jpeg/encoder.py``; the port imports nothing
of that package. The paper evaluates on batches of photographic frames
(Tables II/III):

  newyork   : 500  x 1920x1080, max quality
  stata     : 2400 x  720x480,  max quality
  tos_1440p : 200  x 2560x1440, max quality
  tos_4k    : 200  x 3840x2160, max quality
  tos_8/14/20 : 200 x 2560x1440 at decreasing quality

The original footage cannot ship, so the frames are synthesized
*photograph-like* (smooth illumination + oriented textures + film grain,
correlated across the batch like video) and encoded with the reference
encoder. For a spec and a seed the bytes equal the JAX package's.
Dataset *scale* is configurable so test-sized runs stay fast.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from .codec_ref import encode_baseline

# ffmpeg -qscale:v 2..31 maps roughly to libjpeg quality ~95..5. The paper's
# tos_8/14/20 use qscale 8/14/20; these are the approximate equivalents.
QSCALE_TO_QUALITY = {2: 95, 8: 72, 14: 55, 20: 40}

# the disk cache's file-name prefix and hash tag: a cache directory shared
# with the JAX package never hands one package the other's pickled classes
_CACHE_TAG = "repro_torch"


@dataclasses.dataclass
class DatasetSpec:
    name: str
    n_images: int
    width: int
    height: int
    quality: int
    subsampling: str = "4:2:0"
    subsequence_bits: int = 1024  # paper Table II/III "subsequence size"
    restart_interval: int = 0


PAPER_DATASETS: Dict[str, DatasetSpec] = {
    "newyork": DatasetSpec("newyork", 500, 1920, 1080, 95, subsequence_bits=1024),
    "stata": DatasetSpec("stata", 2400, 720, 480, 95, subsequence_bits=1024),
    "tos_1440p": DatasetSpec("tos_1440p", 200, 2560, 1440, 95, subsequence_bits=1024),
    "tos_4k": DatasetSpec("tos_4k", 200, 3840, 2160, 95, subsequence_bits=1024),
    "tos_8": DatasetSpec("tos_8", 200, 2560, 1440, 72, subsequence_bits=128),
    "tos_14": DatasetSpec("tos_14", 200, 2560, 1440, 55, subsequence_bits=1024),
    "tos_20": DatasetSpec("tos_20", 200, 2560, 1440, 40, subsequence_bits=1024),
}


def scaled_spec(spec: DatasetSpec, scale: float) -> DatasetSpec:
    """Shrink a dataset spec for test-sized runs (images and resolution)."""
    if scale >= 1.0:
        return spec
    n = max(2, int(spec.n_images * scale))
    w = max(64, int(spec.width * max(scale, 0.05)) // 16 * 16)
    h = max(64, int(spec.height * max(scale, 0.05)) // 16 * 16)
    return dataclasses.replace(spec, n_images=n, width=w, height=h)


def synth_frame(
    rng: np.random.Generator,
    width: int,
    height: int,
    t: float,
    detail: float = 1.0,
) -> np.ndarray:
    """One synthetic photograph-like RGB frame.

    Composition: low-frequency illumination gradients + a few oriented
    sinusoidal textures (edges/patterns) + white noise (film grain). `t`
    slides phases so consecutive frames correlate like video footage.
    """
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    xn, yn = xx / width, yy / height
    base = 120 + 60 * np.sin(2.2 * xn + 0.7 * t) * np.cos(1.7 * yn - 0.3 * t)
    tex = np.zeros_like(base)
    for k in range(4):
        fx = 2 ** (k + 2) * np.pi
        ang = 0.6 * k + 0.2 * t
        tex += (18.0 / (k + 1)) * np.sin(
            fx * (xn * np.cos(ang) + yn * np.sin(ang)) + 3.1 * t
        )
    grain = rng.normal(0, 6.0 * detail, size=(height, width))
    luma = base + detail * tex + grain
    # Slowly varying chroma fields.
    cb = 16 * np.sin(3.1 * xn + t) + 10 * np.cos(2.3 * yn)
    cr = 14 * np.cos(2.7 * xn - 0.5 * t) + 9 * np.sin(3.7 * yn + t)
    r = luma + 1.402 * cr
    g = luma - 0.344 * cb - 0.714 * cr
    b = luma + 1.772 * cb
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


@dataclasses.dataclass
class Dataset:
    spec: DatasetSpec
    jpeg_bytes: List[bytes]
    # Per-image ground truth for tests (entropy-level), kept optional to bound
    # memory for large corpora.
    coeff_zigzag: Optional[List[np.ndarray]] = None

    @property
    def compressed_mb(self) -> float:
        return sum(len(b) for b in self.jpeg_bytes) / 1e6

    @property
    def avg_image_kb(self) -> float:
        return self.compressed_mb * 1000 / max(1, len(self.jpeg_bytes))


def build_dataset(
    spec: DatasetSpec,
    seed: int = 0,
    keep_truth: bool = False,
    cache_dir: Optional[str] = None,
) -> Dataset:
    """Encode a full synthetic dataset; disk-cached by content hash.

    The cache file is this package's own (its name and hash carry
    ``_CACHE_TAG``), so it only ever holds pickles this package wrote.
    """
    key = None
    if cache_dir:
        h = hashlib.sha1(
            repr((_CACHE_TAG, dataclasses.astuple(spec), seed, keep_truth,
                  3)).encode()
        ).hexdigest()[:16]
        key = os.path.join(cache_dir, f"{_CACHE_TAG}_{spec.name}_{h}.pkl")
        if os.path.exists(key):
            with open(key, "rb") as f:
                return pickle.load(f)
    rng = np.random.default_rng(seed)
    blobs: List[bytes] = []
    truths: List[np.ndarray] = []
    for i in range(spec.n_images):
        frame = synth_frame(rng, spec.width, spec.height, t=0.13 * i)
        res = encode_baseline(
            frame,
            quality=spec.quality,
            subsampling=spec.subsampling,
            restart_interval=spec.restart_interval,
        )
        blobs.append(res.jpeg_bytes)
        if keep_truth:
            truths.append(res.coeff_zigzag)
    ds = Dataset(spec, blobs, truths if keep_truth else None)
    if key:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = key + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(ds, f)
        os.replace(tmp, key)
    return ds
