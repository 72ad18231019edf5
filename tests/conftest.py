import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-device subprocess tests (forced device count)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")
    # the decoder donates its per-batch words operand; CPU jax cannot
    # consume the donation and warns once per compile (expected, harmless
    # there). Scoped to CPU: on GPU/TPU donation must succeed, so the
    # warning stays visible as a regression signal.
    import jax
    if jax.default_backend() == "cpu":
        config.addinivalue_line(
            "filterwarnings",
            "ignore:Some donated buffers were not usable")


def synth_image(height: int, width: int, seed: int = 0, noise: float = 10.0):
    """Photographic-like synthetic RGB test image."""
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


@pytest.fixture
def rng():
    return np.random.default_rng(0)
