"""What the port refuses (JAX imports, silent CPU fallback, the kernels
without a card), and that every schedule and pixel path it once refused
now plans and decodes."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.jpeg import codec_ref as cr
import repro_torch
from repro_torch.core import api
from repro_torch.core.api import ParallelDecoder

from _torch_corpus import corpus, oracle_coeffs

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "repro")


def test_import_pulls_in_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.kernels.build; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); assert not bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_repro_import_in_source(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(map(_forbidden, names)), f"{path}: imports {names}"


def test_default_device_needs_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    planned = []
    monkeypatch.setattr(api, "build_batch_plan",
                        lambda *a, **k: planned.append(1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.decode_batch(corpus("420"))
    assert not planned  # refused before any work, nothing ran on the CPU


def test_kernel_backend_on_cpu_raises():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        repro_torch.decode_batch(corpus("420"), backend="cuda", device="cpu")


@pytest.mark.parametrize("sync", ["faithful", "specmap", "sequential"])
def test_every_sync_plans_and_decodes_on_the_cpu(sync):
    blobs = corpus("420")
    out = repro_torch.decode_batch(blobs, sync=sync, device="cpu")
    assert out.converged
    np.testing.assert_array_equal(out.coeffs.numpy(), oracle_coeffs(blobs))
    base = np.stack([cr.decode_baseline(b) for b in blobs]).astype(int)
    assert np.abs(out.rgb.numpy().astype(int) - base).max() <= 1


def test_unknown_knobs_raise():
    with pytest.raises(ValueError):
        repro_torch.decode_batch(corpus("420"), sync="magic", device="cpu")
    with pytest.raises(ValueError):
        repro_torch.decode_batch(corpus("420"), fuse="post", device="cpu")
    # "rgb", "coeffs" and "planes" are the emits; any other string raises
    with pytest.raises(ValueError, match="emit must be one of"):
        repro_torch.decode_batch(corpus("420"), emit="pixels", device="cpu")


def test_fuse_none_plans_and_decodes_on_the_cpu():
    assert api.resolve_fuse("none", "cuda") == "none"
    blobs = corpus("420")
    out = repro_torch.decode_batch(blobs, fuse="none", device="cpu")
    np.testing.assert_array_equal(out.coeffs.numpy(), oracle_coeffs(blobs))
    assert len(out.planes) == 3 and not out.pixels_fused


def test_fuse_none_on_the_kernels_needs_a_card(monkeypatch):
    with pytest.raises(ValueError, match="needs a CUDA device"):
        repro_torch.decode_batch(corpus("420"), backend="cuda", fuse="none",
                                 device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    planned = []
    monkeypatch.setattr(api, "build_batch_plan",
                        lambda *a, **k: planned.append(1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.decode_batch(corpus("420"), backend="cuda", fuse="none")
    assert not planned


def test_grayscale_pixels_plan_and_decode_on_the_cpu():
    blobs = corpus("gray")
    dec = ParallelDecoder.from_bytes(blobs, chunk_bits=256, device="cpu")
    dec.backend = "cuda"  # as on a card: the IDCT wrapper, here its plain
    out = dec.decode()    # version on CPU tensors
    assert out.idct_kernel and not out.pixels_fused and not out.color_kernel
    base = np.stack([cr.decode_baseline(b) for b in blobs]).astype(int)
    assert out.rgb.shape == base.shape
    assert np.abs(out.rgb.numpy().astype(int) - base).max() <= 1


def test_no_refusal_of_a_ported_path_is_left():
    """No ``NotImplementedError`` names ROADMAP A4 or B5 any more."""
    for path in PORT_FILES:
        text = path.read_text()
        assert "ROADMAP A4" not in text and "ROADMAP B5" not in text, path


# ---------------------------------------------------------------------------
# REPRO_PALLAS_FUSE and the deprecated use_kernels=, as repro honours them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["none", "post", "full"])
def test_fuse_env_sets_the_kernels_default(monkeypatch, mode):
    monkeypatch.setenv("REPRO_PALLAS_FUSE", mode)
    assert api.resolve_fuse(None, "cuda") == mode


def test_fuse_argument_wins_over_the_env(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS_FUSE", "full")
    assert api.resolve_fuse("post", "cuda") == "post"
    assert api.resolve_fuse("none", "cuda") == "none"
    monkeypatch.setenv("REPRO_PALLAS_FUSE", "")
    assert api.resolve_fuse(None, "cuda") == "post"  # empty: the default


def test_bad_fuse_env_raises(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS_FUSE", "everything")
    with pytest.raises(ValueError, match="unknown fuse mode 'everything'"):
        api.resolve_fuse(None, "cuda")
    # an argument does not read the variable
    assert api.resolve_fuse("full", "cuda") == "full"


@pytest.mark.parametrize("value", ["full", "everything"])
def test_fuse_env_is_ignored_on_the_plain_backend(monkeypatch, value):
    monkeypatch.setenv("REPRO_PALLAS_FUSE", value)
    assert api.resolve_fuse(None, "torch") == "none"
    assert api.resolve_options("jacobi", None, None, "cpu")[1:] == \
        ("torch", "none")
    blobs = corpus("420")
    out = repro_torch.decode_batch(blobs, device="cpu")
    np.testing.assert_array_equal(out.coeffs.numpy(), oracle_coeffs(blobs))


def test_use_kernels_warns_and_means_the_kernels():
    with pytest.warns(DeprecationWarning, match="use_kernels"):
        assert api.resolve_use_kernels(None, True) == "cuda"
    with pytest.warns(DeprecationWarning):
        assert api.resolve_use_kernels("cuda", True) == "cuda"
    assert api.resolve_use_kernels("torch", False) == "torch"
    assert api.resolve_use_kernels(None, False) is None
    with pytest.warns(DeprecationWarning), \
            pytest.raises(ValueError, match="conflicting backend"):
        api.resolve_use_kernels("torch", True)


def test_use_kernels_at_the_entry_points():
    """Each entry point maps ``use_kernels=True`` to the kernels (which
    the CPU refuses) and refuses it beside ``backend="torch"``, before
    any decode."""
    from repro_torch.launch.multihost import decode_multihost
    blobs = corpus("420")
    calls = [lambda **k: repro_torch.decode_batch(blobs, **k),
             lambda **k: ParallelDecoder.from_bytes(blobs, **k),
             lambda **k: decode_multihost(blobs, **k)]
    for call in calls:
        with pytest.warns(DeprecationWarning), \
                pytest.raises(ValueError, match="needs a CUDA device"):
            call(use_kernels=True, device="cpu")
        with pytest.warns(DeprecationWarning), \
                pytest.raises(ValueError, match="conflicting backend"):
            call(use_kernels=True, backend="torch", device="cpu")
