"""What the port refuses: JAX imports, silent CPU fallback, unported paths."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.core import api
from repro_torch.core.api import ParallelDecoder

from _torch_corpus import corpus

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
def test_unported_sync_raises(sync):
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        repro_torch.decode_batch(corpus("420"), sync=sync, device="cpu")


def test_unknown_knobs_raise():
    with pytest.raises(ValueError):
        repro_torch.decode_batch(corpus("420"), sync="magic", device="cpu")
    with pytest.raises(ValueError):
        repro_torch.decode_batch(corpus("420"), fuse="post", device="cpu")
    with pytest.raises(ValueError):
        repro_torch.decode_batch(corpus("420"), emit="planes", device="cpu")


def test_fuse_none_on_the_kernels_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP B5"):
        repro_torch.decode_batch(corpus("420"), backend="cuda", fuse="none")
    with pytest.raises(NotImplementedError, match="ROADMAP B5"):
        api.resolve_fuse("none", "cuda")


def test_grayscale_pixels_on_the_kernels_raise():
    dec = ParallelDecoder.from_bytes(corpus("gray"), chunk_bits=256,
                                     device="cpu")
    dec.backend = "cuda"  # as on a card; refused before any decode work
    with pytest.raises(NotImplementedError, match="ROADMAP B5"):
        dec.decode()
