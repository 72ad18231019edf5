"""Build and load the CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``build/repro_torch/`` at the root of the checkout, and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The library's
file name carries a hash of the sources, so an edited kernel is rebuilt
and a stale library is never loaded. :func:`build_all` starts one
``nvcc`` per source at once.

The checked build (``checked=True``: ``lib<name>-check-<hash>.so``, with
``-DRT_CHECK -lineinfo``) guards every access of the kernels and counts
the writes of their dense outputs (``csrc/check.cuh``); it also holds
``csrc/seeds.cu``, the verifier's seeded faults, which exists only
checked. Only the kernel verifier (``analysis/kernel_check.py``,
``kernels/seeds.py``) asks for it, by that argument; the decoder's
wrappers always load the release build.

Kernel launches through ``ctypes`` do not pass through PyTorch's
dispatcher, so a dispatch mode does not see them. The traced-program
checker (``analysis/trace_check.py``) sees them through a launch recorder
(:func:`recording_launches`): while one is installed in a thread,
:func:`ptr` hands it each tensor it passes to a kernel and :func:`check`
closes the launch under the kernel's name. With none installed both do
nothing more.

Nothing here runs when the module is imported.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("huffman", "pixels", "idct", "color")
CHECKED_SOURCES = SOURCES + ("seeds",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CHECK_FLAGS = ("-DRT_CHECK", "-lineinfo")

_LIBS: Dict[Tuple[str, bool], ctypes.CDLL] = {}
_ENTRIES: Dict[Tuple[str, str, bool], Callable[..., int]] = {}
_LOCK = threading.Lock()
# the launch recorder of each thread (recording_launches)
_RECORDING = threading.local()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on "
                           "PATH or set CUDA_HOME")
    return str(path)


def flags(checked: bool = False) -> Tuple[str, ...]:
    """The nvcc flags of the release or the checked build."""
    return NVCC_FLAGS + (CHECK_FLAGS if checked else ())


def _library_path(name: str, checked: bool = False) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):  # every .cu and .cuh
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(flags(checked)).encode())
    kind = "-check" if checked else ""
    return BUILD_DIR / f"lib{name}{kind}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES, checked: bool = False
              ) -> Dict[str, Tuple[float, str]]:
    """Compile every named source that is not built yet, all at once (the
    checked build with ``checked``).

    Returns ``{name: (seconds, compiler output)}`` for the sources built
    by this call (``-Xptxas -v`` prints registers and shared memory per
    kernel). Raises with the compiler's output if any build fails.
    """
    if not checked and "seeds" in names:
        raise ValueError("seeds.cu is built checked only")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _library_path(name, checked)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *flags(checked), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    report, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name: str, checked: bool = False) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use: the
    release build, or the checked one with ``checked``."""
    with _LOCK:
        lib = _LIBS.get((name, checked))
        if lib is None:
            path = _library_path(name, checked)
            if not path.exists():
                build_all((name,), checked)
            lib = _LIBS[name, checked] = ctypes.CDLL(str(path))
        return lib


def entry(lib: str, name: str, argtypes,
          checked: bool = False) -> Callable[..., int]:
    """The C entry point ``name`` of ``csrc/<lib>.cu``, typed on first use
    (every entry point returns a ``cudaError_t``), of the checked build
    with ``checked``."""
    fn = _ENTRIES.get((lib, name, checked))
    if fn is None:
        fn = getattr(load(lib, checked), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[(lib, name, checked)] = fn
    return fn


@contextlib.contextmanager
def recording_launches(recorder) -> Iterator[None]:
    """Hand this thread's kernel launches to ``recorder`` while the block
    runs: ``recorder.operand(t)`` for each tensor :func:`ptr` passes to a
    kernel, then ``recorder.launch(what)`` when :func:`check` closes the
    launch."""
    before = getattr(_RECORDING, "recorder", None)
    _RECORDING.recorder = recorder
    try:
        yield
    finally:
        _RECORDING.recorder = before


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    recorder = getattr(_RECORDING, "recorder", None)
    if recorder is not None:
        recorder.launch(what)
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")


def ptr(t) -> ctypes.c_void_p:
    recorder = getattr(_RECORDING, "recorder", None)
    if recorder is not None:
        recorder.operand(t)
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """The current stream of ``t``'s card. A kernel runs on the current
    device, so a launch whose operands lie on another card raises (a mesh
    decode launches each block's kernels under ``torch.cuda.device``)."""
    import torch

    if t.device.index != torch.cuda.current_device():
        raise RuntimeError(f"kernel operands on {t.device}, but the current "
                           f"device is cuda:{torch.cuda.current_device()}")
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
