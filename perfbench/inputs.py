"""A configuration's frames, made once and cached inside the checkout.

Frame ``i`` is :func:`jpeg_encoder.synth_frame` at ``t = 0.13 i`` (the
repository's dataset maker's phase step) with film grain drawn from
``SeedSequence([GRAIN_SEED, i])``. The frames are the configuration's and
not the run's: the grain decides how many rounds the sync takes (8 frames
of another grain took 60 to 67 rounds of ``tos_8``, 26 to 29 of
``newyork``), so a grain drawn from ``--seed`` would change the work from
run to run. The run's seed orders the frames in its batches instead
(``harness.ring_frames``); ``perfbench.rehearse --grain`` reads the
check on frames of another grain. The encode runs once a checkout, a Python
process a frame over the host's cores: its result is cached per
(configuration, restart interval) under ``perfbench/.cache/``, the bytes
and segment lengths in ``frames.npz``, which set-up reads, and the
coefficients the bytes hold in ``truth.npz``, which only the check after
the window reads.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np

from . import jpeg_encoder as E

@dataclasses.dataclass
class Frames:
    """The distinct frames of a configuration under a traffic mix."""

    blobs: List[bytes]
    segment_bytes: List[List[int]]   # clean bytes of each entropy segment
    geometry: E.Geometry
    quality: int
    restart_interval: int
    truth_path: Path
    _truth: Optional[List[np.ndarray]] = None

    def truth(self) -> List[np.ndarray]:
        """Each frame's (n_units, 64) coefficients as encoded (zig-zag,
        DC differential)."""
        if self._truth is None:
            with np.load(self.truth_path) as z:
                coeff = z["coeff"].astype(np.int32)
            self._truth = list(coeff.reshape(len(self.blobs), -1, 64))
        return self._truth

    def reference(self, f: int, device, precision: str = "float64"):
        """Frame ``f``'s RGB by the plain reference
        (:func:`perfbench.reference.rgb`)."""
        from . import reference   # torch: not for the encode's workers
        return reference.rgb(self.truth()[f], self.geometry, self.quality,
                             self.restart_interval, device, precision)


GRAIN_SEED = 0


def encode_frame(args) -> E.Encoded:
    """Frame ``i`` of grain ``seed``."""
    seed, i, width, height, quality, subsampling, restart = args
    rng = np.random.default_rng(np.random.SeedSequence([seed, i]))
    img = E.synth_frame(rng, width, height, t=0.13 * i)
    return E.encode(img, quality, subsampling, restart)


def make_frames(config: dict, restart_interval: int, cache: Path,
                processes: Optional[int] = None) -> Frames:
    """The configuration's ``n_images`` distinct frames, from the cache
    directory ``cache`` or encoded over ``processes`` workers (the host's
    cores by default; 1 encodes in this process)."""
    g = E.geometry(config["width"], config["height"], config["subsampling"])
    n = int(config["n_images"])
    what = (n, g.width, g.height, config["subsampling"], config["quality"],
            restart_interval, GRAIN_SEED)
    tag = hashlib.sha256(repr(what).encode()).hexdigest()[:12]
    where = cache / f"{config['name']}.r{restart_interval}.{tag}"
    frames_path, truth_path = where / "frames.npz", where / "truth.npz"
    if frames_path.exists() and truth_path.exists():
        with np.load(frames_path) as z:
            data, ends = z["data"], z["ends"]
            segs = json.loads(str(z["segments"]))
        blobs = [data[a:b].tobytes()
                 for a, b in zip(np.r_[0, ends[:-1]], ends)]
        return Frames(blobs, segs, g, config["quality"], restart_interval,
                      truth_path)
    tasks = [(GRAIN_SEED, i, g.width, g.height, config["quality"],
              config["subsampling"], restart_interval) for i in range(n)]
    processes = min(n, processes or os.cpu_count() or 1)
    where.mkdir(parents=True, exist_ok=True)
    if processes > 1:
        enc = _encode_apart(tasks, where, processes)
    else:
        enc = [encode_frame(t) for t in tasks]
    blobs = [e.jpeg_bytes for e in enc]
    segs = [e.segment_bytes for e in enc]
    data = np.frombuffer(b"".join(blobs), dtype=np.uint8)
    coeff = np.stack([e.coeff for e in enc]).astype(np.int16)
    # written under a temporary name and renamed, so that a run cut short
    # never leaves a half file that a later run would read
    tmp = where / "tmp.npz"
    np.savez(tmp, data=data, ends=np.cumsum([len(b) for b in blobs]),
             segments=json.dumps(segs))
    os.replace(tmp, frames_path)
    np.savez_compressed(tmp, coeff=coeff)
    os.replace(tmp, truth_path)
    return Frames(blobs, segs, g, config["quality"], restart_interval,
                  truth_path, [e.coeff for e in enc])


def _encode_apart(tasks, where: Path, processes: int) -> List[E.Encoded]:
    """Each task encoded by a Python process of its own (``python -m
    perfbench.inputs``), ``processes`` at a time, the results handed over
    in files under ``where``: no pool, so no semaphore in ``/dev/shm``."""
    root = Path(__file__).resolve().parents[1]
    outs = [where / f"part{i}.npz" for i in range(len(tasks))]
    pending, running = list(zip(tasks, outs)), []
    try:
        while pending or running:
            while pending and len(running) < processes:
                task, out = pending.pop(0)
                running.append(subprocess.Popen(
                    [sys.executable, "-m", "perfbench.inputs", str(out),
                     json.dumps(task)], cwd=root))
            if running[0].wait(timeout=600) != 0:
                raise RuntimeError(f"encoding a frame failed: "
                                   f"{running[0].args}")
            running.pop(0)
    finally:
        for p in running:
            p.kill()
            p.wait()
    enc = []
    for out in outs:
        with np.load(out) as z:
            enc.append(E.Encoded(z["jpeg"].tobytes(),
                                 z["coeff"].astype(np.int32),
                                 [int(b) for b in z["segments"]]))
        out.unlink()
    return enc


if __name__ == "__main__":
    # one frame for make_frames: python -m perfbench.inputs OUT TASK
    out, task = Path(sys.argv[1]), json.loads(sys.argv[2])
    e = encode_frame(tuple(task))
    tmp = out.with_suffix(".tmp.npz")
    np.savez(tmp, jpeg=np.frombuffer(e.jpeg_bytes, dtype=np.uint8),
             coeff=e.coeff.astype(np.int16),
             segments=np.array(e.segment_bytes, dtype=np.int64))
    os.replace(tmp, out)
