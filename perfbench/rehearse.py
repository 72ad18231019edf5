"""Rehearse a run, optionally with the timed path broken or on other frames.

    PYTHONPATH=src python -m perfbench.rehearse --root DIR [--card] \\
        [--fault NAME] [--grain G] \\
        -- --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs :func:`perfbench.harness.main`, with the cells, configurations and
metrics under ``DIR`` (a checkout's root, or a small one a test writes):
on the CPU (the program's plain backend, the encode in this process), or
with ``--card`` on the card as the benchmark's own runs are. ``--grain``
makes the configuration's frames with another film grain than the one
the benchmark fixes (``inputs.GRAIN_SEED``), to read the check on
another set of frames. ``--fault`` breaks the program's
``ParallelDecoder.decode`` underneath, as a fault the cell can have
would:

- ``stale``: a decode returns its state unchanged, the last call's output;
- ``half``: half of the batch left out (its images black);
- ``altered``: one sample of the batch's first image altered where it is
  produced;
- ``control``: the control, the plain reference in TF32 put in the
  program's place (its RGB made in set-up, one a distinct frame);
- ``import``: a module of the JAX package's name is loaded before the
  window closes (a stub: nothing of the JAX package is imported).

A cell has one card, so the exchange between cards is no fault it can
have. The tests run this in a process of its own, so that the run's
import check sees that process's modules alone.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import types
from pathlib import Path

import torch

FAULTS = ("stale", "half", "altered", "control", "import")


STUB = "repro.stub"


def install(fault: str) -> None:
    """Break the timed path as ``fault`` says."""
    from repro_torch.core.api import ParallelDecoder
    from . import harness, inputs

    decode = ParallelDecoder.decode
    if fault == "import":
        sys.modules[STUB] = types.ModuleType(STUB)
        return
    if fault == "control":
        made = {}
        make_frames, plan_ring = inputs.make_frames, harness.plan_ring

        def frames_seen(*a, **kw):
            made["frames"] = make_frames(*a, **kw)
            return made["frames"]

        def ring_seen(batches, chunk_bits, device):
            frames = made["frames"]
            index = {b: i for i, b in enumerate(frames.blobs)}
            where = "cuda" if device is None else device
            refs = {f: frames.reference(f, where, "tf32")
                    for f in set(index.values())}
            ring = plan_ring(batches, chunk_bits, device)
            for dec, blobs in zip(ring, batches):
                dec.control_rgb = torch.stack([refs[index[b]] for b in blobs])
            return ring

        inputs.make_frames = frames_seen
        harness.plan_ring = ring_seen

        def broken(self, emit="rgb"):
            return dataclasses.replace(decode(self, emit),
                                       rgb=self.control_rgb.clone())
    elif fault == "stale":
        last = []

        def broken(self, emit="rgb"):
            out = decode(self, emit)
            last.append(out)
            return last.pop(0) if len(last) > 1 else out
    elif fault == "half":
        def broken(self, emit="rgb"):
            out = decode(self, emit)
            rgb = out.rgb.clone()
            rgb[len(rgb) // 2:] = 0
            return dataclasses.replace(out, rgb=rgb)
    elif fault == "altered":
        def broken(self, emit="rgb"):
            out = decode(self, emit)
            rgb = out.rgb.clone()
            rgb[0, 0, 0, 0] ^= 0x80
            return dataclasses.replace(out, rgb=rgb)
    else:
        raise ValueError(f"fault must be one of {FAULTS}")
    ParallelDecoder.decode = broken


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, required=True)
    ap.add_argument("--card", action="store_true",
                    help="run on the card, as the benchmark does")
    ap.add_argument("--fault", choices=FAULTS)
    ap.add_argument("--grain", type=int,
                    help="the frames' film grain (default: the benchmark's)")
    ap.add_argument("run", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    run = args.run[1:] if args.run[:1] == ["--"] else args.run
    from . import harness, inputs
    if args.grain is not None:
        inputs.GRAIN_SEED = args.grain
    if args.fault:
        install(args.fault)
    if args.card:
        return harness.main(run, root=args.root)
    return harness.main(run, root=args.root, device="cpu", processes=1)


if __name__ == "__main__":
    sys.exit(main())
