"""Decoder state for the parallel entropy decoder.

A decoder state (paper §IV) is:
  p : bit position (relative to the entropy segment start)
  u : data-unit index within the current MCU (generalizes the paper's
      component `c`: for subsampled scans the Huffman-table schedule depends
      on the position within the MCU, not just the component)
  z : zig-zag index within the current data unit (0 = expecting DC)
  n : number of zig-zag steps produced (per-chunk during sync; the paper's
      symbol count that is prefix-summed for output placement)

Synchronization compares (p, u, z) — `n` is a pure function of the entry
state and the bits, so it stabilizes with them. All fields are int32
tensors of one lane each.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class DecodeState(NamedTuple):
    p: torch.Tensor  # int32 (n_chunks,)
    u: torch.Tensor  # int32
    z: torch.Tensor  # int32
    n: torch.Tensor  # int32 (z-steps emitted within the current chunk decode)

    @staticmethod
    def cold(start_bits: torch.Tensor) -> "DecodeState":
        """Speculative cold start: bit 0 of the chunk, fresh MCU/zig-zag."""
        z = torch.zeros_like(start_bits)
        return DecodeState(p=start_bits, u=z, z=z, n=z)

    def puz_equal(self, other: "DecodeState") -> torch.Tensor:
        """Per-chunk synchronization predicate (paper: (p, c, z) equality)."""
        return (self.p == other.p) & (self.u == other.u) & (self.z == other.z)

    def select(self, pred: torch.Tensor, other: "DecodeState") -> "DecodeState":
        """where(pred, self, other) element-wise."""
        return DecodeState(
            p=torch.where(pred, self.p, other.p),
            u=torch.where(pred, self.u, other.u),
            z=torch.where(pred, self.z, other.z),
            n=torch.where(pred, self.n, other.n),
        )
