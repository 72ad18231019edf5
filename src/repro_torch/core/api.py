"""Public API: batched JPEG decoding on the card.

Usage:
    out = decode_batch(list_of_jpeg_blobs)          # DecodeOutput, on "cuda"
    dec = ParallelDecoder.from_bytes(blobs, chunk_bits=1024)
    out = dec.decode(emit="rgb")

The port of the JAX package's ``core/api.py``: host parse and plan
(numpy), then on the device the sync (a speculative decode of every
chunk, then rounds to the fixed point), the segmented prefix sum for the
write bases, the write pass, DC undiff and the pixel stage.

``device`` defaults to ``"cuda"``: without a card the call raises, and the
decoder runs on the CPU only when the caller passes ``device="cpu"``.
``backend`` is ``"cuda"`` (the hand-written kernels) or ``"torch"`` (their
plain versions); it defaults to ``"cuda"`` on a CUDA device and to
``"torch"`` on the CPU, and ``"cuda"`` on the CPU raises.

``sync`` picks the schedule (``core/sync.py``): ``"jacobi"`` (default),
``"faithful"`` (the paper's Algorithm 3), ``"specmap"`` (phase-map
composition) or ``"sequential"`` (one chunk per entropy segment, sized by
:func:`sequential_chunk_bits`, so the cold decode is exact: the
per-image baseline). All four give bit-identical coefficients.

``fuse`` (kernels only, default ``"post"``): ``"post"`` runs the write
pass as the stream kernel plus a scatter and the pixel stage as the fused
pixel kernel; ``"full"`` runs the write pass as the store kernel instead;
``"none"`` runs the stream write pass and the unfused pixel chain: the
IDCT kernel, plane assembly (torch indexing) and the color kernel. A
grayscale batch runs the IDCT kernel, plane assembly and a crop under
every mode. The plain backend runs the unfused chain (``fuse="none"``).
``DecodeOutput`` says which of the kernels ran.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import decode as D
from .bitstream import (MAX_UPM, BatchPlan, PlanShape, bucket_capacity,
                        build_batch_plan, build_plan_data, dev_from_numpy,
                        plan_shape)
from .state import DecodeState
from .sync import (SyncResult, chain_entries, faithful_sync, jacobi_sync,
                   specmap_sync)
from ..jpeg.format import parse_jpeg, segment_byte_bounds, unstuff_scan
from ..kernels.color.ops import upsample_color, upsample_color_plain
from ..kernels.fused.ops import decode_pixels_fused, pixels_fusible
from ..kernels.fused.store import (decode_coeffs_store,
                                  decode_coeffs_store_plain)
from ..kernels.huffman import ops as HK
from ..kernels.idct.ops import idct_units, idct_units_plain

BACKENDS = ("cuda", "torch")
FUSE_MODES = ("none", "post", "full")
SYNCS = ("jacobi", "faithful", "specmap", "sequential")
EMITS = ("rgb", "coeffs")


@dataclasses.dataclass
class DecodeOutput:
    coeffs: torch.Tensor                  # (U_total, 64) zig-zag, absolute DC
    planes: Optional[List[torch.Tensor]]  # per component (B, Hc, Wc) float32
    rgb: Optional[torch.Tensor]           # (B, H, W, 3) or (B, H, W) uint8
    sync_rounds: int
    converged: bool
    plan: BatchPlan
    # which kernels ran: the store kernel for the write pass (fuse="full"),
    # and for the pixel stage either the fused pixel kernel or the IDCT
    # kernel followed by the color kernel (three planes)
    store_fused: bool = False
    pixels_fused: bool = False
    idct_kernel: bool = False
    color_kernel: bool = False


def check_sync(sync: str) -> str:
    if sync not in SYNCS:
        raise ValueError(f"unknown sync {sync!r}; expected one of {SYNCS}")
    return sync


def sequential_chunk_bits(unstuffed, bucket: bool = True) -> int:
    """Chunk size that makes every entropy *segment* a single chunk.

    Sized from the unstuffed scans' longest segment (restart intervals
    split a scan into many short segments), not from whole-file bytes, so
    ``s_max`` stays as small as the batch allows. ``unstuffed`` is a list
    of ``unstuff_scan`` results, shared with the plan builder so each scan
    is unstuffed once. With ``bucket`` the size is rounded up the capacity
    ladder before word alignment, as the JAX package does.
    """
    worst = 32
    for clean, rst_bits in unstuffed:
        bounds = segment_byte_bounds(clean, rst_bits)
        longest = max(b - a for a, b in zip(bounds, bounds[1:]))
        worst = max(worst, longest * 8)
    if bucket:
        worst = bucket_capacity(worst)
    return -(-worst // 32) * 32


def resolve_options(sync: str, backend: Optional[str], fuse: Optional[str],
                    device) -> Tuple[torch.device, str, str]:
    """Validate the knobs and resolve their defaults: (device, backend, fuse).

    Unknown or conflicting knobs are refused before the device is looked
    at.
    """
    check_sync(sync)
    if backend is not None and backend not in BACKENDS:
        raise ValueError(
            f"unknown decode backend {backend!r}; expected one of {BACKENDS}")
    if fuse is not None and fuse not in FUSE_MODES:
        raise ValueError(f"unknown fuse mode {fuse!r}; expected one of "
                         f"{FUSE_MODES}")
    if backend is not None:
        resolve_fuse(fuse, backend)
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    return dev, backend, resolve_fuse(fuse, backend)


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the decoder runs on the card, or "
            "on the CPU only when the caller passes device='cpu'")
    return dev


def resolve_backend(backend: Optional[str], device: torch.device) -> str:
    if backend is None:
        return "cuda" if device.type == "cuda" else "torch"
    if backend == "cuda" and device.type != "cuda":
        raise ValueError("backend='cuda' runs the kernels and needs a CUDA "
                         "device; on the CPU use backend='torch'")
    return backend


def resolve_fuse(fuse: Optional[str], backend: str) -> str:
    if backend == "torch":
        if fuse not in (None, "none"):
            raise ValueError(f"fuse={fuse!r} requires backend='cuda'; the "
                             f"plain backend runs the unfused chain")
        return "none"
    return fuse or "post"


class ParallelDecoder:
    """A decoder for one batch: its (optionally bucketed) plan on the
    device, and the backend and fuse mode that run it."""

    def __init__(self, plan: BatchPlan, sync: str = "jacobi",
                 backend: Optional[str] = None, bucket: bool = True,
                 fuse: Optional[str] = None, device="cuda"):
        self.device, self.backend, self.fuse = resolve_options(
            sync, backend, fuse, device)
        self.sync = sync
        self.plan = plan
        self.shape = plan_shape(plan, bucket=bucket)
        self.data = build_plan_data(plan, self.shape)
        self.dev = dev_from_numpy(dict(self.data.arrays,
                                       words=self.data.words), self.device)
        if plan.uniform:
            self._comp_unit_idx = [torch.as_tensor(a, dtype=torch.int64,
                                                   device=self.device)
                                   for a in plan.comp_unit_idx]
            self._comp_block_idx = [torch.as_tensor(a, dtype=torch.int64,
                                                    device=self.device)
                                    for a in plan.comp_block_idx]

    @classmethod
    def from_bytes(cls, blobs: Sequence[bytes], chunk_bits: int = 1024,
                   seq_chunks: int = 32, sync: str = "jacobi",
                   backend: Optional[str] = None, bucket: bool = True,
                   fuse: Optional[str] = None,
                   device="cuda") -> "ParallelDecoder":
        """Parse and plan one batch, and put the plan on ``device``."""
        resolve_options(sync, backend, fuse, device)
        images = [parse_jpeg(b) for b in blobs]
        unstuffed = None
        if sync == "sequential":
            unstuffed = [unstuff_scan(img.scan_data) for img in images]
            chunk_bits = sequential_chunk_bits(unstuffed, bucket=bucket)
        plan = build_batch_plan(blobs, chunk_bits=chunk_bits,
                                seq_chunks=seq_chunks, parsed=images,
                                unstuffed=unstuffed)
        return cls(plan, sync=sync, backend=backend, bucket=bucket,
                   fuse=fuse, device=device)

    def coefficients(self) -> DecodeOutput:
        """Entropy stage: sync, write bases, write pass, DC undiff."""
        coeffs, rounds, converged = decode_coefficients(
            self.dev, self.shape, backend=self.backend, fuse=self.fuse,
            sync=self.sync)
        return DecodeOutput(coeffs[:self.plan.total_units], None, None,
                            rounds, converged, self.plan,
                            store_fused=self.backend == "cuda"
                            and self.fuse == "full")

    def decode(self, emit: str = "rgb") -> DecodeOutput:
        if emit not in EMITS:
            raise ValueError(f"emit must be one of {EMITS}, got {emit!r}")
        plan = self.plan
        if emit == "rgb" and not plan.uniform:
            raise NotImplementedError(
                "pixel stage requires a geometry-uniform batch; decode "
                "images with mixed geometry with emit='coeffs'")
        out = self.coefficients()
        if emit == "coeffs":
            return out
        g, dev = plan.geometry, self.dev
        mrow = dev["unit_mrow"][:plan.total_units]
        kernels = self.backend == "cuda"
        if kernels and self.fuse != "none" and pixels_fusible(g):
            rgb = decode_pixels_fused(out.coeffs, dev["m_matrices_t"], mrow,
                                      geometry=g, n_images=plan.n_images)
            return dataclasses.replace(out, rgb=rgb, pixels_fused=True)
        # the unfused chain: IDCT, plane assembly, then color or, for one
        # plane, a crop and cast
        idct = idct_units if kernels else idct_units_plain
        pixels = idct(out.coeffs, dev["m_matrices_t"], mrow)
        comp_grid = [(g.mcus_y * v, g.mcus_x * h)
                     for h, v in zip(g.comp_h, g.comp_v)]
        planes = D.assemble_planes(pixels, plan.n_images, self._comp_unit_idx,
                                   self._comp_block_idx, comp_grid)
        geo = (g.comp_h, g.comp_v, g.h_max, g.v_max, g.height, g.width)
        if len(planes) == 1:
            rgb = D.upsample_color(planes, *geo)
        else:
            color = upsample_color if kernels else upsample_color_plain
            rgb = color(planes, *geo)
        return dataclasses.replace(out, planes=planes, rgb=rgb,
                                   idct_kernel=kernels,
                                   color_kernel=kernels and len(planes) > 1)


def run_sync(dev: Dict[str, torch.Tensor], shape: PlanShape, sync: str,
             decode_exits) -> SyncResult:
    """Run schedule ``sync`` with the bounds the JAX package gives it.

    Every bound is a capacity: inert lanes are stable from round 0.
    """
    sh = shape
    if sync == "jacobi":
        return jacobi_sync(dev, max_rounds=sh.n_chunks + 2,
                           decode_exits=decode_exits, permuted=sh.permuted)
    if sync == "specmap":
        # the hypothesis decodes count as rounds, so the verify budget adds
        # them to the longest truth-propagation chain
        return specmap_sync(dev, max_upm=MAX_UPM,
                            max_verify=sh.n_chunks + MAX_UPM + 2,
                            decode_exits=decode_exits, permuted=sh.permuted)
    if sync == "faithful":
        return faithful_sync(dev, seq_chunks=sh.seq_chunks,
                             max_outer=sh.n_sequences + 2,
                             decode_exits=decode_exits, permuted=sh.permuted)
    # sequential: one chunk per segment, so the cold decode is exact
    exits = decode_exits(dev, DecodeState.cold(dev["chunk_start"]))
    return SyncResult(exits, 1, True)


def decode_coefficients(dev: Dict[str, torch.Tensor], shape: PlanShape, *,
                        backend: str, fuse: str, sync: str = "jacobi"
                        ) -> Tuple[torch.Tensor, int, bool]:
    """The entropy stage on a padded plan's tensors.

    Returns ``(coeffs, sync_rounds, converged)`` with capacity-sized
    (``shape.n_units``, 64) coefficients. ``dev`` is
    ``dev_from_numpy(PlanData.arrays + words)`` of either package's plan.
    """
    sh = shape
    kernels = backend == "cuda"
    meta = D.chunk_meta(dev)
    kw = dict(s_max=sh.s_max, min_code_bits=sh.min_code_bits)
    exits_fn = HK.decode_exits if kernels else HK.decode_exits_plain

    def decode_exits(d, entry, idx=None):
        return exits_fn(d, meta, entry, idx, **kw)

    res = run_sync(dev, sh, check_sync(sync), decode_exits)
    # Output placement (Alg. 1 lines 7-8) and write pass (lines 9-15).
    # The final segment's write clamp is units_end, the real batch's
    # coefficient count; pad segments carry the same value.
    bases = D.chunk_write_bases(dev, res.exits.n, permuted=sh.permuted)
    seg_end = torch.cat([dev["seg_coeff_base"][1:], dev["units_end"][None]])
    write_max = seg_end[dev["chunk_seg"].to(torch.int64)] - 1
    entries = chain_entries(dev, res.exits, sh.permuted)
    if not kernels:  # decode_span(write=True)
        write_pass = decode_coeffs_store_plain
    elif fuse == "full":
        write_pass = decode_coeffs_store
    else:
        write_pass = HK.decode_coeffs
    out = write_pass(dev, meta, entries, bases, write_max, sh.n_units * 64,
                     **kw)
    coeffs = D.undiff_dc(dev, out.reshape(sh.n_units, 64))
    return coeffs, res.rounds, res.converged


def decode_batch(blobs: Sequence[bytes], chunk_bits: int = 1024,
                 seq_chunks: int = 32, sync: str = "jacobi",
                 emit: str = "rgb", backend: Optional[str] = None,
                 bucket: bool = True, fuse: Optional[str] = None,
                 device="cuda") -> DecodeOutput:
    """Parse, plan and decode one batch (see the module docstring)."""
    dec = ParallelDecoder.from_bytes(
        blobs, chunk_bits=chunk_bits, seq_chunks=seq_chunks, sync=sync,
        backend=backend, bucket=bucket, fuse=fuse, device=device)
    return dec.decode(emit=emit)
