"""Host-side batch planning for the parallel JPEG decoder (numpy).

A copy of the JAX package's ``core/bitstream.py`` planner, with its
non-throwing validation and quarantine lanes, the lane layout that
``dist.plan.balance_lanes`` permutes, and the multi-process consensus
(:func:`merge_plan_shapes`, :func:`consensus_plan`,
:func:`empty_batch_plan`): parse headers, extract tables, unstuff the
scan, and frame the bitstream into fixed-size *subsequences* ("chunks") —
only compressed bytes + small metadata cross the host->device link, which
is the paper's whole point.
:func:`dev_from_numpy` turns the planner's numpy arrays into the port's
tensors.

Terminology:
  segment  : an independently decodable entropy interval. One per image
             normally; restart markers split an image into multiple segments
             (each byte-aligned, DC prediction reset, MCU-aligned).
  chunk    : a `chunk_bits`-sized subsequence of a segment (paper: s*32 bits).
  sequence : `seq_chunks` adjacent chunks (paper: the thread-block unit b).
  tableset : deduplicated (Huffman LUT schedule, units-per-MCU) combination.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import contracts
from ..jpeg import tables as T
from ..jpeg.codec_ref import dct_matrix, scan_unit_layout
from ..jpeg.format import (JpegFormatError, JpegImage, pack_bits_to_words,
                           parse_jpeg, segment_byte_bounds, unstuff_scan)

MAX_UPM = 6  # max data units per MCU we support (4:2:0 -> 4+1+1)

# Per-image decode status (DecodeOutput.status / decode_stats counters).
STATUS_OK = 0          # clean parse, every restart segment intact
STATUS_RECOVERED = 1   # damaged scan; surviving restart segments decoded
STATUS_REJECTED = 2    # nothing decodable; replaced by an inert quarantine lane
STATUS_NAMES = ("ok", "recovered", "rejected")


# ---------------------------------------------------------------------------
# Non-throwing validation: classify blobs before planning
# ---------------------------------------------------------------------------

def expected_segments(img: JpegImage) -> int:
    """Restart segments a complete scan of ``img`` must contain."""
    if img.restart_interval:
        return -(-img.n_mcus // img.restart_interval)
    return 1


def _huffman_spec_error(spec, kind: str) -> Optional[str]:
    """Reject table specs that LUT construction or decoding cannot digest.

    A corrupt DHT parses fine but can carry an overfull code set (Kraft
    inequality violated — canonical code assignment walks off the 16-bit
    window) or DC symbols above 15 (the magnitude-category range the LUT
    entry packs into 4 bits).
    """
    counts = np.asarray(spec.bits, dtype=np.int64)
    kraft = int((counts * (1 << (15 - np.arange(16)))).sum())
    if kraft > (1 << 16):
        return (f"{kind} huffman table overfull "
                f"(kraft sum {kraft} > {1 << 16})")
    if kind == "dc" and len(spec.vals) and int(np.max(spec.vals)) > 15:
        return "dc huffman symbol above category 15"
    return None


def _decodable_error(img: JpegImage) -> Optional[str]:
    """Why a *parsed* image still cannot be decoded, or None if it can.

    ``parse_jpeg`` checks wire structure; this checks semantic
    completeness — geometry sanity and that every referenced quant /
    Huffman table actually arrived and is well formed.
    """
    if not img.components:
        return "no components"
    if img.width <= 0 or img.height <= 0:
        return f"bad dimensions {img.width}x{img.height}"
    for c in img.components:
        if not (1 <= c.h <= 4 and 1 <= c.v <= 4):
            return (f"component {c.comp_id} has illegal sampling "
                    f"{c.h}x{c.v}")
    if img.units_per_mcu > MAX_UPM:
        return (f"{img.units_per_mcu} data units per MCU exceeds the "
                f"supported {MAX_UPM}")
    for c in img.components:
        if c.quant_id not in img.quant_tables:
            return f"missing quant table {c.quant_id}"
        for kind, tid in (("dc", c.dc_table), ("ac", c.ac_table)):
            spec = img.huffman_specs.get((kind, tid))
            if spec is None:
                return f"missing {kind} huffman table {tid}"
            err = _huffman_spec_error(spec, kind)
            if err is not None:
                return err
    return None


@dataclasses.dataclass
class BlobReport:
    """Validation verdict for one JPEG blob (never an exception).

    ``status`` is STATUS_OK / STATUS_RECOVERED / STATUS_REJECTED; ``error``
    carries the diagnostic (with ``error_offset`` / ``error_marker`` byte
    context when the parser provided it). For decodable blobs the parsed
    image and the unstuffed scan ride along so the planner never redoes
    that work, and ``seg_ranges`` / ``seg_valid`` frame the scan into the
    *expected* restart-segment count: missing segments are empty ranges,
    ``seg_valid[i]`` marks segments that provably carry their original
    bits (damaged scans decode their surviving prefix; the suspect tail
    segment is decoded but masked invalid).
    """

    status: int
    error: Optional[str] = None
    error_offset: Optional[int] = None
    error_marker: Optional[int] = None
    image: Optional[JpegImage] = None
    clean: Optional[np.ndarray] = None       # unstuffed scan bytes (uint8)
    rst_bits: Optional[np.ndarray] = None    # restart bit offsets in clean
    seg_ranges: Optional[List[Tuple[int, int]]] = None  # byte spans, S_exp long
    seg_valid: Optional[np.ndarray] = None   # (S_exp,) bool
    n_segments_expected: int = 0
    n_segments_actual: int = 0


@dataclasses.dataclass
class BatchValidation:
    """Per-blob reports plus batch-level rollups for one batch."""

    reports: List[BlobReport]

    @property
    def status(self) -> np.ndarray:
        return np.array([r.status for r in self.reports], dtype=np.int32)

    @property
    def n_ok(self) -> int:
        return sum(r.status == STATUS_OK for r in self.reports)

    @property
    def n_recovered(self) -> int:
        return sum(r.status == STATUS_RECOVERED for r in self.reports)

    @property
    def n_rejected(self) -> int:
        return sum(r.status == STATUS_REJECTED for r in self.reports)

    @property
    def all_ok(self) -> bool:
        return all(r.status == STATUS_OK for r in self.reports)

    def errors(self) -> List[Tuple[int, str]]:
        """(image index, diagnostic) for every non-ok blob."""
        return [(i, r.error or STATUS_NAMES[r.status])
                for i, r in enumerate(self.reports)
                if r.status != STATUS_OK]


def validate_blob(blob: bytes) -> BlobReport:
    """Classify one JPEG blob without ever raising.

    ok        — parses clean, scan complete, all restart segments present.
    recovered — headers and tables intact but the scan is damaged
                (truncated, or the restart-segment count is off); the
                surviving segments are framed for decode with a validity
                mask over them.
    rejected  — structurally unparseable, or missing/corrupt tables:
                nothing decodable. The planner replaces it with an inert
                quarantine lane.
    """
    try:
        img = parse_jpeg(bytes(blob), allow_truncated=True)
    except JpegFormatError as e:
        return BlobReport(status=STATUS_REJECTED, error=str(e),
                          error_offset=e.offset, error_marker=e.marker)
    except Exception as e:  # pragma: no cover — hard wall, nothing escapes
        return BlobReport(status=STATUS_REJECTED,
                          error=f"{type(e).__name__}: {e}")
    err = _decodable_error(img)
    if err is not None:
        return BlobReport(status=STATUS_REJECTED, error=err)
    try:
        clean, rst_bits = unstuff_scan(img.scan_data)
        bounds = segment_byte_bounds(clean, rst_bits)
    except Exception as e:  # pragma: no cover — hard wall
        return BlobReport(status=STATUS_REJECTED,
                          error=f"{type(e).__name__}: {e}")
    s_act = len(bounds) - 1
    s_exp = expected_segments(img)
    anomalous = img.truncated or s_act != s_exp
    n_keep = min(s_act, s_exp)
    if anomalous and len(clean) == 0:
        return BlobReport(status=STATUS_REJECTED, error="empty scan data",
                          image=img, n_segments_expected=s_exp,
                          n_segments_actual=s_act)
    # Frame to exactly s_exp segments: kept segments take their actual
    # byte spans, missing ones are empty. When anomalous, every segment up
    # to (but not including) the last kept one ended at a genuine restart
    # marker and provably carries its original bits; the final kept
    # segment is decoded too (its prefix is real data) but masked invalid.
    seg_ranges = [(bounds[si], bounds[si + 1]) for si in range(n_keep)]
    seg_ranges += [(int(len(clean)), int(len(clean)))] * (s_exp - n_keep)
    ok_upto = s_exp if not anomalous else max(0, n_keep - 1)
    seg_valid = np.arange(s_exp) < ok_upto
    error = None
    if anomalous:
        what = "truncated scan" if img.truncated else "restart structure"
        error = (f"{what}: {s_act}/{s_exp} restart segments present, "
                 f"{ok_upto} intact")
    return BlobReport(
        status=STATUS_OK if not anomalous else STATUS_RECOVERED,
        error=error, image=img, clean=clean, rst_bits=rst_bits,
        seg_ranges=seg_ranges, seg_valid=seg_valid,
        n_segments_expected=s_exp, n_segments_actual=s_act,
    )


def validate_batch(blobs: Sequence[bytes]) -> BatchValidation:
    """Non-throwing classification of a whole batch (tentpole entry point)."""
    return BatchValidation([validate_blob(b) for b in blobs])



# ---------------------------------------------------------------------------
# Folded dequant + de-zigzag + IDCT operator (see DESIGN.md §3)
# ---------------------------------------------------------------------------

def folded_idct_matrix(quant_natural: np.ndarray) -> np.ndarray:
    """M (64x64) with  pixels_rowmajor = M @ coeff_zigzag  (before +128/clamp).

    M = (C^T (x) C^T) . diag(q_natural) . P_zigzag  — the paper's fused
    zigzag+dequant+IDCT kernel folded into a single 64x64 matrix product.
    """
    C = dct_matrix()
    K = np.kron(C.T, C.T)  # vec_row(C^T F C) = (C^T (x) C^T) vec_row(F)
    return (K @ np.diag(quant_natural.astype(np.float64)) @ T.ZIGZAG_PERM).astype(
        np.float32
    )


# ---------------------------------------------------------------------------
# Plan dataclass
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ImageGeometry:
    width: int
    height: int
    mcus_x: int
    mcus_y: int
    units_per_mcu: int
    n_units: int
    n_components: int
    comp_h: Tuple[int, ...]
    comp_v: Tuple[int, ...]
    h_max: int
    v_max: int

    @staticmethod
    def of(img: JpegImage) -> "ImageGeometry":
        return ImageGeometry(
            width=img.width,
            height=img.height,
            mcus_x=img.mcus_x,
            mcus_y=img.mcus_y,
            units_per_mcu=img.units_per_mcu,
            n_units=img.n_units,
            n_components=len(img.components),
            comp_h=tuple(c.h for c in img.components),
            comp_v=tuple(c.v for c in img.components),
            h_max=img.h_max,
            v_max=img.v_max,
        )



@dataclasses.dataclass
class BatchPlan:
    """Everything the device decoder needs, as host numpy arrays."""

    # --- static (python) ---------------------------------------------------
    chunk_bits: int
    seq_chunks: int
    s_max: int                      # decode loop bound per chunk
    min_code_bits: int
    n_images: int
    n_segments: int
    n_chunks: int
    total_units: int
    uniform: bool                   # all images share geometry
    geometry: Optional[ImageGeometry]  # set when uniform

    # --- shared tables -------------------------------------------------------
    words: np.ndarray               # (W,) uint32 packed clean bitstreams
    luts: np.ndarray                # (L, 65536) int32 decode LUTs
    unit_lut_row: np.ndarray        # (TS, MAX_UPM, 2) int32; [...,0]=AC, [...,1]=DC
    unit_comp_map: np.ndarray       # (TS, MAX_UPM) int32 component of unit slot
    ts_upm: np.ndarray              # (TS,) int32 units per MCU

    # --- per segment ---------------------------------------------------------
    seg_word_base: np.ndarray       # (S,) int32 word index of segment start
    seg_nbits: np.ndarray           # (S,) int32
    seg_tableset: np.ndarray        # (S,) int32
    seg_coeff_base: np.ndarray      # (S,) int64 dense coeff index of segment start
    seg_image: np.ndarray           # (S,) int32

    # --- per chunk -----------------------------------------------------------
    # Chunk arrays are indexed by *lane*. A lane holds one subsequence chunk;
    # by default lanes follow bitstream order, but a lane-permutation plan
    # (lane balancing, ROADMAP A9) may reorder them and append inert padding
    # lanes (limit == start, chunk_seq == -1) so every mesh lane gets an
    # equal, contiguous block. Chain adjacency is therefore *explicit*
    # (chunk_prev / chunk_next), never positional.
    chunk_seg: np.ndarray           # (C,) int32
    chunk_start: np.ndarray         # (C,) int32 bit offset in segment
    chunk_limit: np.ndarray         # (C,) int32 (end bit, clipped to seg_nbits)
    chunk_first: np.ndarray         # (C,) bool first chunk of its segment
    chunk_seq: np.ndarray           # (C,) int32 global sequence id (-1 inert)
    chunk_seq_first: np.ndarray     # (C,) bool first chunk of its sequence
    chunk_prev: np.ndarray          # (C,) int32 lane of predecessor chunk
                                    #   (self at segment starts / inert lanes)
    chunk_next: np.ndarray          # (C,) int32 lane of successor chunk
                                    #   (self at segment ends / inert lanes)
    lane_perm: np.ndarray           # (C,) int32 lane -> bitstream chunk id
                                    #   (ids >= n_real_chunks are inert)
    chunk_order: np.ndarray         # (C,) int32 bitstream chunk id -> lane
    n_real_chunks: int              # chunks that carry bits (excl. inert)
    balance: str                    # "none" | "roundrobin" | "lpt"
    n_sequences: int
    seq_last_chunk: np.ndarray      # (Q,) int32 lane of each sequence's last chunk

    # --- per unit (entropy->pixel bridge) -------------------------------------
    unit_comp: np.ndarray           # (U,) int32 component of each data unit
    unit_seg_first: np.ndarray      # (U,) bool first unit of a segment (DC reset)
    unit_mrow: np.ndarray           # (U,) int32 folded-IDCT matrix row id
    unit_image: np.ndarray          # (U,) int32
    m_matrices: np.ndarray          # (NQ, 64, 64) float32

    # --- pixel stage (uniform batches) ----------------------------------------
    comp_unit_idx: Optional[List[np.ndarray]]   # per comp: (Uc,) unit ids in image
    comp_block_idx: Optional[List[np.ndarray]]  # per comp: (Uc,) raster block ids
    comp_grid: Optional[List[Tuple[int, int]]]  # per comp: (blocks_y, blocks_x)

    # --- resilience (host-side, set when planned from a BatchValidation) ------
    # These never ship to the device and never enter PlanShape — quarantine
    # is pure PlanData (zero-bit segments), so it cannot mint compile keys.
    image_status: Optional[np.ndarray] = None  # (B,) int32 STATUS_* per image
    seg_valid: Optional[np.ndarray] = None     # (S,) bool segment carries
                                               #   its original bits
    unit_valid: Optional[np.ndarray] = None    # (U,) bool unit's coefficients
                                               #   are trustworthy


    # --- lane layout -----------------------------------------------------------
    # Mesh-lane blocks the lane axis is laid out for: lane balancing produces
    # n_lanes equal contiguous blocks of whole sequences; identity plans have
    # a single block. Capacity padding (build_plan_data) pads each block
    # independently so the per-device layout survives bucketing.
    n_lanes: int = 1

    def device_arrays(self) -> Dict[str, np.ndarray]:
        """The arrays shipped to the device (via :func:`dev_from_numpy`)."""
        return {
            "words": self.words,
            "luts": self.luts,
            "unit_lut_row": self.unit_lut_row,
            "unit_comp_map": self.unit_comp_map,
            "ts_upm": self.ts_upm,
            "seg_word_base": self.seg_word_base,
            "seg_nbits": self.seg_nbits,
            "seg_tableset": self.seg_tableset,
            "seg_coeff_base": self.seg_coeff_base.astype(np.int32),
            "chunk_seg": self.chunk_seg,
            "chunk_start": self.chunk_start,
            "chunk_limit": self.chunk_limit,
            "chunk_first": self.chunk_first,
            "chunk_seq": self.chunk_seq,
            "chunk_seq_first": self.chunk_seq_first,
            "chunk_prev": self.chunk_prev,
            "chunk_next": self.chunk_next,
            "lane_perm": self.lane_perm,
            "chunk_order": self.chunk_order,
            "seq_last_chunk": self.seq_last_chunk,
            "unit_comp": self.unit_comp,
            "unit_seg_first": self.unit_seg_first,
            "unit_mrow": self.unit_mrow,
            "m_matrices": self.m_matrices,
        }

    @property
    def compressed_bits(self) -> int:
        return int(self.seg_nbits.sum())


# ---------------------------------------------------------------------------
# Static plan geometry (PlanShape) vs streamed plan contents (PlanData)
# ---------------------------------------------------------------------------
#
# A `BatchPlan` mixes *geometry* (array extents, loop bounds) with
# *contents* (the words and metadata tables of one batch). `PlanShape` is
# the geometry, with capacities rounded up a geometric ladder (x LADDER_STEP
# per rung), and `PlanData` the contents padded to those capacities.
# Padding is bit-exact by construction:
#   words     : padded with a copy of the last real word — exactly the value
#               the exact-fit decode reads there anyway (out-of-bounds word
#               reads clamp to the final element), so even speculative
#               garbage decoding past the stream end sees identical bits;
#   segments  : zero-length pads (nbits 0) whose seg_coeff_base is the real
#               coefficient end, so the last real segment's write clamp is
#               unchanged ("units_end" carries it for the exact-capacity
#               case with no pad segment);
#   chunks    : inert lanes (start == limit == 0, chunk_first,
#               chunk_seq == -1, self-chained), inserted per lane block;
#   units     : pad units are segment-firsts of component 0 with zero
#               coefficients — the forward segmented scans (write bases,
#               DC undiff) never let them perturb the real prefix.

LADDER_STEP = 1.3


def check_seg_coeff_disjoint(seg_coeff_base, total_units: int,
                             what: str = "batch plan") -> None:
    """The segment-disjointness invariant the write kernels rely on.

    ``seg_coeff_base`` must start at 0, be non-decreasing, and stay
    inside the dense coefficient extent ``total_units * 64``. Because
    segment ``i``'s write clamp is ``seg_coeff_base[i+1] - 1`` (or
    ``units_end - 1`` for the last), monotone bases make every segment's
    writable coefficient range end exactly where the next begins — so
    lanes of *different* segments can never collide, which is one of the
    three legs of the write-pass scatter-race proof (docs/KERNELS.md) that
    lets the store kernel write without atomics. Checked at plan build so
    a violating plan never reaches a device.
    """
    b = np.asarray(seg_coeff_base, dtype=np.int64)
    if b.size == 0:
        return
    if b[0] != 0:
        raise contracts.ContractViolation(
            f"{what}: seg_coeff_base[0] = {int(b[0])} != 0")
    d = np.diff(b)
    if d.size and d.min() < 0:
        i = int(np.argmin(d))
        raise contracts.ContractViolation(
            f"{what}: seg_coeff_base not non-decreasing at segment {i}: "
            f"{int(b[i])} -> {int(b[i + 1])} — segment write ranges "
            f"would overlap and the bulk scatter could race")
    end = int(total_units) * 64
    if int(b[-1]) > end:
        raise contracts.ContractViolation(
            f"{what}: seg_coeff_base[-1] = {int(b[-1])} exceeds the "
            f"dense coefficient extent {end} (= {total_units} units * 64)")


def bucket_capacity(n: int, step: float = LADDER_STEP) -> int:
    """Smallest rung of the geometric capacity ladder that is >= ``n``.

    The ladder is the integer sequence 1, 2, 3, 4, 6, 8, 11, ... obtained
    by repeatedly multiplying by ``step`` and rounding up (always advancing
    by at least 1). Rounding capacities up this ladder bounds padding waste
    by ``step`` while collapsing a continuum of batch sizes onto a
    logarithmic number of compile keys.
    """
    if n <= 0:
        return 1
    c = 1
    while c < n:
        c = max(c + 1, int(np.ceil(c * step)))
    return c


@dataclasses.dataclass(frozen=True)
class PlanShape:
    """The static geometry of a batch plan: pure python ints/bools.

    Everything here is either a capacity (an array extent the data is
    padded to) or a constant of the decode (loop bounds, lane layout,
    pixel geometry). Hashable by construction.
    """

    # constants of the decode (loop bounds, lane layout)
    chunk_bits: int
    seq_chunks: int
    s_max: int
    min_code_bits: int
    n_lanes: int                 # mesh-lane blocks of the lane axis
    permuted: bool               # lane axis is a balance_lanes permutation
    # capacities (array extents; actual counts ride in PlanData)
    n_words: int
    n_luts: int
    n_tablesets: int
    n_matrices: int
    n_segments: int
    n_chunks: int                # lane capacity = n_lanes * block capacity
    n_sequences: int
    n_units: int
    # pixel stage (uniform batches decode to fixed-shape planes)
    n_images: int
    uniform: bool
    geometry: Optional[ImageGeometry]

    def label(self) -> str:
        """Compact human-readable bucket id for logs/stats."""
        geo = (f"{self.geometry.width}x{self.geometry.height}"
               if self.geometry is not None else "mixed")
        return (f"b{self.n_images}:{geo}:w{self.n_words}:s{self.n_segments}"
                f":c{self.n_lanes}x{self.block}:q{self.n_sequences}"
                f":u{self.n_units}:cb{self.chunk_bits}")

    @property
    def block(self) -> int:
        return self.n_chunks // self.n_lanes


def plan_shape(plan: BatchPlan, bucket: bool = True,
               step: float = LADDER_STEP) -> PlanShape:
    """The (optionally bucketed) PlanShape of a BatchPlan.

    ``bucket=False`` returns the exact-fit shape (capacity == actual count
    everywhere); padding against it is the identity, which is the oracle
    the bucketing tests compare against.
    """
    cap = (lambda n: bucket_capacity(n, step)) if bucket else (lambda n: n)
    assert plan.n_chunks % plan.n_lanes == 0
    if plan.balance == "none":
        assert plan.n_lanes == 1, "identity plans are single-block"
    block_cap = cap(plan.n_chunks // plan.n_lanes)
    shape = PlanShape(
        chunk_bits=plan.chunk_bits,
        seq_chunks=plan.seq_chunks,
        s_max=plan.s_max,
        min_code_bits=plan.min_code_bits,
        n_lanes=plan.n_lanes,
        permuted=plan.balance != "none",
        n_words=cap(len(plan.words)),
        n_luts=cap(plan.luts.shape[0]),
        n_tablesets=cap(plan.ts_upm.shape[0]),
        n_matrices=cap(plan.m_matrices.shape[0]),
        n_segments=cap(plan.n_segments),
        n_chunks=plan.n_lanes * block_cap,
        n_sequences=cap(plan.n_sequences),
        n_units=cap(plan.total_units),
        n_images=plan.n_images,
        uniform=plan.uniform,
        geometry=plan.geometry,
    )
    # build_batch_plan guards the *actual* counts; capacities are rounded
    # UP the bucket ladder, so the padded extents need their own check —
    # no decode may run on an overflowing shape
    contracts.check_shape_capacities(shape)
    return shape


@dataclasses.dataclass
class PlanData:
    """One batch's decoder operands, padded to a PlanShape's capacities.

    ``arrays`` is the device metadata; ``words`` ships separately, as in
    the JAX package. Actual (unpadded) counts ride along as host ints —
    ``total_units * 64`` is also in ``arrays`` as the scalar ``units_end``
    (the write clamp of the final real segment when no pad segment exists
    to carry it).
    """

    shape: PlanShape
    words: np.ndarray            # (shape.n_words,) uint32
    arrays: Dict[str, np.ndarray]
    # actual counts (host-side, for slicing)
    n_words: int
    n_segments: int
    n_chunks: int
    n_sequences: int
    total_units: int


def build_plan_data(plan: BatchPlan, shape: PlanShape) -> PlanData:
    """Pad a BatchPlan's device arrays to ``shape``'s capacities.

    Raises ``ValueError`` if the plan does not fit the shape (any actual
    count above capacity, or a mismatch in a constant of the decode).
    """
    statics = dict(chunk_bits=plan.chunk_bits, seq_chunks=plan.seq_chunks,
                   s_max=plan.s_max, min_code_bits=plan.min_code_bits,
                   n_lanes=plan.n_lanes, permuted=plan.balance != "none",
                   n_images=plan.n_images, uniform=plan.uniform,
                   geometry=plan.geometry)
    for k, v in statics.items():
        if getattr(shape, k) != v:
            raise ValueError(f"plan/shape mismatch on static {k}: "
                             f"{v!r} != {getattr(shape, k)!r}")
    counts = dict(n_words=len(plan.words), n_luts=plan.luts.shape[0],
                  n_tablesets=plan.ts_upm.shape[0],
                  n_matrices=plan.m_matrices.shape[0],
                  n_segments=plan.n_segments, n_chunks=plan.n_chunks,
                  n_sequences=plan.n_sequences, n_units=plan.total_units)
    for k, v in counts.items():
        if v > getattr(shape, k):
            raise ValueError(f"plan does not fit shape: {k}={v} exceeds "
                             f"capacity {getattr(shape, k)}")

    def pad1(a: np.ndarray, n: int, fill) -> np.ndarray:
        a = np.asarray(a)
        out = np.full((n,) + a.shape[1:], fill, dtype=a.dtype)
        out[: len(a)] = a
        return out

    units_end = plan.total_units * 64

    # words: pad with the final real word — the exact value out-of-bounds
    # gathers clamp to in the exact-fit plan, so even the stream-tail
    # speculative decode is bit-identical under padding
    words = pad1(plan.words, shape.n_words, plan.words[-1])

    # lane axis: pad each of the plan's n_lanes blocks to the shape's block
    # capacity with inert lanes
    block = plan.n_chunks // plan.n_lanes
    block_cap = shape.block
    c_cap = shape.n_chunks
    old = np.arange(plan.n_chunks, dtype=np.int64)
    relane = ((old // block) * block_cap + (old % block)).astype(np.int64)
    inert = np.ones(c_cap, dtype=bool)
    inert[relane] = False
    lanes = np.arange(c_cap, dtype=np.int32)

    def lane_ext(src: np.ndarray, fill) -> np.ndarray:
        src = np.asarray(src)
        out = np.full(c_cap, fill, dtype=src.dtype)
        out[relane] = src
        return out

    chunk_prev = lanes.copy()
    chunk_prev[relane] = relane[np.asarray(plan.chunk_prev, np.int64)]
    chunk_next = lanes.copy()
    chunk_next[relane] = relane[np.asarray(plan.chunk_next, np.int64)]
    # lane_perm stays a bijection lane <-> bitstream chunk id: mapped lanes
    # keep their ids, fresh inert lanes take the new ids [n_chunks, c_cap)
    lane_perm = np.empty(c_cap, dtype=np.int32)
    lane_perm[relane] = plan.lane_perm
    lane_perm[inert] = np.arange(plan.n_chunks, c_cap, dtype=np.int32)
    chunk_order = np.empty(c_cap, dtype=np.int32)
    chunk_order[lane_perm] = lanes
    # pad sequences point at the last real sequence's final chunk, whose
    # chunk_next is itself (segment end) — faithful_sync sees a boundary
    # that never needs syncing
    seq_last = relane[np.asarray(plan.seq_last_chunk, np.int64)]
    seq_last_chunk = pad1(seq_last.astype(np.int32), shape.n_sequences,
                          np.int32(seq_last[-1]))

    arrays = {
        "luts": pad1(plan.luts, shape.n_luts, 0),
        "unit_lut_row": pad1(plan.unit_lut_row, shape.n_tablesets, 0),
        "unit_comp_map": pad1(plan.unit_comp_map, shape.n_tablesets, 0),
        "ts_upm": pad1(plan.ts_upm, shape.n_tablesets, 1),
        "seg_word_base": pad1(plan.seg_word_base, shape.n_segments, 0),
        "seg_nbits": pad1(plan.seg_nbits, shape.n_segments, 0),
        "seg_tableset": pad1(plan.seg_tableset, shape.n_segments, 0),
        "seg_coeff_base": pad1(plan.seg_coeff_base.astype(np.int32),
                               shape.n_segments, np.int32(units_end)),
        "chunk_seg": lane_ext(plan.chunk_seg, 0),
        "chunk_start": lane_ext(plan.chunk_start, 0),
        "chunk_limit": lane_ext(plan.chunk_limit, 0),
        "chunk_first": lane_ext(plan.chunk_first, True),
        "chunk_seq": lane_ext(plan.chunk_seq, -1),
        "chunk_seq_first": lane_ext(plan.chunk_seq_first, True),
        "chunk_prev": chunk_prev.astype(np.int32),
        "chunk_next": chunk_next.astype(np.int32),
        "lane_perm": lane_perm,
        "chunk_order": chunk_order,
        "seq_last_chunk": seq_last_chunk,
        "unit_comp": pad1(plan.unit_comp, shape.n_units, 0),
        "unit_seg_first": pad1(plan.unit_seg_first, shape.n_units, True),
        "unit_mrow": pad1(plan.unit_mrow, shape.n_units, 0),
        "m_matrices": pad1(plan.m_matrices, shape.n_matrices, 0.0),
        # scalar actual count: the dense-coefficient end
        # of the real batch (write clamp of the final real segment)
        "units_end": np.asarray(units_end, dtype=np.int32),
    }
    return PlanData(
        shape=shape, words=words, arrays=arrays,
        n_words=len(plan.words), n_segments=plan.n_segments,
        n_chunks=plan.n_chunks, n_sequences=plan.n_sequences,
        total_units=plan.total_units,
    )


def split_plan(plan: BatchPlan, bucket: bool = True,
               step: float = LADDER_STEP) -> Tuple[PlanShape, PlanData]:
    """The compile-once decomposition: (static shape, streamed data)."""
    shape = plan_shape(plan, bucket=bucket, step=step)
    return shape, build_plan_data(plan, shape)


# ---------------------------------------------------------------------------
# Pinning a plan to a given shape
# ---------------------------------------------------------------------------
#
# A caller may pin the shape a plan decodes under (``ParallelDecoder(shape=)``:
# the decode service pins an admitted bucket). Two of its constants may
# relax soundly:
#   s_max          is only a loop *bound*; a lane stops decoding at its bit
#                  limit, so extra iterations are no-ops and any s_max >= the
#                  plan's own need is bit-identical.
#   min_code_bits  is the advance in the speculative garbage phase (invalid
#                  LUT window). Converged schedules emit from truth-propagated
#                  entries that decode only valid codewords, so the final
#                  coefficients do not depend on it; it only has to be small
#                  enough that s_max covers the worst garbage walk, which a
#                  shape covering the plan guarantees (s_max is the monotone
#                  function chunk_bits // min_code + 2 of the shared
#                  chunk_bits).

def consensus_plan(plan: BatchPlan, shape: PlanShape) -> BatchPlan:
    """Align a plan's constants of the decode to a shape that covers it.

    Returns a plan whose statics match ``shape`` exactly (so
    :func:`build_plan_data` accepts it) while its arrays are untouched:
    ``s_max``/``min_code_bits``/``n_images`` take the shape's values
    (bit-exact by the argument above), and the pixel-stage flags collapse
    to coeffs-only when the shape is not uniform. Raises when ``shape``
    does not cover this plan.
    """
    if plan.chunk_bits != shape.chunk_bits:
        raise ValueError(
            f"shape chunk_bits {shape.chunk_bits} != plan's "
            f"{plan.chunk_bits}")
    if plan.seq_chunks != shape.seq_chunks:
        raise ValueError(
            f"shape seq_chunks {shape.seq_chunks} != plan's "
            f"{plan.seq_chunks}")
    if plan.n_lanes != shape.n_lanes or (plan.balance != "none") != shape.permuted:
        raise ValueError(
            f"shape lane layout (n_lanes={shape.n_lanes}, "
            f"permuted={shape.permuted}) != plan's (n_lanes={plan.n_lanes}, "
            f"permuted={plan.balance != 'none'})")
    if shape.s_max < plan.s_max or shape.min_code_bits > plan.min_code_bits:
        raise ValueError(
            f"shape (s_max={shape.s_max}, min_code_bits="
            f"{shape.min_code_bits}) does not cover the plan (s_max="
            f"{plan.s_max}, min_code_bits={plan.min_code_bits})")
    if shape.n_images < plan.n_images:
        raise ValueError(
            f"shape n_images {shape.n_images} < plan's {plan.n_images}")
    kw = dict(s_max=shape.s_max, min_code_bits=shape.min_code_bits,
              n_images=shape.n_images)
    if not shape.uniform:
        kw.update(uniform=False, geometry=None)
    elif not (plan.uniform and plan.geometry == shape.geometry
              and plan.n_images == shape.n_images):
        raise ValueError(
            "the shape is uniform but this plan's geometry/image count "
            "differs: only a coefficients-only shape can cover it")
    return dataclasses.replace(plan, **kw)


# ---------------------------------------------------------------------------
# Multi-process bucket consensus: merge per-process PlanShapes
# ---------------------------------------------------------------------------
#
# In a multi-process launch (repro_torch.launch.multihost) every process
# plans only the JPEG bytes it holds, so their PlanShapes differ in
# capacities and Huffman-derived constants. The processes exchange ONLY
# these tiny shapes and take the elementwise max (`merge_plan_shapes`), so
# all of them land in the same bucket and decode in one program key; the
# compressed bytes never leave their process. A process then aligns its
# local plan's constants to the consensus (`consensus_plan`, by the
# argument above: the pair (min over processes of min_code_bits, max of
# s_max) is the self-consistent worst case, because s_max is the monotone
# function chunk_bits // min_code + 2 of the shared chunk_bits).

def merge_plan_shapes(shapes: Sequence[PlanShape]) -> PlanShape:
    """Elementwise-max consensus of per-process PlanShapes.

    Capacities (and ``s_max``/``n_images``) take the max, ``min_code_bits``
    the min; framing constants (``chunk_bits``, ``seq_chunks``) and the
    lane layout (``n_lanes``, ``permuted``) must agree across processes —
    a mismatch raises instead of producing a shape some process cannot
    decode. The pixel stage survives only when every process reports the
    same uniform geometry *and* image count; otherwise the merged shape is
    coeffs-only (``uniform=False``). Merging is commutative, associative,
    and idempotent, and merged capacities stay on the ladder (a max of
    rungs is a rung), so any exchange order converges to one bucket.
    """
    shapes = list(shapes)
    if not shapes:
        raise ValueError("merge_plan_shapes needs at least one shape")
    for k in ("chunk_bits", "seq_chunks", "n_lanes", "permuted"):
        vals = sorted({getattr(s, k) for s in shapes})
        if len(vals) > 1:
            raise ValueError(
                f"plan shapes disagree on {k}: {vals} — every process must "
                f"frame its batch with identical {k} (exchange/settle it "
                f"before planning, see repro_torch.launch.multihost)")
    first = shapes[0]
    uniform = (all(s.uniform for s in shapes)
               and len({s.geometry for s in shapes}) == 1
               and len({s.n_images for s in shapes}) == 1)

    def cap(k: str) -> int:
        return max(getattr(s, k) for s in shapes)

    merged = PlanShape(
        chunk_bits=first.chunk_bits,
        seq_chunks=first.seq_chunks,
        s_max=cap("s_max"),
        min_code_bits=min(s.min_code_bits for s in shapes),
        n_lanes=first.n_lanes,
        permuted=first.permuted,
        n_words=cap("n_words"),
        n_luts=cap("n_luts"),
        n_tablesets=cap("n_tablesets"),
        n_matrices=cap("n_matrices"),
        n_segments=cap("n_segments"),
        n_chunks=cap("n_chunks"),
        n_sequences=cap("n_sequences"),
        n_units=cap("n_units"),
        n_images=cap("n_images"),
        uniform=uniform,
        geometry=first.geometry if uniform else None,
    )
    # an elementwise max of per-process capacities (s_max up, n_units up)
    # can overflow where every constituent shape was fine — check the merge
    contracts.check_shape_capacities(merged)
    return merged


def empty_batch_plan(chunk_bits: int = 1024,
                     seq_chunks: int = 32) -> BatchPlan:
    """A decodable plan for a process holding zero JPEGs.

    A multi-process launch can leave some processes without local images
    (a corpus smaller than the process count, skewed feeds); they still
    take part in the bucket consensus and decode in the same program key.
    The empty plan is inert-lane-only: one zero-bit segment, one inert
    chunk (start == limit, ``chunk_seq == -1``, self-chained — the
    balance_lanes padding contract), zero units. Every sync schedule
    converges on it immediately and the write pass writes nothing
    (``units_end == 0`` clamps every store).

    ``min_code_bits`` is the loosest legal value (16) and ``s_max`` the
    matching bound — the consensus merge tightens both to the real
    processes' values; decoding the empty plan does not depend on them.
    """
    if chunk_bits % 32:
        raise ValueError(
            f"chunk size must be a multiple of 32 bits, got {chunk_bits}")
    min_code = 16
    return BatchPlan(
        chunk_bits=chunk_bits,
        seq_chunks=seq_chunks,
        s_max=chunk_bits // min_code + 2,
        min_code_bits=min_code,
        n_images=0,
        n_segments=1,
        n_chunks=1,
        total_units=0,
        uniform=False,
        geometry=None,
        words=np.zeros(1, np.uint32),
        luts=np.zeros((1, 1 << 16), np.int32),
        unit_lut_row=np.zeros((1, MAX_UPM, 2), np.int32),
        unit_comp_map=np.zeros((1, MAX_UPM), np.int32),
        ts_upm=np.ones(1, np.int32),
        seg_word_base=np.zeros(1, np.int32),
        seg_nbits=np.zeros(1, np.int32),
        seg_tableset=np.zeros(1, np.int32),
        seg_coeff_base=np.zeros(1, np.int64),
        seg_image=np.zeros(1, np.int32),
        chunk_seg=np.zeros(1, np.int32),
        chunk_start=np.zeros(1, np.int32),
        chunk_limit=np.zeros(1, np.int32),
        chunk_first=np.ones(1, bool),
        chunk_seq=np.full(1, -1, np.int32),
        chunk_seq_first=np.ones(1, bool),
        chunk_prev=np.zeros(1, np.int32),
        chunk_next=np.zeros(1, np.int32),
        lane_perm=np.zeros(1, np.int32),
        chunk_order=np.zeros(1, np.int32),
        n_real_chunks=0,
        balance="none",
        n_sequences=1,
        seq_last_chunk=np.zeros(1, np.int32),
        unit_comp=np.zeros(0, np.int32),
        unit_seg_first=np.zeros(0, bool),
        unit_mrow=np.zeros(0, np.int32),
        unit_image=np.zeros(0, np.int32),
        m_matrices=np.zeros((1, 64, 64), np.float32),
        comp_unit_idx=None,
        comp_block_idx=None,
        comp_grid=None,
    )


# ---------------------------------------------------------------------------
# Plan builder
# ---------------------------------------------------------------------------

def check_coeff_capacity(total_units: int, s_max: int = 0) -> None:
    """Reject batches whose dense coefficient index overflows int32.

    ``BatchPlan.device_arrays`` ships ``seg_coeff_base`` (and the write pass
    computes ``base + local`` offsets) as int32; a batch with
    ``total_units * 64 >= 2**31`` would silently wrap and corrupt write
    offsets. Fail loudly at plan time instead. With ``s_max`` the check
    also covers the speculative single-chunk write overshoot
    (``units_end + 64*s_max + 63`` — see ``core/contracts.py``).
    """
    contracts.checked_coeff_capacity(total_units, s_max=s_max)


def chain_adjacency(chunk_first: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(chunk_prev, chunk_next) in chunk-id space from segment-first flags.

    The single definition of chain adjacency: predecessor/successor follow
    bitstream order within a segment; segment-first chunks are their own
    predecessor and segment-last chunks their own successor (inert padding
    chunks, flagged first, therefore self-chain). ``build_batch_plan``
    uses this directly (identity lanes).
    """
    n = len(chunk_first)
    c_ids = np.arange(n, dtype=np.int32)
    prev_c = np.where(chunk_first, c_ids, c_ids - 1).astype(np.int32)
    next_is_first = np.concatenate([chunk_first[1:], [True]])
    next_c = np.where(next_is_first, c_ids, c_ids + 1).astype(np.int32)
    return prev_c, next_c


def _min_code_bits(specs) -> int:
    m = 16
    for spec in specs:
        nz = np.nonzero(spec.bits)[0]
        if len(nz):
            m = min(m, int(nz[0]) + 1)
    return max(1, m)


def build_batch_plan(
    blobs: Sequence[bytes],
    chunk_bits: int = 1024,
    seq_chunks: int = 32,
    parsed: Optional[Sequence[JpegImage]] = None,
    unstuffed: Optional[Sequence] = None,
    validation: Optional[BatchValidation] = None,
) -> BatchPlan:
    """Parse + frame a batch of JPEG files into a device-ready plan.

    ``parsed`` / ``unstuffed`` let a caller that already parsed the headers
    or unstuffed the scans (``unstuff_scan`` results, one per image, as
    the sequential schedule's chunk sizing does) share that work instead
    of redoing it here.

    ``validation`` (a :func:`validate_batch` result) switches planning to
    the resilient path: damaged blobs never raise. Recovered images are
    framed into their *expected* restart-segment count (missing segments
    become zero-bit segments that decode nothing), and rejected images are
    quarantined as inert lanes — in a geometry-uniform batch they borrow
    the first surviving image's segment/unit footprint with zero-bit
    segments, so the plan's extents match a clean batch of the same shape
    and the surviving images decode bit-identically to decoding them
    alone. Quarantine is pure plan *data* (zero-length segments use the
    exact machinery capacity padding already relies on), never plan
    *shape*, so it cannot mint new compile-cache entries. The plan's
    ``image_status`` / ``seg_valid`` / ``unit_valid`` record what is
    trustworthy.
    """
    assert chunk_bits % 32 == 0, "chunk size must be a multiple of 32 bits"
    if validation is not None:
        assert parsed is None and unstuffed is None, \
            "pass either validation or parsed/unstuffed, not both"
        reports = validation.reports
        n_images = len(reports)
        assert n_images > 0
        live = [r.status != STATUS_REJECTED and r.image is not None
                for r in reports]
        donor = next((i for i, r in enumerate(reports)
                      if live[i] and r.status == STATUS_OK), None)
        if donor is None:
            donor = next((i for i in range(n_images) if live[i]), None)
        images = [reports[i].image if live[i] else None
                  for i in range(n_images)]
    else:
        images = list(parsed) if parsed is not None else [parse_jpeg(b) for b in blobs]
        n_images = len(images)
        assert n_images > 0

    # ---- dedupe Huffman LUTs ------------------------------------------------
    lut_rows: Dict[Tuple[str, str], int] = {}   # (kind, digest) -> row
    luts: List[np.ndarray] = []
    all_specs = []

    def lut_row_for(kind: str, spec) -> int:
        key = (kind, spec.digest())
        if key not in lut_rows:
            lut_rows[key] = len(luts)
            luts.append(T.build_decode_lut(spec, is_dc=(kind == "dc")))
            all_specs.append(spec)
        return lut_rows[key]

    # ---- dedupe tablesets ----------------------------------------------------
    ts_keys: Dict[Tuple, int] = {}
    ts_lut_row: List[np.ndarray] = []
    ts_comp: List[np.ndarray] = []
    ts_upm: List[int] = []

    def tableset_for(img: JpegImage) -> int:
        ucomp = img.unit_component()
        upm = img.units_per_mcu
        assert upm <= MAX_UPM, f"units per MCU {upm} > {MAX_UPM}"
        rows = np.zeros((MAX_UPM, 2), dtype=np.int32)
        comps = np.zeros(MAX_UPM, dtype=np.int32)
        key_parts: List = [upm]
        for u in range(upm):
            c = img.components[ucomp[u]]
            ac = lut_row_for("ac", img.huffman_specs[("ac", c.ac_table)])
            dc = lut_row_for("dc", img.huffman_specs[("dc", c.dc_table)])
            rows[u, 0], rows[u, 1] = ac, dc
            comps[u] = ucomp[u]
            key_parts += [ac, dc, int(ucomp[u])]
        key = tuple(key_parts)
        if key not in ts_keys:
            ts_keys[key] = len(ts_upm)
            ts_lut_row.append(rows)
            ts_comp.append(comps)
            ts_upm.append(upm)
        return ts_keys[key]

    # ---- dedupe quant (folded IDCT) matrices ---------------------------------
    m_keys: Dict[bytes, int] = {}
    m_mats: List[np.ndarray] = []

    def mrow_for(q: np.ndarray) -> int:
        key = q.astype(np.int32).tobytes()
        if key not in m_keys:
            m_keys[key] = len(m_mats)
            m_mats.append(folded_idct_matrix(q))
        return m_keys[key]

    # ---- walk images: segments, words, units ---------------------------------
    word_chunks: List[np.ndarray] = []
    word_pos = 0
    seg_word_base, seg_nbits, seg_tableset, seg_image = [], [], [], []
    seg_n_units: List[int] = []
    unit_comp_l, unit_seg_first_l, unit_mrow_l, unit_image_l = [], [], [], []
    seg_valid_l: List[np.ndarray] = []
    unit_valid_l: List[np.ndarray] = []

    live_geoms = [ImageGeometry.of(img) for img in images if img is not None]
    uniform = bool(live_geoms) and all(g == live_geoms[0] for g in live_geoms)
    geometry = live_geoms[0] if uniform else None
    layout_img = None
    if uniform:
        layout_img = next(img for img in images if img is not None)

    empty_clean = np.zeros(0, dtype=np.uint8)
    for ii in range(n_images):
        img = images[ii]
        if validation is not None:
            r = reports[ii]
            if img is not None:
                clean, ranges, valid = r.clean, r.seg_ranges, r.seg_valid
            elif uniform:
                # quarantine: inert lanes borrowing the donor's footprint —
                # zero-bit segments with the donor's full unit slots, so
                # the plan's segment/unit extents match a clean batch
                img = images[donor]
                s_exp = expected_segments(img)
                clean, ranges = empty_clean, [(0, 0)] * s_exp
                valid = np.zeros(s_exp, dtype=bool)
            else:
                # no donor geometry to borrow: one empty, zero-unit segment
                clean, ranges = empty_clean, [(0, 0)]
                valid = np.zeros(1, dtype=bool)
        else:
            clean, rst_bits = (unstuffed[ii] if unstuffed is not None
                               else unstuff_scan(img.scan_data))
            # segment boundaries in the clean stream (byte aligned)
            bounds = segment_byte_bounds(clean, rst_bits)
            ranges = [(bounds[si], bounds[si + 1])
                      for si in range(len(bounds) - 1)]
            valid = np.ones(len(ranges), dtype=bool)

        if img is not None:
            ts = tableset_for(img)
            upm = img.units_per_mcu
            ucomp = img.unit_component()
            comp_mrow = np.array(
                [mrow_for(img.quant_tables[c.quant_id]) for c in img.components],
                dtype=np.int32,
            )
            if img.restart_interval:
                units_per_interval = img.restart_interval * upm
            else:
                units_per_interval = img.n_units
            remaining_units = img.n_units
        else:
            ts, upm = 0, 1
            ucomp = np.zeros(1, dtype=np.int32)
            comp_mrow = np.zeros(1, dtype=np.int32)
            units_per_interval = remaining_units = 0
        for si, (b0, b1) in enumerate(ranges):
            seg_bytes = clean[b0:b1]
            words = pack_bits_to_words(seg_bytes)
            seg_word_base.append(word_pos)
            word_chunks.append(words)
            word_pos += len(words)
            seg_nbits.append(len(seg_bytes) * 8)
            seg_tableset.append(ts)
            seg_image.append(ii)
            n_u = min(units_per_interval, remaining_units)
            remaining_units -= n_u
            seg_n_units.append(n_u)
            # per-unit metadata for this segment
            uc = ucomp[np.arange(n_u) % upm]
            unit_comp_l.append(uc)
            first = np.zeros(n_u, dtype=bool)
            if n_u:
                first[0] = True
            unit_seg_first_l.append(first)
            unit_mrow_l.append(comp_mrow[uc])
            unit_image_l.append(np.full(n_u, ii, dtype=np.int32))
            unit_valid_l.append(np.full(n_u, bool(valid[si])))
        seg_valid_l.append(np.asarray(valid, dtype=bool))
        assert remaining_units == 0, "restart segmentation lost units"

    words = np.concatenate(word_chunks)
    n_segments = len(seg_nbits)
    seg_nbits = np.array(seg_nbits, dtype=np.int32)
    seg_word_base = np.array(seg_word_base, dtype=np.int32)
    seg_tableset = np.array(seg_tableset, dtype=np.int32)
    seg_image = np.array(seg_image, dtype=np.int32)
    seg_units = np.array(seg_n_units, dtype=np.int64)
    seg_coeff_base = np.concatenate([[0], np.cumsum(seg_units)[:-1]]) * 64

    # ---- chunk framing --------------------------------------------------------
    seg_n_chunks = np.maximum(1, -(-seg_nbits // chunk_bits))
    chunk_seg = np.repeat(np.arange(n_segments, dtype=np.int32), seg_n_chunks)
    in_seg = np.concatenate([np.arange(k, dtype=np.int32) for k in seg_n_chunks])
    chunk_start = in_seg * chunk_bits
    chunk_limit = np.minimum(chunk_start + chunk_bits, seg_nbits[chunk_seg])
    chunk_first = in_seg == 0
    # sequences: groups of seq_chunks chunks, never straddling a segment
    seq_in_seg = in_seg // seq_chunks
    seg_n_seqs = -(-seg_n_chunks // seq_chunks)
    seq_base = np.concatenate([[0], np.cumsum(seg_n_seqs)[:-1]])
    chunk_seq = (seq_base[chunk_seg] + seq_in_seg).astype(np.int32)
    chunk_seq_first = (in_seg % seq_chunks) == 0
    n_sequences = int(seg_n_seqs.sum())
    # last chunk id of each sequence
    seq_last_chunk = np.zeros(n_sequences, dtype=np.int32)
    seq_last_chunk[chunk_seq] = np.arange(len(chunk_seg), dtype=np.int32)

    # explicit chain adjacency (identity layout: lane == bitstream chunk id)
    n_chunks = int(len(chunk_seg))
    c_ids = np.arange(n_chunks, dtype=np.int32)
    chunk_prev, chunk_next = chain_adjacency(chunk_first)

    min_code = _min_code_bits(all_specs)
    s_max = chunk_bits // min_code + 2

    total_units = int(seg_units.sum())
    check_coeff_capacity(total_units, s_max=int(s_max))
    check_seg_coeff_disjoint(seg_coeff_base, total_units)

    # ---- pixel-stage layout (uniform batches) ---------------------------------
    comp_unit_idx = comp_block_idx = comp_grid = None
    if uniform:
        layout = scan_unit_layout(layout_img)
        comp_unit_idx, comp_block_idx, comp_grid = [], [], []
        for ci, c in enumerate(layout_img.components):
            sel = np.where(layout["comp"] == ci)[0]
            comp_unit_idx.append(sel.astype(np.int32))
            comp_block_idx.append(layout["block_idx"][sel].astype(np.int32))
            comp_grid.append((layout_img.mcus_y * c.v, layout_img.mcus_x * c.h))

    return BatchPlan(
        chunk_bits=chunk_bits,
        seq_chunks=seq_chunks,
        s_max=int(s_max),
        min_code_bits=min_code,
        n_images=n_images,
        n_segments=n_segments,
        n_chunks=n_chunks,
        total_units=total_units,
        uniform=uniform,
        geometry=geometry,
        words=words,
        luts=np.stack(luts) if luts else np.zeros((1, 1 << 16), np.int32),
        unit_lut_row=(np.stack(ts_lut_row) if ts_lut_row
                      else np.zeros((1, MAX_UPM, 2), np.int32)),
        unit_comp_map=(np.stack(ts_comp) if ts_comp
                       else np.zeros((1, MAX_UPM), np.int32)),
        ts_upm=(np.array(ts_upm, dtype=np.int32) if ts_upm
                else np.ones(1, np.int32)),
        seg_word_base=seg_word_base,
        seg_nbits=seg_nbits,
        seg_tableset=seg_tableset,
        seg_coeff_base=seg_coeff_base.astype(np.int64),
        seg_image=seg_image,
        chunk_seg=chunk_seg,
        chunk_start=chunk_start.astype(np.int32),
        chunk_limit=chunk_limit.astype(np.int32),
        chunk_first=chunk_first,
        chunk_seq=chunk_seq,
        chunk_seq_first=chunk_seq_first,
        chunk_prev=chunk_prev,
        chunk_next=chunk_next,
        lane_perm=c_ids.copy(),
        chunk_order=c_ids.copy(),
        n_real_chunks=n_chunks,
        balance="none",
        n_sequences=n_sequences,
        seq_last_chunk=seq_last_chunk,
        unit_comp=np.concatenate(unit_comp_l).astype(np.int32),
        unit_seg_first=np.concatenate(unit_seg_first_l),
        unit_mrow=np.concatenate(unit_mrow_l).astype(np.int32),
        unit_image=np.concatenate(unit_image_l),
        m_matrices=(np.stack(m_mats) if m_mats
                    else np.zeros((1, 64, 64), np.float32)),
        comp_unit_idx=comp_unit_idx,
        comp_block_idx=comp_block_idx,
        comp_grid=comp_grid,
        image_status=(validation.status if validation is not None else None),
        seg_valid=(np.concatenate(seg_valid_l)
                   if validation is not None else None),
        unit_valid=(np.concatenate(unit_valid_l)
                    if validation is not None else None),
    )


# ---------------------------------------------------------------------------
# Carrying a plan across: numpy arrays -> the port's tensors
# ---------------------------------------------------------------------------

def segment_starts(first: np.ndarray) -> np.ndarray:
    """(N,) int64: for each position, the position of its segment's first
    element, the latest set flag at or before it (position 0 always starts
    a segment)."""
    pos = np.arange(len(first), dtype=np.int64)
    return np.maximum.accumulate(np.where(first, pos, 0))


def derived_arrays(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """What the decoder reads besides the plan arrays, derived once per plan.

    * ``chunk_seg_start``: in bitstream chunk order (``chunk_order``), the
      position of each chunk's segment-first chunk, for the write-base scan;
    * ``unit_seg_start``: each unit's segment-first unit, for DC undiff;
    * ``m_matrices_t``: the folded operators transposed, ``(NQ, j, k)``,
      the layout the pixel kernel reads.
    """
    out = {}
    if "chunk_first" in arrays:
        first = np.asarray(arrays["chunk_first"])
        order = arrays.get("chunk_order")
        out["chunk_seg_start"] = segment_starts(
            first if order is None else first[np.asarray(order)])
    if "unit_seg_first" in arrays:
        out["unit_seg_start"] = segment_starts(
            np.asarray(arrays["unit_seg_first"]))
    if "m_matrices" in arrays:
        out["m_matrices_t"] = np.ascontiguousarray(
            np.asarray(arrays["m_matrices"]).transpose(0, 2, 1))
    return out


def dev_from_numpy(arrays: Dict[str, np.ndarray],
                   device) -> Dict[str, torch.Tensor]:
    """Tensors on ``device`` for a dict of plan arrays, plus
    :func:`derived_arrays` of them.

    Takes ``BatchPlan.device_arrays()`` or ``PlanData.arrays`` (plus
    ``words``) of this package or of the JAX package alike, so one plan
    can feed both decoders. Values keep their dtypes except ``uint32``,
    which torch cannot shift: such arrays (the packed ``words``) arrive
    as ``int32`` tensors of the same bits, which the kernels read as
    ``uint32_t`` and the plain versions widen to int64.
    """
    out = {}
    for k, a in {**arrays, **derived_arrays(arrays)}.items():
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[k] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return out
