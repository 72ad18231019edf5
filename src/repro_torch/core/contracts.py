"""The decode pipeline's contracts, as data and checks.

A copy of what the port needs of the JAX package's ``analysis/contracts.py``:

* the runtime int32 guards (``ContractViolation``, ``checked_int32``,
  ``checked_coeff_capacity``, ``check_shape_capacities``): the planner in
  :mod:`repro_torch.core.bitstream` calls them so that no plan whose dense
  coefficient index or bit position overflows int32 reaches a kernel;
* the int32 index lattice (:class:`IntRange`, :func:`plan_index_ranges`,
  :func:`check_index_lattice`, :func:`max_damaged_segment_chunks`), which
  bounds every index expression of the decode at a shape's capacities;
* lane-graph liveness (:data:`LANE_GRAPH_ARRAYS`,
  :data:`IDENTITY_LIVE_OK`): which lane-graph operands an identity plan's
  program may index through, per sync schedule;
* the catalogs of the traced-program checker (:data:`TRACE_CONTRACTS`,
  ``analysis/trace_check.py``) and the kernel verifier
  (:data:`KERNEL_CHECK_FAMILIES`).

Stdlib only; shape arguments are duck-typed on attribute names.
"""
from __future__ import annotations

from typing import Dict, Mapping

INT32_MIN = -(2 ** 31)
INT32_MAX = 2 ** 31 - 1


class ContractViolation(ValueError):
    """A decode-pipeline contract does not hold.

    Subclasses ``ValueError`` so pre-existing callers of the runtime
    guards (which raised plain ``ValueError``) keep working.
    """


def checked_int32(value: int, what: str, hint: str = "") -> int:
    """Return ``value`` if it fits a signed 32-bit int, else raise.

    ``what`` names the quantity in the error ("write index bound", ...);
    ``hint`` optionally tells the caller how to get back under the limit
    ("split the batch below N units").
    """
    if not INT32_MIN <= value <= INT32_MAX:
        msg = (f"{what} = {value} overflows int32 "
               f"[{INT32_MIN}, {INT32_MAX}]")
        if hint:
            msg += f". {hint}"
        raise ContractViolation(msg)
    return value


# Write-pass headroom: one chunk's speculative decode can overshoot its
# segment's true coefficient range by at most s_max symbols x 64
# coefficients, plus a final zero-run of up to 63 positions. The write
# index `write_base + st.n + o.run` must stay in int32 through that
# overshoot *before* the `idx < write_max` clamp compares it.
def write_overshoot(s_max: int) -> int:
    return 64 * s_max + 63


def checked_coeff_capacity(total_units: int, s_max: int = 0) -> int:
    """The batch-size guard: dense coefficient indexing fits int32.

    ``total_units * 64`` is the dense coefficient extent
    (``seg_coeff_base`` entries, the ``units_end`` write clamp, and the
    write-buffer sentinel all reach it). With ``s_max`` given, the bound
    also covers the speculative single-chunk overshoot past the final
    segment end (see :func:`write_overshoot`) — the largest int32 the
    compiled write pass can actually compute.
    """
    units_end = total_units * 64
    hint = (f"Split the batch below {INT32_MAX // 64} units.")
    checked_int32(units_end, f"batch of {total_units} data units -> "
                  f"{units_end} dense coefficients", hint)
    if s_max:
        checked_int32(units_end + write_overshoot(s_max),
                      f"write-index bound units_end + 64*s_max + 63 "
                      f"({units_end} + {write_overshoot(s_max)})", hint)
    return total_units


def check_shape_capacities(shape) -> None:
    """Runtime guard over a PlanShape's *capacities* (not actual counts).

    ``build_batch_plan`` checks the actual unit count, but bucketing
    rounds capacities UP a geometric ladder — a batch whose true count
    passes the runtime guard can still land in a bucket whose padded
    capacity products overflow. Called from ``plan_shape`` and
    ``merge_plan_shapes`` so no compiled program ever exists for an
    overflowing shape. Duck-typed: ``shape`` needs ``n_units``,
    ``s_max``, ``n_words``, ``n_chunks``.
    """
    hint = "Use a smaller batch or a finer bucket ladder."
    # dense coefficient extent + speculative write overshoot
    checked_int32(shape.n_units * 64 + write_overshoot(shape.s_max),
                  f"bucketed write-index bound n_units*64 + 64*s_max + 63 "
                  f"({shape.n_units}*64 + {write_overshoot(shape.s_max)})",
                  hint)
    # bit positions: p ranges over [0, 32*n_words] and one extra symbol
    # advance (<= 31 code+magnitude bits) past the limit check
    checked_int32(shape.n_words * 32 + 63,
                  f"bit-position bound n_words*32 + 63 ({shape.n_words}*32)",
                  hint)
    # lane axis: chunk ids and the chain permutations are int32
    checked_int32(shape.n_chunks, f"lane capacity n_chunks", hint)



# ---------------------------------------------------------------------------
# What the kernel verifier needs (analysis/kernel_check.py)
# ---------------------------------------------------------------------------

class IntRange:
    """A closed integer interval [lo, hi]: the abstract value of an index.

    The JAX package's lattice (``analysis/contracts.IntRange``), the part
    the port's checkers use: constants, + and *, and the int32 check."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo: int, hi: int):
        if lo > hi:
            raise ValueError(f"empty IntRange [{lo}, {hi}]")
        self.lo, self.hi = lo, hi

    def __eq__(self, other) -> bool:
        return isinstance(other, IntRange) and (self.lo, self.hi) == (
            other.lo, other.hi)

    def __hash__(self) -> int:
        return hash((self.lo, self.hi))

    def __repr__(self) -> str:
        return f"IntRange({self.lo}, {self.hi})"

    @staticmethod
    def const(n: int) -> "IntRange":
        return IntRange(n, n)

    def __add__(self, other: "IntRange") -> "IntRange":
        return IntRange(self.lo + other.lo, self.hi + other.hi)

    def __mul__(self, other: "IntRange") -> "IntRange":
        ps = (self.lo * other.lo, self.lo * other.hi,
              self.hi * other.lo, self.hi * other.hi)
        return IntRange(min(ps), max(ps))

    @property
    def fits_int32(self) -> bool:
        return INT32_MIN <= self.lo and self.hi <= INT32_MAX

    def check(self, what: str) -> "IntRange":
        checked_int32(self.lo, f"{what} (lower bound)")
        checked_int32(self.hi, f"{what} (upper bound)")
        return self


# ---------------------------------------------------------------------------
# The int32 index lattice (analysis/trace_check.py's int32-lattice)
# ---------------------------------------------------------------------------

def plan_index_ranges(shape, model: str = "valid") -> Dict[str, IntRange]:
    """Bound every int32 index expression of the decoder.

    Returns ``{expression name: IntRange}`` as a function of the shape's
    capacities, under one of two bitstream models:

    ``model="valid"``
        Well-formed (or validated/masked) bitstreams: every chunk's
        converged exit count equals the true symbol count, so a write
        base never exceeds its segment's coefficient range and only the
        *active* chunk overshoots speculatively (by
        :func:`write_overshoot`).

    ``model="adversarial"``
        No convergence assumption: a damaged segment's chunks can each
        exit with up to ``64 * s_max`` phantom coefficient positions, so
        the cumulative write base of a segment spanning ``k`` chunks
        grows as ``k * 64 * s_max``. :func:`max_damaged_segment_chunks`
        gives the largest ``k`` that stays safe; ``validate_batch``'s
        segment masking keeps real damaged inputs inside the valid
        model, so this bound is the residual exposure for *unvalidated*
        adversarial feeds.
    """
    if model not in ("valid", "adversarial"):
        raise ValueError(f"unknown lattice model {model!r}")
    units_end = IntRange(0, shape.n_units * 64)
    over = IntRange(0, write_overshoot(shape.s_max))
    if model == "valid":
        write_base = units_end
    else:
        phantom = IntRange(0, shape.n_chunks * 64 * shape.s_max)
        write_base = units_end + phantom
    return {
        "units_end": units_end,
        "seg_coeff_base": units_end,
        "write_base": write_base,
        # idx = write_base + st.n (<= 64*s_max) + o.run (<= 63)
        "write_index": write_base + over,
        # bit position: within [0, 32*n_words] plus one symbol advance
        "bit_position": IntRange(0, shape.n_words * 32 + 63),
        # word fetch: word_base + (p >> 5) + 1
        "word_fetch": IntRange(0, shape.n_words + (63 >> 5) + 1),
        "lane_index": IntRange(0, shape.n_chunks - 1),
        "sentinel": IntRange(0, shape.n_units * 64),
    }


def check_index_lattice(shape, model: str = "valid") -> None:
    """Raise :class:`ContractViolation` unless every lattice range of
    ``shape`` fits int32."""
    for name, rng in plan_index_ranges(shape, model=model).items():
        rng.check(f"{model}-model {name} at capacities of {_label(shape)}")


def max_damaged_segment_chunks(shape) -> int:
    """Largest chunk count of one unvalidated damaged segment for which
    the adversarial write base still cannot wrap int32."""
    per_chunk = 64 * shape.s_max
    head = INT32_MAX - shape.n_units * 64 - write_overshoot(shape.s_max)
    return max(0, head // per_chunk)


def _label(shape) -> str:
    lab = getattr(shape, "label", None)
    return lab() if callable(lab) else repr(shape)


# ---------------------------------------------------------------------------
# Lane-graph liveness (the identity-lane-graph contract)
# ---------------------------------------------------------------------------

#: The plan operands that encode the lane permutation and chain adjacency.
#: On identity plans (``permuted=False``) the decode uses the shift and
#: direct-scan forms instead of indexing through these arrays.
LANE_GRAPH_ARRAYS = ("chunk_prev", "chunk_next", "lane_perm", "chunk_order")

#: Per sync schedule: the lane-graph operands an *identity* program may
#: index through. ``faithful`` walks the chain through ``chunk_next`` by
#: construction (its chain step is the algorithm, not creep); the other
#: three schedules must not touch the graph at all when ``permuted=False``.
IDENTITY_LIVE_OK: Mapping[str, frozenset] = {
    "jacobi": frozenset(),
    "faithful": frozenset({"chunk_next"}),
    "sequential": frozenset(),
    "specmap": frozenset(),
}


def identity_live_ok(sync: str) -> frozenset:
    try:
        return IDENTITY_LIVE_OK[sync]
    except KeyError:
        raise ContractViolation(
            f"no lane-graph liveness entry for sync schedule {sync!r}; "
            f"add it to contracts.IDENTITY_LIVE_OK") from None


#: The traced-program checker's contracts (``python -m repro_torch.analysis
#: contracts``), as data: name -> description. The JAX package's
#: ``JAXPR_CONTRACTS`` in their torch form; the two of ``MESH_CONTRACTS``
#: run on a decode over a mesh.
TRACE_CONTRACTS: Dict[str, str] = {
    "identity-lane-graph": (
        "identity (permuted=False) programs never index through lane-graph "
        "operands outside IDENTITY_LIVE_OK[sync]: a dispatch mode taints "
        "the plan buffers of LANE_GRAPH_ARRAYS and follows the taint "
        "through every aten op and kernel launch of a decode; permuted "
        "programs must show a tainted index (flip check)"),
    "no-f64": "no float64 tensor in or out of any op of the entropy stage",
    "no-host-read": (
        "between the plan upload and the entropy stage's return the only "
        "reads to the host are core.sync.host_check's, as many as the "
        "decode's RoundBlocks.checks (no .item(), nonzero, boolean-mask "
        "index or copy to the CPU; on the card the syncs that "
        "torch.cuda.set_sync_debug_mode sees, counted too)"),
    "graph-buffers": (
        "every CUDA graph of a program's sync rounds holds only kernel, "
        "memset and device-to-device copy nodes, two of them the exit "
        "kernel's; before each replay those exit nodes read and write the "
        "program's buffers and compact tables at their current addresses "
        "(or the graph's own temporaries); after it the exits lie in one "
        "of the program's two exit buffers; and nothing a decode returns "
        "shares storage with a program buffer"),
    "int32-lattice": (
        "plan index arithmetic cannot overflow int32 at the shape's "
        "(bucketed) capacities under the valid-bitstream model, the "
        "largest ladder rung the runtime guard admits included, and the "
        "adversarial headroom bound is reported"),
    "collective-accounting": (
        "on a decode over a mesh of two blocks or more: the bytes of the "
        "copies from one block's buffers into another's, counted by the "
        "taint tracker by the buffer they land in, equal the mesh "
        "program's own account from its layout (per exchange of the "
        "rounds and per write pass), and each block's lane-graph taint "
        "reaches the halo of every block that reads it"),
    "words-donated-mesh": (
        "on a decode over a mesh of two blocks or more, the mesh half of "
        "the JAX package's words-donated: nothing returned shares storage "
        "with any block's buffers, and on the card each block's round "
        "graphs read only that block's buffers and compact tables (or "
        "the graph's own memory)"),
}

#: The contracts of TRACE_CONTRACTS that run on a decode over a mesh of
#: two blocks or more (``analysis.trace_check.check_mesh``): not
#: applicable on one block, and reported as not run, never as passed,
#: where no mesh was checked.
MESH_CONTRACTS = ("collective-accounting", "words-donated-mesh")


def check_block_cover(extent: int, tile: int, blocks: int, what: str,
                      masked: bool = True) -> None:
    """The tiling contract of one launch over one operand dimension.

    ``blocks`` blocks (or tiles) of ``tile`` items each, block ``b`` at
    origin ``b * tile`` (the origins an :class:`IntRange`, as the JAX
    package's ``tile_origin_range``); raises :class:`ContractViolation`
    unless

    * **cover**: every item is reached (``blocks * tile >= extent``): a
      grid that stops short leaves the rest unwritten;
    * **no empty block**: the last block starts inside the dimension
      (``(blocks - 1) * tile < extent``);
    * where the kernel does not mask its ragged edge (``masked=False``,
      the Pallas kind), **divisibility** and an exact fit
      (``blocks * tile == extent``).
    """
    if tile < 1 or blocks < 0:
        raise ContractViolation(f"{what}: tile {tile}, blocks {blocks}")
    if extent <= 0:
        if blocks:
            raise ContractViolation(
                f"{what}: {blocks} block(s) over an empty dimension")
        return
    if blocks == 0:
        raise ContractViolation(f"{what}: no block covers {extent}")
    origins = IntRange(0, blocks - 1) * IntRange.const(tile)
    end = (origins + IntRange.const(tile)).hi  # past the last block
    if end < extent:
        raise ContractViolation(
            f"{what}: {blocks} block(s) x tile {tile} cover {end} of "
            f"{extent} (the rest is never written)")
    if origins.hi >= extent:
        raise ContractViolation(
            f"{what}: block {blocks - 1} starts at {origins.hi}, past the "
            f"dimension's {extent}")
    if not masked and end != extent:
        raise ContractViolation(
            f"{what}: tile {tile} does not divide {extent} and the "
            f"kernel does not mask its edge")


#: The families of the kernel verifier (``python -m repro_torch.analysis
#: kernels``), as the JAX package names them.
KERNEL_CHECK_FAMILIES = {
    "kernel-bounds": (
        "every global and shared access of the six kernels runs through "
        "the checked build's guard (csrc/check.cuh) and its record is "
        "empty after every launch, on real batches under every launch "
        "candidate; the seeded off-by-one row read (S1) is flagged"),
    "kernel-scatter-race": (
        "the write pass's scatter (ops.scatter_streams) has duplicate-free "
        "targets other than its sentinel, each lane's positions strictly "
        "increase, and the segments' coefficient ranges are disjoint "
        "(bitstream.check_seg_coeff_disjoint); a duplicate-index scatter "
        "is flagged"),
    "kernel-tiling": (
        "each kernel's blocks cover its lanes, units and MCUs exactly on "
        "every bucket-ladder rung under every launch candidate (the C++ "
        "geometry of csrc/geometry.cuh, run on the host), and on the card "
        "every output element of the IDCT, pixel and color kernels is "
        "written exactly once; the seeded short grids (S2, S3) are "
        "flagged"),
}

#: Modules whose overwrite scatters the kernel-scatter-race family proves
#: (the ``unsafe-scatter-set`` lint rule exempts them).
VERIFIED_SCATTER_MODULES = ("repro_torch/kernels/huffman/ops.py",)
