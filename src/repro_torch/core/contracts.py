"""Int32 guards of the host planner.

A copy of the runtime guards of the JAX package's ``analysis/contracts.py``
(``ContractViolation``, ``checked_int32``, ``checked_coeff_capacity`` and
``check_shape_capacities``): the planner in :mod:`repro_torch.core.bitstream`
calls them so that no plan whose dense coefficient index or bit position
overflows int32 reaches a kernel. Stdlib only; shape arguments are
duck-typed on attribute names.
"""
from __future__ import annotations

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
    the port's verifier uses: constants, + and *."""

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
