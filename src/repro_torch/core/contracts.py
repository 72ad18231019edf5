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

