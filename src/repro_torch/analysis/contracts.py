"""The decode pipeline's contracts, as the analysis tools read them.

The port keeps its contracts in :mod:`repro_torch.core.contracts` (the
planner's int32 guards; the index lattice and lane-graph liveness that the
traced-program checker holds, with its catalog ``TRACE_CONTRACTS``; what
the kernel verifier needs: ``IntRange``, ``check_block_cover``,
``KERNEL_CHECK_FAMILIES``, ``VERIFIED_SCATTER_MODULES``); this module
re-exports them under the name the JAX package's ``analysis/contracts.py``
has. Stdlib only.
"""
from __future__ import annotations

from ..core.contracts import (IDENTITY_LIVE_OK, INT32_MAX, INT32_MIN,
                              KERNEL_CHECK_FAMILIES, LANE_GRAPH_ARRAYS,
                              MESH_CONTRACTS, TRACE_CONTRACTS,
                              VERIFIED_SCATTER_MODULES, ContractViolation,
                              IntRange, check_block_cover,
                              check_index_lattice, check_shape_capacities,
                              checked_coeff_capacity, checked_int32,
                              identity_live_ok, max_damaged_segment_chunks,
                              plan_index_ranges, write_overshoot)

__all__ = ["IDENTITY_LIVE_OK", "INT32_MAX", "INT32_MIN",
           "KERNEL_CHECK_FAMILIES", "LANE_GRAPH_ARRAYS",
           "MESH_CONTRACTS", "TRACE_CONTRACTS",
           "VERIFIED_SCATTER_MODULES", "ContractViolation", "IntRange",
           "check_block_cover", "check_index_lattice",
           "check_shape_capacities", "checked_coeff_capacity",
           "checked_int32", "identity_live_ok", "max_damaged_segment_chunks",
           "plan_index_ranges", "write_overshoot"]
