#!/usr/bin/env python3
"""The node rows of a captured graph of two Jacobi rounds, as test data.

Run as a file from the root of a checkout, on a machine with a card::

    python3 src/repro_torch/tools/graph_nodes.py OUT.json

Decodes the traced-program checker's tier-0 restart batch at 256-bit
chunks on the kernels (``analysis/trace_check.py``'s self-test decoder)
twice with its graph audit on, so that the second decode captures the
round graph, and writes as JSON: the graph's rows as
``kernels.huffman.ops.graph_nodes`` reads them (``rows``), the program's
buffer pointers at capture (``live``), the graph's memory-pool spans
(``pool``), the compact tables' pointer of the graph's key (``table``) and
the program's lane capacity (``lanes``). ``tests/_torch_graph_nodes.json``
is its output, which the CPU tests hold the node classifier and the
exit-pointer check against.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from repro_torch.analysis import trace_check as T  # noqa: E402


def main(argv=None) -> int:
    out = Path((argv or sys.argv[1:])[0])
    dec = T._seed_decoder("cuda")
    prog = dec.program
    audit = T.GraphAuditor(prog, "graph_nodes")
    prog.audit = audit
    dec.coefficients()
    dec.coefficients()
    if audit.violations or len(audit.records) != 1:
        raise SystemExit(f"expected one clean graph: {audit.violations}")
    (key, rec), = audit.records.items()
    from repro_torch.kernels.huffman.ops import graph_nodes
    rows = graph_nodes(prog.graphs[key]).tolist()
    out.write_text(json.dumps({
        "rows": rows, "live": rec.live, "pool": rec.pool,
        "table": key[0][0], "lanes": prog.shape.n_chunks}, indent=None))
    print(f"{len(rows)} nodes {rec.kinds} -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
