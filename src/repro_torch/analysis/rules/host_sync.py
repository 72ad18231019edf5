"""traced-host-sync: a host read inside code a CUDA graph captures.

The torch form of the JAX package's rule. Inside a function that a CUDA
graph captures (``with torch.cuda.graph(...)``, ``_graph_pairs`` bodies)
or that a sync loop launches in blocks without a host read between its
iterations (``core.sync.RoundBlocks.loop`` bodies), ``.item()``,
``.cpu()``, ``.tolist()``, ``.numpy()`` and ``bool``/``int``/``float`` of
a tensor read the device on the host: under capture it fails, and in a
block of rounds it puts back the per-round host sync the blocks exist to
remove. Casting a Python constant is fine; suppress such sites with
``# repro: allow[traced-host-sync]``.
"""
from __future__ import annotations

import ast

from ..lint import dotted_name

NAME = "traced-host-sync"
DESCRIPTION = ("host read (.item()/.cpu()/.tolist()/.numpy()/bool()/int()/"
               "float()) inside code a CUDA graph captures or a block of "
               "sync rounds launches")

_SYNC_ATTRS = {"item", "cpu", "tolist", "numpy"}
_CAST_NAMES = {"bool", "int", "float"}
_SYNC_CALLS = {"torch.cuda.synchronize", "cuda.synchronize"}


def _is_constant_ish(node: ast.AST) -> bool:
    """Casts of obvious host constants are not host reads."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Call):
        dn = dotted_name(node.func)
        if dn and dn.rpartition(".")[2] in {"len", "round", "ceil", "floor"}:
            return True
    if isinstance(node, (ast.BinOp, ast.UnaryOp)):
        kids = ([node.left, node.right] if isinstance(node, ast.BinOp)
                else [node.operand])
        return all(_is_constant_ish(k) for k in kids)
    return False


def check(mod):
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or not mod.in_traced(node):
            continue
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in _SYNC_ATTRS:
            yield mod.finding(
                NAME, node,
                f".{func.attr}() reads the device on the host inside "
                f"captured code (fails under CUDA graph capture; a host "
                f"sync per round in a block of rounds)")
            continue
        dn = dotted_name(func)
        if dn in _SYNC_CALLS:
            yield mod.finding(
                NAME, node,
                f"{dn}() synchronizes the host inside captured code")
            continue
        if (isinstance(func, ast.Name) and func.id in _CAST_NAMES
                and len(node.args) == 1 and not node.keywords
                and not _is_constant_ish(node.args[0])):
            yield mod.finding(
                NAME, node,
                f"{func.id}(...) of a possibly-device value inside captured "
                f"code reads it on the host; if the operand is a host "
                f"constant, add `# repro: allow[{NAME}]`")
