"""unsafe-scatter-set: an overwrite scatter on indices not proven unique.

The torch form of the JAX package's rule. ``x.index_put_(idx, v)``,
``x.scatter_(dim, idx, src)`` and ``x.index_copy_(dim, idx, src)`` (and
their out-of-place forms) with a *computed* index overwrite: if the index
ever holds a duplicate, the result depends on which store lands last,
which the card does not order. The write pass's scatter carries a
duplicate-freeness proof (``python -m repro_torch.analysis kernels``,
family *kernel-scatter-race*: the targets of ``scatter_streams`` other
than its sentinel are unique, and each lane's positions strictly
increase); modules listed in ``contracts.VERIFIED_SCATTER_MODULES`` are
covered by it and exempt. Everywhere else, either

* accumulate instead (``index_put_(..., accumulate=True)``,
  ``scatter_add_``, ``index_add_``: order-independent), or
* prove the site and register it, or
* suppress a reviewed site with ``# repro: allow[unsafe-scatter-set]``
  (or a baseline entry naming the justification).

Static indices (literals, tuples of literals) cannot alias and are never
flagged.
"""
from __future__ import annotations

import ast

from ..contracts import VERIFIED_SCATTER_MODULES

NAME = "unsafe-scatter-set"
DESCRIPTION = ("non-accumulating index_put_/scatter_/index_copy_ on a "
               "computed index outside the kernel verifier's proven "
               "modules")

# method -> position of its index argument
_INDEX_ARG = {"index_put_": 0, "index_put": 0, "scatter_": 1, "scatter": 1,
              "index_copy_": 1, "index_copy": 1}


def _static_index(node: ast.AST) -> bool:
    """True when the index cannot hold duplicates at run time: constants,
    unary +/- of constants, tuples and lists thereof."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(
            node.op, (ast.UAdd, ast.USub)):
        return _static_index(node.operand)
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(_static_index(e) for e in node.elts)
    return False


def _accumulates(node: ast.Call, method: str) -> bool:
    kw = {k.arg: k.value for k in node.keywords}
    if method.startswith("index_put"):
        acc = kw.get("accumulate")
        if acc is None and len(node.args) > 2:
            acc = node.args[2]
        return isinstance(acc, ast.Constant) and acc.value is True
    if method.startswith("scatter"):
        return "reduce" in kw or len(node.args) > 3
    return False


def check(mod):
    if mod.path in VERIFIED_SCATTER_MODULES:
        return
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        method = node.func.attr
        pos = _INDEX_ARG.get(method)
        if pos is None or len(node.args) <= pos:
            continue
        if _static_index(node.args[pos]) or _accumulates(node, method):
            continue
        yield mod.finding(
            NAME, node,
            f".{method} with a computed index is an overwrite scatter: "
            f"duplicates are order-dependent; accumulate, or prove the "
            f"site duplicate-free (python -m repro_torch.analysis kernels) "
            f"and register it in contracts.VERIFIED_SCATTER_MODULES")
