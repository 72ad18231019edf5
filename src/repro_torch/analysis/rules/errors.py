"""swallowed-format-error: broad excepts that can hide JpegFormatError.

The JAX package's rule, unchanged in the port. Damage handling is
*typed*: ``JpegFormatError`` / ``JpegTruncationError`` carry byte offset
+ marker context and are classified (never discarded) by
``validate_blob`` / ``validate_batch``.
A bare / ``except Exception`` handler anywhere else can eat those
errors (and genuine bugs) and turn a classifiable corrupt input into a
silent wrong decode. Allowed without flagging: handlers inside
``validate_*`` functions (classification is their job) and handlers
that re-raise.
"""
from __future__ import annotations

import ast

from ..lint import dotted_name

NAME = "swallowed-format-error"
DESCRIPTION = ("bare/broad except (Exception/BaseException) outside "
               "validate_* that does not re-raise")

_BROAD = {"Exception", "BaseException"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    for ty in types:
        dn = dotted_name(ty)
        if dn and dn.rpartition(".")[2] in _BROAD:
            return True
    return False


def _reraises(handler: ast.ExceptHandler) -> bool:
    return any(isinstance(n, ast.Raise) for n in ast.walk(handler))


def check(mod):
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ExceptHandler) or not _is_broad(node):
            continue
        fns = mod.enclosing_functions(node)
        names = [getattr(f, "name", "") for f in fns]
        if any(n.startswith("validate_") or n.startswith("_validate")
               for n in names):
            continue  # classification is validate_*'s job
        if _reraises(node):
            continue
        what = "bare except" if node.type is None else "except Exception"
        yield mod.finding(
            NAME, node,
            f"{what} swallows JpegFormatError (and real bugs) outside "
            f"validate_*: narrow the exception types, re-raise, or "
            f"baseline with a justification if this is a deliberate "
            f"harness catch-all")
