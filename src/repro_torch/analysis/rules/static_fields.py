"""unhashable-static: a mutable field on a frozen dataclass that keys a
cache.

The torch form of the JAX package's rule (its first half; the second,
enclosing-scope captures of a nested jit, has no counterpart: the port
runs eagerly). ``PlanShape`` keys the program cache and ``LaunchConfig``
the launch table by hash: a mutable field (a list, a dict, an ndarray, a
tensor) either raises at hash time or hashes by identity, so equal keys
stop deduplicating and every batch allocates a program, or a CUDA graph
captured under one key replays under another.
"""
from __future__ import annotations

import ast

from ..lint import dotted_name

NAME = "unhashable-static"
DESCRIPTION = ("mutable/ndarray/tensor fields on frozen (hashable) "
               "dataclasses")

_MUTABLE_HEADS = {"ndarray", "list", "List", "dict", "Dict", "set", "Set",
                  "bytearray", "Tensor", "MutableMapping", "defaultdict",
                  "OrderedDict"}
_WRAPPER_HEADS = {"Optional", "Union", "Tuple", "FrozenSet", "Final",
                  "ClassVar", "Annotated", "Sequence", "Mapping", "tuple",
                  "frozenset"}


def _frozen_dataclass(cls: ast.ClassDef) -> bool:
    """Frozen dataclasses that hash by field values (``eq=False`` opts a
    class out: it falls back to identity hash)."""
    for dec in cls.decorator_list:
        dn = dotted_name(dec.func if isinstance(dec, ast.Call) else dec)
        if not dn or dn.rpartition(".")[2] != "dataclass":
            continue
        if isinstance(dec, ast.Call):
            kwargs = {kw.arg: kw.value for kw in dec.keywords}
            frozen = kwargs.get("frozen")
            eq = kwargs.get("eq")
            if (isinstance(frozen, ast.Constant) and frozen.value is True
                    and not (isinstance(eq, ast.Constant)
                             and eq.value is False)):
                return True
    return False


def _mutable_annotation(ann: ast.AST) -> bool:
    if isinstance(ann, ast.Subscript):
        head = dotted_name(ann.value)
        last = head.rpartition(".")[2] if head else ""
        if last in _MUTABLE_HEADS:
            return True
        if last in _WRAPPER_HEADS:
            sl = ann.slice
            elts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
            return any(_mutable_annotation(e) for e in elts)
        return False
    dn = dotted_name(ann)
    if dn is None:
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            return any(h in ann.value for h in ("ndarray", "Tensor", "List[",
                                                "Dict[", "list", "dict"))
        return False
    return dn.rpartition(".")[2] in _MUTABLE_HEADS


def check(mod):
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef) and _frozen_dataclass(node):
            for stmt in node.body:
                if (isinstance(stmt, ast.AnnAssign)
                        and _mutable_annotation(stmt.annotation)):
                    tgt = (stmt.target.id
                           if isinstance(stmt.target, ast.Name) else "?")
                    yield mod.finding(
                        NAME, stmt,
                        f"frozen dataclass {node.name}.{tgt} has a mutable "
                        f"(list/dict/ndarray/tensor) field: frozen "
                        f"dataclasses key caches by hash; this field breaks "
                        f"(or identity-hashes) that key")
