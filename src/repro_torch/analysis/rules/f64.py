"""f64-literal-promotion: float64 in the port's torch code.

The torch form of the JAX package's rule. The decode pipeline is
f32/int32 (and bf16) on the card by contract: an f64 tensor doubles its
bytes and runs the card's FP64 units, and the kernels take none. Flagged:
``torch.float64`` / ``torch.double`` as a ``dtype=`` of a call,
``.double()``, and ``.to(...)`` / ``.type(...)`` with one of them.
Host-side ``np.float64`` precompute (matrix folding, the encoder) is
intentional and NOT flagged; a torch f64 on host tensors needs a
suppression or a baseline entry naming why.
"""
from __future__ import annotations

import ast

from ..lint import dotted_name

NAME = "f64-literal-promotion"
DESCRIPTION = ("torch.float64/torch.double dtypes, .double(), or "
               ".to/.type to float64")

_F64_DOTTED = {"torch.float64", "torch.double"}


def _is_f64(node: ast.AST) -> bool:
    return dotted_name(node) in _F64_DOTTED or (
        isinstance(node, ast.Constant) and node.value in ("torch.float64",
                                                          "torch.double"))


def check(mod):
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        dn = dotted_name(node.func) or ""
        for kw in node.keywords:
            if kw.arg == "dtype" and _is_f64(kw.value):
                yield mod.finding(
                    NAME, node,
                    f"dtype=float64 in {dn or 'a'}(...): the pipeline is "
                    f"f32/int32 on the card; f64 doubles the bytes")
        if not isinstance(node.func, ast.Attribute):
            continue
        attr = node.func.attr
        if attr == "double" and not node.args:
            yield mod.finding(NAME, node,
                              ".double() promotes a tensor to float64")
        elif attr in ("to", "type") and node.args and _is_f64(node.args[0]):
            yield mod.finding(NAME, node,
                              f".{attr}(float64) promotes a tensor to "
                              f"float64")
