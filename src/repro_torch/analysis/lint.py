"""AST linter for the decode pipeline's repo-specific bug classes.

A copy of the JAX package's ``analysis/lint.py`` for the port: the same
:class:`Finding`, suppression grammar and baseline, over ``src/repro_torch``.
Pure stdlib (``ast`` + ``tokenize``): importable and runnable without
torch, so a lint run costs nothing beyond parsing. Rules live in
``repro_torch.analysis.rules``; each is a module with ``NAME``,
``DESCRIPTION`` and ``check(module) -> iterable[Finding]``.

Where the JAX package's rules read *traced* code (a jit, shard_map or
control-flow body), the port's read *captured* code: the body of a
``with torch.cuda.graph(...)`` block, and the functions handed to the
sync loops that launch rounds without a host read in between
(``core.sync`` ``RoundBlocks.loop`` bodies, ``_graph_pairs`` bodies,
``torch.cuda.make_graphed_callables``).

Suppression, two levels:

* inline — a ``# repro: allow[rule]`` comment on the finding's line or
  the line directly above it;
* baseline — ``analysis/baseline.txt`` entries of the form
  ``rule :: path :: stripped source line :: justification``. Keys use
  the *text* of the offending line rather than its number so unrelated
  edits above a baselined finding don't invalidate the entry.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

SUPPRESS_RE = re.compile(r"#\s*repro:\s*allow\[([a-zA-Z0-9_,\- ]+)\]")

_WS = re.compile(r"\s+")


def _norm(line: str) -> str:
    return _WS.sub(" ", line.strip())


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str            # posix path relative to src/ (repro_torch/core/api.py)
    line: int
    col: int
    message: str
    source_line: str

    def baseline_key(self) -> str:
        return f"{self.rule} :: {self.path} :: {_norm(self.source_line)}"

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


# ---------------------------------------------------------------------------
# Captured-context detection
# ---------------------------------------------------------------------------

# Calls whose function argument (at this position) a CUDA graph captures,
# or a sync loop launches in blocks without a host read between its
# iterations: RoundBlocks.loop(name, body, read, limit, run) and
# _graph_pairs(body, ...) of core/sync.py, make_graphed_callables(fn).
_CAPTURING_ARG = {"make_graphed_callables": 0, "_graph_pairs": 0,
                  "loop": 1}
# with-blocks whose body a CUDA graph captures: torch.cuda.graph(g)
_CAPTURING_WITH = ("cuda.graph", "torch.cuda.graph")


def dotted_name(node: ast.AST) -> Optional[str]:
    """'torch.cuda.graph' for an Attribute/Name chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def captured_arg(call: ast.Call) -> Optional[ast.AST]:
    """The argument of ``call`` that runs captured (see
    ``_CAPTURING_ARG``), else None. ``loop`` counts only as a method call
    with at least three arguments (RoundBlocks.loop's shape)."""
    dn = dotted_name(call.func)
    if dn is None:
        return None
    last = dn.rpartition(".")[2]
    pos = _CAPTURING_ARG.get(last)
    if pos is None:
        return None
    if last == "loop" and (not isinstance(call.func, ast.Attribute)
                           or len(call.args) < 3):
        return None
    return call.args[pos] if len(call.args) > pos else None


def is_capturing_with(node: ast.AST) -> bool:
    """A ``with torch.cuda.graph(...)`` statement."""
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return False
    for item in node.items:
        expr = item.context_expr
        dn = dotted_name(expr.func if isinstance(expr, ast.Call) else expr)
        if dn and (dn in _CAPTURING_WITH or dn.endswith(".cuda.graph")):
            return True
    return False


def _bound_names(fn: ast.AST) -> Set[str]:
    """Names bound inside a function scope (params, assigns, imports,
    for/with/except targets, nested defs) — NOT entering nested scopes."""
    out: Set[str] = set()
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        a = fn.args
        for p in (a.posonlyargs + a.args + a.kwonlyargs
                  + ([a.vararg] if a.vararg else [])
                  + ([a.kwarg] if a.kwarg else [])):
            out.add(p.arg)
        body = fn.body
    elif isinstance(fn, ast.Lambda):
        a = fn.args
        for p in (a.posonlyargs + a.args + a.kwonlyargs
                  + ([a.vararg] if a.vararg else [])
                  + ([a.kwarg] if a.kwarg else [])):
            out.add(p.arg)
        return out
    else:
        body = getattr(fn, "body", [])

    def visit(node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
            return  # don't descend into nested scope
        if isinstance(node, ast.Lambda):
            return
        if isinstance(node, ast.ClassDef):
            out.add(node.name)
            return
        if isinstance(node, ast.Name) and isinstance(
                node.ctx, (ast.Store, ast.Del)):
            out.add(node.id)
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                out.add((alias.asname or alias.name).split(".")[0])
        if isinstance(node, ast.ExceptHandler) and node.name:
            out.add(node.name)
        for child in ast.iter_child_nodes(node):
            visit(child)

    for stmt in body:
        visit(stmt)
    return out


class Module:
    """One parsed source file plus the derived context rules consume."""

    def __init__(self, source: str, path: str):
        self.source = source
        self.path = path
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self.suppressed: Dict[int, Set[str]] = self._suppressions()
        self.traced_fns: Set[ast.AST] = self._traced_functions()
        self.captured_withs: List[ast.AST] = [
            n for n in ast.walk(self.tree) if is_capturing_with(n)]
        self._bound_cache: Dict[ast.AST, Set[str]] = {}

    # -- suppression comments ------------------------------------------------
    def _suppressions(self) -> Dict[int, Set[str]]:
        out: Dict[int, Set[str]] = {}
        try:
            toks = tokenize.generate_tokens(io.StringIO(self.source).readline)
            for tok in toks:
                if tok.type != tokenize.COMMENT:
                    continue
                m = SUPPRESS_RE.search(tok.string)
                if m:
                    rules = {r.strip() for r in m.group(1).split(",")}
                    out.setdefault(tok.start[0], set()).update(rules)
        except tokenize.TokenError:
            pass
        return out

    def is_suppressed(self, finding: Finding) -> bool:
        for line in (finding.line, finding.line - 1):
            rules = self.suppressed.get(line)
            if rules and (finding.rule in rules or "*" in rules):
                return True
        return False

    # -- captured-context detection -----------------------------------------
    def _traced_functions(self) -> Set[ast.AST]:
        """Functions and lambdas handed to a capturing call (by name, the
        module's functions of that name)."""
        traced: Set[ast.AST] = set()
        traced_names: Set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                arg = captured_arg(node)
                if isinstance(arg, ast.Lambda):
                    traced.add(arg)
                elif isinstance(arg, ast.Name):
                    traced_names.add(arg.id)
        for node in ast.walk(self.tree):
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name in traced_names):
                traced.add(node)
        return traced

    def enclosing_functions(self, node: ast.AST) -> List[ast.AST]:
        """Innermost-first chain of enclosing function/lambda nodes."""
        out = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                out.append(cur)
            cur = self.parents.get(cur)
        return out

    def in_traced(self, node: ast.AST) -> bool:
        """Whether ``node`` runs captured: inside a captured function or
        the body of a ``with torch.cuda.graph(...)`` block."""
        if any(fn in self.traced_fns
               for fn in [node] + self.enclosing_functions(node)):
            return True
        cur = self.parents.get(node)
        while cur is not None:
            if cur in self.captured_withs:
                return True
            cur = self.parents.get(cur)
        return False

    def is_traced_fn(self, fn: ast.AST) -> bool:
        return fn in self.traced_fns or any(
            f in self.traced_fns for f in self.enclosing_functions(fn))

    def bound_names(self, fn: ast.AST) -> Set[str]:
        if fn not in self._bound_cache:
            self._bound_cache[fn] = _bound_names(fn)
        return self._bound_cache[fn]

    def module_names(self) -> Set[str]:
        return self.bound_names(self.tree)

    # -- finding construction ------------------------------------------------
    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        src = self.lines[line - 1] if 0 < line <= len(self.lines) else ""
        return Finding(rule=rule, path=self.path, line=line, col=col,
                       message=message, source_line=src)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

def _rules():
    from . import rules
    return rules.ALL


def lint_source(source: str, path: str = "<string>",
                rules=None) -> List[Finding]:
    """Lint one source string; returns findings after inline suppression
    (baseline filtering is the CLI's job). The unit-test entry point."""
    mod = Module(source, path)
    out: List[Finding] = []
    for rule in (rules if rules is not None else _rules()):
        for f in rule.check(mod):
            if not mod.is_suppressed(f):
                out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def lint_paths(paths: Sequence[Path], root: Optional[Path] = None,
               rules=None) -> List[Finding]:
    """Lint ``*.py`` files under ``paths``; finding paths are relative to
    ``root`` (default: common parent ``src/`` if present, else cwd)."""
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    out: List[Finding] = []
    for f in files:
        rel = _relpath(f, root)
        try:
            src = f.read_text()
        except (OSError, UnicodeDecodeError):
            continue
        try:
            out.extend(lint_source(src, rel, rules=rules))
        except SyntaxError as e:
            out.append(Finding(rule="parse-error", path=rel,
                               line=e.lineno or 1, col=e.offset or 0,
                               message=f"could not parse: {e.msg}",
                               source_line=""))
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def _relpath(f: Path, root: Optional[Path]) -> str:
    f = f.resolve()
    if root is not None:
        try:
            return f.relative_to(Path(root).resolve()).as_posix()
        except ValueError:
            pass
    # default: anchor at the nearest ancestor named src/ for stable keys
    for anc in f.parents:
        if anc.name == "src":
            return f.relative_to(anc).as_posix()
    return f.name


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------

def load_baseline(path: Path) -> Dict[str, str]:
    """{baseline key: justification} from ``baseline.txt``."""
    out: Dict[str, str] = {}
    if not Path(path).exists():
        return out
    for raw in Path(path).read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = [p.strip() for p in line.split(" :: ")]
        if len(parts) < 3:
            continue
        key = " :: ".join(parts[:3])
        out[key] = parts[3] if len(parts) > 3 else ""
    return out


def apply_baseline(findings: Iterable[Finding],
                   baseline: Dict[str, str]
                   ) -> Tuple[List[Finding], List[str]]:
    """(new findings, stale baseline keys)."""
    findings = list(findings)
    used: Set[str] = set()
    new: List[Finding] = []
    for f in findings:
        k = f.baseline_key()
        if k in baseline:
            used.add(k)
        else:
            new.append(f)
    stale = [k for k in baseline if k not in used]
    return new, stale
