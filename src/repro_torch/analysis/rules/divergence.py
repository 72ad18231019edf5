"""host-divergence: per-process control flow around rendezvous calls.

The JAX package's rule, with the port's rendezvous. Every process must
reach each consensus / coordination call the same number of times in the
same order: the exchanges and barriers of ``launch/multihost.py``
(``exchange``, ``barrier``, ``init_distributed``,
``torch.distributed.init_process_group``), and the key-value operations
of its ``TCPStore`` (``store.set`` / ``get`` / ``wait`` / ``add``), as well
as the JAX names the reference rule knows. Branching on *per-process
identity* (``process_id`` / ``rank`` / ``is_main``) before or around such
a call lets one process skip (or leave through a raise or return ahead
of) a rendezvous its peers are blocked in: the corrupt-feed deadlock
that ``decode_multihost(validate=True)`` is built to prevent. Branching
on *uniform* values (``num_processes``, ``world_size``) is safe and not
flagged.
"""
from __future__ import annotations

import ast

from ..lint import dotted_name

NAME = "host-divergence"
DESCRIPTION = ("process-identity-dependent branching around collective "
               "rendezvous calls (exchange/barrier/store ops)")

_IDENTITY_NAMES = {"process_id", "process_index", "is_main", "rank",
                   "host_id", "is_coordinator"}
_CONSENSUS_CALLS = {
    "exchange", "barrier", "plan_consensus", "initialize",
    "blocking_key_value_get", "key_value_set", "wait_at_barrier",
    "gather_decode_stats", "init_distributed", "init_process_group",
}
# key-value operations of a torch.distributed store: a rendezvous when
# called on an object whose name ends in "store"
_STORE_CALLS = {"set", "get", "wait", "add", "compare_set"}


def _references_identity(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in _IDENTITY_NAMES:
            return True
        if isinstance(sub, ast.Attribute) and sub.attr in _IDENTITY_NAMES:
            return True
        if isinstance(sub, ast.Call):
            dn = dotted_name(sub.func)
            if dn and dn.rpartition(".")[2] in _IDENTITY_NAMES:
                return True
    return False


def _is_consensus_call(node: ast.Call) -> bool:
    dn = dotted_name(node.func)
    if not dn:
        return False
    head, _, last = dn.rpartition(".")
    if last in _CONSENSUS_CALLS:
        return True
    return last in _STORE_CALLS and head.lower().endswith("store")


def check(mod):
    consensus_calls = [n for n in ast.walk(mod.tree)
                       if isinstance(n, ast.Call) and _is_consensus_call(n)]

    # (a) a rendezvous call lexically inside an identity-tested branch
    for call in consensus_calls:
        cur = mod.parents.get(call)
        while cur is not None:
            if (isinstance(cur, (ast.If, ast.While))
                    and _references_identity(cur.test)):
                dn = dotted_name(call.func)
                yield mod.finding(
                    NAME, call,
                    f"collective rendezvous {dn}(...) runs under a branch "
                    f"testing per-process identity: processes that skip it "
                    f"deadlock the peers inside it; restructure so every "
                    f"process reaches the call, or gate on uniform values "
                    f"(num_processes) only")
                break
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break
            cur = mod.parents.get(cur)

    # (b) an identity-tested branch that raises/returns before a later
    # rendezvous in the same function
    fn_calls = {}
    for call in consensus_calls:
        fns = mod.enclosing_functions(call)
        if fns:
            fn_calls.setdefault(fns[0], []).append(call.lineno)
    for fn, call_lines in fn_calls.items():
        last_call = max(call_lines)
        for node in ast.walk(fn):
            if not isinstance(node, ast.If):
                continue
            if not _references_identity(node.test):
                continue
            for sub in ast.walk(node):
                if (isinstance(sub, (ast.Raise, ast.Return))
                        and sub.lineno < last_call):
                    yield mod.finding(
                        NAME, sub,
                        f"early {type(sub).__name__.lower()} under a "
                        f"per-process-identity branch precedes a collective "
                        f"rendezvous at line {last_call}: one process bails "
                        f"while its peers block in the rendezvous")
                    break
            else:
                continue
