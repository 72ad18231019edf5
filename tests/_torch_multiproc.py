"""Run a snippet in N cooperating processes of the port's multi-process
decode (``repro_torch.launch.multihost``) on localhost.

Every process starts from a prelude that calls ``init_distributed`` over a
``TCPStore`` (process 0 hosts it) and gets ``ctx`` and ``emit(obj)``; after
the snippet it calls ``shutdown_distributed``. Results come back as one
JSON object per process, ordered by process id. A hung process fails the
run within a hard wall-clock timeout that kills every process.

Imports no JAX and not ``conftest``, so the card's tests can use it with
``--noconftest``.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap
import time
from typing import List, Optional, Tuple

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")
RESULT_TAG = "RESULT "

_PRELUDE = """\
import json

def emit(obj):
    print({tag!r} + json.dumps(obj), flush=True)

from repro_torch.launch.multihost import (init_distributed,
                                          shutdown_distributed)
ctx = init_distributed(coordinator={coord!r}, num_processes={n},
                       process_id={pid}, timeout_s={init_timeout})
"""

_EPILOGUE = """
shutdown_distributed(timeout_ms={exit_timeout_ms})
"""


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(code: str, n: int, init_timeout: int = 60,
          claims: Optional[List[int]] = None) -> List[subprocess.Popen]:
    """Start the ``n`` processes; ``claims`` overrides the process count
    each one is launched with (one entry a process)."""
    coord = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + TESTS)
    procs = []
    for pid in range(n):
        src = (_PRELUDE.format(tag=RESULT_TAG, coord=coord,
                               n=claims[pid] if claims else n, pid=pid,
                               init_timeout=init_timeout)
               + textwrap.dedent(code)
               + _EPILOGUE.format(exit_timeout_ms=init_timeout * 1000))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env))
    return procs


def collect(procs: List[subprocess.Popen],
            timeout: float) -> List[Tuple[int, str]]:
    """(returncode, output) per process; on the wall-clock timeout every
    process is killed and the run fails with their output."""
    outs: List[Optional[str]] = [None] * len(procs)
    deadline = time.monotonic() + timeout
    try:
        for i, p in enumerate(procs):
            left = deadline - time.monotonic()
            if left <= 0:
                raise subprocess.TimeoutExpired(p.args, timeout)
            outs[i], _ = p.communicate(timeout=left)
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        partial = "\n".join(
            f"=== process {i} (rc={p.poll()}) ===\n{o or '<no output>'}"
            for i, (p, o) in enumerate(zip(procs, outs)))
        raise AssertionError(f"multi-process run timed out after "
                             f"{timeout}s; output:\n{partial[-6000:]}")
    return [(p.returncode, o or "") for p, o in zip(procs, outs)]


def parse_result(out: str):
    lines = [ln for ln in out.splitlines() if ln.startswith(RESULT_TAG)]
    assert lines, f"no {RESULT_TAG!r} line in output:\n{out[-3000:]}"
    return json.loads(lines[-1][len(RESULT_TAG):])


def run_processes(code: str, n: int, timeout: float = 60,
                  init_timeout: int = 30) -> List[dict]:
    """Run ``code`` in ``n`` processes; every one must exit 0 and emit one
    result. Returns the results ordered by process id."""
    results = collect(spawn(code, n, init_timeout=init_timeout), timeout)
    for pid, (rc, out) in enumerate(results):
        assert rc == 0, f"process {pid}/{n} failed (rc={rc}):\n{out[-4000:]}"
    return [parse_result(out) for _, out in results]
