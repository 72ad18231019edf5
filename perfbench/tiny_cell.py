"""A checkout root of one tiny cell, and a CPU rehearsal of it in a
process of its own: what the benchmark's tests drive (the program's plain
backend; frames 24x16 at quality 50 in 128-bit lanes, so that a run takes
seconds)."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

REPO = Path(__file__).resolve().parents[1]
CELL = "tiny.t4"


def make_root(where: Path) -> Path:
    """A root holding ``BENCHMARK.json`` with the one cell ``tiny.t4``,
    its files, the benchmark's metric readers, and the real
    configurations' limits."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    limits = json.loads((REPO / "perfbench/configs/newyork.json")
                        .read_text())["limits"]
    bench["configs"] = [{"name": "tiny", "source": "a test",
                         "file": "perfbench/configs/tiny.json",
                         "reduced": [], "why": "a test"}]
    bench["workloads"] = [{"name": CELL, "config": "tiny", "traffic": "t4",
                           "chips": 1, "why": "a test"}]
    for m in bench["per_layer"]:
        m["workloads"] = [CELL]
    (where / "perfbench" / "configs").mkdir(parents=True)
    (where / "perfbench" / "workloads").mkdir()
    shutil.copytree(REPO / "perfbench" / "metrics",
                    where / "perfbench" / "metrics")
    write(where / "BENCHMARK.json", bench)
    write(where / "perfbench/configs/tiny.json",
          {"name": "tiny", "n_images": 2, "width": 24, "height": 16,
           "subsampling": "4:2:0", "quality": 50, "subsequence_bits": 128,
           "limits": limits})
    write(where / "perfbench/workloads/t4.json",
          {"batch": 4, "ring": 2, "restart_interval": 0, "check_batches": 2,
           "trace_from": 1, "trace_batches": 2})
    return where


def write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def rehearse(root: Path, *run: str, fault: Optional[str] = None,
             grain: Optional[int] = None, timeout: float = 300):
    """``perfbench.rehearse`` in a new process: (exit code, the last line
    of standard output parsed, or None, standard error)."""
    cmd: List[str] = [sys.executable, "-m", "perfbench.rehearse",
                      "--root", str(root)]
    if fault:
        cmd += ["--fault", fault]
    if grain is not None:
        cmd += ["--grain", str(grain)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "src")]))
    p = subprocess.run(cmd + ["--", *run], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=timeout)
    lines = p.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    return p.returncode, last, p.stderr
