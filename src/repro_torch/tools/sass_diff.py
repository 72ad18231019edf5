#!/usr/bin/env python3
"""The release build's machine code of every kernel, in two or more
checkouts of this package.

Run as a file from the root of a checkout, on a machine with the CUDA
toolkit (no card needed)::

    python3 src/repro_torch/tools/sass_diff.py \\
        --tree parent=build/parent/src --tree change=src \\
        [--source huffman,pixels,idct,color] [--checked] [--diff-dir DIR]

For each source, nvcc builds each tree's ``kernels/csrc/<source>.cu``
with that tree's own flags (``kernels/build.py``; the release build, or
the checked one with ``--checked``) into a cubin, and ``cuobjdump`` gives
each kernel's registers and SASS. Every kernel of the first tree is
matched with the kernel of each other tree that has its name, whose
template arguments begin with its own (a template argument added at the
end, such as a block size, still matches) and whose code differs least.
Instructions are compared with the offsets of kernel parameters and
branch labels masked, so that a parameter added at the end of the list
counts only where the code uses it.

Each kernel prints one line: registers, instructions, and how many
instructions of the other tree's counterpart differ (and of its other
instantiations, say each block size); ``--diff-dir``
writes each pair that differs as a unified diff there. The last line is
one JSON object with the same.
"""
from __future__ import annotations

import argparse
import difflib
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
# flags of a shared library that a cubin does not take
_LIBRARY_FLAGS = {"-shared", "-fPIC", "-v"}


def tree_build(label: str, src: Path):
    """The tree's ``kernels/build.py`` (stdlib only), loaded on its own."""
    path = src / "repro_torch" / "kernels" / "build.py"
    spec = importlib.util.spec_from_file_location(f"_sd_build_{label}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cubin_flags(build, checked: bool) -> list:
    """The tree's nvcc flags without the shared library's."""
    if hasattr(build, "flags"):
        flags = list(build.flags(checked))
    elif checked:
        raise SystemExit(f"{build.__file__} has no checked build")
    else:
        flags = list(build.NVCC_FLAGS)
    out = []
    for f in flags:
        if f in _LIBRARY_FLAGS:
            if out and out[-1] in ("-Xcompiler", "-Xptxas"):
                out.pop()
            continue
        out.append(f)
    return out


def cuda_tool(name: str, nvcc: str):
    """A tool of the CUDA toolkit: on PATH, else beside nvcc."""
    found = shutil.which(name)
    if found:
        return found
    path = Path(nvcc).parent / name
    return str(path) if path.exists() else None


def demangle(names: list, nvcc: str) -> dict:
    tool = cuda_tool("cu++filt", nvcc) or shutil.which("c++filt")
    if tool is None:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return dict(zip(names, out))


def kernels_of(cubin: Path, nvcc: str) -> dict:
    """{demangled name: (registers, [normalized instruction])}."""
    cuobjdump = cuda_tool("cuobjdump", nvcc)
    res = subprocess.run([cuobjdump, "-res-usage", str(cubin)],
                         capture_output=True, text=True, check=True).stdout
    regs, name = {}, None
    for line in res.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            name = m.group(1)
        m = re.search(r"REG:(\d+)", line)
        if m and name:
            regs[name] = int(m.group(1))
    sass = subprocess.run([cuobjdump, "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    code, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            code[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m and name:
            ins = re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][.]", m.group(1))
            ins = re.sub(r"\.L_x_\d+", ".L", ins)
            code[name].append(" ".join(ins.split()))
    names = demangle(sorted(code), nvcc)
    return {names[n]: (regs.get(n, -1), code[n]) for n in code}


def split_name(name: str):
    """(base name, template arguments) of a demangled kernel name."""
    s = re.sub(r"(\(anonymous namespace\)|<unnamed>)::", "", name)
    m = re.match(r"(?:void\s+)?([\w:]+)", s)
    base, at = m.group(1).split("::")[-1], m.end()
    if at >= len(s) or s[at] != "<":
        return base, ""
    depth = 0
    for i in range(at, len(s)):
        depth += {"<": 1, ">": -1}.get(s[i], 0)
        if depth == 0:
            return base, s[at + 1:i]
    return base, s[at + 1:]


def differing(a: list, b: list) -> int:
    matched = sum(m.size for m in difflib.SequenceMatcher(
        None, a, b, autojunk=False).get_matching_blocks())
    return len(a) + len(b) - 2 * matched


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    metavar="LABEL=DIR", help="a checkout's src directory")
    ap.add_argument("--source", default="huffman,pixels,idct,color")
    ap.add_argument("--checked", action="store_true",
                    help="the checked build (-DRT_CHECK) instead")
    ap.add_argument("--diff-dir", default="",
                    help="write each differing pair's SASS diff here")
    args = ap.parse_args()
    trees = [t.split("=", 1) for t in args.tree]
    if len(trees) < 2:
        raise SystemExit("give at least two --tree LABEL=DIR")
    builds = {label: tree_build(label, (ROOT / d).resolve())
              for label, d in trees}
    first = trees[0][0]
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        for source in args.source.split(","):
            procs = {}
            for label, build in builds.items():
                cu = build.CSRC / f"{source}.cu"
                cubin = Path(tmp) / f"{label}_{source}.cubin"
                procs[label] = (subprocess.Popen(
                    [build.nvcc_path(), *cubin_flags(build, args.checked),
                     "-cubin", f"-I{build.CSRC}", "-o", str(cubin), str(cu)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), cubin)
            kernels = {}
            for label, (proc, cubin) in procs.items():
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    raise SystemExit(f"nvcc failed for {label} {source}:\n"
                                     f"{log}")
                kernels[label] = kernels_of(cubin, builds[label].nvcc_path())
            for name, (regs, code) in sorted(kernels[first].items()):
                base, targs = split_name(name)
                row = {first: {"kernel": name, "registers": regs,
                               "instructions": len(code)}}
                line = (f"[sass] {source}: {base}<{targs}> {first} {regs} "
                        f"registers, {len(code)} instructions")
                for label in builds:
                    if label == first:
                        continue
                    cands = [(differing(code, c_code), c_name, c_regs,
                              len(c_code))
                             for c_name, (c_regs, c_code)
                             in kernels[label].items()
                             if split_name(c_name)[0] == base
                             and split_name(c_name)[1].startswith(targs)]
                    if not cands:
                        line += f"; {label}: no counterpart"
                        row[label] = None
                        continue
                    diff, c_name, c_regs, n = min(cands)
                    row[label] = {"kernel": c_name, "registers": c_regs,
                                  "instructions": n, "differ": diff}
                    others = ", ".join(
                        f"<{split_name(o[1])[1]}> {o[0]}"
                        for o in sorted(cands, key=lambda o: o[1])
                        if o[1] != c_name)
                    if diff and args.diff_dir:
                        out = Path(args.diff_dir)
                        out.mkdir(parents=True, exist_ok=True)
                        tag = re.sub(r"\W+", "_", f"{source}_{base}_{targs}")
                        (out / f"{tag}.{first}-{label}.diff").write_text(
                            "\n".join(difflib.unified_diff(
                                code, kernels[label][c_name][1], name,
                                c_name, lineterm="")))
                    line += (f"; {label} <{split_name(c_name)[1]}> {c_regs} "
                             f"registers, {n} instructions, {diff} differ"
                             + (f" (other instantiations: {others})"
                                if others else ""))
                print(line, flush=True)
                result[name] = row
    print(json.dumps({"checked": args.checked, "kernels": result}))


if __name__ == "__main__":
    sys.exit(main())
