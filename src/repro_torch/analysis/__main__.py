"""CLI: ``python -m repro_torch.analysis {lint,kernels,contracts}``.

``lint`` is stdlib-only (never imports torch) and runs anywhere.
``kernels`` is the kernel verifier (``kernel_check.run``): its host checks
run anywhere, its checked builds on the card, so it needs one and exits
non-zero without. ``contracts`` is the traced-program checker
(``trace_check.run``): on the card by default, where it exits non-zero
without one, and on the CPU only with ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _default_root() -> Path:
    # src/repro_torch, located from this file so the CLI works from any cwd
    return Path(__file__).resolve().parent.parent


def _default_baseline() -> Path:
    return Path(__file__).resolve().parent / "baseline.txt"


def _cmd_lint(args) -> int:
    from .lint import apply_baseline, lint_paths, load_baseline

    root = _default_root()
    paths = [Path(p) for p in args.paths] or [root]
    findings = lint_paths(paths, root=root.parent)
    stale = []
    if args.baseline is not None:
        baseline_path = Path(args.baseline) if args.baseline else \
            _default_baseline()
        findings, stale = apply_baseline(findings,
                                         load_baseline(baseline_path))
        for key in stale:
            # stale entries fail too: a baseline that no longer matches
            # reality silently whitelists the next real finding at that key
            print(f"stale baseline entry (no longer fires): {key}")
    for f in findings:
        print(f.format())
    n = len(findings)
    print(f"{n} finding{'s' if n != 1 else ''}"
          + (" (after baseline)" if args.baseline is not None else "")
          + (f", {len(stale)} stale baseline entr"
             f"{'ies' if len(stale) != 1 else 'y'}" if stale else ""))
    return 1 if findings or stale else 0


def _cmd_kernels(args) -> int:
    from . import kernel_check
    return kernel_check.run(self_test=args.self_test, verbose=args.verbose)


def _cmd_contracts(args) -> int:
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("contracts: no CUDA device. The checker runs on the card; "
              "pass --device cpu to run it on the CPU", file=sys.stderr)
        return 2
    from . import trace_check
    return trace_check.run(self_test=args.self_test, verbose=args.verbose,
                           device=args.device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static analysis and kernel verifier")
    sub = p.add_subparsers(dest="cmd", required=True)

    pl = sub.add_parser("lint", help="AST lint over src/repro_torch")
    pl.add_argument("paths", nargs="*",
                    help="files/dirs (default: src/repro_torch)")
    pl.add_argument("--baseline", nargs="?", const="", default=None,
                    metavar="FILE",
                    help="filter findings through the checked-in baseline "
                         "(default file: analysis/baseline.txt)")
    pl.set_defaults(fn=_cmd_lint)

    pk = sub.add_parser(
        "kernels",
        help="kernel verifier: bounds, tiling and scatter-race over the "
             "CUDA kernels under every launch candidate (needs a card)")
    pk.add_argument("--self-test", action="store_true",
                    help="also prove the verifier catches four seeded "
                         "faults (an off-by-one row read, a short copy "
                         "grid, a misaligned pixel tile, a duplicate "
                         "scatter index)")
    pk.add_argument("--verbose", action="store_true")
    pk.set_defaults(fn=_cmd_kernels)

    pc = sub.add_parser(
        "contracts",
        help="traced-program checker: lane-graph taint, float64, host "
             "reads and the CUDA graphs of the sync rounds over the tier-0 "
             "grid (and, on the card, the full-width cells)")
    pc.add_argument("--self-test", action="store_true",
                    help="also prove the checker catches its seeded faults "
                         "(a gather-creep read, a float64 op, an .item() in "
                         "a sync round, a returned program-buffer view, a "
                         "buffer reallocated after capture, and on the card "
                         "a graph that copies to the host)")
    pc.add_argument("--verbose", action="store_true")
    pc.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the decodes run (default: the card)")
    pc.set_defaults(fn=_cmd_contracts)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
