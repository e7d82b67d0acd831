"""CLI for the static-analysis suite: ``python -m brpc_tpu_torch.tools.check``.

Exit codes: 0 = clean, 1 = findings, 2 = suite failure — suitable as a
pre-commit / CI gate (see tools/check/run_all.sh).
"""

from __future__ import annotations

import argparse
import sys

from . import ANALYZERS, run_all


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m brpc_tpu_torch.tools.check",
        description="repo-specific static analysis: contract drift, "
                    "lane invariants, closed enums/flags, loop-thread "
                    "blocking calls")
    ap.add_argument("--analyzer", "-a", action="append", default=[],
                    choices=[n for n, _ in ANALYZERS],
                    help="run only this analyzer (repeatable)")
    ap.add_argument("--fail-fast", action="store_true",
                    help="stop after the first analyzer with findings")
    ap.add_argument("--root", default=None,
                    help="repo root to analyze (default: this checkout)")
    ap.add_argument("--quiet", "-q", action="store_true",
                    help="findings only, no summary line")
    args = ap.parse_args(argv)

    try:
        findings = run_all(root=args.root,
                           only=tuple(args.analyzer) or None,
                           fail_fast=args.fail_fast)
    except Exception as e:                      # suite bug ≠ clean tree
        print(f"check: suite error: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2
    for f in findings:
        print(f"{f.path}:{f.line}: [{f.analyzer}] {f.message}")
    if not args.quiet:
        ran = tuple(args.analyzer) or tuple(n for n, _ in ANALYZERS)
        if findings:
            print(f"check: {len(findings)} finding(s) across "
                  f"{', '.join(ran)}", file=sys.stderr)
        else:
            print(f"check: clean ({', '.join(ran)})")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
