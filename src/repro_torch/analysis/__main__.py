"""CLI: ``PYTHONPATH=src python -m repro_torch.analysis src/repro_torch
chip_smoke.py examples --strict-baseline``.

Exit status: 0 = clean (every finding pragma-suppressed or baselined),
1 = new findings, 2 = bad invocation.  ``--strict-baseline`` also fails
on stale baseline entries (keeps the baseline honest).  The JAX
package's ``python -m repro.analysis`` is the reference."""
from __future__ import annotations

import argparse
import sys

from .baseline import DEFAULT_BASELINE, load_baseline, split_by_baseline
from .engine import analyze_paths


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="hntlint for the PyTorch port: host-sync hygiene "
                    "static analysis (rules H001, H003-H007)")
    parser.add_argument("paths", nargs="+",
                        help="files or directories to analyze")
    parser.add_argument("--baseline", default=DEFAULT_BASELINE,
                        help="baseline JSON (default: the committed "
                             "analysis/baseline.json)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore the baseline (report everything)")
    parser.add_argument("--strict-baseline", action="store_true",
                        help="fail on stale baseline entries too")
    try:
        args = parser.parse_args(argv)
    except SystemExit as exc:          # argparse's usage errors
        return int(exc.code or 0)

    findings = analyze_paths(args.paths)
    entries = [] if args.no_baseline else load_baseline(args.baseline)
    new, old, stale = split_by_baseline(findings, entries)

    for f in new:
        print(f.format())
    if old:
        print(f"[hntlint] {len(old)} baselined finding(s) suppressed",
              file=sys.stderr)
    for e in stale:
        print(f"[hntlint] stale baseline entry: {e['rule']} {e['path']} "
              f"{e['key']} (fixed? delete it)", file=sys.stderr)

    if new:
        print(f"[hntlint] {len(new)} new finding(s)", file=sys.stderr)
        return 1
    if stale and args.strict_baseline:
        return 1
    print(f"[hntlint] clean: {len(findings) - len(new)} baselined, "
          f"0 new", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
