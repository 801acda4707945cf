"""``python -m repro_torch.analyze`` / ``repro-torch-analyze``: the gate
over the port's tree — ``repro/analyze/cli.py`` counterpart.

Exits 1 when any active (non-suppressed) finding remains, 0 on a clean
tree. ``--json`` writes the machine-readable report.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analyze.engine import analyze_paths, write_json
from repro_torch.analyze.registry import get_rule, registered

DEFAULT_PATHS = ["src/repro_torch"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro-torch-analyze",
        description="privacy- and sync-safety static analysis for the "
                    "repro_torch tree")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="files or directories to analyze (default: "
                         "src/repro_torch)")
    ap.add_argument("--rules", default="",
                    help="comma-separated subset of rules to run")
    ap.add_argument("--json", dest="json_out", default="",
                    help="also write a JSON report to this path")
    ap.add_argument("--list-rules", action="store_true",
                    help="print registered rules and exit")
    ap.add_argument("--include-fixtures", action="store_true",
                    help="analyze tests/fixtures trees too (they hold "
                    "seeded violations and are skipped by default)")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress the human report (exit code only)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for name in registered():
            print(f"{name:18s} {get_rule(name).doc}")
        return 0
    rules = [r.strip() for r in args.rules.split(",") if r.strip()] or None
    report = analyze_paths(args.paths or list(DEFAULT_PATHS), rules=rules,
                           include_fixtures=args.include_fixtures)
    if args.json_out:
        write_json(report, args.json_out)
    if not args.quiet:
        print(report.human())
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
