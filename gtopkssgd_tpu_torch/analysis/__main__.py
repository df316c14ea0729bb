"""CLI: ``python -m gtopkssgd_tpu_torch.analysis [paths...]``.

Exit codes come from the registry this tool itself enforces
(gtopkssgd_tpu_torch.exit_codes): 0 clean, 1 non-baselined findings, 2
usage. The default baseline is ``baseline.json`` beside this module, so a
run from any directory reads the port's own grandfathered findings.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

from gtopkssgd_tpu_torch.analysis import engine, reporters
from gtopkssgd_tpu_torch.analysis.rules import ALL_RULES, RULES_BY_NAME
from gtopkssgd_tpu_torch.exit_codes import EXIT_ERROR, EXIT_OK, EXIT_USAGE

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")
# The checkout's root: the repo-relative names of the baseline's keys.
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _root(paths: Sequence[str]) -> str:
    """The checkout's root when every path lies inside it (the
    baseline's keys then match from any working directory), else the
    working directory."""
    inside = all(os.path.commonpath([_REPO, os.path.abspath(p)]) == _REPO
                 for p in paths)
    return _REPO if inside else os.getcwd()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        "gtopkssgd_tpu_torch.analysis",
        description="graftlint: AST invariant checker for the port's hot "
                    "path, the metric/exit-code registries, and "
                    "codec-mediated collectives.")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to scan (default: the "
                         "gtopkssgd_tpu_torch package next to this "
                         "analyzer)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--baseline", default=None, metavar="PATH",
                    help="baseline JSON of grandfathered findings "
                         "(default: baseline.json beside this module)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline: report every finding")
    ap.add_argument("--write-baseline", default=None, metavar="PATH",
                    help="grandfather the current findings into PATH "
                         "(carries forward reasons for unchanged keys) "
                         "and exit 0")
    ap.add_argument("--rule", action="append", default=None,
                    metavar="RULE", help="run only this rule (repeat "
                                         "for several)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also print suppressed/baselined findings")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            doc = (rule.__doc__ or "").strip().splitlines()[0]
            print(f"{rule.name:20s} {doc}")
        return EXIT_OK

    if args.rule:
        unknown = sorted(set(args.rule) - set(RULES_BY_NAME))
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)} "
                  f"(see --list-rules)", file=sys.stderr)
            return EXIT_USAGE

    paths = args.paths or [os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))]
    for p in paths:
        if not os.path.exists(p):
            print(f"no such path: {p}", file=sys.stderr)
            return EXIT_USAGE

    baseline = {}
    baseline_path = args.baseline or (
        DEFAULT_BASELINE if os.path.exists(DEFAULT_BASELINE) else None)
    if baseline_path and not args.no_baseline:
        try:
            baseline = engine.load_baseline(baseline_path)
        except (OSError, ValueError) as e:
            print(f"cannot read baseline {baseline_path}: {e}",
                  file=sys.stderr)
            return EXIT_USAGE

    result = engine.run(
        paths, rules=ALL_RULES, baseline=baseline,
        rule_names=set(args.rule) if args.rule else None,
        root=_root(paths))

    if args.write_baseline:
        engine.write_baseline(
            args.write_baseline,
            result.findings + result.baselined, old=baseline)
        print(f"wrote {len(result.findings) + len(result.baselined)} "
              f"baseline entries to {args.write_baseline}")
        return EXIT_OK

    if args.json:
        reporters.json_report(result, sys.stdout)
    else:
        reporters.text_report(result, sys.stdout, verbose=args.verbose)
    return EXIT_ERROR if result.findings else EXIT_OK


if __name__ == "__main__":
    raise SystemExit(main())
