"""graftlint output formats for the port: human text and machine JSON."""

from __future__ import annotations

import json
from typing import IO

from gtopkssgd_tpu_torch.analysis.engine import Result


def text_report(result: Result, out: IO[str], verbose: bool = False) -> None:
    for f in result.findings:
        out.write(f"{f.location()}: [{f.rule}] {f.message}\n")
        if f.snippet:
            out.write(f"    {f.snippet}\n")
    if verbose:
        for f in result.baselined:
            out.write(f"{f.location()}: [{f.rule}] baselined: "
                      f"{f.message}\n")
        for f in result.suppressed:
            out.write(f"{f.location()}: [{f.rule}] suppressed: "
                      f"{f.message}\n")
    for key in result.stale_baseline:
        out.write(f"stale baseline entry (no longer fires): {key}\n")
    out.write(
        f"graftlint: {result.files_scanned} files, "
        f"{len(result.findings)} finding(s), "
        f"{len(result.baselined)} baselined, "
        f"{len(result.suppressed)} suppressed"
        + (f", {len(result.stale_baseline)} stale baseline entr"
           f"{'y' if len(result.stale_baseline) == 1 else 'ies'}"
           if result.stale_baseline else "")
        + "\n")


def json_report(result: Result, out: IO[str]) -> None:
    def rows(findings):
        return [{
            "rule": f.rule, "path": f.path, "line": f.line,
            "col": f.col, "message": f.message, "symbol": f.symbol,
            "snippet": f.snippet,
        } for f in findings]

    json.dump({
        "findings": rows(result.findings),
        "baselined": rows(result.baselined),
        "suppressed": rows(result.suppressed),
        "stale_baseline": result.stale_baseline,
        "files_scanned": result.files_scanned,
    }, out, indent=1, sort_keys=True)
    out.write("\n")
