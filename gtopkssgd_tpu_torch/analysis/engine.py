"""graftlint core for the port: file model, suppressions, baseline,
rule runner (the port of ``gtopkssgd_tpu/analysis/engine.py``).

Pure stdlib (ast/json/tokenize) on purpose: the analyzer runs on a
machine without a card or a CUDA build of PyTorch and never pays a
``torch`` import. Registry values it needs at analysis time (metric
KINDS, the exit-code registry, the event rules) are themselves extracted
from the port's *source* by AST (rules.py).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set

# ``# graftlint: disable=rule-a,rule-b`` (or ``all``) on the flagged
# line or the line directly above it.
_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable=([A-Za-z0-9_,\-\s]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to source.

    ``symbol`` is the qualified name of the enclosing function (or
    ``<module>``); ``snippet`` is the unparsed flagged expression. The
    baseline matches on (rule, path, symbol, snippet) — line numbers are
    display-only, so a baselined finding survives unrelated edits to the
    same file.
    """

    rule: str
    path: str      # repo-relative, forward slashes
    line: int
    col: int
    message: str
    symbol: str = "<module>"
    snippet: str = ""

    @property
    def baseline_key(self) -> str:
        return "::".join(
            (self.rule, self.path, self.symbol, self.snippet))

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"


class SourceFile:
    """One parsed module: AST + per-line suppression sets."""

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.text = text
        self.tree = ast.parse(text, filename=path)
        self.suppressions: Dict[int, Set[str]] = {}
        self._scan_suppressions(text)

    def _scan_suppressions(self, text: str) -> None:
        # tokenize (not a line regex) so a '# graftlint:' inside a string
        # literal is not a suppression.
        try:
            tokens = tokenize.generate_tokens(io.StringIO(text).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _SUPPRESS_RE.search(tok.string)
                if not m:
                    continue
                rules = {r.strip() for r in m.group(1).split(",")
                         if r.strip()}
                self.suppressions.setdefault(
                    tok.start[0], set()).update(rules)
        except tokenize.TokenError:
            pass

    def suppressed(self, finding: Finding) -> bool:
        for line in (finding.line, finding.line - 1):
            rules = self.suppressions.get(line)
            if rules and ("all" in rules or finding.rule in rules):
                return True
        return False


def _iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            yield p
        elif os.path.isdir(p):
            for dirpath, dirnames, files in os.walk(p):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d != "__pycache__" and not d.startswith("."))
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(dirpath, name)


def load_files(paths: Sequence[str],
               root: Optional[str] = None) -> List[SourceFile]:
    """Parse every .py under ``paths``; ``root`` anchors the
    repo-relative names findings and baselines use (default: cwd)."""
    root = os.path.abspath(root or os.getcwd())
    out: List[SourceFile] = []
    for path in _iter_py_files(paths):
        ap = os.path.abspath(path)
        rel = os.path.relpath(ap, root)
        with open(ap, encoding="utf-8") as fh:
            text = fh.read()
        try:
            out.append(SourceFile(ap, rel, text))
        except SyntaxError as e:
            # A file the interpreter would reject is its own finding —
            # surfaced by the runner, not silently skipped.
            sf = SourceFile.__new__(SourceFile)
            sf.path, sf.rel, sf.text = ap, rel.replace(os.sep, "/"), text
            sf.tree = None
            sf.suppressions = {}
            sf.syntax_error = e  # type: ignore[attr-defined]
            out.append(sf)
    return out


# ------------------------------------------------------------------ baseline

def load_baseline(path: str) -> Dict[str, dict]:
    """Baseline JSON -> {baseline_key: entry}. Schema: {"findings":
    [{"rule","path","symbol","snippet","reason"}...]} — ``reason`` is
    the mandatory one-line justification for grandfathering."""
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    entries = data.get("findings", [])
    out: Dict[str, dict] = {}
    for e in entries:
        key = "::".join((e.get("rule", ""), e.get("path", ""),
                         e.get("symbol", ""), e.get("snippet", "")))
        out[key] = e
    return out


def write_baseline(path: str, findings: Sequence[Finding],
                   old: Optional[Dict[str, dict]] = None) -> None:
    """Grandfather ``findings``, carrying forward reasons from an
    existing baseline where keys match; new entries get a TODO reason
    that review is expected to replace."""
    old = old or {}
    rows = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        prev = old.get(f.baseline_key, {})
        rows.append({
            "rule": f.rule,
            "path": f.path,
            "symbol": f.symbol,
            "snippet": f.snippet,
            "message": f.message,
            "reason": prev.get("reason",
                               "TODO: justify or fix this finding"),
        })
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"findings": rows}, fh, indent=1, sort_keys=True)
        fh.write("\n")


# -------------------------------------------------------------------- runner

@dataclasses.dataclass
class Result:
    findings: List[Finding]            # actionable (not suppressed/baselined)
    suppressed: List[Finding]
    baselined: List[Finding]
    stale_baseline: List[str]          # baseline keys that no longer fire
    files_scanned: int


def analyze(files: Sequence[SourceFile],
            rules: Sequence,           # Sequence[Rule] (rules.py)
            rule_names: Optional[Set[str]] = None) -> List[Finding]:
    """Run rules over parsed files; returns RAW findings (suppressions
    and baseline are applied by ``run``)."""
    findings: List[Finding] = []
    broken = [f for f in files if f.tree is None]
    for f in broken:
        e = getattr(f, "syntax_error", None)
        findings.append(Finding(
            rule="syntax", path=f.rel,
            line=getattr(e, "lineno", 1) or 1,
            col=getattr(e, "offset", 0) or 0,
            message=f"file does not parse: {e}",
        ))
    parsed = [f for f in files if f.tree is not None]
    for rule in rules:
        if rule_names and rule.name not in rule_names:
            continue
        findings.extend(rule.run(parsed))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def run(paths: Sequence[str], *, rules: Sequence,
        baseline: Optional[Dict[str, dict]] = None,
        rule_names: Optional[Set[str]] = None,
        root: Optional[str] = None) -> Result:
    files = load_files(paths, root=root)
    raw = analyze(files, rules, rule_names=rule_names)
    by_rel = {f.rel: f for f in files}
    actionable: List[Finding] = []
    suppressed: List[Finding] = []
    baselined: List[Finding] = []
    seen_keys: Set[str] = set()
    baseline = baseline or {}
    for f in raw:
        sf = by_rel.get(f.path)
        if sf is not None and sf.suppressed(f):
            suppressed.append(f)
        elif f.baseline_key in baseline:
            seen_keys.add(f.baseline_key)
            baselined.append(f)
        else:
            actionable.append(f)
    stale = sorted(set(baseline) - seen_keys)
    return Result(findings=actionable, suppressed=suppressed,
                  baselined=baselined, stale_baseline=stale,
                  files_scanned=len(files))
