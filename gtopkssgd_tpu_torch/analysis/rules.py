"""The port's graftlint rule set: the JAX package's six invariants
(``gtopkssgd_tpu/analysis/rules.py``), under the same names, so that
``--rule`` and ``# graftlint: disable=RULE`` mean the same in both
packages.

Registry-backed rules (metric-kind, exit-code, event-rule) read their
registries from the port's SOURCE by AST, never by import (which would
pull in ``torch``), so the analyzer runs where PyTorch is not installed.
When the scanned file set itself contains ``utils/metrics.py`` / a
registry module, that copy wins (fixture trees in tests override the
package); otherwise the files shipped next to this analyzer are read.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from gtopkssgd_tpu_torch.analysis.callgraph import (
    CallGraph,
    FuncInfo,
    ModuleInfo,
    expr_is_tensor,
    module_info,
    own_statements,
    tensor_names,
)
from gtopkssgd_tpu_torch.analysis.engine import Finding, SourceFile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _snippet(node: ast.AST, limit: int = 80) -> str:
    try:
        text = ast.unparse(node)
    except Exception:
        text = type(node).__name__
    return text if len(text) <= limit else text[:limit - 3] + "..."


def _enclosing(sf: SourceFile, node: ast.AST) -> str:
    """Qualified name of the innermost function containing ``node``
    (line-range containment — good enough for display/baseline keys)."""
    best = "<module>"
    best_span = None
    target = getattr(node, "lineno", None)
    if target is None:
        return best
    stack: List[Tuple[ast.AST, str]] = [(sf.tree, "")]
    while stack:
        cur, prefix = stack.pop()
        for child in ast.iter_child_nodes(cur):
            name = getattr(child, "name", None)
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                qual = f"{prefix}{name}"
                lo = child.lineno
                hi = max((getattr(n, "lineno", lo)
                          for n in ast.walk(child)), default=lo)
                if lo <= target <= hi and not isinstance(
                        child, ast.ClassDef):
                    span = hi - lo
                    if best_span is None or span <= best_span:
                        best, best_span = qual, span
                stack.append((child, qual + "."))
            else:
                stack.append((child, prefix))
    return best


def _finding(rule: str, sf: SourceFile, node: ast.AST, message: str,
             symbol: Optional[str] = None) -> Finding:
    return Finding(
        rule=rule, path=sf.rel,
        line=getattr(node, "lineno", 1),
        col=getattr(node, "col_offset", 0),
        message=message,
        symbol=symbol or _enclosing(sf, node),
        snippet=_snippet(node))


# --------------------------------------------------------------------------
# Registry extraction (AST only — see module docstring).
# --------------------------------------------------------------------------

def _load_source(files: Sequence[SourceFile],
                 rel_suffix: str) -> Optional[ast.AST]:
    for sf in files:
        if sf.rel.endswith(rel_suffix):
            return sf.tree
    fallback = os.path.join(_PKG_DIR, *rel_suffix.split("/"))
    if os.path.exists(fallback):
        with open(fallback, encoding="utf-8") as fh:
            return ast.parse(fh.read(), filename=fallback)
    return None


def registered_kinds(files: Sequence[SourceFile] = ()) -> Set[str]:
    """``utils.metrics.KINDS`` recovered from source."""
    tree = _load_source(files, "utils/metrics.py")
    kinds: Set[str] = set()
    if tree is None:
        return kinds
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == "KINDS"
                   for t in node.targets):
            continue
        for leaf in ast.walk(node.value):
            if isinstance(leaf, ast.Constant) and isinstance(
                    leaf.value, str):
                kinds.add(leaf.value)
    return kinds


def registered_event_rules(files: Sequence[SourceFile] = ()) -> Set[str]:
    """``obs.events.RULES`` (the anomaly rule-name registry) recovered
    from source, same AST-only discipline as ``registered_kinds``."""
    tree = _load_source(files, "obs/events.py")
    rules: Set[str] = set()
    if tree is None:
        return rules
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == "RULES"
                   for t in node.targets):
            continue
        for leaf in ast.walk(node.value):
            if isinstance(leaf, ast.Constant) and isinstance(
                    leaf.value, str):
                rules.add(leaf.value)
    return rules


def exit_code_registry(
        files: Sequence[SourceFile] = ()) -> Dict[int, List[str]]:
    """``gtopkssgd_tpu_torch.exit_codes`` constants from source:
    {code: [names...]} — more than one name per code is a collision."""
    tree = _load_source(files, "exit_codes.py")
    out: Dict[int, List[str]] = {}
    if tree is None:
        return out
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not (isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, int)
                and not isinstance(node.value.value, bool)):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id.startswith("EXIT_"):
                out.setdefault(node.value.value, []).append(t.id)
    return out


# --------------------------------------------------------------------------
# Rule 1: host-sync-in-jit
# --------------------------------------------------------------------------

class HostSyncInJitRule:
    """No host synchronization on the port's hot path.

    "jit" keeps the JAX rule's name; in the port it means the code that
    runs every step on the card: what a CUDA graph captures (a sync
    there fails the capture), what ``torch.compile`` compiles, and the
    optimizer's ``step`` (callgraph.py has the roots). A blocking read
    of a device value there stalls the host until the card drains its
    queue, and under ``--pipeline overlap`` serializes the merge thread
    with the selection. The rule builds the reachable set and flags,
    inside it, ``.item()``, ``.tolist()``, ``.numpy()``, ``.cpu()`` and
    ``.to("cpu")`` (the port's ``jax.device_get``),
    ``torch.cuda.synchronize`` and ``Event``/``Stream.synchronize()``,
    ``float()``/``int()``/``bool()`` of a tensor, ``np.asarray`` /
    ``np.array`` of a tensor, and ``print`` of a tensor.
    """

    name = "host-sync-in-jit"

    _COERCIONS = {"float", "int", "bool", "complex"}
    _READS = {"item", "tolist", "numpy", "cpu"}

    def run(self, files: Sequence[SourceFile]) -> List[Finding]:
        graph = CallGraph(files)
        findings: List[Finding] = []
        for fi in graph.reachable_functions():
            m = graph.by_rel[fi.sf.rel]
            tainted = tensor_names(fi, m)
            for node in own_statements(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                findings.extend(
                    self._check_call(m, fi, node, tainted))
        return findings

    def _check_call(self, m: ModuleInfo, fi: FuncInfo, node: ast.Call,
                    tainted: Set[str]) -> List[Finding]:
        out: List[Finding] = []
        func = node.func
        where = f"hot-path `{fi.qualname}`"

        def flag(msg: str) -> None:
            out.append(_finding(self.name, fi.sf, node,
                                f"{msg} inside {where}",
                                symbol=fi.qualname))

        if isinstance(func, ast.Attribute):
            if func.attr in self._READS and not node.args \
                    and not node.keywords:
                flag(f"`.{func.attr}()` forces a device->host sync")
                return out
            if func.attr == "to" and _to_cpu(m, node):
                flag("`.to(\"cpu\")` forces a device->host copy")
                return out
            if func.attr == "synchronize":
                flag(f"`{_snippet(func)}()` blocks the host on the card")
                return out
        full = m.full_name(func)
        if full in {"np.asarray", "numpy.asarray", "np.array",
                    "numpy.array"} and node.args and expr_is_tensor(
                        node.args[0], tainted, m):
            flag(f"`{full}` of a tensor forces a host transfer")
            return out
        if isinstance(func, ast.Name):
            if func.id == "print" and any(
                    expr_is_tensor(a, tainted, m) for a in node.args):
                flag("`print` of a tensor syncs (log it after the step)")
            elif (func.id in self._COERCIONS and len(node.args) == 1
                    and expr_is_tensor(node.args[0], tainted, m)):
                flag(f"`{func.id}()` of a tensor blocks on the queued "
                     "work")
        return out


def _to_cpu(m: ModuleInfo, call: ast.Call) -> bool:
    """``x.to("cpu")``, ``x.to(device="cpu")``, ``x.to(torch.device(
    "cpu"))``."""
    args = list(call.args[:1]) + [kw.value for kw in call.keywords
                                  if kw.arg == "device"]
    for a in args:
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
        if (isinstance(a, ast.Call) and m.full_name(a.func) == "torch.device"
                and a.args and isinstance(a.args[0], ast.Constant)
                and a.args[0].value == "cpu"):
            return True
    return False


# --------------------------------------------------------------------------
# Shared .log( call-site model (rules 2 and 5)
# --------------------------------------------------------------------------

_LOG_EXCLUDED_ROOTS = {"np", "jnp", "numpy", "math", "logging", "torch"}


def _metric_log_calls(m: ModuleInfo):
    """Yield (call, resolved_kind | None, reason) for every call site
    that looks like ``MetricsLogger.log`` — an attribute call named
    ``log`` with a positional first argument, excluding numeric/stdlib
    ``log`` receivers (np.log, math.log, Logger handles named *logger*).
    resolved_kind is the first argument as a string when it is a
    literal or a name statically bound to one; reason explains the
    failure otherwise ("f-string", "unresolved")."""
    for node in ast.walk(m.sf.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "log" and node.args):
            continue
        recv = m.full_name(node.func.value)
        if recv:
            parts = recv.split(".")
            if parts[0] in _LOG_EXCLUDED_ROOTS or any(
                    "logger" in p.lower() for p in parts):
                continue
        kind, reason = _resolve_kind(m, node, node.args[0])
        yield node, kind, reason


def _resolve_kind(m: ModuleInfo, call: ast.Call,
                  arg: ast.AST) -> Tuple[Optional[str], str]:
    if isinstance(arg, ast.Constant):
        if isinstance(arg.value, str):
            return arg.value, ""
        return None, f"non-string literal {arg.value!r}"
    if isinstance(arg, ast.JoinedStr):
        return None, "f-string (dynamic kind)"
    if isinstance(arg, ast.Name):
        # Nearest static binding: a function-local `k = "obs"` wins over
        # a module-level constant of the same name.
        for scope in (_enclosing_node(m.sf.tree, call), m.sf.tree):
            if scope is None:
                continue
            bound = _string_binding(scope, arg.id)
            if bound is not None:
                return bound, ""
        return None, f"name `{arg.id}` not bound to a string constant"
    return None, "dynamic kind expression"


def _enclosing_node(tree: ast.AST, target: ast.AST) -> Optional[ast.AST]:
    line = getattr(target, "lineno", None)
    if line is None:
        return None
    best, best_span = None, None
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        hi = max((getattr(n, "lineno", node.lineno)
                  for n in ast.walk(node)), default=node.lineno)
        if node.lineno <= line <= hi:
            span = hi - node.lineno
            if best_span is None or span <= best_span:
                best, best_span = node, span
    return best


def _string_binding(scope: ast.AST, name: str) -> Optional[str]:
    value: Optional[str] = None
    for node in ast.walk(scope):
        if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Constant) and isinstance(
                    node.value.value, str):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    value = node.value.value
    return value


# --------------------------------------------------------------------------
# Rule 2: metric-kind
# --------------------------------------------------------------------------

class MetricKindRule:
    """Every ``.log(...)`` kind must be a member of
    ``utils.metrics.KINDS``, resolved statically: the AST resolver
    follows names bound to string constants and rejects f-strings and
    dynamic expressions, which a text search could not see."""

    name = "metric-kind"

    def run(self, files: Sequence[SourceFile]) -> List[Finding]:
        kinds = registered_kinds(files)
        if not kinds:
            return []
        findings: List[Finding] = []
        for sf in files:
            m = module_info(sf)
            for call, kind, reason in _metric_log_calls(m):
                if kind is not None:
                    if kind not in kinds:
                        findings.append(_finding(
                            self.name, sf, call,
                            f"unregistered metrics kind {kind!r} — add "
                            "it to gtopkssgd_tpu_torch.utils.metrics.KINDS"))
                else:
                    findings.append(_finding(
                        self.name, sf, call,
                        f"metrics kind is not statically resolvable "
                        f"({reason}) — use a registered literal"))
        return findings


# --------------------------------------------------------------------------
# Rule 3: exit-code
# --------------------------------------------------------------------------

class ExitCodeRule:
    """Process exit codes are a cross-tool contract (launchers and retry
    loops classify runs by rc without parsing logs), so every literal
    ``sys.exit`` / ``SystemExit`` / ``os._exit`` code must come from the
    single-source registry ``gtopkssgd_tpu_torch/exit_codes.py`` — and no
    module may mint its own ``*_EXIT_CODE`` constant outside it."""

    name = "exit-code"

    _EXIT_CALLS = {"sys.exit", "os._exit", "SystemExit", "exit"}
    _CONST_RE = re.compile(r"(^EXIT_|_EXIT_CODE$|^EXITCODE)")

    def run(self, files: Sequence[SourceFile]) -> List[Finding]:
        registry = exit_code_registry(files)
        findings: List[Finding] = []
        for code, names in sorted(registry.items()):
            if len(names) > 1:
                reg = [sf for sf in files
                       if sf.rel.endswith("exit_codes.py")]
                sf = reg[0] if reg else files[0]
                findings.append(Finding(
                    rule=self.name, path=sf.rel, line=1, col=0,
                    message=f"exit-code collision: {sorted(names)} all "
                            f"map to {code}",
                    symbol="<registry>", snippet=str(code)))
        known = set(registry)
        for sf in files:
            m = module_info(sf)
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Call):
                    full = m.full_name(node.func)
                    if full in self._EXIT_CALLS and node.args:
                        code = _int_literal(node.args[0])
                        if code is not None and code not in known:
                            findings.append(_finding(
                                self.name, sf, node,
                                f"exit code {code} is not in the "
                                "gtopkssgd_tpu_torch.exit_codes registry"))
                elif isinstance(node, ast.Assign):
                    if sf.rel.endswith("exit_codes.py"):
                        continue
                    code = _int_literal(node.value)
                    if code is None:
                        continue
                    for t in node.targets:
                        if isinstance(t, ast.Name) and self._CONST_RE.search(
                                t.id):
                            findings.append(_finding(
                                self.name, sf, node,
                                f"exit-code constant `{t.id} = {code}` "
                                "defined outside gtopkssgd_tpu_torch/"
                                "exit_codes.py — import it from the "
                                "registry instead"))
        return findings


def _int_literal(node: ast.AST) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = _int_literal(node.operand)
        return -inner if inner is not None else None
    return None


# --------------------------------------------------------------------------
# Rule 4: codec-wire
# --------------------------------------------------------------------------

class CodecWireRule:
    """Every sparse (vals, idx) exchange in ``parallel/`` — and in
    ``optimizer.py``, where the bucketed layerwise path concatenates
    each bucket's leaves and merges them — must flow through the wire
    codec (``codec.encode`` / the merge tree's ``_ship()`` /
    ``sparse_allreduce``, whose internals are themselves scanned), so
    no collective can silently bypass the wire format and break
    cross-rank bit-identity. Dense payloads (``all_reduce`` for the
    dense mode and the in-slice sum, grad-norm means) are exempt — the
    codec applies to sparse sets only. The collective set is
    ``torch.distributed``'s point-to-point (``send``, ``recv``,
    ``isend``, ``irecv``, ``P2POp``, ``batch_isend_irecv``) and its
    gathers, scatters and broadcasts (``all_gather``,
    ``all_gather_into_tensor``, ``all_to_all``, ``all_to_all_single``,
    ``broadcast``). Every POSITIONAL operand is scanned, not just the
    leading one: torch collectives take the output buffer first, and a
    schedule that dodges the codec dodges the whole bit-identity audit.
    The sparse-name pattern also matches the bucketed path's per-bucket
    buffers (``vals_b``, ``idx_b``, plural ``_list`` forms)."""

    name = "codec-wire"

    _COLLECTIVES = {f"{root}.{op}" for root in ("torch.distributed", "dist")
                    for op in ("isend", "irecv", "send", "recv", "P2POp",
                               "batch_isend_irecv", "all_gather",
                               "all_gather_into_tensor", "all_to_all",
                               "all_to_all_single", "broadcast")}
    _SPARSE_NAME = re.compile(
        r"(^|_)(vals|idx|indices|values)(_b|_list)?$", re.IGNORECASE)
    _SCANNED = ("parallel/", "optimizer.py")

    def run(self, files: Sequence[SourceFile]) -> List[Finding]:
        findings: List[Finding] = []
        for sf in files:
            if not any(part in sf.rel for part in self._SCANNED):
                continue
            m = module_info(sf)
            for fi in m.funcs:
                sanctioned = self._wire_names(fi)
                for node in own_statements(fi.node):
                    if not isinstance(node, ast.Call):
                        continue
                    if m.full_name(node.func) not in self._COLLECTIVES:
                        continue
                    if not node.args:
                        continue
                    names = {n.id for arg in node.args
                             for n in ast.walk(arg)
                             if isinstance(n, ast.Name)}
                    if names & sanctioned:
                        continue  # ships codec.encode output
                    sparse = sorted(
                        n for n in names if self._SPARSE_NAME.search(n))
                    if sparse:
                        findings.append(_finding(
                            self.name, sf, node,
                            f"raw collective ships sparse payload "
                            f"({', '.join(sparse)}) without "
                            "codec.encode/ship() — every sparse "
                            "exchange must go through the wire codec",
                            symbol=fi.qualname))
        return findings

    def _wire_names(self, fi: FuncInfo) -> Set[str]:
        """Names holding codec.encode output (directly, via unpacking,
        or iterated element-wise) — the sanctioned wire buffers."""
        sanctioned: Set[str] = set()

        def rhs_is_wire(value: ast.AST) -> bool:
            for n in ast.walk(value):
                if isinstance(n, ast.Call) and isinstance(
                        n.func, ast.Attribute) and n.func.attr == "encode":
                    return True
                if isinstance(n, ast.Name) and n.id in sanctioned:
                    return True
            return False

        changed = True
        while changed:
            changed = False
            for node in own_statements(fi.node):
                pairs: List[Tuple[ast.AST, ast.AST]] = []
                if isinstance(node, ast.Assign):
                    pairs = [(t, node.value) for t in node.targets]
                elif isinstance(node, ast.For):
                    pairs = [(node.target, node.iter)]
                elif isinstance(node, ast.comprehension):
                    pairs = [(node.target, node.iter)]
                for target, value in pairs:
                    if not rhs_is_wire(value):
                        continue
                    for leaf in ast.walk(target):
                        if isinstance(leaf, ast.Name) \
                                and leaf.id not in sanctioned:
                            sanctioned.add(leaf.id)
                            changed = True
        return sanctioned


# --------------------------------------------------------------------------
# Rule 5: durable-event
# --------------------------------------------------------------------------

class DurableEventRule:
    """Records that exist to survive a hard kill — anomaly ``event``s,
    injected-fault ``inject`` firings, ``recovery`` actions, comm-model
    ``calib`` refits, ``regress``/``overlap`` evidence rows, and
    ``critpath`` stage-interval records (the post-mortem "which stage
    bounded the last step" evidence) — must be fsync'd at the call
    site: ``.log(kind, flush=True, ...)``. Line buffering alone only
    reaches the OS, and these kinds are exactly the ones read back
    after a crash."""

    name = "durable-event"

    DURABLE_KINDS = {"event", "inject", "recovery", "calib", "regress",
                     "compile", "overlap", "critpath", "goodput",
                     "linkmap", "forecast", "resize"}

    def run(self, files: Sequence[SourceFile]) -> List[Finding]:
        findings: List[Finding] = []
        for sf in files:
            m = module_info(sf)
            for call, kind, _reason in _metric_log_calls(m):
                if kind not in self.DURABLE_KINDS:
                    continue
                flush = next((kw.value for kw in call.keywords
                              if kw.arg == "flush"), None)
                ok = (isinstance(flush, ast.Constant)
                      and flush.value is True)
                if not ok:
                    findings.append(_finding(
                        self.name, sf, call,
                        f"durable kind {kind!r} logged without "
                        "flush=True — the record must be fsync'd to "
                        "survive a hard kill"))
        return findings


# --------------------------------------------------------------------------
# Rule 6: event-rule
# --------------------------------------------------------------------------

class EventRuleRule:
    """Every anomaly-event rule name stamped at an emit site must be a
    member of ``obs.events.RULES`` — the event-plane mirror of the
    metric-kind rule. ``_emit`` already rejects unregistered names at
    runtime; this rule catches the typo before any run, at the two
    static shapes emit sites take: a dict literal with a ``"rule"`` key
    (the monitor's own event records) and the first argument of a local
    ``fire(...)`` helper (the threshold-rule bodies)."""

    name = "event-rule"

    def run(self, files: Sequence[SourceFile]) -> List[Finding]:
        rules = registered_event_rules(files)
        if not rules:
            return []
        findings: List[Finding] = []
        for sf in files:
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Dict):
                    for key, val in zip(node.keys, node.values):
                        if (isinstance(key, ast.Constant)
                                and key.value == "rule"
                                and isinstance(val, ast.Constant)
                                and isinstance(val.value, str)
                                and val.value not in rules):
                            findings.append(_finding(
                                self.name, sf, node,
                                f"unregistered event rule "
                                f"{val.value!r} — add it to "
                                "gtopkssgd_tpu_torch.obs.events.RULES (and "
                                "the README event table)"))
                elif (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id == "fire" and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)
                        and node.args[0].value not in rules):
                    findings.append(_finding(
                        self.name, sf, node,
                        f"unregistered event rule "
                        f"{node.args[0].value!r} — add it to "
                        "gtopkssgd_tpu_torch.obs.events.RULES (and the "
                        "README event table)"))
        return findings


ALL_RULES = (
    HostSyncInJitRule(),
    MetricKindRule(),
    ExitCodeRule(),
    CodecWireRule(),
    DurableEventRule(),
    EventRuleRule(),
)

RULES_BY_NAME = {r.name: r for r in ALL_RULES}
