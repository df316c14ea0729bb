"""Hot-path reachability and value-taint machinery for the port's
graftlint rules (the port of ``gtopkssgd_tpu/analysis/callgraph.py``).

Answers two questions from source alone:

  1. Which functions run on the HOT PATH, where a host sync stalls the
     step? What ``jax.jit`` tracing is to the JAX package, CUDA graph
     capture and compilation are to the port. Entry points:

     * every function called inside a ``with torch.cuda.graph(...)``
       block (the trainer's ``_capture`` records ``_train_step`` so);
     * every function passed to ``torch.compile`` or
       ``torch.cuda.make_graphed_callables``, or decorated with
       ``torch.compile``;
     * by module contract, the optimizer's ``step`` (``optimizer.py``),
       which runs every step, eager or captured.

     Reachability is the transitive closure over *name references* (not
     just direct calls), so helpers passed as values are followed.

  2. Which local names hold TENSOR values? Per function, a fixpoint
     taint: the parameters of a hot function (a step's inputs are
     tensors), the results of ``torch.*`` calls and of methods called on
     a tensor, and the names bound from those; lambda parameters count
     too. A parameter annotated with a host type (``k: int``,
     ``density: float``, ``method: str``, ...) or defaulting to a host
     constant (``k=8``, ``name="x"``) is host data, not a tensor. Reads
     of tensor metadata (``x.shape``, ``x.size(0)``, ``x.numel()``,
     ``x.dtype``, ``x.device``, ...) are host data too: ``int(x.numel())``
     reads no device memory. ``torch.*`` calls that return host objects
     (``torch.device``, ``torch.cuda.*``, ``torch.distributed.*``, ...)
     produce no tensor.

Nested ``def``s are separate functions (a method that CONTAINS a
captured step is not itself hot); ``lambda``s are treated as part of
their enclosing function.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from gtopkssgd_tpu_torch.analysis.engine import SourceFile

# Context managers whose body is recorded into a CUDA graph.
GRAPH_CONTEXTS = {"torch.cuda.graph", "torch.cuda.graphs.graph"}
# Wrappers whose callee (decorated function / first argument) is captured
# or compiled.
GRAPH_WRAPPERS = {
    "torch.compile", "torch.cuda.make_graphed_callables",
    "torch.cuda.graphs.make_graphed_callables",
}
_PARTIALS = {"functools.partial", "partial"}

# Attribute reads (and metadata methods) that never touch device memory.
STATIC_ATTRS = {
    "shape", "size", "ndim", "dtype", "device", "is_cuda", "numel", "dim",
    "element_size", "stride", "nbytes", "itemsize", "requires_grad",
    "layout", "data_ptr", "is_contiguous", "storage_offset", "get_device",
    "is_floating_point", "is_complex", "name",
}

# ``torch.*`` calls that return host objects, not tensors (prefixes of
# the full dotted name).
_HOST_TORCH = (
    "torch.device", "torch.dtype", "torch.Size", "torch.finfo",
    "torch.iinfo", "torch.cuda.", "torch.distributed.", "torch.backends.",
    "torch.is_", "torch.get_", "torch.set_", "torch.no_grad",
    "torch.enable_grad", "torch.inference_mode", "torch.Generator",
    "torch.profiler.", "torch.autograd.profiler.", "torch.version",
    "torch.compile", "torch.utils.",
)

# Builtins whose result is host data whatever their argument.
_HOST_BUILTINS = {"len", "isinstance", "hasattr", "type", "id", "callable",
                  "range", "repr", "str"}

# Calls rooted here only propagate taint that flows in through an
# argument (np.asarray of a static python list is host data).
_ARG_TRACED_ROOTS = {"np", "numpy"}

# Annotations that name host data.
_HOST_ANNOTATIONS = {"int", "float", "bool", "str", "complex", "bytes",
                     "None", "dict", "list", "tuple", "set", "Dict", "List",
                     "Tuple", "Set", "Sequence", "Mapping", "Callable",
                     "Iterable", "Any", "type"}

# Default seeds: (module rel-path suffix, function-name regex).
DEFAULT_SEEDS: Tuple[Tuple[str, str], ...] = (
    # Module contract: the optimizer's step runs every step.
    ("optimizer.py", r"^step$"),
)


@dataclasses.dataclass
class FuncInfo:
    sf: SourceFile
    node: ast.AST                  # FunctionDef / AsyncFunctionDef
    qualname: str
    params: Set[str]
    parent: Optional["FuncInfo"]

    @property
    def name(self) -> str:
        return self.node.name  # type: ignore[attr-defined]


class ModuleInfo:
    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.funcs: List[FuncInfo] = []
        self.by_name: Dict[str, List[FuncInfo]] = {}
        self.import_alias: Dict[str, str] = {}   # alias -> dotted module
        self.from_names: Dict[str, Tuple[str, str]] = {}  # name->(mod,orig)
        self._index()

    def _index(self) -> None:
        for node in ast.walk(self.sf.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.import_alias[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.from_names[a.asname or a.name] = (
                        node.module, a.name)

        def visit(node: ast.AST, parent: Optional[FuncInfo],
                  prefix: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    qual = f"{prefix}{child.name}"
                    fi = FuncInfo(
                        sf=self.sf, node=child, qualname=qual,
                        params=_param_names(child.args), parent=parent)
                    self.funcs.append(fi)
                    self.by_name.setdefault(child.name, []).append(fi)
                    visit(child, fi, qual + ".")
                elif isinstance(child, ast.ClassDef):
                    visit(child, parent, f"{prefix}{child.name}.")
                else:
                    visit(child, parent, prefix)

        visit(self.sf.tree, None, "")

    def full_name(self, node: ast.AST) -> Optional[str]:
        """Dotted name of a Name/Attribute chain with the root resolved
        through this module's imports (``import torch.distributed as
        dist`` makes ``dist.isend`` -> ``torch.distributed.isend``)."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = node.id
        if root in self.import_alias:
            root = self.import_alias[root]
        elif root in self.from_names:
            mod, orig = self.from_names[root]
            root = f"{mod}.{orig}"
        parts.append(root)
        return ".".join(reversed(parts))


def module_info(sf: SourceFile) -> ModuleInfo:
    """The file's index, built once and shared by every rule."""
    info = getattr(sf, "_module_info", None)
    if info is None:
        info = sf._module_info = ModuleInfo(sf)  # type: ignore[attr-defined]
    return info


def _param_names(args: ast.arguments) -> Set[str]:
    names = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}
    if args.vararg:
        names.add(args.vararg.arg)
    if args.kwarg:
        names.add(args.kwarg.arg)
    names.discard("self")
    names.discard("cls")
    return names


def _host_annotation(ann: Optional[ast.AST]) -> bool:
    """True where `ann` names host data: a host type, or Optional/Union
    of host types only."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant):
        return ann.value is None or (
            isinstance(ann.value, str) and ann.value in _HOST_ANNOTATIONS)
    if isinstance(ann, ast.Name):
        return ann.id in _HOST_ANNOTATIONS
    if isinstance(ann, ast.Attribute):
        return ann.attr in _HOST_ANNOTATIONS
    if isinstance(ann, ast.Subscript):
        base = ann.value
        name = base.attr if isinstance(base, ast.Attribute) else getattr(
            base, "id", None)
        if name in ("Optional", "Union"):
            inner = ann.slice
            elts = inner.elts if isinstance(inner, ast.Tuple) else [inner]
            return all(_host_annotation(e) for e in elts)
        return name in _HOST_ANNOTATIONS
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return _host_annotation(ann.left) and _host_annotation(ann.right)
    return False


def tensor_params(fn: ast.AST) -> Set[str]:
    """The parameters of `fn` that may hold tensors: all but ``self``,
    ``cls`` and those annotated with, or defaulting to, host data."""
    args = fn.args  # type: ignore[attr-defined]
    positional = args.posonlyargs + args.args
    defaults: Dict[str, ast.AST] = dict(zip(
        [a.arg for a in positional[len(positional) - len(args.defaults):]],
        args.defaults))
    for a, d in zip(args.kwonlyargs, args.kw_defaults):
        if d is not None:
            defaults[a.arg] = d
    out: Set[str] = set()
    for a in positional + args.kwonlyargs:
        if a.arg in ("self", "cls") or _host_annotation(a.annotation):
            continue
        d = defaults.get(a.arg)
        if isinstance(d, ast.Constant) and d.value is not None:
            continue
        out.add(a.arg)
    for a in (args.vararg, args.kwarg):
        if a is not None and not _host_annotation(a.annotation):
            out.add(a.arg)
    return out


def own_statements(fn: ast.AST) -> Iterable[ast.AST]:
    """Walk a function's body EXCLUDING nested def subtrees (they are
    separate functions) but INCLUDING lambdas (inline callbacks)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def value_bindings(fi: FuncInfo) -> Set[str]:
    """Names bound to VALUES in ``fi`` or an enclosing function scope:
    parameters, assignment/loop/with/except targets. A bare reference to
    such a name is the local value, never a same-named module-level
    function. Nested ``def`` names are deliberately NOT included:
    referencing one is a real call edge."""
    names: Set[str] = set()
    cur: Optional[FuncInfo] = fi
    while cur is not None:
        names |= cur.params
        for node in own_statements(cur.node):
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign,
                                   ast.NamedExpr)):
                targets = [node.target]
            elif isinstance(node, ast.For):
                targets = [node.target]
            elif isinstance(node, ast.comprehension):
                targets = [node.target]
            elif isinstance(node, ast.withitem) and node.optional_vars:
                targets = [node.optional_vars]
            elif isinstance(node, ast.ExceptHandler) and node.name:
                names.add(node.name)
            for t in targets:
                for leaf in ast.walk(t):
                    if isinstance(leaf, ast.Name):
                        names.add(leaf.id)
        cur = cur.parent
    return names


def module_aliases(m: ModuleInfo, fi: FuncInfo) -> Dict[str, str]:
    """Local names `fi` binds to an imported module (``c = counters``,
    ``c, n = counters, 4``): name -> the module's dotted path."""
    out: Dict[str, str] = {}
    for node in own_statements(fi.node):
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            pairs = [(target, node.value)]
            if isinstance(target, ast.Tuple) and isinstance(
                    node.value, ast.Tuple) and len(target.elts) == len(
                        node.value.elts):
                pairs = list(zip(target.elts, node.value.elts))
            for t, v in pairs:
                if not (isinstance(t, ast.Name) and isinstance(v, ast.Name)):
                    continue
                if v.id in m.import_alias:
                    out[t.id] = m.import_alias[v.id]
                elif v.id in m.from_names:
                    mod, orig = m.from_names[v.id]
                    out[t.id] = f"{mod}.{orig}"
    return out


class CallGraph:
    """Whole-file-set function index + hot-path reachability."""

    def __init__(self, files: Sequence[SourceFile],
                 seeds: Sequence[Tuple[str, str]] = DEFAULT_SEEDS):
        self.modules = [module_info(sf) for sf in files]
        self.by_rel = {m.sf.rel: m for m in self.modules}
        # Global bare-name index for cross-module from-import resolution.
        self.global_by_name: Dict[str, List[FuncInfo]] = {}
        for m in self.modules:
            for fi in m.funcs:
                self.global_by_name.setdefault(fi.name, []).append(fi)
        self.entries: Set[int] = set()      # id(FuncInfo.node)
        self.reachable: Dict[int, FuncInfo] = {}
        self._find_entries(seeds)
        self._close_over_references()

    # ----------------------------------------------------------- entries
    def _is_wrapper(self, m: ModuleInfo, func: ast.AST) -> bool:
        if m.full_name(func) in GRAPH_WRAPPERS:
            return True
        # functools.partial(torch.compile, ...) as a decorator factory.
        if (isinstance(func, ast.Call)
                and m.full_name(func.func) in _PARTIALS and func.args):
            return m.full_name(func.args[0]) in GRAPH_WRAPPERS
        return False

    def _find_entries(self, seeds: Sequence[Tuple[str, str]]) -> None:
        for m in self.modules:
            for fi in m.funcs:
                for deco in fi.node.decorator_list:  # type: ignore
                    target = deco.func if isinstance(deco, ast.Call) \
                        else deco
                    if self._is_wrapper(m, target) or (
                            isinstance(deco, ast.Call)
                            and self._is_wrapper(m, deco)):
                        self._mark(fi)
                for suffix, pattern in seeds:
                    if (m.sf.rel.endswith(suffix)
                            and re.match(pattern, fi.name)):
                        self._mark(fi)
            for node in ast.walk(m.sf.tree):
                if isinstance(node, ast.Call) and node.args \
                        and self._is_wrapper(m, node.func):
                    self._mark_callee_expr(m, node.args[0])
                elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                        isinstance(item.context_expr, ast.Call)
                        and m.full_name(item.context_expr.func)
                        in GRAPH_CONTEXTS for item in node.items):
                    for stmt in node.body:
                        for sub in ast.walk(stmt):
                            if isinstance(sub, ast.Call):
                                self._mark_callee_expr(m, sub.func)

    def _mark_callee_expr(self, m: ModuleInfo, expr: ast.AST) -> None:
        if isinstance(expr, (ast.Name, ast.Attribute)):
            for fi in self._resolve_reference(m, expr):
                self._mark(fi)
        elif isinstance(expr, (ast.Tuple, ast.List)):
            # make_graphed_callables((f, g), ...)
            for elt in expr.elts:
                self._mark_callee_expr(m, elt)
        elif isinstance(expr, ast.Call):
            # torch.compile(functools.partial(f, ...)) resolves through
            # the partial's first argument.
            if m.full_name(expr.func) in _PARTIALS and expr.args:
                self._mark_callee_expr(m, expr.args[0])

    def _mark(self, fi: FuncInfo) -> None:
        if id(fi.node) not in self.reachable:
            self.entries.add(id(fi.node))
            self.reachable[id(fi.node)] = fi

    # ------------------------------------------------------- reachability
    def _resolve_reference(self, m: ModuleInfo, node: ast.AST,
                           aliases: Optional[Dict[str, str]] = None
                           ) -> List[FuncInfo]:
        if isinstance(node, ast.Name):
            local = m.by_name.get(node.id)
            if local:
                return local
            if node.id in m.from_names:
                mod, orig = m.from_names[node.id]
                return self._resolve_imported(mod, orig)
            return []
        if isinstance(node, ast.Attribute):
            base = node.value
            if isinstance(base, ast.Name):
                if base.id == "self":
                    return m.by_name.get(node.attr, [])
                dotted = m.import_alias.get(base.id) or (
                    aliases or {}).get(base.id)
                if dotted is None and base.id in m.from_names:
                    fmod, forig = m.from_names[base.id]
                    dotted = f"{fmod}.{forig}"
                if dotted:
                    return self._resolve_imported(dotted, node.attr)
        return []

    def _resolve_imported(self, module: str, name: str) -> List[FuncInfo]:
        base = module.replace(".", "/")
        for rel in (base + ".py", base + "/__init__.py"):
            for m in self.modules:
                if (m.sf.rel == rel or m.sf.rel.endswith("/" + rel)) \
                        and name in m.by_name:
                    return m.by_name[name]
        # Package __init__ re-exports: fall back to the global bare-name
        # index for package-internal modules only.
        if module.split(".")[0] in {
                m.sf.rel.split("/")[0] for m in self.modules}:
            return self.global_by_name.get(name, [])
        return []

    def _close_over_references(self) -> None:
        work = list(self.reachable.values())
        shadow_cache: Dict[int, Set[str]] = {}
        while work:
            fi = work.pop()
            m = self.by_rel[fi.sf.rel]
            shadowed = shadow_cache.get(id(fi.node))
            if shadowed is None:
                shadowed = shadow_cache[id(fi.node)] = value_bindings(fi)
            aliases = module_aliases(m, fi)
            for node in own_statements(fi.node):
                if not isinstance(node, (ast.Name, ast.Attribute)):
                    continue
                if isinstance(node, ast.Name) and not isinstance(
                        getattr(node, "ctx", None), ast.Load):
                    continue
                if isinstance(node, ast.Name) and node.id in shadowed:
                    continue  # local value, not a module-level function
                for target in self._resolve_reference(m, node, aliases):
                    if id(target.node) not in self.reachable:
                        self.reachable[id(target.node)] = target
                        work.append(target)

    def reachable_functions(self) -> List[FuncInfo]:
        return sorted(self.reachable.values(),
                      key=lambda fi: (fi.sf.rel, fi.node.lineno))


# ---------------------------------------------------------------- taint

def _torch_call(m: Optional[ModuleInfo], func: ast.AST) -> bool:
    """A call of a ``torch.*`` function that returns a tensor."""
    full = m.full_name(func) if m is not None else None
    if full is None:
        root = func
        while isinstance(root, ast.Attribute):
            root = root.value
        if not (isinstance(root, ast.Name) and root.id == "torch"):
            return False
        full = ast.unparse(func)
    if not (full == "torch" or full.startswith("torch.")):
        return False
    return not full.startswith(_HOST_TORCH)


def tensor_names(fi: FuncInfo, m: Optional[ModuleInfo] = None) -> Set[str]:
    """Fixpoint over simple assignments: which local names (probably)
    hold tensors inside this hot function (see the module docstring)."""
    tainted: Set[str] = tensor_params(fi.node)
    for node in own_statements(fi.node):
        if isinstance(node, ast.Lambda):
            tainted |= _param_names(node.args)
    changed = True
    while changed:
        changed = False
        for node in own_statements(fi.node):
            targets: List[ast.AST] = []
            value: Optional[ast.AST] = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value:
                targets, value = [node.target], node.value
            elif isinstance(node, ast.AugAssign):
                targets, value = [node.target], node.value
            elif isinstance(node, ast.NamedExpr):
                targets, value = [node.target], node.value
            elif isinstance(node, (ast.For, ast.comprehension)):
                targets, value = [node.target], node.iter
            if value is None or not targets:
                continue
            if not expr_is_tensor(value, tainted, m):
                continue
            for t in targets:
                for name in _bound_names(t):
                    if name not in tainted:
                        tainted.add(name)
                        changed = True
    return tainted


def _bound_names(target: ast.AST) -> Set[str]:
    """The names an assignment target binds: ``x``, ``a, *b``; not the
    bases of ``self.x = ...`` or ``d[k] = ...``, which bind nothing."""
    if isinstance(target, ast.Name):
        return {target.id}
    if isinstance(target, (ast.Tuple, ast.List)):
        return set().union(*(_bound_names(e) for e in target.elts))
    if isinstance(target, ast.Starred):
        return _bound_names(target.value)
    return set()


def expr_is_tensor(expr: ast.AST, tainted: Set[str],
                   m: Optional[ModuleInfo] = None) -> bool:
    """Does ``expr`` (likely) produce/contain a tensor? Metadata reads
    are exempt; ``torch.*`` calls that return tensors count as
    producers."""
    stack = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                continue  # x.shape / x.numel() / ... : host metadata
            stack.append(node.value)
            continue
        if isinstance(node, ast.Call):
            if _torch_call(m, node.func):
                return True
            root = node.func
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(node.func, ast.Name) and (
                    node.func.id in _HOST_BUILTINS):
                continue
            if isinstance(root, ast.Name) and root.id in _ARG_TRACED_ROOTS:
                if any(expr_is_tensor(a, tainted, m) for a in node.args):
                    return True
                continue
            stack.extend(node.args)
            stack.extend(kw.value for kw in node.keywords)
            if not isinstance(node.func, ast.Name):
                stack.append(node.func)
            continue
        if isinstance(node, ast.Name):
            if node.id in tainted:
                return True
            continue
        if isinstance(node, ast.IfExp):
            stack.extend((node.body, node.orelse))  # the test is no value
            continue
        stack.extend(ast.iter_child_nodes(node))
    return False
