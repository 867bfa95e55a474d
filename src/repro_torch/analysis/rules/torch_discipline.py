"""Torch discipline: what a captured CUDA graph replays must be what the
eager code computes, and a capture must happen once, not per iteration.

A body captured under ``torch.cuda.graph(...)`` is recorded once and
replayed many times; the host is not in the replay. Five sub-checks, the
failure modes that have bitten the port's captures:

* **host sync in a captured body** — `.item()`, `.tolist()`, `.cpu()`,
  `.numpy()`, `.to("cpu")`, any `.synchronize()` or
  `torch.cuda.synchronize()`; and `float()` / `int()` / `bool()` of a
  tensor value or a Python `if` / `while` on one. A sync is illegal while
  a stream captures (the capture fails), and a host decision taken at
  capture is frozen into every replay. The body's parameters are tensors,
  and taint spreads through simple assignments; shape and dtype reads
  (`x.shape`, `x.ndim`, `x.dtype`, `x.device`, `x.size()`, `len(x)`) and
  `is None` tests are static and exempt.

* **host-to-device copy in a captured body** — `torch.tensor(...)`,
  `torch.as_tensor(...)`, `torch.from_numpy(...)`, `.cuda()` and
  `.to(<device>)` of a value that is not a body tensor (one derived from
  the parameters, or the object's own `self.<buffer>`): a pageable copy is
  a sync, and the copied value is frozen at capture
  (`apps/tsunami.py::_level_constants` keeps constants on the device for
  this reason).

* **host values frozen into a graph** — `np.random.*`, `random.*` and
  `time.*` calls inside a captured body run once, at capture; every replay
  reuses the value they gave.

* **capture in a loop** — `torch.cuda.CUDAGraph()`, `torch.cuda.graph(...)`
  or `torch.cuda.make_graphed_callables(...)` built lexically inside a
  `for` / `while` body: every iteration captures anew, and entering a
  capture synchronizes the device and empties the allocator's cache.
  Capture once and cache the graph (`apps/composite.py::cg`).

* **fd-f64** — finite-difference code (`*fd*` functions) that forces
  float32 (`.float()`, `dtype=torch.float32`, `np.float32`) without ever
  consulting float64 or the input's dtype: FD steps below ~1e-4 underflow
  the difference in single precision.

What counts as a captured body is resolved within one module:

(a) the statements lexically inside ``with torch.cuda.graph(...)``;
(b) the functions called from a captured body by name: a local `def`, a
    module function, or ``self.<method>`` of the enclosing class,
    transitively;
(c) a function passed by name to a same-module function that calls that
    parameter inside a capture (`apps/tsunami.py::_Sweep` hands its step
    bodies to `_replay` this way).

`captured_bodies(paths)` lists what (b) and (c) resolve, as
"relpath::Qualified.name".
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.analysis.common import FileCtx, Finding, dotted, iter_py_files

#: graph-building calls, by their canonical dotted name
GRAPH_CAPTURE = "torch.cuda.graph"
GRAPH_BUILDERS = {GRAPH_CAPTURE, "torch.cuda.CUDAGraph", "torch.cuda.make_graphed_callables"}
#: reads of a tensor that are static (no device value)
STATIC_ATTRS = {"ndim", "shape", "dtype", "device", "is_cuda", "size", "numel", "dim"}
CAST_FNS = {"float", "int", "bool"}
SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
H2D_FNS = {"torch.tensor", "torch.as_tensor", "torch.from_numpy"}
#: module prefixes whose calls take a host value at capture
FROZEN_PREFIXES = {"np.random.": None, "numpy.random.": None, "random.": "random",
                   "time.": "time"}


def _canonical_names(tree: ast.AST) -> tuple[bool, dict[str, str], set[str]]:
    """(imports torch, bare name -> canonical dotted name for what the module
    imports from torch.cuda, stdlib modules imported bare)."""
    has_torch = False
    bare: dict[str, str] = {}
    stdlib: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch" or a.name.startswith("torch."):
                    has_torch = True
                elif a.name in ("random", "time") and a.asname is None:
                    stdlib.add(a.name)
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module.split(".")[0] == "torch":
                has_torch = True
            if node.module == "torch.cuda":
                for a in node.names:
                    bare[a.asname or a.name] = f"torch.cuda.{a.name}"
    return has_torch, bare, stdlib


@dataclass
class _Func:
    node: ast.AST
    cls: str | None  # qualname of the nearest enclosing class
    params: list[str] = field(default_factory=list)


class _Index(ast.NodeVisitor):
    """Every def of one module by qualname, the names each scope defines,
    each class's methods, and every `with torch.cuda.graph(...)` region."""

    def __init__(self, canon, tree: ast.Module) -> None:
        self.canon = canon
        self.module_body = tree.body
        self.funcs: dict[str, _Func] = {}
        self.defs: dict[str, dict[str, str]] = {}  # scope -> name -> qualname
        self.methods: dict[str, dict[str, str]] = {}  # class qual -> name -> qual
        self.bases: dict[str, list[str]] = {}
        self.regions: list[tuple[str, list[ast.stmt]]] = []  # (owner qual, body)
        self._scope: list[tuple[str, str]] = []  # (kind, name)
        self.visit(tree)

    def _qual(self, name: str) -> str:
        return ".".join([n for _, n in self._scope] + [name])

    def _here(self) -> str:
        return ".".join(n for _, n in self._scope)

    def _cls(self) -> str | None:
        for i in range(len(self._scope) - 1, -1, -1):
            if self._scope[i][0] == "class":
                return ".".join(n for _, n in self._scope[: i + 1])
        return None

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        qual = self._qual(node.name)
        self.defs.setdefault(self._here(), {})[node.name] = qual
        self.methods.setdefault(qual, {})
        self.bases[qual] = [dotted(b) or "" for b in node.bases]
        self._scope.append(("class", node.name))
        try:
            self.generic_visit(node)
        finally:
            self._scope.pop()

    def _visit_func(self, node) -> None:
        qual = self._qual(node.name)
        here = self._here()
        in_class = bool(self._scope) and self._scope[-1][0] == "class"
        a = node.args
        params = [p.arg for p in a.posonlyargs + a.args]
        if in_class and params and not any(
            dotted(d) == "staticmethod" for d in node.decorator_list
        ):
            params = params[1:]  # self / cls
        params += [p.arg for p in a.kwonlyargs]
        self.funcs.setdefault(qual, _Func(node, self._cls(), params))
        if in_class:
            self.methods.setdefault(here, {})[node.name] = qual
        else:
            self.defs.setdefault(here, {})[node.name] = qual
        self._scope.append(("func", node.name))
        try:
            self.generic_visit(node)
        finally:
            self._scope.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_With(self, node: ast.With) -> None:
        if any(
            isinstance(i.context_expr, ast.Call)
            and self.canon(i.context_expr.func) == GRAPH_CAPTURE
            for i in node.items
        ):
            self.regions.append((self._here(), node.body))
        self.generic_visit(node)

    # -- resolution ---------------------------------------------------------
    def resolve_name(self, name: str, scope: str) -> str | None:
        """A bare name called in `scope`: the nearest enclosing function's
        def, else the module's (class scopes are not visible, as in
        Python)."""
        parts = scope.split(".") if scope else []
        while True:
            here = ".".join(parts)
            if here in self.funcs and name in self.funcs[here].params:
                return None  # a parameter: what (c) resolves at the call sites
            if here == "" or here in self.funcs:
                hit = self.defs.get(here, {}).get(name)
                if hit is not None and hit in self.funcs:
                    return hit
            if not parts:
                return None
            parts.pop()

    def resolve_method(self, cls: str | None, name: str, seen=None) -> str | None:
        if cls is None:
            return None
        hit = self.methods.get(cls, {}).get(name)
        if hit is not None:
            return hit
        seen = (seen or set()) | {cls}
        for base in self.bases.get(cls, []):
            base_q = self.defs.get("", {}).get(base)
            if base_q and base_q not in seen:
                hit = self.resolve_method(base_q, name, seen)
                if hit:
                    return hit
        return None

    def resolve_call(self, func: ast.AST, scope: str, cls: str | None) -> str | None:
        if isinstance(func, ast.Name):
            return self.resolve_name(func.id, scope)
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id in ("self", "cls")
        ):
            return self.resolve_method(cls, func.attr)
        return None


def _calls(nodes) -> list[ast.Call]:
    """Calls under `nodes`, not descending into nested defs (a nested def
    runs when it is called, and is resolved then)."""
    out: list[ast.Call] = []

    def walk(n: ast.AST) -> None:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return
        if isinstance(n, ast.Call):
            out.append(n)
        for child in ast.iter_child_nodes(n):
            walk(child)

    for n in nodes:
        walk(n)
    return out


def _resolve_captured(index: _Index) -> set[str]:
    """Qualnames of the functions that run inside a capture, (b) and (c)."""
    # (c) first: which parameter of which function a capture region calls
    called_params: dict[str, set[str]] = {}
    for owner, body in index.regions:
        f = index.funcs.get(owner)
        if f is None:
            continue
        for call in _calls(body):
            if isinstance(call.func, ast.Name) and call.func.id in f.params:
                called_params.setdefault(owner, set()).add(call.func.id)

    captured: set[str] = set()
    work: list[str] = []

    def mark(qual: str | None) -> None:
        if qual is not None and qual not in captured:
            captured.add(qual)
            work.append(qual)

    def scope_of(owner: str) -> tuple[str, str | None]:
        f = index.funcs.get(owner)
        return (owner, f.cls) if f is not None else ("", None)

    for owner, body in index.regions:
        scope, cls = scope_of(owner)
        for call in _calls(body):
            mark(index.resolve_call(call.func, scope, cls))

    # (c): every call, anywhere in the module, to a function with called
    # parameters hands the capture the function it passes there by name
    sites = [(q, f.cls, f.node.body) for q, f in index.funcs.items()]
    sites.append(("", None, index.module_body))
    for scope, cls, body in sites:
        for call in _calls(body):
            target = index.resolve_call(call.func, scope, cls)
            if target not in called_params:
                continue
            tparams = index.funcs[target].params
            bound = dict(zip(tparams, call.args))
            bound.update({kw.arg: kw.value for kw in call.keywords if kw.arg})
            for p in called_params[target]:
                if p in bound:
                    mark(index.resolve_call(bound[p], scope, cls))

    # (b) transitively
    while work:
        qual = work.pop()
        f = index.funcs[qual]
        for call in _calls(f.node.body):
            mark(index.resolve_call(call.func, qual, f.cls))
    return captured


def _index(ctx: FileCtx):
    has_torch, bare, stdlib = _canonical_names(ctx.tree)

    def canon(node: ast.AST) -> str | None:
        name = dotted(node)
        if name is None:
            return None
        head, _, rest = name.partition(".")
        if head in bare:
            return bare[head] + (f".{rest}" if rest else "")
        return name

    index = _Index(canon, ctx.tree)
    return has_torch, canon, stdlib, index


def _tensor_names(node: ast.AST, tainted: set[str]) -> set[str]:
    """Tainted (tensor) names under `node`, excluding static reads (shape,
    dtype, device, len) and `is None` tests, which are host values under
    capture."""
    found: set[str] = set()

    def walk(n: ast.AST) -> None:
        if isinstance(n, ast.Attribute) and n.attr in STATIC_ATTRS:
            return
        if isinstance(n, ast.Call) and dotted(n.func) in ("len", "isinstance"):
            return
        if isinstance(n, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops
        ):
            return
        if isinstance(n, ast.Name) and n.id in tainted:
            found.add(n.id)
        for child in ast.iter_child_nodes(n):
            walk(child)

    walk(node)
    return found


def _propagate(nodes, tainted: set[str]) -> None:
    for _ in range(2):
        for root in nodes:
            for node in ast.walk(root):
                if isinstance(node, ast.Assign):
                    if _tensor_names(node.value, tainted):
                        for tgt in node.targets:
                            for n in ast.walk(tgt):
                                if isinstance(n, ast.Name):
                                    tainted.add(n.id)
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    if (
                        node.value is not None
                        and isinstance(node.target, ast.Name)
                        and _tensor_names(node.value, tainted)
                    ):
                        tainted.add(node.target.id)


def _device_arg(call: ast.Call) -> str | None:
    """'cpu' / 'device' if `.to(...)` names a device, else None."""
    for kw in call.keywords:
        if kw.arg == "device":
            v = kw.value
            if isinstance(v, ast.Constant) and v.value == "cpu":
                return "cpu"
            return "device"
    if not call.args:
        return None
    a = call.args[0]
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        return "cpu" if a.value == "cpu" else "device"
    if isinstance(a, ast.Call) and dotted(a.func) == "torch.device":
        first = a.args[0] if a.args else None
        if isinstance(first, ast.Constant) and first.value == "cpu":
            return "cpu"
        return "device"
    name = (dotted(a) or "").split(".")[-1]
    if name == "dev" or name.endswith("device"):
        return "device"
    return None


class _BodyChecker:
    """The host-sync, host-copy and frozen-value checks over one captured
    body: a function (its parameters are tensors) or a region's statements
    (the enclosing function's parameters are)."""

    def __init__(self, rule, ctx, canon, stdlib, nodes, params, symbol, where):
        self.rule, self.ctx, self.canon, self.stdlib = rule, ctx, canon, stdlib
        self.nodes, self.symbol, self.where = nodes, symbol, where
        self.tainted = set(params)
        _propagate(nodes, self.tainted)

    def _nodes(self):
        """Every node of the body, not descending into nested defs."""
        def walk(n):
            yield n
            for child in ast.iter_child_nodes(n):
                if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                          ast.ClassDef)):
                    yield from walk(child)

        for root in self.nodes:
            yield from walk(root)

    def _tensor(self, node: ast.AST) -> bool:
        """A body tensor: derived from the parameters, or the object's own
        state (`self.buf`: the static buffers a capture reads and writes)."""
        return (dotted(node) or "").startswith("self.") or bool(
            _tensor_names(node, self.tainted))

    def run(self) -> list[Finding]:
        findings: list[Finding] = []

        def flag(node: ast.AST, message: str) -> None:
            findings.append(Finding(self.rule, self.ctx.relpath, node.lineno,
                                    self.symbol, f"{message} {self.where}"))

        for node in self._nodes():
            if isinstance(node, (ast.If, ast.While)):
                hit = _tensor_names(node.test, self.tainted)
                if hit:
                    kind = "if" if isinstance(node, ast.If) else "while"
                    flag(node, f"Python `{kind}` on tensor value {sorted(hit)[0]!r} "
                               f"(a host sync, its outcome frozen into the graph)")
                continue
            if not isinstance(node, ast.Call):
                continue
            fn = self.canon(node.func)
            method = node.func.attr if isinstance(node.func, ast.Attribute) else None
            receiver = node.func.value if method else None
            if fn == "torch.cuda.synchronize":
                flag(node, "torch.cuda.synchronize() (a host sync)")
            elif fn in CAST_FNS and node.args:
                hit = _tensor_names(node.args[0], self.tainted)
                if hit:
                    flag(node, f"{fn}() of tensor value {sorted(hit)[0]!r} (a host sync)")
            elif fn in H2D_FNS:
                if not (node.args and self._tensor(node.args[0])):
                    flag(node, f"{fn}(...) of a host value (a host-to-device copy, "
                               f"its value frozen at capture)")
            elif fn and any(
                fn.startswith(p) and (mod is None or mod in self.stdlib)
                for p, mod in FROZEN_PREFIXES.items()
            ):
                flag(node, f"{fn}() takes a host value once, at capture; every "
                           f"replay reuses it")
            elif method in SYNC_METHODS and (method != "numpy" or not node.args):
                flag(node, f".{method}() (a host sync)")
            elif method == "to" and _device_arg(node) == "cpu":
                flag(node, ".to('cpu') (a device-to-host copy, a host sync)")
            elif method == "cuda" or (method == "to" and _device_arg(node) == "device"):
                if not self._tensor(receiver):
                    flag(node, f".{method}(...) of a host value (a host-to-device "
                               f"copy, its value frozen at capture)")
        return findings


class _LoopVisitor(ast.NodeVisitor):
    """Graph builders lexically inside a loop body: one finding a loop."""

    def __init__(self, rule: str, ctx: FileCtx, canon):
        self.rule, self.ctx, self.canon = rule, ctx, canon
        self.loops: list[ast.AST] = []
        self.flagged: set[int] = set()
        self.findings: list[Finding] = []
        self._scope: list[str] = []

    def _scoped(self, node) -> None:
        self._scope.append(node.name)
        try:
            self.generic_visit(node)
        finally:
            self._scope.pop()

    visit_ClassDef = _scoped
    visit_FunctionDef = _scoped
    visit_AsyncFunctionDef = _scoped

    def _loop(self, node) -> None:
        self.loops.append(node)
        try:
            self.generic_visit(node)
        finally:
            self.loops.pop()

    visit_For = _loop
    visit_AsyncFor = _loop
    visit_While = _loop

    def visit_Call(self, node: ast.Call) -> None:
        fn = self.canon(node.func)
        if fn in GRAPH_BUILDERS and self.loops and id(self.loops[-1]) not in self.flagged:
            self.flagged.add(id(self.loops[-1]))
            self.findings.append(Finding(
                self.rule, self.ctx.relpath, node.lineno,
                ".".join(self._scope) or "<module>",
                f"{fn}(...) inside a loop body — every iteration captures a "
                f"new graph (a device sync and an emptied allocator cache "
                f"each time); capture once and cache the graph",
            ))
        self.generic_visit(node)


def _forces_f32(node: ast.AST) -> str | None:
    if isinstance(node, ast.Call):
        fn = dotted(node.func) or ""
        if isinstance(node.func, ast.Attribute) and node.func.attr == "float" and not node.args:
            return ".float()"
        if fn in ("np.float32", "numpy.float32"):
            return fn
        for kw in node.keywords:
            if kw.arg == "dtype" and dotted(kw.value) in (
                "torch.float32", "torch.float", "np.float32", "numpy.float32"
            ):
                return f"dtype={dotted(kw.value)}"
        if isinstance(node.func, ast.Attribute) and node.func.attr in ("to", "type", "astype"):
            for a in node.args[:1]:
                if dotted(a) in ("torch.float32", "torch.float", "np.float32"):
                    return f".{node.func.attr}({dotted(a)})"
                if isinstance(a, ast.Constant) and a.value == "float32":
                    return f".{node.func.attr}('float32')"
    return None


def _consults_f64(func: ast.AST) -> bool:
    for n in ast.walk(func):
        if isinstance(n, ast.Attribute) and (
            n.attr in ("float64", "double", "dtype") or n.attr == "x64_enabled"
        ):
            return True
        if isinstance(n, ast.Constant) and n.value in ("float64", "double"):
            return True
        if isinstance(n, ast.Name) and n.id in ("float64", "double"):
            return True
    return False


def _is_fd_name(name: str) -> bool:
    name = name.lower()
    return "fd" in name.replace("_", " ").split() or "finite" in name


class TorchDisciplineRule:
    rule = "torch"

    def visit_file(self, ctx: FileCtx) -> list[Finding]:
        has_torch, canon, stdlib, index = _index(ctx)
        if not has_torch:
            return []
        findings: list[Finding] = []
        # (a) the regions' own statements
        for owner, body in index.regions:
            f = index.funcs.get(owner)
            findings.extend(_BodyChecker(
                self.rule, ctx, canon, stdlib, body, f.params if f else [],
                owner or "<module>", "inside `with torch.cuda.graph(...)`",
            ).run())
        # (b), (c) the functions run by a capture
        for qual in sorted(_resolve_captured(index)):
            f = index.funcs[qual]
            findings.extend(_BodyChecker(
                self.rule, ctx, canon, stdlib, f.node.body, f.params, qual,
                "inside a captured body",
            ).run())
        loops = _LoopVisitor(self.rule, ctx, canon)
        loops.visit(ctx.tree)
        findings.extend(loops.findings)
        findings.extend(self._check_fd_f64(ctx))
        # one site can be reached as a region and as a captured function
        return sorted(set(findings), key=lambda f: (f.line, f.message))

    def _check_fd_f64(self, ctx: FileCtx) -> list[Finding]:
        findings: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not _is_fd_name(node.name) or _consults_f64(node):
                continue
            for sub in ast.walk(node):
                bad = _forces_f32(sub)
                if bad:
                    findings.append(Finding(
                        self.rule, ctx.relpath, sub.lineno, node.name,
                        f"finite-difference code forces {bad} and never consults "
                        f"float64 or the input's dtype — FD steps underflow in "
                        f"single precision",
                    ))
        return findings

    def finish(self) -> list[Finding]:
        return []


def captured_bodies(paths, root: Path | None = None) -> set[str]:
    """"relpath::Qualified.name" of every function the rule resolves as
    running inside a capture ((b) and (c)) over `paths`."""
    from repro_torch.analysis.lint import _common_root

    paths = [Path(p) for p in paths]
    root = Path(root) if root is not None else _common_root(paths)
    out: set[str] = set()
    for f in iter_py_files(paths):
        ctx = FileCtx.parse(f, root)
        has_torch, _, _, index = _index(ctx)
        if has_torch:
            out |= {f"{ctx.relpath}::{q}" for q in _resolve_captured(index)}
    return out
