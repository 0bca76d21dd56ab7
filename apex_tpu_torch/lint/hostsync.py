"""Host-sync / recompile hazard lint — the Python-AST pass
(counterpart of apex_tpu/lint/hostsync.py).

The program passes see the run that was recorded; this pass sees the
source that WOULD sync with the host or recompile inside a device step
— the static complement of `monitor.compile.RecompileSentry`.  It
identifies *device steps* — functions the port runs as one step on the
device: `torch.compile` targets (decorated with or passed to
`torch.compile`) and the functions marked with the no-op decorator
`ops._common.device_step` (the steps `ddp.make_train_step` and
`make_tp_dp_train_step` return, the serving engine's `_decode_fn` /
`_prefill_fn`, the pipeline schedule's clocks); nested defs inherit —
and flags, inside them:

  HS401  `.item()` on a tensor: a forced host sync that stalls the
         launch queue (and a graph break under `torch.compile`).
  HS402  `float(x)` / `int(x)` / `bool(x)` of a tensor: the same sync
         (shape/dtype/device reads are exempt: they are host values).
  HS403  `.cpu()` / `.numpy()` / `.tolist()` of a tensor, or
         `np.asarray` / `np.array` of one: a device-to-host copy inside
         the step.
  HS404  `if`/`while` on a tensor: a sync to read the predicate (`is
         None` checks and shape/dtype tests are exempt).
  HS405  `torch.compile(...)` constructed inside a loop: a fresh
         compiled function (and a full compile) every iteration.
  HS406  a compiled step closing over a name assigned in an enclosing
         LOOP: the closed-over Python scalar is a guard of the compiled
         code, so each iteration's new value recompiles.

A value counts only when it provably derives from a device step's
parameters, so the pass stays clean on host-side driver code (a warm-up
loop may sync — the hazard is syncing inside the step).  A deliberate
sync carries ``# lint: disable=RULE`` on its line, with its reason.
"""

from __future__ import annotations

import ast
import builtins
import dataclasses
import os
from typing import List, Optional, Set

from apex_tpu_torch.lint.findings import Finding, make_finding

# calls/decorators that make their function argument(s) a device step
TRANSFORMS = frozenset({"compile", "device_step", "vmap"})
# the subset whose CONSTRUCTION in a loop is itself a hazard
_JIT_MAKERS = frozenset({"compile"})

# attribute reads that are host values
STATIC_ATTRS = frozenset({
    "shape", "ndim", "dtype", "device", "is_cuda", "layout",
    "requires_grad", "is_leaf", "itemsize", "nbytes", "_fields",
})
# calls whose result is a host value regardless of their arguments
STATIC_CALLS = frozenset({
    "len", "isinstance", "issubclass", "getattr", "hasattr", "type",
    "range", "id", "repr", "str", "format", "callable",
    "size", "dim", "numel", "nelement", "ndimension", "element_size",
    "stride", "storage_offset", "is_contiguous", "is_floating_point",
    "is_complex", "get_device", "data_ptr",
})
# host materialization: numpy constructors of a tensor, and the tensor
# methods that copy to the host
_HOST_FUNCS = frozenset({"asarray", "array", "copyto"})
_HOST_MODULES = frozenset({"np", "numpy", "onp"})
_HOST_METHODS = frozenset({"cpu", "numpy", "tolist"})
# a method's receiver: the host object the step belongs to
_RECEIVERS = frozenset({"self", "cls"})


def _call_target(func) -> Optional[str]:
    """The trailing name of a call target: `torch.compile` -> 'compile',
    `device_step` -> 'device_step'."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _partial_transform(call: ast.Call) -> bool:
    """functools.partial(torch.compile, ...) used as a decorator/wrapper."""
    if _call_target(call.func) != "partial" or not call.args:
        return False
    return _call_target(call.args[0]) in TRANSFORMS \
        if isinstance(call.args[0], (ast.Name, ast.Attribute)) else False


@dataclasses.dataclass(eq=False)  # identity hashing — scopes are nodes
class _Func:
    node: ast.AST                  # FunctionDef / Lambda / Module
    name: str
    parent: Optional["_Func"]
    params: Set[str] = dataclasses.field(default_factory=set)
    assigned: Set[str] = dataclasses.field(default_factory=set)
    loop_assigned: Set[str] = dataclasses.field(default_factory=set)
    traced: bool = False
    # def lexically inside a loop of the parent scope: a fresh function
    # (and a fresh trace) per iteration BY CONSTRUCTION, so
    # loop-rebound closures are per-iteration values, not stale bakes
    defined_in_loop: bool = False
    children: list = dataclasses.field(default_factory=list)


class _ScopeBuilder(ast.NodeVisitor):
    """First pass: the function-scope tree with per-scope assignment
    and loop-assignment sets, plus traced marks from decorators and
    transform-call references."""

    def __init__(self):
        self.module = _Func(node=None, name="<module>", parent=None)
        self.current = self.module
        self.loop_depth = 0
        self.by_node = {}
        # (scope, name) -> _Func for resolving `torch.compile(f)` references
        self.defs = {}
        self.jit_in_loop: list = []  # (lineno, target) for HS405

    # -- scopes --
    def _enter(self, node, name, params):
        fn = _Func(node=node, name=name, parent=self.current,
                   params=set(params),
                   defined_in_loop=self.loop_depth > 0)
        fn.assigned |= fn.params
        self.current.children.append(fn)
        self.by_node[node] = fn
        self.defs[(self.current, name)] = fn
        outer_loop = self.loop_depth
        self.loop_depth = 0
        prev, self.current = self.current, fn
        for child in ast.iter_child_nodes(node):
            self.visit(child)
        self.current = prev
        self.loop_depth = outer_loop
        return fn

    @staticmethod
    def _params_of(args: ast.arguments):
        names = [a.arg for a in args.posonlyargs + args.args
                 + args.kwonlyargs]
        if args.vararg:
            names.append(args.vararg.arg)
        if args.kwarg:
            names.append(args.kwarg.arg)
        return names

    def visit_FunctionDef(self, node):
        fn = self._enter(node, node.name, self._params_of(node.args))
        self.current.assigned.add(node.name)
        if self.loop_depth:
            self.current.loop_assigned.add(node.name)
        for dec in node.decorator_list:
            tgt = None
            if isinstance(dec, (ast.Name, ast.Attribute)):
                tgt = _call_target(dec)
            elif isinstance(dec, ast.Call):
                if _partial_transform(dec):
                    tgt = "compile"
                else:
                    tgt = _call_target(dec.func)
            if tgt in TRANSFORMS:
                fn.traced = True
            # a compile DECORATOR on a def inside a loop is the same
            # fresh-compile-per-iteration hazard as compile(...) called
            # in the loop (the decorator runs each iteration)
            if tgt in _JIT_MAKERS and self.loop_depth:
                self.jit_in_loop.append((node.lineno, tgt))

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._enter(node, "<lambda>", self._params_of(node.args))

    # -- loops --
    def visit_For(self, node):
        for tname in ast.walk(node.target):
            if isinstance(tname, ast.Name):
                self.current.assigned.add(tname.id)
                self.current.loop_assigned.add(tname.id)
        self.loop_depth += 1
        for child in ast.iter_child_nodes(node):
            self.visit(child)
        self.loop_depth -= 1

    visit_AsyncFor = visit_For

    def visit_While(self, node):
        self.loop_depth += 1
        for child in ast.iter_child_nodes(node):
            self.visit(child)
        self.loop_depth -= 1

    # -- assignments --
    def _note_assign(self, name):
        self.current.assigned.add(name)
        if self.loop_depth:
            self.current.loop_assigned.add(name)

    def visit_Name(self, node):
        if isinstance(node.ctx, ast.Store):
            self._note_assign(node.id)
        self.generic_visit(node)

    def visit_Import(self, node):
        for alias in node.names:
            self.current.assigned.add(
                (alias.asname or alias.name).split(".")[0])

    visit_ImportFrom = visit_Import

    # -- transform-call references + compile-in-loop --
    def visit_Call(self, node):
        tgt = _call_target(node.func)
        if tgt in TRANSFORMS or _partial_transform(node):
            fn_args = list(node.args)
            # mark every function-valued argument
            for arg in fn_args:
                if isinstance(arg, ast.Lambda):
                    pass  # marked below once scope exists
                elif isinstance(arg, ast.Name):
                    self._mark_name_traced(arg.id)
            if tgt in _JIT_MAKERS and self.loop_depth:
                self.jit_in_loop.append((node.lineno, tgt))
        self.generic_visit(node)
        # lambdas appear as children after generic_visit built them
        if tgt in TRANSFORMS or _partial_transform(node):
            for arg in node.args:
                if isinstance(arg, ast.Lambda):
                    fn = self.by_node.get(arg)
                    if fn is not None:
                        fn.traced = True

    def _mark_name_traced(self, name):
        scope = self.current
        while scope is not None:
            fn = self.defs.get((scope, name))
            if fn is not None:
                fn.traced = True
                return
            scope = scope.parent


def _propagate_traced(fn: _Func):
    for child in fn.children:
        if fn.traced:
            child.traced = True
        _propagate_traced(child)


_BUILTINS = frozenset(dir(builtins))


class _Refs:
    """Dynamic-reference collector with static exemptions: a name
    counts only when it is reachable OUTSIDE shape/dtype reads,
    `is None` tests, isinstance/len-class calls."""

    def __init__(self, traced_names: Set[str]):
        self.traced = traced_names
        self.hits: Set[str] = set()

    def collect(self, node) -> Set[str]:
        self._walk(node)
        return self.hits

    def _walk(self, node):
        if node is None:
            return
        if isinstance(node, ast.Name):
            if node.id in self.traced:
                self.hits.add(node.id)
            return
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                return  # x.shape / x.dtype are host values
            self._walk(node.value)
            return
        if isinstance(node, ast.Call):
            tgt = _call_target(node.func)
            if tgt in STATIC_CALLS:
                return
            self._walk(node.func)
            for a in node.args:
                self._walk(a)
            for kw in node.keywords:
                self._walk(kw.value)
            return
        if isinstance(node, ast.Compare):
            if node.ops and all(isinstance(op, (ast.Is, ast.IsNot))
                                for op in node.ops):
                return  # `x is None` is a static identity test
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return  # nested scopes are checked on their own
        for child in ast.iter_child_nodes(node):
            self._walk(child)


def _walk_own_scope(node):
    """ast.walk, but pruning nested function/lambda subtrees — an
    inner helper's assignments belong to ITS scope, and letting them
    leak into the enclosing fixpoint marks host-side names traced
    (false HS402/HS404 positives on plain Python values)."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.Lambda)):
        return  # a nested def at the top is itself another scope
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)


def _traced_names_fixpoint(fn: _Func, body) -> Set[str]:
    """Parameters of this device step (and of enclosing ones) plus
    locals provably derived from them (bounded fixpoint over the
    straight-line assignments of THIS scope only).  A method's
    receiver (`self`, `cls`) is the host object, not a tensor."""
    traced = set(fn.params) - _RECEIVERS
    scope = fn.parent
    while scope is not None:
        if scope.traced:
            traced |= scope.params - _RECEIVERS
        scope = scope.parent
    for _ in range(4):
        grew = False
        for node in body:
            for stmt in _walk_own_scope(node):
                targets, value = None, None
                if isinstance(stmt, ast.Assign):
                    targets, value = stmt.targets, stmt.value
                elif isinstance(stmt, ast.AugAssign):
                    targets, value = [stmt.target], stmt.value
                elif isinstance(stmt, ast.AnnAssign) and stmt.value:
                    targets, value = [stmt.target], stmt.value
                if value is None:
                    continue
                if _Refs(traced).collect(value):
                    for t in targets:
                        for nm in ast.walk(t):
                            if isinstance(nm, ast.Name) \
                                    and nm.id not in traced:
                                traced.add(nm.id)
                                grew = True
        if not grew:
            break
    return traced


class _HazardFinder(ast.NodeVisitor):
    """Second pass over ONE device step's body."""

    def __init__(self, relpath: str, fn: _Func, findings: list):
        self.relpath = relpath
        self.fn = fn
        self.findings = findings
        body = getattr(fn.node, "body", [])
        if isinstance(fn.node, ast.Lambda):
            body = [fn.node.body]
        self.body = body if isinstance(body, list) else [body]
        self.traced_names = _traced_names_fixpoint(fn, self.body)

    def run(self):
        for node in self.body:
            self.visit(node)

    def _loc(self, node) -> str:
        return f"{self.relpath}:{node.lineno}"

    def _refs(self, node) -> Set[str]:
        return _Refs(self.traced_names).collect(node)

    # nested scopes are visited as their own traced functions
    def visit_FunctionDef(self, node):
        return

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        return

    def visit_Call(self, node):
        tgt = _call_target(node.func)
        # HS401 — .item()
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "item"
                and self._refs(node.func.value)):
            self.findings.append(make_finding(
                "HS401", self._loc(node),
                f"`.item()` on a tensor inside device step "
                f"{self.fn.name!r} — a forced host sync that stalls the "
                "launch queue",
                hint="return the tensor and sync on the host side, or "
                     "keep the value on the device"))
        # HS402 — float()/int()/bool() on traced values
        elif tgt in ("float", "int", "bool", "complex") \
                and isinstance(node.func, ast.Name) and node.args:
            refs = set()
            for a in node.args:
                refs |= self._refs(a)
            if refs:
                self.findings.append(make_finding(
                    "HS402", self._loc(node),
                    f"{tgt}() of tensor(s) {sorted(refs)} inside device "
                    f"step {self.fn.name!r} — a host sync",
                    hint="keep the value a tensor (torch.where for "
                         "data-dependent choices), or hoist the "
                         "conversion out of the step"))
        # HS403 — host materialization
        elif self._is_host_call(node):
            refs = set()
            for a in node.args:
                refs |= self._refs(a)
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _HOST_METHODS):
                refs |= self._refs(node.func.value)
            if refs:
                self.findings.append(make_finding(
                    "HS403", self._loc(node),
                    f"host copy ({ast.unparse(node.func)}) of tensor(s) "
                    f"{sorted(refs)} inside device step "
                    f"{self.fn.name!r}",
                    hint="keep the value on the device; .cpu()/.numpy()/"
                         "np.asarray belong on the host side of the step"))
        self.generic_visit(node)

    @staticmethod
    def _is_host_call(node: ast.Call) -> bool:
        f = node.func
        if isinstance(f, ast.Attribute):
            base = f.value
            if f.attr in _HOST_FUNCS and isinstance(base, ast.Name) \
                    and base.id in _HOST_MODULES:
                return True
            if f.attr in _HOST_METHODS and not node.args:
                return True
        return False

    def _check_branch(self, node, kind):
        refs = self._refs(node.test)
        if refs:
            self.findings.append(make_finding(
                "HS404", self._loc(node),
                f"`{kind}` branches on tensor(s) {sorted(refs)} inside "
                f"device step {self.fn.name!r} — a host sync to read "
                "the predicate (and a graph break under torch.compile)",
                hint="use torch.where for data-dependent choices"))

    def visit_If(self, node):
        self._check_branch(node, "if")
        self.generic_visit(node)

    def visit_While(self, node):
        self._check_branch(node, "while")
        self.generic_visit(node)


def _closure_findings(fn: _Func, relpath: str, findings: list):
    """HS406: a device step closing over a loop-assigned enclosing
    name."""
    if not fn.traced or fn.node is None:
        return
    loads = set()
    body = getattr(fn.node, "body", None) or [fn.node.body]
    for node in body if isinstance(body, list) else [body]:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx,
                                                        ast.Load):
                loads.add(sub.id)
    free = loads - fn.assigned - _BUILTINS
    chain, scope = fn, fn.parent
    while scope is not None and scope.parent is not None:
        # module-level loop rebinds are script drivers; only function
        # scopes bake closures into one compiled function.  A def that
        # itself sits inside the rebinding loop is a FRESH function per
        # iteration — per-iteration capture by construction, not a
        # stale guard — so the chain crossing a loop-defined function
        # exempts that scope.
        hits = (sorted(free & scope.loop_assigned - scope.params)
                if not chain.defined_in_loop else [])
        for name in hits:
            findings.append(make_finding(
                "HS406", f"{relpath}:{fn.node.lineno}",
                f"device step {fn.name!r} closes over {name!r}, which "
                f"{scope.name!r} rebinds inside a loop — each new value "
                "fails the compiled code's guard and recompiles",
                hint="pass the value as a (tensor) argument to the step "
                     "instead of closing over it"))
        free -= scope.assigned
        chain, scope = scope, scope.parent


_DISABLE_RE = None  # compiled lazily (keep the module import light)


def _suppressions(text: str) -> dict:
    """lineno -> set of rule ids (or {"*"}) disabled by an inline
    `# lint: disable=HS403[,HS404]` (or bare `# lint: disable`)
    comment — the mechanism for sites where the flagged pattern is the
    point (a deliberate sync, with its reason), so the committed
    allowlist can stay empty.  flake8 `# noqa` comments are
    deliberately NOT honored: their rule namespace is not ours."""
    global _DISABLE_RE
    import re
    if _DISABLE_RE is None:
        _DISABLE_RE = re.compile(
            r"#\s*lint:\s*disable\s*(?:=\s*"
            r"([A-Z]{2}\d{3}(?:\s*,\s*[A-Z]{2}\d{3})*))?")
    out = {}
    for i, line in enumerate(text.splitlines(), 1):
        if "#" not in line:
            continue
        m = _DISABLE_RE.search(line)
        if not m:
            continue
        rules = m.group(1)
        out[i] = (set(r.strip() for r in rules.split(","))
                  if rules else {"*"})
    return out


def lint_source_text(text: str, path: str,
                     relpath: Optional[str] = None) -> List[Finding]:
    """AST-lint one Python source string.  `relpath` is the location
    prefix findings carry (defaults to `path`).  Findings on lines
    carrying a `# lint: disable=RULE` comment are dropped."""
    rel = relpath or path
    try:
        tree = ast.parse(text, filename=path)
    except SyntaxError as e:
        return [make_finding(
            "HS404", f"{rel}:{e.lineno or 0}",
            f"file does not parse: {e.msg}", severity="error",
            hint="fix the syntax error; the lint pass cannot see "
                 "inside")]
    builder = _ScopeBuilder()
    builder.visit(tree)
    _propagate_traced(builder.module)
    findings: List[Finding] = []
    for lineno, tgt in builder.jit_in_loop:
        findings.append(make_finding(
            "HS405", f"{rel}:{lineno}",
            f"torch.{tgt}(...) constructed inside a loop — every "
            "iteration builds a fresh compiled function and pays a full "
            "compile",
            hint="hoist the torch.compile above the loop and call the "
                 "one compiled function inside it"))

    def walk_funcs(fn: _Func):
        if fn.traced and fn.node is not None:
            _HazardFinder(rel, fn, findings).run()
            _closure_findings(fn, rel, findings)
        for child in fn.children:
            walk_funcs(child)

    walk_funcs(builder.module)

    disabled = _suppressions(text)
    if disabled:
        def _suppressed(f):
            line = f.location.rpartition(":")[2]
            rules = disabled.get(int(line) if line.isdigit() else -1)
            return bool(rules) and ("*" in rules or f.rule in rules)
        findings = [f for f in findings if not _suppressed(f)]

    def _line_key(f):
        path, _, line = f.location.rpartition(":")
        return (path, int(line) if line.isdigit() else 0, f.rule)

    findings.sort(key=_line_key)
    return findings


def lint_source(path, root=None) -> List[Finding]:
    """AST-lint one file; locations are relative to `root` when
    given."""
    with open(path) as f:
        text = f.read()
    rel = os.path.relpath(path, root) if root else os.fspath(path)
    return lint_source_text(text, str(path), relpath=rel)


def lint_paths(paths, root=None) -> List[Finding]:
    """AST-lint every .py file under each path (files or directories),
    sorted for deterministic output."""
    files = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d != "__pycache__"
                               and not d.startswith(".")]
                files += [os.path.join(dirpath, fn) for fn in filenames
                          if fn.endswith(".py")]
        else:
            files.append(os.fspath(p))
    findings: List[Finding] = []
    for fp in sorted(set(files)):
        findings += lint_source(fp, root=root)
    return findings
