"""The port's capture rules: host-sync-in-capture, tensor-branch,
program-key-hygiene — the counterparts of the JAX package's
``analysis/jax_rules.py`` (host-sync-in-jit, tracer-branch,
static-arg-hygiene; ``JAX_COUNTERPART``). Stdlib only.

JAX's traced region is the body of a ``jit`` or a ``while_loop``; the
port's is the Python that runs while a dispatch graph's body is captured
(``torch.cuda.is_current_stream_capturing()``): the cycle handed to a
``DispatchGraph`` (`ops/dispatch.py`), each slot's cycle of a
``BatchGraph``, a ``MeshGraph``'s cycles and balance step (`ops/mesh.py`),
and what they call. There a ``.item()`` raises on the card while the CPU
path, which runs the same cycles eagerly, passes; a Python ``if`` on a
tensor syncs or bakes one branch into the graph. All three rules share one
analysis, the set of *captured functions*. A function is a captured root
when it is

  * a callable argument of ``DispatchGraph(...)``, ``BatchGraph(...)`` or
    ``MeshGraph(...)``: a lambda, a name, ``self.<method>``, or an element
    (a lambda or a name) of a list literal or comprehension there;
  * the body of a ``with torch.cuda.graph(...)`` block;
  * a finalizer (``__del__``, a ``weakref.finalize`` callback): the
    collector runs it wherever it runs, inside a capture too; or
  * marked ``# tts-lint: traced (<why>)``, the JAX package's own marker,
    so that one grep finds both: the escape hatch for a callable chosen at
    run time (``lambda: cycle(state)`` over the bound method the engine
    picked, a mesh's ``g.cycles``) and for what a capture enters around
    its body (the stream and memory-pool context managers).

Capturedness then closes over the calls the resolver can follow: a local
name (innermost scope outward, as the JAX rule does); ``self.<method>``
within the enclosing class, its bases and the overrides of its subclasses;
a method of a parameter annotated with a class of the linted project; and,
unlike the JAX rule, which is lexical by design, a function of another
module of the linted project, imported by name (``from ..ops.compaction
import compact_ids``) or called through its module (``_build.entry``):
the port's captured cycles call across modules into ``ops/``. A lambda or
a generator expression inside a captured function is captured with it.

Under a capture every tensor is on the card, so the closure and the rules
read a kernel wrapper's device test (``x.is_cuda``, ``x.device.type ==
"cuda"``, and their negations, ``and``s and ``or``s): the branch a CPU
tensor takes (the plain version), and what follows a card branch that
returns, never runs under a capture and is not followed.
``captured_functions(..., plain=True)`` follows both branches: the set
that the CPU path of the same cycles runs.
"""

from __future__ import annotations

import ast
import os

from .core import PRAGMA, Finding, Module, Project, rule

#: Port rule -> the JAX rule it counterparts (`analysis/jax_rules.py`).
JAX_COUNTERPART = {
    "host-sync-in-capture": "host-sync-in-jit",
    "tensor-branch": "tracer-branch",
    "program-key-hygiene": "static-arg-hygiene",
}

#: The graph builders whose callable arguments run under a capture.
GRAPH_ENTRIES = {"DispatchGraph", "BatchGraph", "MeshGraph"}

#: Method calls that synchronize with / copy to the host.
HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize",
                     "nonzero"}

#: Qualified calls that materialize device values on the host or wait for
#: the device.
HOST_SYNC_CALLS = {
    "numpy.asarray", "numpy.array", "numpy.ascontiguousarray", "numpy.copy",
    "torch.cuda.synchronize", "torch.nonzero", "torch.unique",
    "torch.masked_select",
}

FunctionNode = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


class _Scopes:
    """Lexical function-name resolution for one module."""

    def __init__(self, module: Module):
        self.module = module
        # scope -> {name: def nodes} (a name defined in both branches of an
        # ``if`` has two)
        self.defs: dict[ast.AST | None, dict[str, list]] = {None: {}}
        for node in ast.walk(module.tree):
            if isinstance(node, _DEFS):
                owner = module.enclosing_function(node)
                self.defs.setdefault(owner, {}).setdefault(
                    node.name, []).append(node)

    def resolve_all(self, at: ast.AST, name: str) -> list:
        """Innermost-scope-outward lookup of a function name: every def of
        it in the nearest scope that has one."""
        scope = self.module.enclosing_function(at)
        while True:
            found = self.defs.get(scope, {}).get(name)
            if found:
                return found
            if scope is None:
                return []
            scope = self.module.enclosing_function(scope)

    def resolve(self, at: ast.AST, name: str) -> ast.AST | None:
        found = self.resolve_all(at, name)
        return found[-1] if found else None


# -- the device test -------------------------------------------------------


def on_card(test: ast.AST) -> bool | None:
    """The value of a branch test when every tensor is on the card (under a
    capture): True or False for a device test (``x.is_cuda``,
    ``x.device.type == "cuda"``, ``!= "cpu"``, their negations, ``and``s
    and ``or``s of them with other tests), None when it depends on more."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        v = on_card(test.operand)
        return None if v is None else not v
    if isinstance(test, ast.Attribute) and test.attr == "is_cuda":
        return True
    if (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.left, ast.Attribute)
            and test.left.attr == "type"
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value in ("cuda", "cpu")
            and isinstance(test.ops[0], (ast.Eq, ast.NotEq))):
        return ((test.comparators[0].value == "cuda")
                == isinstance(test.ops[0], ast.Eq))
    if isinstance(test, ast.BoolOp):
        vals = [on_card(v) for v in test.values]
        if isinstance(test.op, ast.Or):
            return True if True in vals else (
                False if all(v is False for v in vals) else None)
        return False if False in vals else (
            True if all(v is True for v in vals) else None)
    return None


def _ends(stmts: list) -> bool:
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


def _body(fn: ast.AST) -> list:
    return [fn.body] if isinstance(fn, ast.Lambda) else fn.body


def plain_only(fn: ast.AST) -> set[ast.AST]:
    """The statements and expressions of ``fn``'s own body that run only
    on a CPU tensor: the branch of a device test that the card does not
    take, and what follows a taken card branch that returns."""
    skip: set[ast.AST] = set()

    def block(stmts: list) -> None:
        for i, s in enumerate(stmts):
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                continue
            if isinstance(s, ast.If):
                v = on_card(s.test)
                if v is not None:
                    taken, dead = (s.body, s.orelse) if v else (
                        s.orelse, s.body)
                    skip.update(dead)
                    block(taken)
                    if _ends(taken):
                        skip.update(stmts[i + 1:])
                        return
                    continue
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(s, field, None)
                if isinstance(sub, list) and sub and isinstance(
                        sub[0], ast.stmt):
                    block(sub)
            for h in getattr(s, "handlers", ()):
                block(h.body)
            for c in getattr(s, "cases", ()):
                block(c.body)

    block([] if isinstance(fn, ast.Lambda) else fn.body)
    # Conditional expressions: ``cuda(x) if x.is_cuda else plain(x)``.
    for node in _walk(_body(fn), skip):
        if isinstance(node, ast.IfExp):
            v = on_card(node.test)
            if v is not None:
                skip.add(node.orelse if v else node.body)
    return skip


def _walk(roots: list, skip: set = frozenset()):
    """Walk ``roots`` without descending into nested functions (yielded,
    not entered) or into ``skip``."""
    stack = [n for n in roots if n not in skip]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if child in skip:
                continue
            if isinstance(child, FunctionNode):
                yield child  # the def itself (for call-closure), not its body
                continue
            stack.append(child)


def _own_nodes(fn: ast.AST, plain: bool = True, module: Module | None = None):
    """Walk a function's body without descending into nested functions
    (nested defs get their own walk once proven captured); with ``plain``
    False, without the branches only a CPU tensor takes (``plain_only``);
    with ``module``, without the branches marked ``uncaptured``."""
    skip = set() if plain else plain_only(fn)
    if module is not None:
        skip |= uncaptured(module, fn)
    return _walk(_body(fn), skip)


def uncaptured(module: Module, fn: ast.AST) -> set[ast.AST]:
    """The bodies of the ``if`` statements of ``fn`` marked ``# tts-lint:
    uncaptured (<why>)`` (on the ``if`` line or the line above it): a
    branch a capture never takes, such as a cache's first-use build that
    the program runs before it captures anything."""
    out: set[ast.AST] = set()
    for node in _walk(_body(fn)):
        if isinstance(node, ast.If):
            for line in (node.lineno, node.lineno - 1):
                comment = module.comments.get(line, "")
                if PRAGMA in comment and "uncaptured" in comment.split(
                        PRAGMA, 1)[-1]:
                    out.update(node.body)
    return out


def _has_marker(module: Module, fn: ast.AST) -> bool:
    if isinstance(fn, ast.Lambda):
        return False
    first = min([fn.lineno] + [d.lineno for d in fn.decorator_list])
    for line in (fn.lineno, first, first - 1):
        comment = module.comments.get(line, "")
        if PRAGMA in comment and "traced" in comment.split(PRAGMA, 1)[-1]:
            return True
    return False


# -- the project's modules, imports and classes ----------------------------


def module_name(path: str) -> tuple[str, bool]:
    """A module's dotted name from its path (``a/b/c.py`` -> ``a.b.c``),
    and whether it is a package's ``__init__``."""
    stem = os.path.splitext(os.path.normpath(path))[0]
    parts = [p for p in stem.split(os.sep) if p and p not in (".", "..")]
    pkg = bool(parts) and parts[-1] == "__init__"
    if pkg:
        parts = parts[:-1]
    return ".".join(parts), pkg


class _ModInfo:
    """One module's top-level functions, classes, import bindings and
    lexical scopes."""

    def __init__(self, module: Module):
        self.module = module
        self.name, self.pkg = module_name(module.path)
        self.scopes = _Scopes(module)
        self.functions = {
            n.name: n for n in module.tree.body if isinstance(n, _DEFS)}
        self.classes: dict[str, ast.ClassDef] = {}
        for n in ast.walk(module.tree):
            if isinstance(n, ast.ClassDef):
                self.classes.setdefault(n.name, n)
        # local name -> ("from", module, name) or ("mod", module)
        self.imports: dict[str, tuple] = {}
        for n in ast.walk(module.tree):
            if isinstance(n, ast.Import):
                for a in n.names:
                    if a.asname:
                        self.imports[a.asname] = ("mod", a.name)
                    else:
                        root = a.name.split(".")[0]
                        self.imports[root] = ("mod", root)
            elif isinstance(n, ast.ImportFrom):
                base = self._absolute(n.module, n.level)
                for a in n.names:
                    self.imports[a.asname or a.name] = ("from", base, a.name)

    def _absolute(self, mod: str | None, level: int) -> str:
        if not level:
            return mod or ""
        parts = self.name.split(".") if self.name else []
        drop = level - 1 if self.pkg else level
        parts = parts[:len(parts) - drop] if drop else parts
        return ".".join(parts + ([mod] if mod else []))


class _Index:
    """Every module of a lint run, by dotted name, and the resolver of the
    calls that the closure follows."""

    def __init__(self, project: Project):
        self.infos = [_ModInfo(m) for m in project.modules]
        self.by_module = {i.module: i for i in self.infos}
        self.by_name = {i.name: i for i in self.infos}
        # class node -> owning info
        self.class_info: dict[ast.ClassDef, _ModInfo] = {}
        for i in self.infos:
            for n in ast.walk(i.module.tree):
                if isinstance(n, ast.ClassDef):
                    self.class_info[n] = i
        self._attr_cache: dict = {}
        self._sub_cache: dict = {}
        self._locals: dict = {}

    def module(self, target: str, near: _ModInfo) -> _ModInfo | None:
        """The linted module named ``target``: exact, else the one whose
        name ends with it (paths linted from elsewhere), nearest ``near``."""
        if not target:
            return None
        if target in self.by_name:
            return self.by_name[target]
        cands = [i for i in self.infos if i.name.endswith("." + target)]
        if not cands:
            return None

        def shared(i):
            a, b = i.name.split("."), near.name.split(".")
            k = 0
            while k < min(len(a), len(b)) and a[k] == b[k]:
                k += 1
            return k
        return max(cands, key=shared)

    def binding(self, info: _ModInfo, name: str, depth: int = 0):
        """What ``name`` is bound to in ``info``: ("def", info, node),
        ("class", info, node), ("mod", info) or None."""
        if depth > 4:
            return None
        if name in info.functions:
            return ("def", info, info.functions[name])
        if name in info.classes and info.classes[name] in info.module.tree.body:
            return ("class", info, info.classes[name])
        imp = info.imports.get(name)
        if imp is None:
            return None
        if imp[0] == "mod":
            target = self.module(imp[1], info)
            return ("mod", target) if target is not None else None
        _, base, attr = imp
        mod = self.module(base, info)
        if mod is not None:
            got = self.binding(mod, attr, depth + 1)
            if got is not None:
                return got
        sub = self.module(f"{base}.{attr}" if base else attr, info)
        return ("mod", sub) if sub is not None else None

    def class_of(self, info: _ModInfo, expr: ast.AST,
                 depth: int = 0) -> tuple[_ModInfo, ast.ClassDef] | None:
        """The project class an annotation or a base names."""
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            try:
                expr = ast.parse(expr.value, mode="eval").body
            except SyntaxError:
                return None
        if isinstance(expr, ast.BinOp):  # ``X | None``
            return (self.class_of(info, expr.left, depth)
                    or self.class_of(info, expr.right, depth))
        if isinstance(expr, ast.Subscript):  # ``Optional[X]``
            return self.class_of(info, expr.slice, depth)
        if isinstance(expr, ast.Name):
            if expr.id in info.classes:
                return info, info.classes[expr.id]
            got = self.binding(info, expr.id)
        elif isinstance(expr, ast.Attribute) and isinstance(
                expr.value, ast.Name):
            mod = self.binding(info, expr.value.id)
            got = (self.binding(mod[1], expr.attr, depth + 1)
                   if mod and mod[0] == "mod" else None)
        else:
            return None
        if got and got[0] == "class":
            return got[1], got[2]
        return None

    def methods(self, info: _ModInfo, cls: ast.ClassDef,
                name: str) -> list[tuple[_ModInfo, ast.AST]]:
        """``cls.<name>``: the method found in the class or its bases (the
        nearest), and the overrides of the project's subclasses of it."""
        out = []
        seen = set()
        work = [(info, cls)]
        while work:  # the class, then its bases
            i, c = work.pop(0)
            if c in seen:
                continue
            seen.add(c)
            m = _method(c, name)
            if m is not None:
                out.append((i, m))
                break
            for b in c.bases:
                got = self.class_of(i, b)
                if got is not None:
                    work.append(got)
        for sub_info, sub in self.subclasses(cls):
            m = _method(sub, name)
            if m is not None:
                out.append((sub_info, m))
        return out

    def subclasses(self, cls: ast.ClassDef) -> list:
        """The project's classes derived from ``cls``, at any depth."""
        if cls in self._sub_cache:
            return self._sub_cache[cls]
        if not hasattr(self, "_bases"):
            self._bases = {
                c: [got[1] for got in (self.class_of(i, b) for b in c.bases)
                    if got is not None]
                for c, i in self.class_info.items()}
        out, seen, work = [], {cls}, [cls]
        while work:
            base = work.pop()
            for c, bases in self._bases.items():
                if c not in seen and base in bases:
                    seen.add(c)
                    out.append((self.class_info[c], c))
                    work.append(c)
        self._sub_cache[cls] = out
        return out

    def callees(self, info: _ModInfo, call: ast.Call, params: dict,
                depth: int = 0) -> list[tuple[_ModInfo, ast.AST]]:
        """The functions ``call`` may enter, as far as the resolver follows
        (a class's call enters its ``__init__``); ``params``: the typed
        parameters of the function it is in."""
        return self.targets(info, call, call.func, params, True, depth)

    def targets(self, info: _ModInfo, at: ast.AST, f: ast.AST, params: dict,
                called: bool = False,
                depth: int = 0) -> list[tuple[_ModInfo, ast.AST]]:
        """The project functions the expression ``f`` (at ``at``) names: a
        local or imported function, a module's function, a method of
        ``self``, of a typed parameter or of a typed attribute (a property
        read runs it)."""
        if isinstance(f, ast.Name):
            local = info.scopes.resolve_all(at, f.id)
            if local:
                return [(info, d) for d in local]
            got = self.binding(info, f.id)
            if got and got[0] == "def":
                return [(got[1], got[2])]
            if called and got and got[0] == "class":
                return self.methods(got[1], got[2], "__init__")
            return []
        if not isinstance(f, ast.Attribute):
            return []
        recv = f.value
        if isinstance(recv, ast.Name) and recv.id not in params:
            got = self.binding(info, recv.id)
            if got and got[0] == "mod":
                sub = self.binding(got[1], f.attr)
                if sub and sub[0] == "def":
                    return [(sub[1], sub[2])]
                if called and sub and sub[0] == "class":
                    return self.methods(sub[1], sub[2], "__init__")
                return []
        out = []
        for ci, cls in self.classes_of(info, at, recv, params, depth):
            out.extend(self.methods(ci, cls, f.attr))
        return out

    def classes_of(self, info: _ModInfo, at: ast.AST, expr: ast.AST,
                   params: dict, depth: int = 0) -> list:
        """The project classes ``expr`` (at ``at``) may be an instance of:
        ``self``/``cls`` (the enclosing class), a parameter annotated with
        a project class, ``self.<attr>`` as the class's methods assign it,
        a class's call, a call of a function annotated to return one, and
        a bare class name (its static methods)."""
        if depth > 3:
            return []
        if isinstance(expr, ast.Name):
            if expr.id in ("self", "cls"):
                cls = info.module.enclosing_class(at)
                return [(info, cls)] if cls is not None else []
            if expr.id in params:
                return [params[expr.id]]
            fn = info.module.enclosing_function(at)
            local = self.locals_of(fn).get(expr.id) if fn else None
            if local:  # a local: what its assignments hold
                return [c for v in local for c in self.classes_of(
                    info, v, v, params, depth + 1)]
            got = self.binding(info, expr.id)
            return [(got[1], got[2])] if got and got[0] == "class" else []
        if isinstance(expr, ast.Attribute):
            out = []
            for ci, cls in self.classes_of(info, at, expr.value, params,
                                           depth + 1):
                out.extend(self.attr_classes(ci, cls, expr.attr, depth + 1))
            return out
        if isinstance(expr, ast.Call):
            out = []
            for ci, callee in self.callees(info, expr, params, depth + 1):
                if callee.name == "__init__":
                    cls = ci.module.enclosing_class(callee)
                    if cls is not None:
                        out.append((ci, cls))
                elif callee.returns is not None:
                    got = self.class_of(ci, callee.returns)
                    if got is not None:
                        out.append(got)
            f = expr.func
            if isinstance(f, ast.Name):
                got = self.binding(info, f.id)
                if got and got[0] == "class":
                    out.append((got[1], got[2]))
            return out
        return []

    def locals_of(self, fn: ast.AST) -> dict[str, list]:
        """``fn``'s plain-name assignments: name -> the values assigned."""
        got = self._locals.get(fn)
        if got is None:
            got = self._locals[fn] = {}
            for a in _own_nodes(fn):
                if isinstance(a, ast.Assign):
                    for t in a.targets:
                        if isinstance(t, ast.Name):
                            got.setdefault(t.id, []).append(a.value)
        return got

    def attr_classes(self, info: _ModInfo, cls: ast.ClassDef, attr: str,
                     depth: int) -> list:
        """The project classes ``<a cls>.<attr>`` may hold: a class-level
        annotation, or what the methods of the class and its bases assign
        to ``self.<attr>``."""
        key = (cls, attr)
        if key in self._attr_cache:
            return self._attr_cache[key]
        self._attr_cache[key] = []  # cycles resolve to nothing
        out = []
        chain, seen = [(info, cls)], set()
        while chain:
            ci, c = chain.pop(0)
            if c in seen:
                continue
            seen.add(c)
            for n in c.body:
                if (isinstance(n, ast.AnnAssign)
                        and isinstance(n.target, ast.Name)
                        and n.target.id == attr):
                    got = self.class_of(ci, n.annotation)
                    if got is not None:
                        out.append(got)
                if isinstance(n, _DEFS):
                    params = self.typed_params(ci, n)
                    for a in ast.walk(n):
                        if isinstance(a, ast.Assign) and any(
                                isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self" and t.attr == attr
                                for t in a.targets):
                            out.extend(self.classes_of(
                                ci, a, a.value, params, depth + 1))
            for b in c.bases:
                got = self.class_of(ci, b)
                if got is not None:
                    chain.append(got)
        uniq = list({id(c): (i, c) for i, c in out}.values())
        self._attr_cache[key] = uniq
        return uniq

    def typed_params(self, info: _ModInfo, fn: ast.AST) -> dict:
        """Parameters annotated with a class of the linted project."""
        if not isinstance(fn, _DEFS + (ast.Lambda,)):
            return {}
        out = {}
        a = fn.args
        for arg in a.posonlyargs + a.args + a.kwonlyargs:
            if arg.annotation is not None:
                got = self.class_of(info, arg.annotation)
                if got is not None:
                    out[arg.arg] = got
        return out


def _method(cls: ast.ClassDef, name: str):
    for n in cls.body:
        if isinstance(n, _DEFS) and n.name == name:
            return n
    return None


def _graph_call(module: Module, call: ast.Call) -> bool:
    qual = module.qualname(call.func)
    return qual is not None and qual.split(".")[-1] in GRAPH_ENTRIES


def _cuda_graph_with(module: Module, node: ast.AST) -> bool:
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return False
    for item in node.items:
        e = item.context_expr
        if isinstance(e, ast.Call):
            qual = module.qualname(e.func)
            if qual in ("torch.cuda.graph", "torch.cuda.graphs.graph"):
                return True
    return False


def _callable_roots(info: _ModInfo, idx: _Index, call: ast.Call) -> list:
    """The functions a graph builder's arguments name."""
    out = []
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        elts = [arg]
        if isinstance(arg, ast.IfExp):
            elts = [arg.body, arg.orelse]
        elif isinstance(arg, (ast.List, ast.Tuple)):
            elts = list(arg.elts)
        elif isinstance(arg, (ast.ListComp, ast.GeneratorExp)):
            elts = [arg.elt]
        for e in elts:
            if isinstance(e, ast.Lambda):
                out.append((info, e))
            elif isinstance(e, ast.Name):
                out.extend((info, d)
                           for d in info.scopes.resolve_all(call, e.id))
            elif (isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name)
                  and e.value.id == "self"):
                cls = info.module.enclosing_class(call)
                if cls is not None:
                    out.extend((i, m) for i, m in idx.methods(
                        info, cls, e.attr) if not _is_property(m))
    return out


def _is_property(fn: ast.AST) -> bool:
    return any(isinstance(d, ast.Name) and d.id == "property"
               for d in getattr(fn, "decorator_list", ()))


def _bindings(callee: ast.AST, call: ast.Call) -> list[tuple[str, ast.AST]]:
    """``(parameter, argument)`` of a call's plain-name arguments (a
    function passed by name) bound to the callee's parameters."""
    a = callee.args
    pos = [x.arg for x in a.posonlyargs + a.args]
    if pos and pos[0] in ("self", "cls") and isinstance(call.func,
                                                        ast.Attribute):
        pos = pos[1:]
    out = []
    for i, arg in enumerate(call.args):
        if i < len(pos) and isinstance(arg, (ast.Name, ast.Attribute)):
            out.append((pos[i], arg))
    names = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
    for kw in call.keywords:
        if kw.arg in names and isinstance(kw.value, (ast.Name, ast.Attribute)):
            out.append((kw.arg, kw.value))
    return out


def _calls_param(info: _ModInfo, fn: ast.AST, param: str,
                 plain: bool) -> bool:
    """Whether ``fn`` calls, or passes on, its parameter ``param`` in the
    code it runs (on the card unless ``plain``)."""
    for node in _own_nodes(fn, plain, info.module):
        if isinstance(node, ast.Name) and node.id == param and isinstance(
                node.ctx, ast.Load):
            parent = info.module.parent.get(node)
            if isinstance(parent, ast.Attribute):
                continue  # ``param.__name__``: a read, not a call
            return True
    return False


def _nested(fn: ast.AST, plain: bool, module: Module) -> list:
    """Lambdas and generator expressions of ``fn``'s own body: closures
    made there (a lambda) and frames of their own (a generator
    expression), run with it."""
    return [n for n in _own_nodes(fn, plain, module)
            if n is not fn and isinstance(n, (ast.Lambda, ast.GeneratorExp))]


def _closure(project: Project, plain: bool) -> dict[Module, set]:
    idx = project.fact("capture-index", _Index)
    roots: list[tuple[_ModInfo, ast.AST]] = []
    for info in idx.infos:
        mod = info.module
        for node in ast.walk(mod.tree):
            if isinstance(node, _DEFS) and (
                    _has_marker(mod, node) or node.name == "__del__"):
                roots.append((info, node))
            elif isinstance(node, ast.Call) and _graph_call(mod, node):
                roots.extend(_callable_roots(info, idx, node))
            elif (isinstance(node, ast.Call) and len(node.args) > 1
                  and mod.qualname(node.func) == "weakref.finalize"):
                roots.extend(idx.targets(info, node, node.args[1], {}))
            elif _cuda_graph_with(mod, node):
                roots.append((info, node))
    out: dict[Module, set] = {i.module: set() for i in idx.infos}
    work = list(roots)
    while work:
        info, fn = work.pop()
        if fn in out[info.module]:
            continue
        out[info.module].add(fn)
        if isinstance(fn, ast.GeneratorExp):
            continue  # walked with the function that holds it
        params = idx.typed_params(info, fn)
        bound: set[ast.AST] = set()  # arguments bound to a callee's params
        nodes = list(_own_nodes(fn, plain, info.module))
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            found = idx.callees(info, node, params)
            for ci, callee in found:
                if callee not in out[ci.module]:
                    work.append((ci, callee))
            # A function passed to a project function is captured where
            # that function calls the parameter it binds (on the card: a
            # wrapper's plain cycle passed beside its CUDA one is not).
            defs = [(ci, d) for ci, d in found if isinstance(d, _DEFS)]
            if not defs:
                continue
            for param, arg in _bindings(defs[0][1], node):
                bound.add(arg)
                if not any(_calls_param(ci, d, param, plain)
                           for ci, d in defs):
                    continue
                for ci, callee in idx.targets(info, arg, arg, params):
                    if callee not in out[ci.module]:
                        work.append((ci, callee))
        for node in nodes:
            # A reference that may be called here (a function picked from
            # a dict or an ``if`` expression, a bound method) or that runs
            # on a read (a property).
            if (isinstance(node, (ast.Name, ast.Attribute))
                    and isinstance(node.ctx, ast.Load) and node not in bound):
                for ci, callee in idx.targets(info, node, node, params):
                    if callee not in out[ci.module]:
                        work.append((ci, callee))
        for n in _nested(fn, plain, info.module):
            if n not in out[info.module]:
                work.append((info, n))
    return out


def captured_functions(module: Module, project: Project,
                       plain: bool = False) -> set[ast.AST]:
    """The function nodes of ``module`` (defs, lambdas, generator
    expressions, ``with torch.cuda.graph`` blocks) whose bodies run under
    a dispatch graph's capture; with ``plain`` the set the CPU path of the
    same cycles runs (both branches of every device test)."""
    sets = project.fact(f"captured:{plain}",
                        lambda p: _closure(p, plain))
    return sets.get(module, set())


def function_key(module: Module, fn: ast.AST) -> tuple[str, str, int]:
    """``(path, name, first line)`` of a function node as its code object
    names it (``co_name``, ``co_firstlineno``: a decorated def starts at
    its first decorator)."""
    if isinstance(fn, _DEFS):
        first = min([fn.lineno] + [d.lineno for d in fn.decorator_list])
        return module.path, fn.name, first
    if isinstance(fn, ast.Lambda):
        return module.path, "<lambda>", fn.lineno
    if isinstance(fn, ast.GeneratorExp):
        return module.path, "<genexpr>", fn.lineno
    return module.path, "<with>", fn.lineno


def captured_keys(paths, plain: bool = False) -> set[tuple[str, str, int]]:
    """``function_key`` of every captured function of the files under
    ``paths`` (one lint run's parse)."""
    from .core import parse_modules

    modules, _ = parse_modules(paths)
    project = Project(modules)
    return {function_key(m, fn) for m in modules
            for fn in captured_functions(m, project, plain)}


# -- taint: which local names may hold tensors ------------------------------


#: Attribute reads that yield static (Python-level) metadata of a tensor:
#: values derived through them are not tensors.
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "itemsize",
                "__name__"}
#: Method calls that return static metadata of a tensor.
STATIC_METHODS = {"numel", "dim", "size", "element_size", "data_ptr",
                  "is_contiguous", "stride", "get_device"}
#: Builtins whose result is static metadata of their argument.
STATIC_CALLS = {"len", "isinstance", "type", "id", "callable", "hasattr"}
#: Annotations of values that are no tensor: Python scalars, torch's
#: dtype and device, containers of those, and their typing spellings.
_SCALAR_ANN = {"int", "bool", "str", "float"}
_STATIC_ANN = _SCALAR_ANN | {
    "dtype", "device", "torch", "tuple", "list", "dict", "set", "frozenset",
    "Optional", "Union", "Sequence", "Mapping", "Iterable", "Callable",
    "typing"}
_TENSOR_ANN = {"Tensor", "ndarray", "Any", "Array", "ArrayLike"}


def _static_ann(ann: ast.AST | None) -> bool:
    """An annotation that admits no tensor: it names a Python scalar,
    ``torch.dtype`` or ``torch.device``, or a container of those, and
    nothing else (a union that admits a tensor is not static)."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    names = {n.id if isinstance(n, ast.Name) else n.attr
             for n in ast.walk(ann) if isinstance(n, (ast.Name, ast.Attribute))}
    return bool(names) and not (names & _TENSOR_ANN) and names <= _STATIC_ANN


class _Static:
    """What the rules know to be static in one captured function: the
    calls of project functions (and the properties) annotated to return a
    static value, resolved as the closure resolves them. No project (a
    fixture linted alone) knows only the builtin cases."""

    def __init__(self, idx: "_Index | None" = None, info=None, fn=None):
        self.idx, self.info = idx, info
        self.params = idx.typed_params(info, fn) if idx is not None else {}

    def call(self, node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in STATIC_METHODS:
            return True
        if isinstance(f, ast.Name) and f.id in STATIC_CALLS:
            return True
        if self.idx is None:
            return False
        defs = self.idx.callees(self.info, node, self.params)
        return bool(defs) and all(
            isinstance(d, _DEFS) and _static_ann(d.returns) for _, d in defs)

    def attr(self, node: ast.AST) -> bool:
        """``x.<property>`` of a project class, annotated static."""
        if not isinstance(node, ast.Attribute) or self.idx is None:
            return False
        if node.attr in STATIC_ATTRS:
            return True
        got = []
        for ci, cls in self.idx.classes_of(self.info, node, node.value,
                                           self.params):
            got.extend(self.idx.methods(ci, cls, node.attr))
        return bool(got) and all(
            _is_property(d) and _static_ann(d.returns) for _, d in got)


_BUILTIN = _Static()


def _names_in(node: ast.AST, static: _Static = _BUILTIN) -> set[str]:
    """Loaded names that can carry a tensor out of ``node``: skips
    subtrees under static-metadata attributes and calls (``x.shape[0]``,
    ``x.numel()``, ``len(x)``, a project function annotated ``-> int``)."""
    out: set[str] = set()
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Attribute) and (
                n.attr in STATIC_ATTRS or static.attr(n)):
            continue
        if static.call(n):
            continue
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
            out.add(n.id)
        stack.extend(ast.iter_child_nodes(n))
    return out


def _target_names(target: ast.AST) -> set[str]:
    return {
        n.id for n in ast.walk(target)
        if isinstance(n, ast.Name) and isinstance(n.ctx, (ast.Store,))
    }


def _scalar_like(arg: ast.arg, default: ast.AST | None = None) -> bool:
    """A parameter annotated with a static type (``_static_ann``: a Python
    scalar, ``torch.dtype``, ``torch.device``, a container of those; a
    union that admits a tensor is not), or with a scalar default: not a
    tensor."""
    if arg.annotation is not None:
        return _static_ann(arg.annotation)
    return (isinstance(default, ast.Constant)
            and isinstance(default.value, (bool, int, float, str)))


def static_params(fn: ast.AST) -> set[str]:
    """The parameters that are not tensors under the capture: the
    receiver of a method (``self``, ``cls``) and the scalar-like ones
    (``_scalar_like``) — the counterpart of the JAX rule's
    ``jit_static_params``."""
    if not isinstance(fn, _DEFS + (ast.Lambda,)):
        return set()
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    out = {p.arg for p, d in zip(pos, defaults) if _scalar_like(p, d)}
    out |= {p.arg for p, d in zip(a.kwonlyargs, a.kw_defaults)
            if _scalar_like(p, d)}
    if pos and pos[0].arg in ("self", "cls"):
        out.add(pos[0].arg)
    return out


def tainted_names(fn: ast.AST, static: set[str] = frozenset(),
                  plain: bool = False, seed: set[str] = frozenset(),
                  known: _Static = _BUILTIN) -> set[str]:
    """Forward may-analysis: parameters are tensors; anything assigned
    from an expression mentioning a tensor name may be a tensor too.
    ``static`` names are excluded up front, though an in-body rebind from
    a tainted expression re-taints them; ``seed`` adds names (a ``with``
    block's enclosing function's)."""
    taint: set[str] = set(seed)
    if isinstance(fn, FunctionNode):
        args = fn.args
        taint |= {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}
        if args.vararg:
            taint.add(args.vararg.arg)
        if args.kwarg:
            taint.add(args.kwarg.arg)
    taint -= set(static)
    if isinstance(fn, ast.Lambda):
        return taint
    for _ in range(10):  # fixpoint (bounded; assignment chains are short)
        changed = False
        for node in _own_nodes(fn, plain):
            value = None
            targets: set[str] = set()
            if isinstance(node, ast.Assign):
                value = node.value
                for t in node.targets:
                    targets |= _target_names(t)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                value = node.value
                if node.value is not None:
                    targets |= _target_names(node.target)
            elif isinstance(node, ast.NamedExpr):
                value = node.value
                targets |= _target_names(node.target)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                value = node.iter
                targets |= _target_names(node.target)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if item.optional_vars is not None and (
                            _names_in(item.context_expr, known) & taint):
                        t = _target_names(item.optional_vars)
                        if not t <= taint:
                            taint |= t
                            changed = True
            if value is not None and targets and (
                    _names_in(value, known) & taint):
                if not targets <= taint:
                    taint |= targets
                    changed = True
        if not changed:
            break
    return taint


def _taint_of(module: Module, fn: ast.AST, known: _Static) -> set[str]:
    if isinstance(fn, (ast.With, ast.AsyncWith)):
        outer = module.enclosing_function(fn)
        seed = (tainted_names(outer, static_params(outer), known=known)
                if outer is not None else set())
        return tainted_names(fn, seed=seed, known=known)
    return tainted_names(fn, static_params(fn), known=known)


def _is_tensor_type(node: ast.AST) -> bool:
    return any(isinstance(n, (ast.Name, ast.Attribute))
               and (n.id if isinstance(n, ast.Name) else n.attr) == "Tensor"
               for n in ast.walk(node))


def _not_a_tensor_here(module: Module, node: ast.AST, name: str) -> bool:
    """Whether ``node`` sits where ``name`` is known not to be a tensor:
    the body of ``if not isinstance(name, torch.Tensor)``, or the ``else``
    of ``if isinstance(name, torch.Tensor)``."""
    cur = node
    while True:
        parent = module.parent.get(cur)
        if parent is None or isinstance(parent, FunctionNode):
            return False
        if isinstance(parent, ast.If):
            test, negated = parent.test, False
            if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
                test, negated = test.operand, True
            if (isinstance(test, ast.Call) and isinstance(test.func, ast.Name)
                    and test.func.id == "isinstance" and len(test.args) == 2
                    and isinstance(test.args[0], ast.Name)
                    and test.args[0].id == name
                    and _is_tensor_type(test.args[1])):
                where = parent.body if negated else parent.orelse
                if cur in where:
                    return True
        cur = parent


def _excluded_use(module: Module, name_node: ast.Name, test: ast.AST,
                  static: _Static = _BUILTIN) -> bool:
    """Uses of a tensor name inside a branch test that are static or
    unknowable: ``x is None`` identity checks, static-metadata attributes
    and calls (``x.shape``, ``x.numel()``, ``len(x)``, ``isinstance``, a
    project function or property annotated ``-> bool``), and names that
    only feed *arguments of a call* (the callee may be a pure
    configuration predicate)."""
    cur: ast.AST | None = name_node
    while cur is not None and cur is not test:
        parent = module.parent.get(cur)
        if isinstance(parent, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in parent.ops
        ):
            return True
        if isinstance(parent, ast.Attribute) and (
                parent.attr in STATIC_ATTRS or static.attr(parent)):
            return True
        if isinstance(parent, ast.Call) and (
                cur is not parent.func or static.call(parent)):
            return True
        cur = parent
    return False


def _regions(module: Module, project: Project) -> list:
    """Each captured function of ``module`` with its tainted names and
    what is static in it (once a lint run, for both rules)."""

    def build(_):
        idx = project.fact("capture-index", _Index)
        info = idx.by_module[module]
        out = []
        for fn in sorted(captured_functions(module, project),
                         key=lambda n: (n.lineno, n.col_offset)):
            if isinstance(fn, ast.GeneratorExp):
                continue  # walked with the function that holds it
            known = _Static(idx, info, fn)
            out.append((fn, _taint_of(module, fn, known), known))
        return out
    return project.fact(f"regions:{module.path}", build)


# -- rules -----------------------------------------------------------------


@rule("host-sync-in-capture")
def host_sync_in_capture(module: Module, project: Project) -> list[Finding]:
    """Host-synchronizing calls in a function a dispatch graph captures.
    Each one raises under capture on the card (a read of a device value,
    or a wait, inside a stream capture) — while the CPU path, which runs
    the same cycles eagerly, passes unseen; the cycle's scalars must stay
    on the device and be read after the dispatch (the counterpart of the
    JAX ``host-sync-in-jit``)."""
    findings: list[Finding] = []
    for fn, taint, known in _regions(module, project):
        for node in _own_nodes(fn, False, module):
            if not isinstance(node, ast.Call):
                continue
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in HOST_SYNC_METHODS
            ):
                findings.append(Finding(
                    "host-sync-in-capture", module.path, node.lineno,
                    node.col_offset,
                    f".{node.func.attr}() inside a captured function "
                    "synchronizes with the host: it raises under capture "
                    "on the card and runs unseen on the CPU path; keep the "
                    "value on the device and read it after the dispatch",
                ))
                continue
            qual = module.qualname(node.func)
            if qual in HOST_SYNC_CALLS:
                findings.append(Finding(
                    "host-sync-in-capture", module.path, node.lineno,
                    node.col_offset,
                    f"{qual}() inside a captured function materializes "
                    "device values on the host: it raises under capture on "
                    "the card and runs unseen on the CPU path; use torch "
                    "operations on the device",
                ))
                continue
            if (
                isinstance(node.func, ast.Name)
                and node.func.id in ("int", "float", "bool")
                and node.args
                and not isinstance(node.args[0], ast.Constant)
                and {n for n in _names_in(node.args[0], known) & taint
                     if not _not_a_tensor_here(module, node, n)}
            ):
                findings.append(Finding(
                    "host-sync-in-capture", module.path, node.lineno,
                    node.col_offset,
                    f"{node.func.id}() on a possibly-tensor value reads it "
                    "on the host: it raises under capture on the card and "
                    "runs unseen on the CPU path; keep it a tensor "
                    "(.to(dtype), torch.where)",
                ))
    return findings


@rule("tensor-branch")
def tensor_branch(module: Module, project: Project) -> list[Finding]:
    """Python ``if``/``while`` on a possibly-tensor value in a captured
    function: it syncs (and raises under capture), or bakes the branch
    taken at capture into the graph (the counterpart of the JAX
    ``tracer-branch``)."""
    findings: list[Finding] = []
    for fn, taint, known in _regions(module, project):
        if isinstance(fn, ast.Lambda):
            continue
        for node in _own_nodes(fn, False, module):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            uses = [
                n for n in ast.walk(node.test)
                if isinstance(n, ast.Name)
                and isinstance(n.ctx, ast.Load)
                and n.id in taint
            ]
            live = [n for n in uses
                    if not _excluded_use(module, n, node.test, known)
                    and not _not_a_tensor_here(module, node, n.id)]
            if live:
                kind = "if" if isinstance(node, ast.If) else "while"
                names = ", ".join(sorted({n.id for n in live}))
                findings.append(Finding(
                    "tensor-branch", module.path, node.lineno, node.col_offset,
                    f"Python `{kind}` on possibly-tensor value(s) {names} "
                    "inside a captured function: it syncs under capture, or "
                    "bakes one branch into the graph; use torch.where or a "
                    "graph node",
                ))
    return findings


# -- program-key-hygiene -----------------------------------------------------


def _loaded(node: ast.AST | None) -> set[str]:
    if node is None:
        return set()
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def _params(fn: ast.AST) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return names


def _key_reads(idx: _Index, info: _ModInfo, key: ast.AST) -> set[str]:
    """The names the key expression reads. The arguments of a call in it
    that resolves to a function of the project count only where that
    function reads the parameter they bind (one level)."""
    reads: set[str] = set()
    calls = [n for n in ast.walk(key) if isinstance(n, ast.Call)]
    inside_resolved: set[ast.AST] = set()
    for call in calls:
        if call in inside_resolved:
            continue
        targets = idx.callees(info, call, {})
        defs = [t for _, t in targets if isinstance(t, _DEFS)]
        if len(defs) != 1:
            continue
        callee = defs[0]
        body_reads = set()
        for stmt in callee.body:
            body_reads |= _loaded(stmt)
        pos = [a.arg for a in callee.args.posonlyargs + callee.args.args]
        for i, arg in enumerate(call.args):
            if i < len(pos) and pos[i] in body_reads:
                reads |= _key_reads(idx, info, arg)
            inside_resolved.update(ast.walk(arg))
        for kw in call.keywords:
            if kw.arg is None or kw.arg in body_reads:
                reads |= _key_reads(idx, info, kw.value)
            inside_resolved.update(ast.walk(kw.value))
        inside_resolved.add(call)
        inside_resolved.update(ast.walk(call.func))
    for n in ast.walk(key):
        if n in inside_resolved:
            continue
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
            reads.add(n.id)
    return reads


def _build_reads(info: _ModInfo, call: ast.Call, build: ast.AST) -> set[str]:
    if isinstance(build, ast.Lambda):
        return _loaded(build.body) | {
            n for d in build.args.defaults for n in _loaded(d)}
    if isinstance(build, ast.Name):
        target = info.scopes.resolve(call, build.id)
        if target is not None and isinstance(target, _DEFS):
            own = set(_params(target))
            return {n for s in target.body for n in _loaded(s)} - own
    return _loaded(build)


@rule("program-key-hygiene")
def program_key_hygiene(module: Module, project: Project) -> list[Finding]:
    """A ``take_cached(owner, attr, key, build)`` whose ``build`` reads a
    parameter of the enclosing function that its ``key`` leaves out: the
    program cache would hand a program built for one value of it to a
    search that asks for another, with graphs captured for the first (the
    counterpart of the JAX ``static-arg-hygiene``, whose jit cache keys on
    the static arguments). The ``owner`` argument, whose attribute holds
    the cache, is exempt."""
    idx = project.fact("capture-index", _Index)
    info = idx.by_module[module]
    findings: list[Finding] = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        qual = module.qualname(node.func)
        if qual is None or qual.split(".")[-1] != "take_cached":
            continue
        args = list(node.args)
        kw = {k.arg: k.value for k in node.keywords if k.arg}
        names = ("problem", "attr", "key", "build")
        for i, n in enumerate(names):
            if i < len(args):
                kw.setdefault(n, args[i])
        if "key" not in kw or "build" not in kw:
            continue
        fn = module.enclosing_function(node)
        if fn is None or isinstance(fn, ast.Lambda):
            continue
        params = set(_params(fn)) - {"self", "cls"}
        exempt = _loaded(kw.get("problem"))
        missing = ((_build_reads(info, node, kw["build"]) & params)
                   - _key_reads(idx, info, kw["key"]) - exempt)
        attr = kw.get("attr")
        cache = (attr.value if isinstance(attr, ast.Constant) else
                 ast.unparse(attr) if attr is not None else "?")
        for p in sorted(missing):
            findings.append(Finding(
                "program-key-hygiene", module.path, node.lineno,
                node.col_offset,
                f"the program cache '{cache}' would serve a graph built for "
                f"another '{p}': its build reads parameter '{p}' of "
                f"'{getattr(fn, 'name', '<lambda>')}', which its key leaves "
                "out; add it to the key",
            ))
    return findings


# -- what a capture really enters ------------------------------------------


class EnteredFunctions:
    """Records ``(path, co_name, co_firstlineno)`` of every function under
    the directory ``root`` that starts or resumes while ``when()`` is true,
    on any thread, for the block: the functions a capture enters when
    ``when`` is ``torch.cuda.is_current_stream_capturing`` (the caller
    passes it: this module imports no torch). It reads only the frame's
    code object, never a tensor.

    With ``sys.monitoring`` (Python 3.12) one callback a code location,
    disabled once the location lies outside ``root`` or is recorded, so
    the block runs at full speed; else ``sys.setprofile`` and
    ``threading.setprofile`` (threads started in the block)."""

    def __init__(self, root: str, when=lambda: True):
        self.root = os.path.abspath(root) + os.sep
        self.when = when
        self.seen: set[tuple[str, str, int]] = set()
        self._tool = None

    def _record(self, code) -> bool:
        """Whether ``code`` needs no more looking at."""
        if not code.co_filename.startswith(self.root):
            return True
        if not self.when():
            return False
        self.seen.add((code.co_filename, code.co_name, code.co_firstlineno))
        return True

    def __enter__(self) -> "EnteredFunctions":
        import sys
        import threading

        mon = getattr(sys, "monitoring", None)
        if mon is not None:
            tool = next((t for t in range(6) if mon.get_tool(t) is None),
                        None)
            if tool is not None:
                mon.use_tool_id(tool, "tts-capture-probe")
                ev = mon.events

                def started(code, _offset):
                    return mon.DISABLE if self._record(code) else None

                mon.register_callback(tool, ev.PY_START, started)
                mon.register_callback(tool, ev.PY_RESUME, started)
                mon.restart_events()  # what an earlier probe disabled
                mon.set_events(tool, ev.PY_START | ev.PY_RESUME)
                self._tool = tool
                return self

        def profile(frame, event, _arg):
            if event == "call":
                self._record(frame.f_code)

        self._prev = (sys.getprofile(), threading.getprofile())
        threading.setprofile(profile)
        sys.setprofile(profile)
        return self

    def __exit__(self, *exc) -> None:
        import sys
        import threading

        if self._tool is not None:
            mon = sys.monitoring
            mon.set_events(self._tool, 0)
            mon.register_callback(self._tool, mon.events.PY_START, None)
            mon.register_callback(self._tool, mon.events.PY_RESUME, None)
            mon.free_tool_id(self._tool)
            self._tool = None
            return
        sys.setprofile(self._prev[0])
        threading.setprofile(self._prev[1])

    def missing(self, captured: set[tuple[str, str, int]]) -> list:
        """The recorded functions that ``captured`` (``captured_keys``)
        lacks, paths made absolute on both sides."""
        have = {(os.path.abspath(p), n, line) for p, n, line in captured}
        return sorted(k for k in self.seen if k not in have)
