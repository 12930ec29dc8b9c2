"""``guarded-by``: a lightweight static race detector for the host-thread
runtime (the lock-based work-stealing tiers in ``pool/``, ``parallel/``).

Annotations (comments — zero runtime cost, greppable):

* Field, trailing form::

      self._value = value  # guarded-by: _lock

* Field, class-body form (covers inherited fields)::

      class ParallelSoAPool(SoAPool):
          # guarded-by: lock -- front, size, capacity, data

* Method contract, class-body form — the method touches guarded state and
  documents "caller must hold the lock"; its *body* is exempt, its *call
  sites* are checked::

      # requires-lock: lock -- push_back_bulk, pop_back_bulk

Enforcement: every attribute access ``B.field`` / call ``B.method(...)``
whose base ``B`` is *inferred* to be an instance of an annotated class must
sit lexically inside ``with B.<lock>:`` or the taken branch of
``if B.try_lock():``. Inference is deliberately shallow and conservative —
parameter/return annotations, direct constructions, ``self`` in methods of
the annotated class, instance attributes typed in ``__init__``, and element
types of ``list[C]`` through indexing / iteration / ``min``/``max``.
Anything unresolvable is silently exempt: the rule under-approximates, so a
finding is always worth reading. Accesses in ``__init__`` of the declaring
class are exempt (the instance is not yet shared), as are accesses from a
method of the declaring class that the class itself documents with
``requires-lock`` (the contract moves the check to the call sites).
"""

from __future__ import annotations

import ast
import re

from .core import Finding, Module, Project, rule

_FIELD_TRAIL = re.compile(r"#\s*guarded-by:\s*(?P<lock>\w+)\s*(?:--.*)?$")
_FIELD_CLASS = re.compile(
    r"#\s*guarded-by:\s*(?P<lock>\w+)\s*--\s*(?P<fields>[\w, ]+)$"
)
_METHOD_CLASS = re.compile(
    r"#\s*requires-lock:\s*(?P<lock>\w+)\s*--\s*(?P<methods>[\w, ]+)$"
)

FunctionNode = (ast.FunctionDef, ast.AsyncFunctionDef)


class _ClassInfo:
    def __init__(self, name: str):
        self.name = name
        self.fields: dict[str, str] = {}  # field -> lock attr
        self.methods: dict[str, str] = {}  # method -> lock attr
        self.attr_types: dict[str, str] = {}  # instance attr -> class name


# -- annotation collection (project-wide) ----------------------------------


def _collect(project: Project) -> dict[str, _ClassInfo]:
    """Guarded classes by name. Class names are matched globally across the
    analyzed tree (unique-per-package assumption)."""

    def build(_):
        classes: dict[str, _ClassInfo] = {}

        def info(name: str) -> _ClassInfo:
            return classes.setdefault(name, _ClassInfo(name))

        for mod in project.modules:
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                for line in range(
                    node.lineno, (node.end_lineno or node.lineno) + 1
                ):
                    comment = mod.comments.get(line)
                    if not comment or _innermost_class_at(mod, line) is not node:
                        continue
                    m = _FIELD_CLASS.search(comment)
                    if m:
                        for f in m.group("fields").split(","):
                            if f.strip():
                                info(node.name).fields[f.strip()] = m.group("lock")
                    m = _METHOD_CLASS.search(comment)
                    if m:
                        for meth in m.group("methods").split(","):
                            if meth.strip():
                                info(node.name).methods[meth.strip()] = m.group("lock")
                for sub in ast.walk(node):
                    if not isinstance(sub, (ast.Assign, ast.AnnAssign)):
                        continue
                    comment = mod.comments.get(sub.lineno, "")
                    m = _FIELD_TRAIL.search(comment)
                    if not m or _FIELD_CLASS.search(comment):
                        continue
                    targets = (
                        sub.targets if isinstance(sub, ast.Assign) else [sub.target]
                    )
                    for t in targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                            and _owning_class(mod, sub) is node
                        ):
                            info(node.name).fields[t.attr] = m.group("lock")
        # instance-attribute types from __init__, for every class (so bases
        # like ``self.pools`` / ``self.gate`` resolve in method bodies)
        for mod in project.modules:
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                init = next(
                    (s for s in node.body
                     if isinstance(s, ast.FunctionDef) and s.name == "__init__"),
                    None,
                )
                if init is None:
                    continue
                env = _param_types(init)
                for sub in ast.walk(init):
                    if not isinstance(sub, ast.Assign):
                        continue
                    for t in sub.targets:
                        if not (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            continue
                        ty = _expr_type(mod, sub.value, env, classes)
                        if ty is not None:
                            info(node.name).attr_types[t.attr] = ty
        return classes

    return project.fact("guarded-by:classes", build)


def _module_index(mod: Module) -> tuple[list, dict]:
    """The module's class definitions and its functions outside any
    function by name (the first in walk order), built once a module: the
    lookups below ran a whole-tree walk a call."""
    idx = getattr(mod, "_lock_index", None)
    if idx is None:
        classes = []
        fns: dict[str, ast.FunctionDef] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                classes.append(node)
            elif (isinstance(node, ast.FunctionDef)
                  and mod.enclosing_function(node) is None):
                fns.setdefault(node.name, node)
        idx = mod._lock_index = (classes, fns)
    return idx


def _innermost_class_at(mod: Module, line: int) -> ast.ClassDef | None:
    best: ast.ClassDef | None = None
    for node in _module_index(mod)[0]:
        if node.lineno <= line <= (
            node.end_lineno or node.lineno
        ):
            if best is None or node.lineno > best.lineno:
                best = node
    return best


def _owning_class(mod: Module, node: ast.AST) -> ast.ClassDef | None:
    """The innermost class lexically containing ``node`` (methods and
    closures nested in methods both resolve to their class)."""
    cur = mod.parent.get(node)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur
        cur = mod.parent.get(cur)
    return None


# -- shallow type inference ------------------------------------------------


def _ann_type(ann: ast.AST | None) -> str | None:
    """``C`` / ``"C"`` / ``C | None`` / ``Optional[C]`` -> ``C``;
    ``list[C]`` / ``Sequence[C]`` / ``tuple[C, ...]`` -> ``list:C``."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        for side in (ann.left, ann.right):
            ty = _ann_type(side)
            if ty is not None and ty != "None":
                return ty
        return None
    if isinstance(ann, ast.Subscript):
        base = ann.value
        base_name = base.attr if isinstance(base, ast.Attribute) else (
            base.id if isinstance(base, ast.Name) else None
        )
        if base_name in ("list", "List", "Sequence", "Iterable", "tuple", "Tuple"):
            elt = ann.slice
            if isinstance(elt, ast.Tuple) and elt.elts:
                elt = elt.elts[0]
            inner = _ann_type(elt)
            return f"list:{inner}" if inner else None
        if base_name == "Optional":
            return _ann_type(ann.slice)
    return None


def _param_types(fn: ast.AST) -> dict[str, str]:
    if isinstance(fn, ast.Lambda):
        return {}
    out: dict[str, str] = {}
    for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs:
        ty = _ann_type(a.annotation)
        if ty is not None:
            out[a.arg] = ty
    return out


def _expr_type(
    mod: Module, expr: ast.AST, env: dict[str, str],
    classes: dict[str, _ClassInfo],
) -> str | None:
    if isinstance(expr, ast.Name):
        return env.get(expr.id)
    if isinstance(expr, ast.Subscript):
        base = _expr_type(mod, expr.value, env, classes)
        if base and base.startswith("list:"):
            return base.split(":", 1)[1]
        return None
    if isinstance(expr, ast.Attribute):
        base = _expr_type(mod, expr.value, env, classes)
        if base in classes:
            return classes[base].attr_types.get(expr.attr)
        return None
    if isinstance(expr, ast.Call):
        fname = expr.func.id if isinstance(expr.func, ast.Name) else None
        if fname is None:
            return None
        if fname in classes:
            return fname  # direct construction
        if fname in ("min", "max", "next") and expr.args:
            base = _expr_type(mod, expr.args[0], env, classes)
            if base and base.startswith("list:"):
                return base.split(":", 1)[1]
            return None
        node = _module_index(mod)[1].get(fname)  # local fn's annotation
        if node is not None:
            return _ann_type(node.returns)
    return None


def _function_env(
    mod: Module, fn: ast.AST, classes: dict[str, _ClassInfo],
    memo: dict[ast.AST, dict[str, str]],
) -> dict[str, str]:
    """Flow-insensitive name->type environment for ``fn``, including its
    lexical ancestors' bindings (closures see outer locals)."""
    if fn in memo:
        return memo[fn]
    outer = mod.enclosing_function(fn)
    env = dict(
        _function_env(mod, outer, classes, memo)
    ) if outer is not None else {}
    env.update(_param_types(fn))
    owner = _owning_class(mod, fn)
    if owner is not None and not isinstance(fn, ast.Lambda):
        env.setdefault("self", owner.name)
    if not isinstance(fn, ast.Lambda):
        for _ in range(4):  # small fixpoint for chained assignments
            changed = False
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    ty = _expr_type(mod, node.value, env, classes)
                    if ty is None:
                        continue
                    for t in node.targets:
                        if isinstance(t, ast.Name) and env.get(t.id) != ty:
                            env[t.id] = ty
                            changed = True
                elif isinstance(node, ast.AnnAssign):
                    ty = _ann_type(node.annotation)
                    if ty and isinstance(node.target, ast.Name):
                        if env.get(node.target.id) != ty:
                            env[node.target.id] = ty
                            changed = True
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    ity = _expr_type(mod, node.iter, env, classes)
                    if (
                        ity and ity.startswith("list:")
                        and isinstance(node.target, ast.Name)
                    ):
                        elt = ity.split(":", 1)[1]
                        if env.get(node.target.id) != elt:
                            env[node.target.id] = elt
                            changed = True
                elif isinstance(node, ast.comprehension):
                    ity = _expr_type(mod, node.iter, env, classes)
                    if (
                        ity and ity.startswith("list:")
                        and isinstance(node.target, ast.Name)
                    ):
                        elt = ity.split(":", 1)[1]
                        if env.get(node.target.id) != elt:
                            env[node.target.id] = elt
                            changed = True
            if not changed:
                break
    memo[fn] = env
    return env


# -- lock-scope tracking ---------------------------------------------------


def _held_locks(mod: Module, node: ast.AST) -> set[str]:
    """Lock expressions (unparse strings) held at ``node``: enclosing
    ``with B.lock:`` items and the taken branch of ``if B.try_lock():``.
    Lock scopes do not cross function boundaries."""
    held: set[str] = set()
    cur: ast.AST | None = node
    while cur is not None:
        parent = mod.parent.get(cur)
        if parent is None:
            break
        if isinstance(parent, (ast.With, ast.AsyncWith)) and cur in parent.body:
            for item in parent.items:
                try:
                    held.add(ast.unparse(item.context_expr))
                except Exception:
                    pass
        if isinstance(parent, ast.If) and cur in parent.body:
            test = parent.test
            if (
                isinstance(test, ast.Call)
                and isinstance(test.func, ast.Attribute)
                and test.func.attr == "try_lock"
            ):
                try:
                    held.add(f"{ast.unparse(test.func.value)}.__try_lock__")
                except Exception:
                    pass
        if isinstance(parent, (*FunctionNode, ast.Lambda)):
            break
        cur = parent
    return held


def _lock_satisfied(base_txt: str, lock: str, held: set[str]) -> bool:
    return f"{base_txt}.{lock}" in held or f"{base_txt}.__try_lock__" in held


def _own_nodes(fn: ast.AST):
    """Walk a function body without descending into nested functions (each
    function is checked exactly once, under its own environment)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (*FunctionNode, ast.Lambda)):
                continue
            stack.append(child)


@rule("guarded-by")
def guarded_by(module: Module, project: Project) -> list[Finding]:
    classes = _collect(project)
    guarded = {c for c, info in classes.items() if info.fields or info.methods}
    if not guarded:
        return []
    findings: list[Finding] = []
    env_memo: dict[ast.AST, dict[str, str]] = {}
    for fn in ast.walk(module.tree):
        if not isinstance(fn, FunctionNode):
            continue
        owner = _owning_class(module, fn)
        if owner is not None and owner.name in guarded:
            if fn.name == "__init__":
                continue  # instance not yet shared
            if fn.name in classes[owner.name].methods:
                continue  # requires-lock contract: checked at call sites
        env = _function_env(module, fn, classes, env_memo)
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Attribute):
                continue
            base_ty = _expr_type(module, node.value, env, classes)
            if base_ty not in guarded:
                continue
            info = classes[base_ty]
            parent = module.parent.get(node)
            is_call = isinstance(parent, ast.Call) and parent.func is node
            try:
                base_txt = ast.unparse(node.value)
            except Exception:
                continue
            if is_call and node.attr in info.methods:
                lock = info.methods[node.attr]
                if not _lock_satisfied(base_txt, lock, _held_locks(module, node)):
                    findings.append(Finding(
                        "guarded-by", module.path, node.lineno, node.col_offset,
                        f"call to {base_ty}.{node.attr}() (requires-lock: "
                        f"{lock}) outside `with {base_txt}.{lock}:` / "
                        f"`if {base_txt}.try_lock():`",
                    ))
            elif not is_call and node.attr in info.fields:
                lock = info.fields[node.attr]
                if not _lock_satisfied(base_txt, lock, _held_locks(module, node)):
                    kind = "write to" if isinstance(
                        node.ctx, (ast.Store, ast.Del)
                    ) else "read of"
                    findings.append(Finding(
                        "guarded-by", module.path, node.lineno, node.col_offset,
                        f"unlocked {kind} {base_ty}.{node.attr} (guarded-by: "
                        f"{lock}); hold `{base_txt}.{lock}` or waive with a "
                        "justification",
                    ))
    return findings
