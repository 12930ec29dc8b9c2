"""``lock-order``: a static lock-*acquisition-order* audit for the
host-thread runtime (the deepening of ``locks.py``'s per-access checking;
a copy of the JAX package's ``analysis/lockorder.py``).

``guarded-by`` proves each shared access holds *its* lock; it says nothing
about holding two locks at once.  The work-stealing tiers routinely touch
two pools (thief + victim), the dist tier nests pool locks under the KV
condition, and the checkpoint gate parks every worker — so the deadlock
question is about the *graph*: which lock can be **blocking-acquired while
another is held**.  This module builds that graph statically:

* **Nodes** are class-level locks ``ClassName.attr`` — every
  ``self.attr = threading.Lock()/RLock()/Condition()`` assignment, plus
  every lock named by a ``guarded-by``/``requires-lock`` annotation.
* **Edges** ``H -> A`` mean "somewhere, lock ``A`` is acquired while
  ``H`` is held": lexical nesting of ``with B.lock:`` /
  ``if B.try_lock():`` scopes (the same scope tracking as ``guarded-by``,
  with the base expression resolved to a class by the shared shallow type
  inference), direct ``B.lock.acquire()`` calls, and one level of call
  propagation — calling a method whose body blocking-acquires its own
  class's locks (``locked_*`` wrappers, ``kv_set``/``kv_get``…) while a
  lock is held adds the corresponding edges.
* Each edge records whether the *acquisition* blocks: ``try_lock()`` and
  ``acquire(blocking=False)`` edges are non-blocking — they can fail but
  never wait, so they cannot close a deadlock cycle.

Findings:

* ``lock-order`` — a cycle among **blocking** edges: two threads taking
  the cycle's locks in different orders can deadlock.  Reported once per
  cycle, at the edge that closes it.
* ``lock-order-same-class`` — a *blocking* acquisition of a lock of class
  ``C`` while a ``C`` lock is already held.  The class-level graph cannot
  order two instances of the same lock, so the only statically safe
  discipline is the one the steal paths follow: the second same-class
  lock must be ``try_lock`` (this is exactly what the repo's "advisory
  racy read" waivers implicitly assume — victim pools are probed with
  ``try_lock`` and released before the thief's own pool is locked).

Like ``guarded-by``, the analysis under-approximates: unresolvable bases
add no nodes and no edges, so a finding is always worth reading, and a
clean report means "no cycle among the locks the analysis can see" —
``threading.Barrier``/``Condition.wait`` rendezvous are out of scope
(out of the analysis's reach).
"""

from __future__ import annotations

import ast
import dataclasses

from .core import Finding, Module, Project, rule
from .locks import (
    FunctionNode,
    _collect,
    _expr_type,
    _function_env,
    _own_nodes,
    _owning_class,
)

_LOCK_CTORS = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Semaphore", "threading.BoundedSemaphore",
}


@dataclasses.dataclass(frozen=True)
class Edge:
    """``A`` acquired at (path, line) while ``held`` was held."""

    held: str
    acquired: str
    path: str
    line: int
    blocking: bool


@dataclasses.dataclass
class LockGraph:
    nodes: set[str]
    edges: list[Edge]

    def blocking_edges(self) -> list[Edge]:
        return [e for e in self.edges if e.blocking]

    def cycles(self) -> list[list[Edge]]:
        """Elementary cycles among blocking edges (DFS over the small class
        graph; deduplicated by node set)."""
        adj: dict[str, list[Edge]] = {}
        for e in self.blocking_edges():
            adj.setdefault(e.held, []).append(e)
        seen_sets: set[frozenset] = set()
        out: list[list[Edge]] = []

        def walk(node: str, path_edges: list[Edge], on_path: list[str]):
            for e in adj.get(node, ()):
                if e.acquired in on_path:
                    cyc = path_edges[on_path.index(e.acquired):] + [e]
                    key = frozenset(x.acquired for x in cyc)
                    if key not in seen_sets:
                        seen_sets.add(key)
                        out.append(cyc)
                    continue
                walk(e.acquired, path_edges + [e], on_path + [e.acquired])

        for start in sorted(adj):
            walk(start, [], [start])
        return out


# -- lock-node discovery ---------------------------------------------------


def _lock_nodes(project: Project) -> dict[str, set[str]]:
    """class name -> its lock attribute names.  Sources: ``threading.*``
    constructor assignments to ``self.<attr>`` anywhere in the class, plus
    the lock names referenced by guarded-by/requires-lock annotations."""

    def build(_):
        classes = _collect(project)
        locks: dict[str, set[str]] = {}
        for cname, info in classes.items():
            names = set(info.fields.values()) | set(info.methods.values())
            if names:
                locks.setdefault(cname, set()).update(names)
        for mod in project.modules:
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                for sub in ast.walk(node):
                    if not (isinstance(sub, ast.Assign)
                            and isinstance(sub.value, ast.Call)):
                        continue
                    q = mod.qualname(sub.value.func)
                    if q not in _LOCK_CTORS:
                        continue
                    for t in sub.targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                            and _owning_class(mod, sub) is node
                        ):
                            locks.setdefault(node.name, set()).add(t.attr)
        return locks

    return project.fact("lock-order:nodes", build)


# -- acquisition extraction ------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Acq:
    node: str       # "ClassName.attr"
    line: int
    col: int
    blocking: bool


def _resolve_lock(mod: Module, expr: ast.AST, env, classes, locks
                  ) -> str | None:
    """``B.attr`` -> "T.attr" when B's inferred type T declares lock attr
    ``attr``; None otherwise."""
    if not isinstance(expr, ast.Attribute):
        return None
    base_ty = _expr_type(mod, expr.value, env, classes)
    if base_ty is None or expr.attr not in locks.get(base_ty, ()):
        return None
    return f"{base_ty}.{expr.attr}"


def _try_lock_node(mod: Module, call: ast.Call, env, classes, locks
                   ) -> str | None:
    """``B.try_lock()`` -> B's class lock node (the conventional ``lock``
    attribute, else the class's single declared lock)."""
    f = call.func
    if not (isinstance(f, ast.Attribute) and f.attr == "try_lock"):
        return None
    base_ty = _expr_type(mod, f.value, env, classes)
    if base_ty is None:
        return None
    names = locks.get(base_ty, set())
    if "lock" in names:
        return f"{base_ty}.lock"
    if len(names) == 1:
        return f"{base_ty}.{next(iter(names))}"
    return None


def _direct_acquisitions(mod: Module, fn, env, classes, locks) -> list[_Acq]:
    """Blocking/non-blocking lock acquisitions lexically inside ``fn``
    (not descending into nested defs)."""
    out: list[_Acq] = []
    for node in _own_nodes(fn):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                lk = _resolve_lock(mod, item.context_expr, env, classes, locks)
                if lk is not None:
                    out.append(_Acq(lk, node.lineno, node.col_offset, True))
        elif isinstance(node, ast.Call):
            lk = _try_lock_node(mod, node, env, classes, locks)
            if lk is not None:
                out.append(_Acq(lk, node.lineno, node.col_offset, False))
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "acquire":
                lk = _resolve_lock(mod, f.value, env, classes, locks)
                if lk is not None:
                    blocking = True
                    for kw in node.keywords:
                        if kw.arg == "blocking" and isinstance(
                            kw.value, ast.Constant
                        ) and kw.value.value is False:
                            blocking = False
                    if node.args and isinstance(node.args[0], ast.Constant) \
                            and node.args[0].value is False:
                        blocking = False
                    out.append(_Acq(lk, node.lineno, node.col_offset, blocking))
    return out


def _method_summaries(project: Project) -> dict[tuple[str, str], set[str]]:
    """(class, method) -> lock nodes the method body blocking-acquires
    directly (one level of call propagation for ``locked_*``-style
    wrappers)."""

    def build(_):
        classes = _collect(project)
        locks = _lock_nodes(project)
        summaries: dict[tuple[str, str], set[str]] = {}
        for mod in project.modules:
            env_memo: dict = {}
            for fn in ast.walk(mod.tree):
                if not isinstance(fn, FunctionNode):
                    continue
                owner = _owning_class(mod, fn)
                if owner is None:
                    continue
                env = _function_env(mod, fn, classes, env_memo)
                acqs = _direct_acquisitions(mod, fn, env, classes, locks)
                blocking = {a.node for a in acqs if a.blocking}
                if blocking:
                    summaries[(owner.name, fn.name)] = blocking
        return summaries

    return project.fact("lock-order:summaries", build)


def _released_before(if_node: ast.If, base: ast.AST, line: int) -> bool:
    """True when the ``if B.try_lock():`` body explicitly releases ``B``
    (``B.unlock()`` / ``B.lock.release()``) at a line before ``line`` —
    the try/finally release-then-continue idiom of the steal paths.  A
    lexical under-approximation: a release the walk can't match keeps the
    lock conservatively held."""
    try:
        base_txt = ast.unparse(base)
    except Exception:
        return False
    for sub in ast.walk(if_node):
        if not (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)):
            continue
        if sub.lineno >= line:
            continue
        f = sub.func
        try:
            if f.attr == "unlock" and ast.unparse(f.value) == base_txt:
                return True
            if (f.attr == "release" and isinstance(f.value, ast.Attribute)
                    and ast.unparse(f.value.value) == base_txt):
                return True
        except Exception:
            continue
    return False


def _held_lock_nodes(mod: Module, node: ast.AST, env, classes, locks
                     ) -> set[str]:
    """Typed version of ``locks._held_locks``: the set of lock *nodes*
    (``T.attr``) held at ``node`` via enclosing ``with``/``try_lock``
    scopes (held is held, however it was acquired — but an explicit
    ``unlock()`` earlier in a try_lock body ends the hold)."""
    held: set[str] = set()
    at_line = getattr(node, "lineno", 0)
    cur: ast.AST | None = node
    while cur is not None:
        parent = mod.parent.get(cur)
        if parent is None:
            break
        if isinstance(parent, (ast.With, ast.AsyncWith)) and cur in parent.body:
            for item in parent.items:
                lk = _resolve_lock(mod, item.context_expr, env, classes, locks)
                if lk is not None:
                    held.add(lk)
        if isinstance(parent, ast.If) and cur in parent.body:
            test = parent.test
            if isinstance(test, ast.Call):
                lk = _try_lock_node(mod, test, env, classes, locks)
                if lk is not None and not _released_before(
                    parent, test.func.value, at_line
                ):
                    held.add(lk)
        if isinstance(parent, FunctionNode) or isinstance(parent, ast.Lambda):
            break
        cur = parent
    return held


def build_graph(project: Project) -> LockGraph:
    """The project-wide lock-acquisition graph (memoised project fact)."""

    def build(_):
        classes = _collect(project)
        locks = _lock_nodes(project)
        summaries = _method_summaries(project)
        nodes = {f"{c}.{a}" for c, attrs in locks.items() for a in attrs}
        edges: list[Edge] = []
        for mod in project.modules:
            env_memo: dict = {}
            for fn in ast.walk(mod.tree):
                if not isinstance(fn, FunctionNode):
                    continue
                env = _function_env(mod, fn, classes, env_memo)
                for node in _own_nodes(fn):
                    acqs: list[_Acq] = []
                    if isinstance(node, (ast.With, ast.AsyncWith)):
                        for item in node.items:
                            lk = _resolve_lock(
                                mod, item.context_expr, env, classes, locks
                            )
                            if lk is not None:
                                acqs.append(_Acq(
                                    lk, node.lineno, node.col_offset, True
                                ))
                    elif isinstance(node, ast.Call):
                        lk = _try_lock_node(mod, node, env, classes, locks)
                        if lk is not None:
                            acqs.append(_Acq(
                                lk, node.lineno, node.col_offset, False
                            ))
                        else:
                            f = node.func
                            if isinstance(f, ast.Attribute):
                                if f.attr == "acquire":
                                    lk = _resolve_lock(
                                        mod, f.value, env, classes, locks
                                    )
                                    if lk is not None:
                                        acqs.append(_Acq(
                                            lk, node.lineno,
                                            node.col_offset, True
                                        ))
                                else:
                                    # one-level call propagation
                                    base_ty = _expr_type(
                                        mod, f.value, env, classes
                                    )
                                    for target in summaries.get(
                                        (base_ty, f.attr), ()
                                    ) if base_ty else ():
                                        acqs.append(_Acq(
                                            target, node.lineno,
                                            node.col_offset, True
                                        ))
                    if not acqs:
                        continue
                    held = _held_lock_nodes(mod, node, env, classes, locks)
                    for acq in acqs:
                        for h in held:
                            if h == acq.node and not acq.blocking:
                                # try_lock of a same-class sibling while
                                # holding one: the sanctioned discipline.
                                continue
                            edges.append(Edge(
                                h, acq.node, mod.path, acq.line, acq.blocking
                            ))
        return LockGraph(nodes=nodes, edges=edges)

    return project.fact("lock-order:graph", build)


# -- the rule --------------------------------------------------------------


@rule("lock-order")
def lock_order(module: Module, project: Project) -> list[Finding]:
    graph = build_graph(project)
    findings: list[Finding] = []
    # Same-class blocking re-acquisition: instance order is invisible to a
    # class-level graph, so the second one must be try_lock.
    for e in graph.edges:
        if e.path != module.path or not e.blocking:
            continue
        if e.held == e.acquired:
            findings.append(Finding(
                "lock-order", module.path, e.line, 0,
                f"blocking acquisition of {e.acquired} while an instance "
                f"of {e.held} is already held — two instances of one lock "
                "class have no static order; probe the second with "
                "try_lock() (the steal-path discipline) or release first",
            ))
    # Cycles among blocking edges: report at the closing edge, in the
    # module that contains it (once per cycle).
    for cyc in graph.cycles():
        closing = cyc[-1]
        if closing.path != module.path or closing.held == closing.acquired:
            continue
        chain = " -> ".join([e.held for e in cyc] + [cyc[-1].acquired])
        findings.append(Finding(
            "lock-order", module.path, closing.line, 0,
            f"lock-acquisition cycle (deadlock potential): {chain}; "
            "break the cycle by ordering the acquisitions or probing "
            "with try_lock()",
        ))
    return findings
