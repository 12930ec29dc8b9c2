"""Pass framework of the port's ``lint``: parsed-module model + rule registry
(a copy of the JAX package's ``analysis/core.py``).

The port's host-thread runtime (the multi and dist workers, the serve
daemon, the fleet router, the kernel build) is lock-based, and no generic
linter sees its ``guarded-by`` notes. Each rule is a function over a parsed
``Module`` (AST + comments + import aliases) registered under a stable
name; ``lint`` parses every file once, runs all rules, then filters
findings through inline waivers (baseline ratcheting lives in
``baseline.py``). The rules are ``guarded-by`` (``locks.py``),
``lock-order`` (``lockorder.py``) and the capture rules
``host-sync-in-capture``, ``tensor-branch`` and ``program-key-hygiene``
(``torch_rules.py``).

Rules see a ``Project`` so cross-file facts (e.g. ``guarded-by`` annotations
declared in ``pool/pool.py`` but enforced in ``parallel/dist.py``) are
collected once and shared.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import tokenize
from typing import Callable, Iterable

#: Inline-waiver / marker comment prefix.
PRAGMA = "tts-lint:"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, pinned to ``file:line:col``."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"

    @property
    def cell(self) -> str:
        """Baseline-ratchet key: findings are counted per (rule, file) so the
        committed baseline survives line drift from unrelated edits."""
        return f"{self.rule}:{self.path}"


class Module:
    """One parsed source file: AST with parent links, comments by line,
    and resolved import aliases — shared by every rule."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.tree = ast.parse(text, filename=path)
        self.comments: dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(io.StringIO(text).readline):
                if tok.type == tokenize.COMMENT:
                    self.comments[tok.start[0]] = tok.string
        except tokenize.TokenError:
            pass  # partial comment map is still useful
        # Parent links let rules walk lexically outward (lock scopes,
        # enclosing-function lookup) without re-walking the tree.
        self.parent: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node
        # Import aliases: local name -> dotted module/object path, so rules
        # can resolve ``np.asarray`` -> ``numpy.asarray`` regardless of the
        # import spelling.
        self.aliases: dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.aliases[a.asname or a.name] = f"{node.module}.{a.name}"

    # -- helpers shared by rules ------------------------------------------

    def qualname(self, node: ast.AST) -> str | None:
        """Dotted name of a Name/Attribute chain with the import alias
        expanded (``np.asarray`` -> ``numpy.asarray``); None for anything
        that is not a plain dotted chain."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.aliases.get(node.id, node.id)
        parts.append(root)
        return ".".join(reversed(parts))

    def enclosing_function(self, node: ast.AST) -> ast.AST | None:
        cur = self.parent.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return cur
            cur = self.parent.get(cur)
        return None

    def enclosing_class(self, node: ast.AST) -> ast.ClassDef | None:
        cur = self.parent.get(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a class defined inside a function still owns its methods,
                # but a function boundary between node and class means node
                # is in a method body — keep climbing to find the class.
                pass
            cur = self.parent.get(cur)
        return None


class Project:
    """All modules of one lint run (cross-file annotation visibility)."""

    def __init__(self, modules: list[Module]):
        self.modules = modules
        self._facts: dict[str, object] = {}

    def fact(self, key: str, build: Callable[["Project"], object]):
        """Memoised project-wide analysis product (e.g. the guarded-by
        annotation table) so N rules x M files don't recompute it."""
        if key not in self._facts:
            self._facts[key] = build(self)
        return self._facts[key]


#: name -> rule function ``(Module, Project) -> list[Finding]``.
RULES: dict[str, Callable[[Module, Project], list[Finding]]] = {}


def rule(name: str):
    def deco(fn):
        RULES[name] = fn
        return fn

    return deco


def _normalize(path: str) -> str:
    """Repo-relative path when under the cwd (stable baseline keys whether
    the caller passed absolute or relative targets); absolute otherwise."""
    ap = os.path.abspath(path)
    cwd = os.getcwd()
    if ap == cwd or ap.startswith(cwd + os.sep):
        return os.path.relpath(ap, cwd)
    return ap


def iter_py_files(paths: Iterable[str]) -> list[str]:
    out: list[str] = []
    paths = [_normalize(p) for p in paths]
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = [
                    d for d in dirs
                    if not d.startswith(".") and d != "__pycache__"
                ]
                out.extend(
                    os.path.join(root, f) for f in files if f.endswith(".py")
                )
        elif p.endswith(".py"):
            out.append(p)
    return sorted(set(out))


def parse_modules(paths: Iterable[str]) -> tuple[list[Module], list[Finding]]:
    """Parse every file; syntax errors become findings (rule ``parse``)
    instead of crashing the whole run."""
    modules: list[Module] = []
    errors: list[Finding] = []
    for path in iter_py_files(paths):
        try:
            with open(path, encoding="utf-8") as f:
                text = f.read()
            modules.append(Module(path, text))
        except SyntaxError as e:
            errors.append(
                Finding("parse", path, e.lineno or 1, e.offset or 0,
                        f"syntax error: {e.msg}")
            )
    return modules, errors


def run_rules(modules: list[Module],
              only: Iterable[str] | None = None) -> list[Finding]:
    # Import for registration side effects (kept out of module import time
    # so `analysis.guard` stays importable alone).
    from . import lockorder, locks, torch_rules  # noqa: F401

    project = Project(modules)
    selected = set(only) if only is not None else set(RULES)
    findings: list[Finding] = []
    for mod in modules:
        for name, fn in sorted(RULES.items()):
            if name in selected:
                findings.extend(fn(mod, project))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings
