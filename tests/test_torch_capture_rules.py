"""The port's capture rules (`tpu_tree_search_torch/analysis/torch_rules.py`:
host-sync-in-capture, tensor-branch, program-key-hygiene) held to the JAX
package's rules (`tpu_tree_search/analysis/jax_rules.py`: host-sync-in-jit,
tracer-branch, static-arg-hygiene).

  * on each twin of tests/data/lint_torch/ the port's findings, mapped
    through ``JAX_COUNTERPART``, equal the JAX lint's on its JAX fixture of
    tests/data/lint/, line for line; the good twin is clean;
  * the port's own cases: the ``self.`` closure, the cross-module closure,
    a ``MeshGraph`` list root, ``with torch.cuda.graph``, the finalizers,
    a key that misses
    a parameter (and one that its key function drops), the plain branch
    under ``is_cuda``, the ``uncaptured`` marker, the sharpenings (static
    annotations, a project function annotated ``-> bool``, ``isinstance``
    narrowing), a waiver honoured and a stale one;
  * the port lints clean with no baseline, and without torch importable;
  * coverage, the CPU twin of chip_smoke.py's capture_lint phase: every
    port function entered during one call of each cycle check's matrix
    captures (at check's small shapes, on the CPU) is in the captured set
    (``plain=True``: both branches of a device test).
"""

from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from tpu_tree_search.analysis import lint as jax_lint
from tpu_tree_search.analysis.core import RULES as JAX_RULES
from tpu_tree_search_torch.analysis import lint
from tpu_tree_search_torch.analysis.core import RULES, Project, parse_modules
from tpu_tree_search_torch.analysis.torch_rules import (
    JAX_COUNTERPART,
    EnteredFunctions,
    captured_functions,
    captured_keys,
)

REPO = Path(__file__).resolve().parent.parent
JAX_FIXTURES = REPO / "tests" / "data" / "lint"
TWINS = REPO / "tests" / "data" / "lint_torch"
PACKAGE = REPO / "tpu_tree_search_torch"
CAPTURE_RULES = sorted(JAX_COUNTERPART)


def _mapped(findings):
    return sorted((JAX_COUNTERPART.get(f.rule, f.rule), f.line)
                  for f in findings)


def _write(tmp_path, files: dict) -> list[str]:
    paths = []
    for name, text in files.items():
        p = tmp_path / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
        paths.append(str(p))
    return paths


def _findings(paths, rule=None):
    out = lint([str(p) for p in paths], rules=CAPTURE_RULES)["new"]
    return [(Path(f.path).name, f.rule, f.line) for f in out
            if rule is None or f.rule == rule]


def _captured_names(paths, plain=False):
    return {(Path(p).name, name) for p, name, _ in
            captured_keys([str(p) for p in paths], plain=plain)}


def test_the_rules_and_their_counterparts():
    assert set(JAX_COUNTERPART) <= set(RULES)
    assert set(JAX_COUNTERPART.values()) <= set(JAX_RULES)
    assert len(set(JAX_COUNTERPART.values())) == 3


@pytest.mark.parametrize("fixture", ["bad_host_sync.py", "bad_tracer_branch.py",
                                     "bad_static_args.py", "good_clean.py"])
def test_twin_findings_equal_jax(fixture):
    """The twin, line for line: each BAD line of the JAX fixture is a BAD
    line of the twin, flagged by the counterpart rule."""
    mine = lint([str(TWINS / fixture)], rules=CAPTURE_RULES)
    theirs = jax_lint([str(JAX_FIXTURES / fixture)],
                      rules=sorted(JAX_COUNTERPART.values()))
    for part in ("new", "waived", "baselined"):
        assert _mapped(mine[part]) == _mapped(theirs[part]), part
    if fixture.startswith("bad_"):
        assert mine["new"]


def test_good_twin_is_clean_under_every_rule():
    res = lint([str(TWINS / "good_clean.py")])
    assert res["new"] == [] and res["waived"] == []


def test_twin_directory_equals_jax():
    mine = lint([str(TWINS)], rules=CAPTURE_RULES)
    theirs = jax_lint([str(JAX_FIXTURES)],
                      rules=sorted(JAX_COUNTERPART.values()))
    assert sorted((Path(f.path).name, JAX_COUNTERPART[f.rule], f.line)
                  for f in mine["new"]) == sorted(
        (Path(f.path).name, f.rule, f.line) for f in theirs["new"])


def test_self_method_closure(tmp_path):
    paths = _write(tmp_path, {"prog.py": """
        from tpu_tree_search_torch.ops.dispatch import DispatchGraph


        class Program:
            def graph(self, st):
                return DispatchGraph(self.cycle, st, 1, 8, 64, 4)

            def cycle(self):
                self.pop(self.st)

            def pop(self, st):
                return st.item()  # reached through self.pop

            def host(self, st):
                return st.item()  # never captured
        """})
    assert _findings(paths) == [("prog.py", "host-sync-in-capture", 13)]
    assert ("prog.py", "host") not in _captured_names(paths)


def test_cross_module_closure(tmp_path):
    """A function imported by name, or called through its module, from
    another module of the linted project is captured with its caller."""
    paths = _write(tmp_path, {
        "pkg/__init__.py": "",
        "pkg/engine.py": """
            from tpu_tree_search_torch.ops.dispatch import DispatchGraph

            from . import helpers
            from .ops import compact


            def graph(st):
                return DispatchGraph(lambda: compact(st) + helpers.tail(st),
                                     st, 1, 8, 64, 4)
            """,
        "pkg/ops.py": """
            def compact(keep):
                if keep.sum() > 0:  # a branch on a tensor, two modules away
                    return keep
                return keep
            """,
        "pkg/helpers.py": """
            def tail(st):
                return st.tolist()
            """})
    assert sorted(_findings(paths)) == [("helpers.py", "host-sync-in-capture", 3),
                                        ("ops.py", "tensor-branch", 3)]


def test_mesh_graph_list_root_and_balance(tmp_path):
    paths = _write(tmp_path, {"mesh.py": """
        from tpu_tree_search_torch.ops.mesh import MeshGraph


        def shard_a():
            return 0


        def shard_b(st):
            return st


        class Mesh:
            def graph(self, st):
                return MeshGraph([shard_a, lambda: shard_b(st)], self.balance,
                                 st, 1, 8, 64, 4, 2)

            def balance(self, r: int):
                return r

            def upload(self):
                return 0
        """})
    names = _captured_names(paths)
    assert {("mesh.py", "shard_a"), ("mesh.py", "shard_b"),
            ("mesh.py", "balance"), ("mesh.py", "<lambda>")} <= names
    assert ("mesh.py", "upload") not in names
    assert ("mesh.py", "graph") not in names


def test_cuda_graph_with_block_root(tmp_path):
    paths = _write(tmp_path, {"g.py": """
        import torch


        def reads(t):
            return t.cpu()


        def capture(g, x):
            with torch.cuda.graph(g):
                y = x * 2
                reads(y)
            return y
        """})
    assert _findings(paths) == [("g.py", "host-sync-in-capture", 6)]


def test_finalizers_are_captured(tmp_path):
    """The collector may run a finalizer inside a capture: ``__del__`` and
    a ``weakref.finalize`` callback are roots."""
    paths = _write(tmp_path, {"fin.py": """
        import weakref


        def retire(key: int):
            return key


        class Handle:
            def __init__(self, t):
                self.t = t
                weakref.finalize(self, retire, 0)

            def __del__(self):
                self.t.item()
        """})
    assert _findings(paths) == [("fin.py", "host-sync-in-capture", 15)]
    names = _captured_names(paths)
    assert {("fin.py", "retire"), ("fin.py", "__del__")} <= names
    assert ("fin.py", "__init__") not in names


def test_plain_branch_under_is_cuda_is_not_captured(tmp_path):
    """A wrapper's device test: the plain branch (and what follows a card
    branch that returns) runs only on a CPU tensor, never under capture."""
    paths = _write(tmp_path, {"wrap.py": """
        from tpu_tree_search_torch.ops.dispatch import DispatchGraph


        def plain(x):
            return x.tolist()


        def cuda(x):
            return x


        def bounds(x):
            if x.is_cuda:
                return cuda(x)
            return plain(x)


        def other(x):
            if x.device.type != "cuda":
                x.item()
                return plain(x)
            return cuda(x)


        def routed(fast, slow, x):
            if x.is_cuda:
                return fast(x)
            return slow(x)


        g = DispatchGraph(lambda: bounds(t) + other(t) + routed(cuda, plain, t),
                          t, 1, 8, 64, 4)
        """})
    assert _findings(paths) == []
    card = _captured_names(paths)
    assert ("wrap.py", "cuda") in card and ("wrap.py", "plain") not in card
    assert ("wrap.py", "plain") in _captured_names(paths, plain=True)


def test_uncaptured_marker(tmp_path):
    paths = _write(tmp_path, {"cache.py": """
        import torch

        from tpu_tree_search_torch.ops.dispatch import DispatchGraph

        _TABLES = {}


        def build(key):
            torch.cuda.synchronize()
            return key


        def tables(key):
            got = _TABLES.get(key)
            # tts-lint: uncaptured (the program builds its tables before it captures)
            if got is None:
                got = _TABLES[key] = build(key)
            return got


        g = DispatchGraph(lambda: tables(0), t, 1, 8, 64, 4)
        """})
    assert _findings(paths) == []
    assert ("cache.py", "build") not in _captured_names(paths)
    # Without the marker the first-use build is captured, and flagged.
    text = Path(paths[0]).read_text().replace("uncaptured", "noted")
    Path(paths[0]).write_text(text)
    assert _findings(paths) == [("cache.py", "host-sync-in-capture", 10)]


def test_sharpened_static_values(tmp_path):
    """Not tensors: a parameter annotated ``torch.dtype``, ``torch.device``
    or a container; a call of a project function, or a property, annotated
    to return a static type; a name inside ``if not isinstance(x,
    torch.Tensor)``. A union that admits a tensor stays a tensor."""
    paths = _write(tmp_path, {"sharp.py": """
        import torch

        from tpu_tree_search_torch.ops.dispatch import DispatchGraph


        class Scratch:
            def fits(self, M: int) -> bool:
                return M > 0

            @property
            def width(self) -> int:
                return 4


        def launch(x, dtype: torch.dtype, entries: dict, scratch: Scratch,
                   count, mixed: int | torch.Tensor):
            if dtype not in entries:
                raise TypeError(dtype)
            if not scratch.fits(8) or scratch.width > 8:
                raise ValueError("scratch")
            if not isinstance(count, torch.Tensor):
                count = torch.tensor(int(count))
            if mixed > 0:  # BAD: may be a tensor
                return x
            return x + count


        g = DispatchGraph(lambda: launch(t, t.dtype, {}, s, 1, 2), t, 1, 8,
                          64, 4)
        """})
    assert _findings(paths) == [("sharp.py", "tensor-branch", 24)]


def test_key_function_followed_one_level(tmp_path):
    """A key built by a call counts the arguments of the parameters that
    function reads: one it drops is missing from the key."""
    paths = _write(tmp_path, {"keys.py": """
        from tpu_tree_search_torch.engine.resident import take_cached


        def program_key(M: int, K: int, mt: int):
            return (M, K)


        def build(*a):
            return a


        def make(problem, M: int, K: int, mt: int):
            return take_cached(problem, "_programs", program_key(M, K, mt),
                               lambda: build(problem, M, K, mt))
        """})
    res = lint(paths, rules=["program-key-hygiene"])["new"]
    assert [(f.line, "'mt'" in f.message, "'_programs'" in f.message)
            for f in res] == [(14, True, True)]


def test_waiver_honoured_and_stale(tmp_path):
    paths = _write(tmp_path, {"w.py": """
        from tpu_tree_search_torch.ops.dispatch import DispatchGraph


        def cycle(st):
            # tts-lint: waive host-sync-in-capture -- fixture: a read the test excuses
            a = st.item()
            b = st + 1  # tts-lint: waive tensor-branch -- stale: nothing fires here
            return a, b


        g = DispatchGraph(lambda: cycle(t), t, 1, 8, 64, 4)
        """})
    res = lint(paths)
    assert [(f.rule, f.line) for f in res["waived"]] == [
        ("host-sync-in-capture", 7)]
    stale = [f for f in res["new"] if f.rule == "waiver-stale"]
    assert [f.line for f in stale] == [8]
    assert "no longer fires" in stale[0].message


def test_port_lints_clean_under_the_capture_rules():
    """The package and chip_smoke.py: no new capture finding without a
    baseline, and the capture rules' waivers are the four this package
    carries, each with its reason."""
    res = lint([str(PACKAGE), str(REPO / "chip_smoke.py")],
               rules=CAPTURE_RULES)
    assert res["new"] == [], "\n".join(f.render() for f in res["new"])
    assert sorted((Path(f.path).name, f.rule) for f in res["waived"]) == [
        ("contracts.py", "tensor-branch"),
        ("pair_exchange.py", "host-sync-in-capture"),
        ("pair_exchange.py", "tensor-branch"),
        ("pair_exchange.py", "tensor-branch")]


def test_captured_set_of_the_port():
    """The roots the engine hands its graphs and the markers reach the
    cycles, the kernel wrappers and the compaction; the plain versions and
    the cache builds are left out on the card."""
    card = _captured_names([PACKAGE])
    for name in [("resident.py", "_unfused_cycle"), ("resident.py", "_fused_cycle"),
                 ("resident.py", "slot_cycle"), ("compaction.py", "compact_ids"),
                 ("compaction.py", "children_of"), ("cycle.py", "cycle_lb1_cuda"),
                 ("pfsp_device.py", "lb2_bounds_staged"),
                 ("lb2_self_kernel.py", "lb2_self_bounds_cuda"),
                 ("dispatch.py", "phase_mark_if"), ("mesh.py", "mesh_balance_cuda"),
                 ("resident_mesh.py", "balance"),
                 ("pair_exchange.py", "pair_exchange_cuda")]:
        assert name in card, name
    for name in [("pfsp_device.py", "lb1_chunk"), ("cycle.py", "cycle_lb1_plain"),
                 ("mesh.py", "mesh_balance_plain"),
                 ("pfsp_device.py", "tables_from_numpy"),
                 ("resident.py", "step"), ("resident.py", "enqueue")]:
        assert name not in card, name
    plain = _captured_names([PACKAGE], plain=True)
    assert ("pfsp_device.py", "lb1_chunk") in plain
    assert card <= plain


def test_capture_rules_without_torch():
    """The lint runs where torch cannot be imported: the rules are stdlib
    only, and the port lints clean there too."""
    code = textwrap.dedent(f"""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("torch", "jax"):
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        from tpu_tree_search_torch.analysis import lint
        res = lint([{str(PACKAGE)!r}], rules={CAPTURE_RULES!r})
        print(len(res["new"]), len(res["waived"]))
        """)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "4"]


# -- coverage: what the cycles really enter, on the CPU ---------------------

_CAPTURED_PLAIN = None


def _plain_set():
    global _CAPTURED_PLAIN
    if _CAPTURED_PLAIN is None:
        _CAPTURED_PLAIN = captured_keys([str(PACKAGE)], plain=True)
    return _CAPTURED_PLAIN


def _entered(call) -> set:
    """The port functions entered during ``call()`` (the probe's window)."""
    live = [False]
    with EnteredFunctions(str(PACKAGE), lambda: live[0]) as probe:
        live[0] = True
        try:
            call()
        finally:
            live[0] = False
    return probe


def _solo_cycle(family: str, fused: bool, mt=None, staged: bool = True):
    from tpu_tree_search_torch.analysis import program_audit as PA
    from tpu_tree_search_torch.engine import resident as R

    factory, p = PA.family_factory(family)
    problem = factory()
    batch, best = PA._frontier(problem, p["M"])
    prog = R.new_program(problem, p["m"], p["M"], p["K"],
                         PA._capacity(problem, p["M"]), "cpu", fused=fused,
                         staged=staged, mt=mt)
    return prog.slot_cycle(prog.own_state(batch, best))


def _batched_slot(family: str, fused: bool):
    from tpu_tree_search_torch.analysis import program_audit as PA
    from tpu_tree_search_torch.engine.batched import BatchedProgram

    factory, p = PA.family_factory(family)
    problem = factory()
    batch, best = PA._frontier(problem, p["M"])
    bp = BatchedProgram(problem, 2, p["m"], p["M"], p["K"],
                        PA._capacity(problem, p["M"]), "cpu", fused=fused)
    bp.make_slot(0, batch, best)
    bp.make_slot(1, batch, best)
    return bp.inner.slot_cycle(bp.states[1])


def _mesh_shard(family: str, fused: bool):
    from tpu_tree_search_torch.analysis import program_audit as PA
    from tpu_tree_search_torch.parallel.resident_mesh import MeshProgram

    factory, p = PA.family_factory(family)
    problem = factory()
    batch, best = PA._frontier(problem, 2 * p["M"])
    prog = MeshProgram(problem, 2, p["m"], p["M"], p["K"], 2, 2 * p["m"],
                       PA._capacity(problem, p["M"]), "cpu", fused=fused)
    prog.upload(batch, best)
    g = prog.groups[0]

    def shard_and_balance():
        g.cycles[1]()
        prog.balance(0)
    return shard_and_balance


COVERAGE = [
    ("nqueens-unfused", lambda: _solo_cycle("nqueens", False)),
    ("nqueens-fused", lambda: _solo_cycle("nqueens", True)),
    ("nqueens-mt16", lambda: _solo_cycle("nqueens", True, mt=16)),
    ("lb1-unfused", lambda: _solo_cycle("pfsp-lb1", False)),
    ("lb1-fused", lambda: _solo_cycle("pfsp-lb1", True)),
    ("lb1-mt16", lambda: _solo_cycle("pfsp-lb1", True, mt=16)),
    ("lb1d-unfused", lambda: _solo_cycle("pfsp-lb1d", False)),
    ("lb2-staged", lambda: _solo_cycle("pfsp-lb2", False)),
    ("lb2-single-pass", lambda: _solo_cycle("pfsp-lb2", False, staged=False)),
    ("lb2-fused", lambda: _solo_cycle("pfsp-lb2", True)),
    ("lb2-mt16", lambda: _solo_cycle("pfsp-lb2", True, mt=16)),
    ("batched-B2-unfused", lambda: _batched_slot("nqueens", False)),
    ("batched-B2-fused", lambda: _batched_slot("pfsp-lb1", True)),
    ("mesh-D2-unfused", lambda: _mesh_shard("nqueens", False)),
    ("mesh-D2-fused", lambda: _mesh_shard("pfsp-lb1", True)),
]


@pytest.mark.parametrize("name,make", COVERAGE, ids=[c[0] for c in COVERAGE])
def test_cycle_enters_only_captured_functions(name, make):
    """One call of the cycle a graph would capture, on the CPU at check's
    shapes: every port function it enters is in the captured set."""
    call = make()
    probe = _entered(call)
    assert len(probe.seen) >= 3, probe.seen
    missing = probe.missing(_plain_set())
    assert missing == [], missing


def test_probe_records_nothing_outside_its_window():
    from tpu_tree_search_torch.ops.compaction import compact_ids

    import torch

    keep = torch.zeros((4, 2), dtype=torch.bool)
    with EnteredFunctions(str(PACKAGE), lambda: False) as off:
        compact_ids(keep, 8, "scatter")
    assert off.seen == set()
    with EnteredFunctions(str(PACKAGE)) as on:
        compact_ids(keep, 8, "scatter")
    assert any(name == "compact_ids" for _, name, _ in on.seen)


def test_captured_functions_is_per_module():
    modules, _ = parse_modules([str(PACKAGE / "ops" / "compaction.py"),
                                str(PACKAGE / "engine" / "resident.py")])
    project = Project(modules)
    by_name = {Path(m.path).name: m for m in modules}
    names = {getattr(f, "name", None)
             for f in captured_functions(by_name["compaction.py"], project)}
    assert {"compact_ids", "children_of"} <= names
