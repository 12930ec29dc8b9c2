"""The program contract registry (``check``) — the port's counterpart of
`tpu_tree_search/analysis/contracts.py`.

The port's performance claims are claims about the structure of the
program a dispatch runs: the K-cycle CUDA graph (`ops/dispatch.py`) around
a cycle (`engine/resident.py`, `ops/cycle.py`, `ops/tiled.py`). "Telemetry
off builds the off program, not a branch", "a knob flip rebuilds and a
host-only knob does not", "the steady-state cycle reads nothing back", "a
dense survivor path has no sort or scatter", "a cycle makes one child-value
gather". A :class:`Contract` is one such named claim with its check,
**declared next to the code it pins** and evaluated by
``analysis/program_audit.py`` over every cell of the knob matrix.

*The program's record.* On the CPU the audit runs one dispatch's worth of a
cell's program (the init, one cycle, the loop condition) under a
:class:`Recorder`, a ``TorchDispatchMode`` that lists the aten operations
in order. Each kernel route (``ops/dispatch.py`` ``route``: the evaluators
of `ops/pfsp_device.py` and `ops/nqueens_device.py`, the cycle wrappers,
the phase mark, the graph's own nodes) is one opaque entry named after its
CUDA wrapper (``lb1_bounds_cuda``, ``cycle_lb1_cuda``, ``phase_mark_cuda``,
...), whichever device ran it: the plain version's operations stay inside
it, out of the cycle's glue. On the card the same cells' graphs are
captured under the recorder, so the record names the same kernels, and the
graph's node lists (name and ``cudaGraphNodeType``, outer and body) ride
along for the node-level claims.

Registration happens when the declaring module is imported;
``program_audit.load_contracts()`` imports them all. A name is registered
once: a second registration raises.

Artifact families (what a check receives):

* ``cycle``       — a :class:`CycleArtifact`: one matrix cell's program,
  its record (outer and body), the bare evaluator's record, and on the
  card the graph's nodes;
* ``compact-ids`` — ``{"mode", "entries"}``: the record of the bare
  ``ops.compaction.compact_ids`` for one mode;
* ``pair-blocks`` — ``{"mp", "child", "self"}``: the records of the lb2
  evaluators over mp pair blocks;
* ``variants``    — a :class:`VariantArtifact`: one base configuration
  recorded under several knob settings;
* ``cache-key``   — a :class:`CacheKeyArtifact`: the program cache's
  behaviour under knob flips on one problem instance;
* ``batched``     — the B-slot program against the solo one;
* ``lock-graph``  — the static lock-acquisition graph
  (``analysis/lockorder.py``);
* ``fingerprint`` — the matrix's entry histograms against the committed
  baseline.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable

__all__ = [
    "CONTRACTS",
    "CacheKeyArtifact",
    "Contract",
    "CycleArtifact",
    "Entry",
    "Record",
    "Recorder",
    "VariantArtifact",
    "child_value_gathers",
    "contract",
    "entry_counts",
    "get",
    "host_reads",
    "run_one",
]

#: Operation classes of the record (aten packet names).
SORT_OPS = frozenset({"sort", "argsort", "topk", "msort", "kthvalue"})
SEARCH_OPS = frozenset({"searchsorted", "bucketize"})
SCATTER_OPS = frozenset({
    "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
    "scatter_reduce_", "index_put", "index_put_", "_index_put_impl_",
    "index_add", "index_add_", "index_reduce", "index_reduce_",
    "masked_scatter", "masked_scatter_", "put", "put_", "index_fill",
    "index_fill_"})
#: A write of a contiguous row window at an offset held on the device (the
#: push's ``index_copy_``): the counterpart of ``dynamic_update_slice``,
#: not a scatter, when its index is a window (``Entry.info["window"]``).
WINDOW_OPS = frozenset({"index_copy", "index_copy_"})
GATHER_OPS = frozenset({"index", "index_select", "gather", "take",
                        "take_along_dim", "embedding"})
#: A read of a device value by the host, and the operations whose output
#: shape depends on the data (they read a count back).
HOST_READ_OPS = frozenset({"_local_scalar_dense", "item", "is_nonzero",
                           "tolist", "numpy"})
DYNAMIC_SHAPE_OPS = frozenset({"nonzero", "masked_select", "argwhere",
                               "unique_consecutive", "_unique", "_unique2",
                               "unique_dim", "nonzero_numpy"})
#: What never goes in a record: aliasing with no work of its own.
_VIEW_OPS = frozenset({"detach", "alias", "lift_fresh"})


# -- the record ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Entry:
    """One entry of a program's record: an aten operation (``op``), a
    kernel route (``route``, named after its CUDA wrapper) or a host read
    outside the dispatcher (``host``: ``tolist``, ``numpy``). ``shapes``
    and ``dtypes`` are the outputs'; ``info`` holds facts a contract reads
    (``alloc_rows``: the rows of a freshly allocated output; ``d2h``: a
    copy from the card to the host; ``accumulate``/``unique``: an
    ``index_put``'s; ``window``: an ``index_copy``'s index is a contiguous
    window)."""

    kind: str
    name: str
    shapes: tuple = ()
    dtypes: tuple = ()
    info: tuple = ()

    def get(self, key: str, default=None):
        return dict(self.info).get(key, default)

    @property
    def text(self) -> str:
        if self.kind != "op":
            return f"{self.kind}:{self.name}"
        shapes = ",".join("x".join(map(str, s)) for s in self.shapes)
        facts = "".join(f" {k}={v}" for k, v in self.info
                        if k != "alloc_rows")
        return f"{self.name}({shapes};{','.join(self.dtypes)}){facts}"


def entry_counts(entries) -> dict[str, int]:
    """The histogram of a record by entry name — the fingerprint unit."""
    counts: dict[str, int] = {}
    for e in entries:
        counts[e.name] = counts.get(e.name, 0) + 1
    return dict(sorted(counts.items()))


def host_reads(entries) -> list:
    """The entries that read the device from the host or size their
    output by the data."""
    return [e for e in entries
            if e.kind == "host" or e.name in HOST_READ_OPS
            or e.name in DYNAMIC_SHAPE_OPS or e.get("d2h")]


def child_value_gathers(entries, rows: int, lanes: int, dtype) -> list:
    """The gathers big enough to move child values: an output of at least
    ``rows * lanes`` elements in the pool's value dtype (masks and index
    planes move no node data)."""
    want = str(dtype)
    out = []
    for e in entries:
        if e.kind != "op" or e.name not in GATHER_OPS:
            continue
        for shape, dt in zip(e.shapes, e.dtypes):
            size = 1
            for d in shape:
                size *= d
            if dt == want and size >= rows * lanes:
                out.append(e)
                break
    return out


@dataclasses.dataclass
class Record:
    """A dispatch's record: ``outer`` (the graph's own nodes: the init, the
    seed mark, the ``while``), ``body`` (one cycle and the loop
    condition), ``meta`` (the program's armed flags) and, on the card,
    ``nodes`` (``{"outer": [(name, type)], "body": [...]}`` and the graphs
    nested in those, ``DispatchGraph.graph_nodes``)."""

    outer: list
    body: list
    meta: dict = dataclasses.field(default_factory=dict)
    nodes: dict | None = None

    @property
    def entries(self) -> list:
        return self.outer + self.body

    @property
    def text(self) -> str:
        lines = [e.text for e in self.outer] + ["--"] + [
            e.text for e in self.body]
        for part, nodes in (self.nodes or {}).items():
            lines += [f"node:{part}:{name}:{kind}" for name, kind in nodes]
        return "\n".join(lines)

    @property
    def counts(self) -> dict[str, int]:
        return entry_counts(self.entries)

    def cycle_entries(self) -> list:
        """The body without the loop condition (the graph's own node)."""
        return [e for e in self.body if not (
            e.kind == "route" and e.name in GRAPH_NODES)]


#: The dispatch graph's own kernels and the ``while`` node
#: (`csrc/dispatch_graph.cu`).
GRAPH_NODES = frozenset({"dispatch_init", "dispatch_cond", "dispatch_cond_obs",
                         "batch_init", "batch_cond", "batch_cond_obs",
                         "slot_gate", "while"})


def _recorder_class():
    """The ``TorchDispatchMode`` subclass, made at first use (the registry
    itself imports no torch)."""
    global _RECORDER
    if _RECORDER is not None:
        return _RECORDER
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    # tts-lint: traced (the recorder's, run under the capture that check records)
    def tensors(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, (list, tuple)):
            return [t for v in x for t in tensors(v)]
        return []

    # tts-lint: traced (the recorder's, run under the capture that check records)
    def window(idx: torch.Tensor) -> bool | None:
        if idx.is_cuda or idx.dim() != 1:
            return None
        v = idx.detach().numpy()
        return bool(v.size < 2 or ((v[1:] - v[:-1]) == 1).all())

    # tts-lint: traced (the recorder's, run under the capture that check records)
    def distinct(idx: torch.Tensor) -> bool | None:
        if idx.is_cuda:
            return None
        v = idx.detach().reshape(-1).numpy()
        return len(set(v.tolist())) == v.size

    class Recorder(TorchDispatchMode):
        """Lists the aten operations this thread runs in the block, a
        kernel route (``ops/dispatch.py`` ``route``) as one entry, and the
        host reads that bypass the dispatcher (``Tensor.tolist``,
        ``Tensor.numpy``, patched for the block)."""

        def __init__(self):
            super().__init__()
            self.entries: list[Entry] = []
            self.depth = 0
            self._saved = {}

        # -- kernel routes (ops/dispatch.py) ----------------------------------

        # tts-lint: traced (the recorder's, run under the capture that check records)
        def note_route(self, name: str) -> None:
            if self.depth == 0:
                self.entries.append(Entry("route", name))

        # tts-lint: traced (the recorder's, run under the capture that check records)
        def enter_route(self, name: str) -> None:
            self.note_route(name)
            self.depth += 1

        # tts-lint: traced (the recorder's, run under the capture that check records)
        def exit_route(self) -> None:
            self.depth -= 1

        # -- the mode ---------------------------------------------------------

        def __enter__(self):
            from ..ops import dispatch

            self._prev = getattr(dispatch._TLS, "record", None)
            dispatch._TLS.record = self
            me = threading.get_ident()
            for attr in ("tolist", "numpy"):
                self._saved[attr] = torch.Tensor.__dict__.get(attr)
                real = getattr(torch.Tensor, attr)

                def patched(t, *a, _real=real, _name=attr, **k):
                    # Only this thread's reads: the mode is per thread too.
                    if self.depth == 0 and threading.get_ident() == me:
                        self.entries.append(Entry("host", _name))
                    return _real(t, *a, **k)
                setattr(torch.Tensor, attr, patched)
            return super().__enter__()

        def __exit__(self, *exc):
            from ..ops import dispatch

            try:
                return super().__exit__(*exc)
            finally:
                for attr, prev in self._saved.items():
                    if prev is None:
                        delattr(torch.Tensor, attr)
                    else:
                        setattr(torch.Tensor, attr, prev)
                self._saved = {}
                dispatch._TLS.record = self._prev

        # tts-lint: traced (the recorder's, run under the capture that check records)
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func.overloadpacket.__name__
            if self.depth or name in _VIEW_OPS:
                return out
            self.depth += 1  # the facts below read tensors unrecorded
            try:
                info = self._facts(name, args, kwargs, out)
            finally:
                self.depth -= 1
            outs = tensors(out)
            self.entries.append(Entry(
                "op", name, tuple(tuple(t.shape) for t in outs),
                tuple(str(t.dtype).replace("torch.", "") for t in outs),
                tuple(sorted(info.items()))))
            return out

        # tts-lint: traced (the recorder's, run under the capture that check records)
        @staticmethod
        def _facts(name: str, args: tuple, kwargs: dict, out) -> dict:
            ins = tensors(args) + tensors(list(kwargs.values()))
            outs = tensors(out)
            info = {}
            stores = {t.untyped_storage().data_ptr() for t in ins}
            fresh = [t for t in outs
                     if t.untyped_storage().data_ptr() not in stores]
            # tts-lint: waive tensor-branch -- fresh is the list of the op's new outputs: the test reads its length
            if fresh and fresh[0].dim():
                info["alloc_rows"] = int(fresh[0].shape[0])
            if any(t.is_cuda for t in ins) and any(
                    not t.is_cuda for t in outs):
                info["d2h"] = True
            if name in ("index_put", "index_put_", "_index_put_impl_"):
                info["accumulate"] = bool(
                    args[3] if len(args) > 3 else
                    kwargs.get("accumulate", False))
                idx = [t for t in args[1] if t is not None]
                if len(idx) == 1:
                    info["unique"] = distinct(idx[0])
            elif name in WINDOW_OPS:
                info["window"] = window(args[2])
            return info

    _RECORDER = Recorder
    return Recorder


_RECORDER = None


def Recorder():  # noqa: N802  (a class made at first use)
    """A new program recorder (see ``_recorder_class``)."""
    return _recorder_class()()


# -- the registry ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Contract:
    """One named claim about the port's programs.

    ``check(artifact, cell)`` returns a list of violation messages (empty:
    the claim holds there). ``applies(cell)`` filters the matrix cells the
    contract runs on (None: every cell of its artifact family).
    ``declared_in`` is the module that owns the claim."""

    name: str
    claim: str
    artifact: str
    check: Callable
    applies: Callable | None = None
    declared_in: str = ""

    def run(self, artifact, cell) -> list[str]:
        if self.applies is not None and not self.applies(cell):
            return []
        return list(self.check(artifact, cell))


#: name -> Contract, filled when the declaring modules are imported.
CONTRACTS: dict[str, Contract] = {}


def contract(name: str, claim: str, artifact: str,
             applies: Callable | None = None):
    """Decorator: register the decorated check as contract ``name``,
    declared next to the code it pins. A name is registered once."""

    def deco(fn):
        prev = CONTRACTS.get(name)
        if prev is not None:
            raise ValueError(
                f"contract {name!r} already declared in {prev.declared_in}")
        CONTRACTS[name] = Contract(
            name=name, claim=claim, artifact=artifact, check=fn,
            applies=applies, declared_in=getattr(fn, "__module__", "") or "")
        return fn

    return deco


def get(name: str) -> Contract:
    if name not in CONTRACTS:
        raise KeyError(
            f"unknown contract {name!r} (loaded: {sorted(CONTRACTS)}) — "
            "did program_audit.load_contracts() run?")
    return CONTRACTS[name]


def run_one(name: str, artifact, cell=None) -> list[str]:
    """Evaluate one contract directly (its ``applies`` bypassed)."""
    return list(get(name).check(artifact, cell))


# -- artifacts -------------------------------------------------------------


class CycleArtifact:
    """One matrix cell's program and its dispatch's record.

    ``prog`` is the built resident program (its resolved ``compact``,
    ``S``, ``fused``, telemetry flags); ``record`` the dispatch's
    :class:`Record`; ``eval_entries`` the record of the bare evaluator on
    the same chunk (the survivor-path contracts budget against it: the
    step may hold the evaluator's own sorts and scatters, and nothing
    more); ``in_place`` whether the pool and state tensors kept their
    addresses; ``capacity`` the pool's rows."""

    def __init__(self, prog, record: Record, eval_entries: list,
                 in_place: bool, capacity: int):
        self.prog = prog
        self.record = record
        self.eval_entries = eval_entries
        self.eval_counts = entry_counts(eval_entries)
        self.in_place = in_place
        self.capacity = capacity

    @property
    def nodes(self) -> dict | None:
        return self.record.nodes


@dataclasses.dataclass
class VariantArtifact:
    """Records of one base configuration under several knob settings:
    ``variants[label]`` a :class:`Record`. The identity and inertness
    contracts compare labels; which labels exist is part of each
    contract's own applicability check. ``fused``: the base's cycle."""

    variants: dict
    fused: bool = False

    def text(self, label: str) -> str:
        return self.variants[label].text

    def has(self, *labels: str) -> bool:
        return all(lb in self.variants for lb in labels)


@dataclasses.dataclass
class CacheKeyArtifact:
    """The program cache on ONE problem instance: ``distinct[knob]`` — the
    programs taken under a flip of ``knob`` (must be different cache
    entries); ``shared[knob]`` — under a flip of a knob the programs do
    not see (must be the same entry)."""

    distinct: dict
    shared: dict
