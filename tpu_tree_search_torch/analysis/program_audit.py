"""``check`` — the program contract auditor of the port (the JAX package's
`tpu_tree_search/analysis/program_audit.py`).

Enumerates the **knob matrix** (problem family x ``TTS_COMPACT`` x
``TTS_OBS`` x ``TTS_PHASEPROF`` on the unfused cycle, and the fused cycle
(the JAX ``TTS_MEGAKERNEL`` axis) with its streamed form (``mt``, the JAX
``TTS_MEGAKERNEL_MT``)), builds every cell's resident program at the JAX
audit's shapes and records one dispatch of it (`analysis/contracts.py`
``Recorder``: on the CPU the init, one cycle and the loop condition run
under it; on the card the cycle is captured into the dispatch graph under
it and the graph's node lists are read). Then it evaluates every
registered contract. Three kinds of output:

* **Contract violations** — a named claim failing on a named cell. Always
  fatal: contracts carry no accepted-debt baseline.
* **Fingerprint drift** — each cell's entry histogram against the committed
  ``.tts-torch-contracts.json`` (``check --update`` regenerates it). The
  baseline records the torch version it was made under; under another
  torch the entry-level comparison is skipped with a warning (aten
  decompositions move between releases; the structural contracts still
  run and still gate). The card's records are not fingerprinted.
* **Lock-order audit** — the static lock-acquisition graph
  (``analysis/lockorder.py``) evaluated as a contract over the port.

The knob pins are process-local and restored: the audit clears every knob
it does not set, so ``check`` gives the same answer under any
``TTS_OBS``/``TTS_COMPACT`` in the caller's environment.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import sys
from types import SimpleNamespace

from .contracts import (
    CONTRACTS,
    CacheKeyArtifact,
    CycleArtifact,
    Entry,
    Record,
    Recorder,
    VariantArtifact,
    contract,
    entry_counts,
    get,
)
from .core import Finding, Project, parse_modules

DEFAULT_BASELINE = ".tts-torch-contracts.json"

#: Every knob of the port a cell may pin; ``_pin`` clears the rest.
KNOBS = (
    "TTS_COMPACT", "TTS_OBS", "TTS_PHASEPROF", "TTS_PIPELINE", "TTS_K",
    "TTS_GUARD", "TTS_QUALITY", "TTS_STEAL", "TTS_PODS", "TTS_FLIGHTREC",
    "TTS_COSTMODEL", "TTS_HBM_GBPS", "TTS_TORCH_TRACE",
)

#: Matrix axes.
COMPACT_AXIS = ("auto", "scatter", "sort", "search", "dense")
OBS_AXIS = ("0", "1")
PHASEPROF_AXIS = ("0", "1")
#: The streamed form's tile width: it divides every matrix M (64, 128).
TILE_MT = 16

FAMILIES = ("nqueens", "pfsp-lb1", "pfsp-lb1d", "pfsp-lb2")

#: Each JAX contract (`tpu_tree_search.analysis.program_audit.
#: load_contracts()`) and the port's contracts that stand for it.
JAX_COUNTERPARTS = {
    "dense-step-no-sort-scatter": ("dense-step-no-sort-scatter",),
    "dense-ids-shift-only": ("dense-ids-shift-only",),
    "scatter-ids-unique": ("scatter-ids-unique",),
    "compact-auto-identity": ("compact-auto-identity",),
    "fused-push-single-gather": ("fused-push-single-gather",),
    "pool-donation": ("pool-in-place",),
    "step-callback-armed-only": ("step-callback-armed-only",
                                 "mesh-copies-device-only"),
    "obs-off-identity": ("obs-off-identity",),
    "obs-counter-block": ("obs-counter-block",),
    "phaseprof-off-identity": ("phaseprof-off-identity",),
    "phaseprof-block-leaf": ("phaseprof-block-leaf",),
    "quality-off-identity": ("quality-off-identity",),
    "pipeline-knob-inert": ("pipeline-knob-inert",),
    "guard-knob-inert": ("guard-knob-inert",),
    "steal-knob-inert": ("steal-knob-inert",),
    "narrow-knob-inert": ("narrow-knob-inert",),
    "megakernel-off-identity": ("megakernel-knobs-inert",),
    "megakernel-tiled-identity": ("megakernel-knobs-inert",
                                  "fused-single-launch"),
    "megakernel-single-call": ("fused-single-launch",),
    "lb2-pairblock-loop-free": ("lb2-pair-blocks-one-launch",),
    "program-cache-key-sound": ("program-cache-key-sound",),
    "batch-b1-identity": ("batch-b1-identity",),
    "batch-splice-no-recompile": ("batch-splice-no-recompile",),
    "op-fingerprint": ("op-fingerprint",),
    "lock-order-acyclic": ("lock-order-acyclic",),
}

#: The JAX contracts with no counterpart, each with its reason.
NO_COUNTERPART = {
    "kernel-backend-inert": "the port has one flavour per device "
                            "(ops/backend.py:1-8): no TTS_KERNEL_BACKEND "
                            "seam to hold inert",
}


def load_contracts() -> dict:
    """Import every contract-declaring module and return the registry."""
    from ..analysis import guard, lockorder  # noqa: F401
    from ..engine import batched, pipeline, resident  # noqa: F401
    from ..obs import counters, phases, quality  # noqa: F401
    from ..ops import compaction, cycle, pfsp_device  # noqa: F401
    from ..parallel import resident_mesh, topology  # noqa: F401

    return CONTRACTS


@contextlib.contextmanager
def _pin(env: dict[str, str]):
    """Pin exactly ``env`` over the audit knobs (every other knob unset);
    restore on exit."""
    keys = set(KNOBS) | set(env)
    prev = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update({k: v for k, v in env.items() if v is not None})
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# -- the matrix ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Cell:
    """One knob-matrix cell of one problem family: the unfused cycle under
    a compaction mode and the telemetry knobs, or the fused cycle
    (``cycle="fused"``; ``mt`` its streamed tile width)."""

    family: str
    compact: str = "auto"
    obs: str = "0"
    phaseprof: str = "0"
    cycle: str = "unfused"
    mt: int | None = None

    @property
    def fused(self) -> bool:
        return self.cycle == "fused"

    @property
    def key(self) -> str:
        s = (f"{self.family}|compact={self.compact}|obs={self.obs}"
             f"|ph={self.phaseprof}")
        if self.fused:
            s += "|mk=fused"
        if self.mt is not None:
            s += f"|mt={self.mt}"
        return s

    def env(self) -> dict[str, str]:
        return {"TTS_COMPACT": self.compact, "TTS_OBS": self.obs,
                "TTS_PHASEPROF": self.phaseprof}


def family_factory(family: str):
    """(problem factory, build params) of a family: the JAX audit's shapes
    (`program_audit.py:148-169`), with a pool of four fan-outs."""
    from ..problems import NQueensProblem, PFSPProblem
    from ..problems.pfsp import taillard

    if family == "nqueens":
        return (lambda: NQueensProblem(N=8)), dict(m=5, M=64, K=4)
    if family in ("pfsp-lb1", "pfsp-lb1d"):
        lb = "lb1" if family == "pfsp-lb1" else "lb1_d"
        return (lambda: PFSPProblem(
            lb=lb, ub=0, p_times=taillard.reduced_instance(14, 10, 5))), \
            dict(m=5, M=128, K=4)
    if family == "pfsp-lb2":
        return (lambda: PFSPProblem(
            lb="lb2", ub=0, p_times=taillard.reduced_instance(14, 8, 5))), \
            dict(m=5, M=64, K=4)
    raise ValueError(f"unknown family {family!r} (know {FAMILIES})")


def matrix_cells(families=None) -> list[Cell]:
    """The full (or family-filtered) knob matrix."""
    out: list[Cell] = []
    for fam in families or FAMILIES:
        for c in COMPACT_AXIS:
            for o in OBS_AXIS:
                for ph in PHASEPROF_AXIS:
                    out.append(Cell(fam, c, o, ph))
        # The fused cycle: the compaction stays auto (the kernel compacts
        # itself); pfsp-lb1d pins the refusal (its program records why it
        # runs unfused).
        for o in OBS_AXIS:
            for ph in PHASEPROF_AXIS:
                out.append(Cell(fam, "auto", o, ph, cycle="fused"))
        if fam != "pfsp-lb1d":
            out.append(Cell(fam, cycle="fused", mt=TILE_MT))
    return out


def _frontier(problem, M: int) -> tuple[dict, int]:
    """A warm host frontier of about 1.5 M nodes (a full chunk to pop) and
    the incumbent."""
    from ..engine.device import warmup
    from ..pool.pool import SoAPool
    from ..problems.base import INF_BOUND, index_batch

    best = getattr(problem, "initial_ub", INF_BOUND)
    pool = SoAPool(problem.node_fields())
    pool.push_back(index_batch(problem.root(), 0))
    _, _, best = warmup(problem, pool, best, M + M // 2)
    return pool.as_batch(), best


def _capacity(problem, M: int) -> int:
    """Four fan-outs of pool rows: room for the loop condition, small
    enough that a record stays cheap."""
    return 4 * M * problem.child_slots


def record_dispatch(prog, state) -> Record:
    """The record of one dispatch of ``prog`` on ``state``: on the CPU the
    init (``dispatch_init``), the seed mark when the clock is armed, the
    ``while``, one cycle and the loop condition's node, run under a
    recorder; on the card the cycle captured into the dispatch graph under
    it, the graph's own nodes as entries, and the graph's node lists. A
    fused cycle with the counters off sets the condition itself: its body
    is the cycle alone."""
    from ..obs import phases as obs_phases
    from ..ops import dispatch as D
    from ..ops.cycle import ST_CTR, ST_CTR_SOL, ST_CYCLES, ST_TREE

    n = prog.problem.child_slots
    Mn = prog.M * n
    cond = "dispatch_cond_obs" if prog.obs and prog.fused else "dispatch_cond"
    meta = {"obs": prog.obs, "phaseprof": prog.phaseprof,
            "fused": prog.fused}
    rec = Recorder()
    if prog.device.type == "cuda":
        with rec:
            g = prog._graph(state)
        outer = [Entry("route", "dispatch_init")] + (
            [Entry("route", "phase_mark_cuda")] if prog.clk is not None
            else []) + [Entry("route", "while")]
        tail = [] if g.own_cond else [Entry("route", cond)]
        return Record(outer, rec.entries + tail, meta, g.graph_nodes())
    own = prog.fused and not prog.obs
    cycle = prog.slot_cycle(state)
    st = state.st
    with rec:
        with D.route("dispatch_init"):
            st[ST_TREE:ST_CYCLES + 1] = 0
            if prog.obs:
                st[ST_CTR:ST_CTR_SOL + 1] = 0
        if prog.clk is not None:
            D.phase_mark(prog.clk, 0, obs_phases.SEED)
        rec.note_route("while")
        mark = len(rec.entries)
        cycle()
        if not own:
            with D.route(cond):
                if prog.obs and prog.fused:
                    D.dispatch_cond_obs_plain(st, n, prog.m, Mn,
                                              prog.capacity, prog.K)
                else:
                    D.cycle_cond_plain(st, prog.m, Mn, prog.capacity, prog.K)
    return Record(rec.entries[:mark], rec.entries[mark:], meta)


def _eval_entries(prog, state) -> list:
    """The record of the program's bare evaluator on the chunk its cycle
    pops (the budget of the survivor-path contracts)."""
    import torch

    from ..ops.cycle import ST_BEST

    M = prog.M
    vals_c = state.pool_vals[:M].clone()
    aux_c = state.pool_aux[:M].to(torch.int32)
    valid = torch.ones(M, dtype=torch.bool, device=prog.device)
    best = state.st[ST_BEST].clone()
    rec = Recorder()
    with rec:
        prog._evaluate(vals_c, aux_c, valid, best)
    return rec.entries


def record_cell(cell: Cell, problem=None, frontier=None,
                device="cpu") -> CycleArtifact:
    """Build one cell's program (uncached) and record a dispatch of it."""
    from ..engine.resident import new_program

    factory, p = family_factory(cell.family)
    if problem is None:
        problem = factory()
    if frontier is None:
        frontier = _frontier(problem, p["M"])
    batch, best = frontier
    capacity = _capacity(problem, p["M"])
    with _pin(cell.env()):
        prog = new_program(problem, p["m"], p["M"], p["K"], capacity, device,
                           fused=cell.fused, mt=cell.mt)
    try:
        state = prog.init_state(batch, best)
        ptrs = _ptrs(state)
        eval_entries = _eval_entries(prog, state)
        record = record_dispatch(prog, state)
        in_place = _ptrs(state) == ptrs
    finally:
        prog.close()
    return CycleArtifact(prog, record, eval_entries, in_place, capacity)


def _ptrs(state) -> tuple:
    return (state.pool_vals.data_ptr(), state.pool_aux.data_ptr(),
            state.st.data_ptr())


def _contracts_for(kind: str):
    return [c for c in CONTRACTS.values() if c.artifact == kind]


def _violations(name: str, cell_key: str, msgs) -> list[Finding]:
    return [Finding(f"contract:{name}", cell_key, 0, 0, m) for m in msgs]


def _fingerprint(record: Record) -> dict:
    return {"ops": record.counts, "entries": len(record.body)}


def audit_matrix(cells, fingerprints: dict | None = None,
                 device="cpu") -> list[Finding]:
    """Record every cell and run the cycle contracts; with
    ``fingerprints``, each cell's histogram is recorded under its key."""
    findings: list[Finding] = []
    by_family: dict[str, list[Cell]] = {}
    for c in cells:
        by_family.setdefault(c.family, []).append(c)
    cycle_contracts = _contracts_for("cycle")
    for fam, fam_cells in by_family.items():
        factory, p = family_factory(fam)
        problem = factory()
        frontier = _frontier(problem, p["M"])
        for cell in fam_cells:
            art = record_cell(cell, problem, frontier, device)
            for c in cycle_contracts:
                findings.extend(_violations(c.name, cell.key,
                                            c.run(art, cell)))
            if fingerprints is not None:
                fingerprints[cell.key] = _fingerprint(art.record)
    return findings


def compact_ids_artifact(mode: str, device="cpu") -> dict:
    """The record of the bare ``compact_ids`` for one mode, on a seeded
    (64, 20) mask at S = 640 (the JAX audit's shape)."""
    import numpy as np
    import torch

    from ..ops.compaction import compact_ids

    keep = torch.from_numpy(
        np.random.default_rng(0).random((64, 20)) < 0.3).to(device)
    rec = Recorder()
    with _pin({}), rec:
        compact_ids(keep, 640, mode)
    return {"mode": mode, "entries": rec.entries}


def audit_compact_ids(fingerprints: dict | None = None,
                      device="cpu") -> list[Finding]:
    """The bare rank-inversion contracts, per mode."""
    from ..ops.compact_policy import MODES

    findings: list[Finding] = []
    for mode in MODES:
        art = compact_ids_artifact(mode, device)
        key = f"compact-ids|mode={mode}"
        for c in _contracts_for("compact-ids"):
            findings.extend(_violations(c.name, key, c.run(art, None)))
        if fingerprints is not None:
            fingerprints[key] = {"ops": entry_counts(art["entries"])}
    return findings


def pair_blocks_artifact(mp: int, device="cpu",
                         copy: int | None = None) -> dict:
    """The records of the lb2 child and self evaluators over ``mp`` pair
    blocks (`ops/pfsp_device.py` ``lb2_bounds_mp``, ``lb2_self_bounds_mp``)
    on ta021, 190 machine pairs (the JAX audit's shape), 8 rows. With
    ``copy``: that copy's of a shard copied on two positions of ``device``
    (`parallel/resident_mesh.py` ``copy_layout``): its blocks and its
    exchange, the other copy run beside it in a thread of its own,
    unrecorded (on the card each on a stream of its own)."""
    import threading

    import torch

    from ..ops import pfsp_device as P
    from ..ops.pair_exchange import PairExchange
    from ..parallel.resident_mesh import copy_layout, mp_grid
    from ..problems import PFSPProblem

    prob = PFSPProblem(inst=21, lb="lb2", ub=1)
    t = prob.device_tables(device)
    n = prob.jobs
    prmu = torch.arange(n, dtype=torch.int32, device=device).repeat(8, 1)
    limit1 = torch.full((8,), -1, dtype=torch.int32, device=device)
    count = torch.tensor(8, dtype=torch.int32, device=device)
    t.pair_blocks(mp)  # the blocks' tables are built before the record
    out = {"mp": mp, "pairs": t.johnson.pair_count}
    runs = {"child": lambda blocks=None, x=None: P.lb2_bounds_mp(
                prmu, limit1, t, mp, blocks=blocks, exchange=x),
            "self": lambda blocks=None, x=None: P.lb2_self_bounds_mp(
                prmu, limit1, count, t, mp, blocks, x)}
    if copy is None:
        for kind, run in runs.items():
            rec = Recorder()
            with _pin({}), rec:
                run()
            out[kind] = rec.entries
        return out
    layout = [blocks for _, blocks in copy_layout(mp_grid(1, mp, 2))[0]]
    x = PairExchange([device, device], 8 * n)
    ends = [x.endpoint(i) for i in range(2)]
    out.update(blocks=layout[copy], exchange=True, copy=copy)
    cuda = torch.device(device).type == "cuda"

    def on_stream(fn):
        if not cuda:
            return fn()
        with torch.cuda.stream(torch.cuda.Stream(device)):
            return fn()

    # Each copy's launches once without the exchange, so that no kernel of
    # theirs is first loaded (lazily, waiting for the card) while a
    # copy's exchange spins.
    for kind, run in runs.items():
        for blocks in layout:
            on_stream(lambda: run(blocks))
    for kind, run in runs.items():
        other = 1 - copy
        peer = threading.Thread(target=lambda: on_stream(
            lambda: run(layout[other], ends[other])), daemon=True)
        peer.start()
        rec = Recorder()
        with _pin({}), rec:
            on_stream(lambda: run(layout[copy], ends[copy]))
        peer.join()
        out[kind] = rec.entries
    if cuda:
        torch.cuda.synchronize(device)
        for end in ends:
            end.check()
    return out


def audit_pair_blocks(fingerprints: dict | None = None, device="cpu",
                      mps=(1, 2, 4), copies=(2, 4)) -> list[Finding]:
    """The pair-block contract at each of ``mps``, and for each of
    ``copies`` (an mp) on each copy of a shard copied on two positions."""
    findings: list[Finding] = []
    cells = [(mp, None) for mp in mps] + [(mp, i) for mp in copies
                                          for i in (0, 1)]
    for mp, copy in cells:
        art = pair_blocks_artifact(mp, device, copy)
        key = f"lb2-pair-blocks|mp={mp}" + (
            "" if copy is None else f"|copy={copy}of2")
        for c in _contracts_for("pair-blocks"):
            findings.extend(_violations(c.name, key, c.run(art, None)))
        if fingerprints is not None:
            fingerprints[key] = {"ops": entry_counts(art["child"]),
                                 "ops_self": entry_counts(art["self"])}
    return findings


def record_batch(bp) -> Record:
    """The record of one round of a batched program (``BatchGraph``): on
    the CPU ``batch_init``, each slot's gate (unfused) and cycle in slot
    order, and ``batch_cond``; on the card the slots' cycles captured into
    the batch's graph, and its node lists."""
    from ..ops import dispatch as D

    inner = bp.inner
    n = bp.problem.child_slots
    Mn = bp.M * n
    cond = "batch_cond_obs" if bp.obs and inner.fused else "batch_cond"
    rec = Recorder()
    meta = {"obs": bp.obs, "fused": inner.fused, "B": bp.B}
    if bp.device.type == "cuda":
        with rec:
            g = bp.graph()
        return Record([Entry("route", "batch_init"), Entry("route", "while")],
                      rec.entries + [Entry("route", cond)], meta,
                      g.graph_nodes())
    with rec:
        with D.route("batch_init"):
            D.batch_init_plain(bp.st, bp.m, Mn, bp.capacity, bp.K, bp.obs)
        rec.note_route("while")
        mark = len(rec.entries)
        for s in bp.states:
            if not inner.fused:
                with D.route("slot_gate"):
                    D.loop_active(s.st.tolist(), bp.m, Mn, bp.capacity, bp.K)
            inner.slot_cycle(s)()
        with D.route(cond):
            D.batch_cond_plain(bp.st, n if bp.obs and inner.fused else 0,
                               bp.m, Mn, bp.capacity, bp.K)
    return Record(rec.entries[:mark], rec.entries[mark:], meta)


def batched_artifact(B: int, fused: bool, device="cpu") -> dict:
    """A B-slot N-Queens program (`engine/batched.py`) against the solo
    program of the same configuration: each one's record, then a slot
    admitted (``make_slot``) into the built program, with the builds and
    tensor addresses around it."""
    from ..engine.batched import BatchedProgram
    from ..engine.resident import new_program
    from ..ops import _build

    factory, p = family_factory("nqueens")
    problem = factory()
    batch, best = _frontier(problem, p["M"])
    capacity = _capacity(problem, p["M"])
    args = (problem, p["m"], p["M"], p["K"], capacity, device)
    with _pin({}):
        solo = new_program(*args, fused=fused)
        try:
            solo_rec = record_dispatch(solo, solo.init_state(batch, best))
        finally:
            solo.close()
        bp = BatchedProgram(problem, B, *args[1:], fused=fused)
    try:
        for i in range(B):
            bp.make_slot(i, batch, best)
        rec = record_batch(bp)
        before = (_build.build_counts(), bp.st.data_ptr(),
                  [_ptrs(s) for s in bp.states])
        bp.make_slot(0, batch, best)
        if B > 1:
            bp.empty_slot(B - 1)
        if bp.graphed:
            bp.graph()
        after = (_build.build_counts(), bp.st.data_ptr(),
                 [_ptrs(s) for s in bp.states])
    finally:
        bp.close()
    return {"B": B, "fused": fused, "record": rec, "solo": solo_rec,
            "before": before, "after": after}


def audit_batched(fingerprints: dict | None = None, device="cpu",
                  widths=(1, 2)) -> list[Finding]:
    """The batched contracts (``engine/batched.py``) on N-Queens, both
    cycles, at each width, and ``step-callback-armed-only`` over the
    batch's record (on the card its graphs, the slots' gated bodies
    included)."""
    findings: list[Finding] = []
    reads = get("step-callback-armed-only")
    for fused in (False, True):
        for B in widths:
            art = batched_artifact(B, fused, device)
            key = f"batched|nqueens|B{B}|{'fused' if fused else 'unfused'}"
            for c in _contracts_for("batched"):
                findings.extend(_violations(c.name, key, c.run(art, None)))
            findings.extend(_violations(reads.name, key, reads.check(
                SimpleNamespace(record=art["record"]), None)))
            if fingerprints is not None:
                fingerprints[key] = _fingerprint(art["record"])
    return findings


def mesh_record(fused: bool, device) -> Record:
    """A D=2 N-Queens mesh program's dispatch graph (`ops/mesh.py`
    ``MeshGraph``: two rounds, each shard's cycle, gated where unfused, and
    the balance step) captured on the card under the recorder: the
    capture's record and every graph's node list."""
    from ..parallel.resident_mesh import MeshProgram

    factory, p = family_factory("nqueens")
    problem = factory()
    batch, best = _frontier(problem, 2 * p["M"])
    with _pin({}):
        prog = MeshProgram(problem, 2, p["m"], p["M"], p["K"], 2, 2 * p["m"],
                           _capacity(problem, p["M"]), device, fused=fused)
    try:
        prog.upload(batch, best)
        rec = Recorder()
        with rec:
            g = prog.graph()
        return Record([], rec.entries, {"fused": fused, "D": 2},
                      g.graph_nodes())
    finally:
        prog.close()


def mesh_copies_artifact(staged: bool, device) -> dict:
    """A D=2, mp=2 lb2 mesh over two positions of the card (each shard a
    copy at each, `parallel/resident_mesh.py`): every group's round graphs
    built, and their node lists by ``group<i>.round<r>.<label>``."""
    from ..parallel.resident_mesh import MeshProgram

    factory, p = family_factory("pfsp-lb2")
    problem = factory()
    batch, best = _frontier(problem, 2 * p["M"])
    with _pin({}):
        prog = MeshProgram(problem, 2, p["m"], p["M"], p["K"], 2, 2 * p["m"],
                           _capacity(problem, p["M"]), devices=[device] * 2,
                           fused=False, staged=staged, mp=2)
    try:
        prog.upload(batch, best)
        nodes = {}
        for i in range(len(prog.groups)):
            for r in range(prog.rounds):
                for label, ns in prog.graph(i, r).graph_nodes().items():
                    nodes[f"group{i}.round{r}.{label}"] = ns
        return {"staged": staged, "copies": [
            [c.shard for c in g.copies] for g in prog.groups],
            "nodes": nodes}
    finally:
        prog.close()


def audit_mesh(device="cpu") -> list[Finding]:
    """``step-callback-armed-only`` over the mesh graphs, both cycles, and
    ``mesh-copies-device-only`` over the copies' graphs under mp (staged
    and single-pass). A mesh dispatch is a graph only on the card: on the
    CPU the shards run the solo cycles the matrix records, so there is
    nothing more to read."""
    import torch

    if torch.device(device).type != "cuda":
        return []
    reads = get("step-callback-armed-only")
    findings: list[Finding] = []
    for fused in (False, True):
        key = f"mesh|nqueens|D2|{'fused' if fused else 'unfused'}"
        findings.extend(_violations(reads.name, key, reads.check(
            SimpleNamespace(record=mesh_record(fused, device)), None)))
    for c in _contracts_for("mesh-copies"):
        for staged in (True, False):
            key = f"mesh|pfsp-lb2|D2|mp2|copies|{'staged' if staged else 'single'}"
            findings.extend(_violations(c.name, key, c.run(
                mesh_copies_artifact(staged, device), None)))
    return findings


# -- variant (identity / knob-inertness) artifacts -------------------------

#: label -> env pins. "off" is the all-unset base every identity contract
#: compares against. TTS_NARROW, TTS_MEGAKERNEL and TTS_MEGAKERNEL_MT are
#: the JAX package's knobs: the port reads none of them.
VARIANT_ENVS = {
    "off": {},
    "obs0": {"TTS_OBS": "0"},
    "obs-host": {"TTS_OBS": "host"},
    "obs1": {"TTS_OBS": "1"},
    "phase0": {"TTS_PHASEPROF": "0"},
    "phase1": {"TTS_PHASEPROF": "1"},
    "phase1-obs1": {"TTS_PHASEPROF": "1", "TTS_OBS": "1"},
    "pipe0": {"TTS_PIPELINE": "0"},
    "pipe2": {"TTS_PIPELINE": "2"},
    "guard1": {"TTS_GUARD": "1"},
    "quality1": {"TTS_QUALITY": "1"},
    "steal-flat": {"TTS_STEAL": "flat"},
    "steal-hier": {"TTS_STEAL": "hier", "TTS_PODS": "2"},
    "narrow0": {"TTS_NARROW": "0"},
    "mk-env": {"TTS_MEGAKERNEL": "0", "TTS_MEGAKERNEL_MT": str(TILE_MT)},
}


def variant_artifact(family: str, fused: bool = False, labels=None,
                     device="cpu") -> VariantArtifact:
    """Record one family's dispatch under each variant env, every label
    on a FRESH problem instance (identity is a fact about the build, never
    a cache hit). The unfused base adds ``mt`` (the tile width passed to
    the unfused cycle) and the auto-against-explicit compaction pair."""
    from ..engine.resident import new_program
    from ..ops.compact_policy import resolve_compact_mode

    factory, p = family_factory(family)
    frontier = _frontier(factory(), p["M"])
    variants: dict[str, Record] = {}

    def record(env, mt=None) -> Record:
        problem = factory()
        with _pin(env):
            prog = new_program(problem, p["m"], p["M"], p["K"],
                               _capacity(problem, p["M"]), device,
                               fused=fused, mt=mt)
        try:
            return record_dispatch(prog, prog.init_state(*frontier))
        finally:
            prog.close()

    for label, env in VARIANT_ENVS.items():
        if labels is None or label in labels:
            variants[label] = record(env)
    if not fused:
        if labels is None or "mt" in labels:
            variants["mt"] = record({}, mt=TILE_MT)
        if labels is None or any(lb.startswith("compact-") for lb in labels):
            problem = factory()
            with _pin({"TTS_COMPACT": "auto"}):
                resolved = resolve_compact_mode(problem, p["M"],
                                                problem.child_slots)
            variants["compact-auto"] = record({"TTS_COMPACT": "auto"})
            variants[f"compact-{resolved}"] = record(
                {"TTS_COMPACT": resolved})
    return VariantArtifact(variants, fused=fused)


def audit_variants(families=None, device="cpu") -> list[Finding]:
    findings: list[Finding] = []
    var_contracts = _contracts_for("variants")
    for fam in families or FAMILIES:
        for fused in (False, True) if fam != "pfsp-lb1d" else (False,):
            art = variant_artifact(fam, fused, device=device)
            key = f"{fam}|variants|{'fused' if fused else 'unfused'}"
            for c in var_contracts:
                findings.extend(_violations(c.name, key, c.run(art, None)))
    return findings


def cache_key_artifact(family: str, device="cpu") -> CacheKeyArtifact:
    """The program cache on one instance (``make_program``, each program
    released back to it): what a program bakes in must take a new program
    on a flip, what it does not see must take the same one. The JAX
    ``TTS_MEGAKERNEL`` and ``TTS_MEGAKERNEL_MT`` are the port's ``fused``
    and ``mt`` arguments; as knobs the port reads neither."""
    from ..engine.resident import make_program

    factory, p = family_factory(family)
    problem = factory()
    capacity = _capacity(problem, p["M"])

    def build(env, fused=False, mt=None):
        with _pin(env):
            prog = make_program(problem, p["m"], p["M"], p["K"], capacity,
                                device, fused=fused, mt=mt)
        prog.release()
        return prog

    base = {"TTS_COMPACT": "sort"}
    p0 = build(base)
    distinct = {
        "TTS_COMPACT": (p0, build({**base, "TTS_COMPACT": "search"})),
        "TTS_OBS": (p0, build({**base, "TTS_OBS": "1"})),
        "TTS_PHASEPROF": (p0, build({**base, "TTS_PHASEPROF": "1"})),
        "TTS_MEGAKERNEL (fused=)": (p0, build(base, fused=True)),
        "TTS_MEGAKERNEL_MT (mt=)": (build(base, fused=True),
                                    build(base, fused=True, mt=TILE_MT)),
    }
    shared = {
        "TTS_PIPELINE": (p0, build({**base, "TTS_PIPELINE": "2"})),
        "TTS_GUARD": (p0, build({**base, "TTS_GUARD": "1"})),
        "TTS_STEAL": (p0, build({**base, "TTS_STEAL": "hier"})),
        "TTS_NARROW": (p0, build({**base, "TTS_NARROW": "0"})),
        "TTS_MEGAKERNEL (env)": (p0, build({**base, "TTS_MEGAKERNEL": "0"})),
        "rebuild": (p0, build(base)),
    }
    from ..engine.resident import release_programs

    release_programs(problem)
    return CacheKeyArtifact(distinct=distinct, shared=shared)


def audit_cache_keys(families=None, device="cpu") -> list[Finding]:
    findings: list[Finding] = []
    for fam in families or FAMILIES:
        art = cache_key_artifact(fam, device)
        for c in _contracts_for("cache-key"):
            findings.extend(_violations(c.name, f"{fam}|cache-key",
                                        c.run(art, None)))
    return findings


def audit_locks(paths=None) -> list[Finding]:
    """The lock-order contract over the port's sources (or ``paths``)."""
    from . import lockorder

    if paths is None:
        paths = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    modules, parse_errors = parse_modules(paths)
    findings = list(parse_errors)
    graph = lockorder.build_graph(Project(modules))
    for c in _contracts_for("lock-graph"):
        findings.extend(_violations(c.name, "lock-graph", c.run(graph, None)))
    return findings


# -- the fingerprint baseline ----------------------------------------------


def _hash_cells(cells: dict) -> str:
    blob = json.dumps(cells, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def load_baseline(path: str) -> dict | None:
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (FileNotFoundError, ValueError):
        return None


def save_baseline(path: str, cells: dict) -> dict:
    import torch

    doc = {
        "comment": "check fingerprint baseline of the port: the entry "
                   "histogram of every recorded program in the knob "
                   "matrix (CPU); regenerate with `python -m "
                   "tpu_tree_search_torch check --update` (drift must be "
                   "intentional and reviewed)",
        "torch": torch.__version__,
        "fingerprint": _hash_cells(cells),
        "cells": cells,
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return doc


def _diff_ops(old: dict, new: dict) -> str:
    deltas = []
    for op in sorted(set(old) | set(new)):
        a, b = old.get(op, 0), new.get(op, 0)
        if a != b:
            deltas.append(f"{op}: {a} -> {b}")
    return "; ".join(deltas) or "(identical op counts)"


@contract(
    "op-fingerprint",
    claim="every matrix cell's entry histogram (aten operations and kernel "
          "routes of its recorded dispatch, on the CPU) matches the "
          "committed .tts-torch-contracts.json — program structure cannot "
          "drift silently (`check --update` accepts reviewed drift; a "
          "baseline made under another torch version is reported as a "
          "warning, not compared entry by entry)",
    artifact="fingerprint",
)
def _check_fingerprint(art, cell=None):
    current, doc = art["current"], art["baseline"]
    if doc is None:
        return [f"no committed baseline at {art['path']} — run "
                "`python -m tpu_tree_search_torch check --update` and "
                "commit it"]
    out = []
    base_cells = doc.get("cells", {})
    for key in sorted(current):
        if key not in base_cells:
            out.append(f"{key}: cell missing from baseline (new matrix "
                       "cell? run --update)")
            continue
        old, new = base_cells[key], current[key]
        for part in ("ops", "ops_self"):
            if old.get(part) != new.get(part):
                out.append(f"{key}: op drift — "
                           f"{_diff_ops(old.get(part) or {}, new.get(part) or {})}")
                break
        else:
            if old.get("entries") != new.get("entries"):
                out.append(f"{key}: entry count {old.get('entries')} -> "
                           f"{new.get('entries')}")
    for key in sorted(set(base_cells) - set(current)):
        out.append(f"{key}: baseline cell no longer produced (stale "
                   "baseline? run --update)")
    return out


# -- orchestration ---------------------------------------------------------


@dataclasses.dataclass
class CheckResult:
    findings: list[Finding]
    fingerprints: dict
    cells: int
    contracts: int
    warnings: list[str]
    updated: str | None = None

    @property
    def fingerprint(self) -> str:
        return _hash_cells(self.fingerprints)


def run_check(families=None, update: bool = False,
              baseline_path: str | None = None, lock_paths=None,
              with_locks: bool = True, with_fingerprint: bool = True,
              device=None) -> CheckResult:
    """The full audit (the ``check`` entry point), on the card unless
    ``device`` is ``"cpu"`` (``ops/backend.py`` ``resolve_device``: None is
    the card, and raises where there is none). On the card it records the
    cells with the graphs' node lists; the fingerprint is the CPU's
    (``device="cpu"``), neither compared nor written on the card, where
    ``update`` raises."""
    import torch

    from ..ops.backend import resolve_device

    load_contracts()
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if update and on_card:
        raise ValueError(UPDATE_ON_CARD)
    baseline_path = baseline_path or DEFAULT_BASELINE
    findings: list[Finding] = []
    fingerprints: dict = {}
    warnings: list[str] = []
    cells = matrix_cells(families=families)
    findings += audit_matrix(cells, fingerprints, device)
    findings += audit_variants(families, device)
    findings += audit_cache_keys(families, device)
    if families is None:
        findings += audit_compact_ids(fingerprints, device)
        findings += audit_pair_blocks(fingerprints, device)
        findings += audit_batched(fingerprints, device)
        findings += audit_mesh(device)
    if with_locks:
        findings += audit_locks(lock_paths)
    updated = None
    if update:
        save_baseline(baseline_path, fingerprints)
        updated = baseline_path
    elif with_fingerprint and families is None and not on_card:
        doc = load_baseline(baseline_path)
        if doc is not None and doc.get("torch") != torch.__version__:
            warnings.append(
                f"baseline {baseline_path} made under torch "
                f"{doc.get('torch')}, running {torch.__version__}: "
                "entry-level comparison skipped (re-run --update under this "
                "torch to re-arm the fingerprint gate)")
        else:
            art = {"current": fingerprints, "baseline": doc,
                   "path": baseline_path}
            findings += _violations("op-fingerprint", "fingerprint",
                                    CONTRACTS["op-fingerprint"].run(art,
                                                                    None))
    findings.sort(key=lambda f: (f.path, f.rule, f.message))
    return CheckResult(findings, fingerprints, len(cells), len(CONTRACTS),
                       warnings, updated)


# -- CLI -------------------------------------------------------------------


#: Why ``--update`` needs the CPU.
UPDATE_ON_CARD = ("--update writes the fingerprint baseline, which is the "
                  "CPU's (the plain versions' operations): pass --device cpu")


def add_check_args(p) -> None:
    p.add_argument("--update", action="store_true",
                   help="regenerate the fingerprint baseline "
                        f"(./{DEFAULT_BASELINE}) from the current programs")
    p.add_argument("--baseline", default=None,
                   help=f"fingerprint baseline path (default "
                        f"./{DEFAULT_BASELINE})")
    p.add_argument("--family", action="append", default=None,
                   dest="families", metavar="NAME", choices=FAMILIES,
                   help="audit only this problem family (repeatable; skips "
                        "the fingerprint gate, which is whole-matrix)")
    p.add_argument("--no-locks", action="store_true",
                   help="skip the lock-order audit")
    p.add_argument("--list", action="store_true", dest="list_contracts",
                   help="print the contract catalogue and exit")
    p.add_argument("--json", action="store_true", dest="check_json",
                   help="emit one JSON object instead of text")
    p.add_argument("--device", default=None,
                   help="cuda (the default: the card, each cell's dispatch "
                        "graph, its node names and types) or cpu (the plain "
                        "versions, fingerprinted; --update needs it)")


def run_check_cli(args) -> int:
    if args.list_contracts:
        for name, c in sorted(load_contracts().items()):
            print(f"{name}  [{c.artifact}]  ({c.declared_in})")
            print(f"    {c.claim}")
        return 0
    if args.update and args.families:
        print("check: --update regenerates the WHOLE-matrix baseline; it "
              "cannot be combined with --family")
        return 2
    from ..ops.backend import resolve_device

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"check: {e}; pass --device cpu to audit the plain versions",
              file=sys.stderr)
        return 2
    if args.update and device.type != "cpu":
        print(f"check: {UPDATE_ON_CARD}", file=sys.stderr)
        return 2
    res = run_check(families=args.families, update=args.update,
                    baseline_path=args.baseline,
                    with_locks=not args.no_locks, device=device)
    if args.check_json:
        print(json.dumps({
            "findings": [vars(f) for f in res.findings],
            "cells": res.cells,
            "contracts": res.contracts,
            "fingerprint": res.fingerprint,
            "warnings": res.warnings,
            "updated": res.updated,
        }))
        return 1 if res.findings else 0
    for w in res.warnings:
        print(f"warning: {w}")
    for f in res.findings:
        print(f.render())
    if res.updated:
        print(f"fingerprint baseline written: {res.updated} "
              f"({len(res.fingerprints)} cells, hash {res.fingerprint})")
    print(f"check: {len(res.findings)} finding(s) over {res.cells} matrix "
          f"cells, {res.contracts} contracts (fingerprint "
          f"{res.fingerprint})")
    return 1 if res.findings else 0
