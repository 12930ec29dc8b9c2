"""Checkpoint / resume — the port's copy of `tpu_tree_search/engine/checkpoint.py`
(the same file format, so a cut taken by either package resumes in the
other, the multi-host tiers' per-host files ``path.h<rank>`` too, and the
same ``lockstep_commit`` of such a set).

The reference has no checkpointing (SURVEY.md §5: a crashed run loses the
search). But the pool *is* the complete search state — the frontier plus the
incumbent and the counters determine the rest of the run exactly — so a
checkpoint is one serialized NodeBatch + four scalars. The resident tiers
snapshot on a wall-clock cadence (downloading the device pool costs one
host transfer, so snapshots are amortized over many K-cycle blocks); a
resumed search seeds phase 2 from the saved frontier and keeps counting
where the saved run stopped.

Format: one ``.npz`` written atomically (tmp + rename), holding the node
fields plus a JSON header identifying the problem. Resuming validates the
header against the live problem to refuse mixing incompatible searches.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from ..problems.base import NodeBatch, Problem

# v2: PFSP meta carries a p_times digest (ptimes_sha).
# v3 (multi-host) / v2 (single-host): multi-host per-host files write the
# higher version so a pre-v3 reader — which has no hosts/cut coherence
# checks — refuses them instead of silently resuming one host's share as
# the whole frontier.
# v4 (multi-host) / v3 (single-host): narrow node storage (TTS_NARROW,
# problems/base.py) — field arrays are saved at the problem's storage
# dtypes (int8/int16), shrinking payloads ~4x. The npz is self-describing,
# so the loader casts every field to the LIVE problem's node_fields dtypes
# on the way in: old wide files resume under narrow runtimes, narrow files
# resume under TTS_NARROW=0, bit-identically either way (node values are
# range-proven for the narrow dtypes by construction).
FORMAT_VERSION = 4
_SINGLE_HOST_VERSION = 3


class RunController:
    """Shared max-steps / periodic-checkpoint bookkeeping for the resident
    tiers. ``snapshot_fn() -> (batch, best)`` downloads the live frontier;
    ``after_step(tree, sol)`` returns True when the run must stop now (the
    cutoff checkpoint, if requested, has already been written).

    ``drain_fn() -> (tree_inc, sol_inc)``: under pipelined dispatch
    (engine/pipeline.py) the frontier snapshot includes the work of every
    in-flight speculative dispatch, so a cut must first drain their scalar
    counts or the saved counters would lag the saved frontier (a resumed
    run would under-count).  Called exactly once, right before a snapshot
    is taken; the engine's drain also folds the increments into its own
    running totals.

    ``yield_fn() -> bool``: cooperative preemption (the seam a serve
    daemon cuts a job through). Checked at every dispatch boundary
    like the ``max_steps`` cutoff; returning True cuts the run NOW — the
    queue drains, the frontier snapshots, the checkpoint (if a path is
    set) is written — and the engine returns ``complete=False``. A
    resumed search from that cut reproduces the uninterrupted result
    bit-for-bit (the frontier + incumbent + counters are the complete
    search state), which is what makes preemption safe to impose on a
    tenant's job."""

    def __init__(
        self,
        problem: Problem,
        checkpoint_path: str | None,
        interval_s: float,
        max_steps: int | None,
        snapshot_fn,
        drain_fn=None,
        yield_fn=None,
    ):
        import time

        self.problem = problem
        self.path = checkpoint_path
        self.interval_s = interval_s
        self.max_steps = max_steps
        self.snapshot_fn = snapshot_fn
        self.drain_fn = drain_fn
        self.yield_fn = yield_fn
        self.steps = 0
        self._clock = time.monotonic
        self._last = self._clock()

    def _save(self, tree: int, sol: int) -> None:
        if self.drain_fn is not None:
            dt, ds = self.drain_fn()
            tree += dt
            sol += ds
        batch, best = self.snapshot_fn()
        save(self.path, self.problem, batch, best, tree, sol)

    def after_step(self, tree: int, sol: int) -> bool:
        self.steps += 1
        cut = self.max_steps is not None and self.steps >= self.max_steps
        if not cut and self.yield_fn is not None:
            cut = bool(self.yield_fn())
        if cut:
            if self.path is not None:
                self._save(tree, sol)
            return True
        if self.path is not None and self._clock() - self._last >= self.interval_s:
            self._save(tree, sol)
            self._last = self._clock()
        return False


def lockstep_commit(ok: bool, staging: str, final: str, vote=None) -> bool:
    """The two-phase commit of a staged per-host file (`tpu_tree_search/
    engine/checkpoint.py:113-136`), shared by the dist and dist_mesh tiers:
    with ``vote`` (an allgather, ``vote(bool) -> list[bool]``) every host
    votes, and the rename commits only if every host staged its file; else
    the staging file goes and the set stays on the previous coherent cut,
    with a warning on stderr (a stale file behind a "resume with --resume"
    would lose the budgeted work)."""
    import sys

    if vote is not None:
        ok = all(vote(bool(ok)))
    if ok:
        os.replace(staging, final)
    else:
        if os.path.exists(staging):
            os.remove(staging)
        print(f"[checkpoint] lockstep cut NOT committed ({final}); the "
              "previous coherent cut (if any) is retained", file=sys.stderr)
    return ok


@dataclass
class Checkpoint:
    meta: dict  # problem identity, see problem_meta()
    batch: NodeBatch  # the frontier
    best: int
    tree: int
    sol: int
    hosts: int = 1  # multi-host sets: total per-host files in this cut
    # Dist tier: identity of the lockstep cut this file belongs to
    # ("<run-uuid>:<round>", stamped identically on every host of the cut);
    # older files carry the bare communicator round (int). None = timer cut.
    cut_tag: int | str | None = None


def problem_meta(problem: Problem) -> dict:
    meta = {"problem": problem.name}
    if problem.name == "nqueens":
        meta.update(N=problem.N, g=problem.g)
    elif problem.name == "pfsp":
        import hashlib

        # Digest of the processing-times matrix: two ad-hoc instances with
        # the same (jobs, machines) but different p_times must not resume
        # each other's frontiers (inst=None alone cannot tell them apart).
        pt = np.ascontiguousarray(problem.lb1_data.p_times, dtype=np.int64)
        digest = hashlib.sha256(pt.tobytes()).hexdigest()[:16]
        meta.update(inst=getattr(problem, "inst", None), lb=problem.lb,
                    ub=problem.ub, jobs=problem.jobs, machines=problem.machines,
                    ptimes_sha=digest)
        # Johnson pair subset (bounds.LB2_VARIANTS): a non-full variant
        # prunes a different tree, so its frontier must not resume a full
        # run's (and vice versa). Stamped only when non-default, so every
        # pre-variant checkpoint keeps loading against full-variant runs.
        if getattr(problem, "lb2_variant", "full") != "full":
            meta.update(lb2_variant=problem.lb2_variant)
    return meta


def save(path: str, problem: Problem, batch: NodeBatch, best: int, tree: int,
         sol: int, hosts: int = 1, cut_tag: int | str | None = None) -> None:
    header = {
        "version": FORMAT_VERSION if hosts > 1 else _SINGLE_HOST_VERSION,
        "meta": problem_meta(problem),
        "best": int(best),
        "tree": int(tree),
        "sol": int(sol),
        "fields": sorted(batch.keys()),
        "hosts": int(hosts),
        "cut_tag": cut_tag,
    }
    arrays = {f"field_{k}": v for k, v in batch.items()}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f, header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
            **arrays,
        )
    os.replace(tmp, path)


def load(path: str, problem: Problem, expect_hosts: int = 1) -> Checkpoint:
    """``expect_hosts``: the host count of the resuming run. A per-host file
    from an H-host cut resumed into a different-H run would silently drop
    (or double-explore) the other hosts' shares — refuse loudly instead."""
    with np.load(path) as data:
        header = json.loads(bytes(data["header"]).decode())
        if header["version"] not in (1, 2, _SINGLE_HOST_VERSION, FORMAT_VERSION):
            raise ValueError(f"unsupported checkpoint version {header['version']}")
        want = problem_meta(problem)
        got = dict(header["meta"])
        if header["version"] == 1:
            # v1 predates the p_times digest, and v1-era writers stamped the
            # constructor-default inst even for ad-hoc matrices — so a v1
            # PFSP meta claiming inst=14 may belong to a different matrix
            # entirely and its frontier would silently resume with wrong
            # bounds. NQueens meta (N, g) fully determines the search, so v1
            # NQueens checkpoints remain resumable; every v1 PFSP file is
            # refused.
            if got.get("problem") != "nqueens":
                raise ValueError(
                    "v1 PFSP checkpoints cannot be trusted: the format "
                    "predates the p_times digest and may impersonate a named "
                    "Taillard instance; re-run from scratch"
                )
            got.pop("ptimes_sha", None)
        if got != want:
            raise ValueError(
                f"checkpoint is for {header['meta']}, not {problem_meta(problem)}"
            )
        hosts = int(header.get("hosts", 1))
        if hosts != expect_hosts:
            raise ValueError(
                f"checkpoint is 1 of {hosts} per-host files; resuming with "
                f"{expect_hosts} host(s) would lose or double-explore the "
                "other shares (resume with the original host count)"
            )
        # Cast every field to the LIVE problem's storage dtypes: the file
        # may predate narrow storage (wide int32 payloads) or have been
        # written under the opposite TTS_NARROW setting — the npz carries
        # the dtypes, so the cast is exact in both directions.
        fields = problem.node_fields()
        batch = {
            k: (np.asarray(data[f"field_{k}"]).astype(fields[k][1])
                if k in fields else data[f"field_{k}"])
            for k in header["fields"]
        }
    return Checkpoint(
        meta=header["meta"], batch=batch,
        best=header["best"], tree=header["tree"], sol=header["sol"],
        hosts=hosts, cut_tag=header.get("cut_tag"),
    )
