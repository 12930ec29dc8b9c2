"""Job specs + the durable job registry (`tpu_tree_search/serve/jobs.py`).

A job spec is the JSON body of ``POST /submit`` — the serve-side mirror of
the CLI's run arguments (``cli.build_parser``), restricted to the tiers a
resident daemon can preempt (``device`` and ``mesh``: both ride
``RunController.yield_fn``). ``validate_spec`` normalizes and defaults it without touching
torch, so admission control runs entirely in the HTTP thread;
``build_problem`` is the constructor the scheduler calls.

The port refuses (``ValueError``, HTTP 400) what it does not run: ``mp``
other than 1 (ROADMAP.md A.9's second half), and the JAX knobs it has no
counterpart for, ``compact`` other than ``"auto"`` and ``lb2_pairblock``
(ROADMAP.md C).
The default M is the port's CLI default for the daemon's device
(``cli.default_M``).

Job records are durable: every state transition rewrites the job's JSON
file atomically under ``<state_dir>/jobs/``, and a restarted daemon
reloads them — finished jobs keep serving their results, interrupted ones
come back as ``requeued`` (their checkpoint makes the resume exact).
"""

from __future__ import annotations

import json
import os
import threading
import time

#: Job lifecycle. queued -> running -> done | failed | cancelled, with two
#: detours: running -> queued (preempted, checkpoint cut) and
#: queued/running -> requeued (daemon drained; a restart re-admits).
STATES = ("queued", "running", "done", "failed", "cancelled", "requeued")

_TIERS = ("device", "mesh")
_LBS = ("lb1", "lb1_d", "lb2")
_LB2_VARIANTS = ("full", "nabeshima", "lageweg")


def _as_int(spec: dict, key: str, lo: int, hi: int, default=None):
    v = spec.get(key, default)
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, int):
        raise ValueError(f"spec.{key} must be an integer")
    if not lo <= v <= hi:
        raise ValueError(f"spec.{key} must be in [{lo}, {hi}], got {v}")
    return v


def validate_spec(spec, device_type: str = "cuda") -> dict:
    """Normalize a submitted spec: fill defaults, reject junk. Returns a
    fresh dict (the admission record); raises ``ValueError`` on invalid
    input. Pure host code — no torch call, safe in the HTTP thread.
    ``device_type`` is the daemon's ("cuda" or "cpu"): it picks the
    default M."""
    if not isinstance(spec, dict):
        raise ValueError("spec must be a JSON object")
    known = {
        "problem", "tier", "N", "g", "inst", "lb", "ub", "lb2_variant",
        "lb2_pairblock", "m", "M", "K", "D", "mp", "compact", "max_steps",
        "label",
    }
    unknown = sorted(set(spec) - known)
    if unknown:
        raise ValueError(f"unknown spec field(s): {', '.join(unknown)}")
    problem = spec.get("problem")
    if problem not in ("nqueens", "pfsp"):
        raise ValueError("spec.problem must be 'nqueens' or 'pfsp'")
    tier = spec.get("tier", "device")
    if tier not in _TIERS:
        raise ValueError(
            f"spec.tier must be one of {_TIERS} (the preemptible resident "
            "tiers); use the CLI directly for seq/multi/dist runs"
        )
    out = {"problem": problem, "tier": tier}
    if problem == "nqueens":
        out["N"] = _as_int(spec, "N", 4, 32, default=14)
        out["g"] = _as_int(spec, "g", 1, 64, default=1)
    else:
        out["inst"] = _as_int(spec, "inst", 1, 120, default=14)
        out["lb"] = spec.get("lb", "lb1")
        if out["lb"] not in _LBS:
            raise ValueError(f"spec.lb must be one of {_LBS}")
        out["ub"] = _as_int(spec, "ub", 0, 1, default=1)
        out["lb2_variant"] = spec.get("lb2_variant", "full")
        if out["lb2_variant"] not in _LB2_VARIANTS:
            raise ValueError(f"spec.lb2_variant must be one of {_LB2_VARIANTS}")
        if out["lb2_variant"] != "full" and out["lb"] != "lb2":
            raise ValueError("spec.lb2_variant requires lb='lb2'")
        if spec.get("lb2_pairblock") is not None:
            raise ValueError(
                "spec.lb2_pairblock has no counterpart in the port: its lb2 "
                "kernels take the pairs in one pass (ROADMAP.md C)")
    out["m"] = _as_int(spec, "m", 1, 1 << 20, default=25)
    M = _as_int(spec, "M", 1, 1 << 24)
    if M is None:
        # The CLI's default for the daemon's device; resolved once at
        # admission so the shape class is fully determined by the
        # normalized spec.
        from ..cli import default_M

        M = default_M(problem, device_type, tier)
    out["M"] = M
    K = spec.get("K")
    if K is not None:
        if K != "auto" and not (
            isinstance(K, int) and not isinstance(K, bool) and K >= 1
        ):
            raise ValueError("spec.K must be 'auto' or an integer >= 1")
        out["K"] = K
    if tier == "mesh":
        D = _as_int(spec, "D", 1, 1024)
        if D is not None:
            out["D"] = D
        if _as_int(spec, "mp", 1, 4096, default=1) != 1:
            raise ValueError(
                "spec.mp is not ported yet (ROADMAP.md queue A, A.9's second "
                "half: the mesh's pair axis)")
    elif spec.get("D") is not None or spec.get("mp", 1) != 1:
        raise ValueError("spec.D/spec.mp only apply to tier='mesh'")
    compact = spec.get("compact")
    if compact is not None and compact != "auto":
        raise ValueError(
            "spec.compact has no counterpart in the port: its fused cycle "
            "compacts inside the kernel and the unfused one picks its mode "
            "from the shape (ROADMAP.md C); only 'auto' is taken")
    ms = _as_int(spec, "max_steps", 1, 1 << 31)
    if ms is not None:
        out["max_steps"] = ms
    label = spec.get("label")
    if label is not None:
        if not isinstance(label, str) or len(label) > 200:
            raise ValueError("spec.label must be a string (<= 200 chars)")
        out["label"] = label
    return out


def build_problem(spec: dict):
    """Construct the problem instance for a validated spec (scheduler and
    pool only)."""
    if spec["problem"] == "nqueens":
        from ..problems import NQueensProblem

        return NQueensProblem(N=spec["N"], g=spec["g"])
    from ..problems import PFSPProblem

    return PFSPProblem(inst=spec["inst"], lb=spec["lb"], ub=spec["ub"],
                       lb2_variant=spec.get("lb2_variant", "full"))


def job_pins(spec: dict) -> dict:
    """The process-env knobs a job pins for its slices (under the
    scheduler's ``EnvLease``). The JAX package pins ``TTS_COMPACT`` and
    ``TTS_LB2_PAIRBLOCK``; the port has neither knob and refuses both
    fields, so a port job pins nothing. Server-wide knobs are fixed at
    daemon start and part of the pool's server token."""
    return {}


def result_record(res) -> dict:
    """The serve-side result payload for a finished SearchResult — the
    counters are full-run totals even across preempted slices (the
    checkpoint seeds them), which is what makes the daemon's answer
    bit-comparable to a standalone ``tts run``."""
    rec = {
        "explored_tree": res.explored_tree,
        "explored_sol": res.explored_sol,
        "best": res.best,
        "elapsed_s": round(res.elapsed, 6),
        "complete": bool(res.complete),
    }
    # The device cycles of the slice (or batch session) that finished the
    # job, beside the counts (a key the JAX record lacks; its readers
    # ignore it).
    rec["device_cycles"] = res.diagnostics.kernel_launches
    if res.compact:
        rec["compact"] = res.compact
    if res.pipeline_depth:
        rec["pipeline_depth"] = res.pipeline_depth
    if res.k_resolved is not None:
        rec["k"] = res.k_resolved
        if res.k_auto:
            rec["k_auto"] = True
    if res.obs:
        rec["obs"] = res.obs
    if res.quality and res.quality.get("points"):
        rec["quality"] = res.quality
    if res.guard:
        # TTS_GUARD=1: the dispatches the steady-state guard checked.
        rec["guard"] = res.guard
    return rec


class Job:
    """One admitted job: the durable record plus runtime-only handles.

    Fields are mutated ONLY through ``JobRegistry`` methods (which hold
    the registry lock and persist the record); the single exception is
    ``cancel_requested``, an advisory flag the HTTP thread sets and the
    scheduler's ``yield_fn`` reads — one-writer/one-reader, staleness of
    one dispatch boundary is the designed cancellation latency."""

    def __init__(self, jid: str, spec: dict, class_key: str, pins: dict):
        self.id = jid
        self.spec = spec
        self.class_key = class_key
        self.pins = pins
        self.state = "queued"
        self.submitted = time.time()
        self.started = None
        self.finished = None
        self.slices = 0
        self.preemptions = 0
        # Cumulative RunController dispatch steps across every slice: the
        # consumed share of the spec's max_steps budget — each slice runs
        # with the remainder, so a preempted/drained/restarted max_steps
        # job finishes only when the budget is actually exhausted.
        self.steps = 0
        self.checkpoint = None  # path; set on first preemption cut
        self.result = None
        self.error = None
        self.warm_hit = False  # admitted into an already-warm class
        self.new_programs = 0  # program-cache entries this job built
        # Dispatch graphs this job built (the JAX record's name: there,
        # jit step-cache entries).
        self.new_step_compiles = 0
        # Runtime-only (not persisted):
        self.cancel_requested = False
        self.recorder = None  # per-job FlightRecorder, bound during slices
        # Per-job QualityRecorder (obs/quality.py), bound during slices;
        # spans preemptions so the trajectory covers the whole job. The
        # stream handler polls .points() for SSE `incumbent` frames.
        self.quality = None

    def record(self) -> dict:
        """The persisted/public JSON view."""
        return {
            "id": self.id,
            "spec": self.spec,
            "class": self.class_key,
            "pins": self.pins,
            "state": self.state,
            "submitted": self.submitted,
            "started": self.started,
            "finished": self.finished,
            "slices": self.slices,
            "preemptions": self.preemptions,
            "steps": self.steps,
            "checkpoint": self.checkpoint,
            "result": self.result,
            "error": self.error,
            "warm_hit": self.warm_hit,
            "new_programs": self.new_programs,
            "new_step_compiles": self.new_step_compiles,
        }

    @classmethod
    def from_record(cls, rec: dict) -> "Job":
        job = cls(rec["id"], rec["spec"], rec["class"], rec.get("pins", {}))
        for k in ("state", "submitted", "started", "finished", "slices",
                  "preemptions", "steps", "checkpoint", "result", "error",
                  "warm_hit", "new_programs", "new_step_compiles"):
            if k in rec:
                setattr(job, k, rec[k])
        return job


class JobRegistry:
    """Durable id -> Job map. Every mutation goes through a method that
    holds the lock and rewrites the job's file atomically (tmp + rename,
    the checkpoint module's convention) — a crashed daemon loses at most
    the transition in flight, never a whole record.

    Lock order: ``_io_lock`` may
    acquire ``_lock`` (``_persist`` snapshots the record inside its write
    critical section), never the reverse — every mutator releases
    ``_lock`` before calling ``_persist``."""

    def __init__(self, state_dir: str):
        self.state_dir = state_dir
        self.jobs_dir = os.path.join(state_dir, "jobs")
        os.makedirs(self.jobs_dir, exist_ok=True)
        self._lock = threading.Lock()
        # Serializes _persist's snapshot+write+rename: concurrent
        # transitions of one job (HTTP cancel vs worker) must neither
        # interleave bytes in a shared tmp file nor let an older snapshot's
        # rename land after a newer one.
        self._io_lock = threading.Lock()
        self._jobs = {}  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock

    def load(self) -> int:
        """Reload persisted records (daemon restart). Jobs that were
        queued/running when the previous daemon died come back as
        ``requeued`` — their checkpoint (if any) makes re-admission exact.
        Returns the number of records loaded."""
        n = 0
        for name in sorted(os.listdir(self.jobs_dir)):
            if not name.endswith(".json"):
                continue
            path = os.path.join(self.jobs_dir, name)
            try:
                with open(path) as f:
                    rec = json.load(f)
                job = Job.from_record(rec)
            except (OSError, ValueError, KeyError):
                continue  # truncated/alien file: skip, don't crash startup
            if job.state in ("queued", "running"):
                job.state = "requeued"
            with self._lock:
                self._jobs[job.id] = job
                # Keep new ids monotonic past every loaded one.
                try:
                    self._seq = max(self._seq, int(job.id.split("-")[-1]))
                except ValueError:
                    pass
            self._persist(job)
            n += 1
        return n

    def create(self, spec: dict, class_key: str, pins: dict,
               warm_hit: bool = False) -> Job:
        with self._lock:
            self._seq += 1
            jid = f"job-{self._seq:06d}"
            job = Job(jid, spec, class_key, pins)
            job.warm_hit = warm_hit
            self._jobs[jid] = job
        self._persist(job)
        return job

    def get(self, jid: str):
        with self._lock:
            return self._jobs.get(jid)

    def all(self) -> list:
        with self._lock:
            return sorted(self._jobs.values(), key=lambda j: j.id)

    def update(self, job: Job, **fields) -> None:
        """Apply field updates under the lock, then persist."""
        with self._lock:
            for k, v in fields.items():
                setattr(job, k, v)
        self._persist(job)

    def transition(self, job: Job, state: str, **fields) -> None:
        assert state in STATES, state
        self._stamp(job, state, fields)
        self.update(job, state=state, **fields)

    def transition_if(self, job: Job, from_states, state: str,
                      **fields) -> bool:
        """Compare-and-swap transition: applies (and persists) only while
        the job is still in one of ``from_states``. This is what keeps a
        racing cancel and a worker's queue pop coherent — whichever CAS
        wins, the loser no-ops instead of resurrecting a terminal state."""
        assert state in STATES, state
        self._stamp(job, state, fields)
        with self._lock:
            if job.state not in from_states:
                return False
            job.state = state
            for k, v in fields.items():
                setattr(job, k, v)
        self._persist(job)
        return True

    @staticmethod
    def _stamp(job: Job, state: str, fields: dict) -> None:
        now = time.time()
        if state == "running" and job.started is None:
            fields.setdefault("started", now)
        if state in ("done", "failed", "cancelled"):
            fields.setdefault("finished", now)

    def _persist(self, job: Job) -> None:
        path = os.path.join(self.jobs_dir, f"{job.id}.json")
        # Thread-unique tmp name AND one writer at a time: snapshotting
        # under the registry lock inside the io critical section means the
        # last rename to land is always the newest record — a restart never
        # loads a torn or stale-ordered file.
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with self._io_lock:
            with self._lock:
                rec = job.record()
            with open(tmp, "w") as f:
                json.dump(rec, f)
            os.replace(tmp, path)
