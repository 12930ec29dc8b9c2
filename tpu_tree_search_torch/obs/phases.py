"""On-device per-phase cycle clocks (``TTS_PHASEPROF=1``) — the port of
`tpu_tree_search/obs/phases.py`.

The counters (``counters.py``) count WORK per dispatch; this leg measures
TIME per phase inside the dispatch: which of pop / bound evaluation /
compaction / push / overflow dominates a cycle.

Design — the counter-block pattern with a clock instead of an adder:

  * one int64 block of ``BLOCK_LEN`` slots: per-phase nanoseconds in
    ``SLOTS`` order, then the last reading (``TPREV``) and the cycle's first
    reading (``T0``); a seed mark zeroes it at the start of each dispatch
    and the host reads it once a dispatch, beside the loop state;
  * the clock is read ON THE DEVICE: the ``phase_mark`` kernel
    (`csrc/phase_clock.cuh`) reads PTX ``%globaltimer`` (64-bit ns), so no
    boundary costs a host round trip (the JAX clock is a host callback —
    the seam its docstring leaves for a device cycle counter). A mark
    sits on the stream between two launches of the cycle, so a reading
    is taken when the launch before it has finished;
  * phase deltas telescope: within a cycle the same readings bound
    adjacent phases, so ``pop + eval + compact + push + overflow ==
    total`` holds EXACTLY (tests pin it); the time between the last mark
    of one cycle and the first of the next (the ``dispatch_cond`` node and
    the graph's node latency, or the host loop of the unfused cycle) lands
    in ``loop``, outside ``total``. 64 bits: no wrap (the JAX block is
    uint32).

Which slots a cycle charges (the marks its launcher enqueues):

  * the fused and streamed PFSP cycles (bounds | count | emit): ``eval``,
    ``compact``, ``push`` — the pop is inside the bounds launch, and there
    is no overflow branch;
  * the fused and streamed N-Queens cycles (labels | emit): ``eval``,
    ``push`` — the labels launch also publishes the block counts;
  * the unfused cycle (torch pop, bound kernels, ``compact_ids``, push or
    overflow): all five; ``balance`` belongs to the mesh tiers.

On the CPU the plain mark reads ``time.perf_counter_ns`` at the same
boundaries. Each mark is one more launch (a graph node), which is why the
armed graphs are a separate, cache-keyed variant: a profiling build, never
the headline measurement. Shares are attribution estimates; the telescoped
``total`` and unchanged search counts are the hard guarantees.

The steady-state trace window is a ``torch.profiler`` capture
(``TTS_TORCH_TRACE=DIR`` / ``--torch-trace DIR``), in place of the JAX
package's XLA trace.
"""

from __future__ import annotations

import os
import threading

#: Phase slots (the JAX package's order). The first five partition the
#: cycle exactly (``total`` is their telescoped sum); ``balance`` (mesh
#: tiers) and ``loop`` (between cycles) sit outside the cycle.
SLOTS = (
    "pop",       # chunk pop (its own launches on the unfused cycle only)
    "eval",      # bound evaluation (lb1/lb1_d/lb2/N-Queens labels)
    "compact",   # survivor ranks (compact_ids; the fused count launch)
    "push",      # survivor push (fits == True cycles; the fused emit)
    "overflow",  # overflow-branch push (fits == False unfused cycles)
    "balance",   # mesh tiers (the balance step)
    "loop",      # between cycles: the condition node, the host loop
    "total",     # per-cycle end - start (== pop+eval+compact+push+overflow)
)
NSLOTS = len(SLOTS)

#: SLOTS index lookup, e.g. ``IDX["compact"]``.
IDX = {name: i for i, name in enumerate(SLOTS)}

#: Block index of the last clock reading, and of the cycle's first one.
TPREV = NSLOTS
T0 = NSLOTS + 1
#: Length of the int64 clock block.
BLOCK_LEN = NSLOTS + 2

#: Mark flags (`csrc/phase_clock.cuh`): the cycle's first mark, its last,
#: a dispatch's seed.
OPEN, CLOSE, SEED = 1, 2, 4

#: The slots that partition the cycle (their sum == ``total``).
CYCLE_SLOTS = ("pop", "eval", "compact", "push", "overflow")


def phase_profiling_enabled() -> bool:
    """True only for ``TTS_PHASEPROF=1`` — the armed graph variant."""
    return os.environ.get("TTS_PHASEPROF", "0") == "1"


def merge_host(total: dict | None, block) -> dict:
    """Host-side accumulation of one harvested block (a sequence of
    ``BLOCK_LEN`` ints, or of ``NSLOTS`` — the readings are not phases)
    into running per-phase nanosecond totals (Python ints)."""
    vals = list(block)
    out = dict(total) if total else {name: 0 for name in SLOTS}
    for i, name in enumerate(SLOTS):
        out[name] = out.get(name, 0) + int(vals[i])
    return out


def as_args(block) -> dict:
    """A harvested block as a {slot: ns} dict for counter events and
    metrics lines."""
    return merge_host(None, block)


def shares(totals: dict) -> dict:
    """Per-phase share of the measured cycle time: each slot over
    ``total`` (``balance``/``loop`` are outside the cycle and can exceed
    1.0)."""
    t = max(1, int(totals.get("total", 0)))
    return {
        name: totals.get(name, 0) / t
        for name in SLOTS if name != "total"
    }


def dominant_phase(totals: dict | None) -> tuple[str, float] | None:
    """(name, share) of the largest in-cycle phase — the "next structural
    cost" line of ``report``/``profile``. None without data."""
    if not totals or not totals.get("total"):
        return None
    name = max(CYCLE_SLOTS, key=lambda s: totals.get(s, 0))
    return name, totals.get(name, 0) / max(1, int(totals["total"]))


def decomp(totals: dict) -> dict:
    """The decomposition record ``report``/``profile`` render: raw ns,
    cycle shares, and the dominant in-cycle phase."""
    dom = dominant_phase(totals)
    return {
        "ns": {k: int(v) for k, v in totals.items()},
        "shares": {k: round(v, 4) for k, v in shares(totals).items()},
        "dominant": dom[0] if dom else None,
        "dominant_share": round(dom[1], 4) if dom else None,
    }


# -- the steady-state torch.profiler window (`profile` / --torch-trace) -------

#: Dispatch boundaries to skip before the window opens: the first dispatch
#: carries the graph build.
TRACE_SKIP_DISPATCHES = 1


def torch_trace_dir() -> str | None:
    """``TTS_TORCH_TRACE=<dir>`` — arm a steady-state ``torch.profiler``
    capture around the dispatch window (CLI: ``--torch-trace DIR``)."""
    return os.environ.get("TTS_TORCH_TRACE") or None


class TorchTraceWindow:
    """Steady-state ``torch.profiler`` bracket around phase 2.

    The engine calls ``on_dispatch(seq)`` once a consumed dispatch and
    ``close()`` when phase 2 ends: the capture opens after
    ``TRACE_SKIP_DISPATCHES`` dispatches and, on close, writes
    ``<dir>/torch_trace.json`` (a Chrome trace of the host and the card).
    The profiler is process-global: one window at a time."""

    _active_lock = threading.Lock()
    _active: "TorchTraceWindow | None" = None

    def __init__(self, tier: str, out_dir: str | None = None):
        self.tier = tier
        self.dir = out_dir if out_dir is not None else torch_trace_dir()
        self.started = False
        self._prof = None
        self._owner = False
        if self.dir:
            with TorchTraceWindow._active_lock:
                if TorchTraceWindow._active is None:
                    TorchTraceWindow._active = self
                    self._owner = True

    def on_dispatch(self, seq: int, launches: int = 0,
                    ahead: int = 0) -> None:
        """A consumed dispatch (``seq`` from 1): ``launches``, the graph-body
        launches it ran, and ``ahead``, the most the dispatches in flight
        and the next one can add, step the ``--profile`` trace
        (``SessionTrace``) too."""
        session = SessionTrace.active()
        if session is not None:
            session.on_dispatch(launches, ahead)
        if (not self._owner or self.started
                or seq < TRACE_SKIP_DISPATCHES + 1):
            return
        from torch.profiler import ProfilerActivity, profile

        import torch

        from . import events as ev

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(self.dir, exist_ok=True)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.started = True
        ev.emit("torch_trace", args={"dir": self.dir, "tier": self.tier,
                                     "after_dispatch": seq - 1})

    def close(self) -> None:
        if self.started:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            self._prof.export_chrome_trace(
                os.path.join(self.dir, "torch_trace.json"))
            self.started = False
            self._prof = None
        if self._owner:
            with TorchTraceWindow._active_lock:
                if TorchTraceWindow._active is self:
                    TorchTraceWindow._active = None
            self._owner = False


# -- the whole-session torch.profiler capture (--profile) ----------------------

#: The graph-body launches a ``--profile`` trace records at most: a traced
#: process past about 300,000 such records ended in an illegal address on
#: the H100, and one stopped at 267,020 ran clean (ROADMAP C). A bound on
#: the tool, not a repair.
PROFILE_BUDGET = 200_000


def profile_k_cap(launches: int, depth: int, budget: int) -> int:
    """The most cycles a dispatch may run under ``--profile``: the ``depth``
    dispatches in flight before the first read, each of up to K runs of a
    body of ``launches`` nodes, stay within ``budget``. At least 1."""
    return max(1, budget // max(1, depth * launches))


def profile_cut(traced: int, ahead: int, budget: int) -> bool:
    """Whether a ``--profile`` trace stops at this dispatch boundary: the
    ``traced`` graph-body launches of the dispatches read so far and the
    ``ahead`` that the dispatches in flight and the next one can add pass
    ``budget``."""
    return traced + ahead > budget


class SessionTrace:
    """``--profile DIR``: ``torch.profiler`` over the whole session (the
    host, and the card with ``cuda``), its Chrome trace written to
    ``DIR/torch_profile.json`` when the block ends.

    On the graph-dispatched resident tier the engine caps K (``k_cap``) and
    steps the trace at each consumed dispatch (``TorchTraceWindow.
    on_dispatch``): recording stops, after the card has finished what is in
    flight, at the first boundary past which the traced graph-body launches
    could pass the budget (``profile_cut``); the rest of the session runs
    untraced. ``summary`` says which dispatches the trace holds. The
    profiler is process-global: one session trace at a time."""

    _active_lock = threading.Lock()
    _active: "SessionTrace | None" = None

    def __init__(self, out_dir: str, cuda: bool):
        self.path = os.path.join(out_dir, "torch_profile.json")
        self.cuda = cuda
        self.budget = PROFILE_BUDGET
        self.dispatches = 0  # consumed in the session
        self.traced_dispatches = 0  # of them, read while recording
        self.traced = 0  # their graph-body launches
        self.recording = False
        self._prof = None

    @classmethod
    def active(cls) -> "SessionTrace | None":
        return cls._active

    def __enter__(self) -> "SessionTrace":
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        with SessionTrace._active_lock:
            if SessionTrace._active is not None:
                raise RuntimeError("a --profile trace is already recording")
            SessionTrace._active = self
        self._prof = profile(activities=acts)
        self._prof.start()
        self.recording = True
        return self

    def __exit__(self, *exc) -> None:
        try:
            self.stop()
            self._prof.export_chrome_trace(self.path)
        finally:
            with SessionTrace._active_lock:
                SessionTrace._active = None

    def k_cap(self, launches: int, depth: int) -> int:
        """The K cap of a search whose body runs ``launches`` nodes with
        ``depth`` dispatches in flight."""
        return profile_k_cap(launches, depth, self.budget)

    def on_dispatch(self, launches: int, ahead: int) -> None:
        self.dispatches += 1
        if not self.recording:
            return
        self.traced += launches
        self.traced_dispatches = self.dispatches
        if profile_cut(self.traced, ahead, self.budget):
            self.stop()

    def stop(self) -> None:
        """Stop recording (the card's work in flight finished first)."""
        if not self.recording:
            return
        if self.cuda:
            import torch

            torch.cuda.synchronize()
        self._prof.stop()
        self.recording = False

    def summary(self) -> str:
        return (f"dispatches 1..{self.traced_dispatches} of {self.dispatches} "
                f"traced, {self.traced} graph-body launches, budget "
                f"{self.budget}")


# -- program contracts (`check`, analysis/contracts.py) ------------------------

from ..analysis.contracts import contract  # noqa: E402


def _marks(entries) -> int:
    return sum(1 for e in entries if e.name == "phase_mark_cuda")


@contract(
    "phaseprof-off-identity",
    claim="TTS_PHASEPROF unset and =0 record the same dispatch with no "
          "clock: the phase-clock marks are built out when off, never "
          "branched (as the counter block)",
    artifact="variants",
)
def _contract_phaseprof_off_identity(art, cell):
    if not art.has("off", "phase0"):
        return []
    out = []
    if art.text("off") != art.text("phase0"):
        out.append("TTS_PHASEPROF=0 build differs from the unset build")
    if art.variants["off"].meta.get("phaseprof") or _marks(
            art.variants["off"].entries):
        out.append("the off build carries phase marks")
    return out


@contract(
    "phaseprof-block-leaf",
    claim="the armed phase clock adds the seed mark before the while node "
          "and the marks between the cycle's launches (`chip_smoke.py` "
          "want_body: the fused cycle's marks ride inside its wrapper, one "
          "more than its launches; the unfused cycle marks loop, pop, eval, "
          "compact and push-or-overflow) — a distinct program, with the "
          "counter block armed beside it",
    artifact="variants",
)
def _contract_phaseprof_block(art, cell):
    if not art.has("off", "phase1", "phase1-obs1"):
        return []
    off, on = art.variants["off"], art.variants["phase1"]
    out = []
    if art.text("off") == art.text("phase1"):
        out.append("TTS_PHASEPROF=1 recorded the off program")
    if _marks(on.outer) != 1:
        out.append(f"{_marks(on.outer)} seed marks before the while node "
                   "(expected 1)")
    want = 0 if art.fused else 5
    if _marks(on.body) != want:
        out.append(f"{_marks(on.body)} marks in the recorded cycle "
                   f"(expected {want})")
    if not on.meta.get("obs"):
        out.append("the armed clock runs without its counter block")
    if art.text("phase1") != art.text("phase1-obs1"):
        out.append("TTS_PHASEPROF=1 with and without TTS_OBS=1 differ (the "
                   "clock arms the counters)")
    if on.nodes is not None:
        body = [nm for nm, _ in on.nodes["body"]]
        clock = sum("phase_mark" in nm for nm in body)
        launches = sum(1 for nm in body if "phase_mark" not in nm
                       and "dispatch_cond" not in nm)
        if art.fused and clock != launches + 1:
            out.append(f"fused body of {launches} launches holds {clock} "
                       "marks (want one more than its launches)")
        if not art.fused and clock != 5:
            out.append(f"unfused body holds {clock} marks (want 5)")
    return out
