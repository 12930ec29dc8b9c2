"""Search result/report structures (the port's copy of
`tpu_tree_search/engine/results.py`, cut to the fields this package fills).

Reproduces the reference's self-reported metrics: exploredTree, exploredSol,
optimum, elapsed time, the 3-phase breakdown of the offload tiers
(`nqueens_gpu_chpl.chpl:178-245`), and offload diagnostics counters
(GpuDiagnostics equivalent, `pfsp_gpu_chpl.chpl:454-466`).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PhaseStats:
    """One phase's deltas (`res1/res2/res3`, `nqueens_gpu_chpl.chpl:178-245`)."""

    seconds: float = 0.0
    tree: int = 0
    sol: int = 0


@dataclass
class Diagnostics:
    """Offload counters (Chapel GpuDiagnostics: kernel_launch /
    host_to_device / device_to_host, `nqueens_gpu_chpl.chpl:278-283`).
    """

    kernel_launches: int = 0
    host_to_device: int = 0
    device_to_host: int = 0
    # Offload: dispatches made while another was still in flight (their
    # H2D and evaluation overlapped the host's branching of the previous
    # chunk; `tpu_tree_search/engine/results.py:35`).
    double_buffered: int = 0


@dataclass
class SearchResult:
    explored_tree: int = 0
    explored_sol: int = 0
    best: int | None = None  # final incumbent (PFSP optimum)
    elapsed: float = 0.0
    phases: list[PhaseStats] = field(default_factory=list)
    diagnostics: Diagnostics = field(default_factory=Diagnostics)
    # False when a max_steps cutoff or a yield_fn ended the run early
    # (engine/checkpoint.py); the counts are then those up to the cut.
    complete: bool = True
    # Resident tier: dispatches the run controller counted (the unit of
    # max_steps).
    steps: int = 0
    # The device tier's engine: "resident" or "offload" (device_search);
    # None on the sequential tier.
    engine: str | None = None
    # Resident tier: the survivor-path compaction mode of the unfused
    # cycle ("dense"/"scatter"); None on the fused cycle, which compacts
    # inside its kernel.
    compact: str | None = None
    # Resident tier: which cycle ran (the fused CUDA cycle or the unfused
    # bound-kernel + torch compaction cycle), the chunk size M and cycles
    # per dispatch K it ran with, the K-cycle dispatches it made, and how
    # often the pool filled past the fan-out headroom and the host
    # offload fallback ran.
    fused: bool = True
    # Resident tier, PFSP lb2: whether the unfused cycle ran the staged
    # evaluator (lb1 prefilter, then lb2 of the compacted candidates).
    staged: bool = False
    # Resident tier, fused cycle: the tile width Mt of the cycle; below M the
    # chunk was streamed in M // Mt tiles, at M it was the single-tile cycle.
    # None on the unfused cycle, which has no tiles.
    megakernel_mt: int | None = None
    M: int | None = None
    k_resolved: int | None = None
    dispatches: int = 0
    stall_fallbacks: int = 0
    # Resident tier: the dispatch-pipeline depth the host loop ran with
    # (TTS_PIPELINE: 1 = synchronous, >= 2 = speculative), and whether
    # TTS_K=auto (or K="auto") resolved K, which then is the K the loop
    # ended on (`tpu_tree_search/engine/results.py:106-108`).
    pipeline_depth: int = 1
    k_auto: bool = False
    # Resident tier, fused cycle on the card: seconds spent building the
    # dispatch graphs (one a K rung, `ops/dispatch.py`), inside phase 2.
    graph_build_s: float = 0.0
    # Resident tier, fused cycle on the card: the dispatches' device time,
    # CUDA events around each graph launch (the graph's nodes and the
    # latency between them), summed; None off the graph.
    dispatch_device_s: float | None = None
    # Telemetry (`obs/`; `tpu_tree_search/engine/results.py:96-129`):
    # ``obs`` — the counter totals (``device_counters``, TTS_OBS=1) and the
    # per-phase ns totals (``device_phases``); ``phase_profile`` — the
    # per-phase ns totals alone (TTS_PHASEPROF=1); ``roofline`` — the
    # memory-roofline audit of a phase-profiled run (`obs/roofline.py`);
    # ``quality`` — the incumbent trajectory (TTS_QUALITY=1,
    # `obs/quality.py`). None when not armed.
    obs: dict | None = None
    phase_profile: dict | None = None
    roofline: dict | None = None
    quality: dict | None = None
    # Multi-device tiers (`tpu_tree_search/engine/results.py:47,59`): each
    # worker's (multi) or shard's (mesh) explored nodes
    # (`pfsp_multigpu_chpl.chpl:518-522`), and the multi tier's successful
    # work steals (declared by the reference, never reported).
    per_worker_tree: list[int] = field(default_factory=list)
    steals: int = 0
    # Multi-host tiers (`tpu_tree_search/engine/results.py:60-69`): the
    # inter-host communicator's totals summed over the hosts (exchange
    # rounds, donation blocks and nodes sent and received, and the seconds
    # its exchange allgathers took), and the resolved steal policy
    # (`parallel/topology.py` ``StealPolicy.describe``).
    comm: dict | None = None
    steal_policy: dict | None = None
    # Resident loops under the steady-state guard (TTS_GUARD=1, `analysis/
    # guard.py` ``guard_record``): the warm and the checked dispatches and
    # the checks that ran (with what was not checked); None when off.
    guard: dict | None = None

    def workload_shares(self) -> list[float]:
        """Per-worker share of explored nodes in percent (the load-balance
        report, `nqueens_multigpu_chpl.chpl:337`)."""
        total = sum(self.per_worker_tree)
        if not total:
            return []
        return [100.0 * t / total for t in self.per_worker_tree]
