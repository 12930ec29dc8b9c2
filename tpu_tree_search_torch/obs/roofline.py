"""Memory-roofline audit of the resident cycle — the port of
`tpu_tree_search/obs/roofline.py`.

Every phase of the cycle moves rows of the pool, so the question a phase
answers is what share of the memory-bound peak its measured time reaches:

    pct_of_peak = byte FLOOR of the run / (peak bytes/s * phase seconds)

  * measured per-phase ns — the phase clock (``TTS_PHASEPROF=1``,
    `obs/phases.py`), summed over the run;
  * the byte floor — from the counter block's totals (`obs/counters.py`;
    armed with the clock): the bytes the phase must move for THIS run's
    data, counted once each:

      - ``pop``: the popped rows read (``popped`` rows of
        ``n * itemsize + aux_itemsize`` bytes);
      - ``eval``: the popped rows read by the bound (the fused cycles pop
        inside their bounds launch, so their ``pop`` charges no time);
      - ``compact``: one keep bit a child slot (``pushed + leaves +
        pruned`` slots, rounded up to bytes) — the least any compaction
        reads;
      - ``push``: the pushed rows written (``pushed`` rows);
      - ``overflow``: 0 (the floor cannot apportion the overflow cycles'
        rows from totals; its row reports time alone).

    The JAX floors charge M rows a cycle and S survivors a push — the TPU
    program's whole-tile traffic. The port's kernels read ``cnt`` rows and
    write only the survivors, so those floors can exceed what the card
    moved and read above 100%; these cannot;
  * peak bytes/s — ``TTS_HBM_GBPS`` (explicit), a measured cost-model
    ``hbm`` link (``links.hbm.per_sec``), then the nominal table below.

Surfaces: ``report --roofline`` (from the ``roofline_meta`` event, the
``device_phases`` and ``device_counters`` samples of a trace),
``SearchResult.roofline`` (whenever the clock ran) and the CLI record's
``roofline_mem``.
"""

from __future__ import annotations

import os

from . import phases as obs_phases

#: Nominal peak device-memory rate by backend, GB/s — the last resort when
#: neither ``TTS_HBM_GBPS`` nor a measured cost-model ``hbm`` link is
#: available:
#:
#:   * ``gpu`` 3350.0 — NVIDIA H100 SXM data sheet (80 GB HBM3 at
#:     3.35 TB/s, at its 700 W power limit; a card set lower runs slower);
#:   * ``cpu`` 40.0 — dual-channel DDR4-3200 (25.6) plus margin, so CPU
#:     tables stay finite and plainly not a card's.
NOMINAL_GBPS = {"gpu": 3350.0, "cpu": 40.0}

#: The cycle phases the audit rows cover (obs/phases.py CYCLE_SLOTS).
PHASES = obs_phases.CYCLE_SLOTS


def hbm_gbps_override() -> float | None:
    """The ``TTS_HBM_GBPS`` knob: explicit peak-bandwidth override (GB/s)."""
    raw = os.environ.get("TTS_HBM_GBPS")
    if raw is None or raw == "":
        return None
    v = float(raw)
    if v <= 0:
        raise ValueError(f"TTS_HBM_GBPS must be a positive GB/s figure, "
                         f"got {raw!r}")
    return v


def hbm_entry(profile: dict, backend: str) -> dict | None:
    """First profile entry (sorted) on ``backend`` that carries a measured
    ``hbm`` link fit — a property of the card, not of the problem."""
    for key in sorted(profile):
        e = profile[key]
        if not isinstance(e, dict) or e.get("backend") != backend:
            continue
        hbm = (e.get("links") or {}).get("hbm")
        if isinstance(hbm, dict) and hbm.get("per_sec"):
            return e
    return None


def peak_bytes_per_sec(backend: str, entry: dict | None = None
                       ) -> tuple[float, str]:
    """The roofline denominator: (bytes/s, source) — the env override, then
    a measured cost-model ``hbm`` link, then the nominal table."""
    env = hbm_gbps_override()
    if env is not None:
        return env * 1e9, "env:TTS_HBM_GBPS"
    if entry is not None:
        hbm = (entry.get("links") or {}).get("hbm")
        if isinstance(hbm, dict) and hbm.get("per_sec"):
            return float(hbm["per_sec"]), "costmodel:hbm"
    gbps = NOMINAL_GBPS.get(backend, NOMINAL_GBPS["cpu"])
    return gbps * 1e9, f"nominal:{backend}"


def phase_byte_floors(counters: dict, *, n: int, itemsize: int,
                      aux_itemsize: int) -> dict[str, int]:
    """The run's byte floor of each phase from its counter totals (see the
    module docstring)."""
    node = n * itemsize + aux_itemsize
    popped = int(counters.get("popped", 0))
    pushed = int(counters.get("pushed", 0))
    slots = pushed + int(counters.get("leaves", 0)) + int(
        counters.get("pruned", 0))
    return {
        "pop": popped * node,
        "eval": popped * node,
        "compact": -(-slots // 8),
        "push": pushed * node,
        "overflow": 0,
    }


def audit(phase_ns: dict, cycles: int, floors: dict, *, peak_bps: float,
          peak_source: str = "") -> dict:
    """The roofline document: per-phase measured ns, byte floor, achieved
    GB/s and %-of-peak. A phase with no measured time or no floor reports
    ns only (no percentage)."""
    rows = []
    for slot in PHASES:
        ns = int(phase_ns.get(slot, 0) or 0)
        nbytes = int(floors.get(slot, 0))
        row: dict = {"phase": slot, "ns": ns, "bytes": nbytes}
        if ns > 0 and nbytes > 0:
            sec = ns / 1e9
            row["gbps"] = round(nbytes / sec / 1e9, 2)
            row["pct_of_peak"] = round(100.0 * nbytes / (peak_bps * sec), 1)
        rows.append(row)
    return {
        "peak_gbps": round(peak_bps / 1e9, 1),
        "peak_source": peak_source,
        "cycles": int(cycles),
        "phases": rows,
    }


def table(doc: dict) -> list[str]:
    """Render an audit document as the ``report --roofline`` table."""
    lines = [
        f"  roofline (peak {doc['peak_gbps']} GB/s, "
        f"{doc['peak_source']}; {doc['cycles']} cycles):",
        "    phase       time_ms     floor_MB    GB/s     % of peak",
    ]
    for row in doc["phases"]:
        ms = row["ns"] / 1e6
        mb = row["bytes"] / 2**20
        if "pct_of_peak" in row:
            tail = f"{row['gbps']:>8.2f}  {row['pct_of_peak']:>8.1f}%"
        else:
            tail = f"{'-':>8}  {'-':>9}"
        lines.append(
            f"    {row['phase']:<10}{ms:>10.2f}{mb:>13.2f}{tail}"
        )
    return lines


# -- engine/report adapters -------------------------------------------------


def meta_args(program) -> dict:
    """The ``roofline_meta`` event payload the resident loop emits: the
    static shape facts (the JAX package's keys, so its ``report`` reads a
    port trace) that rebuild the floors from a trace."""
    return {
        "M": int(program.M),
        "n": int(program.problem.child_slots),
        "S": int(program.S),
        "itemsize": int(program.vals_dtype.itemsize),
        "aux_itemsize": int(program.aux_dtype.itemsize),
        "megakernel": bool(program.fused),
        "megakernel_mt": int(program.mt or 0),
        "megakernel_grid": int(program.M // program.mt) if program.mt else 0,
        "backend": "gpu" if program.device.type == "cuda" else "cpu",
        "floors": "counters",
    }


def from_meta(meta: dict, phase_ns: dict, cycles: int,
              costmodel: dict | None = None,
              counters: dict | None = None) -> dict | None:
    """The audit from a ``roofline_meta`` args dict, phase totals and
    counter totals — the shared path of ``report --roofline`` and
    ``SearchResult.roofline``. None without phase time or counters."""
    if not phase_ns or not counters or cycles <= 0:
        return None
    backend = meta.get("backend") or "cpu"
    entry = hbm_entry(costmodel, backend) if costmodel else None
    peak, src = peak_bytes_per_sec(backend, entry)
    floors = phase_byte_floors(
        counters, n=int(meta["n"]), itemsize=int(meta.get("itemsize", 4)),
        aux_itemsize=int(meta.get("aux_itemsize", 4)))
    return audit(phase_ns, cycles, floors, peak_bps=peak, peak_source=src)


def result_audit(program, phase_ns: dict | None, counters: dict | None,
                 cycles: int) -> dict | None:
    """The ``SearchResult.roofline`` payload: the finished run's phase and
    counter totals against the resolved peak (the cost-model profile when
    ``TTS_COSTMODEL`` names one)."""
    if not phase_ns or not counters or cycles <= 0:
        return None
    from . import costmodel as CM

    prof = None
    path = CM.costmodel_path()
    if path:
        prof = CM.load(path)
    return from_meta(meta_args(program), phase_ns, cycles, costmodel=prof,
                     counters=counters)
