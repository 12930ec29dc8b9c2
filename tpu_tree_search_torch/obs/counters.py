"""On-device cycle counters for the resident engine (``TTS_OBS=1``) — the
port of `tpu_tree_search/obs/counters.py`.

The resident engine runs up to K cycles a dispatch on the device, so the
per-cycle dynamics (pops, prunes, pool occupancy) are invisible to the host
by design. This module adds a small fixed-shape counter block, updated after
every cycle ON THE DEVICE and read only at the dispatch boundaries, where
the host already reads the loop state:

  * the fused and streamed cycles (one CUDA graph a dispatch): the graph's
    last body node is ``dispatch_cond_obs`` (`csrc/dispatch_graph.cu`) in
    place of ``dispatch_cond``, and the block lives in the loop state
    ``st[ST_CTR:]`` (`ops/cycle.py`), so the one copy of ``st`` into the
    host's pinned slot carries it;
  * the unfused cycle folds each cycle with ``update`` from the values it
    already reads, and writes the block into ``st`` once a dispatch.

Disabled path: the engine builds its graphs on the flag (``TTS_OBS`` and
``TTS_PHASEPROF``, keys of its graph cache); off, the graph has the same
nodes as a build without this module.

Slot semantics (``SLOTS`` order; int32 on the device, reset each dispatch):

  * ``popped``    — parents popped (sum of per-cycle ``cnt``);
  * ``pushed``    — children pushed (== exploredTree increments);
  * ``leaves``    — solutions counted (== exploredSol increments);
  * ``pruned``    — candidate child slots neither pushed nor leaves:
                    ``cnt * child_slots - pushed - leaves`` (includes the
                    closed slots of deep PFSP parents);
  * ``overflow``  — cycles that took the overflow branch (survivors past
                    the compaction budget S). The fused cycle has no such
                    branch (its condition reserves M*n rows): 0 there, where
                    the JAX one-kernel cycle counts ``tree_inc > S``;
  * ``pool_hwm``  — high-water mark of the pool size after the push;
  * ``surv_hwm``  — high-water mark of per-cycle survivors;
  * ``push_rows`` — rows the push stage processed: M*n a fused cycle (as
                    the JAX one-kernel cycle reports it), S a fitting
                    unfused cycle and M*n an overflowing one.

Counter headroom rides the engine's K clamp (``K*M*n < 2**31`` a dispatch);
the host accumulates across dispatches in Python ints.
"""

from __future__ import annotations

import os

from .phases import phase_profiling_enabled

SLOTS = (
    "popped",
    "pushed",
    "leaves",
    "pruned",
    "overflow",
    "pool_hwm",
    "surv_hwm",
    "push_rows",
)
NSLOTS = len(SLOTS)

#: SLOTS index lookup, e.g. ``IDX["pushed"]``.
IDX = {name: i for i, name in enumerate(SLOTS)}

#: Slots accumulated as running maxima (the rest add).
_MAX_SLOTS = frozenset((IDX["pool_hwm"], IDX["surv_hwm"]))


def device_counters_enabled() -> bool:
    """True for ``TTS_OBS=1`` (full mode), and under ``TTS_PHASEPROF=1``,
    whose roofline floors are the counters' totals (`obs/roofline.py`).
    ``TTS_OBS=host`` records host events and leaves the graphs as they
    are."""
    return (os.environ.get("TTS_OBS", "0") == "1"
            or phase_profiling_enabled())


def update(ctr, cnt: int, n: int, tree_inc: int, sol_inc: int,
           overflow: bool, size: int, push_rows: int) -> list[int]:
    """One cycle folded into a block (a sequence of ``NSLOTS`` ints): the
    plain per-cycle update (``obs_counters.update`` of the JAX package, and
    what ``dispatch_cond_obs`` computes with ``overflow`` False and
    ``push_rows`` M*n). ``size`` is the pool size after the push."""
    c = list(ctr)
    inc = (cnt, tree_inc, sol_inc, cnt * n - tree_inc - sol_inc,
           1 if overflow else 0, 0, 0, push_rows)
    hwm = (0, 0, 0, 0, 0, size, tree_inc, 0)
    return [max(a + b, h) for a, b, h in zip(c, inc, hwm)]


def merge_host(total: dict | None, block) -> dict:
    """Host-side accumulation of one harvested block (a sequence of
    ``NSLOTS`` ints, or a list of such blocks) into a running totals dict
    — adds the additive slots, maxes the high-water marks."""
    rows = block if block and isinstance(block[0], (list, tuple)) else [block]
    out = dict(total) if total else {name: 0 for name in SLOTS}
    for i, name in enumerate(SLOTS):
        col = [int(r[i]) for r in rows]
        if i in _MAX_SLOTS:
            out[name] = max(out[name], max(col))
        else:
            out[name] = out[name] + sum(col)
    return out


def as_args(block) -> dict:
    """A harvested block as a {slot: int} dict for counter events and
    metrics lines."""
    return merge_host(None, block)


# -- program contracts (`check`, analysis/contracts.py) ------------------------

from ..analysis.contracts import contract  # noqa: E402


def _cond(record) -> str:
    """The dispatch's loop-condition node (the body's last entry, where it
    is a graph node; "" where the cycle sets the condition itself)."""
    from ..analysis.contracts import GRAPH_NODES

    last = record.body[-1].name if record.body else ""
    return last if last in GRAPH_NODES else ""


@contract(
    "obs-off-identity",
    claim="TTS_OBS unset, =0 and =host record the same dispatch and, on "
          "the card, the same graph, with no counter block: the program's "
          "counters are off, the fused cycle sets the loop condition itself "
          "(no condition node) and the unfused one is followed by "
          "dispatch_cond — the block is built out when off, never branched "
          "(host mode touches no device program)",
    artifact="variants",
)
def _contract_obs_off_identity(art, cell):
    if not art.has("off", "obs0", "obs-host"):
        return []
    out = []
    if not (art.text("off") == art.text("obs0") == art.text("obs-host")):
        out.append("TTS_OBS unset/0/host record different programs (the "
                   "off path must be one program)")
    off = art.variants["off"]
    if off.meta.get("obs") or _cond(off) != ("" if art.fused
                                             else "dispatch_cond"):
        out.append("the off build carries the counter block (armed "
                   f"{off.meta.get('obs')}, condition {_cond(off)}): the "
                   "off graph must be the untelemetered one")
    return out


@contract(
    "obs-counter-block",
    claim="TTS_OBS=1 builds a distinct program: on the fused cycle the same "
          "cycle entries with dispatch_cond_obs as the body's last node (the "
          "off body has none: its cycle sets the condition); the unfused "
          "cycle folds its own block (fold=False: its ops grow, the last "
          "node stays dispatch_cond)",
    artifact="variants",
)
def _contract_obs_counter_block(art, cell):
    if not art.has("off", "obs1"):
        return []
    off, on = art.variants["off"], art.variants["obs1"]
    out = []
    if art.text("off") == art.text("obs1") or not on.meta.get("obs"):
        out.append("TTS_OBS=1 recorded the off program (the counter block "
                   "is not armed)")
    want = "dispatch_cond_obs" if art.fused else "dispatch_cond"
    if _cond(on) != want:
        out.append(f"armed condition {_cond(on)}, expected {want}")
    if art.fused and ([e.text for e in on.cycle_entries()]
                      != [e.text for e in off.cycle_entries()]):
        out.append("the fused cycle's entries changed under TTS_OBS=1 (only "
                   "the condition node may)")
    if not art.fused and len(on.body) <= len(off.body):
        out.append("the unfused cycle folds no counter block under "
                   "TTS_OBS=1")
    if on.nodes is not None and on.nodes["body"]:
        last = on.nodes["body"][-1][0]
        if want not in last or (not art.fused and "obs" in last):
            out.append(f"armed graph's last body node {last}, expected "
                       f"{want}")
    return out
