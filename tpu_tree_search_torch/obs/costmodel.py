"""Measured cost-model profiles (``COSTMODEL.json``) — the port of
`tpu_tree_search/obs/costmodel.py`, with the profile format and key scheme
unchanged (the port's backend key is ``gpu`` on the card, ``cpu`` on the
CPU).

The controllers that pace every host loop — AdaptiveK's target host-period
band (engine/pipeline.py) and, through it, the mesh/dist tiers' steal and
exchange cadence (their diffusion/exchange rounds ride dispatch
boundaries) — were tuned against a *fixed* 100-250 ms band, an assumption
about the host<->device round trip, not a measurement. This module closes
the loop the way arXiv:1904.06825 prescribes: fit a **latency + bandwidth
model per link class** from the spans the obs layer already records, and
let the controllers resolve their bands from the measured fit when a
profile exists (the fixed bands remain the documented fallback).

Link classes and their span sources (all host-side; nothing new runs on
device):

  * ``dispatch`` — resident/mesh/dist_mesh ``dispatch`` spans: duration
    vs device cycles. The intercept IS the per-dispatch host round trip
    (the launch and the read of the dispatch's scalars), the slope the
    per-cycle device time.
  * ``offload``  — multi/dist worker ``chunk`` spans: duration vs chunk
    node count (H2D staging + kernel + D2H collect per chunk).
  * ``exchange`` — dist/dist_mesh communicator ``exchange`` spans:
    the inter-host control-round (allgather over DCN/KV) latency.
  * ``donate``   — ``donate_send``/``donate_recv`` spans: duration vs
    payload bytes — the DCN/KV work-migration bandwidth. Spans stamped
    with a link class (parallel/topology.py) also bucket per class
    (``donate:ici`` / ``donate:dcn``) — the fits the hierarchical steal
    policy resolves its per-level quanta and periods from
    (``steal_quantum`` / ``steal_every``).
  * ``steal``    — intra-host worker ``steal`` spans: locked front-pop
    + push duration vs stolen node count (the ``local`` link class).

A profile entry is keyed by ``backend|topology|shape`` (e.g.
``gpu|device-D1|pfsp_j20x10_lb1``) so a ta014 fit never paces an N-Queens
run on another topology; lookup degrades gracefully (same backend+shape on
any topology, then same backend) because the *dispatch intercept* — the
quantity the bands derive from — is a property of the host link, not the
problem.

Band derivation (``resolve_band``): the fixed defaults encode an assumed
8 ms round trip — ``RESIDENT_TARGET`` (0.100, 0.250) is 12.5x/31.25x that
latency; ``MESH_TARGET`` (0.050, 0.150) is 6.25x/18.75x. A measured
latency L replaces the assumption with the same multipliers, clamped so a
pathological fit cannot park K at a useless rung. Deterministic given the
profile, and bit-identical search results by construction — the band only
moves K along the existing ladder (tests/test_costmodel.py pins both).
"""

from __future__ import annotations

import json
import os

#: (lo_multiplier, hi_over_lo, lo_clamp, hi_clamp) per controller tier —
#: chosen so the measured-band formula reproduces the documented fixed
#: bands exactly at the 8 ms design-point latency (see module docstring).
_BAND_RULES = {
    "resident": (12.5, 2.5, (0.020, 2.0), 5.0),
    "mesh": (6.25, 3.0, (0.010, 1.0), 3.0),
}

#: Span name -> (link class, x-axis arg). ``None`` x means latency-only.
_SPAN_LINKS = {
    "dispatch": ("dispatch", "cycles"),
    "chunk": ("offload", "count"),
    "exchange": ("exchange", None),
    "donate_send": ("donate", "bytes"),
    "donate_recv": ("donate", "bytes"),
    "steal": ("steal", "nodes"),
}

_X_UNITS = {"dispatch": "cycle", "offload": "node", "exchange": None,
            "donate": "byte", "steal": "node"}

#: Link classes a donate span may be stamped with (``args["link"]``,
#: parallel/topology.py): stamped spans ALSO bucket into the per-class
#: ``donate:ici`` / ``donate:dcn`` fits the hierarchical steal policy
#: resolves its per-level quanta and periods from.
_DONATE_CLASSES = ("ici", "dcn")

#: Target amortization: a donation's transfer cost must stay below this
#: fraction of the evaluation time the block buys (steal_quantum).
DONATE_FRAC = 0.10


def costmodel_path() -> str | None:
    """The ``TTS_COSTMODEL`` knob: a profile path arms measured bands;
    unset/``0`` keeps the fixed fallbacks."""
    raw = os.environ.get("TTS_COSTMODEL", "") or ""
    return None if raw in ("", "0") else raw


def shape_class(problem) -> str:
    """Problem shape class for profile keys: bound work scales with the
    (jobs, machines)/(N) shape and the bound function, nothing finer."""
    if problem is None:
        return "any"
    if hasattr(problem, "N"):
        return f"nqueens_n{problem.N}"
    if hasattr(problem, "jobs"):
        lb = getattr(problem, "lb", "lb1")
        return f"pfsp_j{problem.jobs}x{problem.machines}_{lb}"
    return getattr(problem, "name", type(problem).__name__).lower()


def profile_key(backend: str, topology: str, shape: str) -> str:
    return f"{backend}|{topology}|{shape}"


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = q * (len(sorted_vals) - 1)
    lo = int(idx)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = idx - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def fit_link(samples: list[tuple[float, float]]) -> dict | None:
    """Least-squares latency+bandwidth fit of ``(x, duration_us)`` span
    samples: ``dur = latency_us + x * per_unit_us``. With too few samples
    (or no x spread) the latency falls back to the median duration and the
    slope is None. Percentiles always report the raw durations."""
    if not samples:
        return None
    durs = sorted(d for _, d in samples)
    n = len(samples)
    med = _percentile(durs, 0.5)
    out = {
        "n": n,
        "p50_us": round(med, 1),
        "p90_us": round(_percentile(durs, 0.90), 1),
        "p99_us": round(_percentile(durs, 0.99), 1),
        "latency_us": round(med, 1),
        "per_unit_us": None,
    }
    # Trim the slowest ~10% before the linear fit: the first dispatches of
    # a run carry compilation (observed: a 760 ms compile spike vs ~10 ms
    # steady state), and a least-squares intercept is exactly what such
    # outliers wreck. Percentiles above stay untrimmed on purpose — p99
    # SHOULD show the spike.
    fit_samples = samples
    if n >= 8:
        cut = _percentile(durs, 0.90)
        trimmed = [(x, d) for x, d in samples if d <= cut]
        if len(trimmed) >= 3:
            fit_samples = trimmed
    xs = [x for x, _ in fit_samples]
    nf = len(fit_samples)
    mean_x = sum(xs) / nf
    var_x = sum((x - mean_x) ** 2 for x in xs)
    if nf >= 3 and var_x > 0.0:
        mean_d = sum(d for _, d in fit_samples) / nf
        cov = sum((x - mean_x) * (d - mean_d) for x, d in fit_samples)
        slope = max(0.0, cov / var_x)
        intercept = max(0.0, mean_d - slope * mean_x)
        out["latency_us"] = round(intercept, 1)
        out["per_unit_us"] = round(slope, 4)
        if slope > 0:
            out["per_sec"] = round(1e6 / slope, 1)  # cycles/nodes/bytes per s
    return out


def samples_from_events(evts: list[dict]) -> dict[str, list]:
    """Bucket every recognized complete span into its link class as
    ``(x, dur_us)`` samples (events without ``dur`` are skipped — the
    older instant spellings of exchange/donate carry no timing)."""
    links: dict[str, list] = {}
    for e in evts:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        hit = _SPAN_LINKS.get(e.get("name", ""))
        if hit is None:
            continue
        link, xarg = hit
        args = e.get("args") or {}
        if xarg is None:
            x = 0.0
        else:
            x = args.get(xarg)
            if x is None and link == "donate":
                x = args.get("nodes")  # older traces: nodes, not bytes
            if x is None:
                continue
        links.setdefault(link, []).append((float(x), float(e["dur"])))
        # Link-class-stamped donations additionally feed the per-class
        # fits (donate:ici / donate:dcn) the steal hierarchy sizes its
        # per-level quanta from; the aggregate "donate" bucket stays for
        # older consumers.
        if link == "donate" and args.get("link") in _DONATE_CLASSES:
            links.setdefault(f"donate:{args['link']}", []).append(
                (float(x), float(e["dur"]))
            )
    return links


def build_profile(evts: list[dict], backend: str, topology: str,
                  shape: str) -> dict:
    """One profile entry (keyed) from a drained/loaded event list."""
    links = {
        name: fit
        for name, samples in sorted(samples_from_events(evts).items())
        if (fit := fit_link(samples)) is not None
    }
    return {
        profile_key(backend, topology, shape): {
            "backend": backend,
            "topology": topology,
            "shape": shape,
            "links": links,
        }
    }


def save(path: str, profile: dict) -> dict:
    """Merge ``profile`` into the file at ``path`` (atomic replace +
    fsync — a capture must survive the session dying right after it).
    Returns the merged document."""
    merged = load(path) or {}
    merged.update(profile)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(merged, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return merged


def load(path: str) -> dict | None:
    """Load a profile document; None on any failure (the controllers fall
    back to their fixed bands — a corrupt profile must never fail a run)."""
    try:
        with open(path) as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None


def lookup(profile: dict, backend: str, topology: str, shape: str
           ) -> tuple[str, dict] | None:
    """Best matching entry: exact key, then same backend+shape on any
    topology, then same backend — sorted for determinism. The degradation
    order follows what the bands actually consume (the dispatch intercept
    is a link property; see module docstring)."""
    exact = profile_key(backend, topology, shape)
    if isinstance(profile.get(exact), dict):
        return exact, profile[exact]
    candidates = sorted(
        k for k, v in profile.items()
        if isinstance(v, dict) and v.get("backend") == backend
    )
    for k in candidates:
        if profile[k].get("shape") == shape:
            return k, profile[k]
    if candidates:
        return candidates[0], profile[candidates[0]]
    return None


def resolve_band(entry: dict, tier: str) -> tuple[float, float] | None:
    """AdaptiveK target band (seconds) from a profile entry's measured
    dispatch latency; None when the entry carries no usable dispatch fit
    (callers keep their fixed band)."""
    rule = _BAND_RULES.get("mesh" if tier in ("mesh", "dist_mesh")
                           else "resident")
    disp = (entry.get("links") or {}).get("dispatch") or {}
    lat_us = disp.get("latency_us")
    if not lat_us or lat_us <= 0:
        return None
    lo_mult, hi_over_lo, (lo_min, lo_max), hi_cap = rule
    lo = min(max(lo_mult * lat_us / 1e6, lo_min), lo_max)
    hi = min(hi_over_lo * lo, hi_cap)
    return (round(lo, 4), round(hi, 4))


def exchange_sleep_s(entry: dict, cap_s: float = 0.5) -> float | None:
    """Idle-host exchange back-off from the measured exchange-round
    latency (dist_mesh: an idle host that received nothing sleeps ~2
    round-trips instead of a fixed guess); None without an exchange fit."""
    exch = (entry.get("links") or {}).get("exchange") or {}
    p50 = exch.get("p50_us")
    if not p50 or p50 <= 0:
        return None
    return round(min(2.0 * p50 / 1e6, cap_s), 4)


def donate_fit(entry: dict, link: str) -> dict | None:
    """The donate fit for one link class: the stamped per-class fit
    (``donate:ici`` / ``donate:dcn``) when the profile carries one, else
    the aggregate ``donate`` fit (older profiles, single-class runs)."""
    links = entry.get("links") or {}
    fit = links.get(f"donate:{link}") or links.get("donate")
    return fit if isinstance(fit, dict) else None


def steal_quantum(entry: dict, link: str, *, m: int,
                  bytes_per_node: int | None, cap: int,
                  frac: float = DONATE_FRAC) -> int | None:
    """Donation quantum (nodes) for ``link`` sized so the measured
    transfer cost amortizes below ``frac`` of the evaluation time the
    block buys:

        lat_us + Q*bpn*per_byte_us  <=  frac * Q*eval_per_node_us
        =>  Q >= lat_us / (frac*eval_per_node_us - bpn*per_byte_us)

    ``eval_per_node_us`` is the offload (chunk) fit's slope — the
    measured per-node evaluation cost on this backend. When the per-byte
    transfer cost alone exceeds the amortization budget no finite quantum
    qualifies; go maximally bulk (``cap``) to pay the latency as rarely
    as possible. None (caller keeps the fixed fallback) without both a
    donate-latency and an eval-rate fit. Clamped to [2m, cap] — a block
    below 2m could not have been popped anyway (pop_front_bulk_half's
    donor threshold)."""
    fit = donate_fit(entry, link)
    off = (entry.get("links") or {}).get("offload") or {}
    eval_us = off.get("per_unit_us")
    lat_us = (fit or {}).get("latency_us")
    if not fit or not eval_us or eval_us <= 0 or not lat_us or lat_us <= 0:
        return None
    per_byte_us = fit.get("per_unit_us") or 0.0
    xfer_per_node_us = (bytes_per_node or 0) * per_byte_us
    denom = frac * eval_us - xfer_per_node_us
    if denom <= 0:
        return int(cap)
    q = lat_us / denom
    return int(min(max(q, 2 * m), cap))


def steal_every(entry: dict, interval_s: float, *, cap: int = 32,
                frac: float = DONATE_FRAC) -> int | None:
    """Far-level period, in near-round multiples: far (dcn) pairs match
    every ``N``-th exchange round where N spaces donations ~one latency
    per ``1/frac`` latencies of elapsed time — the same amortization
    target as the quantum, applied to the round cadence. None without a
    donate-latency fit for the far link."""
    fit = donate_fit(entry, "dcn")
    lat_us = (fit or {}).get("latency_us")
    if not fit or not lat_us or lat_us <= 0 or interval_s <= 0:
        return None
    n = (lat_us / 1e6) / (frac * interval_s)
    return int(min(max(round(n), 2), cap))
