"""Topology descriptors, link classes and the hierarchical steal policy — the
port of `tpu_tree_search/parallel/topology.py`.

The reference's distributed tier applies one flat steal policy to every
link. This module makes the inter-host work distribution of the multi-host
tiers (`parallel/dist.py`, `parallel/dist_mesh.py`) topology-aware:

  * **Link classes.** A pair of hosts is ``local`` (the same host),
    ``ici`` (the same pod) or ``dcn`` (across pods). The pod map comes from
    ``TTS_PODS``; a GPU has no slice index, so without ``TTS_PODS`` every
    host is in pod 0 and every inter-host link is ``ici``, as in the JAX
    package without a multi-slice map.
  * **Two-level hierarchy** (``TTS_STEAL=hier``): the lockstep exchange
    round stays global (every host computes the same matching, no
    handshake); near (ici) donor->needy pairs match every round with the
    near quantum, far (dcn) pairs only every ``far_every``-th round, only
    for needy hosts the near level left unfed, with a bulk quantum. With
    ``TTS_COSTMODEL`` armed the quanta and the far period come from the
    profile's measured fits (`obs/costmodel.py`); else the fixed fallbacks
    below. ``TTS_STEAL=flat`` (the default) keeps the single-level matching.
  * **Simulated links.** ``TTS_SIM_LAT_ICI`` / ``TTS_SIM_LAT_DCN`` (seconds)
    inject a one-way latency on the donation path of that link class;
    unset, nothing sleeps.

The knobs are host-side only: they reach neither a mesh program's cache
key nor a dispatch graph (`tests/test_torch_topology.py` holds this, in
place of the JAX package's ``steal-knob-inert`` contract).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

#: Link classes, cheapest first (the victim-selection escalation order).
LINK_LOCAL = "local"
LINK_ICI = "ici"
LINK_DCN = "dcn"
LINK_CLASSES = (LINK_LOCAL, LINK_ICI, LINK_DCN)

#: Fixed fallbacks without a cost-model fit: far (dcn) rounds fire every
#: 4th near round, and the far quantum is 8x the near cap.
FAR_EVERY_DEFAULT = 4
FAR_QUANTUM_MULT = 8
FAR_EVERY_MAX = 32


def steal_mode() -> str:
    """The ``TTS_STEAL`` knob: ``flat`` (default) or ``hier``. Any other
    value is flat: a typo never changes semantics."""
    raw = (os.environ.get("TTS_STEAL", "") or "").strip().lower()
    return "hier" if raw == "hier" else "flat"


def _parse_pods(raw: str, num_hosts: int) -> list[int] | None:
    """``TTS_PODS``: an integer K splits the hosts into K contiguous equal
    pods (``2`` with H = 4: [0, 0, 1, 1]); a comma list gives each host's
    pod (``0,0,1,1``). None on any mismatch."""
    raw = (raw or "").strip()
    if not raw:
        return None
    try:
        if "," in raw:
            pods = [int(x) for x in raw.split(",")]
            return pods if len(pods) == num_hosts else None
        k = int(raw)
        if k <= 0:
            return None
        per = max(1, (num_hosts + k - 1) // k)
        return [min(h // per, k - 1) for h in range(num_hosts)]
    except ValueError:
        return None


class Topology:
    """The host -> pod map and the link class of a pair of hosts."""

    def __init__(self, num_hosts: int, pod_of: list[int] | None = None):
        self.num_hosts = num_hosts
        self.pod_of = list(pod_of) if pod_of else [0] * num_hosts

    @classmethod
    def detect(cls, num_hosts: int, slice_index: int | None = None,
               allgather=None) -> "Topology":
        """``TTS_PODS`` wins; else, when the caller has a slice index and an
        allgather, the gathered indices; else one pod. (The port's callers
        pass no slice index: a GPU host has none.)"""
        pods = _parse_pods(os.environ.get("TTS_PODS", ""), num_hosts)
        if pods is None and slice_index is not None and allgather is not None:
            gathered = allgather(int(slice_index))
            if len(gathered) == num_hosts:
                pods = [int(p) for p in gathered]
        return cls(num_hosts, pods)

    def link_class(self, a: int, b: int) -> str:
        """The link class between hosts ``a`` and ``b``."""
        if a == b:
            return LINK_LOCAL
        return LINK_ICI if self.pod_of[a] == self.pod_of[b] else LINK_DCN

    @property
    def num_pods(self) -> int:
        return len(set(self.pod_of))

    def describe(self) -> dict:
        return {"num_hosts": self.num_hosts, "pods": list(self.pod_of)}


class SimLinks:
    """The env-armed one-way link latencies of the simulated-latency
    harness: ``armed`` is False, and nothing sleeps, unless a knob is set."""

    def __init__(self):
        self.lat_s = {}
        for link, knob in ((LINK_ICI, "TTS_SIM_LAT_ICI"),
                           (LINK_DCN, "TTS_SIM_LAT_DCN")):
            try:
                v = float(os.environ.get(knob, "") or 0.0)
            except ValueError:
                v = 0.0
            if v > 0:
                self.lat_s[link] = v

    @property
    def armed(self) -> bool:
        return bool(self.lat_s)

    def sleep(self, link: str) -> None:
        lat = self.lat_s.get(link, 0.0)
        if lat > 0:
            time.sleep(lat)


@dataclass
class LevelSpec:
    """The resolved parameters of one hierarchy level."""

    link: str        # "ici" | "dcn"
    level: int       # 1 = near, 2 = far
    every: int       # match this link class every `every`-th round
    quantum: int     # donation block cap (nodes)
    period_s: float  # every * the base interval
    source: str      # "fixed" or the COSTMODEL.json profile key


@dataclass
class StealPolicy:
    """The resolved steal policy of one search. ``flat`` carries the cap of
    every link (M, or D*M on the mesh); ``hier`` adds the levels and the
    near-first, escalate-far matching."""

    mode: str
    topology: Topology
    m: int
    cap: int
    interval_s: float
    levels: dict = field(default_factory=dict)  # link -> LevelSpec
    sim: SimLinks = field(default_factory=SimLinks)

    @property
    def hier(self) -> bool:
        return self.mode == "hier"

    def link(self, a: int, b: int) -> str:
        return self.topology.link_class(a, b)

    def cap_for(self, link: str) -> int:
        if not self.hier:
            return self.cap
        spec = self.levels.get(link)
        return spec.quantum if spec is not None else self.cap

    def level_of(self, link: str) -> int:
        spec = self.levels.get(link)
        return spec.level if spec is not None else (0 if link == LINK_LOCAL
                                                    else 1)

    def match(self, donors: list[int], needy: list[int], round_no: int,
              sizes: list[int] | None = None) -> list[tuple[int, int]]:
        """The deterministic two-level matching (the same inputs on every
        host give the same pairs): near (ici) pairs every round; far (dcn)
        pairs only on far rounds, only for needy hosts the near level left
        unmatched, and (with ``sizes``) only from a donor that can fill a
        meaningful part of the bulk quantum — a far donation pays the link's
        latency whatever it carries."""
        far_spec = self.levels.get(LINK_DCN)
        far_round = far_spec is None or round_no % max(1, far_spec.every) == 0
        far_floor = 0
        if far_spec is not None and sizes is not None:
            far_floor = max(4 * self.m, far_spec.quantum // 2)
        pairs: list[tuple[int, int]] = []
        free = list(donors)
        unmatched = []
        for r in needy:
            near = next((d for d in free if self.link(d, r) == LINK_ICI), None)
            if near is not None:
                pairs.append((near, r))
                free.remove(near)
            else:
                unmatched.append(r)
        if far_round:
            for r in unmatched:
                far = next(
                    (d for d in free
                     if self.link(d, r) == LINK_DCN
                     and (sizes is None or sizes[d] >= far_floor)),
                    None)
                if far is not None:
                    pairs.append((far, r))
                    free.remove(far)
        return pairs

    def describe(self) -> dict:
        """The policy as the result, the ``--json`` record and the report
        show it: the mode, the pods and each link class's level, period and
        quantum."""
        out = {"mode": self.mode, "pods": list(self.topology.pod_of)}
        if self.hier:
            out["levels"] = {
                link: {"level": s.level, "every": s.every,
                       "period_s": round(s.period_s, 4),
                       "quantum": s.quantum, "source": s.source}
                for link, s in sorted(self.levels.items())
            }
        else:
            out["levels"] = {
                "any": {"level": 1, "every": 1,
                        "period_s": round(self.interval_s, 4),
                        "quantum": self.cap, "source": "fixed"},
            }
        if self.sim.armed:
            out["sim_lat_s"] = dict(sorted(self.sim.lat_s.items()))
        return out


def bytes_per_node(problem) -> int | None:
    """A node's payload bytes from the problem's field schema (the cost
    model's per-byte slope in per-node terms)."""
    import numpy as np

    try:
        total = 0
        for _, (shape, dtype) in problem.node_fields().items():
            n = 1
            for d in shape:
                n *= int(d)
            total += n * np.dtype(dtype).itemsize
        return total or None
    except (AttributeError, TypeError, ValueError):
        return None


def resolve_policy(problem, topology: Topology, *, m: int, cap: int,
                   interval_s: float, mode: str | None = None,
                   backend: str = "cpu", topo_str: str = "",
                   ) -> StealPolicy:
    """The policy of one search: flat unless ``TTS_STEAL=hier``. The hier
    levels come from the ``TTS_COSTMODEL`` profile's fits for ``backend``
    (`ops/backend.py` ``profile_backend``) and ``topo_str``, else the fixed
    fallbacks. Only the environment and the profile file are read, so every
    host resolves the same policy without communicating."""
    from ..obs import costmodel as cm

    mode = mode or steal_mode()
    policy = StealPolicy(mode=mode, topology=topology, m=m, cap=cap,
                         interval_s=interval_s)
    if mode != "hier":
        return policy
    entry, src = None, "fixed"
    path = cm.costmodel_path()
    if path:
        prof = cm.load(path)
        if prof:
            hit = cm.lookup(prof, backend, topo_str, cm.shape_class(problem))
            if hit is not None:
                src, entry = hit
    bpn = bytes_per_node(problem)
    near_q = cap
    far_q = min(cap * FAR_QUANTUM_MULT, max(cap, 2 ** 20))
    far_every = FAR_EVERY_DEFAULT
    near_src = far_src = "fixed"
    if entry is not None:
        q = cm.steal_quantum(entry, LINK_ICI, m=m, bytes_per_node=bpn,
                             cap=near_q * FAR_QUANTUM_MULT)
        if q is not None:
            near_q, near_src = q, src
        q = cm.steal_quantum(entry, LINK_DCN, m=m, bytes_per_node=bpn,
                             cap=far_q)
        if q is not None:
            far_q, far_src = max(q, near_q), src
        ev_ = cm.steal_every(entry, interval_s, cap=FAR_EVERY_MAX)
        if ev_ is not None:
            far_every = ev_
    policy.levels = {
        LINK_ICI: LevelSpec(LINK_ICI, 1, 1, near_q, interval_s, near_src),
        LINK_DCN: LevelSpec(LINK_DCN, 2, far_every, far_q,
                            interval_s * far_every, far_src),
    }
    return policy


# -- program contracts (`check`, analysis/contracts.py) ------------------------

from ..analysis.contracts import contract  # noqa: E402


@contract(
    "steal-knob-inert",
    claim="TTS_STEAL never reaches a program: flat and hier (with a pod "
          "map) record the same dispatch as the unset build",
    artifact="variants",
)
def _contract_steal_inert(art, cell):
    if not art.has("off", "steal-flat", "steal-hier"):
        return []
    if art.text("off") == art.text("steal-flat") == art.text("steal-hier"):
        return []
    return ["TTS_STEAL leaked into the recorded program (host-side "
            "scheduling must not fork programs)"]
