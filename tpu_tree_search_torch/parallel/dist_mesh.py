"""The distributed mesh-resident tier (``--tier dist_mesh``) — the port of
`tpu_tree_search/parallel/dist_mesh.py`.

The dist tier (`parallel/dist.py`) runs offload workers on every host, each
chunk a host round trip. This tier composes the mesh-resident engine with
the same inter-host exchange instead:

  * **inside a host**: a mesh program (`parallel/resident_mesh.py`
    ``get_mesh_program``): D pool shards on the host's share of the device
    positions (one, by default), one CUDA graph a dispatch and group
    holding the shards' cycles (kernels 2, 4, 8; 9a-9c under a tile width;
    the unfused cycle under lb1_d, ``fused=False`` or ``mp`` > 1), the
    incumbent fold and the ring diffusion (``mesh_balance``); ``mp`` > 1
    (PFSP lb2) splits each shard's lb2 pair loop in mp pair blocks, as
    the JAX host's dp x mp mesh does (`dist_mesh.py:637-690`);
  * **between hosts**: a bulk-synchronous exchange at dispatch boundaries
    over the dist tier's collectives (threads for virtual hosts, the
    ``TCPStore`` of ``TorchCollectives`` for processes): the incumbent
    all-reduce, written into every shard's state; the matching of idle
    hosts to donors, each donation a block of the donor's frontier front
    (downloaded, up to D*M nodes) sent point-to-point and uploaded into the
    receiver's shards; two-round quiescence; and lockstep cuts.

A donation costs the donor a download and a re-upload of its frontier, and
happens only when a host is starved (no shard can run a cycle), so the hot
path stays on the card. Exchanges move nodes and tighten incumbents but
never make or drop one: with a fixed incumbent the counts equal the
sequential tier's. A host's stream is its own (virtual hosts share the
card), and its program is the problem's cached one or, when another host
holds that, a new one.

The steady-state guard (``guard``, else ``TTS_GUARD=1``; `analysis/
guard.py`) wraps each host's dispatch enqueues as the mesh tier's, and a
donation's re-upload re-arms it; the result's ``guard`` is this process's
first host's.

Differences from the JAX module: a ``max_steps`` cut ends the run without
the host drain (the file holds the frontier), as
the port's mesh tier does; and a saturated mesh (no shard ran a cycle,
balancing moved nothing) falls back to host offload cycles, as
``mesh_resident_search`` does.
"""

from __future__ import annotations

import pickle
import sys
import time
import uuid

import numpy as np
import torch

from ..analysis.guard import RungGuards
from ..engine import checkpoint as ckpt
from ..engine import resident as R
from ..engine.device import drain, warmup
from ..engine.pipeline import (
    MESH_TARGET,
    AdaptiveK,
    DispatchQueue,
    resolve_k,
    resolve_pipeline_depth,
    resolve_target_band,
)
from ..engine.results import Diagnostics, PhaseStats, SearchResult
from ..obs import counters as obs_counters
from ..obs import events as ev
from ..obs import flightrec as fr
from ..obs import phases as obs_phases
from ..obs import quality as obs_quality
from ..ops.backend import profile_backend, resolve_devices
from ..ops.compact_policy import auto_chosen
from ..ops.cycle import ST_BEST, ST_CTR, ST_CYCLES
from ..pool.pool import SoAPool
from ..problems.base import INF_BOUND, Problem, batch_length, index_batch
from .dist import (
    LocalCollectives,
    reduce_hosts,
    run_virtual_hosts,
)
from .multidevice import (
    check_same_cut,
    default_devices,
    host_share,
    worker_streams,
)
from .resident_mesh import get_mesh_program, offload_until_fits


def _host_loop(problem: Problem, m: int, M: int, K, rounds: int, D: int,
               devs: list, coll, initial_best: int | None, *,
               mp: int = 1, fused: bool = True, staged: bool = True,
               partition_fn=None,
               max_steps: int | None = None,
               checkpoint_path: str | None = None,
               checkpoint_interval_s: float = 60.0,
               resume_from: str | None = None,
               guard: bool | None = None) -> dict:
    """One host (`dist_mesh.py:60-636`): the warm-up and its share (or its
    per-host file), the mesh loop with an exchange at every dispatch
    boundary, the drain; returns its stats for the reduction."""
    H, me = coll.num_hosts, coll.host_id
    dev = devs[0]
    best = (initial_best if initial_best is not None
            else getattr(problem, "initial_ub", INF_BOUND))
    suffix = f".h{me}" if H > 1 else ""
    eff_ckpt = None if checkpoint_path is None else checkpoint_path + suffix
    eff_resume = None if resume_from is None else resume_from + suffix
    n = problem.child_slots
    capacity, M = R.resolve_capacity(problem, M, None)
    T = max(2 * m, min(M, 8192))
    diagnostics = Diagnostics()
    problem._native()  # a first call builds it: outside the timed phases
    t0 = time.perf_counter()

    # -- phase 1: replicate-and-slice warm-up (host 0 counts it), or the
    # host's file --------------------------------------------------------------
    pool = SoAPool(problem.node_fields())
    if eff_resume is not None:
        loaded = ckpt.load(eff_resume, problem, expect_hosts=H)
        if H > 1:
            check_same_cut(coll, loaded.cut_tag)
        pool.push_back_bulk(loaded.batch)
        tree1, sol1 = loaded.tree, loaded.sol
        best = min(best, loaded.best)
        capacity = max(capacity, -(-pool.size // D) + 2 * M * n)
    else:
        pool.push_back(index_batch(problem.root(), 0))
        tree1, sol1, best = warmup(problem, pool, best, H * D * m)
        if H > 1:
            pool = host_share(problem, pool, me, H, partition_fn)
            if me != 0:
                tree1 = sol1 = 0
    t1 = time.perf_counter()
    ev.counter("explored", host=me, tree=tree1, sol=sol1, phase=1)

    # -- phase 2: the host's mesh loop and the exchanges ------------------------
    k_auto, k_value = resolve_k(K, default_max=16)
    topo = f"dist_mesh-H{H}xD{D}"
    band, band_src = resolve_target_band("dist_mesh", MESH_TARGET, problem,
                                         topology=topo, device=dev)
    exchange_sleep_s = 0.0  # an idle host's back-off between exchanges
    if band_src is not None:
        # The back-off from the measured exchange round.
        from ..obs import costmodel as cm

        prof = cm.load(cm.costmodel_path() or "")
        hit = cm.lookup(prof or {}, *band_src.split("|")) if prof else None
        measured = cm.exchange_sleep_s(hit[1]) if hit else None
        if measured is not None:
            exchange_sleep_s = measured
    policy = None
    if H > 1:
        from .topology import Topology, resolve_policy

        # The exchange period is the dispatch cadence: the far level's
        # base interval is the K band's middle (or the measured back-off).
        policy = resolve_policy(
            problem, Topology.detect(H), m=m, cap=D * M,
            interval_s=exchange_sleep_s or (band[0] + band[1]) / 2.0,
            backend=profile_backend(dev), topo_str=topo)
    ctl = AdaptiveK(k_value, target=band) if k_auto else None
    depth = resolve_pipeline_depth()

    tree2 = sol2 = 0
    steps = 0
    completed = True
    quiescent_streak = 0
    blocks_sent = blocks_received = nodes_sent = nodes_received = 0
    exch_rounds = 0
    exchange_s = 0.0
    per_worker = np.zeros(D, dtype=np.int64)
    ctr_total: dict | None = None
    ph_total: dict | None = None
    prev_best = best
    qt = obs_quality.tracker(problem)
    sizes = [0] * D
    prev_sizes = None
    dispatches = stalls = 0
    fb_tree = fb_sol = 0
    offloader = None
    queue = DispatchQueue(depth)
    run_uuid = uuid.uuid4().hex[:12]
    ckpt_last = time.monotonic()

    with worker_streams(dev):
        program = get_mesh_program(problem, D, m, M,
                                   ctl.K if ctl else k_value, rounds, T,
                                   capacity, dev, fused=fused, staged=staged,
                                   mp=mp, devices=devs)
        build0 = program.graph_build_s
        device0 = program.dispatch_device_s
        try:
            program.host_slots(depth)
            program.upload(pool.as_batch(), best)
            pool.clear()
            diagnostics.host_to_device += 1

            guards = RungGuards(program, f"dist-mesh step (host {me})",
                                guard)

            def enqueue() -> None:
                with guards.of().step():
                    read = program.enqueue()
                queue.push(read, ev.now_us())

            def consume(read, t_enq: float) -> int:
                nonlocal tree2, sol2, sizes, best, ctr_total, ph_total
                nonlocal prev_best, dispatches
                t_wait = ev.now_us()
                rows, ph, ms = read()
                tree_vec = [r[2] for r in rows]
                ti, si = sum(tree_vec), sum(r[3] for r in rows)
                cy = sum(r[ST_CYCLES] for r in rows)
                sizes = [r[0] for r in rows]
                best = min(best, min(r[ST_BEST] for r in rows))
                tree2 += ti
                sol2 += si
                dispatches += 1
                per_worker[:] += np.asarray(tree_vec, dtype=np.int64)
                diagnostics.kernel_launches += cy
                ctr = None
                if program.obs:
                    ctr = [r[ST_CTR:ST_CTR + obs_counters.NSLOTS] for r in rows]
                    ctr_total = obs_counters.merge_host(ctr_total, ctr)
                if ph is not None:
                    ph_total = obs_phases.merge_host(ph_total, ph)
                fr.heartbeat("dist_mesh", host=me, seq=dispatches, cycles=cy,
                             size=sum(sizes), best=best, tree=tree2, sol=sol2,
                             depth=depth, K=program.K, inflight=len(queue),
                             phases=ph_total)
                if qt is not None:
                    qt.observe(best, dispatches, tree1 + tree2)
                if ev.enabled():
                    now = ev.now_us()
                    ev.emit("dispatch", ph="X", ts=t_enq, host=me,
                            dur=max(0.0, now - t_enq), args={
                                "cycles": cy, "tree": ti, "sol": si,
                                "size": sum(sizes), "best": best,
                                "shard_sizes": list(sizes),
                                "enqueue_us": t_enq,
                                "read_wait_us": now - t_wait,
                                "pipeline_depth": depth, "device_ms": ms})
                    if ctr is not None:
                        ev.counter("device_counters", host=me,
                                   **obs_counters.as_args(ctr))
                    if ph is not None:
                        ev.counter("device_phases", host=me,
                                   **obs_phases.as_args(ph))
                    if best < prev_best:
                        ev.emit("incumbent", host=me, args={"best": best})
                prev_best = best
                return cy

            def drain_queue() -> None:
                # Before any download or snapshot: the frontier includes the
                # in-flight dispatches' work, so their counts are folded.
                for read, t_enq in queue.drain():
                    consume(read, t_enq)

            def download() -> SoAPool:
                drain_queue()
                p = SoAPool(problem.node_fields())
                p.push_back_bulk(program.full_batch())
                diagnostics.device_to_host += 1
                return p

            def upload(p: SoAPool) -> None:
                nonlocal prev_sizes
                program.upload(p.as_batch(), best)
                diagnostics.host_to_device += 1
                prev_sizes = None
                # A donation's re-upload is a sanctioned host round trip:
                # the next dispatch is a warm one for the guard.
                guards.of().rearm()

            def do_lockstep_cut(tag) -> None:
                # After the round's allgather (a barrier: every earlier
                # donation is in on both ends) and before its donations.
                drain_queue()
                staging = eff_ckpt + ".staging"
                ok = True
                t_cut = ev.now_us()
                try:
                    batch = program.full_batch()
                    diagnostics.device_to_host += 1
                    ckpt.save(staging, problem, batch, best, tree1 + tree2,
                              sol1 + sol2, hosts=H, cut_tag=tag)
                except (OSError, RuntimeError, ValueError) as e:
                    # This host vetoes the set's commit.
                    print(f"[checkpoint] host {me} could not stage its cut: "
                          f"{type(e).__name__}: {e}", file=sys.stderr)
                    ok = False
                ckpt.lockstep_commit(ok, staging, eff_ckpt,
                                     vote=coll.allgather_obj if H > 1 else None)
                ev.complete("checkpoint", t_cut, wid=ev.COMM_TID, host=me,
                            args={"tag": str(tag), "ok": ok})

            fr.arm("dist_mesh")
            ev.emit("pipeline", host=me, args={
                "depth": depth, "K": program.K, "k_auto": k_auto,
                "tier": "dist_mesh"})
            if band_src is not None:
                ev.emit("costmodel", host=me, args={
                    "source": band_src, "lo_ms": round(1e3 * band[0], 1),
                    "hi_ms": round(1e3 * band[1], 1), "tier": "dist_mesh"})
            last_ready = time.monotonic()
            while True:
                while not queue.full:
                    enqueue()
                read, t_enq = queue.pop()
                cy = consume(read, t_enq)
                now = time.monotonic()
                period, last_ready = now - last_ready, now
                steps += 1
                if ctl is not None and cy > 0 and ctl.observe(period, cy):
                    drain_queue()
                    program.use_k(ctl.K)
                    ev.emit("k_resize", host=me, args={"K": program.K})
                    last_ready = time.monotonic()
                    prev_sizes = None
                # Idle: this host's mesh cannot run a cycle on any shard.
                idle = max(sizes) < m
                if not idle and cy == 0 and prev_sizes == sizes:
                    # Saturated: host offload cycles until it fits.
                    drain_queue()
                    t_fb = ev.now_us()
                    stalls += 1
                    ti, si, best, offloader = offload_until_fits(
                        program, pool, offloader, best, diagnostics)
                    guards.of().rearm()
                    tree2 += ti
                    sol2 += si
                    fb_tree += ti
                    fb_sol += si
                    ev.complete("overflow_fallback", t_fb, host=me,
                                args={"tree": ti, "sol": si})
                    prev_sizes = None
                    last_ready = time.monotonic()
                else:
                    prev_sizes = sizes
                total = sum(sizes)
                if max_steps is not None and steps >= max_steps:
                    completed = False  # a budget cut, not quiescence
                    if eff_ckpt is not None:
                        # Every host reaches this in the same round; host
                        # 0's tag rides one allgather.
                        tag = f"{run_uuid}:cutoff{steps}"
                        if H > 1:
                            tag = coll.allgather_obj(tag)[0]
                        do_lockstep_cut(tag)
                    break
                if H == 1:
                    if (eff_ckpt is not None and time.monotonic() - ckpt_last
                            >= checkpoint_interval_s):
                        do_lockstep_cut(f"{run_uuid}:{steps}")
                        ckpt_last = time.monotonic()
                    if idle:
                        break
                    continue
                # -- the bulk-synchronous exchange ----------------------------
                exch_rounds += 1
                want_ckpt = (eff_ckpt is not None and me == 0
                             and time.monotonic() - ckpt_last
                             >= checkpoint_interval_s)
                cut_id = f"{run_uuid}:{exch_rounds}" if want_ckpt else None
                t_x = ev.now_us()
                tx0 = time.perf_counter()
                rows = coll.allgather_obj(
                    (total, bool(idle), int(best), want_ckpt, cut_id))
                exchange_s += time.perf_counter() - tx0
                gbest = min(r[2] for r in rows)
                ev.complete("exchange", t_x, wid=ev.COMM_TID, host=me, args={
                    "round": exch_rounds, "size": total, "best": int(gbest),
                    "idle": bool(idle)})
                if gbest < best:
                    # The global incumbent into every shard's state, behind
                    # the dispatches in flight on this host's stream.
                    program.clamp_best(int(gbest))
                    best = int(gbest)
                if eff_ckpt is not None and rows[0][3]:
                    do_lockstep_cut(rows[0][4])
                    ckpt_last = time.monotonic()
                totals = [r[0] for r in rows]
                idles = [r[1] for r in rows]
                donors = sorted((h for h in range(H) if totals[h] >= 4 * D * m),
                                key=lambda h: (-totals[h], h))
                needy = sorted((h for h in range(H) if idles[h]),
                               key=lambda h: (totals[h], h))
                if policy.hier:
                    pairs = [(d, r) for d, r in policy.match(
                        donors, needy, exch_rounds, sizes=totals) if d != r]
                else:
                    pairs = [(d, r) for d, r in zip(donors, needy) if d != r]
                if all(idles) and not pairs:
                    quiescent_streak += 1
                    if quiescent_streak >= 2:
                        ev.emit("terminate", wid=ev.COMM_TID, host=me,
                                args={"round": exch_rounds})
                        break
                    continue
                quiescent_streak = 0
                send_to = next((r for d, r in pairs if d == me), None)
                recv_from = next((d for d, r in pairs if r == me), None)
                if send_to is not None:
                    # The donor: the front (oldest, shallowest: `Pool_par.
                    # chpl:180-191`) half of its frontier, capped at D*M
                    # nodes (the link's quantum under hier); the rest goes
                    # back up.
                    link = policy.link(me, send_to)
                    p = download()
                    block = p.pop_front_bulk_half(m, 0.5,
                                                  cap=policy.cap_for(link))
                    blob = pickle.dumps(block)
                    t_d = ev.now_us()
                    policy.sim.sleep(link)
                    coll.kv_set(f"tts/dmesh/{exch_rounds}/{me}->{send_to}",
                                blob)
                    if block is not None:
                        blocks_sent += 1
                        nodes_sent += batch_length(block)
                        ev.complete("donate_send", t_d, wid=ev.COMM_TID,
                                    host=me, args={
                                        "peer": send_to,
                                        "nodes": batch_length(block),
                                        "bytes": len(blob),
                                        "round": exch_rounds, "link": link,
                                        "level": policy.level_of(link)})
                    upload(p)
                if recv_from is not None:
                    link = policy.link(recv_from, me)
                    t_d = ev.now_us()
                    raw = coll.kv_get(
                        f"tts/dmesh/{exch_rounds}/{recv_from}->{me}",
                        timeout_s=120.0)
                    block = pickle.loads(raw)
                    if block is not None:
                        ev.complete("donate_recv", t_d, wid=ev.COMM_TID,
                                    host=me, args={
                                        "peer": recv_from,
                                        "nodes": batch_length(block),
                                        "bytes": len(raw),
                                        "round": exch_rounds, "link": link,
                                        "level": policy.level_of(link)})
                        p = download()
                        p.push_back_bulk(block)
                        upload(p)
                        blocks_received += 1
                        nodes_received += batch_length(block)
                        fr.note_steal(me, link, policy.level_of(link))
                if idle and recv_from is None and exchange_sleep_s:
                    time.sleep(exchange_sleep_s)

            # -- phase 3: the residual (none after a cut) --------------------
            drain_queue()  # the speculative dispatches left are no-ops
            if completed:
                pool.reset_from(program.full_batch())
                diagnostics.device_to_host += 1
        finally:
            if dev.type == "cuda":
                for g in program.groups:
                    if g.stream is not None:
                        g.stream.synchronize()
                torch.cuda.current_stream(dev).synchronize()
            program.release()
    if offloader is not None:
        diagnostics.kernel_launches += offloader.diagnostics.kernel_launches
        diagnostics.host_to_device += offloader.diagnostics.host_to_device
        diagnostics.device_to_host += offloader.diagnostics.device_to_host
    t2 = time.perf_counter()
    R._emit_device_explored(ctr_total, tree2, sol2, fb_tree, fb_sol, host=me)
    tree3 = sol3 = 0
    if completed:
        tree3, sol3, best = drain(problem, pool, best)
        ev.counter("explored", host=me, tree=tree3, sol=sol3, phase=3)
        if qt is not None:
            qt.observe(best, dispatches, tree1 + tree2 + tree3)
    t3 = time.perf_counter()
    inner = program.inner
    obs = {}
    if ctr_total is not None:
        obs["device_counters"] = ctr_total
    if ph_total is not None:
        obs["device_phases"] = ph_total
    return {
        "tree": tree1 + tree2 + tree3,
        "sol": sol1 + sol2 + sol3,
        "best": best,
        "steals": blocks_received,
        "elapsed": t3 - t0,
        "phases": [PhaseStats(t1 - t0, tree1, sol1),
                   PhaseStats(t2 - t1, tree2, sol2),
                   PhaseStats(t3 - t2, tree3, sol3)],
        "diag": diagnostics,
        "per_worker_tree": per_worker.tolist(),
        "comm": {"rounds": exch_rounds, "blocks_sent": blocks_sent,
                 "blocks_received": blocks_received, "nodes_sent": nodes_sent,
                 "nodes_received": nodes_received, "exchange_s": exchange_s},
        "steal_policy": policy.describe() if policy is not None else None,
        "complete": completed,
        "steps": steps,
        # Host-local (the same on every host but K under --K auto).
        "compact": inner.compact,
        "compact_auto": auto_chosen(inner.compact), "fused": inner.fused,
        "staged": inner.staged, "megakernel_mt": inner.mt, "M": M,
        "mp": program.mp,
        "k_resolved": program.K, "k_auto": k_auto, "pipeline_depth": depth,
        "obs": obs or None, "phase_profile": ph_total,
        "quality": qt.result() if qt is not None else None,
        # Summed over the hosts.
        "reduce_sum": {
            "dispatches": dispatches, "stall_fallbacks": stalls,
            "graph_build_s": program.graph_build_s - build0,
            "dispatch_device_s": (0.0 if device0 is None
                                  else program.dispatch_device_s - device0),
        },
        "graphed": device0 is not None,
        "guard": guards.record(),
    }


def _result(local: dict, red: dict) -> SearchResult:
    extra = red["extra"]
    return SearchResult(
        explored_tree=red["tree"], explored_sol=red["sol"], best=red["best"],
        elapsed=red["elapsed"], phases=local["phases"],
        diagnostics=red["diag"], complete=red["complete"],
        steps=local["steps"], engine="dist_mesh", compact=local["compact"],
        compact_auto=local["compact_auto"],
        fused=local["fused"], staged=local["staged"], mp=local["mp"],
        megakernel_mt=local["megakernel_mt"], M=local["M"],
        k_resolved=local["k_resolved"], dispatches=extra["dispatches"],
        stall_fallbacks=extra["stall_fallbacks"],
        pipeline_depth=local["pipeline_depth"], k_auto=local["k_auto"],
        graph_build_s=extra["graph_build_s"],
        dispatch_device_s=(extra["dispatch_device_s"] if local["graphed"]
                           else None),
        obs=local["obs"], phase_profile=local["phase_profile"],
        quality=local["quality"], per_worker_tree=red["per_worker_tree"],
        steals=red["steals"], comm=red["comm"],
        steal_policy=local["steal_policy"], guard=local["guard"])


def host_positions(devices: list, h: int, H: int) -> list:
    """Host h's share of the device positions (`dist_mesh.py`'s
    ``all_devices[h::H]``): every H-th from h, or, with fewer positions
    than hosts, position h mod their count."""
    share = devices[h::H]
    return share if share else [devices[h % len(devices)]]


def dist_mesh_search(problem: Problem, m: int = 25, M: int = 16384,
                     K: int | str = 16, rounds: int = 2,
                     D: int | None = None, mp: int = 1,
                     num_hosts: int | None = None,
                     devices=None, device=None,
                     initial_best: int | None = None, fused: bool = True,
                     staged: bool = True, partition_fn=None,
                     max_steps: int | None = None,
                     checkpoint_path: str | None = None,
                     checkpoint_interval_s: float = 60.0,
                     resume_from: str | None = None,
                     collectives=None,
                     guard: bool | None = None) -> SearchResult:
    """The distributed mesh-resident tier (``--tier dist_mesh``; the JAX
    signature), three ways as ``dist_search``: this process as host
    ``collectives.host_id`` (``collectives`` given), ``num_hosts`` H > 1
    virtual hosts in threads, or one host (the mesh tier's semantics with
    the exchange's bookkeeping). Host h's D shards (default 1) sit on its
    share of the device positions ``devices`` (default ``default_devices(
    device)``: ``cuda`` unless ``device="cpu"``), ``host_positions``, placed
    there as the mesh tier places them. ``mp`` > 1 (PFSP lb2 only) splits
    each shard's lb2 pair loop in mp pair blocks (the JAX host's dp x mp
    mesh, `dist_mesh.py:637-690`). ``fused=False`` (and lb1_d, and mp > 1)
    runs the unfused cycles. Per-host checkpoints ``path.h<rank>`` are cut
    in lockstep; ``max_steps`` dispatches end the run with a final cut.
    ``guard`` (else ``TTS_GUARD=1``) arms each host's steady-state
    guard."""
    if devices is None:
        devices = default_devices(device)
    devices = resolve_devices(devices)
    if mp < 1:
        raise ValueError(f"mp must be >= 1, got {mp}")
    if mp > 1 and getattr(problem, "lb", None) != "lb2":
        raise ValueError(R.MP_LB2_ONLY)
    D = D or 1
    kw = dict(mp=mp, fused=fused, staged=staged, partition_fn=partition_fn,
              max_steps=max_steps, checkpoint_path=checkpoint_path,
              checkpoint_interval_s=checkpoint_interval_s,
              resume_from=resume_from, guard=guard)

    if collectives is not None:
        devs = host_positions(devices, collectives.host_id,
                              collectives.num_hosts)
        try:
            local = _host_loop(problem, m, M, K, rounds, D, devs, collectives,
                               initial_best, **kw)
            red = reduce_hosts(local, collectives)
        except BaseException as e:
            abort = getattr(collectives, "abort", None)
            if abort is not None:
                abort(f"host {collectives.host_id}: {type(e).__name__}: {e}")
            raise
        return _result(local, red)

    H = num_hosts or 1
    if H == 1:
        coll = LocalCollectives()
        local = _host_loop(problem, m, M, K, rounds, D, devices, coll,
                           initial_best, **kw)
        return _result(local, reduce_hosts(local, coll))

    def host_main(coll, h):
        local = _host_loop(problem, m, M, K, rounds, D,
                           host_positions(devices, h, H), coll, initial_best,
                           **kw)
        return local, reduce_hosts(local, coll)

    outs = run_virtual_hosts(H, host_main, "tts-dmesh")
    local, red = outs[0]
    return _result(local, red)
