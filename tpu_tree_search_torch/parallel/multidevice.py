"""Multi-device search: one host thread and one private pool a worker, a
static partition, work stealing and idle-scan termination — the port of
`tpu_tree_search/parallel/multidevice.py` (the reference's multi-GPU tier,
`pfsp_multigpu_chpl.chpl:312-535`, `nqueens_multigpu_chpl.chpl:152-346`):

  * warm-up on the main thread until the global pool holds ``D * m`` nodes
    (`nqueens_multigpu_chpl.chpl:173`);
  * static round-robin partition: worker w takes elements w, w+D, w+2D ...
    of the warm pool, so sibling subtrees land on different workers
    (`nqueens_multigpu_chpl.chpl:221-225`);
  * each worker offloads chunks of its pool through its own
    ``DeviceOffloader`` with one chunk in flight (the kernels of the
    problem's bound: kernel 1, 5, 1 and 7 staged lb2, or 3), prunes
    against its own incumbent and, with ``share_bound`` (the default),
    publishes and adopts the global best between chunks;
  * a worker whose pool runs dry steals from victims in random order
    (`nqueens_multigpu_chpl.chpl:441`), up to 10 lock attempts a victim,
    half the victim's front iff it holds at least 2m (`Pool_par.chpl:
    180-191`);
  * termination: the idle-state array and its sticky all-idle scan
    (`utils/termination.py`, `util.chpl:16-30`);
  * leftovers drain back to one pool, the counts sum and the incumbents
    fold at the join (`pfsp_multigpu_chpl.chpl:498-520`), and the main
    thread drains the rest.

Devices and streams: worker w runs on ``devices[w % len(devices)]``, so a
D above the card count puts several workers on one card, as the JAX tier
oversubscribes its devices. PyTorch's current stream is a thread's own, and
a kernel entry launches on the caller's: each worker makes its own
``torch.cuda.Stream`` and runs its whole loop on it, so the workers'
copies and kernels overlap instead of queueing on the default stream. Its
offloader's pinned buffers and events are its own. A worker's error stops
every worker and re-raises from ``run_workers``.

With ``share_bound`` the incumbent a chunk prunes against depends on the
threads' timing, so the tree is exact only under a fixed incumbent
(N-Queens; PFSP ub=1 or ``initial_best`` at the optimum), as in JAX.
Checkpoints (``checkpoint_path``) pause every worker at a chunk boundary
and save the union of their pools in the tier-agnostic format
(`engine/checkpoint.py`): a multi cut resumes on the device tier and the
other way round.

The multi-host hooks (`multidevice.py:241-628`) serve the dist tier
(`parallel/dist.py`): ``host_pipeline`` with ``num_hosts`` H > 1 runs the
same deterministic warm-up to ``H*D*m`` on every host and keeps the
stride-H share of ``host_id`` (or ``partition_fn``'s), and writes and
reads the per-host files ``path.h<host_id>``; ``run_workers`` with a host
communicator ``comm`` runs its loop in a thread beside the workers, which
then leave when it sets ``stop_event`` (global termination, or its
failure: unlike the JAX workers they do not run their pools out first),
not on local all-idle; the communicator cuts checkpoints in its exchange
rounds.
"""

from __future__ import annotations

import threading
import time
from contextlib import ExitStack

import numpy as np
import torch

from ..engine.device import DeviceOffloader, drain, warmup
from ..engine.results import Diagnostics, PhaseStats, SearchResult
from ..obs import events as ev
from ..obs import flightrec as fr
from ..ops.backend import resolve_device, resolve_devices
from ..pool.pool import ParallelSoAPool, SoAPool
from ..problems.base import INF_BOUND, Problem, batch_length, index_batch
from ..utils import TaskStates


class _SharedBest:
    """The mid-search incumbent exchange (`multidevice.py:43-59`; the
    reference reconciles incumbents only at the end)."""

    def __init__(self, value: int):
        self._value = value  # guarded-by: _lock
        self._lock = threading.Lock()

    def publish(self, value: int) -> int:
        with self._lock:
            if value < self._value:
                self._value = value
            return self._value

    def read(self) -> int:
        with self._lock:
            return self._value


class PauseGate:
    """Chunk-boundary rendezvous for checkpoints (`multidevice.py:62-122`).

    A worker at the top of its loop holds no node outside its pool (its
    last chunk's children are pushed, its in-flight chunk consumed by the
    ``flush``), so pausing every live worker there leaves pools whose
    union is the exact frontier. Workers call ``poll`` once an iteration
    and ``leave`` on exit; the checkpoint brackets its snapshot with
    ``pause`` and ``resume``."""

    def __init__(self, n_workers: int):
        self._cond = threading.Condition()
        self.active = n_workers  # guarded-by: _cond
        self.paused = 0  # guarded-by: _cond
        self.want = False  # guarded-by: _cond

    def poll(self, flush=None) -> None:
        """Park while a pause is wanted; ``flush`` (called outside the lock
        first) consumes the worker's in-flight chunk."""
        with self._cond:
            if not self.want:
                return
        if flush is not None:
            flush()
        with self._cond:
            self.paused += 1
            self._cond.notify_all()
            while self.want:
                self._cond.wait()
            self.paused -= 1
            self._cond.notify_all()

    def leave(self) -> None:
        with self._cond:
            self.active -= 1
            self._cond.notify_all()

    def pause(self) -> None:
        with self._cond:
            self.want = True
            while self.paused < self.active:
                self._cond.wait()

    def resume(self) -> None:
        """Release the parked workers, and return once each has left the
        pause: a pause that follows at once (``--checkpoint-interval 0``)
        cannot find them still parked and hold them there for good."""
        with self._cond:
            self.want = False
            self._cond.notify_all()
            while self.paused > 0:
                self._cond.wait()

    def all_left(self) -> bool:
        """True once every worker has exited (the timer's stop test)."""
        with self._cond:
            return self.active == 0


class CheckpointManager:
    """Pause the workers, merge their pools' frontiers into one batch and
    save it (`multidevice.py:125-205`). ``base_tree``/``base_sol`` carry
    the counts of the phases outside the workers (the warm-up, a resumed
    run's history)."""

    def __init__(self, problem: Problem, path: str, gate: PauseGate,
                 pools: list[ParallelSoAPool], workers, shared,
                 base_tree: int, base_sol: int, interval_s: float = 60.0,
                 hosts: int = 1):
        self.problem = problem
        self.path = path
        self.gate = gate
        self.pools = pools
        self.workers = workers
        self.shared = shared
        self.base_tree = base_tree
        self.base_sol = base_sol
        self.interval_s = interval_s
        self.hosts = hosts  # per-host files of an H-host set (format v4)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def do_checkpoint(self, to_path: str | None = None,
                      cut_tag: int | str | None = None) -> bool:
        """Pause, snapshot, save. Returns False, and writes nothing, when a
        worker has died: its popped chunk is gone from the pools, and a cut
        would lose a subtree. ``to_path`` is the dist tier's staging file of
        its two-phase commit, ``cut_tag`` the lockstep cut's identity."""
        from ..engine import checkpoint as ckpt

        t_cut = ev.now_us()
        self.gate.pause()
        try:
            if any(w.error is not None for w in self.workers):
                return False
            merged = {k: [] for k in self.problem.empty_batch(0)}
            for p in self.pools:
                # tts-lint: waive guarded-by -- workers are quiesced at the PauseGate rendezvous; no thread can mutate pools until resume()
                b = p.as_batch()
                for k in merged:
                    merged[k].append(b[k])
            batch = {k: np.concatenate(v) for k, v in merged.items()}
            tree = self.base_tree + sum(w.tree for w in self.workers)
            sol = self.base_sol + sum(w.sol for w in self.workers)
            best = min(
                [self.shared.read() if self.shared is not None else INF_BOUND]
                + [w.best for w in self.workers])
            ckpt.save(to_path or self.path, self.problem, batch, best, tree,
                      sol, hosts=self.hosts, cut_tag=cut_tag)
            ev.complete("checkpoint", t_cut, wid=ev.COMM_TID,
                        args={"nodes": int(batch_length(batch))})
            return True
        finally:
            self.gate.resume()

    # -- timer mode (the multi tier; the dist tier cuts from its
    # communicator's rounds, so that every host cuts in the same one) ------
    def _timer_loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            if self.gate.all_left():
                return
            self.do_checkpoint()

    def start_timer(self) -> None:
        self._thread = threading.Thread(target=self._timer_loop,
                                        name="tts-ckpt", daemon=True)
        self._thread.start()

    def stop_timer(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join()


class _Worker:
    def __init__(self, wid: int, problem: Problem, pool: ParallelSoAPool,
                 device: torch.device):
        self.wid = wid
        self.problem = problem
        self.pool = pool
        self.device = device
        self.tree = 0
        self.sol = 0
        self.best = INF_BOUND
        self.steals = 0
        self.chunks = 0  # consumed chunks (the flight recorder's sequence)
        # The last steal's link class and hierarchy level (a worker's own
        # steals are local/0; `parallel/topology.py`), carried on the
        # heartbeats so that the flight recorder and `watch` name the steal
        # level a worker lives off.
        self.steal_link: str | None = None
        self.steal_level: int | None = None
        self.diagnostics = Diagnostics()
        self.error: BaseException | None = None


def _partition(problem: Problem, pool: SoAPool, D: int) -> list[ParallelSoAPool]:
    """The static stride-D split of the warm pool
    (`nqueens_multigpu_chpl.chpl:199-225`): worker w gets elements w::D."""
    batch = pool.as_batch()
    pools = []
    for w in range(D):
        p = ParallelSoAPool(problem.node_fields())
        # tts-lint: waive guarded-by -- pool is thread-local until run_workers hands it to a worker thread
        p.push_back_bulk({k: v[w::D] for k, v in batch.items()})
        pools.append(p)
    return pools


def worker_streams(device: torch.device) -> ExitStack:
    """The context a worker's loop runs in: on the card, its device and a
    stream of its own (synchronised when the loop leaves)."""
    stack = ExitStack()
    if device.type == "cuda":
        stream = torch.cuda.Stream(device)
        stack.enter_context(torch.cuda.device(device))
        stack.enter_context(torch.cuda.stream(stream))
        stack.callback(stream.synchronize)
    return stack


def _worker_loop(w: _Worker, pools: list[ParallelSoAPool], states: TaskStates,
                 m: int, M: int, shared: _SharedBest | None,
                 rng: np.random.Generator, perc: float = 0.5,
                 stop_event: threading.Event | None = None,
                 gate: PauseGate | None = None, host_id: int = 0) -> None:
    """One worker (`multidevice.py:241-397`): pop a chunk of its pool,
    dispatch it with the previous chunk in flight, steal when dry, and
    leave when every worker is idle — or, under a host communicator
    (``stop_event``), when it declares global termination."""
    problem = w.problem
    idle_t0: float | None = None  # open idle span (tracing)
    pending = None  # (staged parents, count, handle, t_chunk) in flight
    try:
        with worker_streams(w.device):
            off = DeviceOffloader(problem, w.device)
            w.diagnostics = off.diagnostics
            D = len(pools)
            chunk_buf = problem.empty_batch(M)

            def consume_pending() -> None:
                # Branch the in-flight chunk on the host and push its
                # children; the next chunk's copy and evaluation ride the
                # worker's stream meanwhile.
                nonlocal pending
                if pending is None:
                    return
                staged, count, handle, t_chunk = pending
                pending = None
                res = problem.generate_children(staged, count,
                                                off.collect(handle), w.best)
                w.tree += res.tree_inc
                w.sol += res.sol_inc
                if res.best < w.best:
                    w.best = res.best
                    if shared is not None:
                        w.best = shared.publish(w.best)
                    ev.emit("incumbent", wid=w.wid, host=host_id,
                            args={"best": w.best})
                w.pool.locked_push_back_bulk(res.children)
                w.chunks += 1
                ev.complete("chunk", t_chunk, wid=w.wid, host=host_id,
                            args={"count": count, "tree": res.tree_inc,
                                  "sol": res.sol_inc})
                fr.heartbeat("multi", host=host_id, wid=w.wid, seq=w.chunks,
                             best=w.best, tree=w.tree, sol=w.sol,
                             steals=w.steals, steal_link=w.steal_link,
                             steal_level=w.steal_level)

            while True:
                if stop_event is not None and stop_event.is_set():
                    # The communicator ended the search: at global
                    # termination every pool is below m (the drain takes
                    # it); after a failure (a dead peer, a dead worker)
                    # no worker runs its pool out first.
                    consume_pending()
                    return
                if gate is not None:
                    gate.poll(flush=consume_pending)
                # BUSY before the pop: an outside idle sampler (the dist
                # tier's communicator) must never see a worker that holds a
                # chunk as idle.
                states.set_busy(w.wid)
                count = w.pool.locked_pop_back_bulk(m, M, chunk_buf)
                if count > 0:
                    if idle_t0 is not None:
                        ev.complete("idle", idle_t0, wid=w.wid, host=host_id)
                        idle_t0 = None
                        fr.set_idle(host_id, w.wid, False)
                    t_chunk = ev.now_us()
                    if shared is not None:
                        w.best = min(w.best, shared.read())
                    staged, handle = off.dispatch(
                        chunk_buf, count, w.best,
                        overlapped=pending is not None)
                    nxt = (staged, count, handle, t_chunk)
                    consume_pending()
                    pending = nxt
                    continue
                if pending is not None:
                    # Dry, but a chunk is in flight: its children may refill
                    # the pool, so neither steal nor go idle yet.
                    consume_pending()
                    continue
                # -- work stealing (`pfsp_multigpu_chpl.chpl:438-479`) -----
                stolen = False
                t_steal = ev.now_us()
                for victim_id in rng.permutation(D):
                    if victim_id == w.wid:
                        continue
                    victim = pools[victim_id]
                    for _ in range(10):  # lock attempts a victim
                        if victim.try_lock():
                            try:
                                batch = victim.pop_front_bulk_half(m, perc)
                            finally:
                                victim.unlock()
                            if batch is not None:
                                w.pool.locked_push_back_bulk(batch)
                                w.steals += 1
                                w.steal_link, w.steal_level = "local", 0
                                stolen = True
                                ev.complete("steal", t_steal, wid=w.wid,
                                            host=host_id, args={
                                                "victim": int(victim_id),
                                                "nodes": batch_length(batch),
                                                "bytes": sum(
                                                    a.nbytes
                                                    for a in batch.values()),
                                                "link": "local", "level": 0})
                            break
                        time.sleep(0)  # yield, as `yieldExecution`
                    if stolen:
                        break
                if stolen:
                    states.set_busy(w.wid)
                    continue
                # -- termination (`pfsp_multigpu_chpl.chpl:481-495`) -------
                states.set_idle(w.wid)
                if idle_t0 is None:
                    # One miss a busy -> idle transition, not one a scan.
                    ev.emit("steal_miss", wid=w.wid, host=host_id,
                            args={"link": "local", "level": 0})
                    idle_t0 = ev.now_us()
                    fr.set_idle(host_id, w.wid, True)
                if stop_event is not None:
                    # Under a host communicator local all-idle is not the
                    # end: a donation from another host may still come. Poll
                    # until it declares global termination (the two-level
                    # scheme, `pfsp_dist_multigpu_chpl.chpl:569-587`).
                    if stop_event.is_set():
                        return
                    time.sleep(0.0005)
                    continue
                if states.all_idle():
                    return
                time.sleep(0)
    except BaseException as e:  # surfaces in run_workers
        w.error = e
        states.set_idle(w.wid)
        states.flag.set()  # every worker leaves; the search aborts
    finally:
        if idle_t0 is not None:
            ev.complete("idle", idle_t0, wid=w.wid, host=host_id)
        ev.counter("explored", wid=w.wid, host=host_id, tree=w.tree,
                   sol=w.sol, phase=2)
        if gate is not None:
            gate.leave()


def run_workers(problem: Problem, pool: SoAPool, D: int, assigned, m: int,
                M: int, best: int, share_bound: bool = True,
                seed: int = 0xB0B, perc: float = 0.5, comm=None,
                ckpt_path: str | None = None, ckpt_interval_s: float = 60.0,
                ckpt_base: tuple[int, int] = (0, 0), ckpt_hosts: int = 1,
                host_id: int = 0):
    """Phase 2 (`multidevice.py:400-492`): partition ``pool`` over D worker
    threads (worker w on ``assigned[w]``), run them, join, and merge their
    leftovers into a new pool. Returns ``(leftover pool, tree, sol, best,
    workers)``. Re-raises the first worker error, then the communicator's.

    ``comm`` (the dist tier): a host communicator with a ``run(pools,
    states, shared, stop_event)`` method, run in a thread of its own beside
    the workers. It owns global termination and the checkpoints' timing
    (``ckpt_mgr``); the incumbent is then always shared."""
    fr.arm("multi")
    pools = _partition(problem, pool, D)
    leftover = SoAPool(problem.node_fields())
    states = TaskStates(D)
    shared = _SharedBest(best) if share_bound or comm is not None else None
    workers = [_Worker(w, problem, pools[w], assigned[w]) for w in range(D)]
    for w in workers:
        w.best = best
    stop_event = threading.Event() if comm is not None else None
    gate = mgr = None
    if ckpt_path is not None:
        gate = PauseGate(D)
        mgr = CheckpointManager(problem, ckpt_path, gate, pools, workers,
                                shared, base_tree=ckpt_base[0],
                                base_sol=ckpt_base[1],
                                interval_s=ckpt_interval_s, hosts=ckpt_hosts)
        if comm is not None:
            # Every host cuts in the same exchange round, so no donation
            # straddles the snapshot.
            comm.ckpt_mgr = mgr
        else:
            mgr.start_timer()
    seeds = np.random.SeedSequence(seed)
    threads = [
        threading.Thread(
            target=_worker_loop,
            args=(w, pools, states, m, M, shared, np.random.default_rng(s),
                  perc, stop_event, gate, host_id),
            name=f"tts-worker-{host_id}.{w.wid}")
        for w, s in zip(workers, seeds.spawn(D))
    ]
    comm_thread = None
    if comm is not None:
        comm_thread = threading.Thread(
            target=comm.run, args=(pools, states, shared, stop_event),
            name=f"tts-host-comm-{host_id}")
        comm_thread.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if comm_thread is not None:
        comm_thread.join()
    elif mgr is not None:
        mgr.stop_timer()
    for w in workers:
        if w.error is not None:
            raise w.error
    if comm is not None and comm.error is not None:
        raise comm.error
    for p in pools:
        # tts-lint: waive guarded-by -- worker and communicator threads are joined; no concurrent access remains
        leftover.push_back_bulk(p.as_batch())
    tree2 = sum(w.tree for w in workers)
    sol2 = sum(w.sol for w in workers)
    best = min([best] + [w.best for w in workers])  # `:518-520`
    return leftover, tree2, sol2, best, workers


def host_share(problem: Problem, warm: SoAPool, host_id: int, num_hosts: int,
               partition_fn=None) -> SoAPool:
    """Host ``host_id``'s share of the warm pool every host built alike:
    its stride-H slice, or what ``partition_fn(batch, host_id, H)`` returns
    (skewed partitions, to drive inter-host stealing in tests)."""
    batch = warm.as_batch()
    pool = SoAPool(problem.node_fields())
    if partition_fn is None:
        pool.push_back_bulk({k: v[host_id::num_hosts] for k, v in batch.items()})
    else:
        pool.push_back_bulk(partition_fn(batch, host_id, num_hosts))
    return pool


def check_same_cut(coll, cut_tag) -> None:
    """Refuse a multi-host resume whose per-host files come from different
    lockstep cuts (a host that crashed between the commit's vote and its
    rename, or stale files of an earlier run with the same host count):
    their union is no frontier, and nodes donated between the cuts would be
    lost or explored twice. Every host calls it (an allgather)."""
    tags = coll.allgather_obj(cut_tag)
    if len(set(tags)) != 1:
        raise ValueError(
            "incoherent multi-host resume: per-host checkpoint files come "
            f"from different cuts ({tags}); restore a matching set (same "
            "run, same communicator round) before resuming")


def host_pipeline(problem: Problem, m: int, M: int, D: int, devices,
                  initial_best: int | None = None, share_bound: bool = True,
                  num_hosts: int = 1, host_id: int = 0,
                  seed: int = 0xB0B, perc: float = 0.5, comm=None,
                  partition_fn=None,
                  checkpoint_path: str | None = None,
                  checkpoint_interval_s: float = 60.0,
                  resume_from: str | None = None) -> dict:
    """The three phases one host runs (`multidevice.py:495-626`): warm-up,
    the partitioned parallel offload, the drain. Returns its stats.

    With one host this is the whole multi tier (warm-up to ``D*m``). With
    H = ``num_hosts`` hosts every host runs the same deterministic warm-up
    to ``H*D*m`` and keeps the stride-H share of ``host_id`` (or what
    ``partition_fn(warm, host_id, H)`` returns): the dist tier's
    replicate-and-slice partition (`pfsp_dist_multigpu_chpl.chpl:339-374`)
    without communication; host 0 alone counts the warm-up. Checkpoints
    then are per-host files ``path.h<host_id>``, and a resume under a
    communicator checks that every host's file is of the same cut."""
    assigned = [devices[w % len(devices)] for w in range(D)]
    best = (initial_best if initial_best is not None
            else getattr(problem, "initial_ub", INF_BOUND))
    suffix = f".h{host_id}" if num_hosts > 1 else ""
    eff_ckpt = None if checkpoint_path is None else checkpoint_path + suffix
    eff_resume = None if resume_from is None else resume_from + suffix

    pool = SoAPool(problem.node_fields())
    problem._native()  # a first call builds it: outside the timed phases
    for dev in set(assigned):
        if problem.name == "pfsp":
            # Built here, before any worker starts (device_tables also
            # synchronises its copy).
            problem.device_tables(dev)
    t0 = time.perf_counter()
    if eff_resume is not None:
        # The loaded frontier replaces the warm-up (the tier-agnostic
        # format of every tier): this host's share.
        from ..engine import checkpoint as ckpt_mod

        loaded = ckpt_mod.load(eff_resume, problem, expect_hosts=num_hosts)
        if comm is not None:
            check_same_cut(comm.coll, loaded.cut_tag)
        pool.push_back_bulk(loaded.batch)
        tree1 = sol1 = 0
        base_tree, base_sol = loaded.tree, loaded.sol
        best = min(best, loaded.best)
    else:
        base_tree = base_sol = 0
        pool.push_back(index_batch(problem.root(), 0))
        # -- step 1: warm-up to H*D*m (`nqueens_multigpu_chpl.chpl:173`,
        # the dist target `pfsp_dist_multigpu_chpl.chpl:339-345`) ----------
        tree1, sol1, best = warmup(problem, pool, best, num_hosts * D * m)
        if num_hosts > 1:
            pool = host_share(problem, pool, host_id, num_hosts, partition_fn)
            if host_id != 0:
                tree1 = sol1 = 0
    t1 = time.perf_counter()
    ev.counter("explored", host=host_id, tree=base_tree + tree1,
               sol=base_sol + sol1, phase=1)

    # -- step 2: the partitioned parallel offload ---------------------------
    pool, tree2, sol2, best, workers = run_workers(
        problem, pool, D, assigned, m, M, best, share_bound, seed=seed,
        perc=perc, comm=comm, ckpt_path=eff_ckpt,
        ckpt_interval_s=checkpoint_interval_s,
        ckpt_base=(base_tree + tree1, base_sol + sol1),
        ckpt_hosts=num_hosts, host_id=host_id)
    t2 = time.perf_counter()

    # -- step 3: drain (`pfsp_multigpu_chpl.chpl:529-535`) --------------------
    tree3, sol3, best = drain(problem, pool, best)
    t3 = time.perf_counter()
    ev.counter("explored", host=host_id, tree=tree3, sol=sol3, phase=3)
    diag = Diagnostics(
        kernel_launches=sum(w.diagnostics.kernel_launches for w in workers),
        host_to_device=sum(w.diagnostics.host_to_device for w in workers),
        device_to_host=sum(w.diagnostics.device_to_host for w in workers),
        double_buffered=sum(w.diagnostics.double_buffered for w in workers),
    )
    return {
        "tree": base_tree + tree1 + tree2 + tree3,
        "sol": base_sol + sol1 + sol2 + sol3,
        "best": best,
        "steals": sum(w.steals for w in workers),
        "phases": [PhaseStats(t1 - t0, tree1, sol1),
                   PhaseStats(t2 - t1, tree2, sol2),
                   PhaseStats(t3 - t2, tree3, sol3)],
        "elapsed": t3 - t0,
        "per_worker_tree": [w.tree for w in workers],
        "diag": diag,
    }


def default_devices(device=None) -> list[torch.device]:
    """The devices of a multi-device run: every card (``device`` None or
    ``"cuda"``), the one card named (``"cuda:1"``), or the CPU
    (``"cpu"``: the plain PyTorch path)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device("cuda")  # raises when there is no card
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device(dev)]


def multidevice_search(problem: Problem, m: int = 25, M: int = 50000,
                       D: int | None = None, devices=None, device=None,
                       initial_best: int | None = None,
                       share_bound: bool = True, perc: float = 0.5,
                       checkpoint_path: str | None = None,
                       checkpoint_interval_s: float = 60.0,
                       resume_from: str | None = None) -> SearchResult:
    """The multi-device tier (``--tier multi``): D workers (default: one a
    device) over ``devices`` (default ``default_devices(device)``), chunks
    of up to M parents while a worker's pool holds at least m, work
    stealing of ``perc`` of a victim's front. Checkpoints as the module
    docstring says."""
    if devices is None:
        devices = default_devices(device)
    devices = resolve_devices(devices)
    if D is None:
        D = len(devices)
    if D < 1:
        raise ValueError(f"D must be >= 1, got {D}")
    local = host_pipeline(
        problem, m, M, D, devices, initial_best, share_bound, perc=perc,
        checkpoint_path=checkpoint_path,
        checkpoint_interval_s=checkpoint_interval_s, resume_from=resume_from)
    return SearchResult(
        explored_tree=local["tree"],
        explored_sol=local["sol"],
        best=local["best"],
        elapsed=local["elapsed"],
        phases=local["phases"],
        diagnostics=local["diag"],
        engine="multi",
        M=M,
        staged=(problem.name == "pfsp" and problem.lb == "lb2"),
        per_worker_tree=local["per_worker_tree"],
        steals=local["steals"],
    )
