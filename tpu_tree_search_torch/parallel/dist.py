"""The distributed multi-host tier (``--tier dist``) — the port of
`tpu_tree_search/parallel/dist.py` (the reference's distributed tier,
`pfsp_dist_multigpu_chpl.chpl:313-647`; its MPI baseline,
`pfsp_dist_multigpu_cuda.c:330-816`):

  * **warm-up**: every host runs the same deterministic warm-up to
    ``H * D * m`` nodes and keeps its stride-H share (replicate and slice:
    no communication, the same partition on every host);
  * **per-host phase 2**: the multi tier's workers (`parallel/
    multidevice.py`: partition, offload, work stealing) over the host's
    devices, with a host communicator (``_HostComm``) in a thread beside
    them: the periodic incumbent all-reduce, host-mediated stealing of pool
    rows between hosts, and the two-level termination;
  * **phase 3**: each host drains its own leftovers;
  * **reductions**: tree and sol summed, best min-reduced, time
    max-reduced (`pfsp_dist_multigpu_cuda.c:680-694`), in one allgather.

Communication goes through a small collectives interface, so one search
runs three ways: one host (``LocalCollectives``); H virtual hosts in
threads of one process (``ThreadCollectives``, ``num_hosts=H``); and one
process a host (``TorchCollectives``: rank ``host_id`` of ``num_hosts`` on
a ``torch.distributed.TCPStore`` that rank 0 hosts, the counterpart of the
JAX package's coordination-service ``JaxCollectives``). The whole control
plane rides the store's key-value channel; no array collective runs, and
no CUDA tensor crosses a host: donations are numpy rows of
``ParallelSoAPool``.

Placement: the JAX package gives each virtual host its own devices and
refuses H above the device count. Here a host's D workers take the cards
round robin from the host's first (``devices[h*D % count]``), each worker on
a stream of its own, so that on one card the workers of all H hosts share
it, as the port's mesh shards do (`ROADMAP.md` C).
"""

from __future__ import annotations

import os
import pickle
import threading
import time
import uuid

from ..engine.results import Diagnostics, SearchResult
from ..obs import events as ev
from ..obs import flightrec as fr
from ..ops.backend import resolve_device
from ..pool.pool import ParallelSoAPool
from ..problems.base import Problem, batch_length
from .multidevice import default_devices, host_pipeline


def secondary_error(e: BaseException) -> bool:
    """True for an error a host raises only because a peer aborted (a
    broken barrier inside a collective, or a collective's ``TimeoutError``
    that says "peer aborted"): never the root cause."""
    return isinstance(e, threading.BrokenBarrierError) or (
        isinstance(e, TimeoutError) and "peer aborted" in str(e))


class LocalCollectives:
    """The degenerate collectives of one host."""

    num_hosts = 1
    host_id = 0

    def __init__(self):
        self._kv: dict = {}

    def allreduce_sum(self, value):
        return value

    def allreduce_min(self, value):
        return value

    def allreduce_max(self, value):
        return value

    def allgather_obj(self, value) -> list:
        return [value]

    def kv_set(self, key: str, value: bytes) -> None:
        self._kv[key] = value

    def kv_get(self, key: str, timeout_s: float) -> bytes:
        try:
            return self._kv.pop(key)
        except KeyError:
            raise TimeoutError(f"kv_get({key!r}): no such key") from None


class ThreadCollectives:
    """In-process collectives for H virtual hosts in threads (the reference's
    oversubscribed locales, `g5k_dist_multigpu_nvidia.sh:33`). A thread binds
    its host id once; ``abort`` breaks the barrier, so that every peer in a
    collective raises a secondary error."""

    def __init__(self, num_hosts: int):
        self.num_hosts = num_hosts
        self._barrier = threading.Barrier(num_hosts)
        self._lock = threading.Lock()
        self._values: list = [None] * num_hosts  # guarded-by: _lock
        self._local = threading.local()
        self._kv: dict = {}  # guarded-by: _kv_cond
        self._kv_cond = threading.Condition()

    def bind(self, host_id: int):
        """Bind the calling thread to ``host_id``."""
        self._local.host_id = host_id
        return self

    @property
    def host_id(self) -> int:
        return self._local.host_id

    def _exchange(self, value):
        with self._lock:
            self._values[self.host_id] = value
        self._barrier.wait()
        with self._lock:
            vals = list(self._values)
        self._barrier.wait()
        return vals

    def allreduce_sum(self, value):
        return sum(self._exchange(value))

    def allreduce_min(self, value):
        return min(self._exchange(value))

    def allreduce_max(self, value):
        return max(self._exchange(value))

    def allgather_obj(self, value) -> list:
        return self._exchange(value)

    def kv_set(self, key: str, value: bytes) -> None:
        with self._kv_cond:
            self._kv[key] = value
            self._kv_cond.notify_all()

    def kv_get(self, key: str, timeout_s: float) -> bytes:
        deadline = time.monotonic() + timeout_s
        with self._kv_cond:
            while key not in self._kv:
                # Short slices: an aborted barrier does not notify.
                if self._barrier.broken or time.monotonic() > deadline:
                    raise TimeoutError(
                        f"kv_get({key!r}) timed out"
                        + (" (peer aborted)" if self._barrier.broken else ""))
                self._kv_cond.wait(timeout=0.05)
            return self._kv.pop(key)

    def abort(self, reason: str = "") -> None:
        """Wake every peer blocked in a collective (they raise
        ``BrokenBarrierError``, a secondary error)."""
        self._barrier.abort()


class TorchCollectives:
    """One process a host: rank ``host_id`` of ``num_hosts`` on a
    ``torch.distributed.TCPStore`` at ``host:port``, which rank 0 hosts (the
    counterpart of `dist.py:151` ``JaxCollectives``). As there, the whole
    control plane rides the key-value store and no array collective runs:
    control tuples are a few hundred bytes at exchange rounds, and a dead
    peer surfaces as a bounded-time error (fail-stop with a root cause)
    instead of a hung collective.

    ``allgather_obj`` is ragged: each host posts its pickled blob once at a
    round-unique key and reads every peer's; a barrier follows before each
    sender deletes its own key (a blob has H-1 readers). ``kv_set`` and
    ``kv_get`` carry the point-to-point donations. Every wait is bounded by
    ``timeout_s`` (default ``AG_TIMEOUT_S``); a timeout or a lost store
    raises ``TimeoutError("... (peer aborted)")``, and so does a wait that
    finds a peer's ``abort`` key. Constructing it connects (rank 0 waits
    for every rank to connect) and raises ``ConnectionError`` when that
    fails. ``close`` keeps rank 0's store up until every rank has made its
    last call. The payloads are pickles that this program's ranks wrote."""

    #: Bounded wait of any control-plane step: longer means a dead or wedged
    #: peer, and the exchange raises instead of hanging the search.
    AG_TIMEOUT_S = 120.0
    #: A wait polls the abort key this often (seconds).
    ABORT_POLL_S = 2.0
    ABORT_KEY = "tts/abort"

    def __init__(self, host: str, port: int, num_hosts: int, host_id: int,
                 timeout_s: float | None = None):
        from datetime import timedelta

        import torch.distributed as tdist

        if num_hosts < 1 or not 0 <= host_id < num_hosts:
            raise ValueError(f"host_id {host_id} is not a rank of "
                             f"{num_hosts} host(s)")
        self.num_hosts = int(num_hosts)
        self.host_id = int(host_id)
        self.address = f"{host}:{port}"
        self.timeout_s = self.AG_TIMEOUT_S if timeout_s is None else timeout_s
        self._lock = threading.Lock()
        self._round = 0  # guarded-by: _lock
        try:
            self._store = tdist.TCPStore(
                host, int(port), self.num_hosts, self.host_id == 0,
                timeout=timedelta(seconds=self.timeout_s),
                wait_for_workers=True)
        except (RuntimeError, OSError) as e:
            raise ConnectionError(
                f"rank {host_id} of {num_hosts} cannot reach the coordinator "
                f"{self.address}: {e}") from None

    @property
    def is_master(self) -> bool:
        return self.host_id == 0

    def _call(self, fn, *args):
        """A store call; a lost store (its host died) is a peer abort."""
        try:
            return fn(*args)
        except RuntimeError as e:
            raise TimeoutError(f"the store at {self.address} failed "
                               f"(peer aborted): {e}") from None

    def _wait(self, keys: list[str], timeout_s: float, what: str) -> None:
        """Wait for ``keys``, at most ``timeout_s``; a peer's abort key ends
        the wait early. Both raise ``TimeoutError("... (peer aborted)")``."""
        from datetime import timedelta

        deadline = time.monotonic() + timeout_s
        while True:
            left = deadline - time.monotonic()
            try:
                self._store.wait(keys, timedelta(
                    seconds=max(0.001, min(self.ABORT_POLL_S, left))))
                return
            except RuntimeError as e:
                if self._call(self._store.check, [self.ABORT_KEY]):
                    reason = self._call(self._store.get, self.ABORT_KEY)
                    raise TimeoutError(
                        f"{what}: rank {self.host_id} stopped (peer aborted: "
                        f"{reason.decode(errors='replace')})") from None
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{what} timed out after {timeout_s:.1f} s on rank "
                        f"{self.host_id} (peer aborted): {e}") from None

    def allreduce_sum(self, value):
        return type(value)(sum(self.allgather_obj(value)))

    def allreduce_min(self, value):
        return type(value)(min(self.allgather_obj(value)))

    def allreduce_max(self, value):
        return type(value)(max(self.allgather_obj(value)))

    def allgather_obj(self, value) -> list:
        if self.num_hosts == 1:
            return [value]
        with self._lock:
            r = self._round
            self._round += 1
            me, H = self.host_id, self.num_hosts
            st = self._store
            key = f"tts/agobj/{r}"
            self._call(st.set, f"{key}/{me}", pickle.dumps(value))
            self._wait([f"{key}/{h}" for h in range(H) if h != me],
                       self.timeout_s, f"allgather round {r}")
            out = [value if h == me else
                   pickle.loads(self._call(st.get, f"{key}/{h}"))
                   for h in range(H)]
            if me == 0 and r > 0:
                # Every rank has posted round r, so every rank has left
                # round r-1's barrier: its keys can go.
                for k in (f"tts/agobj/{r - 1}/done", f"tts/agobj/{r - 1}/all"):
                    self._call(st.delete_key, k)
            # The barrier before each sender deletes its blob: the last
            # rank to arrive raises the round's flag.
            if self._call(st.add, f"{key}/done", 1) == H:
                self._call(st.set, f"{key}/all", b"1")
            self._wait([f"{key}/all"], self.timeout_s,
                       f"allgather round {r} barrier")
            self._call(st.delete_key, f"{key}/{me}")
        return out

    def kv_set(self, key: str, value: bytes) -> None:
        self._call(self._store.set, key, value)

    def kv_get(self, key: str, timeout_s: float) -> bytes:
        self._wait([key], min(timeout_s, self.timeout_s), f"kv_get({key!r})")
        data = self._call(self._store.get, key)
        self._call(self._store.delete_key, key)  # keys are round-unique
        return data

    def abort(self, reason: str = "") -> None:
        """Tell the peers to stop waiting (best effort: the store may be
        gone already)."""
        try:
            self._store.set(self.ABORT_KEY, (reason or "abort").encode())
        except RuntimeError:
            pass

    def close(self, wait: bool = True) -> None:
        """Leave the store: every rank counts itself out, and rank 0 (whose
        process hosts the store) waits until every rank has, at most
        ``timeout_s`` (not at all with ``wait=False``, after a failure)."""
        if self._store is None:
            return
        try:
            if self.num_hosts > 1:
                if self._call(self._store.add, "tts/closed", 1) == self.num_hosts:
                    self._call(self._store.set, "tts/closed/all", b"1")
                if wait and self.is_master:
                    self._wait(["tts/closed/all"], self.timeout_s, "close")
        except TimeoutError:
            pass  # a peer is gone: nothing is left to serve it
        finally:
            self._store = None


def collectives_from_env(coordinator: str | None = None,
                         num_hosts: int | None = None,
                         host_id: int | None = None) -> TorchCollectives:
    """``TorchCollectives`` from the flags, else from the launcher's
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    as `torchrun` sets them). Raises ``ValueError`` when one is missing."""
    if coordinator is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        coordinator = f"{addr}:{port}" if addr and port else None
    if num_hosts is None and os.environ.get("WORLD_SIZE"):
        num_hosts = int(os.environ["WORLD_SIZE"])
    if host_id is None and os.environ.get("RANK"):
        host_id = int(os.environ["RANK"])
    if coordinator is None or num_hosts is None or host_id is None:
        raise ValueError(
            "--distributed needs the coordinator, the number of hosts and "
            "this host's rank: --coordinator HOST:PORT --num-hosts H "
            "--host-id R, or MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK")
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"--coordinator must be HOST:PORT, got {coordinator!r}")
    return TorchCollectives(host, int(port), num_hosts, host_id)


class _HostComm:
    """A host's communicator (`dist.py:251-582`): the periodic incumbent
    exchange, host-mediated work stealing and the two-level termination.

    The reference steals across locales with a remote CAS on the victim's
    pool lock; hosts here share no memory, so each host runs this loop in a
    thread beside its workers, and every ``interval_s`` all hosts meet in a
    bulk-synchronous exchange round:

      1. allgather ``(size, largest pool, best, idle, want_ckpt, cut_id)``;
      2. every host adopts the global incumbent;
      3. donors (a pool of at least 2m) are matched to idle hosts below m,
         the same pairs on every host (same data, no handshake); a donor
         takes the front half of its fullest pool, capped at M nodes (the
         link's quantum under ``TTS_STEAL=hier``), and sends it
         point-to-point over ``kv_set``: only the receiver sees it;
      4. two rounds in a row with every host idle and no pool able to donate
         end the loop everywhere at once (the second round re-samples the
         sizes); the workers then leave by ``stop_event`` and each host's
         drain takes the remainder.

    While every host is busy and none is needy the cadence backs off up to
    16x ``interval_s``; any needy host resets it. A donation popped but not
    delivered (the transport failed) goes back into a local pool. A
    checkpoint is cut in a round that host 0's clock picks: every host
    snapshots in that same round, after its donations, and the set commits
    only if every host staged its file (``lockstep_commit``). The counters
    are written by the communicator's thread alone and read after it
    joins."""

    #: kv_get's wait for a matched donation (seconds mean a dead peer).
    KV_TIMEOUT_S = 120.0
    BACKOFF_MAX = 16  # the cadence back-off's cap (x interval_s)

    def __init__(self, collectives, m: int, perc: float = 0.5,
                 interval_s: float = 0.02, M: int = 50000,
                 ckpt_interval_s: float = 60.0, policy=None):
        from .topology import StealPolicy, Topology

        self.coll = collectives
        # Taken here, on the host's thread: ThreadCollectives' host id is a
        # thread's own, and run() binds the communicator's thread to it.
        self.me = collectives.host_id
        self.m = m
        self.M = M
        self.perc = perc
        self.interval_s = interval_s
        self.policy = policy or StealPolicy(
            mode="flat", topology=Topology(collectives.num_hosts), m=m,
            cap=M, interval_s=interval_s)
        self.rounds = 0
        self.blocks_sent = 0
        self.blocks_received = 0
        self.nodes_sent = 0
        self.nodes_received = 0
        self.exchange_s = 0.0  # the exchange allgathers' wall
        self.error: BaseException | None = None
        self._inflight = None  # a block popped for donation, not delivered
        self.ckpt_mgr = None  # set by run_workers under --checkpoint
        self.ckpt_interval_s = ckpt_interval_s
        self._ckpt_last = None
        # The cut's identity "<run>:<round>", proposed by host 0 and stamped
        # into every host's file, so that a resume can prove the files are
        # of one cut of one run.
        self._run_uuid = uuid.uuid4().hex[:12]

    def stats(self) -> dict:
        return {"rounds": self.rounds, "blocks_sent": self.blocks_sent,
                "blocks_received": self.blocks_received,
                "nodes_sent": self.nodes_sent,
                "nodes_received": self.nodes_received,
                "exchange_s": self.exchange_s}

    def _donate_from(self, pools: list[ParallelSoAPool], cap: int | None = None):
        """A locked front steal from the fullest local pool on a remote
        host's behalf, capped at ``cap`` (default M) nodes; None when no
        pool can spare a block."""
        victim = max(pools, key=lambda p: p.size)
        # tts-lint: waive guarded-by -- advisory racy size read; pop_front_bulk_half re-checks the 2m threshold under the lock
        if victim.size < 2 * self.m:
            return None
        if victim.try_lock():
            try:
                return victim.pop_front_bulk_half(
                    self.m, self.perc, cap=self.M if cap is None else cap)
            finally:
                victim.unlock()
        return None

    def run(self, pools: list[ParallelSoAPool], states, shared, stop_event):
        bind = getattr(self.coll, "bind", None)
        if bind is not None:
            bind(self.me)
        try:
            self._loop(pools, states, shared, stop_event)
        except BaseException as e:  # never leave the workers polling
            self.error = e
            stop_event.set()
            if self._inflight is not None:
                # The undelivered donation stays here: no node is lost.
                pools[0].locked_push_back_bulk(self._inflight)
                self._inflight = None
            abort = getattr(self.coll, "abort", None)
            if abort is not None:
                abort(f"host {self.me}: {type(e).__name__}: {e}")

    def _loop(self, pools: list[ParallelSoAPool], states, shared, stop_event):
        coll = self.coll
        H = coll.num_hosts
        me = self.me
        rrobin = 0
        backoff = 1  # the cadence multiplier
        quiescent_streak = 0
        while True:
            time.sleep(self.interval_s * backoff)
            if states.flag.is_set():
                # Under a communicator only a dying worker raises the flag
                # (the workers poll stop_event, not the all-idle scan):
                # stop here and everywhere.
                stop_event.set()
                abort = getattr(coll, "abort", None)
                if abort is not None:
                    abort(f"host {me}: a worker failed")
                return
            self.rounds += 1
            # tts-lint: waive guarded-by -- advisory racy size sample for the control tuple; quiescence needs two consecutive all-idle rounds
            size = sum(p.size for p in pools)
            # Donor eligibility and quiescence key on the largest pool, not
            # the host's sum: D pools of m-1 leftovers each can sum past 2m
            # with no pool able to donate.
            # tts-lint: waive guarded-by -- advisory racy size sample; donor eligibility is re-checked under try_lock in _donate_from
            max_pool = max(p.size for p in pools)
            idle = states._all_idle()
            best = shared.read()
            want_ckpt = False
            if self.ckpt_mgr is not None and me == 0:
                if self._ckpt_last is None:
                    self._ckpt_last = time.monotonic()
                elif time.monotonic() - self._ckpt_last >= self.ckpt_interval_s:
                    want_ckpt = True
            cut_id = f"{self._run_uuid}:{self.rounds}" if want_ckpt else None
            t_x = ev.now_us()
            t0 = time.perf_counter()
            rows = coll.allgather_obj(
                (size, max_pool, best, bool(idle), want_ckpt, cut_id))
            self.exchange_s += time.perf_counter() - t0
            gbest = min(r[2] for r in rows)
            shared.publish(gbest)
            ev.complete("exchange", t_x, wid=ev.COMM_TID, host=me, args={
                "round": self.rounds, "size": size, "best": int(gbest),
                "idle": bool(idle), "backoff": backoff})
            if gbest < best:
                ev.emit("incumbent", wid=ev.COMM_TID, host=me,
                        args={"best": int(gbest)})
            sizes = [r[0] for r in rows]
            maxes = [r[1] for r in rows]
            idles = [r[3] for r in rows]
            do_ckpt = self.ckpt_mgr is not None and rows[0][4]
            donors = sorted((h for h in range(H) if maxes[h] >= 2 * self.m),
                            key=lambda h: (-maxes[h], h))
            needy = sorted((h for h in range(H) if idles[h] and sizes[h] < self.m),
                           key=lambda h: (sizes[h], h))
            if self.policy.hier:
                pairs = self.policy.match(donors, needy, self.rounds,
                                          sizes=maxes)
            else:
                pairs = list(zip(donors, needy))
            if not pairs:
                if all(idles) and max(maxes) < 2 * self.m:
                    # Quiescent: confirm with a second round in a row.
                    quiescent_streak += 1
                    if quiescent_streak >= 2:
                        ev.emit("terminate", wid=ev.COMM_TID, host=me,
                                args={"round": self.rounds})
                        stop_event.set()
                        return
                    backoff = 1
                else:
                    quiescent_streak = 0
                    backoff = (min(backoff * 2, self.BACKOFF_MAX) if not needy
                               else 1)
            else:
                quiescent_streak = 0
                backoff = 1
                send_to = next((r for d, r in pairs if d == me), None)
                recv_from = next((d for d, r in pairs if r == me), None)
                if send_to is not None:
                    link = self.policy.link(me, send_to)
                    payload = self._donate_from(
                        pools, cap=self.policy.cap_for(link))
                    self._inflight = payload
                    blob = pickle.dumps(payload)
                    t_d = ev.now_us()
                    # The simulated link latency sleeps inside the span.
                    self.policy.sim.sleep(link)
                    coll.kv_set(f"tts/steal/{self.rounds}/{me}->{send_to}", blob)
                    self._inflight = None
                    if payload is not None:
                        self.blocks_sent += 1
                        self.nodes_sent += batch_length(payload)
                        ev.complete("donate_send", t_d, wid=ev.COMM_TID,
                                    host=me, args={
                                        "peer": send_to,
                                        "nodes": batch_length(payload),
                                        "bytes": len(blob), "link": link,
                                        "level": self.policy.level_of(link),
                                        "round": self.rounds})
                if recv_from is not None:
                    link = self.policy.link(recv_from, me)
                    t_d = ev.now_us()
                    raw = coll.kv_get(
                        f"tts/steal/{self.rounds}/{recv_from}->{me}",
                        self.KV_TIMEOUT_S)
                    batch = pickle.loads(raw)
                    if batch is not None:
                        ev.complete("donate_recv", t_d, wid=ev.COMM_TID,
                                    host=me, args={
                                        "peer": recv_from,
                                        "nodes": batch_length(batch),
                                        "bytes": len(raw), "link": link,
                                        "level": self.policy.level_of(link),
                                        "round": self.rounds})
                        # The whole block into one pool (it stays >= m, so
                        # a worker can pop it; local stealing spreads it).
                        pools[rrobin].locked_push_back_bulk(batch)
                        rrobin = (rrobin + 1) % len(pools)
                        self.blocks_received += 1
                        self.nodes_received += batch_length(batch)
                        fr.note_steal(me, link, self.policy.level_of(link))
            if do_ckpt:
                # The same round on every host, after its donations: each
                # host stages its share, and the set commits only if every
                # host staged (a donated node never appears in the files of
                # two rounds).
                from ..engine.checkpoint import lockstep_commit

                staging = self.ckpt_mgr.path + ".staging"
                ok = self.ckpt_mgr.do_checkpoint(to_path=staging,
                                                 cut_tag=rows[0][5])
                lockstep_commit(ok, staging, self.ckpt_mgr.path,
                                vote=coll.allgather_obj)
                self._ckpt_last = time.monotonic()


class _HostOutcomes:
    """The results and errors of H virtual-host threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self.results: dict = {}  # guarded-by: _lock
        self.errors: dict = {}  # guarded-by: _lock

    def put(self, h: int, result=None, error: BaseException | None = None):
        with self._lock:
            if error is None:
                self.results[h] = result
            else:
                self.errors[h] = error

    def take(self, H: int) -> list:
        """The H results in host order; or the root-cause error raised: a
        failing host aborts the collectives, so its peers, host 0 perhaps
        among them, fail with secondary errors."""
        with self._lock:
            errors = [self.errors[h] for h in sorted(self.errors)]
            results = [self.results.get(h) for h in range(H)]
        real = [e for e in errors if not secondary_error(e)]
        if real or errors:
            raise (real or errors)[0]
        return results


def run_virtual_hosts(H: int, host_main, name: str) -> list:
    """``host_main(collectives, h)`` for h in 0..H-1, each in a thread of
    its own on one ``ThreadCollectives``; returns the results in host
    order, or raises the root-cause error."""
    coll = ThreadCollectives(H)
    out = _HostOutcomes()

    def run(h: int) -> None:
        try:
            out.put(h, host_main(coll.bind(h), h))
        except BaseException as e:  # re-raised by take()
            out.put(h, error=e)
            coll.abort()

    threads = [threading.Thread(target=run, args=(h,), name=f"{name}-{h}")
               for h in range(H)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out.take(H)


def host_devices(devices: list, first: int) -> list:
    """``devices`` rotated to start at ``first`` (mod their count): a host's
    workers or shards take the cards round robin from there."""
    n = len(devices)
    return [devices[(first + i) % n] for i in range(n)]


def reduce_hosts(local: dict, coll) -> dict:
    """The cross-host reduction of one host's stats (`dist.py:655-679`, the
    `MPI_Reduce` equivalents, `pfsp_dist_multigpu_cuda.c:680-694`) in one
    allgather: tree, sol, steals, the communicator's counters and the
    offload diagnostics summed, best min-reduced, elapsed max-reduced, the
    per-worker trees concatenated in host order, ``complete`` only if every
    host completed."""
    diag = local["diag"]
    mine = {
        "tree": local["tree"], "sol": local["sol"], "best": local["best"],
        "elapsed": local["elapsed"], "steals": local["steals"],
        "comm": local.get("comm"), "per_worker_tree": local["per_worker_tree"],
        "complete": local.get("complete", True),
        "diag": (diag.kernel_launches, diag.host_to_device,
                 diag.device_to_host, diag.double_buffered),
        "extra": local.get("reduce_sum", {}),
    }
    rows = coll.allgather_obj(mine)
    comm = None
    if rows[0]["comm"] is not None:
        comm = {k: sum(r["comm"][k] for r in rows) for k in rows[0]["comm"]}
    sums = [sum(col) for col in zip(*(r["diag"] for r in rows))]
    return {
        "tree": sum(r["tree"] for r in rows),
        "sol": sum(r["sol"] for r in rows),
        "best": min(r["best"] for r in rows),
        "elapsed": max(r["elapsed"] for r in rows),
        "steals": sum(r["steals"] for r in rows),
        "comm": comm,
        "per_worker_tree": [t for r in rows for t in r["per_worker_tree"]],
        "complete": all(r["complete"] for r in rows),
        "diag": Diagnostics(kernel_launches=sums[0], host_to_device=sums[1],
                            device_to_host=sums[2], double_buffered=sums[3]),
        "extra": {k: sum(r["extra"][k] for r in rows) for k in mine["extra"]},
    }


def _host_search(problem: Problem, m: int, M: int, D: int, devices,
                 collectives, initial_best: int | None, share_bound: bool,
                 seed_base: int = 0xD157, steal: bool = True,
                 steal_interval_s: float = 0.02, perc: float = 0.5,
                 partition_fn=None, checkpoint_path: str | None = None,
                 checkpoint_interval_s: float = 60.0,
                 resume_from: str | None = None) -> dict:
    """One host's pipeline (`dist.py:584-652`): the warm-up and its stride
    share, the workers with an inter-host communicator (when ``steal`` and
    H > 1), the drain; returns its stats for the reduction. Its checkpoints
    are per-host files ``path.h<rank>``, cut in one communicator round on
    every host (or on each host's timer without stealing: no inter-host
    traffic then exists to straddle a cut)."""
    from ..ops.backend import profile_backend
    from .topology import Topology, resolve_policy

    H = collectives.num_hosts
    comm = policy = None
    if steal and H > 1:
        policy = resolve_policy(
            problem, Topology.detect(H), m=m, cap=M,
            interval_s=steal_interval_s, backend=profile_backend(devices[0]),
            topo_str=f"dist-H{H}xD{D}")
        comm = _HostComm(collectives, m, perc=perc,
                         interval_s=steal_interval_s, M=M,
                         ckpt_interval_s=checkpoint_interval_s, policy=policy)
    local = host_pipeline(
        problem, m, M, D, devices, initial_best=initial_best,
        share_bound=share_bound, num_hosts=H, host_id=collectives.host_id,
        seed=seed_base + collectives.host_id, perc=perc, comm=comm,
        partition_fn=partition_fn, checkpoint_path=checkpoint_path,
        checkpoint_interval_s=checkpoint_interval_s, resume_from=resume_from)
    if comm is not None:
        local["comm"] = comm.stats()
    if policy is not None:
        local["steal_policy"] = policy.describe()
    return local


def _result(local: dict, red: dict, problem: Problem, M: int) -> SearchResult:
    return SearchResult(
        explored_tree=red["tree"], explored_sol=red["sol"], best=red["best"],
        elapsed=red["elapsed"], phases=local["phases"],
        diagnostics=red["diag"], engine="dist", M=M,
        staged=(problem.name == "pfsp" and problem.lb == "lb2"),
        per_worker_tree=red["per_worker_tree"], steals=red["steals"],
        comm=red["comm"], steal_policy=local.get("steal_policy"))


def dist_search(problem: Problem, m: int = 25, M: int = 50000,
                D: int | None = None, num_hosts: int | None = None,
                devices=None, device=None, initial_best: int | None = None,
                share_bound: bool = True, steal: bool = True,
                steal_interval_s: float = 0.02, perc: float = 0.5,
                partition_fn=None, checkpoint_path: str | None = None,
                checkpoint_interval_s: float = 60.0,
                resume_from: str | None = None,
                collectives=None) -> SearchResult:
    """The distributed tier (``--tier dist``; `dist.py:682-810`), three ways:

      * ``collectives`` given (a ``TorchCollectives``, say): this process is
        host ``collectives.host_id`` of ``collectives.num_hosts``; it runs
        its share and returns the global result (the JAX package's
        ``jax.process_count() > 1`` mode);
      * ``num_hosts`` H > 1: H virtual hosts in threads of this process;
      * else one host, without a communicator.

    D workers a host (default: the cards over H, at least 1) on
    ``devices`` (default ``default_devices(device)``: ``cuda`` unless
    ``device="cpu"``). ``steal`` (default) runs the inter-host
    communicator (``_HostComm``) every ``steal_interval_s``; ``steal=False``
    keeps the MPI baseline's join-point-only semantics. With a fixed
    incumbent the counts equal the sequential tier's: exchanges move nodes
    and never make or drop one. The result's diagnostics (chunks, copies)
    and ``per_worker_tree`` cover every host."""
    if devices is None:
        devices = default_devices(device)
    devices = [resolve_device(d) for d in devices]
    kw = dict(share_bound=share_bound, steal_interval_s=steal_interval_s,
              perc=perc, partition_fn=partition_fn,
              checkpoint_path=checkpoint_path,
              checkpoint_interval_s=checkpoint_interval_s,
              resume_from=resume_from)

    if collectives is not None:
        H = collectives.num_hosts
        D = D or max(1, len(devices) // H)
        mine = host_devices(devices, collectives.host_id * D)
        try:
            local = _host_search(problem, m, M, D, mine, collectives,
                                 initial_best, steal=steal, **kw)
            red = reduce_hosts(local, collectives)
        except BaseException as e:
            abort = getattr(collectives, "abort", None)
            if abort is not None:
                abort(f"host {collectives.host_id}: {type(e).__name__}: {e}")
            raise
        return _result(local, red, problem, M)

    H = num_hosts or 1
    if H == 1:
        coll = LocalCollectives()
        local = _host_search(problem, m, M, D or len(devices), devices, coll,
                             initial_best, steal=False, **kw)
        return _result(local, reduce_hosts(local, coll), problem, M)

    D = D or max(1, len(devices) // H)

    def host_main(coll, h):
        local = _host_search(problem, m, M, D, host_devices(devices, h * D),
                             coll, initial_best, steal=steal, **kw)
        return local, reduce_hosts(local, coll)

    outs = run_virtual_hosts(H, host_main, "tts-host")
    local, red = outs[0]
    return _result(local, red, problem, M)
