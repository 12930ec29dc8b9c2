"""The router's keeper thread: scrape, detect, pull, rebalance (the port
of `tpu_tree_search/fleet/health.py`).

One background thread owns every periodic concern the router has, so
the HTTP threads never block on a daemon socket:

  * **scrape loop** — every ``interval_s`` each registered daemon is
    scraped (``placement.scrape``: healthz/classes/metrics/jobs). A
    failed probe counts a miss and backs off exponentially; after
    ``max_misses`` consecutive misses the daemon is declared dead and
    the router recovers its jobs (``FleetRouter.recover_daemon`` with
    ``live=False`` — the daemon cannot answer, so recovery runs from the
    checkpoints this thread pulled while it was alive). A daemon whose
    ``/healthz`` reports ``draining`` triggers the live recovery path
    instead (cancel-with-cut -> fetch -> resubmit, the ``migrate``
    flow) while its HTTP surface still answers.
  * **checkpoint pulls** — every ``pull_interval_s`` the router copies
    each in-flight job's latest checkpoint cut (and the job record's
    exact ``steps`` at that cut) into its own ``--state-dir``. This is
    what makes SIGKILL recovery possible at all: a dead daemon serves
    nothing.
  * **rebalance** — when one daemon queues while another sits idle
    (``placement.pick_rebalance``), the hot daemon's longest-running
    checkpointed job is migrated to the idle one, at most once per
    ``rebalance_cooldown_s``.

The keeper holds no locks of its own: all shared state lives behind
``FleetView`` and the router's job map, and every callback it makes
(``recover_daemon``, ``pull_checkpoints``, ``maybe_rebalance``) is
written to be safe against concurrent HTTP-thread reads.
"""

from __future__ import annotations

import sys
import threading
import time

from . import placement


class HealthChecker(threading.Thread):
    """The keeper. ``scrape_once()`` is also callable synchronously —
    the router runs one sweep at startup so static ``--daemon`` entries
    are placeable before the first request arrives (and tests can drive
    ticks deterministically without waiting out the interval)."""

    def __init__(self, router, interval_s: float = 1.0,
                 max_misses: int = 3, backoff0_s: float = 0.5,
                 max_backoff_s: float = 10.0,
                 pull_interval_s: float = 2.0,
                 rebalance: bool = True,
                 rebalance_min_depth: int = 2,
                 rebalance_cooldown_s: float = 10.0,
                 scrape_timeout_s: float = 3.0):
        super().__init__(name="tts-fleet-keeper", daemon=True)
        self.router = router
        self.interval_s = float(interval_s)
        self.max_misses = max(1, int(max_misses))
        self.backoff0_s = float(backoff0_s)
        self.max_backoff_s = float(max_backoff_s)
        self.pull_interval_s = float(pull_interval_s)
        self.rebalance = bool(rebalance)
        self.rebalance_min_depth = int(rebalance_min_depth)
        self.rebalance_cooldown_s = float(rebalance_cooldown_s)
        self.scrape_timeout_s = float(scrape_timeout_s)
        self.stop_event = threading.Event()
        # Keeper-private bookkeeping (single-thread + startup sweep;
        # never touched by HTTP threads).
        self._dead_handled: set = set()
        self._drain_handled: set = set()
        self._next_pull = 0.0
        self._next_rebalance = 0.0
        self._last_err = 0.0

    def stop(self) -> None:
        self.stop_event.set()

    def run(self) -> None:
        while not self.stop_event.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the keeper must
                # outlive any single bad scrape/recovery; a dead keeper
                # is a router that never notices a dead daemon.
                self._report(e)

    def _report(self, e: Exception) -> None:
        now = time.monotonic()
        if now - self._last_err >= 5.0:  # rate-limited operator signal
            self._last_err = now
            print(f"fleet keeper: {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)

    def tick(self) -> None:
        self.scrape_once()
        now = time.monotonic()
        if now >= self._next_pull:
            self._next_pull = now + self.pull_interval_s
            self.router.pull_checkpoints()
        if self.rebalance and now >= self._next_rebalance:
            if self.router.maybe_rebalance(self.rebalance_min_depth):
                self._next_rebalance = (time.monotonic()
                                        + self.rebalance_cooldown_s)

    def scrape_once(self) -> None:
        """One sweep over every registered daemon: refresh snapshots,
        count misses, fire death/drain recovery exactly once per
        episode."""
        view = self.router.view
        now = time.monotonic()
        for st in view.states():
            if st.next_probe > now:
                continue  # backing off a missing daemon
            try:
                data = placement.scrape(st.url,
                                        timeout=self.scrape_timeout_s)
            except Exception as e:  # noqa: BLE001 — any failure is a miss
                misses = view.mark_miss(st, self.backoff0_s,
                                        self.max_backoff_s)
                if misses >= self.max_misses \
                        and st.url not in self._dead_handled:
                    self._dead_handled.add(st.url)
                    view.mark_dead(st)
                    self._report(e)
                    self.router.recover_daemon(st.url, live=False)
                continue
            view.mark_ok(st, data)
            self._dead_handled.discard(st.url)
            if st.draining:
                if st.url not in self._drain_handled:
                    self._drain_handled.add(st.url)
                    self.router.recover_daemon(st.url, live=True)
            else:
                self._drain_handled.discard(st.url)
