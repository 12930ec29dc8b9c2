"""``fleet`` — class-aware routing over N serve daemons (the port of
`tpu_tree_search/fleet/`).

The serve daemon (``serve/``) made one process a multi-tenant search
service: shape-class program pooling, checkpoint preemption, instance
batching, ``/metrics``. This package is its front-end: one router process
that owns *placement* across many daemons, so a tenant talks to a single
URL and jobs land where their programs and dispatch graphs already live.

Layout (each module owns one concern):

  * ``placement.py`` — the scraped per-daemon state (``/healthz`` +
    ``/classes`` + ``/metrics`` + ``/jobs``) and the pure placement
    policy: warm-class-with-free-slot first (admission that builds
    nothing, the same ``serve/pool.class_key`` computation), weighted
    least-loaded otherwise (queue depth, measured queue wait, pool bytes,
    class occupancy);
  * ``health.py``    — the background keeper thread: scrape loop with
    miss-counting + exponential backoff, daemon death/drain detection,
    periodic checkpoint pulls for in-flight jobs (the recovery fuel),
    and conservative hot->idle rebalancing of long-runners;
  * ``router.py``    — the stdlib HTTP router daemon (the same zero-dep
    127.0.0.1 pattern as ``serve/server.py``): placement + lifecycle
    proxy (``/submit``, ``/job/<id>``, SSE pass-through, cancel) with a
    durable fleet-job -> daemon map under ``--state-dir``, and the
    failure-recovery path built on the ``migrate`` checkpoint transport
    (resubmit the last pulled cut + remaining budget elsewhere — equal,
    count for count, to an uninterrupted run);
  * ``loadgen.py``   — the seeded synthetic traffic generator (mixed
    shape classes, heavy-tailed job sizes, Poisson arrivals) and the
    saturation-curve runner (a library: the port has no bench yet).

The router is **host-only**: it never imports torch, never constructs a
problem, and no knob it reads (``TTS_ROUTER``) appears in any program
cache key — pinned by tests/test_torch_fleet.py. Its daemons may be either
package's: the HTTP API and the checkpoint format are shared.
"""

from __future__ import annotations

#: One above the serve daemon's default (8643), itself one above the
#: obs/live watch port (8642).
DEFAULT_ROUTER_PORT = 8644

__all__ = ["DEFAULT_ROUTER_PORT"]
