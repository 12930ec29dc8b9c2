"""The serve daemon of the port — `tpu_tree_search/serve/`, on the card.

One long-lived process owns the card, admits search jobs over a localhost
HTTP/JSON API, and keeps every resident program (and the CUDA graphs built
on it) alive between jobs, so a second same-class job admits with zero new
programs and zero new graphs.

Layout (each module owns one concern, as in the JAX package):

  * ``jobs.py``      — job specs (validated JSON), the Job record, and the
    durable on-disk registry (the JAX package's record format: a registry
    written by either package loads in the other);
  * ``pool.py``      — shape-class admission control: requests map to a
    class and share one problem instance per identity, so the programs
    cached on it (`engine/resident.py`, `engine/batched.py`) serve every
    job of the class;
  * ``scheduler.py`` — worker threads + checkpoint-based preemption
    (``resident_search``'s ``yield_fn``: drain, cut, resume, bit-identical)
    and the env-knob lease;
  * ``batch.py``     — the instance-axis batch executor: with
    ``--batch-slots B`` one batched program advances up to B same-class
    jobs a dispatch (one CUDA graph on the card), splicing and retiring
    jobs at dispatch boundaries without building a graph;
  * ``server.py``    — the stdlib HTTP/SSE daemon and its SIGTERM drain;
  * ``client.py``    — ``submit``, ``watch --job``, ``top`` and ``migrate``;
  * ``warmup.py``    — the warm matrix: ``warmup``'s per-config hit/miss
    on the port's build directory, and ``serve --warm``.

The serving path is stdlib-only: torch and the card are touched only by
the scheduler's worker threads; the HTTP threads and ``/metrics`` read
Python attributes.
"""

from __future__ import annotations

DEFAULT_PORT = 8643  # one above obs/live's default watch port

#: Daemon version, surfaced on ``/healthz`` and ``/metrics``
#: (``tts_serve_build_info``). The JAX package's daemon is 0.13.0; the
#: HTTP API and the job-record schema are the same.
VERSION = "0.13.0"

__all__ = ["DEFAULT_PORT", "VERSION"]
