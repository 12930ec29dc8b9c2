"""The ``serve`` daemon: localhost HTTP/JSON + per-job SSE
(`tpu_tree_search/serve/server.py`: the same API).

Zero-dependency by the same rule as ``obs/live.py`` (stdlib
``http.server`` only, bound to 127.0.0.1 — an operator-side service, not
an internet surface). The HTTP threads only touch the registry, the
scheduler queue, and the pool's bookkeeping (Python attributes); torch
and the card live entirely in the scheduler workers. ``ServeDaemon``
takes the device its jobs run on (``cuda`` by default; ``"cpu"`` runs the
plain path).

API (all JSON):

  * ``POST /submit``             — body: a job spec (serve/jobs.py).
    201 -> ``{id, class, warm, position}``; 400 invalid spec; 503 when
    the queue is at ``--max-queue`` (admission control back-pressure).
  * ``GET  /jobs``               — every job record, id-ordered.
  * ``GET  /job/<id>``           — one job record (404 unknown).
  * ``GET  /job/<id>/result``    — the result record; 409 until the job
    reaches a terminal state (a blocking client polls or streams).
  * ``POST /job/<id>/cancel``    — cancel queued now / running at the
    next dispatch boundary; 409 when already finished.
  * ``GET  /job/<id>/checkpoint``— the job's checkpoint as raw npz bytes
    (409 when the job has none) — with ``resume_ckpt_b64`` on ``/submit``
    this is the ``tts migrate`` transport: cut on daemon A, resubmit the
    spec + checkpoint on daemon B, counters stay cumulative.
  * ``GET  /job/<id>/stream``    — SSE: one frame per new snapshot from
    the job's private flight-recorder ring (incumbent, nodes/s, pool
    occupancy ...) plus ``event: incumbent`` frames — one per recorded
    quality-trajectory improvement, all flushed before the terminal
    ``event: done`` frame carrying the final job record — one connection
    is the whole job story.
  * ``GET  /classes``            — program-pool stats per shape class.
  * ``GET  /metrics``            — Prometheus text format (serve/metrics.py):
    queue depth, jobs by state/class, admission outcomes, pool occupancy,
    compile deltas, preemptions, wait/run histograms.
  * ``GET  /healthz``            — liveness + queue depth + ``uptime_s``,
    ``version`` and ``workers_alive`` (a dead worker thread must not hide
    behind a healthy-looking HTTP surface).
  * ``POST /shutdown``           — graceful drain (same path as SIGTERM).
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse

from ..obs.live import sse_begin, stream_snapshots
from . import DEFAULT_PORT, VERSION
from . import metrics as metrics_mod
from .jobs import JobRegistry, validate_spec
from .pool import ProgramPool
from .scheduler import Scheduler

#: Jobs in a terminal state (no further transitions).
FINAL_STATES = ("done", "failed", "cancelled")


def default_state_dir() -> str:
    return os.environ.get("TTS_SERVE_STATE") or os.path.join(
        os.path.expanduser("~"), ".cache", "tpu_tree_search_torch", "serve"
    )


class ServeDaemon:
    """The daemon's spine: registry + pool + scheduler + HTTP server."""

    def __init__(self, port: int = DEFAULT_PORT, host: str = "127.0.0.1",
                 state_dir: str | None = None, workers: int = 1,
                 quantum_s: float = 5.0, max_queue: int = 64,
                 batch_slots: int | None = None,
                 ckpt_every_s: float | None = None, device=None):
        from ..ops.backend import resolve_device

        # Resolved here, in the constructor's thread: cuda raises when the
        # machine has no card (no fallback to the CPU).
        self.device = resolve_device(device)
        self.state_dir = state_dir or default_state_dir()
        os.makedirs(self.state_dir, exist_ok=True)
        self.registry = JobRegistry(self.state_dir)
        self.loaded = self.registry.load()
        self.pool = ProgramPool()
        self.metrics = metrics_mod.ServeMetrics()
        self.started = time.time()
        self.scheduler = Scheduler(self.registry, self.pool, workers=workers,
                                   quantum_s=quantum_s,
                                   state_dir=self.state_dir,
                                   metrics=self.metrics,
                                   batch_slots=batch_slots,
                                   ckpt_every_s=ckpt_every_s,
                                   device=self.device)
        self.max_queue = max_queue
        self.stop_event = threading.Event()
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.daemon = self  # handler back-reference
        self.host = host
        self.port = self._httpd.server_address[1]
        self._http_thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> None:
        self.scheduler.start()
        # Jobs interrupted by a previous daemon come back requeued with
        # their checkpoints: re-admit them in id order before new work.
        for job in self.registry.all():
            if job.state == "requeued":
                self.registry.transition(job, "queued")
                self.scheduler.submit(job)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name="tts-serve-http", daemon=True,
        )
        self._http_thread.start()

    def submit(self, spec) -> tuple[dict, int]:
        """Admission: validate -> classify -> enqueue. Returns (payload,
        http status). Runs in HTTP threads — no torch, no problem builds.

        An optional top-level ``resume_ckpt_b64`` (the ``tts migrate``
        transport) carries a checkpoint from another daemon: it is
        decoded to a per-job file and attached BEFORE the job is
        enqueued, so the first slice resumes from it — a worker can pop
        the job the instant ``scheduler.submit`` returns."""
        ckpt_b64 = None
        if isinstance(spec, dict) and "resume_ckpt_b64" in spec:
            spec = dict(spec)
            ckpt_b64 = spec.pop("resume_ckpt_b64")
            import base64
            import binascii

            try:
                ckpt_b64 = base64.b64decode(ckpt_b64, validate=True)
            except (TypeError, ValueError, binascii.Error):
                self.metrics.inc("tts_serve_admissions_total",
                                 {"outcome": "invalid"})
                return {"error": "invalid resume_ckpt_b64"}, 400
        try:
            spec = validate_spec(spec, self.device.type)
        except ValueError as e:
            self.metrics.inc("tts_serve_admissions_total",
                             {"outcome": "invalid"})
            return {"error": str(e)}, 400
        if self.scheduler.queue_depth() >= self.max_queue:
            self.metrics.inc("tts_serve_admissions_total",
                             {"outcome": "queue_full"})
            return {"error": f"queue full ({self.max_queue})"}, 503
        cls = self.pool.peek(spec)
        from .jobs import job_pins

        job = self.registry.create(spec, cls["class"], job_pins(spec),
                                   warm_hit=cls["warm"])
        if ckpt_b64 is not None:
            # Validity against the spec's problem is checked by the worker
            # (engine/checkpoint.py's meta validation) — a mismatched
            # checkpoint fails THIS job with a clear error, not the daemon.
            jobs_dir = os.path.join(self.state_dir, "jobs")
            os.makedirs(jobs_dir, exist_ok=True)
            path = os.path.join(jobs_dir, f"{job.id}.resume.ckpt.npz")
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(ckpt_b64)
            os.replace(tmp, path)
            self.registry.update(job, checkpoint=path)
        try:
            pos = self.scheduler.submit(job)
        except RuntimeError:
            self.registry.transition(job, "requeued")
            self.metrics.inc("tts_serve_admissions_total",
                             {"outcome": "draining"})
            return {"error": "daemon is draining"}, 503
        self.metrics.inc("tts_serve_admissions_total",
                         {"outcome": "admitted"})
        return {"id": job.id, "class": cls["class"], "warm": cls["warm"],
                "position": pos}, 201

    def health(self) -> dict:
        """The ``/healthz`` payload. ``workers_alive`` counts scheduler
        worker threads still running — the PR-10 worker wrap makes a
        per-job crash survivable, but an exhausted/killed worker thread
        would otherwise leave a daemon that admits jobs and never runs
        them; ``ok`` goes false in that state so probes (and the submit
        client's error message) surface it."""
        alive = self.scheduler.workers_alive()
        started = self.scheduler.started
        return {
            "ok": alive > 0 or not started,
            # The fleet router's keeper reads this to trigger the live
            # recovery path (migrate-off) while the HTTP surface still
            # answers, instead of waiting out the death detector.
            "draining": self.scheduler._stop_requested(),
            "queue_depth": self.scheduler.queue_depth(),
            "jobs": len(self.registry.all()),
            "uptime_s": round(max(0.0, time.time() - self.started), 3),
            "version": VERSION,
            "workers": self.scheduler.workers,
            "workers_alive": alive,
            "batch_slots": self.scheduler.batch_slots,
        }

    def shutdown(self) -> None:
        """Graceful drain; idempotent (SIGTERM and POST /shutdown share
        it). Runs the scheduler drain in the caller's thread, then wakes
        the main loop."""
        self.scheduler.drain()
        self.stop_event.set()

    def close(self) -> None:
        """Stop the HTTP server; once no slice runs (after a drain), free
        the programs and graphs cached on the pool's problems."""
        self._httpd.shutdown()
        self._httpd.server_close()
        if self.scheduler.idle():
            self.pool.release()


class _Handler(BaseHTTPRequestHandler):
    server_version = "tts-serve/1"

    def log_message(self, fmt, *args):  # silence per-request stderr noise
        pass

    @property
    def daemon(self) -> ServeDaemon:
        return self.server.daemon

    def _json(self, payload, code: int = 200) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self, limit: int = 1 << 20):
        n = int(self.headers.get("Content-Length") or 0)
        if n <= 0 or n > limit:
            return None
        try:
            return json.loads(self.rfile.read(n).decode())
        except (ValueError, UnicodeDecodeError):
            return None

    def _job(self, jid: str):
        return self.daemon.registry.get(jid)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler's contract
        path = urlparse(self.path).path
        try:
            if path == "/jobs":
                self._json([j.record() for j in self.daemon.registry.all()])
            elif path == "/classes":
                stats = self.daemon.pool.stats()
                batch = {b["class"]: b
                         for b in self.daemon.scheduler.batch_stats()}
                for st in stats:
                    b = batch.get(st.get("class"))
                    if b is not None:
                        st["batch_slots"] = b["slots"]
                        st["slots_occupied"] = b["occupied"]
                self._json(stats)
            elif path == "/metrics":
                body = metrics_mod.render(self.daemon).encode()
                self.send_response(200)
                self.send_header("Content-Type", metrics_mod.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/healthz":
                self._json(self.daemon.health())
            elif path.startswith("/job/"):
                parts = path.split("/")  # ['', 'job', '<id>', ...]
                job = self._job(parts[2]) if len(parts) >= 3 else None
                if job is None:
                    self._json({"error": "unknown job"}, code=404)
                elif len(parts) == 3:
                    self._json(job.record())
                elif parts[3] == "result":
                    if job.state in FINAL_STATES:
                        self._json({"id": job.id, "state": job.state,
                                    "result": job.result,
                                    "error": job.error})
                    else:
                        self.daemon.metrics.inc("tts_serve_conflicts_total",
                                                {"endpoint": "result"})
                        self._json({"error": f"job is {job.state}",
                                    "state": job.state}, code=409)
                elif parts[3] == "checkpoint":
                    path = job.checkpoint
                    if (not path or not os.path.exists(path)) \
                            and job.state not in FINAL_STATES:
                        # Mid-slice fallback: job.checkpoint only updates
                        # at a cut, but a previous cut's file may already
                        # sit at the scheduler's well-known path — the
                        # fleet router's periodic pulls read it from here
                        # while the job keeps running.
                        cand = self.daemon.scheduler._checkpoint_path(job)
                        if os.path.exists(cand):
                            path = cand
                    if not path or not os.path.exists(path):
                        self.daemon.metrics.inc(
                            "tts_serve_conflicts_total",
                            {"endpoint": "checkpoint"})
                        self._json({"error": "job has no checkpoint",
                                    "state": job.state}, code=409)
                    else:
                        with open(path, "rb") as f:
                            body = f.read()
                        # Checkpoint payloads are npz (already deflated),
                        # but the header/meta rows and the base64 hop on
                        # resubmit still shave real bytes under gzip —
                        # negotiated, so plain curl keeps working.
                        accept = self.headers.get("Accept-Encoding", "")
                        gzipped = "gzip" in accept.lower()
                        if gzipped:
                            import gzip as _gzip

                            body = _gzip.compress(body, compresslevel=6)
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "application/octet-stream")
                        if gzipped:
                            self.send_header("Content-Encoding", "gzip")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                elif parts[3] == "stream":
                    self._stream_job(job)
                else:
                    self._json({"error": "unknown path"}, code=404)
            else:
                self._json({"error": "unknown path"}, code=404)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away; nothing to clean up

    def do_POST(self):  # noqa: N802
        path = urlparse(self.path).path
        try:
            if path == "/submit":
                # Larger cap than the default: a migrated submit carries a
                # base64 checkpoint (frontier rows) in resume_ckpt_b64.
                body = self._body(limit=64 << 20)
                if body is None:
                    self._json({"error": "invalid JSON body"}, code=400)
                    return
                payload, code = self.daemon.submit(body)
                self._json(payload, code=code)
            elif path == "/shutdown":
                self._json({"ok": True, "draining": True})
                # Drain AFTER replying (it blocks until workers go idle).
                threading.Thread(target=self.daemon.shutdown,
                                 name="tts-serve-drain", daemon=True).start()
            elif path.startswith("/job/") and path.endswith("/cancel"):
                jid = path.split("/")[2]
                job = self._job(jid)
                if job is None:
                    self._json({"error": "unknown job"}, code=404)
                elif self.daemon.scheduler.cancel(job):
                    self._json({"id": job.id, "state": job.state,
                                "cancelling": True})
                else:
                    self.daemon.metrics.inc("tts_serve_conflicts_total",
                                            {"endpoint": "cancel"})
                    self._json({"error": f"job already {job.state}"},
                               code=409)
            else:
                self._json({"error": "unknown path"}, code=404)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _stream_job(self, job) -> None:
        """Per-job SSE: frames from the job's private recorder ring until
        the job finishes, then the final record as ``event: done``.
        Interleaved ``event: incumbent`` frames carry the job's quality
        trajectory (obs/quality.py) as it improves; the stream layer
        drains them once more before the ``done`` frame, so every
        incumbent recorded during the run reaches the client before the
        stream closes."""
        daemon = self.daemon
        sent = 0  # incumbent points already on this connection

        def latest():
            rec = job.recorder
            return rec.latest() if rec is not None else None

        def incumbents():
            nonlocal sent
            q = job.quality
            if q is None:
                return []
            pts = q.points()
            out = []
            while sent < len(pts):
                p = pts[sent]
                sent += 1
                # 1-based monotone index: clients dedupe reconnects by it.
                out.append(("incumbent", {**p, "n": sent, "job": job.id}))
            return out

        def stop():
            return (job.state in FINAL_STATES
                    or daemon.stop_event.is_set()
                    or getattr(self.server, "closing", False))

        sse_begin(self, comment=f"tts job stream {job.id}")
        stream_snapshots(
            self, latest, stop_fn=stop, events_fn=incumbents,
            final_fn=lambda: job.record() if job.state in FINAL_STATES
            else None,
        )


def serve_main(port: int = DEFAULT_PORT, host: str = "127.0.0.1",
               state_dir: str | None = None, workers: int = 1,
               quantum_s: float = 5.0, max_queue: int = 64,
               warm: str | None = None,
               batch_slots: int | None = None,
               ckpt_every_s: float | None = None, device=None,
               router: str | None = None) -> int:
    """The ``serve`` entry point: start, optionally pre-warm the pool,
    then wait for SIGTERM/SIGINT (or POST /shutdown) and drain.

    ``router`` (``--router`` / ``TTS_ROUTER``): self-register with a
    ``fleet`` router (`fleet/router.py`) once the HTTP surface is up;
    failure is reported, not fatal — the daemon serves standalone and the
    router can still be pointed at it later with POST /register.

    Signal composition: the daemon's handler is installed FIRST, so a
    later ``flightrec.install()`` (TTS_FLIGHTREC=1 operators) dumps its
    post-mortem and then chains to us — one SIGTERM yields both the
    flight-record dump and a clean drain."""
    daemon = ServeDaemon(port=port, host=host, state_dir=state_dir,
                         workers=workers, quantum_s=quantum_s,
                         max_queue=max_queue, batch_slots=batch_slots,
                         ckpt_every_s=ckpt_every_s, device=device)

    def _on_signal(signum, frame):
        # Handler context: just set the flag; the main loop drains.
        daemon.stop_event.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _on_signal)
    from ..obs import flightrec

    if flightrec.enabled():
        flightrec.recorder().install()  # chains SIGTERM to _on_signal
    daemon.start()
    print(f"Serving on {daemon.url} (v{VERSION}, "
          f"device: {daemon.device}, "
          f"state: {daemon.state_dir}, "
          f"workers: {daemon.scheduler.workers}, "
          f"quantum: {daemon.scheduler.quantum_s:g}s, "
          f"batch-slots: {daemon.scheduler.batch_slots}"
          + (f", reloaded {daemon.loaded} job record(s)" if daemon.loaded
             else "") + ")", flush=True)
    if router:
        from .client import _post, base_url

        try:
            code, resp = _post(base_url(router=router) + "/register",
                               {"url": daemon.url}, timeout=5.0,
                               retry_s=5.0)
            print(f"Registered with fleet router {router} "
                  f"({resp.get('daemons', '?')} daemon(s) in fleet)"
                  if code == 200 else
                  f"Fleet registration rejected ({code}): {resp}",
                  flush=True)
        except (OSError, ValueError) as e:
            print(f"Fleet registration with {router} failed ({e}); "
                  "serving standalone.", flush=True)
    if warm is not None:
        from .warmup import warm_pool

        for line in warm_pool(daemon, warm):
            print(line, flush=True)
    try:
        while not daemon.stop_event.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    print("Draining: cutting running jobs at the next dispatch boundary "
          "(checkpointed), requeueing pending work...", flush=True)
    daemon.scheduler.drain()
    daemon.close()
    n_requeued = sum(
        1 for j in daemon.registry.all() if j.state == "requeued"
    )
    print(f"Drained ({n_requeued} job(s) requeued for the next daemon).",
          flush=True)
    return 0


def wait_ready(url: str, timeout_s: float = 30.0) -> dict | None:
    """Poll ``/healthz`` until the daemon answers; returns the health
    payload (version, uptime_s, workers_alive ...) so callers can report
    WHICH daemon answered — or a degraded one — not just that a socket
    opened. ``None`` on timeout."""
    from urllib.request import urlopen

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with urlopen(url + "/healthz", timeout=2.0) as resp:  # noqa: S310
                return json.loads(resp.read().decode())
        except (OSError, ValueError):
            time.sleep(0.1)
    return None


def wait_port(url: str, timeout_s: float = 30.0) -> bool:
    """Boolean convenience over :func:`wait_ready` (client/test helper)."""
    return wait_ready(url, timeout_s=timeout_s) is not None


if __name__ == "__main__":
    sys.exit(serve_main())
