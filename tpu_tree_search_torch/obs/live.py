"""``--obs-serve`` / ``watch`` — live telemetry streaming (the port of
`tpu_tree_search/obs/live.py`).

A zero-dependency localhost HTTP endpoint over the flight recorder's
snapshot ring (stdlib ``http.server`` in a daemon thread), plus the
``watch`` client (``python -m tpu_tree_search_torch watch``). This is the streaming-progress seed of the
search-as-a-service direction (ROADMAP item 2, arXiv:2002.07062): the
same snapshots a resident server would push to its tenants.

Endpoints (``127.0.0.1`` only — this is an operator console, not a
service surface):

  * ``GET /snapshot``      — the latest snapshot as one JSON object
    (``{}`` until the first dispatch boundary lands);
  * ``GET /snapshots?n=K`` — the most recent K ring snapshots (JSON
    array; whole ring without ``n``);
  * ``GET /state``         — the flight recorder's post-mortem payload
    (last dispatch per worker, idle map, run meta) — live;
  * ``GET /stream``        — Server-Sent Events: one ``data:`` line per
    new snapshot (~the heartbeat cadence, rate-limited at the source);
  * ``GET /healthz``       — liveness probe.

Server cost model: snapshots are produced by the engines' existing
dispatch-boundary heartbeats whether or not anyone listens; serving them
reads the ring under its lock. Nothing here touches device programs or
the dispatch path.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from . import flightrec

#: SSE poll cadence: the ring refreshes at most every
#: ``flightrec.SNAPSHOT_PERIOD_US``; polling faster only burns cycles.
STREAM_POLL_S = 0.2


class _Handler(BaseHTTPRequestHandler):
    server_version = "tts-obs/1"

    def log_message(self, fmt, *args):  # silence per-request stderr noise
        pass

    def _json(self, payload, code: int = 200) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler's contract
        url = urlparse(self.path)
        try:
            if url.path == "/snapshot":
                self._json(flightrec.latest() or {})
            elif url.path == "/snapshots":
                q = parse_qs(url.query)
                n = None
                if "n" in q:
                    try:
                        n = max(1, int(q["n"][0]))
                    except ValueError:
                        n = None
                self._json(flightrec.snapshots(n))
            elif url.path == "/state":
                self._json(flightrec.recorder().state())
            elif url.path == "/healthz":
                self._json({"ok": True})
            elif url.path == "/stream":
                self._stream()
            else:
                self._json({"error": "unknown path"}, code=404)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away; nothing to clean up

    def _stream(self) -> None:
        sse_begin(self)
        stream_snapshots(
            self, flightrec.latest,
            stop_fn=lambda: getattr(self.server, "closing", False),
        )


# -- SSE plumbing (shared with the serve daemon's per-job streams) ----------


def sse_begin(handler: BaseHTTPRequestHandler, comment: str = "tts snapshot stream") -> None:
    """Open a Server-Sent-Events response on ``handler``."""
    handler.send_response(200)
    handler.send_header("Content-Type", "text/event-stream")
    handler.send_header("Cache-Control", "no-cache")
    handler.end_headers()
    handler.wfile.write(b": " + comment.encode() + b"\n\n")
    handler.wfile.flush()


def sse_event(handler: BaseHTTPRequestHandler, payload: dict,
              event: str | None = None) -> None:
    """One SSE frame (optionally named via ``event:``)."""
    buf = b""
    if event:
        buf += b"event: " + event.encode() + b"\n"
    buf += b"data: " + json.dumps(payload).encode() + b"\n\n"
    handler.wfile.write(buf)
    handler.wfile.flush()


def stream_snapshots(handler: BaseHTTPRequestHandler, latest_fn,
                     stop_fn=None, poll_s: float = STREAM_POLL_S,
                     final_fn=None, events_fn=None) -> None:
    """Poll ``latest_fn()`` and push each NEW snapshot (by ``ts_us``) as an
    SSE frame until ``stop_fn()`` goes true. ``final_fn()`` (optional) may
    return one terminal payload, sent as an ``event: done`` frame — the
    serve daemon closes a finished job's stream with its result record so
    a client needs no second round trip. ``events_fn()`` (optional) may
    return a list of ``(event_name, payload)`` extra frames, drained every
    poll AND once more before the ``done`` frame — the serve daemon uses
    it for ``event: incumbent`` quality frames, and the final drain
    guarantees every incumbent recorded during the run is on the wire
    before the stream closes."""
    last_ts = None

    def push_new() -> None:
        nonlocal last_ts
        if events_fn is not None:
            for name, payload in events_fn():
                sse_event(handler, payload, event=name)
        snap = latest_fn()
        if snap is not None and snap.get("ts_us") != last_ts:
            last_ts = snap.get("ts_us")
            sse_event(handler, snap)

    while not (stop_fn is not None and stop_fn()):
        push_new()
        time.sleep(poll_s)
    # Flush the frame that may have landed during the last sleep — a fast
    # job's only snapshot must not lose the race with its own completion.
    push_new()
    if final_fn is not None:
        payload = final_fn()
        if payload is not None:
            sse_event(handler, payload, event="done")


def iter_sse(resp):
    """Client side: yield ``(event, payload)`` per SSE frame from an open
    ``urlopen`` response (``event`` is None for plain ``data:`` frames;
    unparseable frames are skipped)."""
    event = None
    for raw in resp:
        line = raw.decode(errors="replace").strip()
        if line.startswith("event: "):
            event = line[len("event: "):]
            continue
        if not line.startswith("data: "):
            if not line:
                event = None  # frame boundary
            continue
        try:
            payload = json.loads(line[len("data: "):])
        except ValueError:
            continue
        yield event, payload
        event = None


class LiveServer:
    """The ``--obs-serve`` server handle: ``port`` is the bound port
    (pass 0 to let the OS pick — tests do), ``close()`` stops serving."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.closing = False
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name="tts-obs-serve", daemon=True,
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.closing = True
        self._httpd.shutdown()
        self._httpd.server_close()


def serve(port: int, host: str = "127.0.0.1") -> LiveServer:
    """Start the live monitor (daemon thread; returns immediately)."""
    return LiveServer(port, host)


# -- the `watch` client -- --------------------------------------------------


def format_snapshot(snap: dict) -> str:
    """One human status line from a snapshot (the watch display unit)."""
    if not snap:
        return "waiting for first snapshot..."
    best = snap.get("best")
    size = snap.get("size")
    parts = [
        f"[{snap.get('tier', '?')}]",
        f"{snap.get('nodes_per_sec', 0.0):>12,.0f} nodes/s",
        f"best={best if best is not None else '-'}",
        f"pool={size if size is not None else '-'}",
        f"depth={snap.get('depth', 1)}",
        f"K={snap.get('K') if snap.get('K') is not None else '-'}",
    ]
    if snap.get("workers", 0) > 1:
        parts.append(
            f"workers={snap['workers']}"
            f"(idle {snap.get('idle_workers', 0)})"
        )
    if snap.get("steals"):
        parts.append(f"steals={snap['steals']}")
    if snap.get("steal_link"):
        # Hierarchical stealing (TTS_STEAL=hier): which link class last
        # fed this run — on a stall, the level the search was living off.
        lvl = snap.get("steal_level")
        parts.append(
            f"steal={snap['steal_link']}"
            + (f"/L{lvl}" if lvl is not None else "")
        )
    if snap.get("dominant_phase"):
        # TTS_PHASEPROF runs: where the last dispatch spent its cycles.
        share = snap.get("dominant_phase_share", 0.0)
        parts.append(f"phase={snap['dominant_phase']}:{100.0 * share:.0f}%")
    parts.append(f"dispatch#{snap.get('seq', 0)}")
    return "  ".join(parts)


def _fetch_json(url: str, timeout: float = 5.0):
    from urllib.request import urlopen

    with urlopen(url, timeout=timeout) as resp:  # noqa: S310 — localhost
        return json.loads(resp.read().decode())


def watch_main(port: int, host: str = "127.0.0.1", interval: float = 1.0,
               once: bool = False, as_json: bool = False,
               max_updates: int | None = None) -> int:
    """``watch`` entry point: stream (SSE) with a polling fallback.

    ``once`` prints the current snapshot and exits; ``max_updates`` bounds
    a streaming session (tests; unbounded for operators, ^C to stop).
    Returns 0 on success, 2 when the monitor is unreachable.
    """
    base = f"http://{host}:{port}"
    emit = (lambda s: print(json.dumps(s), flush=True)) if as_json else (
        lambda s: print(format_snapshot(s), flush=True)
    )
    if once:
        try:
            snap = _fetch_json(base + "/snapshot")
        except OSError as e:
            print(f"Error: no live monitor at {base}: {e}", file=sys.stderr)
            return 2
        emit(snap)
        return 0
    from urllib.request import urlopen

    seen = 0
    last_ts = None  # carried into the fallback: no duplicate reprint
    try:
        try:
            with urlopen(base + "/stream", timeout=30.0) as resp:  # noqa: S310
                for _event, snap in iter_sse(resp):
                    emit(snap)
                    seen += 1
                    last_ts = snap.get("ts_us", last_ts)
                    if max_updates is not None and seen >= max_updates:
                        return 0
        except OSError as e:
            if seen == 0 and not _poll_ok(base):
                print(f"Error: no live monitor at {base}: {e}",
                      file=sys.stderr)
                return 2
        # Stream dropped (run over or timeout): fall back to polling until
        # the server goes away entirely.
        while max_updates is None or seen < max_updates:
            try:
                snap = _fetch_json(base + "/snapshot")
            except OSError:
                return 0 if seen else 2
            if snap and snap.get("ts_us") != last_ts:
                last_ts = snap.get("ts_us")
                emit(snap)
                seen += 1
            time.sleep(interval)
    except KeyboardInterrupt:
        pass
    return 0


def _poll_ok(base: str) -> bool:
    try:
        _fetch_json(base + "/healthz", timeout=2.0)
        return True
    except OSError:
        return False
