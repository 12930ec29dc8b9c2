"""The ``fleet`` router daemon: one URL in front of N serve daemons (the
port of `tpu_tree_search/fleet/router.py`: the same API, records and
recovery).

Zero-dependency by the same rule as ``serve/server.py`` (stdlib
``http.server`` only, bound to 127.0.0.1) and strictly **host-only**:
the router never imports torch and never builds a problem — its class-key
computation is the same host-side ``serve/pool.class_key`` the daemons
run at admission, which is the whole warm-placement contract.

API (all JSON; every job endpoint speaks *fleet* job ids, stable across
recoveries and rebalances — the daemon-local id of the moment rides
along as ``daemon_job``):

  * ``POST /submit``            — place + proxy. 201 -> the daemon's
    admission payload plus ``{id: <fleet id>, daemon, daemon_job,
    placement: warm|cold}``; 400 invalid spec; 503 when no registered
    daemon can take the job.
  * ``POST /register``          — body ``{url}``: add a daemon to the
    fleet (``serve --router`` self-registers at startup). Durable.
  * ``GET  /job/<id>``          — the owning daemon's record, identity
    rewritten to the fleet view; a cached copy (``stale: true``) while
    the owner is unreachable mid-recovery.
  * ``GET  /job/<id>/result``   — proxied result (409 until terminal).
  * ``POST /job/<id>/cancel``   — proxied cancel.
  * ``GET  /job/<id>/stream``   — SSE pass-through from the owning
    daemon, re-attached across recoveries/rebalances; the terminal
    ``done`` frame is rewritten to the fleet identity.
  * ``GET  /jobs``              — every fleet job (brief records).
  * ``GET  /daemons``           — per-daemon scraped snapshots.
  * ``GET  /fleet``             — the ``top --router`` aggregate:
    router health + daemon snapshots + brief job rows.
  * ``GET  /healthz``           — router liveness + fleet counts.
  * ``POST /shutdown``          — stop the router (daemons unaffected).

Recovery model: the keeper (health.py) pulls every in-flight job's
latest checkpoint cut — plus the record's exact ``steps`` at that cut —
into the router's ``--state-dir``. On daemon drain the router migrates
jobs live (cancel-with-cut -> fetch -> resubmit, the ``migrate``
flow); on daemon death it resubmits the last pulled cut with the
remaining ``max_steps`` budget elsewhere. Either way the engine's
checkpoint contract (cumulative counters) makes the final result equal,
count for count, to an uninterrupted run; a job that never reached a cut
simply restarts from scratch, which *is* an uninterrupted run.

The router validates and classifies a spec as a daemon on the card
would: a missing M takes the card's default.

Lock discipline (`analysis/lockorder.py`): ``FleetJobMap`` mirrors the
serve registry's ``_io_lock -> _lock`` persist nesting; no router
method holds a map lock while talking to a socket.
"""

from __future__ import annotations

import base64
import json
import os
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.error import HTTPError, URLError
from urllib.parse import urlparse
from urllib.request import urlopen

from ..obs.live import sse_begin, sse_event
from ..serve import VERSION
from ..serve.client import _get, _post, fetch_checkpoint
from ..serve.server import FINAL_STATES
from . import DEFAULT_ROUTER_PORT, placement
from .health import HealthChecker


def default_state_dir() -> str:
    return os.environ.get("TTS_FLEET_STATE") or os.path.join(
        os.path.expanduser("~"), ".cache", "tpu_tree_search_torch", "fleet"
    )


class RouteError(RuntimeError):
    """No registered daemon could take the job (placement exhausted)."""

    def __init__(self, msg: str, tried: list):
        super().__init__(msg)
        self.tried = tried


class FleetJob:
    """One routed job: the durable fleet record. Mutated only through
    ``FleetJobMap`` methods (which persist atomically)."""

    def __init__(self, fid: str, spec: dict, cls: str):
        self.id = fid
        self.spec = spec  # the validated spec (re-routable as-is)
        self.cls = cls
        self.daemon = None  # current owner base URL
        self.daemon_job = None  # owner-local job id
        self.submitted = time.time()
        self.resubmits = 0  # recoveries + rebalances
        self.history: list = []  # every (daemon, daemon_job) placement
        self.ckpt = None  # last pulled checkpoint (router-local path)
        self.ckpt_steps = 0  # the record's exact steps at that cut
        self.last_record = None  # last owner record seen (pull cache)
        self.needs_recovery = False  # owner died; waiting for capacity
        self.migrating = False  # transient: a live migration is mid-flight
        self.error = None

    def record(self) -> dict:
        return {
            "id": self.id,
            "spec": self.spec,
            "class": self.cls,
            "daemon": self.daemon,
            "daemon_job": self.daemon_job,
            "submitted": self.submitted,
            "resubmits": self.resubmits,
            "history": self.history,
            "ckpt": self.ckpt,
            "ckpt_steps": self.ckpt_steps,
            "last_record": self.last_record,
            "needs_recovery": self.needs_recovery,
            "error": self.error,
        }

    def brief(self) -> dict:
        """The ``/jobs`` + ``/fleet`` row: mapping + cached progress."""
        rec = self.last_record or {}
        return {
            "id": self.id,
            "daemon": self.daemon,
            "daemon_job": self.daemon_job,
            "class": self.cls,
            "state": ("recovering" if self.needs_recovery
                      else rec.get("state") or "routed"),
            "steps": rec.get("steps", 0),
            "resubmits": self.resubmits,
            "submitted": self.submitted,
        }

    @classmethod
    def from_record(cls, rec: dict) -> "FleetJob":
        job = cls(rec["id"], rec["spec"], rec["class"])
        for k in ("daemon", "daemon_job", "submitted", "resubmits",
                  "history", "ckpt", "ckpt_steps", "last_record",
                  "needs_recovery", "error"):
            if k in rec:
                setattr(job, k, rec[k])
        return job


class FleetJobMap:
    """Durable fleet-id -> FleetJob map (``<state_dir>/jobs/``), the
    registry pattern from serve/jobs.py: every mutation persists the
    record atomically; a restarted router reloads the full map and the
    keeper resumes monitoring where it left off.

    Lock order: ``_io_lock`` may acquire ``_lock`` (``_persist``
    snapshots inside the write critical section), never the reverse."""

    def __init__(self, state_dir: str):
        self.jobs_dir = os.path.join(state_dir, "jobs")
        os.makedirs(self.jobs_dir, exist_ok=True)
        self._lock = threading.Lock()
        # Serializes _persist (same torn-write reasoning as the serve
        # registry: last rename to land must be the newest record).
        self._io_lock = threading.Lock()
        self._jobs = {}  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock

    def load(self) -> int:
        n = 0
        for name in sorted(os.listdir(self.jobs_dir)):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.jobs_dir, name)) as f:
                    job = FleetJob.from_record(json.load(f))
            except (OSError, ValueError, KeyError):
                continue  # truncated/alien file: skip, don't crash startup
            with self._lock:
                self._jobs[job.id] = job
                try:
                    self._seq = max(self._seq, int(job.id.split("-")[-1]))
                except ValueError:
                    pass
            n += 1
        return n

    def create(self, spec: dict, cls: str) -> FleetJob:
        with self._lock:
            self._seq += 1
            job = FleetJob(f"fjob-{self._seq:06d}", spec, cls)
            self._jobs[job.id] = job
        self._persist(job)
        return job

    def get(self, fid: str):
        with self._lock:
            return self._jobs.get(fid)

    def all(self) -> list:
        with self._lock:
            return sorted(self._jobs.values(), key=lambda j: j.id)

    def by_daemon(self, url: str) -> list:
        url = url.rstrip("/")
        with self._lock:
            return sorted((j for j in self._jobs.values()
                           if j.daemon == url), key=lambda j: j.id)

    def find(self, url: str, daemon_job: str):
        url = url.rstrip("/")
        with self._lock:
            for j in self._jobs.values():
                if j.daemon == url and j.daemon_job == daemon_job:
                    return j
        return None

    def update(self, job: FleetJob, **fields) -> None:
        with self._lock:
            for k, v in fields.items():
                setattr(job, k, v)
        self._persist(job)

    def _persist(self, job: FleetJob) -> None:
        path = os.path.join(self.jobs_dir, f"{job.id}.json")
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with self._io_lock:
            with self._lock:
                rec = job.record()
            with open(tmp, "w") as f:
                json.dump(rec, f)
            os.replace(tmp, path)


class FleetRouter:
    """The router's spine: fleet view + durable job map + keeper + HTTP."""

    def __init__(self, port: int = DEFAULT_ROUTER_PORT,
                 host: str = "127.0.0.1", state_dir: str | None = None,
                 daemons: list | None = None,
                 scrape_interval_s: float = 1.0, max_misses: int = 3,
                 pull_interval_s: float = 2.0, rebalance: bool = True,
                 rebalance_min_depth: int = 2,
                 proxy_timeout_s: float = 10.0):
        self.state_dir = state_dir or default_state_dir()
        os.makedirs(self.state_dir, exist_ok=True)
        self.ckpt_dir = os.path.join(self.state_dir, "ckpt")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.view = placement.FleetView()
        self.jobs = FleetJobMap(self.state_dir)
        self.loaded = self.jobs.load()
        self.proxy_timeout_s = float(proxy_timeout_s)
        self.started = time.time()
        self.stop_event = threading.Event()
        for url in self._load_daemons():
            self.view.add(url)
        for url in daemons or []:
            self.register(url, persist=True, scrape=False)
        self.keeper = HealthChecker(
            self, interval_s=scrape_interval_s, max_misses=max_misses,
            pull_interval_s=pull_interval_s, rebalance=rebalance,
            rebalance_min_depth=rebalance_min_depth)
        self._httpd = ThreadingHTTPServer((host, port), _RouterHandler)
        self._httpd.daemon_threads = True
        self._httpd.router = self  # handler back-reference
        self.host = host
        self.port = self._httpd.server_address[1]
        self._http_thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> None:
        # One synchronous sweep first: static --daemon entries are
        # placeable before the first submit arrives.
        self.keeper.scrape_once()
        self.keeper.start()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name="tts-fleet-http", daemon=True)
        self._http_thread.start()

    def close(self) -> None:
        self.keeper.stop()
        self._httpd.shutdown()
        self._httpd.server_close()

    # -- daemon registration -------------------------------------------------

    def _daemons_path(self) -> str:
        return os.path.join(self.state_dir, "daemons.json")

    def _load_daemons(self) -> list:
        try:
            with open(self._daemons_path()) as f:
                return [str(u) for u in json.load(f)]
        except (OSError, ValueError):
            return []

    def register(self, url: str, persist: bool = True,
                 scrape: bool = True) -> dict:
        url = url.rstrip("/")
        if "://" not in url:
            url = "http://" + url
        st = self.view.add(url)
        if persist:
            urls = sorted(s.url for s in self.view.states())
            tmp = self._daemons_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump(urls, f)
            os.replace(tmp, self._daemons_path())
        if scrape:
            try:  # make it placeable now, not a keeper-tick later
                self.view.mark_ok(st, placement.scrape(url, timeout=3.0))
            except Exception:  # noqa: BLE001 — keeper will keep probing
                pass
        return {"url": url, "healthy": st.healthy,
                "daemons": len(self.view.states())}

    # -- health / aggregates -------------------------------------------------

    def health(self) -> dict:
        states = self.view.states()
        healthy = sum(1 for s in states if s.healthy)
        return {
            "ok": healthy > 0,
            "router": True,
            "daemons": len(states),
            "daemons_healthy": healthy,
            "jobs": len(self.jobs.all()),
            "uptime_s": round(max(0.0, time.time() - self.started), 3),
            "version": VERSION,
        }

    def fleet(self) -> dict:
        return {
            "router": self.health(),
            "daemons": [st.snapshot() for st in self.view.states()],
            "jobs": [j.brief() for j in self.jobs.all()],
        }

    # -- placement + submit --------------------------------------------------

    def _route(self, payload: dict, cls: str, exclude=(),
               only: str | None = None):
        """Place and POST one spec. Tries daemons in policy order until
        one admits (a 503 — queue full / draining — moves on to the
        next); returns ``(DaemonState, reason, response)``. ``only``
        pins the destination (rebalance)."""
        tried: list = []
        excluded = {u.rstrip("/") for u in exclude}
        while True:
            states = [st for st in self.view.states()
                      if st.url not in excluded and st.url not in tried
                      and (only is None or st.url == only.rstrip("/"))]
            st, reason = placement.choose(states, cls)
            if st is None:
                raise RouteError(
                    f"no daemon can take class {cls} ({reason})", tried)
            try:
                code, resp = _post(st.url + "/submit", payload,
                                   timeout=60.0, retry_s=2.0)
            except (URLError, OSError):
                tried.append(st.url)
                continue
            if code == 201:
                return st, reason, resp
            if code == 503:
                tried.append(st.url)
                continue
            # 400 etc.: the daemon's rejection is authoritative.
            raise RouteError(f"daemon {st.url} rejected the job "
                             f"({code}): {resp.get('error', resp)}", tried)

    def submit(self, spec) -> tuple[dict, int]:
        """Admission: validate host-side, classify with the daemons' own
        class-key computation, place, proxy. HTTP-thread safe: no torch,
        no problem builds, placement runs on the keeper's snapshots."""
        from ..serve.jobs import validate_spec
        from ..serve.pool import class_key

        ckpt_b64 = None
        if isinstance(spec, dict) and "resume_ckpt_b64" in spec:
            spec = dict(spec)
            ckpt_b64 = spec.pop("resume_ckpt_b64")
        try:
            validated = validate_spec(spec)
            cls = class_key(validated)
        except ValueError as e:
            return {"error": str(e)}, 400
        payload = dict(validated)
        if ckpt_b64 is not None:
            payload["resume_ckpt_b64"] = ckpt_b64
        try:
            st, reason, resp = self._route(payload, cls)
        except RouteError as e:
            return {"error": str(e), "tried": e.tried}, 503
        job = self.jobs.create(validated, cls)
        self.jobs.update(job, daemon=st.url, daemon_job=resp["id"],
                         history=[{"daemon": st.url,
                                   "daemon_job": resp["id"]}])
        return {**resp, "id": job.id, "daemon": st.url,
                "daemon_job": resp["id"], "placement": reason}, 201

    # -- job views -----------------------------------------------------------

    def fleet_record(self, job: FleetJob, rec: dict) -> dict:
        """A daemon job record rewritten to the fleet identity."""
        rec = dict(rec)
        rec["daemon_job"] = rec.get("id")
        rec["id"] = job.id
        rec["daemon"] = job.daemon
        rec["resubmits"] = job.resubmits
        return rec

    def job_record(self, job: FleetJob) -> dict:
        """The freshest record we can get: live proxy from the owner,
        else the pull cache (``stale: true``) — a job mid-recovery must
        keep answering polls as non-terminal, not 404."""
        try:
            code, rec = _get(f"{job.daemon}/job/{job.daemon_job}",
                             timeout=self.proxy_timeout_s)
            if code == 200:
                if rec.get("state") == "cancelled" and \
                        getattr(job, "migrating", False):
                    # A live migration cut this copy — its successor is
                    # about to be placed elsewhere. Report the
                    # transition, not a terminal state the fleet job
                    # never had (pollers must keep polling).
                    rec = dict(rec)
                    rec["state"] = "requeued"
                    return self.fleet_record(job, rec)
                self.jobs.update(job, last_record=rec)
                return self.fleet_record(job, rec)
        except (URLError, OSError):
            pass
        if job.last_record is not None:
            rec = self.fleet_record(job, job.last_record)
            if rec.get("state") not in FINAL_STATES:
                rec["stale"] = True
            return rec
        return {"id": job.id, "daemon": job.daemon, "state": "queued",
                "class": job.cls, "stale": True}

    # -- checkpoint pulls (keeper thread) ------------------------------------

    def _pull_one(self, job: FleetJob) -> None:
        base = job.daemon
        code, rec = _get(f"{base}/job/{job.daemon_job}", timeout=5.0)
        if code != 200:
            return
        self.jobs.update(job, last_record=rec)
        steps = int(rec.get("steps") or 0)
        if not rec.get("checkpoint") or \
                (job.ckpt is not None and steps == job.ckpt_steps):
            return  # nothing new to pull
        try:
            raw, _wire = fetch_checkpoint(base, job.daemon_job, timeout=30.0)
        except (HTTPError, URLError, OSError):
            return  # e.g. the cut was consumed (job finished); next round
        # Consistency guard: the checkpoint file and the record's steps
        # update together at a cut — re-read the record and keep the pull
        # only if no new cut landed between our two reads.
        code, rec2 = _get(f"{base}/job/{job.daemon_job}", timeout=5.0)
        if code != 200 or int(rec2.get("steps") or 0) != steps:
            return
        path = os.path.join(self.ckpt_dir, f"{job.id}.npz")
        tmp = f"{path}.tmp.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(raw)
        os.replace(tmp, path)
        self.jobs.update(job, ckpt=path, ckpt_steps=steps,
                         last_record=rec2)

    def pull_checkpoints(self) -> None:
        """Keeper duty: refresh every in-flight job's record cache and
        copy new checkpoint cuts local; retry stranded recoveries once
        capacity is back."""
        for job in self.jobs.all():
            if job.needs_recovery:
                try:
                    self._recover_from_pull(job)
                except (RouteError, URLError, OSError):
                    pass  # still no capacity; keep the flag
                continue
            state = (job.last_record or {}).get("state")
            if state in FINAL_STATES:
                continue
            st = self.view.get(job.daemon) if job.daemon else None
            if st is None or not st.healthy:
                continue
            try:
                self._pull_one(job)
            except (URLError, OSError):
                continue

    # -- recovery ------------------------------------------------------------

    def _recovery_payload(self, job: FleetJob, steps_done: int,
                          raw_ckpt) -> dict:
        """The resubmission body: the job's own validated spec, with the
        checkpoint attached and a consumed ``max_steps`` budget reduced
        to the remainder — the exact ``migrate`` arithmetic, which is
        what makes the recovered run's counts an uninterrupted one's."""
        payload = dict(job.spec)
        if raw_ckpt is None:
            return payload  # never reached a cut: restart from scratch
        if payload.get("max_steps") is not None:
            remaining = int(payload["max_steps"]) - int(steps_done)
            if remaining <= 0:
                raise RouteError(
                    f"{job.id}: budget exhausted at the last cut", [])
            payload["max_steps"] = remaining
        payload["resume_ckpt_b64"] = base64.b64encode(raw_ckpt).decode()
        return payload

    def _place_recovered(self, job: FleetJob, payload: dict,
                         exclude=(), only: str | None = None) -> None:
        st, _reason, resp = self._route(payload, job.cls,
                                        exclude=exclude, only=only)
        self.jobs.update(
            job, daemon=st.url, daemon_job=resp["id"],
            resubmits=job.resubmits + 1,
            history=job.history + [{"daemon": st.url,
                                    "daemon_job": resp["id"]}],
            needs_recovery=False, error=None, last_record=None)

    def _recover_from_pull(self, job: FleetJob) -> None:
        """Dead-owner recovery: resubmit the last *pulled* cut (the
        owner cannot answer). ``ckpt_steps`` was recorded at pull time
        from the same record revision as the bytes, so the remaining
        budget is exact."""
        raw = None
        if job.ckpt and os.path.exists(job.ckpt):
            with open(job.ckpt, "rb") as f:
                raw = f.read()
        payload = self._recovery_payload(job, job.ckpt_steps, raw)
        self._place_recovered(job, payload,
                              exclude=(job.daemon,) if job.daemon else ())

    def _migrate_live(self, job: FleetJob, only: str | None = None) -> bool:
        """Live migration (drain/rebalance): the ``migrate`` flow
        against a still-answering owner — cancel (cutting a running
        slice at the next dispatch boundary), fetch the cut, resubmit
        the remainder elsewhere. Returns False when the job turned out
        terminal (nothing to move)."""
        src, djid = job.daemon, job.daemon_job
        code, rec = _get(f"{src}/job/{djid}", timeout=10.0, retry_s=2.0)
        if code != 200:
            raise RouteError(f"{job.id}: owner lost its record ({code})", [])
        if rec.get("state") in FINAL_STATES:
            self.jobs.update(job, last_record=rec)
            return False
        # The flag masks the source copy's transient 'cancelled' from
        # every proxy surface until the successor is placed (or the
        # migration fails and needs_recovery takes over).
        self.jobs.update(job, migrating=True)
        try:
            _post(f"{src}/job/{djid}/cancel", {}, retry_s=2.0)
            deadline = time.monotonic() + 120.0
            while time.monotonic() < deadline:
                code, rec = _get(f"{src}/job/{djid}", timeout=10.0,
                                 retry_s=2.0)
                if code == 200 and rec.get("state") in FINAL_STATES:
                    break
                time.sleep(0.2)
            if rec.get("state") == "done":
                self.jobs.update(job, last_record=rec)
                return False  # finished before the cut: result stands
            raw = None
            if rec.get("checkpoint"):
                raw, _wire = fetch_checkpoint(src, djid, timeout=30.0,
                                              retry_s=2.0)
            payload = self._recovery_payload(
                job, int(rec.get("steps") or 0), raw)
            self._place_recovered(job, payload, exclude=(src,), only=only)
            return True
        finally:
            self.jobs.update(job, migrating=False)

    def recover_daemon(self, url: str, live: bool) -> int:
        """Move every non-terminal job off a dead (``live=False``) or
        draining (``live=True``) daemon. Jobs that cannot be placed yet
        are flagged ``needs_recovery`` and retried by the keeper as
        capacity returns. Returns the number of jobs moved."""
        url = url.rstrip("/")
        moved = 0
        for job in self.jobs.by_daemon(url):
            state = (job.last_record or {}).get("state")
            if state in FINAL_STATES and not job.needs_recovery:
                continue
            try:
                if live:
                    moved += 1 if self._migrate_live(job) else 0
                else:
                    self._recover_from_pull(job)
                    moved += 1
            except (RouteError, HTTPError, URLError, OSError) as e:
                if live:
                    # The daemon died mid-drain: fall back to the pulls.
                    try:
                        self._recover_from_pull(job)
                        moved += 1
                        continue
                    except (RouteError, HTTPError, URLError, OSError):
                        pass
                self.jobs.update(job, needs_recovery=True,
                                 error=f"{type(e).__name__}: {e}")
        return moved

    # -- rebalance -----------------------------------------------------------

    def maybe_rebalance(self, min_depth: int = 2) -> bool:
        """One conservative hot->idle move per call (keeper cadence):
        the hot daemon's longest-running checkpointed job migrates to a
        fully idle daemon. Only jobs the router itself placed move."""
        picked = placement.pick_rebalance(self.view.states(), min_depth)
        if picked is None:
            return False
        hot, rec, cold = picked
        job = self.jobs.find(hot.url, rec.get("id"))
        if job is None:
            return False  # submitted around the router; not ours to move
        try:
            return self._migrate_live(job, only=cold.url)
        except (RouteError, HTTPError, URLError, OSError) as e:
            self.jobs.update(job, error=f"rebalance: {type(e).__name__}: {e}")
            return False


class _RouterHandler(BaseHTTPRequestHandler):
    server_version = "tts-fleet/1"

    def log_message(self, fmt, *args):  # silence per-request stderr noise
        pass

    @property
    def router(self) -> FleetRouter:
        return self.server.router

    def _json(self, payload, code: int = 200) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self, limit: int = 64 << 20):
        n = int(self.headers.get("Content-Length") or 0)
        if n <= 0 or n > limit:
            return None
        try:
            return json.loads(self.rfile.read(n).decode())
        except (ValueError, UnicodeDecodeError):
            return None

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler's contract
        path = urlparse(self.path).path
        try:
            if path == "/healthz":
                self._json(self.router.health())
            elif path == "/fleet":
                self._json(self.router.fleet())
            elif path == "/daemons":
                self._json([st.snapshot()
                            for st in self.router.view.states()])
            elif path == "/jobs":
                self._json([j.brief() for j in self.router.jobs.all()])
            elif path.startswith("/job/"):
                parts = path.split("/")  # ['', 'job', '<id>', ...]
                job = (self.router.jobs.get(parts[2])
                       if len(parts) >= 3 else None)
                if job is None:
                    self._json({"error": "unknown job"}, code=404)
                elif len(parts) == 3:
                    self._json(self.router.job_record(job))
                elif parts[3] == "result":
                    self._proxy_result(job)
                elif parts[3] == "stream":
                    self._stream_proxy(job)
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
                body = self._body()
                if body is None:
                    self._json({"error": "invalid JSON body"}, code=400)
                    return
                payload, code = self.router.submit(body)
                self._json(payload, code=code)
            elif path == "/register":
                body = self._body(limit=1 << 16)
                if not isinstance(body, dict) or not body.get("url"):
                    self._json({"error": "body must be {url: ...}"},
                               code=400)
                    return
                self._json(self.router.register(str(body["url"])))
            elif path == "/shutdown":
                self._json({"ok": True})
                self.router.stop_event.set()
            elif path.startswith("/job/") and path.endswith("/cancel"):
                fid = path.split("/")[2]
                job = self.router.jobs.get(fid)
                if job is None:
                    self._json({"error": "unknown job"}, code=404)
                    return
                try:
                    code, resp = _post(
                        f"{job.daemon}/job/{job.daemon_job}/cancel", {},
                        timeout=self.router.proxy_timeout_s)
                except (URLError, OSError) as e:
                    self._json({"error": f"owner unreachable: {e}"},
                               code=503)
                    return
                if isinstance(resp, dict) and "id" in resp:
                    resp = {**resp, "id": fid,
                            "daemon_job": job.daemon_job}
                self._json(resp, code=code)
            else:
                self._json({"error": "unknown path"}, code=404)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _proxy_result(self, job: FleetJob) -> None:
        try:
            code, rec = _get(f"{job.daemon}/job/{job.daemon_job}/result",
                             timeout=self.router.proxy_timeout_s)
        except (URLError, OSError):
            cached = job.last_record
            if cached is not None and cached.get("state") in FINAL_STATES:
                self._json({"id": job.id, "state": cached["state"],
                            "result": cached.get("result"),
                            "error": cached.get("error"), "stale": True})
                return
            self._json({"error": "owner unreachable (recovering)",
                        "state": "queued"}, code=409)
            return
        if isinstance(rec, dict) and rec.get("state") == "cancelled" \
                and getattr(job, "migrating", False):
            # Mid-migration: the source copy's cancellation is not this
            # job's result — keep answering 409 until the successor ends.
            self._json({"error": "job is migrating", "state": "requeued"},
                       code=409)
            return
        if isinstance(rec, dict) and "id" in rec:
            rec = {**rec, "id": job.id, "daemon_job": job.daemon_job}
        self._json(rec, code=code)

    def _stream_proxy(self, job: FleetJob) -> None:
        """SSE pass-through, re-attached across recoveries: relay the
        owner's per-job stream byte-for-byte; when it drops (daemon
        death, migration cut) re-resolve the owner and reconnect. The
        terminal ``done`` frame is rewritten to the fleet identity; if
        the job finishes while no owner stream is attached (recovery
        landed the final cut elsewhere), a synthetic ``done`` frame is
        emitted from the proxied record. Clients dedupe replayed frames
        exactly as they already do for daemon restarts."""
        router = self.router
        sse_begin(self, comment=f"tts fleet job stream {job.id}")
        deadline = time.monotonic() + 3600.0
        while time.monotonic() < deadline and \
                not router.stop_event.is_set():
            job = router.jobs.get(job.id) or job  # refresh the mapping
            try:
                with urlopen(f"{job.daemon}/job/{job.daemon_job}/stream",
                             timeout=600.0) as resp:  # noqa: S310
                    in_done = False
                    for line in resp:
                        if line.startswith(b"event: done"):
                            # Held back until the payload is vetted: a
                            # live migration ends the SOURCE copy with
                            # 'cancelled', which is not this job's end.
                            in_done = True
                            continue
                        if in_done and line.startswith(b"data: "):
                            try:
                                rec = json.loads(line[6:].decode())
                            except ValueError:
                                rec = None
                            cur = router.jobs.get(job.id) or job
                            if rec is not None \
                                    and rec.get("state") == "cancelled" \
                                    and (cur.migrating or
                                         cur.daemon_job != rec.get("id")):
                                in_done = False
                                break  # reattach to the successor copy
                            if rec is not None:
                                rec = router.fleet_record(cur, rec)
                                line = (b"data: "
                                        + json.dumps(rec).encode() + b"\n")
                            self.wfile.write(b"event: done\n" + line
                                             + b"\n")
                            self.wfile.flush()
                            return  # the job's story is complete
                        self.wfile.write(line)
                        self.wfile.flush()
            except (URLError, OSError, ValueError):
                pass
            # Stream dropped: finished elsewhere, mid-recovery, or the
            # owner restarted. Poll the fleet view and either finish the
            # story or re-attach.
            rec = router.job_record(job)
            if rec.get("state") in FINAL_STATES and not rec.get("stale"):
                sse_event(self, rec, event="done")
                return
            time.sleep(0.3)


def router_main(port: int = DEFAULT_ROUTER_PORT, host: str = "127.0.0.1",
                state_dir: str | None = None, daemons: list | None = None,
                scrape_interval_s: float = 1.0, max_misses: int = 3,
                pull_interval_s: float = 2.0, rebalance: bool = True,
                rebalance_min_depth: int = 2) -> int:
    """The ``fleet`` entry point: start, print the banner, wait for
    SIGTERM/SIGINT (or POST /shutdown). The router carries no search
    state of its own beyond the durable job map — stopping it never
    touches the daemons' jobs, and a restart resumes monitoring from
    the map."""
    router = FleetRouter(
        port=port, host=host, state_dir=state_dir, daemons=daemons,
        scrape_interval_s=scrape_interval_s, max_misses=max_misses,
        pull_interval_s=pull_interval_s, rebalance=rebalance,
        rebalance_min_depth=rebalance_min_depth)

    def _on_signal(signum, frame):
        router.stop_event.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _on_signal)
    router.start()
    n = len(router.view.states())
    print(f"Fleet router on {router.url} (v{VERSION}, "
          f"state: {router.state_dir}, {n} daemon(s) registered"
          + (f", reloaded {router.loaded} job record(s)" if router.loaded
             else "") + ")", flush=True)
    try:
        while not router.stop_event.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    router.close()
    print("Fleet router stopped (daemons and their jobs are unaffected).",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(router_main())
