"""Thin clients for the serve daemon (`tpu_tree_search/serve/client.py`):
``submit``, ``watch --job``, ``top`` and ``migrate``.

Pure stdlib HTTP (urllib) against 127.0.0.1 — no torch import on any path
here, same discipline as ``obs/live.watch_main``. The submit client
converts CLI run arguments into a job spec (reusing the main parser's
validation via ``submit -- <run args>``), posts it, and either returns
the id immediately or follows the job's SSE stream to completion.
``top`` is the operator console: a periodically refreshed per-job /
per-class table assembled from ``/healthz`` + ``/jobs`` + ``/classes``,
and ``top --router`` its fleet-wide view from a router's ``/fleet``.
``submit`` takes a ``router`` (a fleet router proxies every endpoint the
clients use).
"""

from __future__ import annotations

import json
import sys
import time
from urllib.error import HTTPError, URLError
from urllib.request import Request, urlopen

from ..obs.live import format_snapshot, iter_sse
from . import DEFAULT_PORT

_FINAL = ("done", "failed", "cancelled")


def _retrying(do, retry_s: float):
    """Run ``do()`` retrying transient transport failures (connection
    refused/reset during a daemon restart, socket timeouts) with
    exponential backoff until the ``retry_s`` deadline, then re-raise.
    An ``HTTPError`` is never retried here — a status line IS an answer;
    callers branch on the code. ``retry_s=0`` keeps the old single-shot
    behaviour."""
    deadline = time.monotonic() + max(0.0, retry_s)
    delay = 0.1
    while True:
        try:
            return do()
        except HTTPError:
            raise
        except (URLError, OSError, ConnectionError):
            if time.monotonic() + delay > deadline:
                raise
            time.sleep(delay)
            delay = min(2.0, delay * 2)


def _post(url: str, payload: dict, timeout: float = 10.0,
          retry_s: float = 0.0) -> tuple[int, dict]:
    body = json.dumps(payload).encode()
    req = Request(url, data=body,
                  headers={"Content-Type": "application/json"})

    def do():
        with urlopen(req, timeout=timeout) as resp:  # noqa: S310 — localhost
            return resp.status, json.loads(resp.read().decode())

    try:
        return _retrying(do, retry_s)
    except HTTPError as e:
        try:
            return e.code, json.loads(e.read().decode())
        except ValueError:
            return e.code, {"error": str(e)}


def _get(url: str, timeout: float = 10.0,
         retry_s: float = 0.0) -> tuple[int, dict]:
    def do():
        with urlopen(url, timeout=timeout) as resp:  # noqa: S310
            return resp.status, json.loads(resp.read().decode())

    try:
        return _retrying(do, retry_s)
    except HTTPError as e:
        try:
            return e.code, json.loads(e.read().decode())
        except ValueError:
            return e.code, {"error": str(e)}


def fetch_checkpoint(base: str, jid: str, timeout: float = 30.0,
                     retry_s: float = 0.0) -> tuple[bytes, int]:
    """``GET /job/<id>/checkpoint`` with gzip transport negotiated:
    returns ``(npz bytes, wire bytes)``. Shared by ``tts migrate`` and
    the fleet router's checkpoint pulls. Raises ``HTTPError`` (409: no
    checkpoint yet) or ``URLError`` past the retry deadline."""

    def do():
        # Ask for gzip transport: urllib neither advertises nor decodes
        # it on its own, so both ends are explicit here. Old daemons
        # ignore the header and send identity — both shapes are handled.
        req = Request(base + f"/job/{jid}/checkpoint",
                      headers={"Accept-Encoding": "gzip"})
        with urlopen(req, timeout=timeout) as resp:  # noqa: S310
            raw = resp.read()
            wire = len(raw)
            if resp.headers.get("Content-Encoding") == "gzip":
                import gzip

                raw = gzip.decompress(raw)
            return raw, wire

    return _retrying(do, retry_s)


def spec_from_args(args) -> dict:
    """A job spec from parsed CLI run arguments (the submit path re-parses
    ``<run args>`` through ``cli.build_parser`` first, so every CLI-side
    validation already ran). The port's parser has no compaction or
    pair-block flags, so none reaches the spec."""
    spec = {"problem": args.problem, "tier": args.tier, "m": args.m}
    if args.tier == "mesh" and args.D is not None:
        spec["D"] = args.D
    if args.M is not None:
        spec["M"] = args.M
    if args.K is not None:
        spec["K"] = args.K if args.K == "auto" else int(args.K)
    if args.problem == "nqueens":
        spec.update(N=args.N, g=args.g)
    else:
        spec.update(inst=args.inst, lb=args.lb, ub=args.ub)
        if args.lb2_variant != "full":
            spec["lb2_variant"] = args.lb2_variant
    if args.max_steps is not None:
        spec["max_steps"] = args.max_steps
    return spec


def base_url(port: int = DEFAULT_PORT, host: str = "127.0.0.1",
             router: str | None = None) -> str:
    """The client's target base URL: the router when ``--router`` (or
    TTS_ROUTER) names one — every serve endpoint the clients use is
    proxied 1:1 by the fleet router — else the daemon at host:port."""
    if router:
        router = router.rstrip("/")
        return router if "://" in router else "http://" + router
    return f"http://{host}:{port}"


def submit_main(spec: dict, port: int = DEFAULT_PORT,
                host: str = "127.0.0.1", wait: bool = False,
                as_json: bool = False, router: str | None = None,
                retry_s: float = 10.0) -> int:
    """Submit a job; with ``wait`` follow it to completion (result record
    printed — the serve analogue of a ``tts run --json`` line). The
    submit POST retries transient connection failures for ``retry_s``
    (a restarting daemon/router is a routine fleet event, not an
    error)."""
    base = base_url(port, host, router)
    try:
        code, payload = _post(base + "/submit", spec, retry_s=retry_s)
    except (URLError, OSError) as e:
        what = "fleet router" if router else "serve daemon"
        print(f"Error: no {what} at {base}: {e}", file=sys.stderr)
        return 2
    if code != 201:
        print(f"Error: submit rejected ({code}): "
              f"{payload.get('error', payload)}{_daemon_tag(base)}",
              file=sys.stderr)
        return 2
    if not wait:
        if as_json:
            print(json.dumps(payload))
        else:
            print(f"{payload['id']}  class={payload['class']}"
                  f"{' (warm)' if payload.get('warm') else ''}"
                  f"  position={payload['position']}"
                  + (f"  @ {payload['daemon']}"  # routed by a fleet router
                     if payload.get("daemon") else ""))
        return 0
    rec = follow_job(base, payload["id"],
                     emit=None if as_json else
                     (lambda s: print(format_snapshot(s), flush=True)),
                     on_incumbent=None if as_json else
                     (lambda p: print(_format_incumbent(p), flush=True)))
    if rec is None:
        print(f"Error: lost job {payload['id']}", file=sys.stderr)
        return 2
    if as_json:
        print(json.dumps(rec))
    else:
        _print_final(rec)
    return 0 if rec.get("state") == "done" else 1


def _daemon_tag(base: str) -> str:
    """`` [daemon v0.11.0, up 42s, workers 1/1 alive]`` for error
    messages — a rejected submit should say WHICH daemon rejected it and
    whether its workers are even running (a dead worker thread otherwise
    hides behind a listening socket)."""
    try:
        code, h = _get(base + "/healthz", timeout=2.0)
    except (URLError, OSError):
        return ""
    if code != 200 or not isinstance(h, dict):
        return ""
    return (f" [daemon v{h.get('version', '?')}, "
            f"up {h.get('uptime_s', 0):.0f}s, "
            f"workers {h.get('workers_alive', '?')}/{h.get('workers', '?')}"
            f" alive]")


def _format_incumbent(p: dict) -> str:
    """One human line per quality-trajectory improvement."""
    return (f"  incumbent #{p.get('n', '?')}: best={p.get('best')}"
            f"  t={p.get('t_s', 0.0):.3f}s  step={p.get('step')}"
            f"  nodes={p.get('nodes')}")


def _print_final(rec: dict) -> None:
    res = rec.get("result") or {}
    print(f"{rec['id']}: {rec['state']}"
          + (f"  tree={res.get('explored_tree')} "
             f"sol={res.get('explored_sol')} best={res.get('best')}"
             if res else "")
          + (f"  error={rec['error']}" if rec.get("error") else ""))


def follow_job(base: str, jid: str, emit=None, timeout_s: float = 600.0,
               on_incumbent=None):
    """Stream a job's SSE until its ``done`` frame; fall back to polling
    if the stream drops (daemon restart). Returns the final job record or
    None. ``on_incumbent`` receives each NEW ``event: incumbent`` quality
    frame (deduped by its monotone ``n`` index across reconnects).

    Dedupe: the server re-sends a job's latest snapshot (and every
    incumbent so far) on each NEW stream connection, so this reconnect
    loop would re-print identical frames once per retry interval on a
    quiet job. Snapshots are deduped by their ``(ts_us, seq)`` identity,
    incumbents by ``n`` — both survive any number of reconnects."""
    deadline = time.monotonic() + timeout_s
    last_key = None  # (ts_us, seq) of the last emitted snapshot
    max_n = 0  # highest incumbent index emitted
    while time.monotonic() < deadline:
        try:
            req = base + f"/job/{jid}/stream"
            with urlopen(req, timeout=timeout_s) as resp:  # noqa: S310
                for event, payload in iter_sse(resp):
                    if event == "done":
                        return payload
                    if event == "incumbent":
                        n = int(payload.get("n") or 0)
                        if n and n <= max_n:
                            continue  # reconnect replayed an old frame
                        max_n = max(max_n, n)
                        if on_incumbent is not None:
                            on_incumbent(payload)
                        continue
                    key = (payload.get("ts_us"), payload.get("seq"))
                    if key == last_key:
                        continue
                    last_key = key
                    if emit is not None:
                        emit(payload)
        except (OSError, ValueError):
            pass
        # Stream dropped: poll the record directly. The poll itself
        # rides the retry helper — a daemon restarting (or a router
        # recovering the job onto another daemon) answers again within
        # seconds, and a watch must survive that window instead of
        # reporting the job lost.
        try:
            code, rec = _get(base + f"/job/{jid}", retry_s=10.0)
        except (URLError, OSError):
            time.sleep(0.5)
            continue
        if code == 200 and rec.get("state") in _FINAL:
            return rec
        if code == 404:
            return None
        time.sleep(0.5)
    return None


def watch_job_main(jid: str, port: int = DEFAULT_PORT,
                   host: str = "127.0.0.1", once: bool = False,
                   as_json: bool = False,
                   max_updates: int | None = None) -> int:
    """``tts watch --job <id>``: live per-job stream from the daemon."""
    base = f"http://{host}:{port}"
    try:
        code, rec = _get(base + f"/job/{jid}")
    except URLError as e:
        print(f"Error: no serve daemon at {base}: {e}", file=sys.stderr)
        return 2
    if code != 200:
        print(f"Error: unknown job {jid}", file=sys.stderr)
        return 2
    emit = (lambda s: print(json.dumps(s), flush=True)) if as_json else (
        lambda s: print(format_snapshot(s), flush=True)
    )
    if once or rec.get("state") in _FINAL:
        if as_json:
            print(json.dumps(rec))
        else:
            _print_final(rec) if rec.get("state") in _FINAL else print(
                f"{rec['id']}: {rec['state']}"
            )
        return 0
    # Delegate to follow_job: it owns the reconnect/poll fallback AND the
    # cross-reconnect dedupe (the old inline loop re-printed the latest
    # snapshot after every stream drop).
    seen = {"n": 0}

    def bounded_emit(s):
        emit(s)
        seen["n"] += 1
        if max_updates is not None and seen["n"] >= max_updates:
            raise _Enough

    on_inc = ((lambda p: print(json.dumps({"incumbent": p}), flush=True))
              if as_json else
              (lambda p: print(_format_incumbent(p), flush=True)))
    try:
        final = follow_job(base, jid, emit=bounded_emit,
                           on_incumbent=on_inc)
    except (_Enough, KeyboardInterrupt):
        return 0
    if final is None:
        print(f"Error: lost job {jid}", file=sys.stderr)
        return 2
    if as_json:
        print(json.dumps(final))
    else:
        _print_final(final)
    return 0


class _Enough(Exception):
    """Raised by a bounded watch to cut the stream after --max-updates."""


# -- the `tts top` operator console ------------------------------------------


def _fmt_bytes(n) -> str:
    """Human bytes for the per-class pool column (0 -> '-': nothing
    resident yet, e.g. the class is admitted but not compiled)."""
    n = float(int(n or 0))
    if n <= 0:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}GiB"


def _render_top(health: dict, jobs: list, classes: dict) -> str:
    """The ``tts top`` display: daemon header, per-class occupancy table,
    then per-job rows (active work first, newest terminal jobs last)."""
    lines = []
    ok = health.get("ok", False)
    lines.append(
        f"tts serve v{health.get('version', '?')}"
        f"  up {health.get('uptime_s', 0):.0f}s"
        f"  queue={health.get('queue_depth', 0)}"
        f"  workers={health.get('workers_alive', '?')}"
        f"/{health.get('workers', '?')}"
        + (f"  batch={health['batch_slots']}"
           if int(health.get("batch_slots") or 1) > 1 else "")
        + ("" if ok else "  [DEGRADED: no alive worker]")
    )
    by_state: dict = {}
    for j in jobs:
        by_state[j.get("state", "?")] = by_state.get(j.get("state", "?"), 0) + 1
    lines.append("jobs: " + ("  ".join(
        f"{s}={n}" for s, n in sorted(by_state.items())) or "none"))
    if classes:
        lines.append("")
        lines.append(f"{'class':<44} {'warm':>4} {'progs':>5} "
                     f"{'steps':>5} {'jobs':>5} {'slots':>5} {'pool':>8}")
        for st in sorted(classes, key=lambda st: st.get("class", "")):
            if "slots_occupied" in st:
                slots = f"{st['slots_occupied']}/{st.get('batch_slots', '?')}"
            else:
                slots = "-"
            lines.append(
                f"{(st.get('class') or '?')[:44]:<44} "
                f"{'y' if st.get('warm') else '-':>4} "
                f"{st.get('programs', 0):>5} "
                f"{st.get('step_cache_entries', 0):>5} "
                f"{st.get('jobs_admitted', 0):>5} "
                f"{slots:>5} "
                f"{_fmt_bytes(st.get('pool_bytes', 0)):>8}")
    active = [j for j in jobs
              if j.get("state") in ("running", "queued", "requeued")]
    finished = [j for j in jobs if j not in active]
    rows = active + finished[-5:]  # full active set + recent history
    if rows:
        lines.append("")
        lines.append(f"{'job':<12} {'state':<9} {'class':<36} "
                     f"{'slices':>6} {'preempt':>7} {'steps':>9} {'best':>8}")
        for j in rows:
            res = j.get("result") or {}
            q = (res.get("quality") or {}).get("points") or []
            best = res.get("best", q[-1]["best"] if q else None)
            lines.append(
                f"{j.get('id', '?'):<12} {j.get('state', '?'):<9} "
                f"{(j.get('class') or '?')[:36]:<36} "
                f"{j.get('slices', 0):>6} {j.get('preemptions', 0):>7} "
                f"{j.get('steps', 0):>9} "
                f"{best if best is not None else '-':>8}")
    return "\n".join(lines)


def top_main(port: int = DEFAULT_PORT, host: str = "127.0.0.1",
             interval: float = 2.0, once: bool = False,
             as_json: bool = False) -> int:
    """``tts top``: live per-job / per-class daemon table (the serve
    analogue of ``tts watch``'s single-run status line). ``--once``
    prints one frame and exits (CI smoke); ``--json`` emits the raw
    composed payload per refresh."""
    base = f"http://{host}:{port}"
    try:
        while True:
            try:
                _, health = _get(base + "/healthz", timeout=5.0)
                _, jobs = _get(base + "/jobs", timeout=5.0)
                _, classes = _get(base + "/classes", timeout=5.0)
            except (URLError, OSError) as e:
                print(f"Error: no serve daemon at {base}: {e}",
                      file=sys.stderr)
                return 2
            if as_json:
                print(json.dumps({"health": health, "jobs": jobs,
                                  "classes": classes}), flush=True)
            else:
                if not once and sys.stdout.isatty():
                    print("\x1b[2J\x1b[H", end="")
                print(_render_top(health, jobs, classes), flush=True)
            if once:
                return 0
            time.sleep(interval)
    except KeyboardInterrupt:
        return 0


# -- `top --router`: the fleet-wide operator console ----------------------


def _render_fleet_top(fleet: dict) -> str:
    """Per-daemon rows + fleet totals from the router's ``/fleet``
    aggregate (its keeper's last ``/healthz`` + ``/classes`` scrape of
    every registered daemon)."""
    router = fleet.get("router") or {}
    daemons = fleet.get("daemons") or []
    jobs = fleet.get("jobs") or []
    lines = [
        f"fleet v{router.get('version', '?')}"
        f"  up {router.get('uptime_s', 0):.0f}s"
        f"  daemons={router.get('daemons_healthy', 0)}"
        f"/{router.get('daemons', 0)} healthy"
        f"  jobs={router.get('jobs', 0)}"
        + ("" if router.get("ok") else "  [DEGRADED: no healthy daemon]")
    ]
    lines.append("")
    lines.append(f"{'daemon':<28} {'state':<8} {'queue':>5} {'work':>6} "
                 f"{'warm':>4} {'cls':>3} {'pool':>8} {'jobs':<24}")
    tot_queue = tot_warm = tot_cls = tot_pool = 0
    for d in daemons:
        h = d.get("health") or {}
        classes = d.get("classes") or []
        warm = sum(1 for c in classes if c.get("warm"))
        pool = sum(int(c.get("pool_bytes", 0) or 0) for c in classes)
        state = ("drain" if d.get("draining")
                 else "ok" if d.get("healthy")
                 else f"dead({d.get('misses', 0)})")
        by_state = d.get("jobs_by_state") or {}
        tot_queue += int(h.get("queue_depth", 0) or 0)
        tot_warm += warm
        tot_cls += len(classes)
        tot_pool += pool
        lines.append(
            f"{d.get('url', '?')[:28]:<28} {state:<8} "
            f"{h.get('queue_depth', 0):>5} "
            f"{h.get('workers_alive', '?')}/{h.get('workers', '?'):>4} "
            f"{warm:>4} {len(classes):>3} {_fmt_bytes(pool):>8} "
            + (" ".join(f"{s}={n}" for s, n in sorted(by_state.items()))
               or "-"))
    lines.append(
        f"{'TOTAL':<28} {'':<8} {tot_queue:>5} {'':>6} "
        f"{tot_warm:>4} {tot_cls:>3} {_fmt_bytes(tot_pool):>8}")
    active = [j for j in jobs
              if j.get("state") not in _FINAL]
    finished = [j for j in jobs if j not in active]
    rows = active + finished[-5:]
    if rows:
        lines.append("")
        lines.append(f"{'fleet job':<12} {'state':<9} {'daemon':<24} "
                     f"{'class':<30} {'steps':>8} {'moves':>5}")
        for j in rows:
            lines.append(
                f"{j.get('id', '?'):<12} {j.get('state') or '?':<9} "
                f"{(j.get('daemon') or '?')[:24]:<24} "
                f"{(j.get('class') or '?')[:30]:<30} "
                f"{j.get('steps', 0):>8} {j.get('resubmits', 0):>5}")
    return "\n".join(lines)


def fleet_top_main(router: str, interval: float = 2.0, once: bool = False,
                   as_json: bool = False) -> int:
    """``top --router URL``: the fleet-wide console — per-daemon
    rows aggregated from the router keeper's scrapes plus fleet totals.
    ``--once``/``--json`` mirror the single-daemon ``top``."""
    base = base_url(router=router)
    try:
        while True:
            try:
                code, fleet = _get(base + "/fleet", timeout=5.0,
                                   retry_s=5.0)
            except (URLError, OSError) as e:
                print(f"Error: no fleet router at {base}: {e}",
                      file=sys.stderr)
                return 2
            if code != 200:
                print(f"Error: /fleet failed ({code}): {fleet}",
                      file=sys.stderr)
                return 2
            if as_json:
                print(json.dumps(fleet), flush=True)
            else:
                if not once and sys.stdout.isatty():
                    print("\x1b[2J\x1b[H", end="")
                print(_render_fleet_top(fleet), flush=True)
            if once:
                return 0
            time.sleep(interval)
    except KeyboardInterrupt:
        return 0


# -- `tts migrate`: cross-daemon job migration --------------------------------


def migrate_main(jid: str, to_url: str, port: int = DEFAULT_PORT,
                 host: str = "127.0.0.1", as_json: bool = False,
                 timeout_s: float = 120.0) -> int:
    """``tts migrate <job> --to URL``: move a job between daemons over its
    portable checkpoint. Cancel on daemon A (cutting a running slice at
    the next dispatch boundary), fetch the checkpoint bytes, resubmit the
    spec + checkpoint to daemon B — counters stay cumulative, so the
    migrated run's final result is bit-identical to never having moved.
    A consumed ``max_steps`` budget follows the job: the resubmitted spec
    carries only the remaining steps."""
    base = f"http://{host}:{port}"
    dst = to_url.rstrip("/")
    if "://" not in dst:
        dst = "http://" + dst
    try:
        code, rec = _get(base + f"/job/{jid}")
    except URLError as e:
        print(f"Error: no serve daemon at {base}: {e}", file=sys.stderr)
        return 2
    if code != 200:
        print(f"Error: unknown job {jid}", file=sys.stderr)
        return 2
    if rec.get("state") in ("queued", "requeued", "running"):
        code, resp = _post(base + f"/job/{jid}/cancel", {})
        if code not in (200, 409):
            print(f"Error: cancel failed ({code}): {resp}", file=sys.stderr)
            return 2
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            code, rec = _get(base + f"/job/{jid}")
            if code == 200 and rec.get("state") in _FINAL:
                break
            time.sleep(0.2)
    if rec.get("state") == "done":
        print(f"{jid} already finished on {base}; nothing to migrate",
              file=sys.stderr)
        return 1
    if not rec.get("checkpoint"):
        print(f"Error: {jid} has no checkpoint to migrate "
              f"(state {rec.get('state')}; it never ran to a cut)",
              file=sys.stderr)
        return 2
    try:
        raw, wire_bytes = fetch_checkpoint(base, jid)
    except (URLError, OSError) as e:
        print(f"Error: checkpoint fetch failed: {e}", file=sys.stderr)
        return 2
    spec = dict(rec.get("spec") or {})
    steps = int(rec.get("steps") or 0)
    if spec.get("max_steps") is not None:
        remaining = int(spec["max_steps"]) - steps
        if remaining <= 0:
            print(f"Error: {jid} already exhausted its max_steps budget "
                  f"({steps}/{spec['max_steps']})", file=sys.stderr)
            return 2
        spec["max_steps"] = remaining
    import base64

    payload = {**spec, "resume_ckpt_b64": base64.b64encode(raw).decode()}
    try:
        code, sub = _post(dst + "/submit", payload, timeout=60.0)
    except URLError as e:
        print(f"Error: no serve daemon at {dst}: {e}", file=sys.stderr)
        return 2
    if code != 201:
        print(f"Error: destination rejected the migrated job ({code}): "
              f"{sub.get('error', sub)}{_daemon_tag(dst)}", file=sys.stderr)
        return 2
    if as_json:
        print(json.dumps({"from": jid, "id": sub["id"], "to": dst,
                          "class": sub.get("class"),
                          "warm": sub.get("warm"), "steps_done": steps,
                          "ckpt_bytes": len(raw),
                          "ckpt_wire_bytes": wire_bytes}))
    else:
        print(f"{jid} -> {sub['id']} @ {dst}  class={sub.get('class')}"
              f"{' (warm)' if sub.get('warm') else ''}"
              f"  steps_done={steps}"
              f"  ckpt={len(raw)}B"
              + (f" (gzip wire {wire_bytes}B)"
                 if wire_bytes != len(raw) else ""))
    return 0
