"""The port's fleet router (`tpu_tree_search_torch/fleet/`) on the CPU, held
to the JAX package's (`tpu_tree_search/fleet/`).

  * the placement policy (``choose``, ``pick_rebalance``) and the load
    generator's plan (``make_plan``) against the JAX functions on the same
    synthetic snapshots and seeds — pure, no socket;
  * the durable ``FleetJobMap``, and a record written by one package's map
    loaded by the other's;
  * the host-only pin: importing the router loads no torch, no fleet
    module imports torch or JAX, and ``TTS_ROUTER`` forks no class key;
  * end to end, in-process ``device="cpu"`` daemons (port 0) behind an
    in-process router: warm and cold placement under ``TTS_GUARD=1``, the
    SSE proxy, ``top --router``, the refusals; a drained daemon's job and a
    SIGKILLed daemon's job (a subprocess daemon) finish with the counts of
    an uninterrupted run.

Every wait polls the router for the state it waits for, under a deadline.
"""

from __future__ import annotations

import functools
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from tpu_tree_search.engine import sequential_search as jax_sequential
from tpu_tree_search.fleet import loadgen as jax_loadgen
from tpu_tree_search.fleet import placement as jax_placement
from tpu_tree_search.fleet.router import FleetJobMap as JaxFleetJobMap
from tpu_tree_search.problems import NQueensProblem as JaxNQueens
from tpu_tree_search_torch.fleet import loadgen, placement
from tpu_tree_search_torch.fleet.router import FleetJobMap, FleetRouter
from tpu_tree_search_torch.serve.server import ServeDaemon

REPO = Path(__file__).resolve().parent.parent
_FINAL = ("done", "failed", "cancelled")
NQ10 = {"problem": "nqueens", "N": 10, "M": 256}


def _post(base, path, payload):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _poll(what, fn, timeout_s=90.0, every_s=0.05):
    """``fn()`` until it returns a true value, under a deadline."""
    deadline = time.monotonic() + timeout_s
    last = None
    while time.monotonic() < deadline:
        last = fn()
        if last:
            return last
        time.sleep(every_s)
    raise AssertionError(f"{what} not seen in {timeout_s}s (last: {last})")


def _wait_final(router_url, fid, timeout_s=240.0):
    """The fleet job's record once terminal AND fresh (a cached record
    mid-recovery reports ``stale``). Polled every 0.2 s: the router and
    the in-process daemons share this process's interpreter lock with the
    searches."""
    def final():
        code, rec = _get(router_url, f"/job/{fid}")
        assert code == 200, rec
        return rec if rec["state"] in _FINAL and not rec.get("stale") else None
    return _poll(f"fleet job {fid} final", final, timeout_s, every_s=0.2)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread for the daemons' small searches, as the
    subprocess daemon's ``OMP_NUM_THREADS=1``: with the suite's parallel
    workers on the same cores, idle OpenMP waiters made a dispatch 100 to
    1000 times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _daemon(tmp_path, name, **kw):
    d = ServeDaemon(port=0, state_dir=str(tmp_path / name), device="cpu",
                    **kw)
    d.start()
    return d


def _close(*daemons):
    for d in daemons:
        d.scheduler.drain(timeout_s=30.0)
        d.close()


def _router(tmp_path, daemons, **kw):
    kw.setdefault("scrape_interval_s", 0.2)
    kw.setdefault("pull_interval_s", 0.3)
    r = FleetRouter(port=0, state_dir=str(tmp_path / "fleet"),
                    daemons=[d.url for d in daemons], **kw)
    r.start()
    return r


@functools.cache
def _jax_counts(N):
    """The JAX package's uninterrupted sequential run of N-Queens N: its
    (tree, sol, best), once a module."""
    res = jax_sequential(JaxNQueens(N=N))
    return res.explored_tree, res.explored_sol, res.best


def _counts(rec):
    r = rec["result"]
    return r["explored_tree"], r["explored_sol"], r["best"]


# -- the pure policy against the JAX package's (no sockets) ---------------------


def _state(mod, url, *, healthy=True, draining=False, queue_depth=0,
           classes=(), jobs=(), wait_sum=0.0, wait_count=0):
    st = mod.DaemonState(url)
    st.healthy = healthy
    st.draining = draining
    st.health = {"ok": healthy, "queue_depth": queue_depth}
    st.classes = [dict(c) for c in classes]
    st.jobs = [dict(j) for j in jobs]
    st.metrics = {
        "tts_serve_queue_wait_seconds_sum": {(): wait_sum},
        "tts_serve_queue_wait_seconds_count": {(): wait_count},
    }
    return st


GIB = 1 << 30
#: (snapshots, class, the expected (url, reason)). Warm beats idle (a
#: compile there costs more than a queue here); a free same-class slot
#: beats a full one; cold goes least-loaded, the measured queue wait
#: breaking a queue-depth tie; unhealthy and draining daemons are skipped.
CHOOSE = [
    ([dict(url="http://a:1", queue_depth=3,
           classes=[{"class": "X", "warm": True}]),
      dict(url="http://b:1")], "X", ("http://a:1", "warm")),
    ([dict(url="http://a:1", classes=[{"class": "X", "warm": True,
                                       "batch_slots": 2, "slots_occupied": 2}]),
      dict(url="http://b:1", classes=[{"class": "X", "warm": True,
                                       "batch_slots": 2, "slots_occupied": 1}])],
     "X", ("http://b:1", "warm")),
    ([dict(url="http://a:1", queue_depth=4), dict(url="http://b:1",
                                                 queue_depth=1),
      dict(url="http://c:1", queue_depth=1, wait_sum=40.0, wait_count=4)],
     "Y", ("http://b:1", "cold")),
    ([dict(url="http://a:1", healthy=False,
           classes=[{"class": "X", "warm": True}]),
      dict(url="http://b:1", draining=True,
           classes=[{"class": "X", "warm": True}]),
      dict(url="http://c:1")], "X", ("http://c:1", "cold")),
    ([dict(url="http://a:1", healthy=False),
      dict(url="http://b:1", draining=True)], "X", (None, "no healthy daemon")),
    ([dict(url="http://b:1", classes=[{"class": "Z", "pool_bytes": 3 * GIB}]),
      dict(url="http://a:1", classes=[{"class": "Z", "pool_bytes": GIB}])],
     "X", ("http://a:1", "cold")),
    ([dict(url="http://b:1", queue_depth=1,
           classes=[{"class": "X", "warm": True}]),
      dict(url="http://a:1", queue_depth=0,
           classes=[{"class": "X", "warm": True}])], "X", ("http://a:1",
                                                           "warm")),
]


@pytest.mark.parametrize("snaps,cls,want", CHOOSE)
def test_choose_equals_jax(snaps, cls, want):
    got = {}
    for name, mod in (("port", placement), ("jax", jax_placement)):
        states = [_state(mod, **s) for s in snaps]
        st, reason = mod.choose(states, cls)
        got[name] = (st.url if st is not None else None, reason)
    assert got["port"] == got["jax"] == want


def _runner(jid, steps, ckpt="c"):
    return {"id": jid, "state": "running", "checkpoint": ckpt, "steps": steps}


#: (snapshots, min_depth, the expected (hot, job id, idle) or None). The
#: longest-running checkpointed job moves; below the depth, with the idle
#: daemon busy, or with no checkpointed runner, nothing moves.
REBALANCE = [
    ([dict(url="http://a:1", queue_depth=3,
           jobs=[_runner("job-1", 50), _runner("job-2", 90),
                 _runner("job-3", 99, None)]),
      dict(url="http://b:1")], 2, ("http://a:1", "job-2", "http://b:1")),
    ([dict(url="http://a:1", queue_depth=1, jobs=[_runner("job-1", 50)]),
      dict(url="http://b:1")], 2, None),
    ([dict(url="http://a:1", queue_depth=3, jobs=[_runner("job-1", 50)]),
      dict(url="http://b:1", jobs=[{"id": "j", "state": "running"}])], 2,
     None),
    ([dict(url="http://a:1", queue_depth=3, jobs=[_runner("job-1", 5, None)]),
      dict(url="http://b:1")], 2, None),
    ([dict(url="http://a:1", queue_depth=5,
           jobs=[_runner("job-7", 40), _runner("job-4", 40)]),
      dict(url="http://c:1", queue_depth=2), dict(url="http://b:1")], 3,
     ("http://a:1", "job-4", "http://b:1")),
    ([dict(url="http://a:1", queue_depth=3, jobs=[_runner("job-1", 50)])], 2,
     None),
]


@pytest.mark.parametrize("snaps,min_depth,want", REBALANCE)
def test_pick_rebalance_equals_jax(snaps, min_depth, want):
    got = {}
    for name, mod in (("port", placement), ("jax", jax_placement)):
        picked = mod.pick_rebalance([_state(mod, **s) for s in snaps],
                                    min_depth=min_depth)
        got[name] = (None if picked is None
                     else (picked[0].url, picked[1]["id"], picked[2].url))
    assert got["port"] == got["jax"] == want


# -- the load generator against the JAX package's ------------------------------


@pytest.mark.parametrize("kw", [
    dict(seed=42, n_jobs=200, rate_per_s=10.0),
    dict(seed=5, n_jobs=6, rate_per_s=2.0, steps_scale=10, steps_cap=40),
    dict(seed=7, n_jobs=50, rate_per_s=0.5, pareto_alpha=2.5,
         classes=[{"spec": {"problem": "pfsp", "inst": 14}, "weight": 1},
                  {"spec": {"problem": "nqueens", "N": 9}}]),
])
def test_make_plan_equals_jax(kw):
    assert loadgen.make_plan(**kw) == jax_loadgen.make_plan(**kw)


def test_make_plan_deterministic_and_heavy_tailed():
    p1 = loadgen.make_plan(seed=42, n_jobs=200, rate_per_s=10.0)
    assert p1 == loadgen.make_plan(seed=42, n_jobs=200, rate_per_s=10.0)
    assert p1 != loadgen.make_plan(seed=43, n_jobs=200, rate_per_s=10.0)
    ats = [row["at_s"] for row in p1]
    assert ats == sorted(ats) and len(ats) == 200
    steps = [row["spec"]["max_steps"] for row in p1]
    assert all(8 <= s <= 600 for s in steps)
    assert max(steps) > 10 * sorted(steps)[len(steps) // 2]
    classes = {loadgen._class_of(row["spec"]) for row in p1}
    assert len(classes) == len(loadgen.DEFAULT_CLASSES)


def test_quantile_nearest_rank():
    for mod in (loadgen, jax_loadgen):
        assert mod._quantile([], 0.99) == 0.0
        assert mod._quantile([5.0], 0.99) == 5.0
        assert mod._quantile(list(range(100)), 0.50) == 50
        assert mod._quantile(list(range(100)), 0.99) == 98


# -- the host-only pin -----------------------------------------------------------


def test_router_import_loads_no_torch():
    """Importing the router (and classifying a spec with the daemons' own
    class-key computation) leaves torch out of the process."""
    code = ("import sys; import tpu_tree_search_torch.fleet.router; "
            "import tpu_tree_search_torch.fleet.loadgen; "
            "from tpu_tree_search_torch.fleet.placement import "
            "fleet_class_key; "
            "fleet_class_key({'problem': 'pfsp', 'inst': 14, 'M': 1024}); "
            "fleet_class_key({'problem': 'nqueens'}); "
            "print(sorted(m for m in ('torch', 'jax') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_router_is_host_only(monkeypatch):
    """TTS_ROUTER forks no program-cache key, and no fleet module imports
    torch, JAX or the JAX package."""
    from tpu_tree_search_torch.serve.pool import server_env_token

    monkeypatch.delenv("TTS_ROUTER", raising=False)
    t0 = server_env_token()
    monkeypatch.setenv("TTS_ROUTER", "http://127.0.0.1:9999")
    assert server_env_token() == t0
    assert "TTS_ROUTER" not in repr(server_env_token())
    pkg = REPO / "tpu_tree_search_torch" / "fleet"
    names = sorted(p.name for p in pkg.glob("*.py"))
    assert names == ["__init__.py", "health.py", "loadgen.py",
                     "placement.py", "router.py"]
    for name in names:
        src = (pkg / name).read_text()
        assert not re.search(
            r"^\s*(import (torch|jax)|from (torch|jax|tpu_tree_search)\b)",
            src, re.M), f"fleet/{name} must stay host-only"


def test_fleet_job_map_durable(tmp_path):
    m1 = FleetJobMap(str(tmp_path))
    job = m1.create({"problem": "nqueens"}, "clsX")
    m1.update(job, daemon="http://a:1", daemon_job="job-000007",
              ckpt_steps=12)
    m2 = FleetJobMap(str(tmp_path))
    assert m2.load() == 1
    back = m2.get(job.id)
    assert back.daemon == "http://a:1" and back.daemon_job == "job-000007"
    assert back.ckpt_steps == 12 and back.cls == "clsX"
    # The sequence resumes past reloaded ids: no id reuse after a restart.
    assert int(m2.create({}, "c").id.split("-")[-1]) > \
        int(job.id.split("-")[-1])


@pytest.mark.parametrize("writer,reader", [
    (FleetJobMap, JaxFleetJobMap), (JaxFleetJobMap, FleetJobMap)])
def test_fleet_job_map_records_cross_packages(tmp_path, writer, reader):
    """A router of either package reloads the other's durable job map."""
    w = writer(str(tmp_path))
    job = w.create({"problem": "nqueens", "N": 10, "M": 256}, "clsX")
    w.update(job, daemon="http://a:1", daemon_job="job-000003",
             resubmits=2, history=[{"daemon": "http://a:1",
                                    "daemon_job": "job-000003"}],
             ckpt="/x/fjob.npz", ckpt_steps=9,
             last_record={"state": "running", "steps": 9},
             needs_recovery=True, error="E")
    r = reader(str(tmp_path))
    assert r.load() == 1
    back = r.get(job.id)
    assert back.record() == job.record()
    assert back.brief() == job.brief()


# -- end to end ------------------------------------------------------------------


def _warm_on(router_url, daemon_url):
    code, fleet = _get(router_url, "/fleet")
    assert code == 200
    for d in fleet["daemons"]:
        if d["url"] == daemon_url and any(c.get("warm")
                                          for c in d["classes"]):
            return True
    return False


def test_fleet_warm_placement_builds_nothing(tmp_path, monkeypatch):
    """Three mixed-class jobs through a two-daemon fleet under
    TTS_GUARD=1: the second same-class job lands warm on the first one's
    daemon and builds no program and no graph; another class warms cold on
    the other daemon."""
    monkeypatch.setenv("TTS_GUARD", "1")
    da = _daemon(tmp_path, "a")
    db = _daemon(tmp_path, "b")
    r = _router(tmp_path, [da, db])
    try:
        code, p1 = _post(r.url, "/submit", {**NQ10, "max_steps": 40})
        assert code == 201 and p1["placement"] == "cold", p1
        rec1 = _wait_final(r.url, p1["id"])
        assert rec1["state"] == "done"
        # The keeper's scrape shows the class warm before the next submit.
        _poll("the class warm", lambda: _warm_on(r.url, p1["daemon"]))
        code, p2 = _post(r.url, "/submit", {**NQ10, "max_steps": 40})
        assert code == 201 and p2["placement"] == "warm", p2
        assert p2["daemon"] == p1["daemon"]
        code, p3 = _post(r.url, "/submit",
                         {"problem": "nqueens", "N": 9, "M": 256,
                          "max_steps": 40})
        assert code == 201 and p3["placement"] == "cold", p3
        assert p3["daemon"] != p1["daemon"]
        rec2 = _wait_final(r.url, p2["id"])
        rec3 = _wait_final(r.url, p3["id"])
        assert rec2["state"] == "done" and rec3["state"] == "done"
        assert rec2["new_programs"] == 0 and rec2["new_step_compiles"] == 0
        # Guarded, and more than the warm dispatch was checked.
        assert rec2["result"]["guard"]["checked_dispatches"] >= 1
        assert _counts(rec2) == _counts(rec1) == _jax_counts(10)
        assert _counts(rec3) == _jax_counts(9)
        assert rec2["id"] == p2["id"] and rec2["daemon_job"].startswith("job-")
        code, fleet = _get(r.url, "/fleet")
        assert fleet["router"]["daemons_healthy"] == 2
        assert {j["state"] for j in fleet["jobs"]} == {"done"}
    finally:
        r.close()
        _close(da, db)


def test_fleet_sse_stream_proxy(tmp_path):
    """The proxied stream ends with a ``done`` frame in the fleet's
    identity, relayed from the owning daemon."""
    da = _daemon(tmp_path, "a")
    r = _router(tmp_path, [da])
    try:
        code, p = _post(r.url, "/submit", {**NQ10, "max_steps": 40})
        assert code == 201, p
        done = None
        with urllib.request.urlopen(r.url + f"/job/{p['id']}/stream",
                                    timeout=120) as resp:
            event = None
            for raw in resp:
                line = raw.decode().rstrip("\n")
                if line.startswith("event: "):
                    event = line[len("event: "):]
                elif line.startswith("data: ") and event == "done":
                    done = json.loads(line[len("data: "):])
                    break
        assert done is not None
        assert done["id"] == p["id"] and done["state"] == "done"
        assert done["daemon_job"].startswith("job-")
        assert done["daemon"] == da.url
    finally:
        r.close()
        _close(da)


def test_fleet_top_once_json_and_text(tmp_path, capsys):
    """``top --router URL --once`` prints the /fleet aggregate (one JSON
    line with --json), and the CLI's ``submit --router`` goes through it."""
    from tpu_tree_search_torch import cli

    da = _daemon(tmp_path, "a")
    r = _router(tmp_path, [da])
    try:
        assert cli.main(["top", "--router", r.url, "--once", "--json"]) == 0
        payload = json.loads(capsys.readouterr().out.strip())
        assert payload["router"]["daemons"] == 1
        assert payload["daemons"][0]["url"] == da.url
        assert payload["daemons"][0]["healthy"] is True
        assert cli.main(["submit", "--router", r.url, "--wait", "--json",
                         "--", "nqueens", "--N", "8", "--M", "64"]) == 0
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec["id"].startswith("fjob-") and rec["state"] == "done"
        assert _counts(rec) == _jax_counts(8)
        assert cli.main(["top", "--router", r.url, "--once"]) == 0
        out = capsys.readouterr().out
        assert out.startswith("fleet v") and rec["id"] in out
    finally:
        r.close()
        _close(da)


def test_fleet_rejects_bad_spec_and_no_capacity(tmp_path):
    da = _daemon(tmp_path, "a")
    r = _router(tmp_path, [da])
    try:
        code, resp = _post(r.url, "/submit", {"problem": "tsp"})
        assert code == 400 and "error" in resp
        code, resp = _get(r.url, "/job/fjob-999999")
        assert code == 404
    finally:
        r.close()
        _close(da)
    # With its only daemon gone, placement answers 503 naming the reason.
    r2 = FleetRouter(port=0, state_dir=str(tmp_path / "fleet2"),
                     daemons=[da.url], scrape_interval_s=0.2)
    r2.start()
    try:
        code, resp = _post(r2.url, "/submit", dict(NQ10))
        assert code == 503 and "no daemon" in resp["error"]
    finally:
        r2.close()


# -- end to end: recovery --------------------------------------------------------


def _banner_url(proc, timeout_s=120.0):
    """The daemon's URL from its banner line, under a deadline."""
    found = []

    def read():
        for line in proc.stdout:
            m = re.search(r"(http://127\.0\.0\.1:\d+)", line)
            if m:
                found.append(m.group(1))
                return

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    return found[0] if found else None


def test_sigkill_recovery_equals_uninterrupted(tmp_path):
    """SIGKILL a daemon mid-job; the router resubmits the last pulled cut
    (with the remaining budget) to a daemon registered afterwards, and the
    final counts equal an uninterrupted run's."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("TTS_GUARD", None)
    pa = subprocess.Popen(
        [sys.executable, "-m", "tpu_tree_search_torch", "serve", "--port",
         "0", "--device", "cpu", "--state-dir", str(tmp_path / "a"),
         "--ckpt-every", "0.3"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=str(REPO))
    db = r = None
    try:
        url_a = _banner_url(pa)
        assert url_a, "daemon A never printed its banner"
        r = _router(tmp_path, [], max_misses=2)
        r.register(url_a)
        code, p = _post(r.url, "/submit",
                        {"problem": "nqueens", "N": 12, "M": 256, "K": 4})
        assert code == 201, p
        fid = p["id"]
        # Killed once a pulled cut holds a third of the job's ~838
        # dispatches, so that the recovering daemon, in this process, runs
        # what is left.
        _poll("a pulled cut", lambda: (lambda j: j.ckpt and j.ckpt_steps >= 280)(
            r.jobs.get(fid)), timeout_s=180.0)
        pa.send_signal(signal.SIGKILL)
        # The death detector flags the job (no other daemon to take it).
        _poll("the job flagged for recovery",
              lambda: r.jobs.get(fid).needs_recovery)
        db = _daemon(tmp_path, "b")
        r.register(db.url)
        rec = _wait_final(r.url, fid)
        assert rec["state"] == "done" and rec["daemon"] == db.url
        assert rec["resubmits"] >= 1
        assert _counts(rec) == _jax_counts(12)
    finally:
        if r is not None:
            r.close()
        if db is not None:
            _close(db)
        pa.kill()
        pa.wait(timeout=30)


def test_drain_triggers_live_migration(tmp_path):
    """A draining daemon's ``/healthz`` flags it; the keeper migrates its
    job to the healthy daemon over the live (cancel-with-cut) path, and
    the counts equal an uninterrupted run's."""
    da = _daemon(tmp_path, "a", ckpt_every_s=0.3)
    db = _daemon(tmp_path, "b", ckpt_every_s=0.3)
    r = _router(tmp_path, [da, db])
    try:
        code, p = _post(r.url, "/submit",
                        {"problem": "nqueens", "N": 11, "M": 256, "K": 4})
        assert code == 201, p
        # A cold class ties on load: drain whichever daemon took it.
        src, dst = (da, db) if p["daemon"] == da.url else (db, da)
        _poll("the job running", lambda: _get(
            r.url, f"/job/{p['id']}")[1].get("state") == "running")
        src.scheduler.drain(timeout_s=0.0)
        rec = _wait_final(r.url, p["id"])
        assert rec["state"] == "done" and rec["daemon"] == dst.url
        assert rec["resubmits"] >= 1
        assert _counts(rec) == _jax_counts(11)
    finally:
        r.close()
        _close(da, db)


@pytest.mark.slow
def test_loadgen_saturation_point(tmp_path):
    """One saturation point end to end: the loadgen drives a two-daemon
    fleet and every admitted job finishes with a measured queue wait."""
    da = _daemon(tmp_path, "a")
    db = _daemon(tmp_path, "b")
    r = _router(tmp_path, [da, db])
    try:
        plan = loadgen.make_plan(seed=5, n_jobs=6, rate_per_s=2.0,
                                 steps_scale=10, steps_cap=40)
        res = loadgen.run_plan(r.url, plan, timeout_s=300.0)
        s = res["summary"]
        assert s["offered"] == 6 and s["admitted"] == 6, s
        assert s["done"] == 6, (s, res["jobs"])
        assert s["queue_wait_ms_p99"] >= s["queue_wait_ms_p50"] >= 0
        assert res["per_class"]
    finally:
        r.close()
        _close(da, db)
