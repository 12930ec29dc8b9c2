"""The port's serve daemon (`tpu_tree_search_torch/serve/`) on the CPU,
held to the JAX package's (`tpu_tree_search/serve/`).

  * ``validate_spec`` and ``class_key`` against the JAX functions on the
    shared fields, and the port's refusals (``mp`` past 1, ``compact``,
    ``lb2_pairblock``);
  * registry durability, and a registry written by the JAX ``JobRegistry``
    loaded by the port's (and back);
  * an in-process ``device="cpu"`` daemon: submit, stream and result equal
    to the JAX CLI's counts; a second same-class job builds no program;
    preempt and resume, and the ``max_steps`` budget across preemption,
    bit-identical; cancel; drain to ``requeued``; a 2-slot batch
    bit-identical to solo with a zero-new-program splice;
  * ``warmup``'s selection and its hit/miss on the build directory;
  * the CLI: ``submit``, ``watch --job``, ``top``, and exit 2 for a router
    that does not answer (``top --router``, ``submit --router``).

Every wait on a daemon has its own timeout.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import urllib.request

import pytest

from tpu_tree_search.serve import jobs as jax_jobs
from tpu_tree_search.serve import pool as jax_pool
from tpu_tree_search_torch import cli
from tpu_tree_search_torch.engine.resident import resident_search
from tpu_tree_search_torch.problems import NQueensProblem
from tpu_tree_search_torch.serve import pool as serve_pool
from tpu_tree_search_torch.serve import warmup
from tpu_tree_search_torch.serve.jobs import JobRegistry, validate_spec
from tpu_tree_search_torch.serve.server import ServeDaemon

_FINAL = ("done", "failed", "cancelled")
NQ10 = {"problem": "nqueens", "N": 10, "M": 256, "K": 4}


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


def _wait_final(base, jid, timeout_s=120.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        code, rec = _get(base, f"/job/{jid}")
        assert code == 200, rec
        if rec["state"] in _FINAL:
            return rec
        time.sleep(0.05)
    raise AssertionError(f"job {jid} did not finish in {timeout_s}s")


def _wait_state(base, jid, state, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        _, rec = _get(base, f"/job/{jid}")
        if rec["state"] == state:
            return rec
        time.sleep(0.02)
    raise AssertionError(f"job {jid} never reached {state}")


def _daemon(tmp_path, **kw):
    d = ServeDaemon(port=0, state_dir=str(tmp_path / "state"), device="cpu",
                    **kw)
    d.start()
    return d


def _close(d):
    d.scheduler.drain(timeout_s=30.0)
    d.close()


@pytest.fixture
def daemon(tmp_path):
    d = _daemon(tmp_path)
    yield d
    _close(d)


def _reference(N, M=256, K=4):
    return resident_search(NQueensProblem(N), m=25, M=M, K=K, device="cpu")


def _counts(rec):
    r = rec["result"]
    return r["explored_tree"], r["explored_sol"], r["best"]


# -- specs and classes against the JAX package ----------------------------------


SHARED = [
    {"problem": "nqueens", "M": 1024},
    {"problem": "nqueens", "N": 12, "g": 2, "m": 5, "M": 64, "K": "auto"},
    {"problem": "pfsp", "M": 4096, "max_steps": 3, "label": "x"},
    {"problem": "pfsp", "inst": 21, "lb": "lb2", "lb2_variant": "nabeshima",
     "ub": 0, "M": 1024, "K": 8},
    {"problem": "pfsp", "lb": "lb1_d", "M": 256, "compact": "auto"},
]


@pytest.mark.parametrize("spec", SHARED)
def test_validate_spec_and_class_key_match_jax(spec):
    mine = validate_spec(dict(spec), "cpu")
    theirs = jax_jobs.validate_spec(dict(spec))
    theirs.pop("compact", None)  # the port takes 'auto' only and keeps none
    assert mine == theirs
    key, jkey = serve_pool.class_key(mine), jax_pool.class_key(theirs)
    # The compaction mode is each engine's own policy (the port's is the
    # JAX gpu row); everything before it is the same token.
    assert key.split("-compact=")[0] == jkey.split("-compact=")[0]
    if spec["problem"] == "nqueens":
        assert key == jkey
    assert serve_pool.identity_key(mine) == jax_pool.identity_key(theirs)


def test_default_m_is_the_port_cli_default():
    assert validate_spec({"problem": "pfsp"}, "cuda")["M"] == 49152
    assert validate_spec({"problem": "pfsp"}, "cpu")["M"] == 50000
    assert validate_spec({"problem": "nqueens"}, "cuda")["M"] == 50000


@pytest.mark.parametrize("bad,queue", [
    ({"problem": "nqueens", "tier": "mesh", "mp": 2}, "A.9"),
    ({"problem": "pfsp", "compact": "sort"}, "ROADMAP.md C"),
    ({"problem": "pfsp", "lb": "lb2", "lb2_pairblock": 4}, "ROADMAP.md C"),
    ({"problem": "pfsp", "lb": "lb2", "lb2_pairblock": "auto"},
     "ROADMAP.md C"),
])
def test_refused_fields_name_their_queue(bad, queue):
    with pytest.raises(ValueError, match=queue):
        validate_spec(bad, "cpu")


@pytest.mark.parametrize("bad", [
    {"problem": "tsp"},
    {"problem": "nqueens", "tier": "dist"},
    {"problem": "nqueens", "nope": 1},
    {"problem": "nqueens", "N": 2},
    {"problem": "nqueens", "N": 33},
    {"problem": "nqueens", "K": 0},
    {"problem": "nqueens", "K": "fast"},
    {"problem": "pfsp", "lb2_variant": "lageweg"},
    {"problem": "nqueens", "mp": 2},
    {"problem": "nqueens", "M": "big"},
    [1, 2],
])
def test_validate_spec_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        jax_jobs.validate_spec(bad)
    with pytest.raises(ValueError):
        validate_spec(bad, "cpu")


# -- the registry ---------------------------------------------------------------


def test_registry_durability_and_the_jax_record_format(tmp_path):
    spec = validate_spec(dict(NQ10), "cpu")
    jreg = jax_jobs.JobRegistry(str(tmp_path))
    j1 = jreg.create(spec, "cls", {})
    j2 = jreg.create(spec, "cls", {})
    jreg.transition(j1, "done", result={"explored_tree": 35538})
    jreg.transition(j2, "running")
    reg = JobRegistry(str(tmp_path))
    assert reg.load() == 2
    assert reg.get(j1.id).result == {"explored_tree": 35538}
    assert reg.get(j2.id).state == "requeued"
    j3 = reg.create(spec, "cls", {})
    assert j3.id > j2.id
    reg.transition(j3, "queued")
    back = jax_jobs.JobRegistry(str(tmp_path))
    assert back.load() == 3
    assert back.get(j3.id).record() == reg.get(j3.id).record() | {
        "state": "requeued"}


# -- the daemon, end to end ------------------------------------------------------


def test_submit_stream_result_equal_the_jax_cli(daemon, capsys):
    from tpu_tree_search import cli as jax_cli
    from tpu_tree_search_torch.obs.live import iter_sse

    assert jax_cli.main(["nqueens", "--N", "10", "--M", "256", "--K", "4",
                         "--tier", "device", "--json"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    base = daemon.url
    code, sub = _post(base, "/submit", NQ10)
    assert code == 201 and sub["warm"] is False
    frames, final = [], None
    with urllib.request.urlopen(base + f"/job/{sub['id']}/stream",
                                timeout=120) as resp:
        for event, payload in iter_sse(resp):
            if event == "done":
                final = payload
                break
            if event != "incumbent":
                frames.append(payload)
    assert final is not None and final["state"] == "done"
    assert frames and frames[-1]["tier"] == "resident"
    assert (final["result"]["explored_tree"], final["result"]["explored_sol"]) \
        == (want["explored_tree"], want["explored_sol"])
    code, res = _get(base, f"/job/{sub['id']}/result")
    assert code == 200 and res["result"] == final["result"]
    assert final["new_programs"] == 1
    # A second same-class job: warm, no new program, no new graph.
    code, sub2 = _post(base, "/submit", NQ10)
    assert sub2["warm"] is True and sub2["class"] == sub["class"]
    rec2 = _wait_final(base, sub2["id"])
    assert rec2["new_programs"] == 0 and rec2["new_step_compiles"] == 0
    assert _counts(rec2) == _counts(final)
    code, classes = _get(base, "/classes")
    (entry,) = classes
    assert entry["programs"] == 1 and entry["jobs_admitted"] == 2
    assert entry["pool_bytes"] > 0
    code, err = _post(base, "/submit", {"problem": "nqueens",
                                        "tier": "mesh", "mp": 2})
    assert code == 400 and "A.9" in err["error"]
    from tpu_tree_search_torch.serve.metrics import parse_text

    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        m = parse_text(r.read().decode())
    assert m["tts_serve_admissions_total"][(("outcome", "invalid"),)] == 1


def test_preempt_resume_and_budget_bit_identical(tmp_path, monkeypatch):
    """quantum=0 with a waiter cuts at every dispatch boundary: the resumed
    job lands its uninterrupted counts, and a max_steps job spends its
    budget across slices exactly, to the counts of a solo run cut at the
    same step (one dispatch in flight: a cut under speculation also keeps
    the in-flight dispatches' work)."""
    monkeypatch.setenv("TTS_PIPELINE", "1")
    ref = _reference(11)
    d = _daemon(tmp_path, quantum_s=0.0)
    try:
        base = d.url
        _, p1 = _post(base, "/submit", {**NQ10, "N": 11})
        _, p2 = _post(base, "/submit", {**NQ10, "N": 12, "K": 2,
                                        "max_steps": 6})
        _, p3 = _post(base, "/submit", NQ10)
        rec1 = _wait_final(base, p1["id"])
        rec2 = _wait_final(base, p2["id"])
        rec3 = _wait_final(base, p3["id"])
        assert rec1["state"] == rec2["state"] == rec3["state"] == "done"
        assert rec1["preemptions"] > 0
        assert rec1["slices"] == rec1["preemptions"] + 1
        assert _counts(rec1) == (ref.explored_tree, ref.explored_sol, ref.best)
        assert rec1["checkpoint"] is None
        assert rec2["preemptions"] > 0 and rec2["steps"] == 6
        assert rec2["result"]["complete"] is False
        solo = resident_search(NQueensProblem(12), m=25, M=256, K=2,
                               max_steps=6, device="cpu")
        assert (rec2["result"]["explored_tree"],
                rec2["result"]["explored_sol"]) == (solo.explored_tree,
                                                    solo.explored_sol)
    finally:
        _close(d)


def test_cancel_running_and_drain_to_requeued(tmp_path):
    d = _daemon(tmp_path)
    try:
        base = d.url
        long = {"problem": "nqueens", "N": 13, "M": 256, "K": 1,
                "max_steps": 1 << 20}
        _, s1 = _post(base, "/submit", long)
        _wait_state(base, s1["id"], "running")
        assert _post(base, f"/job/{s1['id']}/cancel", {})[0] == 200
        rec = _wait_final(base, s1["id"])
        assert rec["state"] == "cancelled" and rec["steps"] < (1 << 20)
        assert _post(base, f"/job/{s1['id']}/cancel", {})[0] == 409
        _, s2 = _post(base, "/submit", long)
        _wait_state(base, s2["id"], "running")
        time.sleep(0.3)
        d.scheduler.drain(timeout_s=60.0)
        job = d.registry.get(s2["id"])
        assert job.state == "requeued" and job.steps < (1 << 20)
        assert job.checkpoint and os.path.exists(job.checkpoint)
        assert _post(base, "/submit", NQ10)[0] == 503
    finally:
        d.close()


def test_batch_bit_identical_with_a_zero_program_splice(tmp_path):
    """Three same-class jobs through a 2-slot batch: each lands the solo
    counts; the first pays the batched program, every spliced job builds
    nothing."""
    ref = _reference(10)
    d = ServeDaemon(port=0, state_dir=str(tmp_path / "state"), device="cpu",
                    batch_slots=2)
    d._http_thread = threading.Thread(
        target=d._httpd.serve_forever, kwargs={"poll_interval": 0.2},
        daemon=True)
    d._http_thread.start()
    try:
        base = d.url
        ids = [_post(base, "/submit", NQ10)[1]["id"] for _ in range(3)]
        d.scheduler.start()
        recs = [_wait_final(base, jid) for jid in ids]
        for rec in recs:
            assert rec["state"] == "done", rec.get("error")
            assert _counts(rec) == (ref.explored_tree, ref.explored_sol,
                                    ref.best)
        assert recs[0]["new_programs"] == 1
        assert [r["new_programs"] for r in recs[1:]] == [0, 0]
        assert [r["new_step_compiles"] for r in recs] == [0, 0, 0]
        from tpu_tree_search_torch.serve.metrics import parse_text

        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            m = parse_text(r.read().decode())
        assert m["tts_serve_batch_slots"][()] == 2.0
        assert sum(m["tts_serve_slots_spliced_total"].values()) == 3
        code, classes = _get(base, "/classes")
        assert classes[0]["batch_slots"] == 2
    finally:
        _close(d)


# -- warmup ---------------------------------------------------------------------


def test_warmup_selection_leaves_out_the_knobs_the_port_lacks():
    names = {c.name for c in warmup.CONFIGS}
    assert not any(k in c.env for c in warmup.CONFIGS
                   for k in ("TTS_PALLAS", "TTS_LB2_PAIRBLOCK", "TTS_COMPACT"))
    assert "ta014-lb1" in names and "ta014-lb1-jnp" not in names
    serveable = warmup.select_configs("serve")
    assert serveable and all(c.servable for c in serveable)
    for cfg in serveable:
        validate_spec(cfg.spec(), "cuda")
    assert [c.name for c in warmup.select_configs("ta014-lb1,nqueens-15")] \
        == ["ta014-lb1", "nqueens-15"]
    with pytest.raises(ValueError):
        warmup.select_configs("no-such-config")
    assert warmup.warmup_main("no-such-config") == 2


def test_warmup_hit_miss_on_the_build_directory(tmp_path, monkeypatch,
                                                 capsys):
    """The first run of a config builds the native runtime into an empty
    build directory (a miss); the second builds nothing (a hit)."""
    monkeypatch.setenv("TTS_BUILD_DIR", str(tmp_path / "build"))
    from tpu_tree_search_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    cfg = [warmup.WarmConfig("tiny", "tiny nqueens", ["nqueens", "8", "64"])]
    lines = []
    assert warmup.run_configs(cfg, timeout_s=300, emit=lines.append,
                              device="cpu") == 0
    assert re.search(r"miss\(\+\d+ files\)", lines[0]), lines
    lines2 = []
    assert warmup.run_configs(cfg, timeout_s=300, emit=lines2.append,
                              device="cpu") == 0
    assert "[hit]" in lines2[0], lines2


# -- the CLI ----------------------------------------------------------------------


def test_cli_submit_watch_and_top(daemon, capsys):
    port = str(daemon.port)
    rc = cli.main(["submit", "--port", port, "--wait", "--json", "--",
                   "nqueens", "--N", "10", "--M", "256", "--K", "4"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rec["state"] == "done"
    assert rec["spec"]["tier"] == "device"
    assert rec["result"]["explored_tree"] == 35538
    assert cli.main(["watch", "--job", rec["id"], "--port", port,
                     "--json"]) == 0
    watched = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert watched["id"] == rec["id"] and watched["state"] == "done"
    assert cli.main(["top", "--port", port, "--once"]) == 0
    assert rec["id"] in capsys.readouterr().out
    # A refused spec: exit 2 with the daemon's error.
    assert cli.main(["submit", "--port", port, "--", "nqueens",
                     "--tier", "seq"]) == 2
    assert "Error: submit rejected (400)" in capsys.readouterr().err


def test_cli_refusals_and_unreachable(capsys):
    for argv in (["top", "--router", "http://127.0.0.1:1", "--once"],
                 ["submit", "--router", "http://127.0.0.1:1", "--",
                  "nqueens"]):
        assert cli.main(argv) == 2
        err = capsys.readouterr().err
        assert err.startswith("Error: no fleet router at http://127.0.0.1:1")
    assert cli.main(["watch", "--job", "job-000001", "--port", "1"]) == 2
    with pytest.raises(SystemExit):
        cli.main(["submit"])
    with pytest.raises(SystemExit):
        cli.main(["submit", "--", "watch"])
