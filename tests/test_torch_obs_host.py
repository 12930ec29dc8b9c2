"""The port's host telemetry (`tpu_tree_search_torch/obs/`) against the JAX
package's, on the CPU.

  * traces and metrics files: a port trace read by the JAX ``report``
    gives the port's own summary, and a JAX trace read by the port's gives
    JAX's; the files one package writes load in the other. The roofline
    section differs by design (the port's floors come from the counter
    block, ROADMAP C) and is pinned on its own;
  * ``fit_link``, ``build_profile``, ``lookup``, ``resolve_band``,
    ``primal_gap``, ``primal_integral`` and ``roofline.audit`` on equal
    inputs equal the JAX functions; the optima table is JAX's and agrees
    with the port's ``taillard.py``;
  * ``TTS_COSTMODEL`` resolves AdaptiveK's band as the JAX
    ``resolve_target_band`` does (a missing or corrupt profile: the
    default band);
  * the flight recorder dumps a trace ``load_trace_lenient`` reads, from a
    SIGTERM'd subprocess search; the live monitor serves snapshots that
    ``watch`` renders;
  * the CLI: ``--trace``, ``--metrics-file``, ``--costmodel``,
    ``--obs-serve``, ``--phase-profile``, ``--torch-trace``, and the
    ``report``, ``profile`` and ``watch`` subcommands.

Signal handlers, the excepthook and the flight recorder's state are
restored after each test; the SIGTERM run is a subprocess.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from tpu_tree_search.engine import pipeline as jax_pipeline
from tpu_tree_search.engine.resident import resident_search as jax_resident_search
from tpu_tree_search.obs import costmodel as jax_cm
from tpu_tree_search.obs import export as jax_export
from tpu_tree_search.obs import quality as jax_quality
from tpu_tree_search.obs import report as jax_report
from tpu_tree_search.obs import roofline as jax_roofline
from tpu_tree_search.problems import NQueensProblem as JaxNQueens
from tpu_tree_search.problems import taillard_optima as jax_optima
from tpu_tree_search_torch import cli, obs
from tpu_tree_search_torch.engine import pipeline
from tpu_tree_search_torch.engine.resident import resident_search
from tpu_tree_search_torch.obs import (
    costmodel,
    export,
    flightrec,
    live,
    quality,
    report,
    roofline,
)
from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem
from tpu_tree_search_torch.problems import taillard_optima
from tpu_tree_search_torch.problems.pfsp import taillard

ROOT = Path(__file__).resolve().parent.parent
PTM = taillard.reduced_instance(14, jobs=10, machines=5)


@pytest.fixture(autouse=True)
def _restore_process_hooks(monkeypatch):
    """Each test leaves the knobs, the signal handlers, the excepthook and
    the flight recorder as it found them (the CLI arms the recorder)."""
    for k in ("TTS_OBS", "TTS_PHASEPROF", "TTS_PIPELINE", "TTS_K",
              "TTS_FLIGHTREC", "TTS_QUALITY", "TTS_COSTMODEL",
              "TTS_HBM_GBPS", "TTS_TORCH_TRACE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TTS_WATCHDOG_S", "0")
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGALRM)}
    hook = sys.excepthook
    rec = flightrec.recorder()
    yield
    for s, h in handlers.items():
        signal.signal(s, h)
    sys.excepthook = hook
    rec.reset()
    rec._installed = False
    rec._prev_handlers = {}
    rec._prev_excepthook = None


def _run_events(mode: str = "1", phaseprof: bool = False, jax: bool = False):
    """The events of one N-Queens N=9 resident search under ``capture``."""
    if phaseprof:
        os.environ["TTS_PHASEPROF"] = "1"
    try:
        if jax:
            from tpu_tree_search import obs as jax_obs

            with jax_obs.capture(mode=mode) as cap:
                jax_resident_search(JaxNQueens(9), m=8, M=64, K=4)
        else:
            with obs.capture(mode=mode) as cap:
                resident_search(NQueensProblem(9), m=8, M=64, K=4,
                                device="cpu")
    finally:
        os.environ.pop("TTS_PHASEPROF", None)
    return cap.events


# -- traces read in either package's report -----------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("mode", ["1", "host"])
def test_a_trace_reads_in_either_report(tmp_path, writer, mode):
    evts = _run_events(mode=mode, jax=writer == "jax")
    assert any(e["name"] == "dispatch" for e in evts)
    path = tmp_path / "t.json"
    (export if writer == "port" else jax_export).write_chrome_trace(
        evts, str(path))
    port_evts, warn = export.load_trace_lenient(str(path))
    jax_evts, jwarn = jax_export.load_trace_lenient(str(path))
    assert warn is None and jwarn is None and port_evts == jax_evts
    assert report.summarize(port_evts) == jax_report.summarize(jax_evts)
    # Metrics JSON lines too: one package writes, the other reads.
    mpath = tmp_path / "m.jsonl"
    (jax_export if writer == "port" else export).write_metrics_jsonl(
        evts, str(mpath))
    a, _ = export.load_trace_lenient(str(mpath))
    b, _ = jax_export.load_trace_lenient(str(mpath))
    assert a == b and report.summarize(a) == jax_report.summarize(b)
    assert report.summarize(a)["device_counters"] == (
        report.summarize(port_evts)["device_counters"])


def test_phase_profiled_traces_differ_only_in_the_roofline_floors():
    evts = _run_events(phaseprof=True)
    ours, theirs = report.summarize(evts), jax_report.summarize(evts)
    assert ours["phase_decomp"] == theirs["phase_decomp"]
    assert {k: v for k, v in ours.items() if k != "roofline"} == {
        k: v for k, v in theirs.items() if k != "roofline"}
    # The port's floors are the counter block's rows, never above the JAX
    # whole-tile floors (M rows a cycle, S survivors a push).
    c = ours["device_counters"]
    node = 9 * 1 + 1
    floors = {r["phase"]: r["bytes"] for r in ours["roofline"]["phases"]}
    assert floors["eval"] == c["popped"] * node
    assert floors["push"] == c["pushed"] * node
    assert floors["compact"] == -(-(c["pushed"] + c["leaves"] + c["pruned"])
                                  // 8)
    jfloors = {r["phase"]: r["bytes"] for r in theirs["roofline"]["phases"]}
    assert all(floors[p] <= jfloors[p] for p in ("pop", "eval"))
    # A JAX trace with the clock but no counters has no port floors.
    no_ctr = [e for e in evts if e["name"] != "device_counters"]
    assert report.summarize(no_ctr)["roofline"] is None


# -- the cost model, quality and roofline functions ---------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fit_link_and_profiles_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    samples = [(float(rng.integers(1, 64)),
                float(rng.uniform(100, 5000))) for _ in range(n)]
    assert costmodel.fit_link(samples) == jax_cm.fit_link(samples)
    evts = [{"name": name, "ph": "X", "ts": float(i), "dur": d,
             "args": {"cycles": int(x), "count": int(x), "bytes": int(x),
                      "nodes": int(x), "link": "ici" if i % 2 else "dcn"}}
            for i, (x, d) in enumerate(samples)
            for name in ("dispatch", "chunk", "steal", "donate_send",
                         "exchange")]
    prof = costmodel.build_profile(evts, "gpu", "device-D1", "nqueens_n9")
    assert prof == jax_cm.build_profile(evts, "gpu", "device-D1",
                                        "nqueens_n9")
    entry = next(iter(prof.values()))
    for tier in ("resident", "mesh", "dist_mesh"):
        assert costmodel.resolve_band(entry, tier) == jax_cm.resolve_band(
            entry, tier)
    assert costmodel.exchange_sleep_s(entry) == jax_cm.exchange_sleep_s(entry)
    assert costmodel.steal_quantum(entry, "ici", m=25, bytes_per_node=21,
                                   cap=1 << 16) == jax_cm.steal_quantum(
        entry, "ici", m=25, bytes_per_node=21, cap=1 << 16)
    doc = {**prof, "cpu|x|nqueens_n9": {"backend": "cpu", "shape": "nqueens_n9"}}
    for args in (("gpu", "device-D1", "nqueens_n9"), ("gpu", "other", "x"),
                 ("cpu", "device-D1", "nqueens_n9"), ("tpu", "a", "b")):
        assert costmodel.lookup(doc, *args) == jax_cm.lookup(doc, *args)


def test_shape_classes_equal_jax():
    for prob, jprob in ((NQueensProblem(9), JaxNQueens(9)),):
        assert costmodel.shape_class(prob) == jax_cm.shape_class(jprob)
    assert costmodel.shape_class(PFSPProblem(inst=14, lb="lb2")) == \
        "pfsp_j20x10_lb2"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_primal_gap_and_integral_equal_jax(seed):
    rng = np.random.default_rng(seed)
    opt = int(rng.integers(100, 3000))
    pts = sorted(({"t_s": float(rng.uniform(0, 10)),
                   "best": int(opt + rng.integers(0, 500))}
                  for _ in range(int(rng.integers(1, 8)))),
                 key=lambda p: p["t_s"])
    for p in pts:
        assert quality.primal_gap(p["best"], opt) == jax_quality.primal_gap(
            p["best"], opt)
    for horizon in (5.0, 12.0, 0.0):
        assert quality.primal_integral(pts, opt, horizon) == \
            jax_quality.primal_integral(pts, opt, horizon)
    assert quality.primal_gap(2**31 - 1, opt) is None
    assert quality.primal_integral(pts, None, 5.0) is None


def test_optima_table_is_jax_and_matches_the_port_taillard():
    assert taillard_optima.BEST_KNOWN == jax_optima.BEST_KNOWN
    for inst in range(1, 121):
        assert taillard_optima.known_optimum(inst) == taillard.best_ub(inst)
    assert taillard_optima.optimum_for(PFSPProblem(inst=14)) == 1377
    assert taillard_optima.optimum_for(NQueensProblem(8)) is None


@pytest.mark.parametrize("megakernel", [False, True])
def test_roofline_audit_equals_jax_on_equal_floors(monkeypatch, megakernel):
    ns = {"pop": 1_000_000, "eval": 9_000_000, "compact": 500_000,
          "push": 2_000_000, "overflow": 0}
    kw = dict(M=49152, n=20, S=245760, itemsize=1)
    per_cycle = jax_roofline.phase_byte_floors(megakernel=megakernel, **kw)
    floors = {k: v * 37 for k, v in per_cycle.items()}
    for peak in (3.35e12, 40e9):
        assert roofline.audit(ns, 37, floors, peak_bps=peak,
                              peak_source="x") == jax_roofline.audit(
            ns, 37, megakernel=megakernel, peak_bps=peak, peak_source="x",
            **kw)
    assert roofline.table(jax_roofline.audit(
        ns, 37, peak_bps=3.35e12, **kw)) == jax_roofline.table(
        jax_roofline.audit(ns, 37, peak_bps=3.35e12, **kw))
    # The peak resolves in the JAX order; the nominal gpu row is the H100
    # SXM data sheet's 3.35 TB/s (the JAX row is a 900 GB/s placeholder).
    assert roofline.peak_bytes_per_sec("gpu") == (3.35e12, "nominal:gpu")
    entry = {"backend": "gpu", "links": {"hbm": {"per_sec": 2.9e12}}}
    assert roofline.peak_bytes_per_sec("gpu", entry) == \
        jax_roofline.peak_bytes_per_sec("gpu", entry)
    monkeypatch.setenv("TTS_HBM_GBPS", "3000")
    assert roofline.peak_bytes_per_sec("gpu", entry) == \
        jax_roofline.peak_bytes_per_sec("gpu", entry) == (3e12,
                                                          "env:TTS_HBM_GBPS")


# -- TTS_COSTMODEL sets the band ---------------------------------------------


def _dispatch_events(latency_us: float) -> list:
    return [{"name": "dispatch", "ph": "X", "ts": float(i),
             "dur": latency_us + 10.0 * c, "args": {"cycles": c}}
            for i, c in enumerate((4, 8, 16, 32, 64, 128))]


def test_costmodel_band_parity_with_jax(tmp_path, monkeypatch):
    prob, jprob = NQueensProblem(10), JaxNQueens(10)
    args = ("resident", pipeline.RESIDENT_TARGET)
    # A missing or corrupt profile: the default band, as the JAX
    # costmodel.load returns None.
    for raw in (str(tmp_path / "missing.json"), "junk"):
        if raw == "junk":
            (tmp_path / "junk.json").write_text("not json")
            raw = str(tmp_path / "junk.json")
        monkeypatch.setenv("TTS_COSTMODEL", raw)
        assert pipeline.resolve_target_band(*args, prob, "device-D1",
                                            device="cpu") == \
            jax_pipeline.resolve_target_band(*args, jprob, "device-D1") == \
            (pipeline.RESIDENT_TARGET, None)
    # A matching entry: JAX's band (the CPU's profile key is "cpu").
    path = str(tmp_path / "COSTMODEL.json")
    costmodel.save(path, costmodel.build_profile(
        _dispatch_events(64_000.0), "cpu", "device-D1",
        costmodel.shape_class(prob)))
    monkeypatch.setenv("TTS_COSTMODEL", path)
    band = pipeline.resolve_target_band(*args, prob, "device-D1",
                                        device="cpu")
    assert band == jax_pipeline.resolve_target_band(*args, jprob, "device-D1")
    assert band[1] == "cpu|device-D1|nqueens_n10"
    assert band[0] != pipeline.RESIDENT_TARGET
    # On the card the key is "gpu": this profile has no gpu entry.
    assert pipeline.resolve_target_band(*args, prob, "device-D1",
                                        device="cuda") == (
        pipeline.RESIDENT_TARGET, None)


def test_costmodel_capture_then_armed_run_through_the_cli(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    path = str(tmp_path / "COSTMODEL.json")
    base = ["nqueens", "--N", "9", "--device", "cpu", "--M", "64", "--K",
            "auto", "--json"]
    assert cli.main(base + ["--costmodel", path]) == 0
    out = capsys.readouterr().out
    assert f"Cost model written: {path} [cpu|device-D1|nqueens_n9]" in out
    doc = json.loads(Path(path).read_text())
    assert "dispatch" in doc["cpu|device-D1|nqueens_n9"]["links"]
    monkeypatch.setenv("TTS_COSTMODEL", path)
    trace = str(tmp_path / "t.json")
    assert cli.main(base + ["--trace", trace]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rec["explored_tree"], rec["explored_sol"]) == (8393, 352)
    evts, _ = export.load_trace_lenient(trace)
    cmev = [e for e in evts if e["name"] == "costmodel"]
    assert len(cmev) == 1
    assert cmev[0]["args"]["source"] == "cpu|device-D1|nqueens_n9"


# -- the flight recorder and the live monitor ----------------------------------


def test_sigterm_mid_search_leaves_a_readable_postmortem(tmp_path):
    prefix = str(tmp_path / "killed")
    env = dict(os.environ, TTS_OBS="host", TTS_FLIGHTREC=prefix,
               TTS_WATCHDOG_S="0", PYTHONPATH=str(ROOT))
    # N=13 on the CPU's plain cycles runs long: the kill lands mid-search.
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_tree_search_torch", "nqueens", "--N",
         "13", "--device", "cpu", "--M", "256", "--K", "2"],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        for line in proc.stdout:
            if line.startswith("Device: cpu"):
                break
        time.sleep(3.0)  # into the dispatch loop
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert rc == -signal.SIGTERM  # the honest death status
    evts, warn = export.load_trace_lenient(prefix + ".trace.json")
    assert warn is None and any(e["name"] == "dispatch" for e in evts)
    frd = json.loads(Path(prefix + ".trace.json").read_text())[
        "otherData"]["flightrec"]
    assert frd["reason"] == "SIGTERM" and frd["meta"]["tier"] == "resident"
    last = frd["last_dispatch"]["h0/w0"]
    assert last["seq"] >= 1 and last["tree"] > 0
    # Both packages' report read the corpse.
    assert cli.main(["report", prefix + ".trace.json",
                     prefix + ".metrics.jsonl"]) == 0
    assert jax_report.report_main([prefix + ".trace.json"]) == 0


def test_recorder_ring_and_dump(tmp_path, monkeypatch):
    monkeypatch.setenv("TTS_OBS", "host")
    rec = flightrec.FlightRecorder(ring=3, snapshot_period_us=0.0)
    for i in range(5):
        rec.heartbeat("resident", seq=i + 1, cycles=4, size=10 + i, best=9,
                      tree=100 * (i + 1), sol=1, depth=2, K=16,
                      phases={"eval": 5, "push": 3, "total": 8})
    snaps = rec.snapshots()
    assert len(snaps) == 3 and snaps[-1]["seq"] == 5
    assert snaps[-1]["dominant_phase"] == "eval"
    path = rec.dump("test", prefix=str(tmp_path / "d"))
    evts, warn = export.load_trace_lenient(path)
    assert warn is None
    assert rec.dump("test", prefix=str(tmp_path / "no" / "dir")) is None
    monkeypatch.setenv("TTS_OBS", "0")
    off = flightrec.FlightRecorder()
    off.heartbeat("resident", seq=1)
    assert off.snapshots() == [] and off.state()["last_dispatch"] == {}


def test_heartbeats_ride_the_resident_dispatches(monkeypatch):
    monkeypatch.setenv("TTS_OBS", "host")
    rec = flightrec.recorder()
    rec.reset()
    rec._snap_period_us = 0.0
    try:
        res = resident_search(NQueensProblem(9), m=8, M=64, K=4, device="cpu")
        st = rec.state()
        assert st["last_dispatch"]["h0/w0"]["seq"] == res.dispatches
        assert st["last_dispatch"]["h0/w0"]["tree"] == res.phases[1].tree
        assert rec.latest()["tier"] == "resident"
    finally:
        rec._snap_period_us = flightrec.SNAPSHOT_PERIOD_US


def test_live_monitor_and_watch(monkeypatch, capsys):
    from urllib.request import urlopen

    monkeypatch.setenv("TTS_OBS", "host")
    rec = flightrec.recorder()
    rec.reset()
    rec._snap_period_us = 0.0
    srv = live.serve(0)
    try:
        with urlopen(srv.url + "/snapshot", timeout=5) as r:
            assert json.loads(r.read()) == {}
        for i in range(2):
            rec.heartbeat("resident", seq=i + 1, cycles=4, size=100, best=1377,
                          tree=1000, sol=3, depth=2, K=16)
        with urlopen(srv.url + "/healthz", timeout=5) as r:
            assert json.loads(r.read()) == {"ok": True}
        assert cli.main(["watch", "--port", str(srv.port), "--once"]) == 0
        out = capsys.readouterr().out
        assert "best=1377" in out and "dispatch#2" in out
    finally:
        srv.close()
        rec._snap_period_us = flightrec.SNAPSHOT_PERIOD_US
    assert cli.main(["watch", "--port", str(srv.port), "--once"]) == 2


# -- the CLI -----------------------------------------------------------------


def test_cli_trace_metrics_and_report(tmp_path, capsys):
    trace, metrics = str(tmp_path / "t.json"), str(tmp_path / "m.jsonl")
    assert cli.main(["nqueens", "--N", "9", "--device", "cpu", "--M", "64",
                     "--trace", trace, "--metrics-file", metrics,
                     "--json"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["obs"]["device_counters"]["pushed"] == rec["phases"][1][0]
    evts, _ = export.load_trace_lenient(trace)
    tree = sum(e["args"]["tree"] for e in evts if e["name"] == "explored")
    assert tree == rec["explored_tree"] == 8393
    assert cli.main(["report", trace, "--json"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["device_counters"] == rec["obs"]["device_counters"]
    assert cli.main(["report", metrics]) == 0
    assert "device counters:" in capsys.readouterr().out
    # Not phase-profiled: --roofline refuses; a missing file exits 2.
    assert cli.main(["report", trace, "--roofline"]) == 2
    assert "phase-profiled" in capsys.readouterr().err
    assert cli.main(["report", str(tmp_path / "none.json")]) == 2


def test_cli_profile_subcommand_and_torch_trace(tmp_path, capsys):
    tdir = str(tmp_path / "tt")
    trace = str(tmp_path / "p.json")
    assert cli.main(["profile", "nqueens", "--N", "9", "--device", "cpu",
                     "--M", "64", "--K", "4", "--torch-trace", tdir,
                     "--trace", trace, "--json"]) == 0
    out = capsys.readouterr().out
    assert "Phase profiler (TTS_PHASEPROF): armed" in out
    assert "phase decomposition" in out and "next structural cost" in out
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["roofline_mem"]["phases"][1]["phase"] == "eval"
    assert set(rec["obs"]) == {"device_counters", "device_phases"}
    assert (tmp_path / "tt" / "torch_trace.json").stat().st_size > 0
    assert cli.main(["report", trace, "--roofline"]) == 0
    assert "roofline (peak 40.0 GB/s, nominal:cpu" in capsys.readouterr().out
    assert "TTS_PHASEPROF" not in os.environ  # the pins are restored


@pytest.mark.parametrize("argv", [
    ["--tier", "seq", "--phase-profile"],
    ["--engine", "offload", "--torch-trace", "d"],
    ["--M", "64", "--trace", "t.json", "--mt", "12"],
])
def test_cli_telemetry_refusals_exit_2(argv, capsys):
    assert cli.main(["nqueens", "--N", "8", "--device", "cpu", *argv]) == 2
    cap = capsys.readouterr()
    assert cap.err.startswith("Error: ") and cap.out == ""


def test_cli_obs_serve_and_quality(monkeypatch, capsys):
    monkeypatch.setenv("TTS_QUALITY", "1")
    assert cli.main(["nqueens", "--N", "8", "--device", "cpu", "--M", "64",
                     "--obs-serve", "0", "--json"]) == 0
    out = capsys.readouterr().out
    assert "Live monitor: http://127.0.0.1:" in out
    assert "Quality trajectory (1 incumbent(s)):" in out
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["explored_sol"] == 92 and rec["quality"]["optimum"] is None
    assert len(rec["quality"]["points"]) == 1


def test_quality_tracker_with_a_reference(monkeypatch):
    monkeypatch.setenv("TTS_QUALITY", "1")
    with obs.capture() as cap:
        res = resident_search(PFSPProblem(lb="lb1", ub=0, p_times=PTM),
                              m=8, M=64, K=4, device="cpu")
    pts = res.quality["points"]
    assert pts[0]["best"] >= pts[-1]["best"] == res.best
    assert all(a["best"] > b["best"] for a, b in zip(pts, pts[1:]))
    s = cap.summary()
    assert s["quality"]["jobs"]["-"]["final_best"] <= pts[0]["best"]
    # The tracker resolves Taillard references by instance id.
    rec = quality.tracker(PFSPProblem(inst=14))
    assert rec.optimum == 1377
