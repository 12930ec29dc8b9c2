"""Package-level guarantees of the PyTorch/CUDA port.

  * No module of ``tpu_tree_search_torch/`` and not ``chip_smoke.py`` imports
    JAX or anything of the JAX package (an AST scan of every import).
  * Entry points run on ``cuda`` unless asked for the CPU: on a machine
    without CUDA they raise instead of falling back.
  * The CLI refuses what is not ported (``--mp``, a search on several
    cards) with the ROADMAP queue, ``check`` (no counterpart), ``--guard``
    off the resident loops and the multi-host flags where the JAX CLI
    does, runs
    N-Queens and PFSP lb1/lb1_d/lb2 on the device tier (resident and
    offload engines) and the sequential tier, and ``chip_smoke.py`` fails
    (prints no result) without a card.
"""

from __future__ import annotations

import ast
import json
import shutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_tree_search_torch import cli
from tpu_tree_search_torch.engine.resident import resident_search
from tpu_tree_search_torch.ops import _build
from tpu_tree_search_torch.ops.backend import resolve_device
from tpu_tree_search_torch.problems import PFSPProblem
from tpu_tree_search_torch.problems.pfsp import taillard

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "tpu_tree_search_torch"
FORBIDDEN = {"jax", "jaxlib", "tpu_tree_search"}


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_files()
    assert len(files) > 15 and (ROOT / "chip_smoke.py").exists()
    # The telemetry package and the optima table keep their own copies of
    # the JAX package's modules (none of them imports JAX).
    obs_modules = {"__init__", "costmodel", "counters", "events", "export",
                   "flightrec", "live", "phases", "quality", "report",
                   "roofline"}
    assert {p.stem for p in files if p.parent == PKG / "obs"} == obs_modules
    assert PKG / "problems" / "taillard_optima.py" in files
    # The batched engine and the serve daemon (and its clients) are scanned
    # with the rest.
    assert PKG / "engine" / "batched.py" in files
    assert {p.stem for p in files if p.parent == PKG / "serve"} == {
        "__init__", "batch", "client", "jobs", "metrics", "pool",
        "scheduler", "server", "warmup"}
    # The multi-device and multi-host tiers, their own copy of the
    # termination scan, and the mesh chunk evaluator.
    assert {p.stem for p in files if p.parent == PKG / "parallel"} == {
        "__init__", "dist", "dist_mesh", "mesh", "multidevice",
        "resident_mesh", "topology"}
    assert {p.stem for p in files if p.parent == PKG / "utils"} == {
        "__init__", "termination"}
    # The fleet router and the analysis package (the lint's lock and
    # capture rules, the steady-state guard, the program contracts and
    # their auditor).
    assert {p.stem for p in files if p.parent == PKG / "fleet"} == {
        "__init__", "health", "loadgen", "placement", "router"}
    assert {p.stem for p in files if p.parent == PKG / "analysis"} == {
        "__init__", "__main__", "baseline", "contracts", "core", "guard",
        "lockorder", "locks", "program_audit", "torch_rules"}
    bad = {
        str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & FORBIDDEN)
        for f in files
    }
    assert {f: r for f, r in bad.items() if r} == {}


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _no_cuda()
    prob = PFSPProblem(lb="lb1", ub=0,
                       p_times=taillard.reduced_instance(14, jobs=6, machines=3))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resident_search(prob, m=4, M=64, K=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        prob.device_tables("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["pfsp", "--inst", "14"])
    assert resolve_device("cpu") == torch.device("cpu")


GUARD = "--guard asserts steady-state purity of the resident device loops"


@pytest.mark.parametrize("argv,names", [
    # The --mp refusals are the JAX CLI's (`tpu_tree_search/cli.py:520-527`).
    (["pfsp", "--tier", "multi", "--mp", "2"],
     "--mp only applies to --tier mesh/dist_mesh"),
    (["nqueens", "--tier", "mesh", "--mp", "2"],
     "--mp shards the lb2 Johnson pair loop (pfsp --lb lb2 only)"),
    (["nqueens", "--tier", "multi", "--K", "4"], None),
    (["nqueens", "--tier", "multi", "--perc", "0"], None),
    (["nqueens", "--tier", "mesh", "--engine", "offload"], None),
    (["nqueens", "--tier", "device", "--D", "2"], None),
    (["nqueens", "--tier", "multi", "--hosts", "2"], "--hosts/--distributed"),
    (["nqueens", "--tier", "dist_mesh", "--no-steal"], "--no-steal"),
    (["nqueens", "--tier", "dist", "--distributed", "--hosts", "2"],
     "mutually exclusive"),
    (["nqueens", "--tier", "dist", "--coordinator", "127.0.0.1:1"],
     "require --distributed"),
    (["nqueens", "--tier", "dist_mesh", "--steal-interval", "0.1"],
     "--steal-interval"),
    (["nqueens", "--tier", "seq", "--compact", "sort"],
     "--compact only applies to runs with device-side compaction"),
    (["pfsp", "--tier", "multi", "--compact", "dense"],
     "the offload/multi/dist workers prune on host"),
    (["pfsp", "--tier", "multi", "--guard"], GUARD),
    (["nqueens", "--engine", "offload", "--guard"], GUARD),
])
def test_cli_refuses_unported_paths(argv, names, capsys):
    # The refusals the JAX CLI makes. Each is an Error: line and exit 2.
    extra = [] if "--device" in argv or "seq" in argv else [
        "--device", "cpu"]
    assert cli.main(argv + extra) == 2
    err = capsys.readouterr().err
    assert err.startswith("Error:")
    if names is not None:
        assert names in err


@pytest.mark.parametrize("argv", [
    ["pfsp", "--inst", "14", "--tier", "dist_mesh", "--lb", "lb2", "--mp",
     "2", "--device", "cpu", "--M", "64", "--K", "1", "--max-steps", "1"],
    ["nqueens", "--tier", "mesh", "--device", "cuda:0,cuda:1"],
])
def test_cli_runs_the_pair_axis_and_device_lists(argv, tmp_path, capsys):
    # Once refused as unported (queue A's last item): a dist_mesh run at
    # mp = 2 on the CPU (cut after one dispatch), and a mesh on two cards,
    # which only the want of a card refuses here. No message of the port
    # names that queue item or says "not ported" any more.
    if "cuda:0,cuda:1" in argv and torch.cuda.device_count() < 2:
        with pytest.raises((RuntimeError, ValueError), match="CUDA|no card"):
            cli.main(argv)
    else:
        ckpt = str(tmp_path / "cut.npz")
        assert cli.main(argv + ["--checkpoint", ckpt, "--json"]) == 0
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec["mp"] == 2 and rec["complete"] is False
    root = Path(cli.__file__).parent
    said = [f"{p.relative_to(root)}:{i}" for p in sorted(root.rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if re.search(r"A\.9|A9_|not ported", line)]
    assert said == []


def test_cli_report_and_record_on_cpu(capsys):
    prob = PFSPProblem(lb="lb1", ub=0,
                       p_times=taillard.reduced_instance(14, jobs=8, machines=4))
    res = resident_search(prob, m=4, M=64, K=8, device="cpu")
    args = cli.build_parser().parse_args(["pfsp", "--device", "cpu"])
    cli.print_results(prob, res)
    out = capsys.readouterr().out
    assert f"Size of the explored tree: {res.explored_tree}" in out
    assert "Device cycle: fused CUDA cycle" in out
    rec = cli.result_record(args, res, torch.device("cpu"))
    assert (rec["explored_tree"], rec["explored_sol"], rec["optimum"]) == (
        res.explored_tree, res.explored_sol, res.best)
    assert sum(p.tree for p in res.phases) == res.explored_tree


def test_kernel_sources_export_the_bound_entries():
    names = {p.stem for p in _build.sources()}
    assert names == {"lb1_bounds", "cycle_lb1", "nqueens_labels",
                     "cycle_nqueens", "lb1_d_bounds", "lb2_bounds",
                     "lb2_self_bounds", "cycle_lb2", "tiled_lb1",
                     "tiled_nqueens", "tiled_lb2", "dispatch_graph",
                     "mesh_balance", "pair_exchange"}
    text = {p.stem: p.read_text() for p in _build.sources()}
    # The mesh copies' pair exchange (not a TPU kernel: the JAX lax.pmax).
    for entry in ("pair_exchange_enqueue", "pair_exchange_load",
                  "pair_exchange_peers"):
        assert f'extern "C" int {entry}(' in text["pair_exchange"]
    # The graph dispatch's source (not a TPU kernel: the host loop's half).
    for entry in ("dispatch_graph_create", "dispatch_graph_begin_body",
                  "dispatch_graph_end_body", "dispatch_graph_instantiate",
                  "dispatch_graph_launch", "dispatch_graph_destroy",
                  "batch_graph_create", "batch_graph_end_body"):
        assert f'extern "C" int {entry}(' in text["dispatch_graph"]
    # The batched graph's nodes (the OR of the slots' conditions, the mask).
    for kernel in ("batch_init", "batch_cond", "batch_cond_obs"):
        assert f"__global__ void {kernel}(" in text["dispatch_graph"]
    assert "cudaGraphCondTypeWhile" in text["dispatch_graph"]
    for src, entries in [("lb1_bounds", ("lb1_bounds_i8", "lb1_bounds_i32")),
                         ("lb1_d_bounds", ("lb1_d_bounds_i8", "lb1_d_bounds_i32")),
                         ("nqueens_labels", ("nqueens_labels_i8",
                                             "nqueens_labels_i32"))]:
        for entry in entries:
            assert f'extern "C" int {entry}(' in text[src]
    for src, macro, entries in [
            ("cycle_lb1", "TTS_CYCLE_ENTRY", ("cycle_lb1_i8", "cycle_lb1_i32")),
            ("lb2_bounds", "TTS_LB2_ENTRY", ("lb2_bounds_i8", "lb2_bounds_i32")),
            ("lb2_self_bounds", "TTS_LB2_SELF_ENTRY",
             ("lb2_self_bounds_i8", "lb2_self_bounds_i32")),
            ("cycle_lb2", "TTS_CYCLE_LB2_ENTRY", ("cycle_lb2_i8", "cycle_lb2_i32")),
            ("tiled_lb1", "TTS_TILED_LB1_ENTRY", ("tiled_lb1_i8", "tiled_lb1_i32")),
            ("tiled_lb2", "TTS_TILED_LB2_ENTRY", ("tiled_lb2_i8", "tiled_lb2_i32")),
            # The N-Queens cycles: an int8 depth through N = 127, int32 beyond.
            ("cycle_nqueens", "TTS_NQ_CYCLE_ENTRY",
             ("cycle_nqueens", "cycle_nqueens_i32")),
            ("tiled_nqueens", "TTS_NQ_TILED_ENTRY",
             ("tiled_nqueens", "tiled_nqueens_i32"))]:
        for entry in entries:
            assert f"{macro}({entry}," in text[src]
    # The lb2 kernels report their shared memory a block for the wrappers'
    # shape check.
    for src in ("lb2_bounds", "lb2_self_bounds", "cycle_lb2", "tiled_lb2"):
        assert f'extern "C" long long {src}_smem(' in text[src]
    # Each source names the TPU kernel it replaces.
    for src, tpu in [("lb1_bounds", "_lb1_kernel"), ("cycle_lb1", "_mega_lb1_kernel"),
                     ("nqueens_labels", "_nqueens_kernel"),
                     ("cycle_nqueens", "_mega_nqueens_kernel"),
                     ("lb1_d_bounds", "_lb1_d_kernel"),
                     ("lb2_bounds", "_lb2_kernel"),
                     ("lb2_self_bounds", "_lb2_self_kernel"),
                     ("cycle_lb2", "_mega_lb2_kernel"),
                     ("tiled_lb1", "_mega_lb1_tiled_kernel"),
                     ("tiled_nqueens", "_mega_nqueens_tiled_kernel"),
                     ("tiled_lb2", "_mega_lb2_tiled_kernel")]:
        assert f"Replaces the TPU kernel `{tpu}`" in text[src]
    # The eval-only pass runs on kernels 1, 3 and 6, whose sources say so.
    for src, tpu in [("lb1_bounds", "_eval_lb1_kernel"),
                     ("nqueens_labels", "_eval_nqueens_kernel"),
                     ("lb2_bounds", "_eval_lb2_kernel")]:
        assert f"the TPU kernel `{tpu}`" in text[src]
        assert "ops/tiled.streamed_eval_bounds" in text[src]
    for src in ("tiled_lb1", "tiled_nqueens", "tiled_lb2"):
        assert "_eval_" not in text[src]


def test_fused_cycle_sources_mirror_the_python_layout():
    # The fused cycles have no scan launch, and their block and stash
    # layout is the one ops/cycle.py sizes the scratch for.
    from tpu_tree_search_torch.ops import cycle as C

    common = (_build.CSRC / "cycle_common.cuh").read_text()
    assert "#define TTS_CYCLE_PARENTS 32" in common
    assert f"ST_BASE = {C.ST_BASE}," in common
    # The counter block's slots in the state, and the phase clock's block
    # (csrc/phase_clock.cuh), mirror obs/counters.py and obs/phases.py.
    from tpu_tree_search_torch.obs import phases as P

    for name in ("ST_CTR", "ST_CTR_TREE", "ST_CTR_SOL", "ST_LEN"):
        assert f"{name} = {getattr(C, name)}," in common
    clock = (_build.CSRC / "phase_clock.cuh").read_text()
    for slot in P.SLOTS:
        assert f"PH_{slot.upper()} = {P.IDX[slot]}," in clock
    assert f"PH_TPREV = {P.TPREV}," in clock and f"PH_T0 = {P.T0}," in clock
    assert f"PH_LEN = {P.BLOCK_LEN}," in clock
    assert (f"PH_OPEN = {P.OPEN}, PH_CLOSE = {P.CLOSE}, PH_SEED = {P.SEED}"
            in clock)
    assert "return (bytes + 15) / 16 * 16 + 16;" in common
    assert 'extern "C" int tts_cycle_parents_per_block()' in common
    for src in ("cycle_lb1.cu", "cycle_lb2.cu", "cycle_nqueens.cu",
                "cycle_pfsp.cuh", "cycle_common.cuh"):
        assert "cycle_scan" not in (_build.CSRC / src).read_text()
    nq = (_build.CSRC / "nqueens_common.cuh").read_text()
    assert "#define TTS_NQ_PARENTS_PER_BLOCK 32" in nq


def test_chip_ab_reads_a_chip_smoke_run():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_ab", ROOT / "chip_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    out = "\n".join([
        "NVIDIA H100 80GB HBM3, 700.00 W",
        json.dumps({"phase": "kernel4", "M": 50000, "g": 1, "chunk": "full", "ms": 0.02}),
        json.dumps({"phase": "kernel6", "inst": "ta021", "n": 20, "B": 1024,
                    "dtype": "torch.int8", "ms": 0.03}),
        json.dumps({"phase": "kernel8", "inst": "ta014", "n": 20, "dtype": "torch.int8",
                    "M": 1024, "chunk": "full", "incumbent": "inf", "ms": 0.02,
                    "launch_ms": {"lb2_cycle_bounds": 0.013}}),
        json.dumps({"phase": "kernel7", "R": 983040, "n_active": 185,
                    "dtype": "torch.int8", "ms": 0.004}),
        json.dumps({"phase": "search_x", "elapsed_s": 0.5, "phases": [[1, 0, 0.1], [2, 0, 0.3]]}),
        json.dumps({"phase": "profile", "search": "search_x", "device_busy_ms": 3.0,
                    "phase2_ms": 4.0, "busy_share": 0.75, "dispatches": 1,
                    "graph_build_s": 0.004, "cond_ms_per_cycle": 0.0013,
                    "dispatch_device_ms": 3.2, "event_busy_share": 0.8,
                    "trace_complete": False}),
        json.dumps({"phase": "pipeline", "run": "ta014_lb1_Kauto", "dispatches": 6,
                    "K": 64, "graph_build_s": 0.003, "phase2_s": 0.008,
                    "phase2_less_build_s": 0.005, "dispatch_device_ms": 2.4,
                    "profiled_device_ms": 2.1, "busy_share": 0.3}),
        json.dumps({"phase": "graph_dispatch", "search": "ta014_lb1", "dispatch_ms": 0.2,
                    "plain_ms": 40.0, "graph_build_s": 0.004}),
        json.dumps({"kernels": [{"name": "cycle_nqueens", "ms": 0.02}]}),
        json.dumps({"ok": True, "device": {}}),
    ])
    got = ab.summarize(out)
    assert got["card"] == "NVIDIA H100 80GB HBM3, 700.00 W" and got["ok"]
    assert got["kernels"] == {"cycle_nqueens": 0.02}
    k8 = "kernel8/ta014/20/torch.int8/1024/full/inf"
    assert got["cycles"] == {"kernel4/50000/1/full": 0.02,
                             "kernel6/ta021/20/torch.int8/1024": 0.03, k8: 0.02,
                             "kernel7/torch.int8/983040/185": 0.004}
    assert got["launch_ms"] == {k8: {"lb2_cycle_bounds": 0.013}}
    assert got["searches"] == {"search_x": [0.5, 0.3]}
    assert got["profiles"]["search_x"]["busy_share"] == 0.75
    assert got["profiles"]["search_x"]["dispatches"] == 1
    assert got["profiles"]["search_x"]["dispatch_device_ms"] == 3.2
    assert got["profiles"]["search_x"]["trace_complete"] is False
    assert got["pipeline"]["ta014_lb1_Kauto"]["K"] == 64
    assert got["pipeline"]["ta014_lb1_Kauto"]["dispatch_device_ms"] == 2.4
    assert got["graph"] == {"ta014_lb1": {"dispatch_ms": 0.2, "plain_ms": 40.0,
                                          "graph_build_s": 0.004}}


def test_chip_ab_rows_outside_the_parents_spread():
    # --rows: a row is outside when both B times fall past both A times on
    # one side; a row that one checkout lacks is not compared.
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_ab", ROOT / "chip_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    got = ab.outside({"slow": [1.0, 1.2, 1.3, 1.1], "fast": [2.0, 1.0, 1.0, 2.0],
                      "within": [1.0, 1.05, 0.99, 1.1], "mixed": [1.0, 1.2, 0.9, 1.1],
                      "new": [None, 1.0, 1.0, None]})
    assert set(got) == {"slow", "fast"}
    assert abs(got["slow"] - 0.19047619) < 1e-6 and got["fast"] == -0.5


def test_chip_ab_keys_kernel1_and_kernel5_rows_by_instance():
    # A checkout whose kernel 1 and 5 rows name no instance ran them on
    # ta014: their keys match the rows that name it, so an A/B lines them up.
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_ab", ROOT / "chip_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    rows = [{"phase": "kernel1", "B": 1024, "dtype": "torch.int8", "ms": 0.0145},
            {"phase": "kernel5", "inst": "ta014", "B": 1024, "dtype": "torch.int8",
             "ms": 0.005},
            {"phase": "kernel5", "inst": "ta111", "B": 1024, "dtype": "torch.int32",
             "ms": 0.05}]
    got = ab.summarize("\n".join(json.dumps(r) for r in rows))
    assert got["cycles"] == {"kernel1/ta014/torch.int8/1024": 0.0145,
                             "kernel5/ta014/torch.int8/1024": 0.005,
                             "kernel5/ta111/torch.int32/1024": 0.05}


def test_chip_sweep_lb1_steps_apply_to_the_sources(tmp_path):
    # Every design step of kernels 1 and 5 is a substitution whose text the
    # committed sources hold (make_variant raises on a text it cannot find).
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_sweep", ROOT / "chip_sweep.py")
    sw = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sw)
    names = [name for name, _ in sw.LB1_STEPS]
    assert names[0] == "committed" and len(set(names)) == len(names)
    for name, subs in sw.LB1_STEPS:
        sw.make_variant(ROOT, tmp_path / name, subs)
        text = (tmp_path / name / "tpu_tree_search_torch/csrc/lb1_family.cuh").read_text()
        assert (text == (_build.CSRC / "lb1_family.cuh").read_text()) == (not subs)


def test_chip_sweep_tiled_steps_apply_to_the_sources(tmp_path):
    # Every design step of kernels 9a, 9b and 9c is a substitution of the
    # cycles' shared code, and every step of kernel 3 one of its source,
    # that the committed sources hold.
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_sweep", ROOT / "chip_sweep.py")
    sw = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sw)
    names = [name for name, _ in sw.TILED_STEPS]
    assert names[0] == "committed" and len(set(names)) == len(names)
    sources = ("cycle_common.cuh", "nqueens_labels.cu")
    for name, subs in sw.TILED_STEPS:
        assert set(subs) <= set(sources)
        sw.make_variant(ROOT, tmp_path / name, subs)
        for source in sources:
            text = (tmp_path / name / "tpu_tree_search_torch/csrc" / source).read_text()
            assert (text == (_build.CSRC / source).read_text()) == (source not in subs)
    assert any("nqueens_labels.cu" in subs for _, subs in sw.TILED_STEPS)


def test_chip_ab_keys_streamed_rows_by_tile_width():
    # The streamed cycles' rows at two tile widths of one M get two keys.
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_ab", ROOT / "chip_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    rows = [{"phase": "kernel10", "M": 50000, "mt": mt, "g": 1, "chunk": "full",
             "ms": ms} for mt, ms in ((80, 0.02), (8, 0.021))]
    got = ab.summarize("\n".join(json.dumps(r) for r in rows))
    assert got["cycles"] == {"kernel10/50000/80/1/full": 0.02,
                             "kernel10/50000/8/1/full": 0.021}


def test_chip_smoke_lb1_family_rows():
    # The kernel 1 and 5 rows of chip_smoke.py: ta014 first, as earlier runs
    # drew them, then ta021, ta111 (int32), 40 machines and rows that are no
    # permutation (repeated ids, limit1 past both ends).
    import importlib.util

    import numpy as np

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cases = cs.lb1_family_inputs(0)
    keys = [(inst, B, dt) for inst, B, dt, _ in cases]
    assert keys[:4] == [("ta014", B, dt) for B in (1024, 49152)
                        for dt in (torch.int8, torch.int32)]
    assert ("ta111", 1024, torch.int32) in keys and ("40x12", 49152, torch.int8) in keys
    assert {("ta021", 1024, torch.int8), ("ta021", 49152, torch.int8)} <= set(keys)
    want = cs.random_nodes(np.random.default_rng(0), 20, 1024)
    assert all(np.array_equal(a, b) for a, b in zip(cases[0][3], want))
    prmu, limit1 = cases[-1][3]
    assert cases[-1][0] == "ta014-nonperm"
    assert any(len(set(r)) < 20 for r in prmu[:100])
    assert limit1.min() < -1 and limit1.max() > 19


# ta014's 10-job, 5-machine corner under the nabeshima pairs and its optimal
# incumbent: the JAX sequential tier's counts (pinned against it by
# tests/test_torch_resident.py).
NABESHIMA_10x5 = (1294, 0, 609)


def test_chip_sweep_makes_variant_copies(tmp_path):
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_sweep", ROOT / "chip_sweep.py")
    sw = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sw)
    dest = tmp_path / "v"
    sw.make_variant(ROOT, dest, {"lb2_common.cuh": {
        "#define TTS_LB2_LOOP_PARENTS 32": "#define TTS_LB2_LOOP_PARENTS 16"}})
    text = (dest / "tpu_tree_search_torch/csrc/lb2_common.cuh").read_text()
    assert "#define TTS_LB2_LOOP_PARENTS 16" in text
    assert (dest / "chip_smoke.py").is_file() and (dest / "chip_sweep.py").is_file()
    assert not (dest / "tpu_tree_search_torch/_build").exists()
    with pytest.raises(ValueError, match="not found"):
        sw.make_variant(ROOT, dest, {"lb2_common.cuh": {"no such text": ""}})


def test_cli_runs_lb2_on_cpu_and_records_it(monkeypatch, capsys):
    make = cli.make_problem

    def reduced(args):  # the CLI's problem, cut to the 10-job corner
        prob = PFSPProblem(lb=args.lb, ub=0, lb2_variant=args.lb2_variant,
                           p_times=taillard.reduced_instance(14, jobs=10, machines=5))
        prob.initial_ub = NABESHIMA_10x5[2]
        return prob

    monkeypatch.setattr(cli, "make_problem", reduced)
    base = ["pfsp", "--lb", "lb2", "--lb2-variant", "nabeshima", "--M", "64",
            "--device", "cpu", "--json"]
    for extra in ([], ["--unfused"]):
        assert cli.main(base + extra) == 0
        out = capsys.readouterr().out
        assert "Lower bound function: lb2" in out
        assert "lb2 machine-pair subset: nabeshima" in out
        rec = json.loads(out.strip().splitlines()[-1])
        assert (rec["explored_tree"], rec["explored_sol"], rec["optimum"]) == NABESHIMA_10x5
        assert (rec["lb"], rec["lb2_variant"]) == ("lb2", "nabeshima")
        assert (rec["fused"], rec["staged"]) == (not extra, bool(extra))
        assert ("staged lb2" in out) == bool(extra)
    monkeypatch.setattr(cli, "make_problem", make)
    args = cli.build_parser().parse_args(["pfsp", "--lb", "lb2"])
    assert args.lb2_variant == "full"
    assert cli.make_problem(args).lb2_variant == "full"


def test_cli_nqueens_report_and_record_on_cpu(capsys):
    assert cli.main(["nqueens", "--N", "8", "--M", "64", "--K", "16",
                     "--device", "cpu", "--json"]) == 0
    out = capsys.readouterr().out
    assert "Resolution of the 8-Queens instance" in out
    assert "with 1 safety check(s) per evaluation" in out
    assert "Optimal makespan" not in out
    assert "Device cycle: fused CUDA cycle" in out
    rec = json.loads(out.strip().splitlines()[-1])
    assert (rec["explored_tree"], rec["explored_sol"]) == (2056, 92)
    assert (rec["N"], rec["g"], rec["fused"], rec["M"], rec["K"]) == (8, 1, True, 64, 16)
    assert rec["dispatches"] >= 1 and rec["device_cycles"] >= 1
    assert sum(p[0] for p in rec["phases"]) == 2056
    assert cli.main(["nqueens", "--N", "8", "--M", "64", "--unfused",
                     "--device", "cpu", "--json"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rec["explored_tree"], rec["explored_sol"], rec["fused"]) == (2056, 92, False)


def test_lb1_d_reports_the_unfused_cycle(capsys):
    prob = PFSPProblem(lb="lb1_d", ub=0,
                       p_times=taillard.reduced_instance(14, jobs=8, machines=4))
    res = resident_search(prob, m=4, M=64, K=8, device="cpu")  # fused asked
    cli.print_results(prob, res)
    assert "Device cycle: unfused (dense)" in capsys.readouterr().out
    args = cli.build_parser().parse_args(["pfsp", "--lb", "lb1_d"])
    rec = cli.result_record(args, res, torch.device("cpu"))
    assert rec["fused"] is False and rec["lb"] == "lb1_d"


def test_default_chunk_size_per_problem():
    assert cli.default_M("pfsp", "cuda") == 49152
    assert cli.default_M("pfsp", "cpu") == 50000
    assert cli.default_M("nqueens", "cuda") == 50000
    assert cli.default_M("nqueens", "cpu") == 50000
    # The offload engine keeps the reference's 50000 on every device (the
    # JAX `resolve_chunk_size`).
    assert cli.default_M("pfsp", "cuda", "device", "offload") == 50000
    assert cli.default_M("pfsp", "cuda", "seq") == 50000
    args = cli.build_parser().parse_args(["nqueens"])
    assert (args.N, args.g) == (14, 1)  # the JAX CLI's defaults


def test_cli_sequential_tier(capsys):
    assert cli.main(["nqueens", "--N", "8", "--tier", "seq", "--json"]) == 0
    out = capsys.readouterr().out
    assert "Sequential tree search (host CPU)" in out
    assert "Search on device" not in out and "Exploration terminated." in out
    rec = json.loads(out.strip().splitlines()[-1])
    assert (rec["explored_tree"], rec["explored_sol"]) == (2056, 92)
    assert rec["tier"] == "seq" and rec["native"] is True
    assert len(rec["phases"]) == 1 and "device" not in rec
    assert cli.main(["pfsp", "--inst", "14", "--lb", "lb2", "--tier", "seq",
                     "--json"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rec["explored_tree"], rec["explored_sol"], rec["optimum"]) == (
        144639, 0, 1377)


def test_cli_offload_engine(capsys, monkeypatch):
    assert cli.main(["nqueens", "--N", "10", "--engine", "offload", "--device",
                     "cpu", "--M", "1024", "--json"]) == 0
    out = capsys.readouterr().out
    assert "Offload: M=1024, chunks=" in out and "double_buffered=" in out
    rec = json.loads(out.strip().splitlines()[-1])
    assert (rec["explored_tree"], rec["explored_sol"]) == (35538, 724)
    assert rec["engine"] == "offload" and rec["M"] == 1024
    assert rec["chunks"] == rec["host_to_device"] == rec["device_to_host"] > 1
    assert 0 < rec["double_buffered"] < rec["chunks"]
    assert sum(p[0] for p in rec["phases"]) == 35538
    # The Python host path gives the same search.
    monkeypatch.setenv("TTS_NATIVE", "0")
    assert cli.main(["nqueens", "--N", "8", "--engine", "offload", "--device",
                     "cpu", "--M", "64", "--json"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rec["explored_tree"], rec["explored_sol"]) == (2056, 92)
    assert rec["native"] is False


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    _no_cuda()
    runs = [ROOT]
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone / "chip_smoke.py")
    runs.append(alone)
    for cwd in runs:
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_chip_sweep_lb2self_steps_apply_to_the_sources(tmp_path):
    # Every design step of kernel 7, and the opt-in's steps, is a
    # substitution of the committed sources or a source taken whole from
    # the parent checkout; the first kernel 7 step is the kernel before its
    # redesign, from that checkout.
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_sweep", ROOT / "chip_sweep.py")
    sw = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sw)
    parent = tmp_path / "parent"
    (parent / "tpu_tree_search_torch/csrc").mkdir(parents=True)
    for name in ("lb2_self_bounds.cu", "lb2_common.cuh", "tts_common.cuh"):
        (parent / "tpu_tree_search_torch/csrc" / name).write_text(f"// parent {name}\n")
    names = [name for name, _ in sw.LB2SELF_STEPS]
    assert names[:3] == ["parent", "committed", "free_slots"]
    assert len(set(names)) == len(names)
    assert [name for name, _ in sw.OPTIN_STEPS] == ["parent_optin", "committed"]
    for name, subs in sw.LB2SELF_STEPS + sw.OPTIN_STEPS:
        assert set(subs) <= {"lb2_self_bounds.cu", "lb2_common.cuh", "tts_common.cuh"}
        sw.make_variant(ROOT, tmp_path / "v" / name, subs, parent)
        for source in ("lb2_self_bounds.cu", "lb2_common.cuh", "tts_common.cuh"):
            text = (tmp_path / "v" / name / "tpu_tree_search_torch/csrc" / source).read_text()
            if subs.get(source) == sw.PARENT:
                assert text == f"// parent {source}\n"
            else:
                assert (text == (_build.CSRC / source).read_text()) == (source not in subs)
    assert sw.LB2SELF_STEPS[0][1] == {"lb2_self_bounds.cu": sw.PARENT,
                                      "lb2_common.cuh": sw.PARENT}
    with pytest.raises(SystemExit):
        sw.make_variant(ROOT, tmp_path / "none", sw.LB2SELF_STEPS[0][1], tmp_path / "no")


def test_chip_smoke_kernel7_search_rows():
    # Kernel 7's rows at the staged search's launches are copied from a run
    # of the search: each call's count, rows and limit1 as the search
    # hands them over (the kept calls only), and the search's result is
    # unchanged. Here a staged lb2 search on a reduced ta014 on the CPU.
    import importlib.util

    import numpy as np

    from tpu_tree_search_torch.engine.resident import resident_search
    from tpu_tree_search_torch.ops import pfsp_device
    from tpu_tree_search_torch.problems import PFSPProblem
    from tpu_tree_search_torch.problems.pfsp import taillard as T

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.K7_SEARCH_LAUNCHES == {0: 185, 4: 9372, 8: 74171}
    prob = PFSPProblem(lb="lb2", ub=0, p_times=T.reduced_instance(14, jobs=10, machines=5))
    res = []
    calls = cs.capture_self_launches(
        lambda: res.append(resident_search(prob, m=8, M=256, K=64, initial_best=609,
                                           device="cpu", fused=False, staged=True)),
        keep={0, 2})
    assert pfsp_device.lb2_self_bounds.__name__ == "lb2_self_bounds"
    assert (res[0].explored_tree, res[0].explored_sol, res[0].best) == (326, 0, 609)
    assert len(calls) > 2 and [c["index"] for c in calls] == list(range(len(calls)))
    for c in calls:
        assert (c["rows"] is None) == (c["index"] not in (0, 2))
        assert 0 < c["n_active"] <= 256 * 10
    for c in (calls[0], calls[2]):
        rows = c["rows"][:c["n_active"]].numpy()
        lim = c["limit1"][:c["n_active"]].numpy()
        assert c["rows"].shape == (256 * 10, 10)
        assert (np.sort(rows, axis=1) == np.arange(10)).all()
        assert lim.min() >= 0 and lim.max() <= 8
    # The free-job count of the self bound: per row the front, the mask
    # and P * (5r + 4); at most the all-slots count.
    l1 = np.array([-1, 5, 18])
    assert cs.lb2_self_ops(l1, 20, 10, 45) == sum(
        (x + 1) * 20 + 20 + 45 * (5 * (19 - x) + 4) for x in l1)
    assert cs.lb2_self_ops(l1, 20, 10, 45) < cs.lb2_ops(l1, 20, 10, 45, child=False)
