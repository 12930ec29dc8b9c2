"""Command line of the port: the single-host subset of `tpu_tree_search/cli.py`.

    python -m tpu_tree_search_torch pfsp --inst 14 --lb lb1 --ub 1 --tier device [--json]
    python -m tpu_tree_search_torch pfsp --inst 14 --lb lb2 [--lb2-variant nabeshima] [--unfused]
    python -m tpu_tree_search_torch nqueens --N 15 --tier device [--json]
    python -m tpu_tree_search_torch pfsp --inst 14 --lb lb1 --mt 64   # streamed cycle
    python -m tpu_tree_search_torch pfsp --inst 14 --tier seq          # host, native runtime
    python -m tpu_tree_search_torch nqueens --N 14 --engine offload    # per-chunk round trip
    python -m tpu_tree_search_torch pfsp --inst 14 --tier multi --D 4  # threaded workers, stealing
    python -m tpu_tree_search_torch nqueens --N 15 --tier mesh --D 4   # D shards, one graph a dispatch
    python -m tpu_tree_search_torch pfsp --inst 14 --tier dist --hosts 2 --D 2      # virtual hosts
    python -m tpu_tree_search_torch nqueens --N 15 --tier dist_mesh --hosts 2 --D 2
    python -m tpu_tree_search_torch pfsp --inst 14 --tier dist --distributed \
        --coordinator 127.0.0.1:29500 --num-hosts 2 --host-id 0   # one process a host
    python -m tpu_tree_search_torch pfsp --inst 14 --K 4 --max-steps 2 --checkpoint f.npz
    python -m tpu_tree_search_torch pfsp --inst 14 --resume f.npz
    python -m tpu_tree_search_torch pfsp --inst 14 --trace t.json [--metrics-file m.jsonl]
    python -m tpu_tree_search_torch report t.json [--json] [--roofline]
    python -m tpu_tree_search_torch profile pfsp --inst 14 [--torch-trace DIR]
    python -m tpu_tree_search_torch nqueens --N 15 --obs-serve 8642   # then: watch --port 8642
    python -m tpu_tree_search_torch serve --batch-slots 4 [--device cpu]   # the daemon
    python -m tpu_tree_search_torch submit --wait -- pfsp --inst 14        # then: watch --job ID
    python -m tpu_tree_search_torch fleet --daemon URL --daemon URL        # the router
    python -m tpu_tree_search_torch submit --router URL --wait -- nqueens --N 12
    python -m tpu_tree_search_torch pfsp --inst 14 --guard                 # steady-state guard
    python -m tpu_tree_search_torch lint [paths] [--rule guarded-by]      # the lock rules

The banner and the report follow the reference's format (`print_settings` /
`print_results`). Tiers: ``--tier device`` (the default: the port's entry
points run on the card unless asked otherwise) with ``--engine resident``
(the device-resident engine, the default) or ``--engine offload`` (the
reference's per-chunk host round trip, `engine/device.py`), and ``--tier
seq`` (the host's sequential search, `engine/sequential.py`), and the
multi-device tiers (`parallel/`): ``--tier multi`` (``--D`` worker threads,
each offloading chunks on its own stream, with work stealing of ``--perc``
of a victim's front) and ``--tier mesh`` (``--D`` pool shards on one card,
one CUDA graph a dispatch with the incumbent fold and the ring diffusion;
M is a shard's, K defaults to 16), and the multi-host tiers: ``--tier
dist`` (each host the multi tier's workers with an inter-host
communicator: incumbent exchange, donations of pool rows, two-level
termination) and ``--tier dist_mesh`` (each host a mesh, exchanging at
dispatch boundaries), as ``--hosts H`` virtual hosts in threads or, with
``--distributed``, as one process a host on a ``TCPStore`` at
``--coordinator`` (else the launcher's ``MASTER_ADDR``/``MASTER_PORT``/
``WORLD_SIZE``/``RANK``); rank 0 prints the banner and the report, every
rank its ``--json`` record. Dispatch is
pipelined (``TTS_PIPELINE``) and ``--K auto`` adapts K
(`engine/pipeline.py`); under lb2, ``--unfused`` runs the staged evaluator;
``--mt`` (the JAX ``TTS_MEGAKERNEL_MT``) streams the fused cycle in tiles of
that many parents. ``--checkpoint``, ``--checkpoint-interval``, ``--resume``
and ``--max-steps`` cut and resume the resident engine
(`engine/checkpoint.py`).

Telemetry (`obs/`, the JAX CLI's flags and knobs): ``--trace`` writes a
Chrome trace of the run's events, ``--metrics-file`` appends its counter
samples as JSON lines, ``--costmodel`` fits the run's link profile into a
``COSTMODEL.json`` (``TTS_COSTMODEL`` then resolves AdaptiveK's band from
it), ``--obs-serve PORT`` serves live snapshots on localhost (each of these
implies ``TTS_OBS=1`` unless ``TTS_OBS`` is set: the counter block rides
the dispatch), ``--phase-profile`` arms the device phase clock
(``TTS_PHASEPROF=1``) and ``--torch-trace DIR`` a steady-state
``torch.profiler`` window (resident engine). Subcommands beside ``pfsp`` and
``nqueens``: ``report FILE... [--json] [--roofline] [--costmodel PATH]``
summarizes traces and metrics files (either package's), ``watch`` follows an
``--obs-serve`` run, ``profile <run command>`` runs with the phase clock
armed. ``TTS_QUALITY=1`` prints the incumbent trajectory.

Serving (`serve/`, the JAX package's daemon and clients): ``serve``
starts the daemon (``--port``, ``--state-dir``, ``--workers``,
``--quantum``, ``--max-queue``, ``--warm``, ``--batch-slots``,
``--ckpt-every``, ``--device``), ``submit [--wait] -- <run command>``
posts a job, ``watch --job ID`` follows one, ``top`` is the operator
console, ``migrate ID --to URL`` moves a job between daemons over its
checkpoint, and ``warmup`` runs the warm matrix with hit/miss on the
build directory. The fleet (`fleet/`, host-only): ``fleet`` starts the
router over serve daemons (``--daemon`` a daemon's URL, repeatable;
``serve --router URL`` registers a daemon itself), ``submit --router`` and
``top --router`` (or ``--fleet``: ``TTS_ROUTER``, else the default router
port) go through it.

The guards (`analysis/`): ``--guard`` arms the steady-state guard of the
resident loops (``TTS_GUARD=1`` for the run: the resident engine, mesh,
dist_mesh), and ``lint`` runs the lock rules (``guarded-by``,
``lock-order``) over the port. ``check`` audits JAX programs and has no
counterpart.

What is not ported exits 2 naming the ROADMAP.md queue that ports it
(A.9's second half, steps 3-4: ``--mp`` and a mesh on more than one card,
``--device`` with a comma), and so does any shape or option the port
refuses, or a flag the chosen tier or engine would ignore (``Error: ...``
on stderr, no traceback).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from contextlib import contextmanager

TIERS = ("seq", "device", "mesh", "multi", "dist", "dist_mesh")
ENGINES = ("resident", "offload")
DIST_TIERS = ("dist", "dist_mesh")
A9_STEPS_3_4 = ("ROADMAP.md queue A, A.9's second half, steps 3-4: the "
                "mesh's --mp pair axis, and mesh shards on more than one card")
#: The JAX CLI's reason for refusing ``--guard`` off the resident loops
#: (`tpu_tree_search/cli.py:451-460`).
GUARD_TIERS = ("--guard asserts steady-state purity of the resident device "
               "loops (--tier device with the resident engine, mesh, "
               "dist_mesh); the offload/multi/dist workers round-trip every "
               "chunk by design")
#: The banners' tier names (`tpu_tree_search/cli.py:738-746`).
TIER_NAMES = {"seq": "Sequential", "device": "Single-device",
              "mesh": "SPMD device-mesh", "multi": "Multi-device",
              "dist": "Distributed multi-device",
              "dist_mesh": "Distributed mesh-resident"}


def default_M(problem: str, device_type: str, tier: str = "device",
              engine: str = "resident") -> int:
    """Default chunk size M: 49152 for PFSP on cuda with the resident
    engine — the JAX CLI's gpu row (`resolve_chunk_size`: the reference's
    50000-node GPU chunk rounded down to a multiple of 8); everything else
    (N-Queens, PFSP on the CPU, the offload engine, whose chunks each pay a
    host round trip) keeps the reference's 50000."""
    resident = tier == "device" and engine == "resident"
    return 49152 if (resident and problem == "pfsp"
                     and device_type == "cuda") else 50000


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_tree_search_torch",
        description="Device-resident tree search (PFSP Branch-and-Bound, "
                    "N-Queens backtracking) on PyTorch/CUDA",
        epilog="other commands: `report FILE... [--json] [--roofline]` "
               "(summarize traces), `profile <run command>` (the run with "
               "the phase clock armed), `watch [--port P] [--job ID]` "
               "(follow an --obs-serve run or a serve job), `serve`, "
               "`submit`, `top`, `migrate`, `warmup` (the serve daemon "
               "and its clients), `fleet` (the router over daemons), "
               "`lint` (the lock rules)",
    )
    p.add_argument("problem", choices=("pfsp", "nqueens"))
    p.add_argument("--N", type=int, default=14,
                   help="N-Queens: number of queens")
    p.add_argument("--g", type=int, default=1,
                   help="N-Queens: safety checks per evaluation")
    p.add_argument("--inst", type=int, default=14,
                   help="PFSP: Taillard instance id (1..120)")
    p.add_argument("--lb", default="lb1", choices=("lb1", "lb1_d", "lb2"),
                   help="PFSP: lower bound")
    p.add_argument("--ub", type=int, default=1, choices=(0, 1),
                   help="PFSP: initial upper bound: 1 = known optimum, 0 = inf")
    p.add_argument("--lb2-variant", default="full",
                   choices=("full", "nabeshima", "lageweg"),
                   help="PFSP lb2: Johnson machine-pair subset (the "
                        "reference's enum lb2_variant): full = all "
                        "m(m-1)/2 pairs; nabeshima = (i, i+1); lageweg = "
                        "(i, m-1)")
    p.add_argument("--tier", default="device", choices=TIERS,
                   help="device (the default; the card unless --device cpu), "
                        "seq (the host's sequential search), multi (--D "
                        "worker threads with work stealing), mesh (--D "
                        "pool shards on one card), dist (hosts of multi "
                        "workers with inter-host stealing) or dist_mesh "
                        "(hosts of meshes exchanging at dispatch "
                        "boundaries)")
    p.add_argument("--engine", default="resident", choices=ENGINES,
                   help="device tier engine: resident = pool in device "
                        "memory, K chunk cycles a dispatch; offload = a "
                        "host round trip a chunk (the reference's structure)")
    p.add_argument("--m", type=int, default=25,
                   help="minimum pool size for a device cycle (warm-up target)")
    p.add_argument("--M", type=int, default=None,
                   help="maximum parents per device cycle (default: 49152 for "
                        "PFSP on cuda, else 50000)")
    p.add_argument("--K", type=str, default=None,
                   help="device cycles per dispatch: a positive integer or "
                        "'auto', which resizes K along a geometric ladder "
                        "toward a target host period (also TTS_K=auto; "
                        "engine/pipeline.py); default 4096, clamped to the "
                        "int32 counters' headroom")
    p.add_argument("--device", default=None,
                   help="cuda (default; raises when absent) or cpu; a comma "
                        "list (a mesh on several cards) is refused (not "
                        "ported yet)")
    p.add_argument("--D", type=int, default=None,
                   help="multi, mesh and dist tiers: worker threads (placed "
                        "round robin on the cards) or pool shards (all on "
                        "one card), a host's under dist/dist_mesh; default: "
                        "the number of cards over the hosts (1 on the CPU)")
    p.add_argument("--mp", type=int, default=1,
                   help="mesh tiers, PFSP lb2: the pair axis; refused (not "
                        "ported yet)")
    p.add_argument("--perc", type=float, default=0.5,
                   help="multi and dist tiers: fraction of a victim's pool "
                        "front taken a steal (0.5 = the steal-half rule)")
    p.add_argument("--hosts", type=int, default=None,
                   help="dist tiers: number of virtual hosts, threads of "
                        "this process (--distributed runs a process a host)")
    p.add_argument("--no-steal", action="store_true",
                   help="dist tier: no inter-host stealing and no incumbent "
                        "exchange (the MPI baseline's join-point-only "
                        "semantics)")
    p.add_argument("--distributed", action="store_true",
                   help="dist tiers: this process is one host of a "
                        "multi-process run on a TCPStore control plane "
                        "(rank 0 hosts it); the coordinator, the host count "
                        "and the rank come from --coordinator/--num-hosts/"
                        "--host-id, else MASTER_ADDR, MASTER_PORT, "
                        "WORLD_SIZE and RANK")
    p.add_argument("--coordinator", type=str, default=None,
                   metavar="HOST:PORT",
                   help="with --distributed: the store's address (rank 0 "
                        "listens there)")
    p.add_argument("--num-hosts", type=int, default=None,
                   help="with --distributed: the number of processes")
    p.add_argument("--host-id", type=int, default=None,
                   help="with --distributed: this process's rank")
    p.add_argument("--steal-interval", type=float, default=None,
                   help="dist tier: the communicator's cadence floor in "
                        "seconds (default 0.02; backs off while every host "
                        "is busy)")
    p.add_argument("--guard", action="store_true",
                   help="resident loops (--tier device with the resident "
                        "engine, mesh, dist_mesh): the steady-state guard "
                        "(TTS_GUARD=1 for the run): after a dispatch "
                        "graph's first dispatch, every dispatch must build "
                        "nothing and, on the card, make no synchronising "
                        "call (else GuardViolation)")
    p.add_argument("--unfused", action="store_true",
                   help="run the unfused cycle (evaluator kernel + torch "
                        "compaction; staged under lb2) instead of the fused "
                        "CUDA cycle")
    p.add_argument("--mt", type=int, default=None,
                   help="tile width of the fused cycle (the JAX "
                        "TTS_MEGAKERNEL_MT): below M the chunk is streamed in "
                        "M/mt tiles; a multiple of 8 that divides M. Inert "
                        "with --unfused and under lb1_d")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="resident engine and the parallel tiers: save the "
                        "search frontier to this file periodically and at a "
                        "--max-steps cut (the dist tiers: one file a host, "
                        "FILE.h<rank>, cut in lockstep)")
    p.add_argument("--checkpoint-interval", type=float, default=60.0,
                   help="seconds between checkpoint snapshots (0: after "
                        "every dispatch)")
    p.add_argument("--resume", type=str, default=None,
                   help="resident engine: resume a search from a "
                        "checkpoint file (either package's)")
    p.add_argument("--max-steps", type=int, default=None,
                   help="resident engine: stop after this many dispatches "
                        "(a checkpoint cut; the result is marked incomplete)")
    p.add_argument("--json", action="store_true",
                   help="print one JSON result line after the report")
    p.add_argument("--trace", type=str, default=None,
                   help="write a Chrome-trace-event JSON of the run's "
                        "telemetry to this file (Perfetto; summarize with "
                        "`report`); implies TTS_OBS=1 unless TTS_OBS is set")
    p.add_argument("--metrics-file", type=str, default=None,
                   help="append one JSON line per telemetry counter sample "
                        "to this file; implies TTS_OBS=1 unless TTS_OBS is "
                        "set")
    p.add_argument("--obs-serve", type=int, default=None, metavar="PORT",
                   help="serve live run snapshots on 127.0.0.1:PORT over "
                        "HTTP/SSE (follow with `watch --port PORT`); implies "
                        "TTS_OBS=1 unless TTS_OBS is set")
    p.add_argument("--costmodel", type=str, default=None, metavar="PATH",
                   help="after the run, fit its per-link latency+bandwidth "
                        "profile from the recorded spans and merge it into "
                        "this COSTMODEL.json; TTS_COSTMODEL=PATH makes later "
                        "runs resolve their K band from it; implies "
                        "TTS_OBS=1 unless TTS_OBS is set")
    p.add_argument("--phase-profile", action="store_true",
                   help="resident engine: arm the device phase clock "
                        "(pop/eval/compact/push/overflow on %%globaltimer, "
                        "obs/phases.py; TTS_PHASEPROF=1) and the counter "
                        "block — separate dispatch graphs, the same counts; "
                        "the decomposition and the roofline print with the "
                        "results. Not for headline measurements")
    p.add_argument("--torch-trace", type=str, default=None, metavar="DIR",
                   help="resident engine: a torch.profiler trace of the "
                        "steady-state dispatch window (after the first "
                        "dispatch) into DIR/torch_trace.json "
                        "(TTS_TORCH_TRACE=DIR)")
    return p


def report_parser() -> argparse.ArgumentParser:
    """``report FILE... [--json] [--roofline] [--costmodel PATH]``."""
    p = argparse.ArgumentParser(
        prog="python -m tpu_tree_search_torch report",
        description="summarize --trace / --metrics-file / flight-recorder "
                    "files (either package's; merged into one report)")
    p.add_argument("trace", nargs="+")
    p.add_argument("--json", action="store_true",
                   help="emit the summary as one JSON object")
    p.add_argument("--roofline", action="store_true",
                   help="require the memory-roofline section (exit 2 when "
                        "the trace was not phase-profiled)")
    p.add_argument("--costmodel", type=str, default=None, metavar="PATH",
                   help="COSTMODEL.json whose measured `hbm` link supplies "
                        "the roofline's peak (else TTS_HBM_GBPS, else the "
                        "nominal table)")
    return p


def watch_parser() -> argparse.ArgumentParser:
    """``watch [--port P] [--host H] [--interval S] [--once] [--json]
    [--job ID]``."""
    p = argparse.ArgumentParser(
        prog="python -m tpu_tree_search_torch watch",
        description="live view of a run started with --obs-serve PORT, or "
                    "with --job of one serve-daemon job")
    p.add_argument("--port", type=int, default=None,
                   help="the --obs-serve port (default 8642), or with --job "
                        "the serve daemon's port (default 8643)")
    p.add_argument("--job", type=str, default=None, metavar="ID",
                   help="follow one serve-daemon job's stream")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--interval", type=float, default=1.0,
                   help="polling fallback interval in seconds")
    p.add_argument("--once", action="store_true",
                   help="print the current snapshot and exit")
    p.add_argument("--json", action="store_true",
                   help="emit raw snapshot JSON lines")
    return p


def serve_parsers() -> dict:
    """The serving subcommands' parsers (`tpu_tree_search/cli.py:279-436`):
    ``serve``, ``fleet``, ``submit``, ``top``, ``migrate``, ``warmup``."""
    from .fleet import DEFAULT_ROUTER_PORT
    from .serve import DEFAULT_PORT

    prog = "python -m tpu_tree_search_torch"
    srv = argparse.ArgumentParser(
        prog=f"{prog} serve",
        description="persistent multi-tenant search daemon: admit jobs over "
                    "a localhost HTTP/JSON API, keep each shape class's "
                    "programs and dispatch graphs between jobs, preempt "
                    "through bit-identical checkpoint cuts")
    srv.add_argument("--port", type=int, default=DEFAULT_PORT,
                     help=f"listen port on 127.0.0.1 (default {DEFAULT_PORT}; "
                          "0 = OS-assigned, printed at startup)")
    srv.add_argument("--host", type=str, default="127.0.0.1")
    srv.add_argument("--state-dir", type=str, default=None,
                     help="durable job records + checkpoints (default "
                          "TTS_SERVE_STATE or "
                          "~/.cache/tpu_tree_search_torch/serve)")
    srv.add_argument("--workers", type=int, default=1,
                     help="concurrent job slices (default 1)")
    srv.add_argument("--quantum", type=float, default=5.0,
                     help="seconds a job runs before it must yield to "
                          "waiting work (checkpoint cut + requeue)")
    srv.add_argument("--max-queue", type=int, default=64,
                     help="admission control: reject submits (503) beyond "
                          "this queue depth")
    srv.add_argument("--warm", type=str, nargs="?", const="serve",
                     default=None, metavar="NAMES",
                     help="pre-warm the program pool at startup: 'serve', "
                          "'all', or a comma-separated config list "
                          "(`warmup` names)")
    srv.add_argument("--batch-slots", type=int, default=None, metavar="B",
                     help="instance-axis batch slots a batched program: "
                          "with >= 2 same-class jobs queued, one dispatch "
                          "(one CUDA graph) advances up to B of them "
                          "(default TTS_BATCH_SLOTS or 1)")
    srv.add_argument("--ckpt-every", type=float, default=None, metavar="S",
                     help="cut a recoverable checkpoint every S seconds "
                          "(default TTS_CKPT_EVERY or off); the fleet "
                          "router pulls these to survive a killed daemon")
    srv.add_argument("--device", default=None,
                     help="cuda (default; raises when absent) or cpu")
    srv.add_argument("--router", type=str, default=None, metavar="URL",
                     help="self-register with a `fleet` router at startup "
                          "(default TTS_ROUTER; failure is non-fatal)")
    flt = argparse.ArgumentParser(
        prog=f"{prog} fleet",
        description="class-aware router over serve daemons: one URL places "
                    "each job where its shape class is already warm, "
                    "proxies the job's lifecycle, and recovers in-flight "
                    "jobs off dead or draining daemons by checkpoint "
                    "resubmission (host-only: no torch)")
    flt.add_argument("--port", type=int, default=DEFAULT_ROUTER_PORT,
                     help=f"router port on 127.0.0.1 (default "
                          f"{DEFAULT_ROUTER_PORT}; 0 = OS-assigned, printed "
                          "at startup)")
    flt.add_argument("--host", type=str, default="127.0.0.1")
    flt.add_argument("--state-dir", type=str, default=None,
                     help="durable fleet job map + pulled checkpoints "
                          "(default TTS_FLEET_STATE or "
                          "~/.cache/tpu_tree_search_torch/fleet)")
    flt.add_argument("--daemon", action="append", default=None,
                     metavar="URL", dest="daemons",
                     help="register a serve daemon (repeatable; daemons can "
                          "also self-register with `serve --router` or POST "
                          "/register)")
    flt.add_argument("--scrape-interval", type=float, default=1.0,
                     help="seconds between the keeper's scrapes of each "
                          "daemon's /healthz, /classes, /metrics, /jobs")
    flt.add_argument("--health-misses", type=int, default=3,
                     help="consecutive failed probes before a daemon is "
                          "declared dead and its jobs recovered (default 3)")
    flt.add_argument("--pull-interval", type=float, default=2.0,
                     help="seconds between checkpoint pulls of in-flight "
                          "jobs (the SIGKILL recovery's fuel; default 2)")
    flt.add_argument("--no-rebalance", action="store_true",
                     help="disable hot->idle migration of long-runners")
    flt.add_argument("--rebalance-depth", type=int, default=2,
                     help="queue depth on the hot daemon before a rebalance "
                          "move is considered (default 2)")
    smt = argparse.ArgumentParser(
        prog=f"{prog} submit",
        description="submit a run to a serve daemon: `submit [--wait] -- "
                    "pfsp --inst 14` (the run args are a normal run "
                    "command; --wait streams to completion)")
    smt.add_argument("--port", type=int, default=DEFAULT_PORT)
    smt.add_argument("--host", type=str, default="127.0.0.1")
    smt.add_argument("--router", type=str, default=None, metavar="URL",
                     help="submit through a `fleet` router instead of one "
                          "daemon (default TTS_ROUTER): the job lands on the "
                          "daemon whose shape class is already warm")
    smt.add_argument("--wait", action="store_true",
                     help="follow the job's stream and print the final "
                          "result (exit 1 unless it completes)")
    smt.add_argument("--json", action="store_true",
                     help="emit the submit response (or with --wait the "
                          "final job record) as one JSON line")
    smt.add_argument("rest", nargs=argparse.REMAINDER,
                     help="a full run command (problem + flags)")
    top = argparse.ArgumentParser(
        prog=f"{prog} top",
        description="live per-job / per-class table for a serve daemon, or "
                    "with --router the fleet's")
    top.add_argument("--port", type=int, default=DEFAULT_PORT)
    top.add_argument("--host", type=str, default="127.0.0.1")
    top.add_argument("--router", type=str, default=None, metavar="URL",
                     help="aggregate a whole fleet instead of one daemon "
                          "(default TTS_ROUTER): per-daemon rows + fleet "
                          "totals from the router's /fleet endpoint")
    top.add_argument("--fleet", action="store_true",
                     help="the fleet's view at TTS_ROUTER, else at the "
                          f"default router port ({DEFAULT_ROUTER_PORT})")
    top.add_argument("--interval", type=float, default=2.0)
    top.add_argument("--once", action="store_true",
                     help="print one frame and exit")
    top.add_argument("--json", action="store_true")
    mig = argparse.ArgumentParser(
        prog=f"{prog} migrate",
        description="move a job between serve daemons over its portable "
                    "checkpoint (either package's daemons)")
    mig.add_argument("job", type=str, help="job id on the source daemon")
    mig.add_argument("--to", type=str, required=True, metavar="URL")
    mig.add_argument("--port", type=int, default=DEFAULT_PORT)
    mig.add_argument("--host", type=str, default="127.0.0.1")
    mig.add_argument("--json", action="store_true")
    wrm = argparse.ArgumentParser(
        prog=f"{prog} warmup",
        description="run the warm matrix, a subprocess a config, with "
                    "per-config hit/miss on the build directory")
    wrm.add_argument("--configs", type=str, default=None, metavar="NAMES",
                     help="'all' (default), 'serve', or a comma-separated "
                          "config name list")
    wrm.add_argument("--timeout", type=float, default=None,
                     help="per-config subprocess timeout in seconds "
                          "(default TTS_WARM_TIMEOUT or 420)")
    wrm.add_argument("--device", default="cuda",
                     help="cuda (default) or cpu")
    return {"serve": srv, "fleet": flt, "submit": smt, "top": top,
            "migrate": mig, "warmup": wrm}


def serve_main(argv: list[str]) -> int:
    """The serving subcommands (``argv[0]`` names one) and the fleet's."""
    cmd, rest = argv[0], argv[1:]
    args = serve_parsers()[cmd].parse_args(rest)
    router = getattr(args, "router", None) or os.environ.get("TTS_ROUTER")
    if cmd == "serve":
        from .serve.server import serve_main as daemon_main

        try:
            return daemon_main(port=args.port, host=args.host,
                               state_dir=args.state_dir, workers=args.workers,
                               quantum_s=args.quantum,
                               max_queue=args.max_queue, warm=args.warm,
                               batch_slots=args.batch_slots,
                               ckpt_every_s=args.ckpt_every,
                               device=args.device, router=router)
        except (RuntimeError, ValueError) as e:
            print(f"Error: {e}", file=sys.stderr)
            return 2
    if cmd == "fleet":
        # Host-only: no torch anywhere in fleet/.
        from .fleet.router import router_main

        return router_main(port=args.port, host=args.host,
                           state_dir=args.state_dir, daemons=args.daemons,
                           scrape_interval_s=args.scrape_interval,
                           max_misses=args.health_misses,
                           pull_interval_s=args.pull_interval,
                           rebalance=not args.no_rebalance,
                           rebalance_min_depth=args.rebalance_depth)
    if cmd == "submit":
        rest = [a for a in args.rest if a != "--"]
        parser = build_parser()
        if not rest or rest[0] not in ("pfsp", "nqueens"):
            parser.error("submit wraps a search run, e.g. `submit -- pfsp "
                         "--inst 14`")
        run_args = parser.parse_args(rest)
        try:
            check_supported(run_args)
            parse_k(run_args.K)
        except (NotImplementedError, ValueError) as e:
            print(f"Error: {e}", file=sys.stderr)
            return 2
        from .serve.client import spec_from_args, submit_main

        return submit_main(spec_from_args(run_args), port=args.port,
                           host=args.host, wait=args.wait, as_json=args.json,
                           router=router)
    if cmd == "top":
        if args.fleet and not router:
            from .fleet import DEFAULT_ROUTER_PORT

            router = f"http://127.0.0.1:{DEFAULT_ROUTER_PORT}"
        if router:
            from .serve.client import fleet_top_main

            return fleet_top_main(router, interval=args.interval,
                                  once=args.once, as_json=args.json)
        from .serve.client import top_main

        return top_main(port=args.port, host=args.host,
                        interval=args.interval, once=args.once,
                        as_json=args.json)
    if cmd == "migrate":
        from .serve.client import migrate_main

        return migrate_main(args.job, args.to, port=args.port,
                            host=args.host, as_json=args.json)
    from .serve.warmup import warmup_main

    return warmup_main(args.configs, timeout_s=args.timeout,
                       device=args.device)


def check_supported(args) -> None:
    """Refuse what the port lacks, and a flag the chosen tier or engine would
    ignore (`tpu_tree_search/cli.py` `_dispatch_tier`, `validate_args`)."""
    if args.guard and not (args.tier in ("mesh", "dist_mesh") or (
            args.tier == "device" and args.engine == "resident")):
        raise ValueError(GUARD_TIERS)
    if args.device is not None and "," in args.device:
        raise NotImplementedError(
            f"--device {args.device}: one search on several cards is not "
            f"ported yet ({A9_STEPS_3_4})")
    if args.mp != 1:
        if args.mp < 1:
            raise ValueError("--mp must be >= 1")
        raise NotImplementedError(f"--mp is not ported yet ({A9_STEPS_3_4})")
    if args.D is not None:
        if args.tier not in ("multi", "mesh") + DIST_TIERS:
            raise ValueError("--D applies to the multi, mesh and dist tiers")
        if args.D < 1:
            raise ValueError(f"--D must be >= 1, got {args.D}")
    if args.perc != 0.5 and args.tier not in ("multi", "dist"):
        raise ValueError("--perc only applies to the work-stealing tiers "
                         "(multi, dist)")
    if not 0.0 < args.perc <= 1.0:
        raise ValueError("--perc must be in (0, 1]: the fraction of the "
                         "victim's front taken per steal")
    check_dist(args)
    if args.tier in ("multi", "mesh") + DIST_TIERS:
        check_parallel(args)
        check_limits(args)
        return
    resident = args.tier == "device" and args.engine == "resident"
    if not resident and (args.phase_profile or args.torch_trace is not None):
        raise ValueError("--phase-profile/--torch-trace apply to the "
                         "resident engine's dispatches")
    resident_flags = [name for name, value in (
        ("--checkpoint", args.checkpoint), ("--resume", args.resume),
        ("--max-steps", args.max_steps), ("--K", args.K)) if value is not None]
    cycle_flags = [name for name, value in (("--mt", args.mt is not None),
                                            ("--unfused", args.unfused)) if value]
    if args.tier == "seq":
        if resident_flags:
            raise ValueError("--checkpoint/--resume/--max-steps/--K need a "
                             "device tier")
        stray = cycle_flags + [name for name, value in (
            ("--engine", args.engine != "resident"),
            ("--device", args.device is not None)) if value]
        if stray:
            raise ValueError(f"{'/'.join(stray)} apply to --tier device; "
                             "the sequential tier runs on the host")
    elif args.engine == "offload":
        if resident_flags:
            raise ValueError("--checkpoint/--resume/--max-steps/--K need the "
                             "resident engine")
        if cycle_flags:
            raise ValueError(f"{'/'.join(cycle_flags)} apply to the resident "
                             "engine's device cycle")
    check_limits(args)


def check_dist(args) -> None:
    """The JAX CLI's checks of the multi-host flags (`tpu_tree_search/
    cli.py:495-519`)."""
    if (args.hosts is not None or args.distributed) and args.tier not in DIST_TIERS:
        raise ValueError("--hosts/--distributed only apply to --tier "
                         "dist/dist_mesh")
    if args.no_steal and args.tier != "dist":
        raise ValueError("--no-steal only applies to --tier dist")
    if args.distributed and args.hosts is not None:
        raise ValueError("--distributed (a process a host) and --hosts "
                         "(virtual hosts) are mutually exclusive")
    if ((args.coordinator is not None or args.num_hosts is not None
         or args.host_id is not None) and not args.distributed):
        raise ValueError("--coordinator/--num-hosts/--host-id require "
                         "--distributed")
    if args.steal_interval is not None:
        if args.tier != "dist":
            raise ValueError("--steal-interval only applies to --tier dist")
        if args.steal_interval <= 0:
            raise ValueError("--steal-interval must be > 0")
    if args.hosts is not None and args.hosts < 1:
        raise ValueError("--hosts must be >= 1")


def check_limits(args) -> None:
    """``--max-steps`` >= 1 and ``--checkpoint-interval`` >= 0."""
    if args.max_steps is not None and args.max_steps < 1:
        raise ValueError(f"--max-steps must be >= 1, got {args.max_steps}")
    if args.checkpoint_interval < 0:
        raise ValueError("--checkpoint-interval must be >= 0, got "
                         f"{args.checkpoint_interval}")


def check_parallel(args) -> None:
    """The refusals of the multi, mesh and dist tiers (`tpu_tree_search/
    cli.py:452-522,668-676`): the mesh tiers are resident-only and take no
    tile width or torch.profiler window; the multi and dist tiers' workers
    offload, so they take no --K, --max-steps, cycle flags or phase
    clock."""
    if args.engine != "resident":
        raise ValueError(
            "--engine offload is not available for this tier (mesh/"
            "dist_mesh are resident-only; use --tier multi for "
            "host-orchestrated offload across devices)"
            if args.tier in ("mesh", "dist_mesh") else
            f"--engine applies to --tier device (the {args.tier} tier's "
            "workers always offload)")
    if args.torch_trace is not None:
        raise ValueError("--torch-trace applies to --tier device's resident "
                         "engine")
    if args.mt is not None:
        raise ValueError(f"--mt applies to --tier device's resident engine; "
                         f"--tier {args.tier} takes no tile width")
    if args.tier in ("multi", "dist"):
        if args.max_steps is not None or args.K is not None:
            raise ValueError("--max-steps/--K need the device, mesh, or "
                             "dist_mesh tier")
        if args.unfused:
            raise ValueError("--unfused applies to the resident device "
                             f"cycles; the {args.tier} tier's workers offload")
        if args.phase_profile:
            raise ValueError(
                "--phase-profile arms the resident loops' device phase clock "
                "(--tier device with the resident engine, mesh, dist_mesh); "
                f"the {args.tier} tier's workers have no device cycle to "
                "decompose")


def parse_k(knob: str | None) -> int | str:
    """``--K``: None (the default, 4096), a positive integer or ``auto``
    (`tpu_tree_search/cli.py:444-450`); ``ValueError`` otherwise."""
    if knob is None:
        return 4096
    if knob == "auto":
        return knob
    try:
        k = int(knob)
    except ValueError:
        raise ValueError(f"--K must be 'auto' or a positive integer, got "
                         f"{knob!r}") from None
    if k < 1:
        raise ValueError(f"--K must be >= 1 (or 'auto'), got {k}")
    return k


def make_problem(args):
    from .problems import NQueensProblem, PFSPProblem

    if args.problem == "nqueens":
        return NQueensProblem(N=args.N, g=args.g)
    return PFSPProblem(inst=args.inst, lb=args.lb, ub=args.ub,
                       lb2_variant=args.lb2_variant)


def print_settings(args, device) -> None:
    print("\n=================================================")
    if args.tier == "seq":
        print("Sequential tree search (host CPU)\n")
    elif args.tier in ("multi", "mesh"):
        print(f"{TIER_NAMES[args.tier]} GPU tree search (PyTorch/CUDA, "
              f"D = {args.D})\n")
    elif args.tier in DIST_TIERS:
        hosts = (f"{args.num_hosts} processes" if args.distributed
                 else f"{args.hosts or 1} virtual host(s)")
        print(f"{TIER_NAMES[args.tier]} GPU tree search (PyTorch/CUDA, "
              f"{hosts} x D = {args.D})\n")
    else:
        engine = "offload" if args.engine == "offload" else "device-resident"
        print(f"Single-device GPU tree search (PyTorch/CUDA, {engine})\n")
    if args.problem == "nqueens":
        print(f"Resolution of the {args.N}-Queens instance")
        print(f"  with {args.g} safety check(s) per evaluation")
    else:
        from .problems.pfsp import taillard

        print(
            f"Resolution of PFSP Taillard's instance: ta{args.inst:03d} "
            f"(m = {taillard.nb_machines(args.inst)}, n = {taillard.nb_jobs(args.inst)})"
        )
        print("Initial upper bound: " + ("opt" if args.ub == 1 else "inf"))
        print(f"Lower bound function: {args.lb}")
        if args.lb == "lb2" and args.lb2_variant != "full":
            print(f"lb2 machine-pair subset: {args.lb2_variant}")
        print("Branching rule: fwd")
    if device is not None:
        print(f"Device: {device}")
    if os.environ.get("TTS_PHASEPROF") == "1":
        print("Phase profiler (TTS_PHASEPROF): armed — separate dispatch "
              "graphs, NOT a headline measurement")
    if args.torch_trace is not None:
        print(f"torch.profiler window (TTS_TORCH_TRACE): {args.torch_trace} "
              "(steady-state dispatches)")
    if args.tier in DIST_TIERS:
        # The raw knobs; the resolved policy prints with the results.
        from .parallel.topology import steal_mode

        pods = os.environ.get("TTS_PODS")
        print(f"Inter-host stealing (TTS_STEAL): {steal_mode()}"
              + (f"; pod map (TTS_PODS): {pods}" if pods else ""))
    print("=================================================")


def megakernel_tiled(res) -> bool:
    """Whether the fused cycle streamed its chunk in tiles (Mt < M)."""
    return res.megakernel_mt is not None and res.megakernel_mt < res.M


def print_results(problem, res, checkpoint: str | None = None) -> None:
    """The report (`tpu_tree_search/cli.py` `print_results`): the phases of
    a device tier (one phase on the sequential tier: none printed), whether
    the run ended or was cut (``checkpoint``: the file a cut wrote), the
    totals and the engine's diagnostics."""
    if len(res.phases) > 1:
        labels = ("Initial search on CPU", "Search on device",
                  "Final search on CPU")
        for label, ph in zip(labels, res.phases):
            print(f"\n{label} completed")
            print(f"Size of the explored tree: {ph.tree}")
            print(f"Number of explored solutions: {ph.sol}")
            print(f"Elapsed time: {ph.seconds:.6f} [s]")
    if res.complete:
        print("\nExploration terminated.")
    elif checkpoint is not None:
        print("\nExploration interrupted (checkpointed; resume with --resume).")
    else:
        print("\nExploration interrupted (no checkpoint written).")
    print("\n=================================================")
    print(f"Size of the explored tree: {res.explored_tree}")
    print(f"Number of explored solutions: {res.explored_sol}")
    if problem.name == "pfsp":
        tag = " (improved)" if res.best < problem.initial_ub else " (not improved)"
        print(f"Optimal makespan: {res.best}{tag}")
    print(f"Elapsed time: {res.elapsed:.6f} [s]")
    if res.per_worker_tree:
        shares = ", ".join(f"{s:.2f}" for s in res.workload_shares())
        print(f"Workload per device (%): [{shares}]")
    if res.steals:
        print(f"Work steals (intra-host): {res.steals}")
    if res.comm:
        c = res.comm
        print(f"Inter-host comm: exchange_rounds={c['rounds']} "
              f"stolen_blocks={c['blocks_received']} "
              f"stolen_nodes={c['nodes_received']}")
    if res.steal_policy:
        # The resolved steal hierarchy: a line a link class.
        sp = res.steal_policy
        print(f"Steal policy: {sp['mode']} pods={sp['pods']}")
        for link, lv in sp.get("levels", {}).items():
            print(f"  {link}: level={lv['level']} every={lv['every']} "
                  f"period={lv['period_s']}s quantum={lv['quantum']} "
                  f"({lv['source']})")
    d = res.diagnostics
    if res.engine in ("offload", "multi", "dist"):
        staged = ", staged lb2" if res.staged else ""
        print(f"Offload: M={res.M}, chunks={d.kernel_launches}{staged}")
        print(f"Device diagnostics: kernel_launch={d.kernel_launches} "
              f"host_to_device={d.host_to_device} "
              f"device_to_host={d.device_to_host} "
              f"double_buffered={d.double_buffered}")
    elif res.engine in ("resident", "mesh", "dist_mesh"):
        cycle = "fused CUDA cycle" if res.fused else f"unfused ({res.compact})"
        if res.megakernel_mt:
            form = "tiled" if megakernel_tiled(res) else "single-tile"
            cycle += f", {form} Mt={res.megakernel_mt}"
        if res.staged:
            cycle += ", staged lb2"
        print(f"Device cycle: {cycle}, M={res.M}, K={res.k_resolved}, "
              f"dispatches={res.dispatches}, stall fallbacks={res.stall_fallbacks}")
        tag = " (auto)" if res.k_auto else ""
        print(f"Dispatch pipeline: depth={res.pipeline_depth}, "
              f"K={res.k_resolved}{tag}")
        print(f"Device diagnostics: cycles={d.kernel_launches} "
              f"host_to_device={d.host_to_device} "
              f"device_to_host={d.device_to_host}")
    if res.guard:
        g = res.guard
        print(f"Steady-state guard: {g['checked_dispatches']} dispatch(es) "
              f"checked after {g['warm_dispatches']} warm; checks: "
              + ", ".join(g["checks"])
              + (f" (not checked: {g['not_checked']})"
                 if g.get("not_checked") else ""))
    print_telemetry(res)
    print("=================================================\n")


def print_telemetry(res) -> None:
    """The telemetry lines of the report (`tpu_tree_search/cli.py:857-895`):
    the counter totals, the phase decomposition and its roofline, and the
    incumbent trajectory with its primal gap and integral."""
    from .obs import phases as obs_phases
    from .obs import quality as obs_quality
    from .obs import roofline as obs_roofline
    from .obs.report import phase_table

    ctr = (res.obs or {}).get("device_counters")
    if ctr:
        print("Device counters: "
              + "  ".join(f"{k}={v}" for k, v in ctr.items()))
    if res.phase_profile:
        for line in phase_table(obs_phases.decomp(res.phase_profile)):
            print(line)
    if res.roofline:
        for line in obs_roofline.table(res.roofline):
            print(line)
    q = res.quality
    if q and q.get("points"):
        opt = q.get("optimum")
        print(f"Quality trajectory ({len(q['points'])} incumbent(s)"
              + (f", optimum {opt}" if opt is not None else "") + "):")
        for p in q["points"]:
            g = obs_quality.primal_gap(p.get("best"), opt)
            print(f"  t={p['t_s']:.3f}s  step={p['step']}  "
                  f"best={p['best']}  nodes={p['nodes']}"
                  + (f"  gap={100.0 * g:.2f}%" if g is not None else ""))
        pi = obs_quality.primal_integral(q["points"], opt,
                                         max(res.elapsed, 1e-9))
        if pi is not None:
            print(f"  primal integral: {pi:.4f}")


def result_record(args, res, device) -> dict:
    from . import native

    rec = {
        "problem": args.problem,
        "tier": args.tier,
        "explored_tree": res.explored_tree,
        "explored_sol": res.explored_sol,
        "elapsed_s": res.elapsed,
        # (tree, sol, seconds) of each phase: the sequential search; or the
        # host warm-up, the device loop and the host drain.
        "phases": [[ph.tree, ph.sol, ph.seconds] for ph in res.phases],
        # Whether the host phases ran on the native runtime (TTS_NATIVE).
        "native": native.enabled(),
    }
    if not res.complete:
        rec["complete"] = False
    if res.obs:
        # The counter and phase totals (TTS_OBS=1, TTS_PHASEPROF=1).
        rec["obs"] = res.obs
    if res.quality and res.quality.get("points"):
        # TTS_QUALITY=1: the incumbent trajectory (obs/quality.py).
        rec["quality"] = res.quality
    if res.roofline is not None:
        # Phase-profiled runs: the memory-roofline audit (obs/roofline.py).
        rec["roofline_mem"] = res.roofline
    if res.guard:
        # --guard: the dispatches the steady-state guard checked.
        rec["guard"] = res.guard
    if args.problem == "pfsp":
        rec.update(inst=args.inst, lb=args.lb, ub=args.ub, optimum=res.best)
        if args.lb == "lb2":
            rec["lb2_variant"] = args.lb2_variant
    else:
        rec.update(N=args.N, g=args.g)
    if args.tier == "seq":
        return rec
    rec.update(device=str(device), engine=res.engine, M=res.M)
    if args.problem == "pfsp" and args.lb == "lb2":
        rec["staged"] = res.staged
    if res.per_worker_tree:
        # The multi and mesh tiers: each worker's or shard's explored nodes
        # and their shares (`SearchResult.workload_shares`), and the steals
        # under the JAX record's key (`tpu_tree_search/cli.py:927-928`).
        rec.update(D=len(res.per_worker_tree),
                   per_worker_tree=res.per_worker_tree,
                   workload_shares=res.workload_shares())
        if args.tier in DIST_TIERS:
            # A host's workers or shards, and the hosts.
            rec.update(D=args.D, hosts=len(res.per_worker_tree) // args.D)
    if res.steals:
        rec["steals"] = res.steals
    if res.comm:
        # The multi-host tiers' communicator, summed over the hosts, and
        # the resolved steal policy (the JAX record's keys).
        rec["comm"] = res.comm
    if res.steal_policy:
        rec["steal_policy"] = res.steal_policy
    d = res.diagnostics
    if res.engine in ("offload", "multi", "dist"):
        # The per-chunk round trip's diagnostics: one evaluation, H2D and
        # D2H a chunk, and the dispatches that overlapped an in-flight one.
        rec.update(chunks=d.kernel_launches, host_to_device=d.host_to_device,
                   device_to_host=d.device_to_host,
                   double_buffered=d.double_buffered)
        return rec
    rec.update({
        "fused": res.fused,
        "K": res.k_resolved,
        "steps": res.steps,
        "dispatches": res.dispatches,
        "device_cycles": res.diagnostics.kernel_launches,
        "stall_fallbacks": res.stall_fallbacks,
        # The dispatch regime that produced the numbers (JAX `cli.py:976-980`)
        # and the time its CUDA graphs took to build, inside phase 2.
        "pipeline_depth": res.pipeline_depth,
        "graph_build_s": res.graph_build_s,
    })
    if res.dispatch_device_s is not None:
        # The graph dispatches' device time (CUDA events around each launch).
        rec["dispatch_device_s"] = res.dispatch_device_s
    if res.k_auto:
        rec["k_auto"] = True
    if res.megakernel_mt:
        # Which fused form produced the numbers: the single-tile cycle
        # (Mt == M) or the streamed one (`tpu_tree_search/cli.py:1004-1006`).
        rec.update(megakernel_mt=res.megakernel_mt,
                   megakernel_tiled=megakernel_tiled(res))
    return rec


@contextmanager
def pinned_env(pins: dict):
    """Set ``pins`` in the environment for the block, then restore what was
    there (a second ``main`` in one process does not inherit them)."""
    prev = {k: os.environ.get(k) for k in pins}
    os.environ.update(pins)
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_pins(args) -> dict:
    """The knobs the run's flags set for it (`tpu_tree_search/
    cli.py:619-636`): ``TTS_GUARD=1`` for ``--guard``, ``TTS_PHASEPROF``,
    ``TTS_TORCH_TRACE`` and, for ``--trace``/``--metrics-file``/
    ``--obs-serve``/``--costmodel``, ``TTS_OBS=1`` unless ``TTS_OBS`` is
    set (``=host`` keeps the graphs)."""
    pins = {}
    if args.guard:
        pins["TTS_GUARD"] = "1"
    if args.phase_profile:
        pins["TTS_PHASEPROF"] = "1"
    if args.torch_trace is not None:
        pins["TTS_TORCH_TRACE"] = args.torch_trace
    wants = (args.trace is not None or args.metrics_file is not None
             or args.obs_serve is not None or args.costmodel is not None)
    if wants and "TTS_OBS" not in os.environ:
        pins["TTS_OBS"] = "1"
    return pins


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "report":
        # Summarizes files: no search, no torch.
        from .obs.report import report_main

        rargs = report_parser().parse_args(argv[1:])
        return report_main(rargs.trace, as_json=rargs.json,
                           roofline=rargs.roofline,
                           costmodel=rargs.costmodel)
    if argv and argv[0] == "watch":
        wargs = watch_parser().parse_args(argv[1:])
        if wargs.job is not None:
            # A serve daemon's job: a pure HTTP client.
            from .serve import DEFAULT_PORT
            from .serve.client import watch_job_main

            return watch_job_main(wargs.job, port=wargs.port or DEFAULT_PORT,
                                  host=wargs.host, once=wargs.once,
                                  as_json=wargs.json)
        from .obs.live import watch_main

        return watch_main(wargs.port or 8642, host=wargs.host,
                          interval=wargs.interval, once=wargs.once,
                          as_json=wargs.json)
    if argv and argv[0] in ("serve", "submit", "top", "migrate", "warmup",
                            "fleet"):
        return serve_main(argv)
    if argv and argv[0] == "lint":
        # The lock rules: stdlib AST passes, no torch.
        from .analysis import lint_main

        return lint_main(argv[1:], prog="python -m tpu_tree_search_torch lint")
    if argv and argv[0] == "check":
        print("Error: `check` audits the JAX package's compiled programs "
              "(its contracts and program audit) and has no counterpart in "
              "the port; `lint` runs the lock rules and `--guard` the "
              "steady-state guard", file=sys.stderr)
        return 2
    parser = build_parser()
    if argv and argv[0] == "profile":
        # `profile <run command>`: the same run with the phase clock armed.
        if len(argv) < 2 or argv[1] not in ("pfsp", "nqueens"):
            parser.error("profile wraps a search run, e.g. `profile pfsp "
                         "--inst 14`")
        argv = argv[1:] + ["--phase-profile"]
    args = parser.parse_args(argv)
    with pinned_env(run_pins(args)):
        return run(args)


def run(args) -> int:
    """One search of ``args`` with its telemetry: the refusals, the
    banner, the run (with the flight recorder armed and the live monitor
    serving when asked), the report, then the trace, metrics and
    cost-model files; under ``--distributed`` this process is one host of
    the run, on a ``TorchCollectives``."""
    try:
        K, device, problem, M = prepare(args)
    except (NotImplementedError, ValueError, TypeError) as e:
        # A shape or option the port refuses: exit 2, as an unported tier.
        print(f"Error: {e}", file=sys.stderr)
        return 2
    coll = None
    if args.distributed:
        from .parallel.dist import collectives_from_env

        try:
            coll = collectives_from_env(args.coordinator, args.num_hosts,
                                        args.host_id)
        except (ConnectionError, ValueError) as e:
            # No store, no peers: the run never goes on as one host.
            print(f"Error: {e}", file=sys.stderr)
            return 2
    if coll is None:
        return run_search(args, K, device, problem, M, coll)
    try:
        rc = run_search(args, K, device, problem, M, coll)
    except BaseException:
        coll.close(wait=False)  # the peers hear of it by the abort key
        raise
    coll.close()
    return rc


def run_search(args, K, device, problem, M, coll) -> int:
    """The search of ``run``: the banner, the run, the report and the
    telemetry files on rank 0 (every rank with ``coll`` None), the record
    on every rank."""
    from .obs import events as obs_events
    from .obs import flightrec

    primary = coll is None or coll.is_master
    if primary:
        print_settings(args, device)
    if obs_events.enabled():
        # A run-scoped trace: a prior run's events in this process stay out.
        obs_events.reset()
        flightrec.reset()
        flightrec.recorder().install()
    live_server = None
    if args.obs_serve is not None:
        from .obs import live as obs_live

        live_server = obs_live.serve(args.obs_serve)
        print(f"Live monitor: {live_server.url} "
              f"(watch --port {live_server.port})")
    try:
        if args.tier == "seq":
            from .engine.sequential import sequential_search

            res = sequential_search(problem)
        elif args.tier == "multi":
            from .parallel.multidevice import multidevice_search

            res = multidevice_search(
                problem, m=args.m, M=M, D=args.D, device=args.device,
                perc=args.perc, checkpoint_path=args.checkpoint,
                checkpoint_interval_s=args.checkpoint_interval,
                resume_from=args.resume)
        elif args.tier == "dist":
            from .parallel.dist import dist_search

            kw = {} if args.steal_interval is None else {
                "steal_interval_s": args.steal_interval}
            res = dist_search(
                problem, m=args.m, M=M, D=args.D, num_hosts=args.hosts,
                device=args.device, perc=args.perc,
                steal=not args.no_steal, checkpoint_path=args.checkpoint,
                checkpoint_interval_s=args.checkpoint_interval,
                resume_from=args.resume, collectives=coll, **kw)
        elif args.tier == "dist_mesh":
            from .parallel.dist_mesh import dist_mesh_search

            res = dist_mesh_search(
                problem, m=args.m, M=M, K=K, D=args.D, num_hosts=args.hosts,
                device=args.device, fused=not args.unfused,
                max_steps=args.max_steps, checkpoint_path=args.checkpoint,
                checkpoint_interval_s=args.checkpoint_interval,
                resume_from=args.resume, collectives=coll)
        elif args.tier == "mesh":
            from .parallel.resident_mesh import mesh_resident_search

            res = mesh_resident_search(
                problem, m=args.m, M=M, K=K, D=args.D, device=device,
                fused=not args.unfused, max_steps=args.max_steps,
                checkpoint_path=args.checkpoint,
                checkpoint_interval_s=args.checkpoint_interval,
                resume_from=args.resume)
        elif args.engine == "offload":
            from .engine.device import device_search

            res = device_search(problem, m=args.m, M=M, device=device)
        else:
            from .engine.resident import resident_search

            res = resident_search(
                problem, m=args.m, M=M, K=K, device=device,
                fused=not args.unfused, mt=args.mt, max_steps=args.max_steps,
                checkpoint_path=args.checkpoint,
                checkpoint_interval_s=args.checkpoint_interval,
                resume_from=args.resume)
    finally:
        if live_server is not None:
            live_server.close()
    if primary:
        print_results(problem, res, checkpoint=args.checkpoint)
        if args.trace or args.metrics_file or args.costmodel:
            write_telemetry(args, problem, device, obs_events.drain())
    if args.json:
        rec = result_record(args, res, device)
        if coll is not None:
            rec.update(host_id=coll.host_id, num_hosts=coll.num_hosts)
        print(json.dumps(rec), flush=True)
    return 0


def write_telemetry(args, problem, device, evts: list) -> None:
    """The run's ``--trace``, ``--metrics-file`` and ``--costmodel`` files
    from its drained events."""
    from .obs import export as obs_export

    if args.trace:
        n = obs_export.write_chrome_trace(evts, args.trace)
        print(f"Trace written: {args.trace} ({n} events; open in Perfetto "
              "or `report`)")
    if args.metrics_file:
        obs_export.write_metrics_jsonl(evts, args.metrics_file)
    if args.costmodel:
        from .engine.pipeline import profile_backend
        from .obs import costmodel as cm

        # The topology the resident engine passes to resolve_target_band,
        # so a capture matches a later run of the same tier.
        profile = cm.build_profile(evts, profile_backend(device),
                                   "device-D1", cm.shape_class(problem))
        cm.save(args.costmodel, profile)
        key = next(iter(profile))
        links = ", ".join(sorted(profile[key]["links"])) or "none"
        print(f"Cost model written: {args.costmodel} [{key}] (links: "
              f"{links}; arm with TTS_COSTMODEL={args.costmodel})")


def prepare(args):
    """``(K, device, problem, M)`` of the search of ``args``, after every
    check of what the port refuses, before the search starts: the tier and
    the flags it would ignore, ``--K``, ``TTS_K`` and ``TTS_PIPELINE``
    (resident engine), ``TTS_HBM_GBPS``, the problem's shape, the tile
    width, under lb2 on the card the lb2 kernels' table routes, and the
    header of a ``--resume`` file. The sequential tier has no K, device or
    M (None). Raises ``NotImplementedError``, ``ValueError`` or
    ``TypeError`` on a refusal; errors inside the search are not refusals
    and propagate from ``main``."""
    check_supported(args)
    problem = make_problem(args)
    from .obs.roofline import hbm_gbps_override

    hbm_gbps_override()
    if args.tier == "seq":
        return None, None, problem, None
    from .engine.pipeline import resolve_k, resolve_pipeline_depth
    from .ops.backend import resolve_device
    from .ops.lb2_kernel import johnson_operands
    from .ops.tiled import check_tile

    resident = args.engine == "resident" and args.tier not in ("multi", "dist")
    K = None
    if resident:
        # The meshes' default K is 16 (`tpu_tree_search/cli.py:57-58`).
        mesh = args.tier in ("mesh", "dist_mesh")
        K = 16 if mesh and args.K is None else parse_k(args.K)
        resolve_k(K, default_max=16 if mesh else 4096)
        resolve_pipeline_depth()
    device = resolve_device(args.device)
    hosts, ranks = host_ranks(args)
    if args.tier in ("multi", "mesh") + DIST_TIERS and args.D is None:
        from .parallel.multidevice import default_devices

        args.D = max(1, len(default_devices(args.device)) // hosts)
    M = args.M if args.M is not None else default_M(
        args.problem, device.type, args.tier, args.engine)
    # The tile width of the fused cycle; lb1_d has no fused cycle, and
    # there, as under --unfused, --mt is inert.
    fused = not args.unfused and not (args.problem == "pfsp" and args.lb == "lb1_d")
    if fused and args.mt is not None:
        check_tile(M, args.mt)
    if device.type == "cuda" and args.problem == "pfsp" and args.lb == "lb2":
        tables = problem.device_tables(device)
        for source in ("lb2_bounds", "lb2_self_bounds", "cycle_lb2", "tiled_lb2"):
            johnson_operands(source, tables)
    if args.resume is not None:
        import zipfile

        from .engine import checkpoint as ckpt

        paths = ([f"{args.resume}.h{r}" for r in ranks] if hosts > 1
                 else [args.resume])
        for path in paths:
            try:
                ckpt.load(path, problem, expect_hosts=hosts)
            except (OSError, KeyError, zipfile.BadZipFile) as e:
                raise ValueError(f"cannot read checkpoint {path!r}: "
                                 f"{e}") from None
    return K, device, problem, M


def host_ranks(args) -> tuple[int, list[int]]:
    """The host count of the run and the ranks this process runs: H
    virtual hosts (``--hosts``), or under ``--distributed`` this process's
    rank of ``--num-hosts`` (else ``RANK`` of ``WORLD_SIZE``; none known:
    no rank, and the collectives' construction refuses the run)."""
    if args.tier not in DIST_TIERS:
        return 1, [0]
    if not args.distributed:
        H = args.hosts or 1
        return H, list(range(H))
    H = args.num_hosts or int(os.environ.get("WORLD_SIZE") or 1)
    rank = args.host_id
    if rank is None and os.environ.get("RANK"):
        rank = int(os.environ["RANK"])
    return H, [] if rank is None else [rank]


if __name__ == "__main__":
    sys.exit(main())
