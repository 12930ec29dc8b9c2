"""Command line of the port: the single-device subset of `tpu_tree_search/cli.py`.

    python -m tpu_tree_search_torch pfsp --inst 14 --lb lb1 --ub 1 --tier device [--json]
    python -m tpu_tree_search_torch pfsp --inst 14 --lb lb2 [--lb2-variant nabeshima] [--unfused]
    python -m tpu_tree_search_torch nqueens --N 15 --tier device [--json]
    python -m tpu_tree_search_torch pfsp --inst 14 --lb lb1 --mt 64   # streamed cycle
    python -m tpu_tree_search_torch pfsp --inst 14 --tier seq          # host, native runtime
    python -m tpu_tree_search_torch nqueens --N 14 --engine offload    # per-chunk round trip
    python -m tpu_tree_search_torch pfsp --inst 14 --K 4 --max-steps 2 --checkpoint f.npz
    python -m tpu_tree_search_torch pfsp --inst 14 --resume f.npz

The banner and the report follow the reference's format (`print_settings` /
`print_results`). Tiers: ``--tier device`` (the default: the port's entry
points run on the card unless asked otherwise) with ``--engine resident``
(the device-resident engine, the default) or ``--engine offload`` (the
reference's per-chunk host round trip, `engine/device.py`), and ``--tier
seq`` (the host's sequential search, `engine/sequential.py`). Dispatch is
pipelined (``TTS_PIPELINE``) and ``--K auto`` adapts K
(`engine/pipeline.py`); under lb2, ``--unfused`` runs the staged evaluator;
``--mt`` (the JAX ``TTS_MEGAKERNEL_MT``) streams the fused cycle in tiles of
that many parents. ``--checkpoint``, ``--checkpoint-interval``, ``--resume``
and ``--max-steps`` cut and resume the resident engine
(`engine/checkpoint.py`). The other tiers exit 2 naming the ROADMAP.md queue
that ports them, and so does any shape or option the port refuses, or a
flag the chosen tier or engine would ignore (``Error: ...`` on stderr, no
traceback).
"""

from __future__ import annotations

import argparse
import json
import sys

TIERS = ("seq", "device", "mesh", "multi", "dist", "dist_mesh")
ENGINES = ("resident", "offload")


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
                   help="device (the default; the card unless --device cpu) "
                        "or seq (the host's sequential search); the other "
                        "tiers are not ported yet")
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
                   help="cuda (default; raises when absent) or cpu")
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
                   help="resident engine: save the search frontier to this "
                        "file periodically and at a --max-steps cut")
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
    return p


def check_supported(args) -> None:
    """Refuse a tier the port lacks, and a flag the chosen tier or engine
    would ignore (`tpu_tree_search/cli.py` `_dispatch_tier`, `validate_args`)."""
    if args.tier not in ("seq", "device"):
        raise NotImplementedError(
            f"tier {args.tier!r} is not ported yet (ROADMAP.md queue A, "
            "A.9: the multi-device and multi-host tiers); the port runs "
            "--tier device and --tier seq")
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
    if args.max_steps is not None and args.max_steps < 1:
        raise ValueError(f"--max-steps must be >= 1, got {args.max_steps}")
    if args.checkpoint_interval < 0:
        raise ValueError("--checkpoint-interval must be >= 0, got "
                         f"{args.checkpoint_interval}")


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
    d = res.diagnostics
    if res.engine == "offload":
        staged = ", staged lb2" if res.staged else ""
        print(f"Offload: M={res.M}, chunks={d.kernel_launches}{staged}")
        print(f"Device diagnostics: kernel_launch={d.kernel_launches} "
              f"host_to_device={d.host_to_device} "
              f"device_to_host={d.device_to_host} "
              f"double_buffered={d.double_buffered}")
    elif res.engine == "resident":
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
    print("=================================================\n")


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
    d = res.diagnostics
    if res.engine == "offload":
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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        K, device, problem, M = prepare(args)
    except (NotImplementedError, ValueError, TypeError) as e:
        # A shape or option the port refuses: exit 2, as an unported tier.
        print(f"Error: {e}", file=sys.stderr)
        return 2
    print_settings(args, device)
    if args.tier == "seq":
        from .engine.sequential import sequential_search

        res = sequential_search(problem)
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
    print_results(problem, res, checkpoint=args.checkpoint)
    if args.json:
        print(json.dumps(result_record(args, res, device)))
    return 0


def prepare(args):
    """``(K, device, problem, M)`` of the search of ``args``, after every
    check of what the port refuses, before the search starts: the tier and
    the flags it would ignore, ``--K``, ``TTS_K``, ``TTS_PIPELINE`` and
    ``TTS_COSTMODEL`` (resident engine), the problem's shape, the tile
    width, under lb2 on the card the lb2 kernels' table routes, and the
    header of a ``--resume`` file. The sequential tier has no K, device or
    M (None). Raises ``NotImplementedError``, ``ValueError`` or
    ``TypeError`` on a refusal; errors inside the search are not refusals
    and propagate from ``main``."""
    check_supported(args)
    problem = make_problem(args)
    if args.tier == "seq":
        return None, None, problem, None
    from .engine.pipeline import (RESIDENT_TARGET, resolve_k,
                                  resolve_pipeline_depth, resolve_target_band)
    from .ops.backend import resolve_device
    from .ops.lb2_kernel import johnson_operands
    from .ops.tiled import check_tile

    resident = args.engine == "resident"
    K = None
    if resident:
        K = parse_k(args.K)
        resolve_k(K, default_max=4096)
        resolve_pipeline_depth()
        resolve_target_band("resident", RESIDENT_TARGET, problem,
                            topology="device-D1")
    device = resolve_device(args.device)
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

        try:
            ckpt.load(args.resume, problem)
        except (OSError, KeyError, zipfile.BadZipFile) as e:
            raise ValueError(f"cannot read checkpoint {args.resume!r}: "
                             f"{e}") from None
    return K, device, problem, M


if __name__ == "__main__":
    sys.exit(main())
