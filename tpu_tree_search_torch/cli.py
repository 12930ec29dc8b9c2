"""Command line of the port: the device-tier subset of `tpu_tree_search/cli.py`.

    python -m tpu_tree_search_torch pfsp --inst 14 --lb lb1 --ub 1 --tier device [--json]
    python -m tpu_tree_search_torch pfsp --inst 14 --lb lb2 [--lb2-variant nabeshima] [--unfused]
    python -m tpu_tree_search_torch nqueens --N 15 --tier device [--json]
    python -m tpu_tree_search_torch pfsp --inst 14 --lb lb1 --mt 64   # streamed cycle

The banner and the report follow the reference's format (`print_settings` /
`print_results`). Dispatch is pipelined (``TTS_PIPELINE``) and ``--K auto``
adapts K (`engine/pipeline.py`). Supported: ``--tier device`` (the device-resident engine)
for N-Queens and for PFSP with ``--lb lb1``, ``lb1_d`` or ``lb2``; under
lb2, ``--unfused`` runs the staged evaluator. ``--mt`` (the JAX
``TTS_MEGAKERNEL_MT``) streams the fused cycle in tiles of that many parents;
a width that is not a multiple of 8 dividing M exits 2. The other tiers exit
2 naming the ROADMAP.md queue that ports them, and so does any shape or
option the port refuses (``Error: ...`` on stderr, no traceback).
"""

from __future__ import annotations

import argparse
import json
import sys

TIERS = ("seq", "device", "mesh", "multi", "dist", "dist_mesh")


def default_M(problem: str, device_type: str) -> int:
    """Default chunk size M: 49152 for PFSP on cuda — the JAX CLI's gpu row
    (`resolve_chunk_size`: the reference's 50000-node GPU chunk rounded down
    to a multiple of 8); everything else (N-Queens on both devices, PFSP on
    the CPU) keeps the reference's 50000."""
    return 49152 if problem == "pfsp" and device_type == "cuda" else 50000


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
    p.add_argument("--tier", default="device", choices=TIERS)
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
    p.add_argument("--json", action="store_true",
                   help="print one JSON result line after the report")
    return p


def check_supported(args) -> None:
    if args.tier != "device":
        raise NotImplementedError(
            f"tier {args.tier!r} is not ported yet (ROADMAP.md queue A, "
            "the tiers); the port runs --tier device")


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
    print("Single-device GPU tree search (PyTorch/CUDA)\n")
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
    print(f"Device: {device}")
    print("=================================================")


def megakernel_tiled(res) -> bool:
    """Whether the fused cycle streamed its chunk in tiles (Mt < M)."""
    return res.megakernel_mt is not None and res.megakernel_mt < res.M


def print_results(problem, res) -> None:
    labels = ("Initial search on CPU", "Search on device", "Final search on CPU")
    for label, ph in zip(labels, res.phases):
        print(f"\n{label} completed")
        print(f"Size of the explored tree: {ph.tree}")
        print(f"Number of explored solutions: {ph.sol}")
        print(f"Elapsed time: {ph.seconds:.6f} [s]")
    print("\nExploration terminated.")
    print("\n=================================================")
    print(f"Size of the explored tree: {res.explored_tree}")
    print(f"Number of explored solutions: {res.explored_sol}")
    if problem.name == "pfsp":
        tag = " (improved)" if res.best < problem.initial_ub else " (not improved)"
        print(f"Optimal makespan: {res.best}{tag}")
    print(f"Elapsed time: {res.elapsed:.6f} [s]")
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
    d = res.diagnostics
    print(f"Device diagnostics: cycles={d.kernel_launches} "
          f"host_to_device={d.host_to_device} device_to_host={d.device_to_host}")
    print("=================================================\n")


def result_record(args, res, device) -> dict:
    rec = {
        "problem": args.problem,
        "tier": args.tier,
        "explored_tree": res.explored_tree,
        "explored_sol": res.explored_sol,
        "elapsed_s": res.elapsed,
        # (tree, sol, seconds) of the host warm-up, the device loop and the
        # host drain.
        "phases": [[ph.tree, ph.sol, ph.seconds] for ph in res.phases],
        "device": str(device),
        "fused": res.fused,
        "M": res.M,
        "K": res.k_resolved,
        "dispatches": res.dispatches,
        "device_cycles": res.diagnostics.kernel_launches,
        "stall_fallbacks": res.stall_fallbacks,
        # The dispatch regime that produced the numbers (JAX `cli.py:976-980`)
        # and the time its CUDA graphs took to build, inside phase 2.
        "pipeline_depth": res.pipeline_depth,
        "graph_build_s": res.graph_build_s,
    }
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
    if args.problem == "pfsp":
        rec.update(inst=args.inst, lb=args.lb, ub=args.ub, optimum=res.best)
        if args.lb == "lb2":
            rec.update(lb2_variant=args.lb2_variant, staged=res.staged)
    else:
        rec.update(N=args.N, g=args.g)
    return rec


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        K, device, problem, M = prepare(args)
    except (NotImplementedError, ValueError, TypeError) as e:
        # A shape or option the port refuses: exit 2, as an unported tier.
        print(f"Error: {e}", file=sys.stderr)
        return 2
    from .engine.resident import resident_search

    print_settings(args, device)
    res = resident_search(problem, m=args.m, M=M, K=K, device=device,
                          fused=not args.unfused, mt=args.mt)
    print_results(problem, res)
    if args.json:
        print(json.dumps(result_record(args, res, device)))
    return 0


def prepare(args):
    """``(K, device, problem, M)`` of the search of ``args``, after every
    check of what the port refuses, before the search starts: the tier,
    ``--K``, ``TTS_K``, ``TTS_PIPELINE`` and ``TTS_COSTMODEL``, the
    problem's shape, the tile width and, under lb2 on the card, the lb2
    kernels' table routes. Raises ``NotImplementedError``, ``ValueError``
    or ``TypeError`` on a refusal; errors inside the search are not
    refusals and propagate from ``main``."""
    check_supported(args)
    from .engine.pipeline import (RESIDENT_TARGET, resolve_k,
                                  resolve_pipeline_depth, resolve_target_band)
    from .ops.backend import resolve_device
    from .ops.lb2_kernel import johnson_operands
    from .ops.tiled import check_tile

    K = parse_k(args.K)
    resolve_k(K, default_max=4096)
    resolve_pipeline_depth()
    device = resolve_device(args.device)
    problem = make_problem(args)
    resolve_target_band("resident", RESIDENT_TARGET, problem,
                        topology="device-D1")
    M = args.M if args.M is not None else default_M(args.problem, device.type)
    # The tile width of the fused cycle; lb1_d has no fused cycle, and
    # there, as under --unfused, --mt is inert.
    fused = not args.unfused and not (args.problem == "pfsp" and args.lb == "lb1_d")
    if fused and args.mt is not None:
        check_tile(M, args.mt)
    if device.type == "cuda" and args.problem == "pfsp" and args.lb == "lb2":
        tables = problem.device_tables(device)
        for source in ("lb2_bounds", "lb2_self_bounds", "cycle_lb2", "tiled_lb2"):
            johnson_operands(source, tables)
    return K, device, problem, M


if __name__ == "__main__":
    sys.exit(main())
