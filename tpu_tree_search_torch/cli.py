"""Command line of the port: the pfsp subset of `tpu_tree_search/cli.py`.

    python -m tpu_tree_search_torch pfsp --inst 14 --lb lb1 --ub 1 --tier device [--json]

The banner and the report follow the reference's format (`print_settings` /
`print_results`). Supported: PFSP, ``--lb lb1``, ``--tier device`` (the
device-resident engine). The other problems, bounds and tiers raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import argparse
import json
import sys

TIERS = ("seq", "device", "mesh", "multi", "dist", "dist_mesh")

#: Default chunk size M per device type: 49152 on cuda is the JAX CLI's gpu
#: row (`resolve_chunk_size`: the reference's 50000-node GPU chunk rounded
#: down to a multiple of 8); the CPU keeps the reference's 50000.
DEFAULT_M = {"cuda": 49152, "cpu": 50000}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_tree_search_torch",
        description="Device-resident PFSP Branch-and-Bound on PyTorch/CUDA",
    )
    p.add_argument("problem", choices=("pfsp", "nqueens"))
    p.add_argument("--inst", type=int, default=14,
                   help="Taillard instance id (1..120)")
    p.add_argument("--lb", default="lb1", choices=("lb1", "lb1_d", "lb2"))
    p.add_argument("--ub", type=int, default=1, choices=(0, 1),
                   help="initial upper bound: 1 = known optimum, 0 = inf")
    p.add_argument("--tier", default="device", choices=TIERS)
    p.add_argument("--m", type=int, default=25,
                   help="minimum pool size for a device cycle (warm-up target)")
    p.add_argument("--M", type=int, default=None,
                   help="maximum parents per device cycle (default: 49152 on "
                        "cuda, 50000 on cpu)")
    p.add_argument("--K", type=int, default=256,
                   help="device cycles per dispatch")
    p.add_argument("--device", default=None,
                   help="cuda (default; raises when absent) or cpu")
    p.add_argument("--unfused", action="store_true",
                   help="run the unfused cycle (bound kernel + torch "
                        "compaction) instead of the fused CUDA cycle")
    p.add_argument("--json", action="store_true",
                   help="print one JSON result line after the report")
    return p


def check_supported(args) -> None:
    if args.problem != "pfsp":
        raise NotImplementedError(
            "N-Queens is not ported yet (ROADMAP.md queue next, item 1)")
    if args.tier != "device":
        raise NotImplementedError(
            f"tier {args.tier!r} is not ported yet (ROADMAP.md queue next, "
            "items 3-4); the port runs --tier device")
    if args.lb != "lb1":
        raise NotImplementedError(
            f"bound {args.lb!r} is not ported yet (ROADMAP.md queue next, "
            "item 4); the port runs --lb lb1")


def print_settings(args, device) -> None:
    from .problems.pfsp import taillard

    print("\n=================================================")
    print("Single-device GPU tree search (PyTorch/CUDA)\n")
    print(
        f"Resolution of PFSP Taillard's instance: ta{args.inst:03d} "
        f"(m = {taillard.nb_machines(args.inst)}, n = {taillard.nb_jobs(args.inst)})"
    )
    print("Initial upper bound: " + ("opt" if args.ub == 1 else "inf"))
    print(f"Lower bound function: {args.lb}")
    print("Branching rule: fwd")
    print(f"Device: {device}")
    print("=================================================")


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
    tag = " (improved)" if res.best < problem.initial_ub else " (not improved)"
    print(f"Optimal makespan: {res.best}{tag}")
    print(f"Elapsed time: {res.elapsed:.6f} [s]")
    cycle = "fused CUDA cycle" if res.fused else f"unfused ({res.compact})"
    print(f"Device cycle: {cycle}, M={res.M}, K={res.k_resolved}, "
          f"dispatches={res.dispatches}, stall fallbacks={res.stall_fallbacks}")
    d = res.diagnostics
    print(f"Device diagnostics: cycles={d.kernel_launches} "
          f"host_to_device={d.host_to_device} device_to_host={d.device_to_host}")
    print("=================================================\n")


def result_record(args, res, device) -> dict:
    return {
        "problem": args.problem,
        "tier": args.tier,
        "inst": args.inst,
        "lb": args.lb,
        "ub": args.ub,
        "explored_tree": res.explored_tree,
        "explored_sol": res.explored_sol,
        "optimum": res.best,
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
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        check_supported(args)
    except NotImplementedError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2
    from .engine.resident import resident_search
    from .ops.backend import resolve_device
    from .problems import PFSPProblem

    device = resolve_device(args.device)
    try:
        problem = PFSPProblem(inst=args.inst, lb=args.lb, ub=args.ub)
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2
    M = args.M if args.M is not None else DEFAULT_M[device.type]
    print_settings(args, device)
    res = resident_search(problem, m=args.m, M=M, K=args.K, device=device,
                          fused=not args.unfused)
    print_results(problem, res)
    if args.json:
        print(json.dumps(result_record(args, res, device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
