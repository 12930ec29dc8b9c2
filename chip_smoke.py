#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu_tree_search_torch``) on one GPU.

    python3 chip_smoke.py            # every phase below
    python3 chip_smoke.py --cycles   # phases 1, 2, 4, 8, 15, 16 and six profiles
    python3 chip_smoke.py --host     # phases 1, 2 and 18c (offload cold and warm, profiled)
    python3 chip_smoke.py --serve    # phases 1, 2, 16d and 18e (the batched graph, serving)
    python3 chip_smoke.py --parallel # phases 1, 2, 18f and 18g (the multi-device and multi-host tiers)
    python3 chip_smoke.py --dist     # phases 1, 2 and 18g (the multi-host tiers)
    python3 chip_smoke.py --fleet    # phases 1, 2, 18h and 18i (the guard, the fleet)
    python3 chip_smoke.py --mp       # phases 1, 2 and 18j-18m (the pair axis, device positions)
    python3 chip_smoke.py --copies   # phases 1, 2, 18j and 18o-18r (the shard copies, --profile)
    python3 chip_smoke.py --cupti [DIR]  # phases 1, 2 and the traced unfused graph's probes
    python3 chip_smoke.py --cupti-modes [DIR]  # the same probe traced under each --compact mode
    python3 chip_smoke.py --check    # phases 1, 2 and 18n (the program contracts, the compaction modes)

Run from the root of a checkout on a machine with one NVIDIA H100 (sm_90a)
and ``nvcc``. Phases, each printed as one JSON line; any failure raises and
ends the script with a non-zero exit before the final line:

  1. device: torch's device name and count, and the card's name and power
     limit as ``nvidia-smi --query-gpu=name,power.limit`` prints them;
  2. build: the native host runtime (``g++``, its seconds), then every
     kernel compiled from ``tpu_tree_search_torch/csrc`` (one ``nvcc`` per
     source, in parallel), with the build seconds;
  3. kernel 1 (lb1 bounds) against its plain PyTorch version on the card:
     ta014 tables, seeded random partial permutations, B = 1024 and 49152,
     int8 and int32 inputs; ta021 (20 machines) at both B, ta111 (500
     jobs, int32) at B = 1024, a seeded 40-machine instance (the one-thread
     prologue) and ta014 rows that are no permutation at B = 49152;
     bit-equal on the open slots (every slot for the last); each row with
     the block shape the kernel chose (``block``: parents, threads and
     blocks, shared memory, whether the grid fit on the card at once, and
     the parent prologue: a wavefront over ``lanes`` lanes a parent, or
     warp 0's fronts);
  4. kernel 2 (the fused search cycle) against its plain version on the
     card: M = 1024 and 49152, finite and INF incumbent, a partial and a
     full chunk; equal state and live pool rows; and on ta051 tables (50
     jobs: two keep-mask words a parent) with an int32 pool;
  5. the full ta014 lb1 ub=1 search through the CLI on the fused path at
     M = 49152 (the default) and M = 1024: tree 2,573,652, sol 2,648,
     makespan 1377; kernel 2's launches counted from 0 around each run;
  6. the same search on the unfused path at M = 1024, counting kernel 1;
  7. ``kernel3`` (N-Queens safety labels) against its plain version:
     N = 15 and 20, B = 1024 and 50000, g = 1 and 4, and B = 50000 at
     N = 14, 32 and 48 (past 32: the per-slot path), g = 1, seeded random
     boards with depth uniform in 0..N
     and a share at N; bit-equal on the whole (B, N) plane; each row with
     the block shape of the launch (``block``: parents a tile, blocks,
     tiles, packed words a parent, blocks an SM); and the g = 256 time at
     least 4x the g = 1 time at B = 50000, N = 15 (a smaller ratio means
     nvcc folded the rounds);
  8. ``kernel4`` (the fused N-Queens cycle) against its plain version at
     N = 15: M = 1024 and 50000, a partial and a full chunk, g = 1 and (at
     M = 50000) g = 4; equal state and live pool rows;
  9. ``kernel5`` (lb1_d bounds) against its plain version on the rows of
     phase 3, each with its block shape;
 10. N-Queens N = 15 through the CLI on the fused path at the default M:
     tree 171,129,071, sol 2,279,184, counting kernel 4;
 11. N-Queens N = 14 through the CLI with ``--unfused``: tree 27,358,552,
     sol 365,596, counting kernel 3;
 12. ta014 lb1_d ub=1 through the CLI at the default M (the unfused cycle):
     tree 2,573,652, sol 2,648, makespan 1377, counting kernel 5;
 13. ``kernel6`` (lb2 child bounds) against its plain version on ta014,
     ta021, ta051 and ta081 tables (the last two need more than 48 KB of
     shared memory a block; ta081 has the 100 jobs the lb2 kernels take at
     most): B = 1024 and 49152 (ta051, ta081: 1024), int8 and int32;
     bit-equal on the open slots; each row with the block shape the kernel
     chose (``block``: parents and threads a block, shared memory, and
     whether the whole grid fit on the card at once);
 14. ``kernel7`` (the staged self lb2) against its plain version on ta014:
     R = 1024*20 and 49152*20 rows, n_active at a quarter and at R, and
     the rows of the staged ta014 lb2 search's launches 1, 5 and 9 (R =
     49152*20; n_active 185, 9,372 and 74,171), copied from a run of that
     search; bit-equal on the active rows, each row with its grid and the
     work split its launch took, and the quarter/full time ratio (the
     blocks past n_active return at once);
 15. ``kernel8`` (the fused lb2 cycle) against its plain version, as kernel 2
     in phase 4, on ta014 and on ta021 tables (20 machines, P = 190 pairs,
     where lb2 costs the most), each row with its bounds launch's block
     shape;
 16. ``kernel9``, ``kernel10`` and ``kernel11`` (the streamed lb1, N-Queens
     and lb2 cycles: rows 9b, 9a and 9c of the PERF.md table) against their
     plain versions, as kernels 2, 4 and 8 at tile widths mt = 16
     (M = 1024) and 64 (M = 49152; N-Queens 80 at M = 50000), 9a and 9c
     also at mt = 8 (the most tiles, four a block of 32 parents), 9c also
     on ta021; equal state, live pool rows and (G, 4) per-tile scalars;
     each row with its device time by launch (``launch_ms``) and its
     launches a cycle (``launches_per_cycle``);
 16b. past the old limits: kernels 6 and 7 on ta101 and ta111 (200 and
     500 jobs, int32 rows, the global table route), kernels 8 and 9c on
     both at M = 256 (``kernel8``, ``kernel11`` rows with ``inst``), and
     kernels 4 and 9a at N = 48 (two keep-mask words a parent), each row
     with its route (``tables``) or ``mask_words``, time, plain time and
     bound;
 16c. ``graph_dispatch``: one graph dispatch of K = 4 cycles (the program's
     CUDA graph, csrc/dispatch_graph.cu) of each fused and streamed cycle
     (kernels 2, 4, 8, 9a, 9b, 9c; ta014 lb1, lb2 with no incumbent at
     M = 49152, N-Queens N = 15 at M = 50000) against the plain dispatch
     loop (the plain cycles and ``cycle_cond_plain``): every state word
     through ``st[ST_RUNS]`` and every live row equal, the body the
     cycle's launches alone (the cycle sets the while node's condition),
     and an N = 10 dispatch that ends before its K = 64 running no extra
     body, with the graph's build seconds; then, on ta014 lb1 and N = 15,
     the same dispatch with telemetry off, with the counter block
     (``TTS_OBS=1``) and with the phase clock (``TTS_PHASEPROF=1``):
     the body's kernels (off: the cycle's launches alone;
     armed: ``dispatch_cond_obs`` in its place; the clock: a
     ``phase_mark`` before and after each launch), and the counter block
     against ``dispatch_cond_obs_plain`` after the same plain cycles,
     slot for slot (``graph_variants``);
 16d. ``batch_graph``: the batched graph's own kernels (``batch_init``,
     ``batch_cond``, ``batch_cond_obs``; csrc/dispatch_graph.cu) at ta014
     lb1, M = 49152, K = 4, B = 4 (two frontiers, an empty slot, a slot
     below m): one batched dispatch, telemetry off and with the counter
     block, against the same batch through the plain versions on the
     card's tensors and against B solo K = 4 graph dispatches; max
     difference 0; the nodes' device time a launch, the dispatch's time
     beside the solo dispatches', and a frozen slot's cost a cycle;
 17. ta014 lb2 ub=1 (tree 144,639, sol 0, makespan 1377) through the CLI on
     the fused path at M = 49152 and M = 1024 (counting kernel 8), with
     ``--unfused`` (the staged evaluator: kernels 1 and 7), and through
     ``resident_search(..., fused=False, staged=False)`` (kernel 6);
 18. the streamed searches through the CLI with ``--mt``: ta014 lb1 and lb2
     at M = 49152, mt = 64, ta014 lb1 at M = 1024, mt = 16 (many small
     cycles) and N-Queens N = 15 at M = 50000, mt = 80, to their goldens,
     counting kernels 9b, 9c and 9a (and none of 2, 8, 4);
 18b. ``pipeline``: ta014 lb1, N-Queens N = 15 and ta014 lb2 (fused) at
     ``TTS_PIPELINE`` 1 and 2 and at ``--K auto``, each to its goldens,
     with its dispatches, K, graph build seconds, phase 2 wall time and
     the dispatches' device time by CUDA events around each graph launch
     (``dispatch_device_ms``, and over phase 2 the busy share), then under
     the profiler (its device time, a lower bound, and the trace check of
     phase 20);
 18d. ``obs`` (telemetry, obs/): the ``%globaltimer`` step; ``phase_mark``
     against its plain arithmetic replayed on the card's own readings;
     ``graph_variants`` of the fused ta014 lb2 and the streamed N = 15
     (``--mt 80``) graphs; then ta014 lb1, N = 15, ta014 lb2 (fused),
     N = 15 ``--mt 80``, N = 14 ``--unfused`` and staged lb2 ``--unfused``
     through the CLI in the turns off, ``TTS_OBS=1``, ``TTS_PHASEPROF=1``,
     off, each to its goldens, with phase 2's wall and event ms; armed,
     the counters equal phase 2's tree and sol, every slot >= 0, on the
     fused cycles ``overflow`` 0, ``push_rows`` = cycles*M*n and one
     ``dispatch_cond_obs`` a cycle; with the clock, the telescoped total
     exact, the decomposition and the roofline table printed and no
     roofline row above 100%; the two kernels' device time under the
     profiler (N = 15 phase-profiled); and a ``--trace`` run of ta014 lb1
     whose ``report`` exits 0 and whose ``explored`` samples sum to its
     counts;
 18e. ``serve``: the port's ``ServeDaemon`` in-process on a free localhost
     port with ``--batch-slots 4``: four ta014 lb1 jobs through one batch
     (kernel 2), two N = 15 jobs (kernel 4) and two ta014 lb2 jobs (kernel
     8), each to its goldens, the counts set to 0 before each batch: each
     cycle kernel's launches equal the jobs' summed device cycles,
     ``batch_init`` and ``batch_cond`` launched, graphs built only on the
     first admission; a solo ta014 lb1 job preempted by a waiter (quantum
     0) and resumed to its goldens; a second job of its class with zero new
     programs and graphs; per job its wall and queue wait; and the four
     lb1 jobs as four solo searches in turn (dispatches, device ms,
     graph build seconds cold and warm);
 18f. the multi-device tiers (``parallel/``): ``mesh_balance``, the mesh's
     balance step (csrc/mesh_balance.cu), against its plain version on
     seeded states, every word and live row (D = 1, 2 and 4, a gift of T
     whose kept rows overlap their destination, no gift), timed at ta014's
     mesh shape (D = 4, C = 2,097,152) with and without a gift of T rows;
     ``mesh_dispatch``, one mesh dispatch (the graph: rounds of
     ``batch_init``, the shards' cycles, the balance) against the plain
     one on the card's tensors at D = 4 for ta014 lb1 and N = 15, max
     difference 0; ``multi_*``, ``--tier multi`` at D = 1 (ta014 lb1), 2
     and 4 (ta014 lb1 and lb2, N = 15) to the goldens, each bound wrapper
     launched once a chunk, with per-worker trees, steals and phase
     seconds; ``mesh_*``, ``--tier mesh`` at D = 2 and 4 on the same runs
     to the goldens, the cycle wrapper launched once a cycle and the
     balance twice a dispatch, with device time (events), dispatches, graph
     build seconds and per-shard trees; and ``mesh_warm``, a second ta014
     lb1 mesh search of one problem object that builds no graph;
 18g. the multi-host tiers (``parallel/dist.py``, ``parallel/dist_mesh.py``):
     ``dist_*``, ``--tier dist --hosts 2 --D 2`` (virtual hosts) on ta014
     lb1 and lb2 ub=1 and N-Queens N = 14 to the goldens and ta014 lb1
     ``--no-steal``, each bound wrapper launched once a chunk;
     ``dist_mesh_*``, ``--tier dist_mesh --hosts 2 --D 2`` on ta014 lb1 and
     lb2 and N = 15, the cycle wrapper once a cycle and the balance twice a
     dispatch; ``dist_mesh_cut_resume``, a lockstep ``--max-steps`` cut of
     ta014 lb1 (one cut tag in both per-host files) resumed to the goldens;
     and ``dist_procs_*``/``dist_mesh_procs_*``, two processes a tier
     (``--distributed`` on a ``TCPStore``) on ta014 lb1, each rank to the
     goldens. Each line: phase 2 seconds, exchange rounds, blocks and nodes
     sent, the mean ms of an exchange allgather round, and (dist_mesh)
     device ms by CUDA events;
 18h. ``guard_*``: the steady-state guard (``--guard``) on ta014 lb1 at
     K = 4, N = 15, ta014 lb2 at K = 4 and the mesh at D = 2 on ta014 lb1,
     each unguarded then guarded to its goldens with more than one checked
     dispatch (phase 2 of both); two tampers that must raise
     ``GuardViolation`` naming the dispatch (a ``.item()`` slipped into
     the enqueue, a graph rebuilt in steady state); and a guarded unfused
     N = 14 search to its goldens (its cycle of fixed shapes is one graph
     launch a dispatch, so the guard checks it);
 18i. ``fleet_*``: two ``ServeDaemon``s on the card behind an in-process
     ``FleetRouter``, under ``TTS_GUARD=1``: ta014 lb1 cold then warm (no
     new program, no new graph), N = 15 cold on the other daemon, ta014
     lb2, each to its goldens; N-Queens N = 17 (K = 256) moved live off a
     draining daemon, then recovered from a pulled cut after a SIGKILL of a
     subprocess daemon, both equal to an uninterrupted solo run; per job
     the routed wall, the daemon's, the router hop and the queue wait (ms),
     and kernels 2, 4 and 8's launches around the phase;
 18j. ``mesh_mp_*``: ta014 lb2 ub=1 at ``--tier mesh --D 2 --mp 2`` and
     ``--mp 4`` (the lb2 pair loop in mp pair blocks, the unfused cycle),
     staged (kernels 1 and 7 on pair blocks) and single-pass
     (``mesh_resident_search(staged=False)``: kernel 6 on pair blocks), the
     mp = 2 run once guarded (K = 4), beside the mp = 1 unfused mesh, and
     ``--tier dist_mesh --hosts 2 --D 1`` at mp 2 and 1, each to its
     goldens, the counts set to 0 before each: a pair-block wrapper
     launched mp times a cycle, the full-pair one never; each line's device
     ms (events) beside mp = 1's; the mp = 2 mesh runs again under
     ``torch.profiler``, where the trace's launches of kernels 1, 6 and 7
     and of the shards' ``slot_gate`` are at most the wrappers' counts
     (CUPTI loses records in conditional bodies, never adds one); then
     ``slot_gate``: one unfused mesh dispatch (N=12, D = 4 with a frozen
     shard) on the card against the same program on the CPU, max
     difference 0, its while body a gate and an ``if`` node a shard and
     ``batch_cond`` (no cycle node outside an ``if`` node: a frozen shard
     launches nothing), and the gate's device time a launch (profiler)
     beside its plain version;
 18k. ``kernel6_mp``, ``kernel7_mp``: kernels 6 and 7 on the pair blocks
     of ta014 (P = 45) and ta021 (P = 190) at mp = 2 and 4, B = 49152
     seeded rows: each block against its plain version (the plain lb2 over
     the block's pairs), and the max of the blocks against the full-pair
     launch, max difference 0 (kernel 6 on the open slots, kernel 7 on
     every row); each block's time, the plain time, the bound at P_local
     and the whole mp call's time beside the full launch's;
 18l. ``mesh_eval``: ``parallel/mesh.py``'s ``MeshEvaluator`` on the card
     over four positions of cuda:0 (dp 4, or 2 x 2 and 1 x 4 under mp) on
     ta014 lb1, lb1_d, lb2 at mp 1, 2, 4 and N = 15, against the unsharded
     bounds (open slots) and the leaf fold against the plain minimum;
 18m. ``mesh_cards``: the device count; the mesh over ``--device
     cuda:0,cuda:0`` (two groups on the card: a graph a group and round,
     the cross-group balance) at D = 4 on ta014 lb1 and N = 15 to the
     goldens, equal to the one-group program's state rows and live rows
     after each of three dispatches; ``--tier multi --device
     cuda:0,cuda:0``; and, with more than one card, the same over
     cuda:0,cuda:1;
 18o. ``pair_exchange`` (``csrc/pair_exchange.cu``, the JAX ``lax.pmax``
     over the mp axis): two copies on two positions of the card, each on
     a stream of its own, at M = 49152 and n = 20, five exchanges in a row
     against the plain version (max difference 0), the pair's time and
     each kernel's, the plain version's, the bound; a copy whose peer never
     posts raising within the 0.5 s timeout;
 18p. ``mesh_mp_copies_*``: ta014 lb2 ``--tier mesh --D 2 --mp 2`` staged
     and single-pass over ``cuda:0,cuda:0`` and four positions of
     ``cuda:0`` (each shard a copy at each position of its grid row) to
     the goldens, each copy's pair block and exchange launched once a
     cycle, the device ms beside phase 18j's in-turn layout and mp = 1;
     three dispatches of each against the one-position program, every
     state row and live row equal, the copies' rows their primaries',
     error words 0 (with two cards the same over cuda:0,cuda:1);
 18q. ``whole_profile``: ``--profile`` on the fused ta014 lb1 search, its
     trace naming kernel 2's launches, and, in a process of its own, on
     the unfused ta014 lb1 M = 1024 search: the goldens and the window the
     CLI prints (K capped, dispatches 1..i of N traced within the budget);
 18r. ``copies_traced``: the CLI refuses ``--profile`` of the copies over
     ``cuda:0,cuda:0`` (exit 2) and runs the line untraced to the goldens;
     one dispatch of the copies over two and four positions untraced,
     then under ``torch.profiler``, where ``MeshProgram`` refuses it;
 18n. ``compact_*``: the unfused ta014 lb1 M = 1024, N-Queens N = 14 and
     ta014 lb2 staged under ``--compact`` scatter, sort and search to the
     goldens, each with its counts set to 0 just before it and the body's
     kernel launched; a guarded unfused N = 14 under sort and under search;
     ``check``: ``check`` with no ``--device``, the card (`analysis/program_audit.py`), over
     every matrix cell's dispatch graph, the node names and types held to
     the contracts, 0 findings;
 18c. the single-device tiers beside the resident engine: ``seq``, the
     sequential tier (``--tier seq``, the native host runtime) on ta014 lb1
     and lb2 ub=1 and N-Queens N = 14 to their goldens with no kernel
     launched, nodes/s beside BASELINE.md's C anchors and the host CPU
     named; ``offload_*``, the offload engine (``--engine offload``) on
     ta014 lb1, lb1_d and lb2 (staged: kernels 1 and 7) and N = 14, and
     ``device_search(staged=False)`` on lb2 (kernel 6), to their goldens,
     each bound wrapper launched once a chunk and no other kernel, with
     the chunks, copies, ``double_buffered`` and phase 2 seconds;
     ``checkpoint_*``, cut (``--K 4 --max-steps 2 --checkpoint``) and
     resume (``--resume``) of ta014 lb1 and lb2 fused and N = 15 ``--mt
     80`` to the goldens, ta014 lb1 with ``--checkpoint-interval 0``, and
     the JAX package's committed v1 cut of N = 9, with each save's and
     load's seconds and the file's bytes; ``host_phases``, phases 1 and 3
     of ta014 lb1 and lb2 and N = 15 fused with the native runtime and
     with ``TTS_NATIVE=0``, in turns A B B A;
 19. the eval-only pass through ``streamed_eval_bounds`` (lb1, lb2, N-Queens
     at full width) and ``megakernel_lb2_bounds``, which launch kernels 1,
     6 and 3 (counted), checked against the plain planes;
 20. the lb2 searches (and the streamed one) again under ``torch.profiler``,
     the unfused ta014 lb1 search at M = 1024, the ta014 lb1_d search and
     the unfused N-Queens N = 14 search (with kernel 1's, 5's, resp. 3's,
     device time a search; the staged lb2 search with kernels 1 and 7's), then
     ta014 lb1 and N-Queens N = 15, single-tile and streamed: device time
     by kernel against the device phase's wall time (the busy share),
     and for the single-tile ta014 lb1 (kernel 2) and N-Queens (kernel 4)
     searches and the streamed lb1 (9b), N-Queens (9a) and lb2 (9c)
     searches the launches a cycle from the profiler's kernel counts (3, 2,
     3, 2 and 3 a cycle, and no ``cycle_scan`` launch). Under the graph
     dispatch the wrapper is called once a K rung, at capture
     (``captures``), and its ``launches`` are the graph bodies' runs that
     the device counted (``st[ST_RUNS]``, read after each dispatch), which
     must equal the real cycles: no cycle launched past termination. The
     trace may lose events of a graph body, never gain one: it is held to
     at most that many launches, exactly that many when it holds every
     ``dispatch_init`` and ``dispatch_cond`` that ran (``trace_complete``,
     ``trace_lost``); the graphed searches' device time is also taken by
     CUDA events around each graph launch (``dispatch_device_ms``,
     ``event_busy_share``);
 21. the ``kernels`` line: per kernel its route, source, the TPU kernel it
     replaces, launches on its search path (the fused and streamed cycles:
     the cycles their graphs ran, with the graph's ``captures`` beside),
     the largest difference from the
     plain version, its time, the plain version's time and the bound (the
     kernel 1, 3, 5, 6 and 8 rows with their block shape); the eval-only
     pass's TPU kernels get rows of their own on kernels 1, 3 and 6, with
     the launches of phase 19; the lb2 and N-Queens rows carry ``wide``
     (phase 16b), and ``dispatch_graph`` (the graph dispatch, the host
     loop's counterpart of the JAX ``lax.while_loop``) its phase 16c time,
     its condition kernel's time a cycle and the pipeline runs;
     ``dispatch_init`` and ``dispatch_cond`` (the graph's own nodes) their
     launches (none of ``dispatch_cond`` on a fused search: the cycle sets
     the condition) and profiled times; rows 1, 3,
     5, 6 and 7 carry the offload runs' launches (``offload_launches``);
     ``dispatch_cond_obs`` (the counter node) and ``phase_mark`` (the
     clock) carry the launches of the armed ta014 lb1 runs of phase 18d;
     ``batch_init`` and ``batch_cond`` (the batched graph's nodes) the
     launches of phase 18e's batched ta014 lb1 run, their phase 16d times
     and a frozen slot's cost a cycle; ``mesh_balance`` the launches of the
     mesh D = 4 ta014 lb1 run and its phase 18f times; rows 1, 3, 7 and the
     cycles carry the multi, mesh, dist and dist_mesh runs' launches
     (``parallel_launches``), and the cycles 2, 4 and 8 the fleet phase's
     (``fleet_launches``); kernels 6 and 7 on pair blocks get rows of their
     own (``lb2_bounds_pair_block``, ``lb2_self_bounds_pair_block``) with
     the launches of the mp = 2 mesh runs of phase 18j and the times of
     phase 18k; ``pair_exchange`` the launches of phase 18p's staged run
     over two positions and phase 18o's times.

Every phase line carries ``t_s``, the script's seconds so far.
Kernel times (``ms``) are the profiler's device time a call (``timing``
says how it was taken), ``call_ms`` CUDA-event medians on the card; ``bound_ms`` is the larger of the
bytes the function must move over 3.35 TB/s and its int32 operations over
67 T/s (the H100 SXM data-sheet rates, a card at its 700 W limit). The lb2
rows count the operations of the per-parent pair pass (``lb2_scan_ops``)
and print the per-child recurrence's count beside it as
``child_loop_bound_ms`` (``lb2_ops``); kernel 7 (one bound a row) counts
its walks by free job (``lb2_self_ops``) and prints the all-slots count
beside it as ``all_slots_bound_ms``. The last
line is ``{"ok": true, "device": {...}}``. Without CUDA, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

GOLDEN = {"explored_tree": 2573652, "explored_sol": 2648, "optimum": 1377}
GOLDEN_LB2 = {"explored_tree": 144639, "explored_sol": 0, "optimum": 1377}
NQ_GOLDEN = {15: {"explored_tree": 171129071, "explored_sol": 2279184},
             14: {"explored_tree": 27358552, "explored_sol": 365596}}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (data sheet)
INT_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (data sheet)
INF = 2**31 - 1
# The three kernels of one fused cycle (csrc/cycle_lb1.cu; the count
# launch ends with the last block's offset scan).
CYCLE_KERNELS = ("cycle_bounds", "cycle_count", "cycle_emit")
# The three kernels of one fused lb2 cycle (csrc/cycle_lb2.cu).
LB2_CYCLE_KERNELS = ("lb2_cycle_bounds", "cycle_count", "cycle_emit")
# The two kernels of one fused N-Queens cycle (csrc/cycle_nqueens.cu).
NQ_CYCLE_KERNELS = ("nq_cycle_labels", "nq_cycle_emit")
# The kernel of each of the eval-only pass's TPU kernels, by counter.
EVAL_KERNEL = {"eval_lb1": "lb1_bounds", "eval_nqueens": "nqueens_labels",
               "eval_lb2": "lb2_bounds"}
# The kernels of one streamed cycle: kernel 9b's bounds, count and emit
# (csrc/tiled_lb1.cu, kernel 2's bodies), kernel 9c's (csrc/tiled_lb2.cu,
# kernel 8's bodies) and kernel 9a's labels and emit (csrc/tiled_nqueens.cu,
# kernel 4's bodies), each under a name of its own.
TILED_KERNELS = {"lb1": ("lb1_tiles_bounds", "pfsp_tiles_count", "pfsp_tiles_emit"),
                 "lb2": ("lb2_tiles_bounds", "pfsp_tiles_count", "pfsp_tiles_emit"),
                 "nqueens": ("nq_tiles_labels", "nq_tiles_emit")}


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase line, with the script's seconds so far (``t_s``)."""
    print(json.dumps({"phase": phase, "t_s": round(time.perf_counter() - _T0, 3),
                      **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


# Device ms a call of each launch of the last profiled kernel_device_ms,
# by launch name (the cycle phases print it beside the total), and the
# launches of each name a call that its trace held.
LAST_LAUNCH_MS: dict[str, float] = {}
LAST_LAUNCHES: dict[str, float] = {}


def _profiled_ms(fn, reps: int, names: tuple[str, ...],
                 setup) -> tuple[float | None, int]:
    """(device ms of one call, launches the trace held of the name it held
    least) from a ``torch.profiler`` trace of ``reps`` calls, each of which
    launches every kernel of ``names`` once: per name, its mean per launch
    over the launches the trace holds. (None, 0) when the trace holds none
    of some name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if setup is not None:
                setup()
            fn()
        torch.cuda.synchronize()
    per_name: dict[str, list] = {}
    for ev in prof.key_averages():
        name = next((nm for nm in names if nm in ev.key), None)
        if name is None:
            continue
        us = getattr(ev, "device_time_total", None)
        us = ev.cuda_time_total if us is None else us
        acc = per_name.setdefault(name, [0.0, 0])
        acc[0] += us
        acc[1] += ev.count
    LAST_LAUNCH_MS.clear()
    LAST_LAUNCHES.clear()
    if len(per_name) < len(names) or any(c == 0 or us <= 0 for us, c in per_name.values()):
        return None, 0
    for name, (us, c) in per_name.items():
        LAST_LAUNCH_MS[name] = us / c / 1e3
        LAST_LAUNCHES[name] = c / reps
    return sum(LAST_LAUNCH_MS.values()), min(c for _, c in per_name.values())


def kernel_device_ms(fn, reps: int, names: tuple[str, ...],
                     setup=None) -> tuple[float, str]:
    """Device time of one ``fn()`` call spent in the CUDA kernels whose names
    contain one of ``names`` (each launched once a call), and how it was
    taken. ``"profiler"``: the sum over ``names`` of each kernel's mean
    duration a launch in a ``torch.profiler`` (CUPTI) trace of ``reps``
    calls — host issue time excluded; ``"profiler (k of reps launches)"``
    when the trace held only k launches of some name (a trace can drop
    events; the mean is over those it holds). When the trace holds none of
    some name (tried twice), ``"events"``: the mean of CUDA events around
    each of ``reps`` calls — an upper bound that includes whatever host
    issue time the device waits for."""
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        ms, held = _profiled_ms(fn, reps, names, setup)
        if ms is not None:
            return ms, ("profiler" if held >= reps
                        else f"profiler ({held} of {reps} launches)")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        if setup is not None:
            setup()
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps, "events"


def median_ms(fn, reps: int, setup=None) -> float:
    """Median wall time of one ``fn()`` call on the stream (CUDA events
    around each call, host issue time included; ``setup()`` runs before
    each, outside the timed pair)."""
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def lb1_ops(limit1: np.ndarray, n: int, m: int) -> float:
    """int32 operations of the lb1 plane: per parent (l1+1)*m*2 for the
    front scan and (n-l1-1)*m for the remaining work, per child slot 6m."""
    l1 = limit1.astype(np.int64)
    return float(np.sum((l1 + 1) * m * 2 + (n - l1 - 1) * m) + limit1.size * n * 6 * m)


def lb1_d_ops(limit1: np.ndarray, n: int, m: int) -> float:
    """int32 operations of the lb1_d plane: the lb1 parent prologue, then
    per child slot 5m (two max, three add a machine)."""
    l1 = limit1.astype(np.int64)
    return float(np.sum((l1 + 1) * m * 2 + (n - l1 - 1) * m) + limit1.size * n * 5 * m)


def lb2_ops(limit1: np.ndarray, n: int, m: int, P: int,
            child: bool = True) -> float:
    """int32 operations of lb2. Per parent: the front scan, (l1+1)*m*2, and
    n job positions. Per bound: P*(5n + 4) for the pair loop (a free test
    and the recurrence tmp0 += p0; tmp1 = max(tmp1, tmp0 + lag) + p1 an
    ordered slot, then the pair's two tails and maxes). ``child``: one bound
    per open child slot (k > l1), each after its add_forward step (2m);
    else (the self bound) one bound per row."""
    l1 = limit1.astype(np.int64)
    pro = float(np.sum((l1 + 1) * m * 2 + n))
    per = P * (5 * n + 4)
    if child:
        return pro + float(np.sum(n - l1 - 1)) * (2 * m + per)
    return pro + l1.size * per


def lb2_self_ops(limit1: np.ndarray, n: int, m: int, P: int) -> float:
    """int32 operations of the self lb2 by free jobs (kernel 7's walks):
    per row the front scan, (l1+1)*m*2, n for its free-job mask, and per
    pair 5 a free job (the recurrence and the walk's step) and 4 for the
    pair's tails and maxes: P*(5r + 4) with r = n-l1-1."""
    l1 = limit1.astype(np.int64)
    r = n - l1 - 1
    return float(np.sum((l1 + 1) * m * 2 + n + P * (5 * r + 4)))


# Operations of one free job in one (parent, pair) task of the pair pass
# (`lb2p_pair`, csrc/lb2_common.cuh): 9 in the forward walk (the two prefix
# sums, the term, its atomicMax and the prefix maximum) and 9 in the
# backward walk.
LB2_SCAN_OPS_PER_JOB = 18
# Operations of one open child a machine in `lb2p_bounds`: its add_forward
# step (2), the machine's one-machine term and the maxima (5).
LB2_CHILD_OPS_PER_MACHINE = 7


def lb2_scan_ops(limit1: np.ndarray, n: int, m: int, P: int) -> float:
    """int32 operations of the lb2 child plane by the per-parent pair pass.
    Per parent: the front scan, (l1+1)*m*2, its n jobs read, and
    LB2_CHILD_OPS_PER_MACHINE*m for each of its r = n-l1-1 open children.
    Per (parent, pair): one free test an ordered slot (n) and
    LB2_SCAN_OPS_PER_JOB a free job."""
    l1 = limit1.astype(np.int64)
    r = n - l1 - 1
    return float(np.sum((l1 + 1) * m * 2 + n + r * LB2_CHILD_OPS_PER_MACHINE * m
                        + P * (n + LB2_SCAN_OPS_PER_JOB * r)))


def johnson_bytes(tables, source: str = "lb2_bounds") -> int:
    """Bytes of the tables an lb2 kernel reads on its route: ptm_t and
    min_heads (int32), the (P, 4) int32 pair rows, and the (P, n, 4) ordered
    table, int16 on the shared-memory route, int32 with its (P, n) int16
    inverse on the global one."""
    from tpu_tree_search_torch.ops import lb2_kernel

    J = lb2_kernel.johnson_operands(source, tables)
    return (tables.jobs * tables.machines + tables.machines) * 4 + \
        J.tab.numel() * J.tab.element_size() + J.pairinfo.numel() * 4 + \
        (J.inv.numel() * 2 if J.tables == "global" else 0)


def nq_ops(depth: np.ndarray, N: int, g: int) -> float:
    """Integer operations of the labels of these parents: per round, per
    (placed queen, open slot), two compares and two adds (the diagonals)."""
    d = depth.astype(np.int64)
    return float(g * np.sum(d * np.clip(N - d, 0, None)) * 4)


def random_boards(rng, N: int, B: int, full_share: float = 0.2):
    """Seeded random permutation boards; depth uniform in 0..N with a share
    at N (popped solutions)."""
    board = np.argsort(rng.random((B, N)), axis=1).astype(np.uint8)
    depth = rng.integers(0, N + 1, B).astype(np.int32)
    depth[rng.random(B) < full_share] = N
    return board, depth


def random_nodes(rng, n: int, B: int, deep_share: float = 0.25):
    """Seeded partial permutations; a share one swap from complete so their
    children are leaves."""
    prmu = np.argsort(rng.random((B, n)), axis=1).astype(np.int32)
    limit1 = rng.integers(-1, n - 2, B).astype(np.int32)
    limit1[rng.random(B) < deep_share] = n - 2
    return prmu, limit1


# Kernel 7's launches on the staged ta014 lb2 search (seventeen, each of
# R = 49152*20 rows) that phase kernel7 times: launches 1, 5 and 9 by
# their index, with the counts they have there.
K7_SEARCH_LAUNCHES = {0: 185, 4: 9372, 8: 74171}


@contextlib.contextmanager
def eager_cycles():
    """The resident programs made in the block launch their cycles from the
    host's loop, not through a dispatch graph (``graphed`` off): the same
    kernels, one wrapper call a cycle."""
    from tpu_tree_search_torch.engine import resident as R

    def eager(orig):
        def init(self, *args, **kwargs):
            orig(self, *args, **kwargs)
            self.graphed = False
            self.dispatch_device_s = None
        return init

    with _patched(R._ResidentProgram, "__init__", eager):
        yield


def capture_self_launches(run, keep=None) -> list[dict]:
    """Kernel 7's inputs as a search hands them over: ``run()`` runs a
    staged lb2 search with ``pfsp_device.lb2_self_bounds`` wrapped so that
    each call's rows and limit1 are copied before the call (the calls whose
    index is in ``keep``; every call when it is None). The search's
    programs run their cycles eagerly (``eager_cycles``), so that the hook
    sees each cycle's call, not the one call of a graph's capture. One dict
    a call: ``index``, ``n_active`` (read after the search), ``rows`` and
    ``limit1`` (the copies, or None)."""
    from tpu_tree_search_torch.ops import pfsp_device

    real = pfsp_device.lb2_self_bounds
    calls = []

    def hook(rows, limit1, n_active, tables):
        mine = keep is None or len(calls) in keep
        calls.append(dict(index=len(calls),
                          n_active=(n_active.clone() if isinstance(n_active, torch.Tensor)
                                    else n_active),
                          rows=rows.clone() if mine else None,
                          limit1=limit1.clone() if mine else None))
        return real(rows, limit1, n_active, tables)

    pfsp_device.lb2_self_bounds = hook
    try:
        with eager_cycles():
            run()
    finally:
        pfsp_device.lb2_self_bounds = real
    for c in calls:
        c["n_active"] = int(c["n_active"])
    return calls


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         nvidia_smi=smi, host_cpu=host_cpu(), **dev)
    return dev


def host_cpu() -> str:
    """The host CPU (the host phases and the sequential tier run there):
    its model as /proc/cpuinfo names it, vendor, family, model number and
    clock, and the cores this process sees."""
    import os
    import platform

    info = {}
    try:
        for ln in open("/proc/cpuinfo").read().splitlines():
            key, _, value = ln.partition(":")
            info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    parts = [info.get("model name") or platform.processor() or platform.machine()]
    parts += [f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model", "cpu MHz")
              if info.get(k)]
    return f"{', '.join(parts)}; {os.cpu_count()} cores"


def phase_build():
    from tpu_tree_search_torch import native
    from tpu_tree_search_torch.ops import _build

    # The host runtime first (g++, seconds), so that no search's phases
    # include its build.
    t0 = time.perf_counter()
    native_lib = native.build()
    native.load()
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    per_source = _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {}
    for src in _build.sources():
        log = _build.log_path(src.stem).read_text(errors="replace")
        ptxas[src.stem] = [ln.strip() for ln in log.splitlines()
                           if "entry function" in ln or "registers" in ln
                           or "spill" in ln][:24]
    emit("build", seconds=secs, per_source_seconds=per_source, ptxas=ptxas,
         native_gxx_seconds=native_s, native_library=native_lib.name)


def lb1_family_inputs(seed: int):
    """The (instance, B, dtype, rows) of the kernel 1 and 5 rows: ta014 at
    B = 1024 and 49152, int8 and int32 (first, in the order of earlier
    runs, from ``seed``); ta021 (20 machines) at both B, int8; ta111 (500
    jobs) at B = 1024, int32; a seeded 40-machine, 12-job instance (the
    one-thread prologue) at B = 49152; and ta014 rows that are no
    permutation (repeated ids, limit1 from -3 to n + 1) at B = 49152,
    compared on every slot."""
    n = 20  # ta014's and ta021's jobs
    rng = np.random.default_rng(seed)
    cases = []
    for B in (1024, 49152):
        rows = random_nodes(rng, n, B)
        cases += [("ta014", B, dt, rows) for dt in (torch.int8, torch.int32)]
    rng = np.random.default_rng(seed + 100)
    cases += [("ta021", B, torch.int8, random_nodes(rng, n, B)) for B in (1024, 49152)]
    cases.append(("ta111", 1024, torch.int32, random_nodes(rng, 500, 1024)))
    cases.append(("40x12", 49152, torch.int8, random_nodes(rng, 12, 49152)))
    wild = (rng.integers(0, n, (49152, n)).astype(np.int32),
            rng.integers(-3, n + 2, 49152).astype(np.int32))
    cases.append(("ta014-nonperm", 49152, torch.int8, wild))
    return cases


def lb1_family_tables(dev) -> dict:
    """The lb1 tables of the kernel 1 and 5 rows, by instance name."""
    from tpu_tree_search_torch.problems import PFSPProblem

    ptm40 = np.random.default_rng(40).integers(1, 100, (40, 12))
    ta014 = PFSPProblem(inst=14, lb="lb1", ub=1).device_tables(dev)
    return {"ta014": ta014, "ta014-nonperm": ta014,
            "ta021": PFSPProblem(inst=21, lb="lb1", ub=1).device_tables(dev),
            "ta111": PFSPProblem(inst=111, lb="lb1", ub=1).device_tables(dev),
            "40x12": PFSPProblem(lb="lb1", ub=0, p_times=ptm40).device_tables(dev)}


def phase_lb1_family(phase: str, dev, tables: dict) -> dict:
    """Kernel 1 (``phase`` "kernel1", lb1) or kernel 5 ("kernel5", lb1_d)
    against its plain version on the rows of ``lb1_family_inputs``:
    bit-equal on the open slots (every slot for the rows that are no
    permutation), each row with its time, the block shape the kernel chose
    (``block``) and its bound. Rows are keyed (instance, B, dtype)."""
    from tpu_tree_search_torch.ops import lb1_d_kernel, lb1_kernel

    kernel, plain, source, ops_of = (
        (lb1_kernel.lb1_bounds_cuda, lb1_kernel.plain, "lb1_bounds", lb1_ops)
        if phase == "kernel1" else
        (lb1_d_kernel.lb1_d_bounds_cuda, lb1_d_kernel.plain, "lb1_d_bounds", lb1_d_ops))
    rows = {}
    for inst, B, dtype, (prmu, limit1) in lb1_family_inputs(0 if phase == "kernel1" else 5):
        t = tables[inst]
        n, m = t.jobs, t.machines
        nonperm = inst.endswith("nonperm")
        open_ = torch.from_numpy((np.arange(n)[None, :] > limit1[:, None]) | nonperm).to(dev)
        p = torch.from_numpy(prmu).to(dev).to(dtype)
        lim = torch.from_numpy(limit1).to(dev).to(dtype)
        got = kernel(p, lim, t)
        want = plain(p, lim, t)
        torch.cuda.synchronize()
        err = int((got[open_].long() - want[open_].long()).abs().max())
        check(err == 0, f"{phase} differs from plain ({inst}, B={B}, {dtype})")
        block = lb1_kernel.last_shape(source)
        # The prologue: a wavefront over `lanes` lanes a parent, or warp 0's
        # fronts (one thread a parent) beside the other warps' remaining work.
        block["prologue"] = "wavefront" if block["lanes"] else "warp 0 fronts"
        call = lambda: kernel(p, lim, t)  # noqa: E731
        ms, timing = kernel_device_ms(call, 50, (f"{source}_kernel",))
        call_ms = median_ms(call, 50)
        plain_ms = median_ms(lambda: plain(p, lim, t), 5)
        isz = p.element_size()
        nbytes = B * n * isz + B * isz + B * n * 4 + (n * m + 2 * m) * 4
        bms, by = bound_ms(nbytes, ops_of(np.clip(limit1, -1, n - 1), n, m))
        rows[(inst, B, str(dtype))] = dict(
            inst=inst, m=m, B=B, dtype=str(dtype), block=block, max_abs_err=err,
            ms=ms, timing=timing, call_ms=call_ms, plain_ms=plain_ms,
            bound_ms=bms, bound_us=bms * 1e3, bound_by=by)
        emit(phase, **rows[(inst, B, str(dtype))])
    return rows


def _pfsp_cycle_fns(dev, tables, lb: str, tiled: bool, M: int, mt: int,
                    dtype=torch.int8):
    """(run the kernel, run its plain version, kernel names, the scratch
    whose ``scal`` holds the last kernel call's per-tile scalars, or None)
    of one PFSP cycle on a pool of ``dtype``: single-tile (kernels 2, 8) or
    streamed in tiles of mt (kernels 9b, 9c). Each run takes (pool_vals,
    pool_aux, st) and returns the plain version's (G, 4) per-tile scalars,
    or None."""
    from tpu_tree_search_torch.ops import cycle as C
    from tpu_tree_search_torch.ops import tiled as T

    n, K, mterm = tables.jobs, 4, 25
    if not tiled:
        scratch = C.cycle_scratch(M, n, dtype, dev)
        cuda_cycle, plain_cycle = ((C.cycle_lb1_cuda, C.cycle_lb1_plain) if lb == "lb1"
                                   else (C.cycle_lb2_cuda, C.cycle_lb2_plain))
        return (lambda pv, pa, st: cuda_cycle(pv, pa, st, scratch, tables, M, mterm, K),
                lambda pv, pa, st: plain_cycle(pv, pa, st, tables, M, mterm, K),
                CYCLE_KERNELS if lb == "lb1" else LB2_CYCLE_KERNELS, None)
    if lb == "lb1":
        cuda_cycle, plain_cycle = T.tiled_lb1_cuda, T.tiled_lb1_plain
        scratch = T.tiled_lb1_scratch(M, n, mt, dtype, dev)
    else:
        cuda_cycle, plain_cycle = T.tiled_lb2_cuda, T.tiled_lb2_plain
        scratch = T.tiled_lb2_scratch(M, n, mt, dtype, dev)
    return (lambda pv, pa, st: cuda_cycle(pv, pa, st, scratch, tables, M, mt, mterm, K),
            lambda pv, pa, st: plain_cycle(pv, pa, st, tables, M, mt, mterm, K),
            TILED_KERNELS[lb], scratch)


# The tile width of the streamed rows keyed (M, chunk, incumbent); rows at
# another width add it to the key.
TILE_MT = {1024: 16, 49152: 64}


def phase_pfsp_cycle(phase: str, dev, tables, lb: str, seed: int,
                     tiled: bool = False, dtype=torch.int8,
                     inst: str = "ta014",
                     shapes=((1024, 16), (49152, 64)),
                     chunks=("partial", "full"),
                     incumbents=("finite", "inf")) -> dict:
    """A PFSP cycle kernel (``lb`` lb1: kernel 2, or 9b when ``tiled``; lb2:
    kernel 8, or 9c) against its plain version on a pool of ``dtype`` on
    the tables of ``inst``: at each (M, mt) of ``shapes`` (mt, the tile
    width, only streamed), a partial and a full chunk, finite and INF
    incumbent; equal state, live pool rows and, streamed, (G, 4) per-tile
    scalars. Each row has the device time by launch and the launches a
    cycle that the profiler's trace held."""
    from tpu_tree_search_torch.ops import cycle as C
    from tpu_tree_search_torch.ops import lb2_kernel
    from tpu_tree_search_torch.ops.pfsp_device import lb1_chunk, lb2_chunk

    bound = lb1_chunk if lb == "lb1" else lb2_chunk
    table_bytes = ((tables.jobs * tables.machines + 2 * tables.machines) * 4
                   if lb == "lb1" else johnson_bytes(tables))
    n, m = tables.jobs, tables.machines
    rng = np.random.default_rng(seed)
    rows = {}
    isz = dtype.itemsize
    for M, mt in shapes:
        run_cuda, run_plain, names, scratch = _pfsp_cycle_fns(dev, tables, lb, tiled, M,
                                                              mt, dtype)
        G = M // mt if tiled else 1
        for chunk in chunks:
            size = M // 2 + 3 if chunk == "partial" else M + 517
            prmu, limit1 = random_nodes(rng, n, size)
            leaf = (np.arange(n)[None, :] > limit1[:, None]) & (limit1[:, None] == n - 2)
            lbs = bound(torch.from_numpy(prmu).to(dev),
                        torch.from_numpy(limit1).to(dev), tables).cpu().numpy()
            for incumbent in incumbents:
                best = int(np.median(lbs[leaf])) if incumbent == "finite" else INF
                cap = size + M * n
                pv0 = torch.zeros((cap, n), dtype=dtype, device=dev)
                pa0 = torch.zeros(cap, dtype=dtype, device=dev)
                pv0[:size] = torch.from_numpy(prmu).to(dev).to(dtype)
                pa0[:size] = torch.from_numpy(limit1).to(dev).to(dtype)
                st0 = C.new_state(size, best, dev)
                pv, pa, st = pv0.clone(), pa0.clone(), st0.clone()
                run_cuda(pv, pa, st)
                pv2, pa2, st2 = pv0.clone(), pa0.clone(), st0.clone()
                scal2 = run_plain(pv2, pa2, st2)
                torch.cuda.synchronize()
                live = int(st2[C.ST_SIZE])
                err = max(
                    int((st[:C.ST_BASE + 1] - st2[:C.ST_BASE + 1]).abs().max()),
                    int((pv[:live].int() - pv2[:live].int()).abs().max()) if live else 0,
                    int((pa[:live].int() - pa2[:live].int()).abs().max()) if live else 0,
                    int((scratch.scal - scal2).abs().max()) if tiled else 0,
                )
                tree, sol = int(st2[C.ST_TREE]), int(st2[C.ST_SOL])
                check(err == 0 and int(st2[C.ST_CYCLES]) == 1,
                      f"{phase} ({lb}) kernel differs from plain (M={M}, {chunk}, {incumbent})")

                def restore():
                    pv.copy_(pv0)
                    pa.copy_(pa0)
                    st.copy_(st0)
                    pv2.copy_(pv0)
                    pa2.copy_(pa0)
                    st2.copy_(st0)

                def call():
                    run_cuda(pv, pa, st)

                ms, timing = kernel_device_ms(call, 30, names, restore)
                launch_ms = dict(LAST_LAUNCH_MS)
                launches = sum(LAST_LAUNCHES.values())
                call_ms = median_ms(call, 30, restore)
                block = (lb2_kernel.last_shape("tiled_lb2" if tiled else "cycle_lb2")
                         if lb == "lb2" else None)
                plain_ms = median_ms(lambda: run_plain(pv2, pa2, st2),
                                     3 if lb == "lb1" or M <= 1024 else 1, restore)
                cnt = min(size, M)
                # Rows popped and pushed, the tables, the state and, streamed,
                # the (G, 4) int32 per-tile scalars.
                nbytes = (cnt + tree) * (n + 1) * isz + table_bytes + 64 + \
                    (16 * G if tiled else 0)
                pop = limit1[size - cnt:]
                extra = {}
                if lb == "lb1":
                    ops = lb1_ops(pop, n, m)
                else:
                    P = tables.johnson.pair_count
                    ops = lb2_scan_ops(pop, n, m, P)
                    extra["child_loop_bound_ms"] = bound_ms(nbytes, lb2_ops(pop, n, m, P))[0]
                    if block is not None:
                        extra["block"] = block
                bms, by = bound_ms(nbytes, ops)
                key = ((M, chunk, incumbent) if not tiled or mt == TILE_MT.get(M)
                       else (M, chunk, incumbent, mt))
                rows[key] = dict(
                    inst=inst, n=n, dtype=str(dtype),
                    M=M, mt=mt if tiled else M, chunk=chunk, incumbent=incumbent, popped=cnt,
                    tree_inc=tree, sol_inc=sol, best_in=best,
                    best_out=int(st2[C.ST_BEST]), max_abs_err=err, ms=ms,
                    launch_ms=launch_ms, launches_per_cycle=launches, timing=timing,
                    call_ms=call_ms, plain_ms=plain_ms,
                    bound_ms=bms, bound_us=bms * 1e3, bound_by=by, **extra)
                emit(phase, **rows[key])
    return rows


def phase_kernel6(dev, lb2_tables: dict) -> dict:
    from tpu_tree_search_torch.ops import lb2_kernel

    rng = np.random.default_rng(6)
    rows = {}
    for inst, tables in lb2_tables.items():
        n, m, P = tables.jobs, tables.machines, tables.johnson.pair_count
        for B in ((1024, 49152) if n <= 20 else (1024,)):
            prmu, limit1 = random_nodes(rng, n, B)
            open_ = torch.from_numpy(np.arange(n)[None, :] > limit1[:, None]).to(dev)
            for dtype in (torch.int8, torch.int32):
                p = torch.from_numpy(prmu).to(dev).to(dtype)
                lim = torch.from_numpy(limit1).to(dev).to(dtype)
                got = lb2_kernel.lb2_bounds_cuda(p, lim, tables)
                want = lb2_kernel.plain(p, lim, tables)
                torch.cuda.synchronize()
                err = int((got[open_].long() - want[open_].long()).abs().max())
                check(err == 0, f"lb2 kernel differs from plain ({inst}, B={B}, {dtype})")
                call = lambda: lb2_kernel.lb2_bounds_cuda(p, lim, tables)  # noqa: E731
                ms, timing = kernel_device_ms(call, 30, ("lb2_bounds_kernel",))
                call_ms = median_ms(call, 30)
                block = lb2_kernel.last_shape("lb2_bounds")
                plain_ms = median_ms(lambda: lb2_kernel.plain(p, lim, tables),
                                     3 if B <= 1024 else 1)
                isz = p.element_size()
                nbytes = B * n * isz + B * isz + B * n * 4 + johnson_bytes(tables)
                bms, by = bound_ms(nbytes, lb2_scan_ops(limit1, n, m, P))
                key = (inst, B, str(dtype))
                rows[key] = dict(inst=inst, n=n, m=m, P=P, B=B, dtype=str(dtype),
                                 smem_bytes=lb2_kernel.block_smem("lb2_bounds", tables),
                                 block=block, max_abs_err=err, ms=ms, timing=timing,
                                 call_ms=call_ms, plain_ms=plain_ms, bound_ms=bms,
                                 bound_us=bms * 1e3, bound_by=by,
                                 child_loop_bound_ms=bound_ms(
                                     nbytes, lb2_ops(limit1, n, m, P))[0])
                emit("kernel6", **rows[key])
    return rows


def phase_kernel7(dev, tables) -> dict:
    """Kernel 7 against its plain version on ta014: R = 1024*20 and
    49152*20 ``random_nodes`` rows at n_active a quarter of R and R, and
    the rows of the staged ta014 lb2 search's own launches
    (``K7_SEARCH_LAUNCHES``, copied from a run of that search by
    ``capture_self_launches``); bit-equal on the active rows. Each row with
    its grid (``block``: threads, the most rows a thread, blocks, shared
    memory, blocks an SM, the table's stride), the lanes a row and rows a
    thread that the launch took from n_active as its block 0 wrote them
    (``split``, checked against the mirror ``lb2_self_kernel.split``), and
    two bounds: the free-job count (``lb2_self_ops``) and the all-slots
    count (``all_slots_bound_ms``, ``lb2_ops``)."""
    from tpu_tree_search_torch.ops import lb2_self_kernel

    n, m, P = tables.jobs, tables.machines, tables.johnson.pair_count
    rng = np.random.default_rng(7)
    rows = {}
    cases = []
    for B in (1024, 49152):
        R = B * n
        prmu, limit1 = random_nodes(rng, n, R)
        cases += [(torch.from_numpy(prmu).to(dev).to(torch.int8),
                   torch.from_numpy(limit1).to(dev).to(torch.int8), (R // 4, R), None)]
    launches = capture_self_launches(
        lambda: run_search(PFSP_LB2 + ["--unfused"], GOLDEN_LB2), keep=K7_SEARCH_LAUNCHES)
    emit("kernel7_search_launches", n_active=[c["n_active"] for c in launches])
    for i, want_count in K7_SEARCH_LAUNCHES.items():
        c = launches[i]
        check(c["n_active"] == want_count, f"the staged search's kernel 7 launch {i + 1} "
              f"has {c['n_active']} rows, not {want_count}")
        cases += [(c["rows"], c["limit1"], (c["n_active"],), i + 1)]
    for p, lim, counts, launch in cases:
        R = p.shape[0]
        limit1 = lim.cpu().numpy().astype(np.int32)
        for nact in counts:
            want = lb2_self_kernel.plain(p[:nact], lim[:nact], nact, tables)
            na = torch.tensor(nact, dtype=torch.int32, device=dev)
            got = lb2_self_kernel.lb2_self_bounds_cuda(p, lim, na, tables)
            torch.cuda.synchronize()
            err = int((got[:nact].long() - want.long()).abs().max())
            check(err == 0, f"lb2 self kernel differs from plain (R={R}, n_active={nact})")
            block = lb2_self_kernel.last_shape()
            split = lb2_self_kernel.last_split()
            check(split == lb2_self_kernel.split(nact, block["blocks"], block["threads"],
                                                 block["rows"], P, m),
                  f"lb2 self kernel took the split {split} at n_active={nact}, "
                  "not the mirror's")
            call = lambda: lb2_self_kernel.lb2_self_bounds_cuda(p, lim, na, tables)  # noqa: E731
            ms, timing = kernel_device_ms(call, 30, ("lb2_self_bounds_kernel",))
            call_ms = median_ms(call, 30)
            plain_ms = median_ms(lambda: lb2_self_kernel.plain(p, lim, na, tables), 3)
            nbytes = nact * (n + 1 + 4) + johnson_bytes(tables)
            bms, by = bound_ms(nbytes, lb2_self_ops(limit1[:nact], n, m, P))
            rows[(R, nact)] = dict(
                R=R, n_active=nact, dtype=str(p.dtype), search_launch=launch,
                mean_limit1=float(limit1[:nact].mean()), block=block, split=split,
                max_abs_err=err, ms=ms, timing=timing, call_ms=call_ms,
                plain_ms=plain_ms, bound_ms=bms, bound_us=bms * 1e3, bound_by=by,
                all_slots_bound_ms=bound_ms(
                    nbytes, lb2_ops(limit1[:nact], n, m, P, child=False))[0])
            emit("kernel7", **rows[(R, nact)])
    R = 49152 * n
    ratio = rows[(R, R // 4)]["ms"] / rows[(R, R)]["ms"]
    emit("kernel7_skip", quarter_ms=rows[(R, R // 4)]["ms"], full_ms=rows[(R, R)]["ms"],
         ratio=ratio)
    check(ratio < 0.5, f"n_active = R/4 takes {ratio:.2f}x the full time: "
          "the blocks past n_active are not skipped")
    return rows


def phase_kernel3(dev) -> dict:
    from tpu_tree_search_torch.ops import nqueens_kernel as NK

    rng = np.random.default_rng(3)
    rows = {}
    configs = [(N, B, g) for N in (15, 20) for B in (1024, 50000) for g in (1, 4)]
    # The unfused N=14 search's shape, the fold check's g=256 twin, the
    # widest packed board (eight packed words a parent), and a board past 32
    # (the per-slot path, ``block`` words 0).
    configs += [(14, 50000, 1), (15, 50000, 256), (32, 50000, 1), (48, 50000, 1)]
    for N, B, g in configs:
        board, depth = random_boards(rng, N, B)
        b = torch.from_numpy(board).to(dev)
        errs = []
        for dtype in (torch.int8, torch.int32):
            d = torch.from_numpy(depth).to(dev).to(dtype)
            got = NK.nqueens_labels_cuda(b, d, N, g)
            want = NK.plain(b, d, N, g)
            torch.cuda.synchronize()
            errs.append(int((got.int() - want.int()).abs().max()))
        err = max(errs)
        check(err == 0, f"labels kernel differs from plain (N={N}, B={B}, g={g})")
        d = torch.from_numpy(depth).to(dev).to(torch.int8)
        call = lambda: NK.nqueens_labels_cuda(b, d, N, g)  # noqa: E731
        call()
        block = NK.last_shape()
        ms, timing = kernel_device_ms(call, 30, ("nqueens_labels_kernel",))
        call_ms = median_ms(call, 30)
        plain_ms = median_ms(lambda: NK.plain(b, d, N, g), 3)
        bms, by = bound_ms(2 * B * N + B, nq_ops(depth, N, g))
        rows[(N, B, g)] = dict(N=N, B=B, g=g, block=block, max_abs_err=err, ms=ms,
                               timing=timing, call_ms=call_ms,
                               plain_ms=plain_ms, bound_ms=bms,
                               bound_us=bms * 1e3, bound_by=by)
        emit("kernel3", **rows[(N, B, g)])
    ratio = rows[(15, 50000, 256)]["ms"] / rows[(15, 50000, 1)]["ms"]
    emit("kernel3_rounds", g1_ms=rows[(15, 50000, 1)]["ms"],
         g256_ms=rows[(15, 50000, 256)]["ms"], ratio=ratio)
    check(ratio >= 4.0, f"g=256 labels take only {ratio:.2f}x the g=1 time: "
          "the compiler folded the rounds")
    return rows


def phase_kernel4(dev, phase: str = "kernel4", tiled: bool = False,
                  N: int = 15, shapes=None) -> dict:
    """The N-Queens cycle kernel (kernel 4, or 9a when ``tiled``) against
    its plain version at N = 15: M = 1024 (streamed: mt = 16) and 50000
    (mt = 80, and streamed also mt = 8), a partial and a full chunk, g = 1
    and (kernel 4, M = 50000) g = 4; equal state, live pool rows and,
    streamed, (G, 4) per-tile scalars. Rows are keyed (M, chunk), and
    (M, chunk, g) past g = 1, or (M, chunk, mt) past mt = 80. Another ``N``
    (a board past 32: ``mask_words`` keep-mask words a parent) takes
    ``shapes`` ((M, mt, g) triples) and is keyed (N, M, chunk)."""
    from tpu_tree_search_torch.ops import cycle as C
    from tpu_tree_search_torch.ops import cycle_nqueens as CN
    from tpu_tree_search_torch.ops import tiled as T
    from tpu_tree_search_torch.problems import NQueensProblem

    K, mterm = 4, 25
    prob = NQueensProblem(N, g=1)
    rng = np.random.default_rng((10 if tiled else 4) + N - 15)
    rows = {}
    ddt = CN.depth_dtype(N)
    if shapes is None:
        shapes = [(1024, 16, 1), (50000, 80, 1)] + (
            [(50000, 8, 1)] if tiled else [(50000, 80, 4)])
    for M, mt, g in shapes:
        if tiled:
            scratch = T.tiled_nqueens_scratch(M, N, mt, dev)
            names = TILED_KERNELS["nqueens"]

            def run_cuda(pv, pa, st):
                T.tiled_nqueens_cuda(pv, pa, st, scratch, prob, M, mt, mterm, K)

            def run_plain(pv, pa, st):
                return T.tiled_nqueens_plain(pv, pa, st, prob, M, mt, mterm, K)
        else:
            scratch = CN.nqueens_scratch(M, N, dev)
            names = NQ_CYCLE_KERNELS

            def run_cuda(pv, pa, st):
                CN.cycle_nqueens_cuda(pv, pa, st, scratch, N, g, M, mterm, K)

            def run_plain(pv, pa, st):
                return CN.cycle_nqueens_plain(pv, pa, st, N, g, M, mterm, K)
        G = M // mt if tiled else 1
        for chunk in ("partial", "full"):
            size = M // 2 + 3 if chunk == "partial" else M + 517
            board, depth = random_boards(rng, N, size)
            cap = size + M * N
            pv0 = torch.zeros((cap, N), dtype=torch.uint8, device=dev)
            pa0 = torch.zeros(cap, dtype=ddt, device=dev)
            pv0[:size] = torch.from_numpy(board).to(dev)
            pa0[:size] = torch.from_numpy(depth).to(dev).to(ddt)
            st0 = C.new_state(size, INF, dev)
            pv, pa, st = pv0.clone(), pa0.clone(), st0.clone()
            run_cuda(pv, pa, st)
            pv2, pa2, st2 = pv0.clone(), pa0.clone(), st0.clone()
            scal2 = run_plain(pv2, pa2, st2)
            torch.cuda.synchronize()
            live = int(st2[C.ST_SIZE])
            err = max(
                int((st[:C.ST_BASE + 1] - st2[:C.ST_BASE + 1]).abs().max()),
                int((pv[:live].int() - pv2[:live].int()).abs().max()) if live else 0,
                int((pa[:live].int() - pa2[:live].int()).abs().max()) if live else 0,
                int((scratch.scal - scal2).abs().max()) if tiled else 0,
            )
            tree, sol = int(st2[C.ST_TREE]), int(st2[C.ST_SOL])
            check(err == 0 and int(st2[C.ST_CYCLES]) == 1 and tree > 0 and sol > 0,
                  f"{phase} N-Queens cycle kernel differs from plain (M={M}, {chunk}, g={g})")

            def restore():
                pv.copy_(pv0)
                pa.copy_(pa0)
                st.copy_(st0)
                pv2.copy_(pv0)
                pa2.copy_(pa0)
                st2.copy_(st0)

            def call():
                run_cuda(pv, pa, st)

            ms, timing = kernel_device_ms(call, 30, names, restore)
            launch_ms = dict(LAST_LAUNCH_MS)
            launches = sum(LAST_LAUNCHES.values())
            call_ms = median_ms(call, 30, restore)
            plain_ms = median_ms(lambda: run_plain(pv2, pa2, st2), 3, restore)
            cnt = min(size, M)
            pop = depth[size - cnt:]
            nbytes = cnt * (N + 1) + tree * (N + 1) + 64 + (16 * G if tiled else 0)
            bms, by = bound_ms(nbytes, nq_ops(pop[pop < N], N, g))
            key = ((N, M, chunk) if N != 15 else (M, chunk, g) if g != 1 else
                   (M, chunk) if mt in (16, 80) else (M, chunk, mt))
            rows[key] = dict(
                **({"N": N, "mask_words": CN.nq_mask_words(N)} if N != 15 else {}),
                M=M, mt=mt if tiled else M, g=g, chunk=chunk, popped=cnt,
                tree_inc=tree, sol_inc=sol, max_abs_err=err, ms=ms,
                launch_ms=launch_ms, launches_per_cycle=launches, timing=timing,
                call_ms=call_ms,
                plain_ms=plain_ms, bound_ms=bms, bound_us=bms * 1e3, bound_by=by)
            emit(phase, **rows[key])
    return rows


def phase_lb2_wide(dev) -> dict:
    """Kernels 6 and 7 past 100 jobs, against their plain versions on
    int32 rows (the resident pool's type past 127 jobs): ta101 (200 jobs, 20
    machines) and ta111 (500 jobs), both on the global table route, at B =
    1024 and 256 parents (kernel 7: n_active = R = 4096 rows). Each row with
    its route (``tables``), block shape and bound (kernel 6: the pair pass,
    ``lb2_scan_ops``; kernel 7: its walks by free job)."""
    from tpu_tree_search_torch.ops import lb2_kernel, lb2_self_kernel
    from tpu_tree_search_torch.problems import PFSPProblem

    rng = np.random.default_rng(111)
    rows = {}
    for inst, B in (("ta101", 1024), ("ta111", 256)):
        tables = PFSPProblem(inst=int(inst[2:]), lb="lb2", ub=1).device_tables(dev)
        n, m, P = tables.jobs, tables.machines, tables.johnson.pair_count
        prmu, limit1 = random_nodes(rng, n, B)
        p = torch.from_numpy(prmu).to(dev)
        lim = torch.from_numpy(limit1).to(dev)
        open_ = torch.from_numpy(np.arange(n)[None, :] > limit1[:, None]).to(dev)
        got = lb2_kernel.lb2_bounds_cuda(p, lim, tables)
        want = lb2_kernel.plain(p, lim, tables)
        torch.cuda.synchronize()
        err = int((got[open_].long() - want[open_].long()).abs().max())
        check(err == 0, f"lb2 kernel differs from plain ({inst}, B={B})")
        call = lambda: lb2_kernel.lb2_bounds_cuda(p, lim, tables)  # noqa: E731
        ms, timing = kernel_device_ms(call, 20, ("lb2_bounds_kernel",))
        block = lb2_kernel.last_shape("lb2_bounds")
        plain_ms = median_ms(lambda: lb2_kernel.plain(p, lim, tables), 1)
        nbytes = B * n * 4 + B * 4 + B * n * 4 + johnson_bytes(tables)
        bms, by = bound_ms(nbytes, lb2_scan_ops(limit1, n, m, P))
        rows[("kernel6", inst)] = dict(
            inst=inst, n=n, m=m, P=P, B=B, dtype="torch.int32", tables=block["tables"],
            block=block, max_abs_err=err, ms=ms, timing=timing,
            call_ms=median_ms(call, 20), plain_ms=plain_ms, bound_ms=bms,
            bound_us=bms * 1e3, bound_by=by,
            child_loop_bound_ms=bound_ms(nbytes, lb2_ops(limit1, n, m, P))[0])
        emit("kernel6", **rows[("kernel6", inst)])
        R = 4096
        sp, sl = random_nodes(rng, n, R)
        sp_t, sl_t = torch.from_numpy(sp).to(dev), torch.from_numpy(sl).to(dev)
        na = torch.tensor(R, dtype=torch.int32, device=dev)
        got = lb2_self_kernel.lb2_self_bounds_cuda(sp_t, sl_t, na, tables)
        want = lb2_self_kernel.plain(sp_t, sl_t, R, tables)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        check(err == 0, f"lb2 self kernel differs from plain ({inst}, R={R})")
        call = lambda: lb2_self_kernel.lb2_self_bounds_cuda(sp_t, sl_t, na, tables)  # noqa: E731
        ms, timing = kernel_device_ms(call, 20, ("lb2_self_bounds_kernel",))
        block = lb2_self_kernel.last_shape()
        nbytes = R * (n * 4 + 4 + 4) + johnson_bytes(tables, "lb2_self_bounds")
        bms, by = bound_ms(nbytes, lb2_self_ops(sl, n, m, P))
        rows[("kernel7", inst)] = dict(
            inst=inst, n=n, R=R, n_active=R, dtype="torch.int32", tables=block["tables"],
            block=block, split=lb2_self_kernel.last_split(), max_abs_err=err, ms=ms,
            timing=timing, call_ms=median_ms(call, 20),
            plain_ms=median_ms(lambda: lb2_self_kernel.plain(sp_t, sl_t, R, tables), 1),
            bound_ms=bms, bound_us=bms * 1e3, bound_by=by,
            all_slots_bound_ms=bound_ms(nbytes, lb2_ops(sl, n, m, P, child=False))[0])
        emit("kernel7", **rows[("kernel7", inst)])
        for phase, tiled in (("kernel8", False), ("kernel11", True)):
            got = phase_pfsp_cycle(phase, dev, tables, "lb2", 11 + int(tiled), tiled=tiled,
                                   dtype=torch.int32, inst=inst, shapes=((256, 16),),
                                   chunks=("full",), incumbents=("finite",))
            for key, row in got.items():
                rows[(phase, inst) + key] = dict(row, tables=row["block"]["tables"])
        for (phase, i, *_), row in rows.items():
            source = {"kernel6": "lb2_bounds", "kernel7": "lb2_self_bounds",
                      "kernel8": "cycle_lb2", "kernel11": "tiled_lb2"}[phase]
            check(i != inst or row["tables"]
                  == lb2_kernel.johnson_operands(source, tables).tables,
                  f"{source} on {inst}: launched on {row['tables']}, not the "
                  "route johnson_operands picks")
    return rows


#: The graph dispatch's cases: (name, problem, M, mt, the body's source
#: ("unfused": the unfused cycle, whose body ends with dispatch_cond), K,
#: whether the dispatch runs all K cycles: True, or False (the search ends
#: before its K-th cycle, so the body must run no more than the real
#: cycles)).
def graph_cases():
    from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem

    lb1 = PFSPProblem(inst=14, lb="lb1", ub=1)
    # No incumbent: ta014 lb2's tree at the optimum is smaller than a chunk.
    lb2 = PFSPProblem(inst=14, lb="lb2", ub=0)
    nq = NQueensProblem(15)
    return (("ta014_lb1", lb1, 49152, None, "cycle_lb1", 4, True),
            ("nqueens_N15", nq, 50000, None, "cycle_nqueens", 4, True),
            ("ta014_lb2", lb2, 49152, None, "cycle_lb2", 4, True),
            ("nqueens_N15_mt80", nq, 50000, 80, "tiled_nqueens", 4, True),
            ("ta014_lb1_mt64", lb1, 49152, 64, "tiled_lb1", 4, True),
            ("ta014_lb2_mt64", lb2, 49152, 64, "tiled_lb2", 4, True),
            ("nqueens_N10_ends", NQueensProblem(10), 1024, None, "cycle_nqueens", 64,
             False),
            ("ta014_lb1_unfused", lb1, 1024, None, "unfused", 4, True))


def plain_cycle(source: str, prob, prog, ref, M: int, mt, K: int) -> None:
    """One plain cycle of the body ``source`` on the state ``ref``."""
    from tpu_tree_search_torch.ops import cycle as C
    from tpu_tree_search_torch.ops import cycle_nqueens as CN
    from tpu_tree_search_torch.ops import tiled as T

    v, a, st = ref.pool_vals, ref.pool_aux, ref.st
    if source == "unfused":
        prog._unfused_cycle(ref)
    elif source == "cycle_nqueens":
        CN.cycle_nqueens_plain(v, a, st, prob.N, prob.g, M, 25, K)
    elif source == "tiled_nqueens":
        T.tiled_nqueens_plain(v, a, st, prob, M, mt, 25, K)
    elif source.startswith("tiled_"):
        (T.tiled_lb1_plain if source == "tiled_lb1" else T.tiled_lb2_plain)(
            v, a, st, prog.tables, M, mt, 25, K)
    else:
        (C.cycle_lb1_plain if source == "cycle_lb1" else C.cycle_lb2_plain)(
            v, a, st, prog.tables, M, 25, K)


def phase_graph_dispatch(dev) -> dict:
    """The graph dispatch (csrc/dispatch_graph.cu) against the plain
    dispatch loop on seeded frontiers, one case a fused and streamed cycle
    (kernels 2, 4, 8, 9a, 9b, 9c; ``graph_cases``): one dispatch of K = 4
    cycles through the program's graph, whose body is the cycle's launches
    alone (the cycle sets the while node's condition itself: no
    dispatch_cond), and the same dispatch through the plain cycles and
    ``cycle_cond_plain``; every state word through st[ST_RUNS] and every
    live row equal, the runs equal to the cycles. One case ends its
    search before its K: its body runs no more than the cycles; one is the
    unfused cycle (M = 1024), whose body ends with dispatch_cond, against
    its cycles launched eagerly and ``cycle_cond_plain``. The
    graph's build seconds and its dispatch's CUDA-event time beside the
    plain loop's time. Then, on ta014 lb1 and N = 15, the same dispatch in
    each telemetry variant (``graph_variants``): the body's kernels, and
    armed, the counter block against the plain update over the same K
    plain cycles, slot for slot."""
    from tpu_tree_search_torch.engine.device import warmup
    from tpu_tree_search_torch.engine.resident import make_program
    from tpu_tree_search_torch.ops import cycle as C
    from tpu_tree_search_torch.ops import dispatch as D
    from tpu_tree_search_torch.pool import SoAPool
    from tpu_tree_search_torch.problems.base import index_batch

    rows = {}
    for name, prob, M, mt, source, K, full in graph_cases():
        best = getattr(prob, "initial_ub", INF)
        pool = SoAPool(prob.node_fields())
        pool.push_back(index_batch(prob.root(), 0))
        warmup(prob, pool, best, M + 517)
        fr = pool.as_batch()
        n = prob.child_slots
        # Room for K full fan-outs (ta014 lb2 with no incumbent prunes little).
        cap = 2 * fr[prob.vals_field].shape[0] + (K + 1) * M * n
        fused = source != "unfused"
        prog = make_program(prob, 25, M, K, cap, dev, mt=mt, fused=fused)
        prog.host_slots(1)
        state = prog.init_state(fr, best)
        ref = prog.init_state(fr, best)
        prog.enqueue(state)()
        g = next(iter(prog._graphs.values()))
        if fused:
            names = body_names(g)
            check(g.own_cond and names == list(GRAPH_BODY[source]),
                  f"{name}: body {names} (own condition {g.own_cond}) != the cycle's "
                  f"launches {list(GRAPH_BODY[source])}")
        else:
            names = g.kernels()[-1:]
            check(not g.own_cond and "dispatch_cond" in names[0],
                  f"{name}: the unfused body ends with {names}, not dispatch_cond")
        # The plain dispatch loop: the init node's zeroes, then the cycle
        # and the body's end while the condition holds.
        ref.st[C.ST_TREE:C.ST_CYCLES + 1] = 0
        ref.st[C.ST_RUNS] = 0
        popped = 0
        t0 = time.perf_counter()
        live = D.loop_active(ref.st.tolist(), 25, M * n, prog.capacity, K)
        while live:
            popped += min(int(ref.st[C.ST_SIZE]), M)
            plain_cycle(source, prob, prog, ref, M, mt, K)
            live = D.cycle_cond_plain(ref.st, 25, M * n, prog.capacity, K)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        words = state.st[:C.ST_RUNS + 1].tolist()
        want = ref.st[:C.ST_RUNS + 1].tolist()
        size, _, tree, _, cycles = want[:C.ST_CYCLES + 1]
        err = max(max(abs(a - b) for a, b in zip(words, want)),
                  _maxdiff(state.pool_vals[:size], ref.pool_vals[:size]),
                  _maxdiff(state.pool_aux[:size], ref.pool_aux[:size]))
        check(err == 0 and words[C.ST_RUNS] == cycles and cycles > 0
              and (cycles == K if full else cycles < K),
              f"graph dispatch {words} differs from the plain loop {want} ({name}, K={K})")
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(5):
            st0 = state.st.clone()
            a.record()
            prog.step(state)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
            state.st.copy_(st0)
        prog.close()
        # The bytes the K cycles must move: each popped row read and each
        # survivor row written once (rows and their scalar), the state.
        isz = state.pool_vals.element_size()
        bms, by = bound_ms((popped + tree) * (n + 1) * isz + 64, 0.0)
        rows[name] = dict(search=name, M=M, mt=mt, K=K, cycles=cycles, runs=words[C.ST_RUNS],
                          popped=popped, tree_inc=tree, max_abs_err=err,
                          body=names, graph_build_s=prog.graph_build_s,
                          dispatch_ms=float(np.median(times)), plain_ms=plain_ms,
                          bound_ms=bms, bound_by=by)
        if name in ("ta014_lb1", "nqueens_N15"):
            variants = graph_variants(dev, name, prob, M, None, source, K)
            rows[name].update(
                counters_max_abs_err=max(v.get("counters_max_abs_err", 0)
                                         for v in variants.values()),
                variants=variants)
        emit("graph_dispatch", **rows[name])
    return rows


# The dispatch-pipeline runs: each search at TTS_PIPELINE 1 and 2 (the
# default) and at --K auto (the default depth).
PIPELINE_RUNS = (("1", []), ("2", []), (None, ["--K", "auto"]))


def phase_pipeline(name: str, argv: list[str], golden: dict, counters: dict,
                   kernel: str, names: tuple[str, ...], per_call: int) -> list[dict]:
    """One search at each of ``PIPELINE_RUNS``: a run through the CLI (its
    goldens, dispatches, K, graph build seconds, phase 2 wall time and the
    dispatches' device time by CUDA events, with every kernel's launch
    count set to 0 just before and read just after, ``kernel``'s checked),
    then the same under the profiler (device time, busy share, and the
    trace's ``per_call`` launches of ``names`` a cycle run)."""
    import os

    out = []
    for depth, extra in PIPELINE_RUNS:
        tag = f"{name}_depth{depth}" if depth else f"{name}_Kauto"
        old = os.environ.get("TTS_PIPELINE")
        if depth:
            os.environ["TTS_PIPELINE"] = depth
        try:
            rec = phase_search(f"search_{tag}", argv + extra, counters, golden)
            check(rec["launches"][kernel] > 0 and rec["captures"][kernel] > 0
                  and rec["launches"]["dispatch_graph"] == rec["dispatches"],
                  f"{tag}: {kernel} not launched through the graph dispatch")
            prof = phase_profile(tag, argv + extra, golden,
                                 (counters[kernel], names, per_call))
        finally:
            if old is None:
                os.environ.pop("TTS_PIPELINE", None)
            else:
                os.environ["TTS_PIPELINE"] = old
        row = dict(run=tag, launches=rec["launches"],
                   pipeline_depth=rec["pipeline_depth"], K=rec["K"],
                   k_auto=rec.get("k_auto", False), dispatches=rec["dispatches"],
                   device_cycles=rec["device_cycles"], graph_build_s=rec["graph_build_s"],
                   phase2_s=rec["phases"][1][2],
                   phase2_less_build_s=rec["phases"][1][2] - rec["graph_build_s"],
                   dispatch_device_ms=rec["dispatch_device_s"] * 1e3,
                   busy_share=rec["dispatch_device_s"] / rec["phases"][1][2],
                   profiled_device_ms=prof["device_busy_ms"],
                   profiled_phase2_ms=prof["phase2_ms"],
                   profiled_busy_share=prof["busy_share"],
                   trace_complete=prof.get("trace_complete"))
        emit("pipeline", **row)
        out.append(row)
    return out


def _eval_plain(prob, dev):
    """The plain plane of ``prob``'s eval entry: lb1 or lb2 (open slots
    compared), or the N-Queens labels (every slot)."""
    from tpu_tree_search_torch.ops.nqueens_device import labels_chunk
    from tpu_tree_search_torch.ops.pfsp_device import lb1_chunk, lb2_chunk

    if prob.name == "nqueens":
        return lambda b, d: labels_chunk(b, d, prob.N, prob.g).to(torch.int32)
    tables = prob.device_tables(dev)
    bound = lb1_chunk if prob.lb == "lb1" else lb2_chunk
    return lambda p, lim: bound(p, lim, tables)


def _eval_inputs(rng, prob, dev, B: int, dtype):
    """Seeded chunk of ``prob`` on the card and its compared-slot mask:
    PFSP partial permutations (open slots), N-Queens boards (every slot)."""
    if prob.name == "nqueens":
        board, depth = random_boards(rng, prob.N, B)
        mask = torch.ones((B, prob.N), dtype=torch.bool, device=dev)
        return (torch.from_numpy(board).to(dev),
                torch.from_numpy(depth).to(dev).to(dtype), depth, mask)
    n = prob.jobs
    prmu, limit1 = random_nodes(rng, n, B)
    mask = torch.from_numpy(np.arange(n)[None, :] > limit1[:, None]).to(dev)
    return (torch.from_numpy(prmu).to(dev).to(dtype),
            torch.from_numpy(limit1).to(dev).to(dtype), limit1, mask)


def phase_eval_pass(dev, probs: dict, counters: dict) -> dict:
    """The eval-only pass through its library entries, as a user calls it:
    ``streamed_eval_bounds`` on a ta014 lb1 and an lb2 chunk of B = 49152 at
    mt = 64 and an N-Queens N = 15 chunk of B = 50000 at mt = 80, then
    ``megakernel_lb2_bounds`` on the lb2 chunk (kernels 1, 3 and 6), with
    every kernel's launch count set to 0 just before and read just after;
    each plane is then checked against the plain one."""
    from tpu_tree_search_torch.ops import tiled as T

    rng = np.random.default_rng(19)
    inputs = {fam: _eval_inputs(rng, prob, dev, 50000 if fam == "nqueens" else 49152,
                                torch.int8)
              for fam, prob in probs.items()}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    planes = {fam: T.streamed_eval_bounds(probs[fam], vals, aux,
                                          80 if fam == "nqueens" else 64)
              for fam, (vals, aux, _, _) in inputs.items()}
    vals, aux = inputs["lb2"][:2]
    planes["megakernel_lb2"] = T.megakernel_lb2_bounds(
        vals, aux, probs["lb2"].device_tables(dev))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    err = 0
    for fam, got in planes.items():
        vals, aux, _, mask = inputs["lb2" if fam == "megakernel_lb2" else fam]
        want = _eval_plain(probs["lb2" if fam == "megakernel_lb2" else fam], dev)(vals, aux)
        check(got.shape == want.shape and got.dtype == torch.int32,
              f"eval pass {fam}: shape {tuple(got.shape)} {got.dtype}")
        err = max(err, int((got[mask].long() - want[mask].long()).abs().max()))
    check(err == 0, "the eval-only pass differs from the plain planes")
    out = dict(launches=launches, seconds=seconds, max_abs_err=err,
               rows={f: int(p.shape[0]) for f, p in planes.items()})
    emit("eval_pass", **out)
    return dict(out, phase="eval_pass")


PFSP_LB1 = ["pfsp", "--inst", "14", "--lb", "lb1", "--ub", "1", "--tier", "device"]
PFSP_LB2 = ["pfsp", "--inst", "14", "--lb", "lb2", "--ub", "1", "--tier", "device"]
PFSP_LB1D = ["pfsp", "--inst", "14", "--lb", "lb1_d", "--ub", "1", "--tier", "device"]


def run_search(argv: list[str], golden: dict | None) -> dict:
    """One search through the CLI (report captured); returns its JSON
    record after checking its counts against ``golden`` (a cut: None)."""
    from tpu_tree_search_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--json"])
    check(rc == 0, f"cli {argv} returned {rc}")
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    if golden is not None:
        got = {k: rec[k] for k in golden}
        check(got == golden, f"{argv} counts {got} != golden {golden}")
    return rec


def zero_counts(counters: dict) -> None:
    """Every kernel wrapper's launch count (and graph captures) to 0."""
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "captures"):
            fn.captures = 0
    torch.cuda.synchronize()


# The reference C sequential programs' nodes/s on one core of an Intel Xeon
# @ 2.10 GHz (BASELINE.md); N-Queens' anchor is N = 15's.
C_ANCHORS = {"ta014_lb1": 927909, "ta014_lb2": 65391, "nqueens_N15": 9942907}
PFSP_SEQ = ["pfsp", "--inst", "14", "--ub", "1", "--tier", "seq"]
# The sequential runs: (name, argv, golden, C anchor).
SEQ_RUNS = [
    ("ta014_lb1", PFSP_SEQ + ["--lb", "lb1"], GOLDEN, "ta014_lb1"),
    ("ta014_lb2", PFSP_SEQ + ["--lb", "lb2"], GOLDEN_LB2, "ta014_lb2"),
    ("nqueens_N14", ["nqueens", "--N", "14", "--tier", "seq"], NQ_GOLDEN[14],
     "nqueens_N15"),
]


def phase_seq(counters: dict) -> dict:
    """The sequential tier through the CLI (``--tier seq``, the native
    runtime on the host CPU) on ta014 lb1 and lb2 ub=1 and N-Queens N = 14,
    each to its goldens, with no kernel launched; nodes/s beside the C
    anchors."""
    rows = {}
    for name, argv, golden, anchor in SEQ_RUNS:
        zero_counts(counters)
        rec = run_search(argv, golden)
        launched = {k: fn.launches for k, fn in counters.items() if fn.launches}
        check(rec["native"] and not launched,
              f"seq {name}: native {rec['native']}, kernels launched {launched}")
        nps = rec["explored_tree"] / rec["elapsed_s"]
        rows[name] = dict(elapsed_s=rec["elapsed_s"], nodes_per_s=nps,
                          c_anchor=anchor, c_anchor_nodes_per_s=C_ANCHORS[anchor],
                          over_c_anchor=nps / C_ANCHORS[anchor])
    emit("seq", host_cpu=host_cpu(), native=True, rows=rows)
    return rows


# The offload runs: (name, argv, golden, the bound wrappers a chunk launches
# once each, device_search keywords: a library run).
OFFLOAD_RUNS = [
    ("ta014_lb1", PFSP_LB1, GOLDEN, ("lb1_bounds",), {}),
    ("ta014_lb1_d", PFSP_LB1D, GOLDEN, ("lb1_d_bounds",), {}),
    ("ta014_lb2", PFSP_LB2, GOLDEN_LB2, ("lb1_bounds", "lb2_self_bounds"), {}),
    ("ta014_lb2_single_pass", PFSP_LB2, GOLDEN_LB2, ("lb2_bounds",),
     {"staged": False}),
    ("nqueens_N14", ["nqueens", "--N", "14", "--tier", "device"], NQ_GOLDEN[14],
     ("nqueens_labels",), {}),
]


def phase_offload(counters: dict, run: str = "main") -> dict:
    """The offload tier (``--engine offload``, the per-chunk host round
    trip) to the goldens, through the CLI or, for lb2's single-pass
    evaluator, through ``device_search(staged=False)``. Every kernel's
    launch count is set to 0 just before each search and read just after:
    each bound wrapper of the path launched once a chunk, every other
    kernel never. ``run`` names the pass in each line."""
    from tpu_tree_search_torch import cli
    from tpu_tree_search_torch.engine.device import device_search

    rows = {}
    for name, argv, golden, launched, kwargs in OFFLOAD_RUNS:
        argv = argv + ["--engine", "offload"]
        zero_counts(counters)
        if kwargs:
            args = cli.build_parser().parse_args(argv)
            dev = torch.device("cuda", 0)
            res = device_search(cli.make_problem(args), m=args.m,
                                M=cli.default_M(args.problem, dev.type, args.tier,
                                                args.engine),
                                device=dev, **kwargs)
            rec = dict(cli.result_record(args, res, dev), entry="device_search",
                       **kwargs)
            got = {k: rec[k] for k in golden}
            check(got == golden, f"device_search {name} counts {got} != {golden}")
        else:
            rec = run_search(argv, golden)
        launches = {k: fn.launches for k, fn in counters.items()}
        chunks = rec["chunks"]
        check(launches == {k: chunks if k in launched else 0 for k in launches},
              f"offload {name}: launches {launches} for {chunks} chunks of {launched}")
        check(rec["host_to_device"] == rec["device_to_host"] == chunks > 0,
              f"offload {name}: copies {rec['host_to_device']}, "
              f"{rec['device_to_host']} for {chunks} chunks")
        phase2_s = rec["phases"][1][2]
        rows[name] = dict(
            chunks=chunks, launches={k: launches[k] for k in launched},
            launches_per_chunk={k: 1 for k in launched},
            host_to_device=rec["host_to_device"], device_to_host=rec["device_to_host"],
            double_buffered=rec["double_buffered"], staged=rec.get("staged"),
            M=rec["M"], phases=rec["phases"], phase2_s=phase2_s,
            phase2_ms_per_chunk=1e3 * phase2_s / chunks, elapsed_s=rec["elapsed_s"],
            nodes_per_s=rec["explored_tree"] / rec["elapsed_s"],
            entry=rec.get("entry", "cli"), run=run)
        emit(f"offload_{name}", **rows[name])
    return rows


def phase_offload_profile() -> dict:
    """The staged ta014 lb2 offload once more under ``torch.profiler``: the
    device time by kernel and copy (top five) against phase 2."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rec = run_search(PFSP_LB2 + ["--engine", "offload"], GOLDEN_LB2)
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        us = ev.self_cuda_time_total if us is None else us
        if ev.device_type == DeviceType.CUDA and us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3
    busy_ms = sum(by_name.values())
    check(busy_ms > 0, "offload profile: the trace holds no device time")
    out = dict(search="offload_ta014_lb2", device_busy_ms=busy_ms,
               phase2_ms=rec["phases"][1][2] * 1e3, chunks=rec["chunks"],
               top_device_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:5]))
    emit("offload_profile", **out)
    return out


# The cut-and-resume runs: (name, argv, golden, the cycle wrapper).
CKPT_RUNS = [
    ("ta014_lb1", PFSP_LB1, GOLDEN, "cycle_lb1"),
    ("nqueens_N15_mt80", ["nqueens", "--N", "15", "--tier", "device", "--mt", "80"],
     NQ_GOLDEN[15], "tiled_nqueens"),
    ("ta014_lb2", PFSP_LB2, GOLDEN_LB2, "cycle_lb2"),
]
# The JAX package's committed cut of N-Queens N = 9 (a v1 file).
V1_FIXTURE = "tests/data/nqueens_n9_v1.ckpt.npz"
NQ9_GOLDEN = {"explored_tree": 8393, "explored_sol": 352}


def phase_checkpoint(counters: dict) -> dict:
    """Cut and resume on the resident engine through the CLI: each of
    ``CKPT_RUNS`` cut with ``--K 4 --max-steps 2 --checkpoint f``, then
    resumed with ``--resume f`` to the goldens (the cut's counts are the
    resumed run's phase 1); ta014 lb1 with ``--K 4 --checkpoint-interval
    0`` (a save after every dispatch) to the goldens; and the JAX
    package's committed v1 cut of N = 9 resumed on the card. Each save and
    load is timed, with the file's bytes."""
    import tempfile
    from pathlib import Path

    from tpu_tree_search_torch.engine import checkpoint as ckpt

    timing = {"save": [], "load": []}
    real = {"save": ckpt.save, "load": ckpt.load}

    def timed(kind):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = real[kind](*args, **kwargs)
            timing[kind].append(time.perf_counter() - t0)
            return out
        return run

    root = Path(__file__).resolve().parent
    scratch = root / "tpu_tree_search_torch" / "_build"
    scratch.mkdir(parents=True, exist_ok=True)
    rows = {}
    ckpt.save, ckpt.load = timed("save"), timed("load")
    try:
        with tempfile.TemporaryDirectory(dir=scratch) as tmp:
            for name, argv, golden, kernel in CKPT_RUNS:
                path = str(Path(tmp) / f"{name}.npz")
                for v in timing.values():
                    v.clear()
                zero_counts(counters)
                cut = run_search(argv + ["--K", "4", "--max-steps", "2",
                                         "--checkpoint", path], None)
                check(cut.get("complete") is False and cut["steps"] == 2
                      and counters[kernel].launches > 0,
                      f"cut {name}: {cut.get('complete')}, {cut['steps']} steps, "
                      f"{counters[kernel].launches} {kernel} launches")
                saves = list(timing["save"])
                cut_launches = counters[kernel].launches
                timing["load"].clear()
                zero_counts(counters)
                done = run_search(argv + ["--resume", path], golden)
                check(done["phases"][0][:2] == [cut["explored_tree"], cut["explored_sol"]]
                      and counters[kernel].launches > 0,
                      f"resume {name}: phase 1 {done['phases'][0]} against the "
                      f"cut's {cut['explored_tree']}, {cut['explored_sol']}")
                rows[name] = dict(
                    cut_tree=cut["explored_tree"], cut_sol=cut["explored_sol"],
                    cut_dispatches=cut["dispatches"], cut_launches=cut_launches,
                    resumed_launches=counters[kernel].launches,
                    resumed_tree=done["explored_tree"], resumed_sol=done["explored_sol"],
                    save_s=saves, load_s=list(timing["load"]),
                    file_bytes=Path(path).stat().st_size,
                    frontier=done["phases"][1][0] + done["phases"][2][0])
                emit(f"checkpoint_{name}", **rows[name])
            path = str(Path(tmp) / "every.npz")
            timing["save"].clear()
            rec = run_search(PFSP_LB1 + ["--K", "4", "--checkpoint", path,
                                         "--checkpoint-interval", "0"], GOLDEN)
            check(len(timing["save"]) == rec["steps"] > 1,
                  f"interval 0: {len(timing['save'])} saves in {rec['steps']} steps")
            rows["ta014_lb1_interval0"] = dict(
                steps=rec["steps"], saves=len(timing["save"]),
                save_s_total=sum(timing["save"]), save_s_max=max(timing["save"]),
                phase2_s=rec["phases"][1][2], file_bytes=Path(path).stat().st_size)
            emit("checkpoint_ta014_lb1_interval0", **rows["ta014_lb1_interval0"])
        timing["load"].clear()
        zero_counts(counters)
        rec = run_search(["nqueens", "--N", "9", "--m", "8", "--M", "64", "--K", "2",
                          "--resume", str(root / V1_FIXTURE)], NQ9_GOLDEN)
        check(rec["phases"][0][0] == 734 and counters["cycle_nqueens"].launches > 0,
              f"v1 fixture: phase 1 {rec['phases'][0]}")
        rows["jax_v1_fixture"] = dict(fixture=V1_FIXTURE, load_s=list(timing["load"]),
                                      launches=counters["cycle_nqueens"].launches,
                                      phases=rec["phases"])
        emit("checkpoint_jax_v1_fixture", **rows["jax_v1_fixture"])
    finally:
        ckpt.save, ckpt.load = real["save"], real["load"]
    return rows


# The searches whose host phases are timed: (name, argv, golden).
HOST_PHASE_RUNS = [
    ("ta014_lb1", PFSP_LB1, GOLDEN), ("ta014_lb2", PFSP_LB2, GOLDEN_LB2),
    ("nqueens_N15", ["nqueens", "--N", "15", "--tier", "device"], NQ_GOLDEN[15]),
]


def phase_host_phases() -> dict:
    """Phases 1 (the host warm-up) and 3 (the host drain) of ta014 lb1 and
    lb2 fused and N-Queens N = 15 fused, on the native runtime (A) and with
    ``TTS_NATIVE=0`` (B), in turns A B B A, each to its goldens."""
    import os

    rows = {}
    old = os.environ.get("TTS_NATIVE")
    try:
        for name, argv, golden in HOST_PHASE_RUNS:
            runs = []
            for native_on in (True, False, False, True):
                os.environ["TTS_NATIVE"] = "1" if native_on else "0"
                rec = run_search(argv, golden)
                check(rec["native"] is native_on, f"{name}: native {rec['native']}")
                (t1, _, s1), (_, _, s2), (t3, _, s3) = rec["phases"]
                runs.append(dict(native=native_on, phase1_s=s1, phase1_tree=t1,
                                 phase2_s=s2, phase3_s=s3, phase3_tree=t3,
                                 elapsed_s=rec["elapsed_s"]))
            rows[name] = runs
    finally:
        if old is None:
            os.environ.pop("TTS_NATIVE", None)
        else:
            os.environ["TTS_NATIVE"] = old
    emit("host_phases", host_cpu=host_cpu(), order="A B B A (A native, B TTS_NATIVE=0)",
         rows=rows)
    return rows


def phase_search(name: str, argv: list[str], counters: dict,
                 golden: dict = GOLDEN, **library_kwargs) -> dict:
    """Drive one search with every kernel's launch count set to 0 just
    before it, and read the counts just after. The search runs through the
    CLI, or, given ``library_kwargs``, through the library entry
    ``resident_search`` with the CLI's problem and defaults for ``argv``
    and those keyword arguments."""
    from tpu_tree_search_torch import cli
    from tpu_tree_search_torch.engine.resident import resident_search

    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "captures"):
            fn.captures = 0
    torch.cuda.synchronize()
    if library_kwargs:
        args = cli.build_parser().parse_args(argv)
        dev = torch.device("cuda", 0)
        res = resident_search(cli.make_problem(args), m=args.m,
                              M=cli.default_M(args.problem, dev.type),
                              K=cli.parse_k(args.K), device=dev, **library_kwargs)
        rec = dict(cli.result_record(args, res, dev), entry="resident_search",
                   **library_kwargs)
        got = {k: rec[k] for k in golden}
        check(got == golden, f"resident_search {argv} {library_kwargs} counts "
              f"{got} != golden {golden}")
    else:
        rec = run_search(argv, golden)
    launches = {k: fn.launches for k, fn in counters.items()}
    captures = {k: fn.captures for k, fn in counters.items()
                if getattr(fn, "captures", 0)}
    for k in captures:
        # The captured wrappers' launches are the graph bodies' runs, read
        # from the device after each dispatch: each run is one real cycle
        # (fused, or unfused: each wrapper of its body once), so they equal
        # the device cycles (plus none past termination). A stall fallback
        # adds its offload cycles to device_cycles.
        runs = launches[k]
        check(runs == rec["device_cycles"] if rec["stall_fallbacks"] == 0
              else runs <= rec["device_cycles"],
              f"{name}: {runs} {k} launches for {rec['device_cycles']} device cycles")
    dev_tree, _, dev_s = rec["phases"][1]
    out = dict(rec, launches=launches, captures=captures,
               nodes_per_s=rec["explored_tree"] / rec["elapsed_s"],
               device_nodes_per_s=dev_tree / dev_s,
               stall_fallback_ran=rec["stall_fallbacks"] > 0)
    emit(name, **out)
    return dict(out, phase=name)


def phase_profile(name: str, argv: list[str], golden: dict,
                  cycle: tuple | None = None, kernels: tuple[str, ...] = (),
                  host: bool = True, eager: bool = False,
                  **library_kwargs) -> dict:
    """One search again under ``torch.profiler``: the device time of every
    kernel and copy in the run, summed by name (the top five are printed),
    against the wall time of the device phase (phase 2). Their ratio is the
    device's busy share of that phase; the profiler's host overhead stretches
    the wall time, so the share is a lower bound. ``cycle``, (wrapper,
    kernel names, launches): the wrapper's calls in the run, the launches
    of those kernels the profiler counted, and a check that each call made
    ``launches`` of them and that no ``cycle_scan`` launch ran. ``kernels``,
    kernel names: each one's device time in the run and its launches there
    (``kernel_device_ms``, ``kernel_launches``, by name).
    ``host=False`` traces the device alone (the unfused searches' host
    trace, hundreds of thousands of events, takes minutes to read).
    ``eager`` launches the cycles from the host's loop (``eager_cycles``):
    a CUPTI trace of the unfused ta014 lb1 dispatch graph at M = 1024 ends
    in an illegal address on the H100, with kernel 1 or its plain version
    in the body alike, where the same graph untraced runs clean (the
    ``--cupti`` probes; ROADMAP C)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_tree_search_torch.ops import dispatch as D

    # dispatch_cond's launches: the body runs of the graphs it ends (none
    # where the cycle sets the condition itself).
    counters = {"dispatch_cond": D.dispatch_cond, "dispatch_init": D.dispatch_init}
    if cycle is not None:
        counters["cycle"] = cycle[0]
    activities = [ProfilerActivity.CPU] if host else []
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if eager:
            stack.enter_context(eager_cycles())
        prof = stack.enter_context(
            profile(activities=activities + [ProfilerActivity.CUDA]))
        rec = phase_search(f"{name}_profiled", argv, counters, golden,
                           **library_kwargs)
        torch.cuda.synchronize()
    by_name, counts = {}, {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        us = ev.self_cuda_time_total if us is None else us
        if ev.device_type == DeviceType.CUDA and us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3
            counts[ev.key] = counts.get(ev.key, 0) + ev.count
    busy_ms = sum(by_name.values())
    phase2_ms = rec["phases"][1][2] * 1e3
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:5])
    check(busy_ms > 0, f"{name}: the trace holds no device time")
    out = dict(search=name, eager_cycles=eager, device_busy_ms=busy_ms,
               phase2_ms=phase2_ms,
               busy_share=busy_ms / phase2_ms, top_device_ms=top, host_traced=host,
               seconds=time.perf_counter() - t0)
    if kernels:
        out.update(kernel_device_ms={kn: sum(v for k, v in by_name.items() if kn in k)
                                     for kn in kernels},
                   kernel_launches={kn: sum(c for k, c in counts.items() if kn in k)
                                    for kn in kernels})
    # The graph dispatch's own kernels (csrc/dispatch_graph.cu): one
    # dispatch_init a dispatch, one dispatch_cond a run of an unfused
    # body (a fused cycle sets the condition itself). Their device
    # time by the CUDA events around each graph launch (``dispatch_device_s``,
    # complete where the trace may not be, §3 of PERF.md) beside the trace's.
    graph = {g: (sum(v for k, v in by_name.items() if g in k),
                 sum(c for k, c in counts.items() if g in k))
             for g in ("dispatch_init", "dispatch_cond")}
    real = rec["device_cycles"]
    event_ms = (rec["dispatch_device_s"] * 1e3
                if rec.get("dispatch_device_s") is not None else None)
    out.update(dispatches=rec["dispatches"], K=rec["K"],
               graph_build_s=rec["graph_build_s"], dispatch_device_ms=event_ms,
               event_busy_share=None if event_ms is None else event_ms / phase2_ms,
               graph_kernel_ms={g: ms for g, (ms, _) in graph.items()},
               graph_kernel_launches={g: c for g, (_, c) in graph.items()},
               graph_kernel_runs={g: rec["launches"][g] for g in graph},
               cond_ms_per_cycle=graph["dispatch_cond"][0]
               / max(graph["dispatch_cond"][1], 1),
               init_ms_per_dispatch=graph["dispatch_init"][0]
               / max(graph["dispatch_init"][1], 1))
    if cycle is not None:
        _, names, per_call = cycle
        # The wrapper's launches: the graph bodies' runs, equal to the real
        # cycles (phase_search checks it), so none past termination.
        calls = rec["launches"]["cycle"]
        launches = sum(c for k, c in counts.items() if any(nm in k for nm in names))
        cycle_ms = {k: v for k, v in by_name.items() if any(nm in k for nm in names)}
        # The trace may drop events of a graph body, never add any. It is
        # complete when it holds every dispatch_init and dispatch_cond that
        # ran; then it must hold per_call launches a cycle run, exactly.
        # Where the cycle sets the condition itself, no node beside it
        # counts the body's runs: the trace's completeness is not known.
        conds = rec["launches"]["dispatch_cond"]
        lost = {"cycle": per_call * calls - launches,
                "dispatch_cond": conds - graph["dispatch_cond"][1],
                "dispatch_init": rec["dispatches"] - graph["dispatch_init"][1]}
        complete = (conds > 0 and lost["dispatch_cond"] == 0
                    and lost["dispatch_init"] == 0)
        out.update(cycle_calls=calls, cycle_captures=rec["captures"]["cycle"],
                   real_cycles=real, cycle_kernel_launches=launches,
                   launches_per_cycle=launches / max(calls, 1),
                   trace_complete=complete, trace_lost=lost,
                   cycle_device_ms=cycle_ms,
                   cycle_ms_per_traced_cycle=sum(cycle_ms.values())
                   / max(launches / per_call, 1))
        check(calls > 0 and rec["captures"]["cycle"] > 0,
              f"{name}: the cycle was not launched through the graph")
        check(min(lost.values()) >= 0 and (lost["cycle"] == 0 or not complete),
              f"{name}: the trace holds {launches} launches of {names}, "
              f"{graph} graph kernels, for {calls} cycle runs and "
              f"{rec['dispatches']} dispatches")
        check(not any("cycle_scan" in k for k in counts),
              f"{name}: a cycle_scan launch ran")
    emit("profile", **out)
    return out


# -- telemetry: the counter block and the phase clock (obs/) -------------------

# The telemetry variants, by the knobs each sets.
OBS_VARIANTS = {"off": {}, "obs": {"TTS_OBS": "1"}, "phaseprof": {"TTS_PHASEPROF": "1"}}
# The body's launches a cycle, by graph (the off body is the cycle's
# launches alone, its emit setting the loop condition; the armed ones end
# with dispatch_cond_obs; with the clock a phase_mark opens the cycle and
# follows each launch).
GRAPH_BODY = {"cycle_lb1": CYCLE_KERNELS, "cycle_lb2": LB2_CYCLE_KERNELS,
              "cycle_nqueens": NQ_CYCLE_KERNELS,
              "tiled_nqueens": TILED_KERNELS["nqueens"],
              "tiled_lb1": TILED_KERNELS["lb1"], "tiled_lb2": TILED_KERNELS["lb2"]}


@contextlib.contextmanager
def telemetry(variant: str):
    """The knobs of one telemetry variant, restored after the block."""
    import os

    keys = ("TTS_OBS", "TTS_PHASEPROF")
    prev = {k: os.environ.pop(k, None) for k in keys}
    os.environ.update(OBS_VARIANTS[variant])
    try:
        yield
    finally:
        for k in keys:
            os.environ.pop(k, None)
            if prev[k] is not None:
                os.environ[k] = prev[k]


def body_names(graph) -> list[str]:
    """The graph body's kernels by short name, in graph order."""
    shorts = {k for v in GRAPH_BODY.values() for k in v} | {
        "dispatch_cond_obs", "dispatch_cond", "phase_mark"}
    out = []
    for mangled in graph.kernels():
        hits = [k for k in shorts if k in mangled]
        out.append(max(hits, key=len) if hits else mangled)
    return out


def want_body(source: str, variant: str) -> list[str]:
    cycle = list(GRAPH_BODY[source])
    if variant == "off":
        return cycle
    if variant == "obs":
        return cycle + ["dispatch_cond_obs"]
    body = ["phase_mark"]
    for launch in cycle:
        body += [launch, "phase_mark"]
    return body + ["dispatch_cond_obs"]


def graph_variants(dev, name: str, prob, M: int, mt, source: str, K: int = 4,
                   target: int | None = None) -> dict:
    """One K-cycle graph dispatch of each telemetry variant on one warm
    frontier (``target`` nodes, default M + 517): the body's kernels
    against ``want_body`` (off: the untelemetered body, node for node),
    and, armed, the counter block against ``dispatch_cond_obs_plain`` after
    the same plain cycles, slot for slot, and the phase block
    telescoped."""
    from tpu_tree_search_torch.engine.device import warmup
    from tpu_tree_search_torch.engine.resident import make_program
    from tpu_tree_search_torch.obs import phases as OP
    from tpu_tree_search_torch.ops import cycle as C
    from tpu_tree_search_torch.ops import cycle_nqueens as CN
    from tpu_tree_search_torch.ops import dispatch as D
    from tpu_tree_search_torch.ops import tiled as T
    from tpu_tree_search_torch.pool import SoAPool
    from tpu_tree_search_torch.problems.base import index_batch

    best = getattr(prob, "initial_ub", INF)
    pool = SoAPool(prob.node_fields())
    pool.push_back(index_batch(prob.root(), 0))
    warmup(prob, pool, best, M + 517 if target is None else target)
    fr = pool.as_batch()
    n = prob.child_slots
    out = {}
    for variant in OBS_VARIANTS:
        with telemetry(variant):
            prog = make_program(prob, 25, M, K, 2 * fr[prob.vals_field].shape[0] + 2 * M * n,
                                dev, mt=mt)
        prog.host_slots(1)
        state = prog.init_state(fr, best)
        ref = prog.init_state(fr, best)
        got = prog.enqueue(state)(full=True)
        g = next(iter(prog._graphs.values()))
        names = body_names(g)
        outer = g.kernels(body=False)
        check(names == want_body(source, variant),
              f"{name} {variant}: body {names} != {want_body(source, variant)}")
        check(len(outer) == (3 if variant == "phaseprof" else 2),
              f"{name} {variant}: graph nodes {outer}")
        row = dict(body_nodes=len(names), graph_nodes=len(outer), cycles=got.cycles,
                   event_ms=got.device_ms)
        if variant != "off":
            ref.st[C.ST_TREE:C.ST_CYCLES + 1] = 0
            for _ in range(K):
                if source == "cycle_nqueens":
                    CN.cycle_nqueens_plain(ref.pool_vals, ref.pool_aux, ref.st, prob.N,
                                           prob.g, M, 25, K)
                elif source == "tiled_nqueens":
                    T.tiled_nqueens_plain(ref.pool_vals, ref.pool_aux, ref.st, prob, M, mt,
                                          25, K)
                else:
                    (C.cycle_lb1_plain if source == "cycle_lb1" else C.cycle_lb2_plain)(
                        ref.pool_vals, ref.pool_aux, ref.st, prog.tables, M, 25, K)
                if not int(ref.st[C.ST_ACTIVE]):
                    break
                D.dispatch_cond_obs_plain(ref.st, n, 25, M * n, prog.capacity, K)
            want = ref.st[C.ST_CTR:C.ST_CTR + 8].tolist()
            err = max(abs(a - b) for a, b in zip(got.ctr, want))
            check(err == 0 and got.cycles == int(ref.st[C.ST_CYCLES]) > 0,
                  f"{name} {variant}: counter block {got.ctr} != plain {want}")
            row.update(counters=got.ctr, counters_max_abs_err=err)
        if variant == "phaseprof":
            ph = got.ph
            tele = sum(ph[OP.IDX[s]] for s in OP.CYCLE_SLOTS) - ph[OP.IDX["total"]]
            check(tele == 0 and min(ph[:OP.NSLOTS]) >= 0,
                  f"{name}: phase block {ph} does not telescope")
            row.update(phases=OP.as_args(ph))
        prog.close()
        out[variant] = row
    emit("graph_variants", search=name, M=M, mt=mt, K=K, **out)
    return out


def phase_mark_replay(dev, marks: int = 64) -> dict:
    """``phase_mark`` against its plain arithmetic (``phase_mark_at``) on the
    same readings: a sequence of marks on the card (a seed, then cycles of
    loop, eval, compact, push), each reading copied out after its mark;
    the plain arithmetic replayed on those readings must give the card's
    block exactly."""
    from tpu_tree_search_torch.obs import phases as OP
    from tpu_tree_search_torch.ops import dispatch as D

    clk = D.new_clock(dev)
    log = torch.zeros(marks + 1, dtype=torch.int64, device=dev)
    seq = [(0, OP.SEED)]
    cycle = [(OP.IDX["loop"], OP.OPEN), (OP.IDX["eval"], 0), (OP.IDX["compact"], 0),
             (OP.IDX["push"], OP.CLOSE)]
    while len(seq) < marks + 1:
        seq += cycle
    seq = seq[:1 + (marks // 4) * 4]
    for i, (slot, flags) in enumerate(seq):
        D.phase_mark_cuda(clk, slot, flags)
        log[i].copy_(clk[OP.TPREV])
    torch.cuda.synchronize()
    reads = log.tolist()
    v = [0] * OP.BLOCK_LEN
    for (slot, flags), now in zip(seq, reads):
        v = D.phase_mark_at(v, slot, flags, now)
    err = max(abs(a - b) for a, b in zip(clk.tolist(), v))
    check(err == 0, f"phase_mark differs from its plain arithmetic by {err}")
    return dict(marks=len(seq), max_abs_err=err)


def phase_obs(dev, counters: dict) -> dict:
    """The telemetry phase (obs/): every search of ``OBS_RUNS`` at full
    width in the turns off, obs, phaseprof, off, to its golden, with the
    launches of the counter kernel and the marks counted from 0; the
    counter invariants (pushed and leaves = phase 2's tree and sol; on the
    fused cycles overflow 0 and push_rows = cycles*M*n), the telescoped
    phase total, no roofline row above 100%; the body graphs of the fused
    ta014 lb2 and the streamed N-Queens; ``phase_mark`` against its plain
    arithmetic; the %globaltimer step; the two kernels' device time under
    the profiler; and a CLI ``--trace`` run whose ``report`` exits 0 and
    whose ``explored`` samples sum to its counts."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from tpu_tree_search_torch import cli
    from tpu_tree_search_torch.obs import export as OE
    from tpu_tree_search_torch.obs import phases as OP
    from tpu_tree_search_torch.obs import report as OR
    from tpu_tree_search_torch.obs import roofline as ORL
    from tpu_tree_search_torch.ops import dispatch as D
    from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem

    timer = D.globaltimer_step_ns(dev)
    emit("globaltimer", **timer)
    replay = phase_mark_replay(dev)
    # (ta014 lb2's warm-up frontier never reaches M nodes.)
    graphs = {"ta014_lb2": graph_variants(dev, "ta014_lb2", PFSPProblem(inst=14, lb="lb2", ub=1),
                                          49152, None, "cycle_lb2", target=2000),
              "nqueens_N15_mt80": graph_variants(dev, "nqueens_N15_mt80", NQueensProblem(15),
                                                 50000, 80, "tiled_nqueens")}
    runs, launches = {}, {}
    for name, argv, golden, fused in OBS_RUNS:
        for turn, variant in enumerate(("off", "obs", "phaseprof", "off")):
            zero_counts(counters)
            with telemetry(variant):
                rec = run_search(argv, golden)
            launches[(name, variant, turn)] = {
                "dispatch_cond_obs": counters["dispatch_cond_obs"].launches,
                "phase_mark": counters["phase_mark"].launches}
            p2_tree, p2_sol, p2_s = rec["phases"][1]
            row = dict(search=name, variant=variant, turn=turn, phase2_s=p2_s,
                       event_ms=(rec["dispatch_device_s"] * 1e3
                                 if rec.get("dispatch_device_s") is not None else None),
                       dispatches=rec["dispatches"], device_cycles=rec["device_cycles"],
                       launches=launches[(name, variant, turn)])
            check(("obs" in rec) is (variant != "off"), f"{name} {variant}: obs record")
            if variant != "off":
                c = rec["obs"]["device_counters"]
                if rec["stall_fallbacks"] == 0:
                    check(c["pushed"] == p2_tree and c["leaves"] == p2_sol,
                          f"{name} {variant}: counters {c} != phase 2 ({p2_tree}, {p2_sol})")
                check(min(c.values()) >= 0, f"{name} {variant}: a negative slot")
                if fused:
                    n = 20 if name.startswith("ta") else 15
                    Mn = rec["M"] * n
                    check(c["overflow"] == 0 and c["push_rows"] == rec["device_cycles"] * Mn,
                          f"{name} {variant}: fused overflow/push_rows {c}")
                    check(launches[(name, variant, turn)]["dispatch_cond_obs"]
                          == rec["device_cycles"],
                          f"{name} {variant}: dispatch_cond_obs launches")
                row["counters"] = c
            if variant == "phaseprof":
                ph = rec["obs"]["device_phases"]
                check(sum(ph[s] for s in OP.CYCLE_SLOTS) == ph["total"] > 0
                      and min(ph.values()) >= 0, f"{name}: phases {ph} do not telescope")
                roof = rec["roofline_mem"]
                check(all(r.get("pct_of_peak", 0.0) <= 100.0 for r in roof["phases"]),
                      f"{name}: a roofline row above 100%: {roof}")
                check(launches[(name, variant, turn)]["phase_mark"] > 0,
                      f"{name}: no phase_mark launched")
                row.update(decomp=OP.decomp(ph), roofline=roof,
                           roofline_table=ORL.table(roof))
            runs[(name, variant, turn)] = row
            emit("obs", **row)
    # The two kernels' device time a launch: the phase-profiled N = 15
    # search under the profiler.
    with telemetry("phaseprof"):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run_search(["nqueens", "--N", "15", "--tier", "device"], NQ_GOLDEN[15])
            torch.cuda.synchronize()
    prof_ms = {}
    for kname in ("dispatch_cond_obs", "phase_mark"):
        us = cnt = 0
        for ev in prof.key_averages():
            if kname in ev.key:
                t = getattr(ev, "device_time_total", None)
                us += ev.cuda_time_total if t is None else t
                cnt += ev.count
        prof_ms[kname] = (us / cnt / 1e3 if cnt else None, cnt)
    # The plain versions' time a call (the host-driven arithmetic).
    from tpu_tree_search_torch.ops import cycle as C

    st = torch.zeros(C.ST_LEN, dtype=torch.int32, device=dev)
    st[C.ST_SIZE], st[C.ST_CNT] = 100000, 49152
    plain_cond_ms = median_ms(lambda: D.dispatch_cond_obs_plain(st, 20, 25, 983040,
                                                                1 << 24, 4096), 20)
    clk_cpu = D.new_clock("cpu")
    t0 = time.perf_counter()
    for _ in range(200):
        D.phase_mark_plain(clk_cpu, 1)
    plain_mark_ms = (time.perf_counter() - t0) / 200 * 1e3
    # A traced CLI run: its trace reads in `report`, and its explored
    # samples sum to its counts.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.json")
        rec = run_search(PFSP_LB1 + ["--trace", path], GOLDEN)
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["report", path, "--json"])
        evts, warn = OE.load_trace_lenient(path)
        tree = sum(e["args"]["tree"] for e in evts if e["name"] == "explored")
        sol = sum(e["args"]["sol"] for e in evts if e["name"] == "explored")
        summary = OR.summarize(evts)
    check(rc == 0 and warn is None, "report on the --trace file failed")
    check((tree, sol) == (rec["explored_tree"], rec["explored_sol"]),
          f"trace explored ({tree}, {sol}) != the run's counts")
    emit("obs_trace", events=len(evts), explored=[tree, sol],
         device_counters=summary["device_counters"],
         dispatches=sum(1 for e in evts if e["name"] == "dispatch"))
    return dict(runs=runs, launches=launches, graphs=graphs, replay=replay, timer=timer,
                prof_ms=prof_ms, plain_cond_ms=plain_cond_ms, plain_mark_ms=plain_mark_ms)


# The telemetry phase's searches: (name, argv, golden, fused cycle).
OBS_RUNS = [
    ("ta014_lb1", PFSP_LB1, GOLDEN, True),
    ("nqueens_N15", ["nqueens", "--N", "15", "--tier", "device"], NQ_GOLDEN[15], True),
    ("ta014_lb2", PFSP_LB2, GOLDEN_LB2, True),
    ("nqueens_N15_mt80", ["nqueens", "--N", "15", "--tier", "device", "--mt", "80"],
     NQ_GOLDEN[15], True),
    ("nqueens_N14_unfused", ["nqueens", "--N", "14", "--tier", "device", "--unfused"],
     NQ_GOLDEN[14], False),
    ("ta014_lb2_staged_unfused", PFSP_LB2 + ["--unfused"], GOLDEN_LB2, False),
]


def main_cycles(dev, dev_info) -> int:
    """``--cycles``: only the fused cycles (kernels 2, 4 and 8) and the
    streamed ones (9a, 9b and 9c) against their plain versions, and the
    ta014 lb1 and N-Queens N = 15 searches and the streamed N-Queens, lb2
    and lb1 searches under the profiler with their launches a cycle; the
    last line says which phases ran."""
    from tpu_tree_search_torch.ops import cycle as C
    from tpu_tree_search_torch.ops import cycle_nqueens as CN
    from tpu_tree_search_torch.ops import tiled as T
    from tpu_tree_search_torch.problems import PFSPProblem

    tables = PFSPProblem(inst=14, lb="lb1", ub=1).device_tables(dev)
    phase_pfsp_cycle("kernel2", dev, tables, "lb1", 1)
    phase_pfsp_cycle("kernel2", dev, PFSPProblem(inst=51, lb="lb1", ub=1).device_tables(dev),
                     "lb1", 51, dtype=torch.int32, inst="ta051")
    phase_kernel4(dev)
    phase_pfsp_cycle("kernel8", dev, PFSPProblem(inst=14, lb="lb2", ub=1).device_tables(dev),
                     "lb2", 8)
    ta021 = PFSPProblem(inst=21, lb="lb2", ub=1).device_tables(dev)
    phase_pfsp_cycle("kernel8", dev, ta021, "lb2", 21, inst="ta021")
    phase_pfsp_cycle("kernel9", dev, tables, "lb1", 9, tiled=True)
    phase_kernel4(dev, "kernel10", tiled=True)
    phase_pfsp_cycle("kernel11", dev, PFSPProblem(inst=14, lb="lb2", ub=1).device_tables(dev),
                     "lb2", 11, tiled=True, shapes=((1024, 16), (49152, 64), (49152, 8)))
    phase_pfsp_cycle("kernel11", dev, ta021, "lb2", 111, tiled=True, inst="ta021",
                     shapes=((49152, 64),))
    phase_profile("search_fused_M49152", PFSP_LB1, GOLDEN,
                  (C.cycle_lb1_cuda, CYCLE_KERNELS, 3))
    phase_profile("search_fused_M1024", PFSP_LB1 + ["--M", "1024"], GOLDEN,
                  (C.cycle_lb1_cuda, CYCLE_KERNELS, 3))
    phase_profile("search_nqueens_N15_fused", ["nqueens", "--N", "15", "--tier", "device"],
                  NQ_GOLDEN[15], (CN.cycle_nqueens_cuda, NQ_CYCLE_KERNELS, 2))
    phase_profile("search_nqueens_N15_tiled",
                  ["nqueens", "--N", "15", "--tier", "device", "--mt", "80"], NQ_GOLDEN[15],
                  (T.tiled_nqueens_cuda, TILED_KERNELS["nqueens"], 2))
    phase_profile("search_lb2_tiled_M49152", PFSP_LB2 + ["--mt", "64"], GOLDEN_LB2,
                  (T.tiled_lb2_cuda, TILED_KERNELS["lb2"], 3))
    phase_profile("search_lb1_tiled_M49152", PFSP_LB1 + ["--mt", "64"], GOLDEN,
                  (T.tiled_lb1_cuda, TILED_KERNELS["lb1"], 3))
    print(json.dumps({"ok": True, "phases": "cycles", "device": dev_info}), flush=True)
    return 0


# -- the batched engine and the serve daemon -----------------------------------


def _frontier(prob, target: int) -> dict:
    """A host frontier of ``prob`` warmed up to at least ``target`` nodes."""
    from tpu_tree_search_torch.engine.device import warmup
    from tpu_tree_search_torch.pool import SoAPool
    from tpu_tree_search_torch.problems.base import index_batch

    pool = SoAPool(prob.node_fields())
    pool.push_back(index_batch(prob.root(), 0))
    warmup(prob, pool, getattr(prob, "initial_ub", INF), target)
    return pool.as_batch()


def _maxdiff(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest absolute difference of two integer tensors (0 when
    empty)."""
    return int((a.int() - b.int()).abs().max()) if a.numel() else 0


def phase_batch_graph(dev) -> dict:
    """The batched graph's own kernels (csrc/dispatch_graph.cu: batch_init,
    batch_cond, batch_cond_obs) at ta014 lb1, M = 49152, K = 4, B = 4: slot
    0 a frontier of M + 517 nodes, slot 1 one of 2M + 1000, slot 2 empty,
    slot 3 ten nodes (below m: retired). One batched dispatch, telemetry
    off and with the counter block, against (a) the same batch through the
    plain versions on the card's tensors (batch_init_plain, the plain
    cycles, batch_cond_plain): every word of every slot and the live rows;
    (b) B solo K = 4 dispatches of the program's graph: the counts, every
    word but ST_ACTIVE (the cycle's own flag: a frozen slot's cycle clears
    it, a solo graph never launches one) and the live rows. Max difference
    0. Times: the batched dispatch (CUDA events), the live slots' solo
    dispatches, the plain versions; the nodes' device time a launch
    (profiler); and a frozen slot's cost a cycle: the batch with only slot
    0 live against slot 0's solo dispatch, over K cycles of 3 frozen
    slots."""
    from tpu_tree_search_torch.engine.batched import make_batched_program
    from tpu_tree_search_torch.engine.resident import make_program
    from tpu_tree_search_torch.ops import cycle as C
    from tpu_tree_search_torch.ops import dispatch as D
    from tpu_tree_search_torch.problems import PFSPProblem

    K, M, B, n, m = 4, 49152, 4, 20, 25
    prob = PFSPProblem(inst=14, lb="lb1", ub=1)
    best = prob.initial_ub
    fr = _frontier(prob, M + 517)
    fr2 = _frontier(prob, 2 * M + 1000)
    low = {k: v[:10] for k, v in fr.items()}
    fronts = [fr, fr2, None, low]
    cap = 2 * fr2["prmu"].shape[0] + 2 * M * n
    rows = {}
    for variant in ("off", "obs"):
        obs = variant == "obs"
        with telemetry(variant):
            bp = make_batched_program(prob, B, m, M, K, cap, dev)
            solo = make_program(prob, m, M, K, cap, dev)

            def load(fs=fronts):
                for i, f in enumerate(fs):
                    bp.make_slot(i, f, best if f is not None else 0)

            load()
            torch.cuda.synchronize()
            ref_st = bp.st.clone()
            ref_pools = [(s.pool_vals.clone(), s.pool_aux.clone()) for s in bp.states]
            cond = D.batch_cond_obs if obs else D.batch_cond
            for w in (C.cycle_lb1_cuda, D.batch_init, cond):
                w.launches = 0
            reads = bp.step()
            cycles = [r[2] for r in reads]
            check(C.cycle_lb1_cuda.launches == sum(cycles) and cycles[0] == K
                  and cycles[2:] == [0, 0],
                  f"batched launches {C.cycle_lb1_cuda.launches} != cycles {cycles}")
            check(D.batch_init.launches == 1 and cond.launches == max(cycles),
                  "batch_init/batch_cond launches != 1 / the rounds")
            # (a) the plain versions on the card's tensors.
            t0 = time.perf_counter()
            live = D.batch_init_plain(ref_st, m, M * n, cap, K, obs)
            rounds = 0
            while live and rounds < K:
                for i, (pv, pa) in enumerate(ref_pools):
                    C.cycle_lb1_plain(pv, pa, ref_st[i], bp.inner.tables, M, m, K)
                live = D.batch_cond_plain(ref_st, n if obs else 0, m, M * n, cap, K)
                rounds += 1
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err_plain = _maxdiff(bp.st, ref_st)
            for i, (pv, pa) in enumerate(ref_pools):
                size = reads[i][3]
                err_plain = max(err_plain, _maxdiff(bp.states[i].pool_vals[:size], pv[:size]),
                                _maxdiff(bp.states[i].pool_aux[:size], pa[:size]))
            # (b) B solo dispatches of the program's graph.
            solo.host_slots(1)
            words = [w for w in range(C.ST_LEN) if w != C.ST_ACTIVE]
            err_solo = 0
            solo_states = []
            for i, f in enumerate(fronts):
                if f is None:
                    err_solo = max(err_solo, reads[i][3])
                    continue
                state = solo.init_state(f, best)
                got = solo.enqueue(state)()
                solo_states.append(state)
                size = reads[i][3]
                err_solo = max(err_solo, max(abs(a - b) for a, b in zip(got, reads[i][:5])),
                               _maxdiff(bp.st[i, words], state.st[words]),
                               _maxdiff(bp.states[i].pool_vals[:size],
                                        state.pool_vals[:size]),
                               _maxdiff(bp.states[i].pool_aux[:size], state.pool_aux[:size]))
            check(err_plain == 0 and err_solo == 0,
                  f"batched dispatch ({variant}) differs: plain {err_plain}, solo {err_solo}")
            g = bp.graph()
            body = g.kernels()
            batch_ms = median_ms(g.launch, 5, setup=load)

            def reload_solo():
                for st_, f in zip(solo_states, (fr, fr2)):
                    solo.load_state(st_, f, best)

            solo_ms = median_ms(lambda: [solo._graph(st_).launch() for st_ in solo_states],
                                5, setup=reload_solo)
            node_ms, timing = kernel_device_ms(
                g.launch, 5, ("batch_init", cond.__name__), setup=load)
            node_ms_each = dict(LAST_LAUNCH_MS)
            # A frozen slot's cost: only slot 0 live.
            lone = [fr, None, None, None]
            batch1_ms = median_ms(g.launch, 5, setup=lambda: load(lone))
            solo1_ms = median_ms(lambda: solo._graph(solo_states[0]).launch(), 5,
                                 setup=lambda: solo.load_state(solo_states[0], fr, best))
            frozen_us = (batch1_ms - solo1_ms) * 1e3 / (K * (B - 1))
            # The plain nodes alone on the card's states.
            st_p = bp.st.clone()
            init_plain_ms = median_ms(lambda: D.batch_init_plain(st_p, m, M * n, cap, K, obs), 5)
            cond_plain_ms = median_ms(
                lambda: D.batch_cond_plain(st_p, n if obs else 0, m, M * n, cap, K), 5)
            bp.close()
            solo.close()
        rows[variant] = dict(
            variant=variant, B=B, K=K, M=M, cycles=cycles, rounds=max(cycles),
            max_abs_err=max(err_plain, err_solo), err_plain=err_plain, err_solo=err_solo,
            body_nodes=len(body), graph_build_s=bp.graph_build_s,
            batch_dispatch_ms=batch_ms, solo_dispatches_ms=solo_ms, plain_ms=plain_ms,
            node_ms=node_ms_each, node_timing=timing,
            init_plain_ms=init_plain_ms, cond_plain_ms=cond_plain_ms,
            frozen_slot_us_per_cycle=frozen_us, lone_batch_ms=batch1_ms,
            lone_solo_ms=solo1_ms)
        emit("batch_graph", **rows[variant])
    return rows


def _serve_call(base: str, path: str, payload=None, timeout: float = 60.0):
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _serve_wait(base: str, ids: list, timeout_s: float = 300.0) -> list:
    deadline = time.monotonic() + timeout_s
    recs = []
    for jid in ids:
        while True:
            _, rec = _serve_call(base, f"/job/{jid}")
            if rec["state"] in ("done", "failed", "cancelled"):
                break
            check(time.monotonic() < deadline, f"serve job {jid} did not finish")
            time.sleep(0.02)
        check(rec["state"] == "done", f"serve job {jid}: {rec['state']} {rec.get('error')}")
        recs.append(rec)
    return recs


def _submit_together(d, specs: list) -> list:
    """Admit ``specs`` through the daemon's own admission path (what POST
    /submit calls) while the scheduler's queue lock is held, so that a
    worker sees them all queued at once (a batch forms; a waiter exists
    before the first job's first dispatch)."""
    ids = []
    with d.scheduler._cv:
        for spec in specs:
            payload, code = d.submit(dict(spec))
            check(code == 201, f"submit {spec}: {code} {payload}")
            ids.append(payload["id"])
    return ids


SERVE_LB1 = {"problem": "pfsp", "inst": 14, "lb": "lb1", "ub": 1}
SERVE_LB2 = {"problem": "pfsp", "inst": 14, "lb": "lb2", "ub": 1}
SERVE_NQ15 = {"problem": "nqueens", "N": 15}


def phase_serve(dev, counters: dict) -> dict:
    """The port's serve daemon on the card, in-process on a free localhost
    port with ``--batch-slots 4`` (``ServeDaemon``), every job at full
    width and default M: four ta014 lb1 ub=1 jobs through one batch (kernel
    2 captured a slot), two N = 15 jobs (kernel 4) and two ta014 lb2 jobs
    (kernel 8), each to its goldens; the counts set to 0 just before each
    batch and read just after: each cycle kernel's launches equal the
    jobs' summed device cycles, ``batch_init`` and ``batch_cond`` launched;
    graph builds on the first admission and 0 on the later ones. Then a
    solo ta014 lb1 job at K = 4 that a quantum of 0 s and a waiting job
    preempt at least once, resumed to its goldens, and a second job of its
    class: zero new programs and graphs. Per job: wall and queue wait.
    Beside the batch: the same four jobs as four solo searches in turn
    (``resident_search``; dispatches, device ms by CUDA events, graph
    build seconds cold and warm)."""
    import tempfile
    import threading

    from tpu_tree_search_torch.engine.resident import release_programs, resident_search
    from tpu_tree_search_torch.problems import PFSPProblem
    from tpu_tree_search_torch.serve.pool import identity_key
    from tpu_tree_search_torch.serve.server import ServeDaemon, wait_ready

    golden = {"lb1": (2573652, 2648, 1377), "lb2": (144639, 0, 1377),
              "nq15": (171129071, 2279184, None)}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = ServeDaemon(port=0, state_dir=tmp, batch_slots=4, quantum_s=5.0)
        d._http_thread = threading.Thread(target=d._httpd.serve_forever,
                                          kwargs={"poll_interval": 0.2}, daemon=True)
        d._http_thread.start()
        base = d.url
        check(wait_ready(base, 30) is not None, "serve daemon did not answer")
        started = False
        try:
            for name, spec, jobs, kernel in (("lb1", SERVE_LB1, 4, "cycle_lb1"),
                                             ("nq15", SERVE_NQ15, 2, "cycle_nqueens"),
                                             ("lb2", SERVE_LB2, 2, "cycle_lb2")):
                zero_counts(counters)
                t0 = time.perf_counter()
                if not started:
                    # Over HTTP; the queue holds the batch before the worker
                    # starts.
                    ids = []
                    for _ in range(jobs):
                        code, sub = _serve_call(base, "/submit", spec)
                        check(code == 201, f"submit {spec}: {code} {sub}")
                        ids.append(sub["id"])
                    d.scheduler.start()
                    started = True
                else:
                    ids = _submit_together(d, [spec] * jobs)
                recs = _serve_wait(base, ids)
                wall = time.perf_counter() - t0
                torch.cuda.synchronize()
                launches = {k: fn.launches for k, fn in counters.items()}
                cycles = [r["result"]["device_cycles"] for r in recs]
                for r in recs:
                    res = r["result"]
                    got = (res["explored_tree"], res["explored_sol"],
                           res["best"] if golden[name][2] is not None else None)
                    check(got == golden[name], f"serve {name}: {got} != {golden[name]}")
                check(launches[kernel] == sum(cycles) and launches[kernel] > 0,
                      f"serve {name}: {kernel} launches {launches[kernel]} != cycles {cycles}")
                check(launches["batch_init"] > 0 and launches["batch_cond"] > 0,
                      f"serve {name}: the batched graph's nodes not launched")
                check(recs[0]["new_step_compiles"] >= 1
                      and all(r["new_step_compiles"] == 0 and r["new_programs"] == 0
                              for r in recs[1:]),
                      f"serve {name}: graphs built on a later admission")
                problem = d.pool._problems[identity_key(recs[0]["spec"])]
                (bp,) = problem._batched_programs.values()
                out[name] = dict(
                    jobs=jobs, wall_s=wall, device_cycles=cycles,
                    launches={k: launches[k] for k in (kernel, "batch_init", "batch_cond")},
                    batched_dispatches=launches["batch_init"],
                    batch_device_ms=bp.dispatch_device_s * 1e3,
                    batch_graph_build_s=bp.graph_build_s,
                    graphs_built=[r["new_step_compiles"] for r in recs],
                    new_programs=[r["new_programs"] for r in recs],
                    job_wall_s=[r["result"]["elapsed_s"] for r in recs],
                    queue_wait_s=[r["started"] - r["submitted"] for r in recs])
                emit("serve", phase_of="batch", run=name, **out[name])
            # A solo job preempted by a waiter (quantum 0), then a second job
            # of its class.
            d.scheduler.quantum_s = 0.0
            pre = dict(SERVE_LB1, K=4)
            waiter = dict(SERVE_LB1, M=1024)
            zero_counts(counters)
            ids = _submit_together(d, [pre, waiter])
            recs = _serve_wait(base, ids)
            for r in recs:
                res = r["result"]
                check((res["explored_tree"], res["explored_sol"], res["best"])
                      == golden["lb1"], f"preempted serve job: {res}")
            check(recs[0]["preemptions"] >= 1, "the quantum-0 job was not preempted")
            d.scheduler.quantum_s = 5.0
            _, again = _serve_call(base, "/submit", pre)
            (rec2,) = _serve_wait(base, [again["id"]])
            check(again["warm"] and rec2["new_programs"] == 0
                  and rec2["new_step_compiles"] == 0,
                  f"second same-class job built {rec2['new_programs']} programs, "
                  f"{rec2['new_step_compiles']} graphs")
            res = rec2["result"]
            check((res["explored_tree"], res["explored_sol"], res["best"]) == golden["lb1"],
                  "second same-class job missed its goldens")
            out["preempt"] = dict(
                preemptions=recs[0]["preemptions"], slices=recs[0]["slices"],
                waiter_preemptions=recs[1]["preemptions"],
                job_wall_s=[r["result"]["elapsed_s"] for r in recs],
                second_job=dict(new_programs=rec2["new_programs"],
                                graphs_built=rec2["new_step_compiles"],
                                wall_s=res["elapsed_s"],
                                queue_wait_s=rec2["started"] - rec2["submitted"]))
            emit("serve", phase_of="preempt", **out["preempt"])
            _, classes = _serve_call(base, "/classes")
            out["metrics_lines"] = len(metrics_text(base).splitlines())
        finally:
            d.scheduler.drain(timeout_s=60.0)
            d.close()
    # The four ta014 lb1 jobs as four solo searches in turn, on one problem:
    # the first builds its graph (cold), the others reuse it (warm).
    prob = PFSPProblem(inst=14, lb="lb1", ub=1)
    solo = []
    for _ in range(4):
        t0 = time.perf_counter()
        res = resident_search(prob, m=25, M=49152, device=dev)
        solo.append(dict(wall_s=time.perf_counter() - t0, dispatches=res.dispatches,
                         device_ms=res.dispatch_device_s * 1e3,
                         graph_build_s=res.graph_build_s,
                         device_cycles=res.diagnostics.kernel_launches))
        check((res.explored_tree, res.explored_sol, res.best) == golden["lb1"],
              "solo ta014 lb1 missed its goldens")
    check(solo[0]["graph_build_s"] > 0 and all(r["graph_build_s"] == 0 for r in solo[1:]),
          "a warm solo search built a graph")
    release_programs(prob)
    out["solo_lb1"] = dict(
        runs=solo, dispatches=sum(r["dispatches"] for r in solo),
        device_ms=sum(r["device_ms"] for r in solo), wall_s=sum(r["wall_s"] for r in solo),
        graph_build_s_cold=solo[0]["graph_build_s"],
        graph_build_s_warm=[r["graph_build_s"] for r in solo[1:]])
    emit("serve", phase_of="solo_in_turn", **out["solo_lb1"],
         batch_dispatches=out["lb1"]["batched_dispatches"],
         batch_device_ms=out["lb1"]["batch_device_ms"], batch_wall_s=out["lb1"]["wall_s"])
    out["classes"] = classes
    out["launches"] = out["lb1"]["launches"]
    return out


def metrics_text(base: str) -> str:
    """The daemon's /metrics text, checked by its own parser (which raises
    on a malformed line)."""
    import urllib.request

    from tpu_tree_search_torch.serve.metrics import parse_text

    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        text = r.read().decode()
    parse_text(text)
    return text


def graph_node_rows(dev, gd: dict, fused: dict, nq15: dict, unfused: dict,
                    profs: dict, prof_nq14: dict) -> list[dict]:
    """The kernels line's rows of the dispatch graph's own nodes (not TPU
    kernels: the JAX ``lax.while_loop``'s init and ``cond``). ``dispatch_init``
    once a dispatch on the fused ta014 lb1 search; ``dispatch_cond`` once a
    cycle of an unfused body (the fused cycles set the condition
    themselves: no launch on their searches), its time on the unfused N=14
    search. Plain versions on the card's state; max diff: the K = 4 graph
    dispatches' state words against the plain dispatch loop (phase
    graph_dispatch; ``dispatch_cond``: its unfused case)."""
    from tpu_tree_search_torch.ops import cycle as C
    from tpu_tree_search_torch.ops import dispatch as D

    st = C.new_state(60000, INF, dev)
    Mn, cap = 49152 * 20, 1 << 22

    def init_plain():
        st[C.ST_TREE:C.ST_CYCLES + 1] = 0
        st[C.ST_RUNS] = 0
        D.loop_active(st.tolist(), 25, Mn, cap, 4)

    init_ms = median_ms(init_plain, 20)
    cond_ms = median_ms(lambda: D.cycle_cond_plain(st, 25, Mn, cap, 1 << 30), 20)
    err = {"dispatch_init": max(r["max_abs_err"] for r in gd.values()),
           "dispatch_cond": gd["ta014_lb1_unfused"]["max_abs_err"]}
    fprof = profs["search_fused_M49152"]
    rows = []
    for name, launches, path, ms, timing, nbytes, replaces, extra in [
            ("dispatch_init", fused["launches"]["dispatch_init"], "search_fused_M49152",
             fprof["init_ms_per_dispatch"],
             f"profiler ({fprof['graph_kernel_launches']['dispatch_init']} launches, "
             "search_fused_M49152)",
             # Reads size and cycles, writes tree, sol, cycles and runs.
             6 * 4, "tpu_tree_search/engine/resident.py:438", {}),
            ("dispatch_cond", unfused["launches"]["dispatch_cond"], "search_unfused_M1024",
             prof_nq14["cond_ms_per_cycle"],
             f"profiler ({prof_nq14['graph_kernel_launches']['dispatch_cond']} launches, "
             "search_nqueens_N14_unfused)",
             # Reads size, cycles and runs, writes runs.
             4 * 4, "tpu_tree_search/engine/resident.py:421",
             {"fused_launches": {"search_fused_M49152": fused["launches"]["dispatch_cond"],
                                 "search_nqueens_N15_fused":
                                     nq15["launches"]["dispatch_cond"]},
              "fused_traced_launches": {n: r["graph_kernel_launches"]["dispatch_cond"]
                                        for n, r in profs.items()}})]:
        bms, by = bound_ms(nbytes, 0.0)
        rows.append({"name": name, "route": "cuda",
                     "source": "tpu_tree_search_torch/csrc/dispatch_graph.cu",
                     "replaces": replaces, "launches": launches, "launches_path": path,
                     "shape": "one thread, the loop state's int32 words",
                     "max_abs_err": err[name], "ms": ms, "timing": timing,
                     "plain_ms": init_ms if name == "dispatch_init" else cond_ms,
                     "bound_ms": bms, "bound_by": by, "library_ms": None, **extra})
    return rows


def batch_kernel_rows(bg: dict, serve: dict) -> list[dict]:
    """The kernels line's rows of the batched graph's nodes (not TPU
    kernels: the counterparts of the JAX batched while loop's init and
    OR-of-conds), shaped like the dispatch_cond_obs row; their launches are
    the serve phase's batched ta014 lb1 run's."""
    B = bg["off"]["B"]
    # Bytes a launch must move, a slot: batch_init reads size and cycles and
    # writes tree, sol, cycles and runs (the counter block's 10 words too
    # with TTS_OBS=1); batch_cond reads active, size and cycles and
    # writes runs.
    init_bms, init_by = bound_ms(B * 6 * 4, 0.0)
    cond_bms, cond_by = bound_ms(B * 4 * 4, 0.0)
    rows = []
    for name, replaces, bms, by, plain_key in (
            ("batch_init", "tpu_tree_search/engine/batched.py:135", init_bms, init_by,
             "init_plain_ms"),
            ("batch_cond", "tpu_tree_search/engine/batched.py:120", cond_bms, cond_by,
             "cond_plain_ms")):
        off = bg["off"]
        rows.append({
            "name": name, "route": "cuda",
            "source": "tpu_tree_search_torch/csrc/dispatch_graph.cu",
            "replaces": replaces,
            "launches": serve["launches"][name],
            "launches_path": "serve batched ta014 lb1 (4 jobs, B=4)",
            "shape": f"one block of {B} threads, the ({B}, 32) int32 slot states",
            "max_abs_err": max(r["max_abs_err"] for r in bg.values()),
            "ms": off["node_ms"].get(name), "timing": off["node_timing"],
            "plain_ms": off[plain_key], "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "obs_ms": bg["obs"]["node_ms"].get("batch_cond_obs" if name == "batch_cond"
                                               else name),
            "frozen_slot_us_per_cycle": off["frozen_slot_us_per_cycle"]})
    return rows


def main_serve(dev, dev_info) -> int:
    """``--serve``: only this slice's path (the batched graph's kernels and
    the serve phase) after the build."""
    counters = kernel_counters()
    bg = phase_batch_graph(dev)
    serve = phase_serve(dev, counters)
    print(json.dumps({"kernels": batch_kernel_rows(bg, serve)}), flush=True)
    print(json.dumps({"ok": True, "phases": "serve", "device": dev_info}), flush=True)
    return 0


# -- the multi-device tiers (parallel/) -------------------------------------------

# The multi and mesh runs: (name, argv, golden, the kernels of the multi
# tier's offload, the mesh's cycle wrapper).
NQ15 = ["nqueens", "--N", "15", "--tier", "device"]
PARALLEL_RUNS = [
    ("ta014_lb1", PFSP_LB1, GOLDEN, ("lb1_bounds",), "cycle_lb1"),
    ("ta014_lb2", PFSP_LB2, GOLDEN_LB2, ("lb1_bounds", "lb2_self_bounds"),
     "cycle_lb2"),
    ("nqueens_N15", NQ15, NQ_GOLDEN[15], ("nqueens_labels",), "cycle_nqueens"),
]


def _mesh_balance_state(dev, D: int, C: int, n: int, sizes: list[int],
                        seed: int):
    """Seeded (D, ST_LEN) states with ``sizes``, random incumbents and
    counts, and random (D, C, n) int8 rows and (D, C) int8 column."""
    from tpu_tree_search_torch.ops.cycle import ST_LEN

    g = torch.Generator().manual_seed(seed)
    st = torch.randint(0, 1000, (D, ST_LEN), generator=g, dtype=torch.int32)
    st[:, 0] = torch.tensor(sizes, dtype=torch.int32)
    st[:, 1] = torch.randint(1000, 2000, (D,), generator=g, dtype=torch.int32)
    vals = torch.randint(0, n, (D, C, n), generator=g, dtype=torch.int8)
    aux = torch.randint(-1, n - 1, (D, C), generator=g, dtype=torch.int8)
    return st.to(dev), vals.to(dev), aux.to(dev)


def phase_mesh_balance(dev) -> dict:
    """``mesh_balance`` (csrc/mesh_balance.cu: the plan, the move and the
    shed) against ``mesh_balance_plain`` on the same seeded states, every
    word of every shard and every live row: D = 1 (the fold alone), D = 2
    with a gift, D = 2 where the gift is T and the donor's kept rows
    overlap the rows they move to (the staging copy), D = 4 with two gifts,
    D = 4 with none, first and last rounds; and the main path's shape, ta014
    at the mesh's defaults (D = 4, C = 2,097,152, M = 50,000, T = 8,192):
    a gift of T rows from a shard of 300,000 to a starving one. Times at that
    shape, with and without the gift: the three launches' device time
    (profiler), the call (events), the plain version; the bound by bytes
    (the states read and written, the gift's rows read and written, the
    donor's kept rows read and written once)."""
    from tpu_tree_search_torch.ops import mesh as MS
    from tpu_tree_search_torch.ops.cycle import ST_LEN

    cases = [
        ("d1_fold", 1, 4096, 20, 25, 1024, 2000, [3000], True, True),
        ("d2_gift", 2, 10000, 20, 25, 1024, 2000, [5000, 3], True, False),
        ("d2_T_overlap", 2, 10000, 15, 25, 1024, 2000, [3000, 0], False, True),
        ("d4_two_gifts", 4, 20000, 20, 25, 4096, 5000, [9000, 10, 80, 0], False,
         False),
        ("d4_no_gift", 4, 20000, 20, 25, 4096, 5000, [900, 100, 60, 50], True,
         True),
        ("d8_four_gifts", 8, 20000, 15, 25, 4096, 5000,
         [9000, 0, 3000, 5, 900, 0, 1500, 1], True, False),
        ("ta014_gift", 4, 2097152, 20, 25, 8192, 50000 * 20,
         [300000, 10, 200000, 150000], True, False),
        ("ta014_no_gift", 4, 2097152, 20, 25, 8192, 50000 * 20,
         [300000, 100000, 200000, 150000], True, False),
    ]
    rows = {}
    for i, (name, D, C, n, m, T, Mn, sizes, first, last) in enumerate(cases):
        st, vals, aux = _mesh_balance_state(dev, D, C, n, sizes, 15 + i)
        scratch = MS.MeshScratch.make(vals, aux)
        st0, vals0, aux0 = st.clone(), vals.clone(), aux.clone()
        give, take = MS.balance_plan(sizes, m, T, Mn, C)
        MS.mesh_balance_cuda(st, vals, aux, scratch, m, T, Mn, first, last)
        torch.cuda.synchronize()
        pst, pvals, paux = st0.clone(), vals0.clone(), aux0.clone()
        t0 = time.perf_counter()
        MS.mesh_balance_plain(pst, pvals, paux, m, T, Mn, first, last)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = _maxdiff(st, pst)
        for d in range(D):
            size = int(pst[d, 0])
            err = max(err, _maxdiff(vals[d, :size], pvals[d, :size]),
                      _maxdiff(aux[d, :size], paux[d, :size]))
        check(err == 0, f"mesh_balance {name} differs from its plain version: {err}")
        row = dict(D=D, C=C, n=n, sizes=sizes, give=give, take=take,
                   new_sizes=pst[:, 0].tolist(), first=first, last=last,
                   max_abs_err=err, plain_ms=plain_ms)
        if name.startswith("ta014"):
            def reload(st0=st0, vals0=vals0, aux0=aux0, st=st, vals=vals, aux=aux):
                st.copy_(st0)
                vals.copy_(vals0)
                aux.copy_(aux0)

            def call(st=st, vals=vals, aux=aux, scratch=scratch, m=m, T=T, Mn=Mn):
                MS.mesh_balance_cuda(st, vals, aux, scratch, m, T, Mn, True, False)

            names = ("mesh_plan",) if D == 1 else ("mesh_plan", "mesh_move", "mesh_shed")
            ms, timing = kernel_device_ms(call, 5, names, setup=reload)
            row.update(ms=ms, timing=timing, launch_ms=dict(LAST_LAUNCH_MS),
                       call_ms=median_ms(call, 5, setup=reload))
            rowb = n + 1  # an int8 row and its int8 column
            # The least traffic: a donor's kept rows read and written once,
            # the gift read and written once (counted at its receiver).
            moved = sum(2 * (s - g) * rowb for g, s in zip(give, sizes) if g)
            moved += sum(2 * t * rowb for t in take)
            row["bound_ms"], row["bound_by"] = bound_ms(
                2 * D * ST_LEN * 4 + moved, 0.0)
            row["bytes"] = 2 * D * ST_LEN * 4 + moved
        del st, vals, aux, scratch, st0, vals0, aux0, pst, pvals, paux
        torch.cuda.empty_cache()
        rows[name] = row
        emit("mesh_balance", case=name, **row)
    return rows


def _plain_mesh_dispatch(prog, st, vals, aux, cycle_plain) -> None:
    """One mesh dispatch of ``prog``'s configuration through the plain
    versions on the given tensors: per round ``batch_init_plain``, the
    shards' plain cycles until no shard is live, ``mesh_balance_plain``."""
    from tpu_tree_search_torch.ops import dispatch as Dp
    from tpu_tree_search_torch.ops import mesh as MS

    m, Mn, C, K = prog.m, prog.Mn, prog.capacity, prog.K
    for r in range(prog.rounds):
        live = Dp.batch_init_plain(st, m, Mn, C, K, False)
        for _ in range(K):
            if not live:
                break
            for d in range(prog.D):
                cycle_plain(vals[d], aux[d], st[d])
            live = Dp.batch_cond_plain(st, 0, m, Mn, C, K)
        MS.mesh_balance_plain(st, vals, aux, m, prog.T, Mn, r == 0,
                              r == prog.rounds - 1)


def phase_mesh_dispatch(dev) -> dict:
    """One mesh dispatch (``MeshGraph``: rounds of ``batch_init``, the
    shards' cycles under a while node, ``mesh_balance``) against the same
    dispatch through the plain versions on the card's tensors, at D = 4,
    K = 4, 2 rounds: ta014 lb1 (kernel 2, M = 49152) and N-Queens N = 15
    (kernel 4, M = 50000), the shards loaded with a frontier of 2M + 1000
    nodes, one of 10 (below m: it starves, and takes a gift), one of
    M + 517 and an empty one. Every word of every shard and every live row;
    the dispatch's counts and launches; its time (events), the plain
    version's, and the graph's build seconds and nodes."""
    from tpu_tree_search_torch.ops import cycle as C
    from tpu_tree_search_torch.ops import cycle_nqueens as CN
    from tpu_tree_search_torch.ops import mesh as MS
    from tpu_tree_search_torch.ops.cycle import new_state
    from tpu_tree_search_torch.parallel.resident_mesh import MeshProgram
    from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem

    D, K, rounds, m = 4, 4, 2, 25
    rows = {}
    for name, prob, M in (("ta014_lb1", PFSPProblem(inst=14, lb="lb1", ub=1), 49152),
                          ("nqueens_N15", NQueensProblem(15), 50000)):
        n = prob.child_slots
        best = getattr(prob, "initial_ub", INF)
        fr = _frontier(prob, 2 * M + 1000)
        fronts = [fr, {k: v[:10] for k, v in fr.items()},
                  {k: v[:M + 517] for k, v in fr.items()}, None]
        cap = 2 * fr[prob.vals_field].shape[0] + 2 * M * n
        T = max(2 * m, min(M, 8192))
        prog = MeshProgram(prob, D, m, M, K, rounds, T, cap, dev)
        if name == "ta014_lb1":
            tables = prog.inner.tables

            def cycle_plain(v, a, s, M=M):
                C.cycle_lb1_plain(v, a, s, tables, M, m, prog.K)
            wrapper = C.cycle_lb1_cuda
        else:
            def cycle_plain(v, a, s, M=M, N=prob.N):
                CN.cycle_nqueens_plain(v, a, s, N, 1, M, m, prog.K)
            wrapper = CN.cycle_nqueens_cuda

        def load():
            for d, f in enumerate(fronts):
                if f is None:
                    prog.st[d].copy_(new_state(0, best, dev))
                else:
                    prog.inner.load_state(prog.states[d], f, best)

        load()
        torch.cuda.synchronize()
        ref = (prog.st.clone(), prog.pool_vals.clone(), prog.pool_aux.clone())
        prog.host_slots(1)
        for w in (wrapper, MS.mesh_balance_cuda):
            w.launches = 0
        graphs0 = MS.MeshGraph.launches
        rows_read, _, dispatch_ms = prog.enqueue()()
        cycles = [r[C.ST_CYCLES] for r in rows_read]
        check(wrapper.launches == sum(cycles) > 0
              and MS.mesh_balance_cuda.launches == rounds
              and MS.MeshGraph.launches == graphs0 + 1,
              f"mesh dispatch {name}: launches {wrapper.launches} for cycles "
              f"{cycles}, balance {MS.mesh_balance_cuda.launches}")
        t0 = time.perf_counter()
        _plain_mesh_dispatch(prog, *ref, cycle_plain)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = _maxdiff(prog.st, ref[0])
        for d in range(D):
            size = int(ref[0][d, 0])
            err = max(err, _maxdiff(prog.pool_vals[d, :size], ref[1][d, :size]),
                      _maxdiff(prog.pool_aux[d, :size], ref[2][d, :size]))
        check(err == 0, f"mesh dispatch {name} differs from the plain one: {err}")
        g = prog.graph()
        call_ms = median_ms(g.launch, 3, setup=load)
        rows[name] = dict(D=D, K=prog.K, rounds=rounds, M=M, T=T, capacity=cap,
                          cycles=cycles, sizes=[r[0] for r in rows_read],
                          tree=[r[2] for r in rows_read], max_abs_err=err,
                          dispatch_ms=dispatch_ms, call_ms=call_ms,
                          plain_ms=plain_ms, graph_build_s=prog.graph_build_s,
                          body_nodes=len(g.kernels()), graph_nodes=len(g.kernels(False)))
        emit("mesh_dispatch", case=name, **rows[name])
        prog.close()
        del ref
        torch.cuda.empty_cache()
    return rows


def phase_multi(counters: dict, Ds=(2, 4)) -> dict:
    """The multi tier (``--tier multi --D D``: D worker threads on the one
    card, each on its own stream) on ta014 lb1 and lb2 ub=1 and N-Queens
    N = 15 to their goldens, and ta014 lb1 at D = 1 too (the offload tier's
    structure in one worker). Every count set to 0 just before each search
    and read just after: each bound wrapper of the path launched once a
    chunk, every other kernel never. Each line: the per-worker trees and
    shares, steals, chunks, copies, phase seconds."""
    rows = {}
    runs = [(1, PARALLEL_RUNS[0])] + [(D, r) for D in Ds for r in PARALLEL_RUNS]
    for D, (name, argv, golden, launched, _) in runs:
        zero_counts(counters)
        rec = run_search(argv + ["--tier", "multi", "--D", str(D)], golden)
        launches = {k: fn.launches for k, fn in counters.items()}
        chunks = rec["chunks"]
        check(launches == {k: chunks if k in launched else 0 for k in launches},
              f"multi {name} D={D}: launches {launches} for {chunks} chunks")
        check(len(rec["per_worker_tree"]) == D, f"multi {name}: workers")
        rows[(name, D)] = dict(
            D=D, chunks=chunks, launches={k: launches[k] for k in launched},
            per_worker_tree=rec["per_worker_tree"],
            workload_shares=rec["workload_shares"], steals=rec.get("steals", 0),
            host_to_device=rec["host_to_device"],
            double_buffered=rec["double_buffered"], phases=rec["phases"],
            phase2_s=rec["phases"][1][2], elapsed_s=rec["elapsed_s"],
            nodes_per_s=rec["explored_tree"] / rec["elapsed_s"])
        emit(f"multi_{name}_D{D}", **rows[(name, D)])
    return rows


def phase_mesh(counters: dict, Ds=(2, 4)) -> dict:
    """The mesh tier (``--tier mesh --D D``: D shards on the one card, one
    CUDA graph a dispatch) on ta014 lb1 and lb2 ub=1 and N-Queens N = 15 to
    their goldens, the counts set to 0 just before each search: the cycle
    wrapper launched once a cycle (the shards' summed cycles), the balance
    step twice a dispatch (two rounds), one graph a dispatch. Each line:
    device time (events), dispatches, graph build seconds, per-shard trees.
    Then a second ta014 lb1 D = 4 search of the same problem object builds
    no graph (the program cache)."""
    from tpu_tree_search_torch.parallel.resident_mesh import mesh_resident_search
    from tpu_tree_search_torch.problems import PFSPProblem

    rows = {}
    for D in Ds:
        for name, argv, golden, _, cycle in PARALLEL_RUNS:
            zero_counts(counters)
            rec = run_search(argv + ["--tier", "mesh", "--D", str(D)], golden)
            launches = {k: fn.launches for k, fn in counters.items()}
            disp = rec["dispatches"]
            check(launches[cycle] == rec["device_cycles"] > 0
                  and launches["mesh_balance"] == 2 * disp
                  and launches["mesh_graph"] == disp,
                  f"mesh {name} D={D}: launches {launches}, dispatches {disp}, "
                  f"cycles {rec['device_cycles']}")
            check(len(rec["per_worker_tree"]) == D, f"mesh {name}: shards")
            rows[(name, D)] = dict(
                D=D, dispatches=disp, device_cycles=rec["device_cycles"], K=rec["K"],
                launches={k: v for k, v in launches.items() if v},
                dispatch_device_ms=1e3 * rec["dispatch_device_s"],
                graph_build_s=rec["graph_build_s"],
                per_worker_tree=rec["per_worker_tree"],
                workload_shares=rec["workload_shares"],
                stall_fallbacks=rec["stall_fallbacks"], phases=rec["phases"],
                phase2_s=rec["phases"][1][2], elapsed_s=rec["elapsed_s"])
            emit(f"mesh_{name}_D{D}", **rows[(name, D)])
    prob = PFSPProblem(inst=14, lb="lb1", ub=1)
    dev = torch.device("cuda", 0)
    first = mesh_resident_search(prob, M=50000, D=4, device=dev)
    second = mesh_resident_search(prob, M=50000, D=4, device=dev)
    for res in (first, second):
        got = {"explored_tree": res.explored_tree, "explored_sol": res.explored_sol,
               "optimum": res.best}
        check(got == GOLDEN, f"mesh warm search counts {got}")
    (prog,) = prob._mesh_programs.values()
    check(first.graph_build_s > 0 and second.graph_build_s == 0
          and len(prog._graphs) == 1,
          f"a second mesh search built graphs: {second.graph_build_s} s, "
          f"{len(prog._graphs)} graphs")
    rows["warm"] = dict(first_graph_build_s=first.graph_build_s,
                        second_graph_build_s=second.graph_build_s,
                        graphs=len(prog._graphs),
                        first_device_ms=1e3 * first.dispatch_device_s,
                        second_device_ms=1e3 * second.dispatch_device_s)
    emit("mesh_warm", **rows["warm"])
    return rows


# The multi-host tiers' virtual hosts: two hosts of two workers or shards.
HOSTS = ["--hosts", "2", "--D", "2"]
NQ14 = ["nqueens", "--N", "14", "--tier", "device"]
# The dist runs: (name, argv, golden, bound wrappers launched, --no-steal).
DIST_RUNS = [
    ("ta014_lb1", PFSP_LB1, GOLDEN, ("lb1_bounds",), False),
    ("ta014_lb2", PFSP_LB2, GOLDEN_LB2, ("lb1_bounds", "lb2_self_bounds"), False),
    ("nqueens_N14", NQ14, NQ_GOLDEN[14], ("nqueens_labels",), False),
    ("ta014_lb1_nosteal", PFSP_LB1, GOLDEN, ("lb1_bounds",), True),
]


def comm_stats(rec: dict) -> dict:
    """A multi-host record's communicator totals (summed over the hosts)
    and the mean ms of one exchange allgather round."""
    c = rec.get("comm")
    if not c:
        return {"comm": None}
    return {"exchange_rounds": c["rounds"], "blocks_sent": c["blocks_sent"],
            "nodes_sent": c["nodes_sent"],
            "blocks_received": c["blocks_received"],
            "nodes_received": c["nodes_received"],
            "allgather_ms_mean": (1e3 * c["exchange_s"] / c["rounds"]
                                  if c["rounds"] else None)}


def phase_dist(counters: dict) -> dict:
    """``--tier dist --hosts 2 --D 2`` (two virtual hosts, threads on
    ``ThreadCollectives``, of two offload workers each, all on the one card)
    on ta014 lb1 and lb2 ub=1 and N-Queens N = 14 to their goldens, and ta014
    lb1 with ``--no-steal``. The counts set to 0 just before each search and
    read just after: each bound wrapper of the path launched once a chunk
    (the chunks of both hosts), every other kernel never. Each line: phase 2
    seconds, the exchange rounds, blocks and nodes sent, the mean ms of an
    exchange allgather, per-worker trees."""
    rows = {}
    for name, argv, golden, launched, nosteal in DIST_RUNS:
        zero_counts(counters)
        rec = run_search(argv + ["--tier", "dist"] + HOSTS
                         + (["--no-steal"] if nosteal else []), golden)
        launches = {k: fn.launches for k, fn in counters.items()}
        chunks = rec["chunks"]
        check(launches == {k: chunks if k in launched else 0 for k in launches},
              f"dist {name}: launches {launches} for {chunks} chunks")
        check(rec["hosts"] == 2 and len(rec["per_worker_tree"]) == 4
              and (rec.get("comm") is None) == nosteal,
              f"dist {name}: hosts {rec['hosts']}, comm {rec.get('comm')}")
        rows[(name, 2)] = dict(
            hosts=2, D=2, chunks=chunks,
            launches={k: launches[k] for k in launched},
            per_worker_tree=rec["per_worker_tree"], steals=rec.get("steals", 0),
            phases=rec["phases"], phase2_s=rec["phases"][1][2],
            elapsed_s=rec["elapsed_s"], **comm_stats(rec))
        emit(f"dist_{name}_H2D2", **rows[(name, 2)])
    return rows


def phase_dist_mesh(counters: dict) -> dict:
    """``--tier dist_mesh --hosts 2 --D 2`` (two virtual hosts, a mesh of two
    shards each on the one card, a stream and a program each) on ta014 lb1
    and lb2 ub=1 and N-Queens N = 15 to their goldens, the counts set to 0
    just before each search: the cycle wrapper launched once a cycle (both
    hosts' shards' cycles), the balance step twice a dispatch, one graph a
    dispatch. Each line: device ms (CUDA events around each graph launch,
    summed over the hosts), dispatches, exchange rounds, donations, the mean
    ms of an exchange allgather. Then a lockstep cut (``--K 4 --max-steps 2
    --checkpoint``) of ta014 lb1 and its resume to the goldens."""
    import tempfile
    from pathlib import Path

    rows = {}
    for name, argv, golden, _, cycle in PARALLEL_RUNS:
        zero_counts(counters)
        rec = run_search(argv + ["--tier", "dist_mesh"] + HOSTS, golden)
        launches = {k: fn.launches for k, fn in counters.items()}
        disp = rec["dispatches"]
        check(launches[cycle] == rec["device_cycles"] > 0
              and launches["mesh_balance"] == 2 * disp
              and launches["mesh_graph"] == disp,
              f"dist_mesh {name}: launches {launches}, dispatches {disp}, "
              f"cycles {rec['device_cycles']}")
        check(rec["hosts"] == 2 and len(rec["per_worker_tree"]) == 4,
              f"dist_mesh {name}: {rec['hosts']} hosts")
        rows[(name, 2)] = dict(
            hosts=2, D=2, dispatches=disp, device_cycles=rec["device_cycles"],
            K=rec["K"], launches={k: v for k, v in launches.items() if v},
            dispatch_device_ms=1e3 * rec["dispatch_device_s"],
            graph_build_s=rec["graph_build_s"],
            per_worker_tree=rec["per_worker_tree"],
            stall_fallbacks=rec["stall_fallbacks"], phases=rec["phases"],
            phase2_s=rec["phases"][1][2], elapsed_s=rec["elapsed_s"],
            **comm_stats(rec))
        emit(f"dist_mesh_{name}_H2D2", **rows[(name, 2)])
    root = Path(__file__).resolve().parent
    scratch = root / "tpu_tree_search_torch" / "_build"
    scratch.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        path = str(Path(tmp) / "dmesh.npz")
        argv = PFSP_LB1 + ["--tier", "dist_mesh"] + HOSTS
        zero_counts(counters)
        cut = run_search(argv + ["--K", "4", "--max-steps", "2",
                                 "--checkpoint", path], None)
        tags = []
        for h in (0, 1):
            with np.load(f"{path}.h{h}") as data:
                tags.append(json.loads(bytes(data["header"]).decode())["cut_tag"])
        check(cut.get("complete") is False and tags[0] == tags[1] is not None
              and counters["cycle_lb1"].launches > 0,
              f"dist_mesh cut: complete {cut.get('complete')}, tags {tags}")
        zero_counts(counters)
        done = run_search(argv + ["--resume", path], GOLDEN)
        check(counters["cycle_lb1"].launches == done["device_cycles"] > 0,
              "dist_mesh resume: cycles not launched")
        rows["cut"] = dict(cut_tree=cut["explored_tree"], cut_sol=cut["explored_sol"],
                           cut_dispatches=cut["dispatches"], cut_tag=tags[0],
                           resumed_tree=done["explored_tree"],
                           resumed_sol=done["explored_sol"],
                           resumed_dispatches=done["dispatches"])
        emit("dist_mesh_cut_resume", **rows["cut"])
    return rows


def phase_dist_procs() -> dict:
    """Process mode: for ``--tier dist`` and ``--tier dist_mesh``, two
    processes of ``python -m tpu_tree_search_torch pfsp --inst 14 --lb lb1
    --ub 1 --tier T --distributed --coordinator 127.0.0.1:<free port>
    --num-hosts 2 --host-id h --D 1 --json`` (a ``TCPStore`` on loopback,
    rank 0 hosting it; both on the one card, each its own CUDA context).
    Each rank's record hits the goldens. Each line: each rank's phase 2
    seconds, chunks or device cycles, and (dist_mesh) device ms, and the
    exchange rounds, donations and the mean ms of a ``TorchCollectives``
    allgather round."""
    import os
    import socket
    from pathlib import Path

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    rows = {}
    for tier in ("dist", "dist_mesh"):
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        argv = [sys.executable, "-m", "tpu_tree_search_torch", "pfsp", "--inst", "14",
                "--lb", "lb1", "--ub", "1", "--tier", tier, "--distributed",
                "--coordinator", f"127.0.0.1:{port}", "--num-hosts", "2",
                "--D", "1", "--json"]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(argv + ["--host-id", str(h)], cwd=root, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for h in (0, 1)]
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=300)
                outs.append((p.returncode, out, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        recs = []
        for h, (rc, out, err) in enumerate(outs):
            check(rc == 0, f"{tier} rank {h} exited {rc}: {err[-1500:]}")
            rec = json.loads(out.strip().splitlines()[-1])
            got = {k: rec[k] for k in GOLDEN}
            check(got == GOLDEN and rec["host_id"] == h,
                  f"{tier} rank {h} counts {got} != golden {GOLDEN}")
            recs.append(rec)
        work = "chunks" if tier == "dist" else "device_cycles"
        rows[tier] = dict(
            wall_s=time.perf_counter() - t0,
            phase2_s=[r["phases"][1][2] for r in recs],
            elapsed_s=recs[0]["elapsed_s"], **{work: recs[0][work]},
            per_worker_tree=recs[0]["per_worker_tree"], **comm_stats(recs[0]))
        if tier == "dist_mesh":
            rows[tier]["dispatch_device_ms"] = 1e3 * recs[0]["dispatch_device_s"]
        emit(f"{tier}_procs_ta014_lb1", **rows[tier])
    return rows


def mesh_kernel_row(bal: dict, disp: dict, mesh: dict) -> dict:
    """The kernels line's row of the balance step (not a TPU kernel: the
    JAX ``pmin`` and ring diffusion, XLA collectives); its launches are
    the mesh D = 4 ta014 lb1 search's."""
    main = bal["ta014_gift"]
    return {
        "name": "mesh_balance", "route": "cuda",
        "source": "tpu_tree_search_torch/csrc/mesh_balance.cu",
        "replaces": "tpu_tree_search/parallel/resident_mesh.py:200",
        "launches": mesh[("ta014_lb1", 4)]["launches"]["mesh_balance"],
        "launches_path": "mesh ta014_lb1 D=4",
        "shape": "ta014 D=4 C=2097152 M=50000 T=8192, a gift of T rows",
        "max_abs_err": max([r["max_abs_err"] for r in bal.values()]
                           + [r["max_abs_err"] for r in disp.values()]),
        "ms": main["ms"], "timing": main["timing"], "call_ms": main["call_ms"],
        "launch_ms": main["launch_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None, "no_gift_ms": bal["ta014_no_gift"]["ms"],
        "no_gift_bound_ms": bal["ta014_no_gift"]["bound_ms"],
        "dispatch": disp}


def main_parallel(dev, dev_info) -> int:
    """``--parallel``: only this slice's path (the balance step, one mesh
    dispatch against the plain one, the multi and mesh tiers) after the
    build."""
    counters = kernel_counters()
    bal = phase_mesh_balance(dev)
    disp = phase_mesh_dispatch(dev)
    phase_multi(counters)
    mesh = phase_mesh(counters)
    phase_dist(counters)
    phase_dist_mesh(counters)
    phase_dist_procs()
    print(json.dumps({"kernels": [mesh_kernel_row(bal, disp, mesh)]}), flush=True)
    print(json.dumps({"ok": True, "phases": "parallel", "device": dev_info}), flush=True)
    return 0


def main_dist(dev_info) -> int:
    """``--dist``: only the multi-host tiers after the build (virtual hosts
    of both tiers, the cut and its resume, then two processes of each)."""
    counters = kernel_counters()
    phase_dist(counters)
    phase_dist_mesh(counters)
    phase_dist_procs()
    print(json.dumps({"ok": True, "phases": "dist", "device": dev_info}), flush=True)
    return 0


# The guarded runs (phase 18h): (name, argv, golden). The K values give
# each run several steady-state dispatches (ta014 lb1 at the default K is
# two dispatches).
GUARD_RUNS = [
    ("ta014_lb1_K4", PFSP_LB1 + ["--K", "4"], GOLDEN),
    ("nqueens_N15", NQ15 + ["--K", "512"], NQ_GOLDEN[15]),
    ("ta014_lb2_K4", PFSP_LB2 + ["--K", "4"], GOLDEN_LB2),
    ("mesh_D2_ta014_lb1", PFSP_LB1 + ["--tier", "mesh", "--D", "2", "--K", "4"],
     GOLDEN),
]


@contextlib.contextmanager
def _patched(cls, name: str, fn):
    """``cls.name`` replaced by ``fn(original)`` for the block."""
    orig = getattr(cls, name)
    setattr(cls, name, fn(orig))
    try:
        yield
    finally:
        setattr(cls, name, orig)


def _tamper_raises(what: str, run) -> str:
    """``run()`` must raise ``GuardViolation``; returns its message."""
    from tpu_tree_search_torch.analysis.guard import GuardViolation

    try:
        run()
    except GuardViolation as e:
        torch.cuda.synchronize()
        return str(e)
    raise RuntimeError(f"chip_smoke check failed: {what} raised no GuardViolation")


def _guard_row(name: str, runs: dict, median) -> dict:
    """One guard_* line from a configuration's unguarded ("off") and
    guarded ("on") runs, in run order, after checking that every guarded
    run checked more than one dispatch with the sync check armed."""
    for on in runs["on"]:
        g = on.get("guard") or {}
        check(g.get("checked_dispatches", 0) > 1 and "sync" in g.get("checks", ()),
              f"guard {name}: {g}")
    check(all(off.get("guard") is None for off in runs["off"]),
          f"guard {name}: an unguarded run guarded")
    on = runs["on"][0]
    row = dict(guard=on["guard"], dispatches=on["dispatches"],
               launches=on["launches"])
    for mode, sfx in (("on", ""), ("off", "_unguarded")):
        phase2 = [r["phases"][1][2] for r in runs[mode]]
        row["phase2_s" + sfx] = phase2
        row["phase2_median_s" + sfx] = median(phase2)
        row["dispatch_device_ms" + sfx] = [1e3 * r["dispatch_device_s"]
                                           for r in runs[mode]]
        row["gc_ms" + sfx] = [r["gc_ms"] for r in runs[mode]]
    return row


def phase_guard(counters: dict) -> dict:
    """The steady-state guard (``--guard``, ``analysis/guard.py``) on the
    card: ta014 lb1 at K = 4, N = 15, ta014 lb2 at K = 4 and the mesh at
    D = 2 on ta014 lb1, each at full width and default M: a first run
    builds the program, then unguarded and guarded twice over (A B B A A B
    B A), each to its goldens, the guarded ones with more than one checked
    steady-state dispatch (the sync check armed); phase 2, the device ms
    and the garbage collector's pauses (ms) of each, and each mode's
    median phase 2. Two tampers must raise ``GuardViolation`` naming the dispatch: a
    ``.item()`` on a CUDA tensor slipped into each enqueue (a hook around
    the program's ``enqueue``), and a steady-state dispatch that builds a
    new graph (the program's graph cache emptied at the second dispatch).
    Then a guarded unfused N = 14 search to its goldens: its cycle of fixed
    shapes reads nothing back, its dispatch is one graph launch, and the
    guard checks every dispatch after the first."""
    from tpu_tree_search_torch.engine import resident as R
    from tpu_tree_search_torch.engine.resident import resident_search
    from tpu_tree_search_torch.problems import NQueensProblem

    import gc
    import statistics

    gc_s = [0.0, None]  # the pauses' sum, the open pause's start

    def gc_clock(stage, _info):
        if stage == "start":
            gc_s[1] = time.perf_counter()
        elif gc_s[1] is not None:
            gc_s[0] += time.perf_counter() - gc_s[1]
            gc_s[1] = None

    rows = {}
    gc.callbacks.append(gc_clock)
    try:
        for name, argv, golden in GUARD_RUNS:
            run_search(argv, golden)  # builds the program and its graph
            runs = {"off": [], "on": []}
            for mode in ("off", "on", "on", "off") * 2:  # A B B A A B B A, warm
                zero_counts(counters)
                gc_s[0] = 0.0
                rec = run_search(argv + (["--guard"] if mode == "on" else []),
                                 golden)
                rec["gc_ms"] = 1e3 * gc_s[0]
                rec["launches"] = {k: fn.launches for k, fn in counters.items()
                                   if fn.launches}
                runs[mode].append(rec)
            rows[name] = _guard_row(name, runs, statistics.median)
            emit(f"guard_{name}", **rows[name])
    finally:
        gc.callbacks.remove(gc_clock)
    dev = torch.device("cuda", 0)

    def sync_hook(orig):
        def enqueue(self, state):
            read = orig(self, state)
            state.st[0].item()  # the tamper: a synchronising call
            return read
        return enqueue

    with _patched(R._ResidentProgram, "enqueue", sync_hook):
        msg = _tamper_raises("a .item() in the enqueue", lambda: resident_search(
            NQueensProblem(12), M=50000, K=1, device=dev, guard=True))
    check("synchronising call in steady-state dispatch 2" in msg, msg)
    rows["tamper_sync"] = msg
    calls = [0]

    def rebuild_hook(orig):
        def graph(self, state):
            calls[0] += 1
            if calls[0] == 2:  # the tamper: the graph rebuilt in steady state
                self._stale = list(self._graphs.values())
                self._graphs.clear()
            return orig(self, state)
        return graph

    with _patched(R._ResidentProgram, "_graph", rebuild_hook):
        msg = _tamper_raises("a graph rebuilt in steady state", lambda: resident_search(
            NQueensProblem(12), M=50000, K=1, device=dev, guard=True))
    check("steady-state dispatch 2 built something (graphs" in msg, msg)
    rows["tamper_rebuild"] = msg
    zero_counts(counters)
    rec = run_search(NQ14 + ["--unfused", "--guard", "--K", "64"], NQ_GOLDEN[14])
    g = rec.get("guard") or {}
    check(g.get("checked_dispatches", 0) > 1 and "sync" in g.get("checks", ())
          and counters["dispatch_graph"].launches == rec["dispatches"]
          and counters["nqueens_labels"].launches == rec["device_cycles"],
          f"guarded unfused N=14: guard {g}, {counters['dispatch_graph'].launches} "
          f"graph launches for {rec['dispatches']} dispatches")
    rows["unfused_N14"] = dict(outcome="completed", guard=g,
                               dispatches=rec["dispatches"],
                               graph_launches=counters["dispatch_graph"].launches,
                               device_cycles=rec["device_cycles"],
                               dispatch_device_ms=1e3 * rec["dispatch_device_s"],
                               phase2_s=rec["phases"][1][2])
    emit("guard_tampers", tamper_sync=rows["tamper_sync"],
         tamper_rebuild=rows["tamper_rebuild"], unfused_N14=rows["unfused_N14"])
    return rows


FLEET_N17 = {"problem": "nqueens", "N": 17, "M": 50000, "K": 256}
# The placement jobs (spec, golden counts), by name.
FLEET_JOBS = {"lb1": (SERVE_LB1, (2573652, 2648, 1377)),
              "nq15": (SERVE_NQ15, (171129071, 2279184)),
              "lb2": (SERVE_LB2, (144639, 0, 1377))}
N17_SOL = 95815104  # the classical solution count of 17 queens


def _fleet_submit(base: str, spec: dict) -> tuple[dict, float]:
    t0 = time.perf_counter()
    code, sub = _serve_call(base, "/submit", spec)
    check(code == 201, f"fleet submit {spec}: {code} {sub}")
    return sub, t0


def _fleet_wait(base: str, subs: list, timeout_s: float = 300.0,
                poll_s: float = 0.005) -> list:
    """The fresh final records of the fleet jobs ``subs`` ((submit reply,
    submit time) pairs), polled together, each with its routed wall (its
    submit to the router's first final answer), the final daemon's wall
    (its record's finished - submitted), the queue wait, and the router hop:
    the routed wall less the daemon's, for a job that ran on one daemon
    only. A resubmitted job's routed wall also holds its earlier daemons'
    runs and the recovery wait, so its hop is null."""
    deadline = time.monotonic() + timeout_s
    done: dict = {}
    while len(done) < len(subs):
        for sub, t0 in subs:
            if sub["id"] in done:
                continue
            code, rec = _serve_call(base, f"/job/{sub['id']}")
            if code == 200 and rec["state"] in ("done", "failed", "cancelled") \
                    and not rec.get("stale"):
                done[sub["id"]] = (rec, time.perf_counter() - t0)
        check(time.monotonic() < deadline, f"fleet jobs not final: {len(done)}")
        time.sleep(poll_s)
    out = []
    for sub, _ in subs:
        rec, routed = done[sub["id"]]
        check(rec["state"] == "done",
              f"fleet job {sub['id']}: {rec['state']} {rec.get('error')}")
        daemon_wall = rec["finished"] - rec["submitted"]
        hop = None if rec.get("resubmits") else 1e3 * (routed - daemon_wall)
        out.append(dict(rec, routed_wall_ms=1e3 * routed,
                        daemon_wall_ms=1e3 * daemon_wall, router_hop_ms=hop,
                        queue_wait_ms=1e3 * (rec["started"] - rec["submitted"])))
    return out


def _poll_until(what: str, fn, timeout_s: float = 120.0):
    deadline = time.monotonic() + timeout_s
    while True:
        got = fn()
        if got:
            return got
        check(time.monotonic() < deadline, f"fleet: {what} not seen")
        time.sleep(0.02)


def phase_fleet(counters: dict) -> dict:
    """The fleet router (``fleet/``) over daemons on the card, all jobs
    under ``TTS_GUARD=1``: two ``ServeDaemon``s in-process on free
    localhost ports (``--ckpt-every 0.3``) behind an in-process
    ``FleetRouter``. Placement: ta014 lb1 ub=1 cold, then the same class
    warm on the same daemon with no new program and no new graph; N = 15
    cold on the other daemon; ta014 lb2 ub=1; each to its goldens. Drain
    migration: N-Queens N = 17 at K = 256, cut every 0.3 s, moved live off
    its draining daemon. SIGKILL recovery: the same job on a subprocess
    daemon (``serve --port 0 --ckpt-every 0.3``), killed after the router
    pulled a cut, resubmitted to a daemon registered afterwards. Both long
    jobs equal an uninterrupted solo ``resident_search`` of the spec, count
    for count. Per job: the routed wall, the daemon's, the router hop and
    the queue wait (ms); the resubmits; kernels 2, 4 and 8's launches in
    this process around the phase (the subprocess's are its own)."""
    import os
    import re
    import signal
    import tempfile

    from tpu_tree_search_torch.engine.resident import resident_search
    from tpu_tree_search_torch.fleet.router import FleetRouter
    from tpu_tree_search_torch.problems import NQueensProblem
    from tpu_tree_search_torch.serve.server import ServeDaemon

    dev = torch.device("cuda", 0)
    t_ref = time.perf_counter()
    ref = resident_search(NQueensProblem(FLEET_N17["N"]), M=FLEET_N17["M"],
                          K=FLEET_N17["K"], device=dev)
    ref_counts = (ref.explored_tree, ref.explored_sol)
    check(ref.explored_sol == N17_SOL, f"N=17 solo run: {ref_counts}")
    emit("fleet_reference", **FLEET_N17, explored_tree=ref.explored_tree,
         explored_sol=ref.explored_sol, wall_s=time.perf_counter() - t_ref,
         dispatches=ref.dispatches,
         device_ms=ref.dispatch_device_s and 1e3 * ref.dispatch_device_s)
    golden = {k: g for k, (_, g) in FLEET_JOBS.items()}
    prev_guard = os.environ.get("TTS_GUARD")
    os.environ["TTS_GUARD"] = "1"
    out = {}
    daemons = []
    router = proc = None
    zero_counts(counters)
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for name in ("a", "b"):
                d = ServeDaemon(port=0, state_dir=f"{tmp}/{name}", ckpt_every_s=0.3,
                                device=dev)
                d.start()
                daemons.append(d)
            router = FleetRouter(port=0, state_dir=f"{tmp}/fleet",
                                 daemons=[d.url for d in daemons],
                                 scrape_interval_s=0.2, pull_interval_s=0.3,
                                 max_misses=2)
            router.start()
            base = router.url
            # -- placement --------------------------------------------------
            sub1, t1 = _fleet_submit(base, FLEET_JOBS["lb1"][0])
            check(sub1["placement"] == "cold", f"first lb1 job: {sub1}")
            (rec1,) = _fleet_wait(base, [(sub1, t1)])

            def warm_on(url):
                _, fl = _serve_call(base, "/fleet")
                return any(d["url"] == url and any(c.get("warm") for c in d["classes"])
                           for d in fl["daemons"])
            _poll_until("the lb1 class warm", lambda: warm_on(sub1["daemon"]))
            sub2, t2 = _fleet_submit(base, FLEET_JOBS["lb1"][0])
            sub3, t3 = _fleet_submit(base, FLEET_JOBS["nq15"][0])
            sub4, t4 = _fleet_submit(base, FLEET_JOBS["lb2"][0])
            check(sub2["placement"] == "warm" and sub2["daemon"] == sub1["daemon"],
                  f"warm lb1 job: {sub2}")
            check(sub3["placement"] == "cold" and sub3["daemon"] != sub1["daemon"],
                  f"N=15 job: {sub3}")
            rec2, rec3, rec4 = _fleet_wait(base, [(sub2, t2), (sub3, t3),
                                                  (sub4, t4)])
            check(rec2["new_programs"] == 0 and rec2["new_step_compiles"] == 0,
                  f"warm job built {rec2['new_programs']} programs, "
                  f"{rec2['new_step_compiles']} graphs")
            for rec, want in ((rec1, golden["lb1"]), (rec2, golden["lb1"]),
                              (rec3, golden["nq15"]), (rec4, golden["lb2"])):
                res = rec["result"]
                got = (res["explored_tree"], res["explored_sol"], res["best"])[:len(want)]
                check(got == want, f"fleet job {rec['id']}: {got} != {want}")
            for key, rec, sub in (("lb1_cold", rec1, sub1), ("lb1_warm", rec2, sub2),
                                  ("nq15_cold", rec3, sub3), ("lb2", rec4, sub4)):
                out[key] = {k: rec.get(k) for k in (
                    "routed_wall_ms", "daemon_wall_ms", "router_hop_ms",
                    "queue_wait_ms", "new_programs", "new_step_compiles", "daemon",
                    "slices")}
                out[key].update(placement=sub["placement"],
                                guard=rec["result"].get("guard"))
                emit("fleet_placement", job=key, **out[key])
            # -- drain migration ---------------------------------------------
            sub5, t5 = _fleet_submit(base, FLEET_N17)
            src = next(d for d in daemons if d.url == sub5["daemon"])
            dst = next(d for d in daemons if d is not src)
            _poll_until("the N=17 job cut once", lambda: (lambda r: r.get("state") == "running"
                        and int(r.get("steps") or 0) > 0)(_serve_call(base, f"/job/{sub5['id']}")[1]))
            t_drain = time.perf_counter()
            src.scheduler.drain(timeout_s=0.0)
            (rec5,) = _fleet_wait(base, [(sub5, t5)], timeout_s=600.0)
            res = rec5["result"]
            check((res["explored_tree"], res["explored_sol"]) == ref_counts
                  and rec5["daemon"] == dst.url and rec5["resubmits"] >= 1,
                  f"drain migration: {res['explored_tree']}, {res['explored_sol']}, "
                  f"{rec5['daemon']}, {rec5['resubmits']}")
            out["drain"] = {k: rec5.get(k) for k in (
                "routed_wall_ms", "daemon_wall_ms", "router_hop_ms", "queue_wait_ms",
                "resubmits", "slices", "steps")}
            out["drain"].update(drain_to_done_s=time.perf_counter() - t_drain,
                                counts=[res["explored_tree"], res["explored_sol"]])
            emit("fleet_drain_migration", **out["drain"])
            # -- SIGKILL recovery ---------------------------------------------
            dst.scheduler.drain(timeout_s=60.0)  # only the subprocess places
            proc = subprocess.Popen(
                [sys.executable, "-m", "tpu_tree_search_torch", "serve", "--port", "0",
                 "--state-dir", f"{tmp}/p", "--ckpt-every", "0.3"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                cwd=os.path.dirname(os.path.abspath(__file__)))
            url_p = None
            for line in proc.stdout:
                m = re.search(r"(http://127\.0\.0\.1:\d+)", line)
                if m:
                    url_p = m.group(1)
                    break
            check(url_p is not None, "the subprocess daemon printed no banner")
            router.register(url_p)
            sub6, t6 = _fleet_submit(base, FLEET_N17)
            check(sub6["daemon"] == url_p, f"SIGKILL job placed on {sub6['daemon']}")
            _poll_until("a pulled cut", lambda: (lambda j: j.ckpt and j.ckpt_steps > 0)(
                router.jobs.get(sub6["id"])), timeout_s=300.0)
            steps_at_kill = router.jobs.get(sub6["id"]).ckpt_steps
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=60)
            _poll_until("the job flagged for recovery",
                        lambda: router.jobs.get(sub6["id"]).needs_recovery)
            d3 = ServeDaemon(port=0, state_dir=f"{tmp}/c", ckpt_every_s=0.3, device=dev)
            d3.start()
            daemons.append(d3)
            router.register(d3.url)
            (rec6,) = _fleet_wait(base, [(sub6, t6)], timeout_s=600.0)
            res = rec6["result"]
            check((res["explored_tree"], res["explored_sol"]) == ref_counts
                  and rec6["daemon"] == d3.url and rec6["resubmits"] >= 1,
                  f"SIGKILL recovery: {res['explored_tree']}, {res['explored_sol']}, "
                  f"{rec6['daemon']}, {rec6['resubmits']}")
            out["sigkill"] = {k: rec6.get(k) for k in (
                "routed_wall_ms", "daemon_wall_ms", "router_hop_ms", "queue_wait_ms",
                "resubmits", "slices", "steps")}
            out["sigkill"].update(steps_at_kill=steps_at_kill,
                                  counts=[res["explored_tree"], res["explored_sol"]])
            emit("fleet_sigkill_recovery", **out["sigkill"])
        finally:
            if prev_guard is None:
                os.environ.pop("TTS_GUARD", None)
            else:
                os.environ["TTS_GUARD"] = prev_guard
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
            if router is not None:
                router.close()
            for d in daemons:
                d.scheduler.drain(timeout_s=60.0)
                d.close()
    torch.cuda.synchronize()
    out["launches"] = {k: counters[k].launches
                       for k in ("cycle_lb1", "cycle_nqueens", "cycle_lb2")}
    check(all(out["launches"].values()), f"fleet: a cycle kernel not launched "
          f"{out['launches']}")
    emit("fleet_launches", **out["launches"])
    return out


def main_fleet(dev_info) -> int:
    """``--fleet``: only the guard and the fleet phases after the build."""
    counters = kernel_counters()
    phase_guard(counters)
    phase_fleet(counters)
    print(json.dumps({"ok": True, "phases": "fleet", "device": dev_info}), flush=True)
    return 0


# -- the lb2 pair axis (--mp) and device positions -------------------------------

# ta014 lb2 on the mesh at D = 2 (PFSP_LB2 with the tier replaced).
LB2_MESH = PFSP_LB2[:-1] + ["mesh", "--D", "2"]
# The mesh_mp runs: (name, argv, mp, staged, library); a library run goes
# through mesh_resident_search (single-pass lb2 has no CLI flag).
MP_RUNS = [
    ("mp1_staged", LB2_MESH + ["--unfused"], 1, True, False),
    ("mp1_single", LB2_MESH, 1, False, True),
    ("mp2_staged", LB2_MESH + ["--mp", "2"], 2, True, False),
    ("mp2_single", LB2_MESH + ["--mp", "2"], 2, False, True),
    ("mp4_staged", LB2_MESH + ["--mp", "4"], 4, True, False),
    ("mp4_single", LB2_MESH + ["--mp", "4"], 4, False, True),
    ("mp2_guard", LB2_MESH + ["--mp", "2", "--guard", "--K", "4"], 2, True, False),
    ("dist_mesh_mp2", PFSP_LB2[:-1] + ["dist_mesh", "--hosts", "2", "--D", "1",
                                       "--mp", "2"], 2, True, False),
    ("dist_mesh_mp1", PFSP_LB2[:-1] + ["dist_mesh", "--hosts", "2", "--D", "1",
                                       "--unfused"], 1, True, False),
]


def _library_mesh(argv: list[str], golden: dict, **kwargs) -> dict:
    """``argv``'s mesh search through ``mesh_resident_search`` with the
    CLI's problem and defaults and ``kwargs``; its CLI record."""
    from tpu_tree_search_torch import cli
    from tpu_tree_search_torch.parallel.resident_mesh import mesh_resident_search

    args = cli.build_parser().parse_args(argv)
    dev = torch.device("cuda", 0)
    res = mesh_resident_search(cli.make_problem(args), m=args.m,
                               M=cli.default_M(args.problem, dev.type, "mesh"),
                               K=16, D=args.D, mp=args.mp, device=dev, **kwargs)
    rec = dict(cli.result_record(args, res, dev), entry="mesh_resident_search",
               **kwargs)
    got = {k: rec[k] for k in golden}
    check(got == golden, f"mesh_resident_search {argv} {kwargs} counts {got}")
    return rec


# The mesh_mp runs traced again under torch.profiler, and the kernels whose
# launches the trace counts: (kernel name in the trace, the wrappers that
# launch it).
MP_TRACED = ("mp2_staged", "mp2_single")
MP_TRACE_KERNELS = (("lb2_bounds_kernel", ("lb2_bounds", "lb2_block")),
                    ("lb2_self_bounds_kernel", ("lb2_self_bounds", "lb2_self_block")),
                    ("lb1_bounds_kernel", ("lb1_bounds",)),
                    ("slot_gate", ("slot_gate",)))


def traced_launches(go, counters: dict) -> tuple[dict, dict, dict]:
    """``go()`` under ``torch.profiler`` (the device alone), its counts set
    to 0 just before: ``(its result, the wrappers' launches, the trace's
    launches of each kernel of MP_TRACE_KERNELS)``, which the wrappers'
    counts must equal (a launch the wrappers do not count shows here)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    zero_counts(counters)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rec = go()
        torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    traced = {kn: 0 for kn, _ in MP_TRACE_KERNELS}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        for kn, _ in MP_TRACE_KERNELS:
            if kn in ev.key:
                traced[kn] += ev.count
    return rec, launches, traced


def phase_mesh_mp(counters: dict) -> dict:
    """Phase 18j (see the module note): the mesh and dist_mesh tiers under
    the lb2 pair axis, each run's counts set to 0 just before it; the runs
    of MP_TRACED again under ``torch.profiler``, the trace's kernel
    launches against the wrappers' counts."""
    rows = {}
    for name, argv, mp, staged, library in MP_RUNS:
        def go(argv=argv, staged=staged, library=library):
            return (_library_mesh(argv, GOLDEN_LB2, fused=False, staged=staged)
                    if library else run_search(argv, GOLDEN_LB2))
        zero_counts(counters)
        rec = go()
        launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
        cycles = rec["device_cycles"]
        bound = ("lb2_self_block" if staged else "lb2_block") if mp > 1 else (
            "lb2_self_bounds" if staged else "lb2_bounds")
        other = {"lb2_bounds", "lb2_self_bounds", "lb2_block",
                 "lb2_self_block", "cycle_lb2"} - {bound}
        check(rec["mp"] == mp and not rec["fused"] and rec["staged"] == staged,
              f"mesh_mp {name}: mp {rec['mp']}, fused {rec['fused']}, "
              f"staged {rec['staged']}")
        check(launches.get(bound, 0) == mp * cycles > 0
              and launches.get("lb1_bounds", 0) == (cycles if staged else 0)
              and not any(launches.get(k) for k in other),
              f"mesh_mp {name}: launches {launches} for {cycles} cycles at mp {mp}")
        if "--guard" in argv:
            g = rec.get("guard") or {}
            check(g.get("checked_dispatches", 0) > 1 and "sync" in g.get("checks", ()),
                  f"mesh_mp {name}: guard {g}")
        rows[name] = dict(mp=mp, staged=staged, entry=rec.get("entry", "cli"),
                          tier=rec["tier"], dispatches=rec["dispatches"],
                          device_cycles=cycles, launches=launches,
                          dispatch_device_ms=(1e3 * rec["dispatch_device_s"]
                                              if rec.get("dispatch_device_s") is not None
                                              else None),
                          graph_build_s=rec["graph_build_s"], guard=rec.get("guard"),
                          per_worker_tree=rec["per_worker_tree"],
                          phase2_s=rec["phases"][1][2], elapsed_s=rec["elapsed_s"])
        if name in MP_TRACED:
            _, by_wrapper, traced = traced_launches(go, counters)
            want = {kn: sum(by_wrapper.get(w, 0) for w in ws)
                    for kn, ws in MP_TRACE_KERNELS}
            # CUPTI loses records of a conditional body's nodes (some runs
            # lose most), never adds one: a trace holding more launches
            # than a wrapper counted would be a launch it did not count.
            check(all(traced[k] <= want[k] for k in want) and traced["slot_gate"] > 0,
                  f"mesh_mp {name}: traced launches {traced} against the wrappers' {want}")
            rows[name]["traced_launches"] = traced
    for name, row in rows.items():
        base = rows[("dist_mesh_mp1" if name.startswith("dist") else
                     f"mp1_{'staged' if row['staged'] else 'single'}")]
        if row["dispatch_device_ms"] and base["dispatch_device_ms"]:
            row["device_ms_over_mp1"] = row["dispatch_device_ms"] / base["dispatch_device_ms"]
        emit(f"mesh_mp_{name}", **row)
    return rows


def phase_pair_blocks(dev, lb2_tables: dict) -> dict:
    """Phase 18k: kernels 6 and 7 on the mp pair blocks (see the module
    note). Returns the rows by (kernel, inst, mp)."""
    from tpu_tree_search_torch.ops import lb2_kernel, lb2_self_kernel
    from tpu_tree_search_torch.ops import pfsp_device as PD

    rng = np.random.default_rng(18)
    rows = {}
    B = 49152
    for inst in ("ta014", "ta021"):
        tables = lb2_tables[inst]
        n, m, P = tables.jobs, tables.machines, tables.johnson.pair_count
        prmu, limit1 = random_nodes(rng, n, B)
        p = torch.from_numpy(prmu).to(dev).to(torch.int8)
        lim = torch.from_numpy(limit1).to(dev).to(torch.int8)
        na = torch.tensor(B, dtype=torch.int32, device=dev)
        open_ = torch.from_numpy(np.arange(n)[None, :] > limit1[:, None]).to(dev)
        full6 = lb2_kernel.lb2_bounds_cuda(p, lim, tables)
        full7 = lb2_self_kernel.lb2_self_bounds_cuda(p, lim, na, tables)
        full6_ms, _ = kernel_device_ms(
            lambda: lb2_kernel.lb2_bounds_cuda(p, lim, tables), 20, ("lb2_bounds_kernel",))
        full7_ms, _ = kernel_device_ms(
            lambda: lb2_self_kernel.lb2_self_bounds_cuda(p, lim, na, tables), 20,
            ("lb2_self_bounds_kernel",))
        for mp in (2, 4):
            blocks = tables.pair_blocks(mp)
            P_local = blocks[0].johnson.pair_count
            err6 = err7 = 0
            max6 = max7 = None
            for blk in blocks:
                got6 = lb2_kernel.lb2_block_cuda(p, lim, blk)
                want6 = lb2_kernel.plain(p, lim, blk)
                got7 = lb2_self_kernel.lb2_self_block_cuda(p, lim, na, blk)
                want7 = lb2_self_kernel.plain(p, lim, na, blk)
                torch.cuda.synchronize()
                err6 = max(err6, int((got6[open_].long() - want6[open_].long()).abs().max()))
                err7 = max(err7, int((got7.long() - want7.long()).abs().max()))
                max6 = got6 if max6 is None else torch.maximum(max6, got6)
                max7 = got7 if max7 is None else torch.maximum(max7, got7)
            d6 = int((max6[open_].long() - full6[open_].long()).abs().max())
            d7 = int((max7.long() - full7.long()).abs().max())
            check(err6 == err7 == d6 == d7 == 0,
                  f"pair blocks {inst} mp={mp}: block vs plain {err6}, {err7}; "
                  f"max vs full {d6}, {d7}")
            blk = blocks[0]
            for kname, wrapper, args, plain, kernel, nbytes, ops, full_ms, whole in [
                    ("kernel6_mp", lb2_kernel.lb2_block_cuda, (p, lim, blk),
                     lambda: lb2_kernel.plain(p, lim, blk), "lb2_bounds_kernel",
                     B * n + B + B * n * 4 + johnson_bytes(blk),
                     lb2_scan_ops(limit1, n, m, P_local), full6_ms,
                     lambda: PD.lb2_bounds_mp(p, lim, tables, mp)),
                    ("kernel7_mp", lb2_self_kernel.lb2_self_block_cuda,
                     (p, lim, na, blk), lambda: lb2_self_kernel.plain(p, lim, na, blk),
                     "lb2_self_bounds_kernel",
                     B * (n + 1 + 4) + johnson_bytes(blk, "lb2_self_bounds"),
                     lb2_self_ops(limit1, n, m, P_local), full7_ms,
                     lambda: PD.lb2_self_bounds_mp(p, lim, na, tables, mp))]:
                call = lambda: wrapper(*args)  # noqa: E731
                ms, timing = kernel_device_ms(call, 20, (kernel,))
                bms, by = bound_ms(nbytes, ops)
                row = dict(inst=inst, n=n, m=m, P=P, mp=mp, P_local=P_local, B=B,
                           dtype="torch.int8", max_abs_err=max(err6 if kname == "kernel6_mp"
                                                               else err7, 0),
                           max_of_blocks_vs_full=d6 if kname == "kernel6_mp" else d7,
                           ms=ms, timing=timing, call_ms=median_ms(call, 20),
                           plain_ms=median_ms(plain, 1), bound_ms=bms, bound_by=by,
                           library_ms=None, full_pairs_ms=full_ms,
                           mp_call_ms=median_ms(whole, 10))
                if kname == "kernel6_mp":
                    row["block"] = lb2_kernel.last_shape("lb2_bounds")
                else:
                    row["block"] = lb2_self_kernel.last_shape()
                rows[(kname, inst, mp)] = row
                emit(kname, **row)
    return rows


def phase_mesh_eval(dev) -> dict:
    """Phase 18l: ``MeshEvaluator`` on the card against the unsharded
    bounds and the plain leaf fold."""
    from tpu_tree_search_torch.parallel import mesh as PM
    from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem

    rng = np.random.default_rng(19)
    rows = {}
    B = 4096
    for lb, mp in (("lb1", 1), ("lb1_d", 1), ("lb2", 1), ("lb2", 2), ("lb2", 4),
                   ("nqueens", 1)):
        if lb == "nqueens":
            prob = NQueensProblem(15)
            board, depth = random_boards(rng, 15, B)
            par = {"board": board, "depth": depth.astype(np.int8)}
        else:
            prob = PFSPProblem(inst=14, lb=lb, ub=1)
            prmu, limit1 = random_nodes(rng, 20, B)
            par = {"prmu": prmu.astype(np.int8), "limit1": limit1.astype(np.int8),
                   "depth": (limit1 + 1).astype(np.int8)}
        ev = PM.MeshEvaluator(prob, PM.make_mesh(4, mp=mp, devices=["cuda:0"] * 4))
        count = B - 7
        t0 = time.perf_counter()
        got, best = ev(par, count, 10**9)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        if lb == "nqueens":
            want = prob.device_bounds(torch.from_numpy(board).to(dev),
                                      torch.from_numpy(depth).to(dev))
            err = int((got.long() - want.long()).abs().max())
            want_best = 2**31 - 1
        else:
            p = torch.from_numpy(par["prmu"]).to(dev)
            lim = torch.from_numpy(par["limit1"]).to(dev)
            want = prob.device_bounds(p, lim)
            open_ = torch.from_numpy(np.arange(20)[None, :] > limit1[:, None]).to(dev)
            err = int((got[open_].long() - want[open_].long()).abs().max())
            leaf = open_.clone()
            leaf[count:] = False
            leaf &= torch.from_numpy(limit1 + 2 == 20).to(dev)[:, None]
            want_best = min(10**9, int(torch.where(leaf, want, 2**31 - 1).min()))
        check(err == 0 and best == want_best,
              f"mesh_eval {lb} mp={mp}: max diff {err}, best {best} != {want_best}")
        rows[(lb, mp)] = dict(problem=prob.name, lb=lb, dp=ev.dp, mp=ev.mp, B=B,
                              count=count, max_abs_err=err, best=best, call_s=call_s)
        emit("mesh_eval", **rows[(lb, mp)])
    return rows


def phase_mesh_cards(counters: dict) -> dict:
    """Phase 18m: the mesh and the multi tier over device positions (see
    the module note)."""
    from tpu_tree_search_torch.engine.device import warmup
    from tpu_tree_search_torch.parallel.resident_mesh import get_mesh_program
    from tpu_tree_search_torch.pool.pool import SoAPool
    from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem
    from tpu_tree_search_torch.problems.base import index_batch

    count = torch.cuda.device_count()
    peer = (torch.cuda.can_device_access_peer(0, 1) if count > 1 else None)
    emit("cards", device_count=count, peer_0_1=peer,
         names=[torch.cuda.get_device_name(i) for i in range(count)])
    lists = ["cuda:0,cuda:0"] + (["cuda:0,cuda:1"] if count > 1 else [])
    rows = {}
    dev = torch.device("cuda", 0)
    for positions in lists:
        for name, argv, golden, cycle in (
                ("ta014_lb1", PFSP_LB1, GOLDEN, "cycle_lb1"),
                ("nqueens_N15", NQ15, NQ_GOLDEN[15], "cycle_nqueens")):
            for devs in (positions, "cuda:0"):
                zero_counts(counters)
                rec = run_search(argv + ["--tier", "mesh", "--D", "4", "--device", devs],
                                 golden)
                launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
                disp = rec["dispatches"]
                groups = 2 if "," in devs else 1
                check(launches.get(cycle) == rec["device_cycles"] > 0
                      and launches.get("mesh_graph") == disp * (2 * groups if groups > 1
                                                                else 1)
                      and launches.get("mesh_balance") == 2 * disp,
                      f"mesh_cards {name} {devs}: launches {launches}, {disp} dispatches")
                rows[(positions, name, devs)] = dict(
                    positions=devs, groups=groups, dispatches=disp,
                    device_cycles=rec["device_cycles"], launches=launches,
                    dispatch_device_ms=1e3 * rec["dispatch_device_s"],
                    per_worker_tree=rec["per_worker_tree"],
                    phase2_s=rec["phases"][1][2])
                emit(f"mesh_cards_{name}", **rows[(positions, name, devs)])
            one = rows[(positions, name, "cuda:0")]
            two = rows[(positions, name, positions)]
            check(one["per_worker_tree"] == two["per_worker_tree"]
                  and one["dispatches"] == two["dispatches"],
                  f"mesh_cards {name}: {positions} shard trees {two['per_worker_tree']} "
                  f"!= one group's {one['per_worker_tree']}")
        # Dispatch by dispatch: every state row and live row equal.
        for name, prob, M in (("ta014_lb1", PFSPProblem(inst=14, lb="lb1", ub=1), 16384),
                              ("nqueens_N15", NQueensProblem(15), 16384)):
            pool = SoAPool(prob.node_fields())
            pool.push_back(index_batch(prob.root(), 0))
            _, _, best = warmup(prob, pool, getattr(prob, "initial_ub", INF), 400)
            frontier = pool.as_batch()
            C = 2 * M * prob.child_slots
            a = get_mesh_program(prob, 4, 25, M, 4, 2, 8192, C, dev)
            b = get_mesh_program(prob, 4, 25, M, 4, 2, 8192, C,
                                 devices=positions.split(","))
            sizes = []
            try:
                for prog in (a, b):
                    prog.host_slots(1)
                    prog.upload(frontier, best)
                for _ in range(3):
                    ra = a.enqueue()()[0]
                    rb = b.enqueue()()[0]
                    check(ra == rb, f"mesh_cards {name}: state rows differ")
                    for d in range(4):
                        s = ra[d][0]
                        check(torch.equal(a.states[d].pool_vals[:s], b.states[d].pool_vals[:s])
                              and torch.equal(a.states[d].pool_aux[:s],
                                              b.states[d].pool_aux[:s]),
                              f"mesh_cards {name}: shard {d}'s live rows differ")
                    sizes.append([r[0] for r in ra])
            finally:
                a.release()
                b.release()
            emit("mesh_cards_rows", positions=positions, search=name, shard_sizes=sizes,
                 groups=[g.shards for g in b.groups], equal=True)
        zero_counts(counters)
        rec = run_search(PFSP_LB1 + ["--tier", "multi", "--device", positions], GOLDEN)
        rows[(positions, "multi")] = dict(
            positions=positions, per_worker_tree=rec["per_worker_tree"],
            chunks=rec["chunks"], launches={k: fn.launches for k, fn in counters.items()
                                            if fn.launches},
            phase2_s=rec["phases"][1][2])
        check(rows[(positions, "multi")]["launches"] == {"lb1_bounds": rec["chunks"]},
              f"multi {positions}: launches {rows[(positions, 'multi')]['launches']}")
        emit("mesh_cards_multi", **rows[(positions, "multi")])
    return rows


def phase_slot_gate(dev) -> dict:
    """``slot_gate`` (csrc/dispatch_graph.cu: an unfused slot's gate and the
    condition of its ``if`` node) on the card: one unfused mesh dispatch
    (N-Queens N=12, D = 4: a full shard, a starving one, a partial one
    and an empty one; K = 4, 2 rounds) against the same program on the
    CPU, every word of every shard and every live row (max difference);
    the gate's device ms a launch from a ``torch.profiler`` trace of a
    second dispatch on the same frontiers, its launches there; the plain
    version (``loop_active`` on each shard's row, ``st[ST_ACTIVE]`` set on
    the card's tensor) timed by events; the bound: the three words the
    gate reads and the one it writes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_tree_search_torch.ops import cycle as C
    from tpu_tree_search_torch.ops import dispatch as D
    from tpu_tree_search_torch.parallel.resident_mesh import MeshProgram
    from tpu_tree_search_torch.problems import NQueensProblem

    prob, M, K, m, cap, Dn = NQueensProblem(12), 256, 4, 25, 1 << 15, 4
    fr = _frontier(prob, 600)
    fronts = [fr, {k: v[:10] for k, v in fr.items()},
              {k: v[:300] for k, v in fr.items()}, None]

    def program(where):
        prog = MeshProgram(prob, Dn, m, M, K, 2, 64, cap, where, fused=False)
        prog.host_slots(1)
        return prog

    def load(prog):
        for d, f in enumerate(fronts):
            if f is None:
                prog.st[d].copy_(C.new_state(0, INF, prog.device))
            else:
                prog.inner.load_state(prog.states[d], f, INF)

    out = []
    for where in (dev, torch.device("cpu")):
        prog = program(where)
        load(prog)
        out.append((prog, prog.enqueue()()[0]))
    (g, grows), (p, prows) = out
    err = max(abs(a - b) for ra, rb in zip(grows, prows) for a, b in zip(ra, rb))
    for d in range(Dn):
        s = prows[d][0]
        err = max(err, _maxdiff(g.pool_vals[d, :s].cpu(), p.pool_vals[d, :s]),
                  _maxdiff(g.pool_aux[d, :s].cpu(), p.pool_aux[d, :s]))
    p.close()
    body = g.graph().kernels()
    check(len(body) == 2 * Dn + 1 and body.count("-") == Dn
          and sum("slot_gate" in k for k in body) == Dn
          and sum("batch_cond" in k for k in body) == 1,
          f"slot_gate: the unfused mesh body's nodes {body}")
    load(g)
    D.slot_gate.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g.enqueue()()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and "slot_gate" in e.key]
    traced = sum(e.count for e in evs)
    ms = sum(e.self_device_time_total for e in evs) / 1e3 / max(1, traced)
    launches = D.slot_gate.launches
    g.close()
    st = torch.stack([C.new_state(s, INF, dev) for s in (600, 10, 300, 0)])

    def plain():
        for i, row in enumerate(st.tolist()):
            st[i, C.ST_ACTIVE] = int(D.loop_active(row, m, M * prob.child_slots, cap, K))

    plain_ms = median_ms(plain, 5) / Dn
    bms, by = bound_ms(4 * 4, 0)
    check(err == 0 and 0 < traced <= launches,
          f"slot_gate: max diff {err}, traced {traced} of {launches} launches")
    row = dict(max_abs_err=err, ms=ms, traced_launches=traced, launches=launches,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by, shards=Dn,
               cycles=sum(r[C.ST_CYCLES] for r in grows))
    emit("slot_gate", **row)
    return row


def slot_gate_row(gate: dict, mp_runs: dict) -> dict:
    """The kernels line's row of ``slot_gate`` (phase 18j's mp = 2 staged
    mesh its launches, ``phase_slot_gate`` its times)."""
    return {"name": "slot_gate", "route": "cuda",
            "source": "tpu_tree_search_torch/csrc/dispatch_graph.cu",
            "replaces": "tpu_tree_search/engine/batched.py:120",
            "launches": mp_runs["mp2_staged"]["launches"]["slot_gate"],
            "launches_path": "mesh_mp mp2_staged",
            "shape": "one shard's state row, D = 4 a round",
            "max_abs_err": gate["max_abs_err"], "ms": gate["ms"],
            "timing": "profiler, a launch", "plain_ms": gate["plain_ms"],
            "bound_ms": gate["bound_ms"], "bound_by": gate["bound_by"],
            "library_ms": None}


def pair_block_rows(mp_runs: dict, blocks: dict) -> list[dict]:
    """The kernels line's rows of kernels 6 and 7 on pair blocks: the
    launches of the mp = 2 mesh runs of phase 18j, the times of phase 18k
    (ta014 mp = 2 the main row; every row in ``pair_blocks``)."""
    out = []
    for name, source, replaces, kname, run, wrapper in [
            ("lb2_bounds_pair_block", "lb2_bounds.cu", "pallas_kernels.py:746",
             "kernel6_mp", "mp2_single", "lb2_block"),
            ("lb2_self_bounds_pair_block", "lb2_self_bounds.cu", "pallas_kernels.py:909",
             "kernel7_mp", "mp2_staged", "lb2_self_block")]:
        main_row = blocks[(kname, "ta014", 2)]
        mine = {k: r for k, r in blocks.items() if k[0] == kname}
        out.append({
            "name": name, "route": "cuda",
            "source": f"tpu_tree_search_torch/csrc/{source}",
            "replaces": f"tpu_tree_search/ops/{replaces}",
            "launches": mp_runs[run]["launches"][wrapper],
            "launches_path": f"mesh_mp {run}",
            "shape": "ta014 B=49152 int8, mp=2 (P_local 23 of 45)",
            "max_abs_err": max(r["max_abs_err"] for r in mine.values()),
            "ms": main_row["ms"], "timing": main_row["timing"],
            "call_ms": main_row["call_ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": None, "block": main_row["block"],
            "pair_blocks": {f"{k[1]}/mp{k[2]}": {
                f: r[f] for f in ("P_local", "ms", "plain_ms", "bound_ms", "bound_by",
                                  "max_of_blocks_vs_full", "full_pairs_ms", "mp_call_ms")}
                for k, r in mine.items()},
            "mp_launches": {f"{run_name}": row["launches"].get(wrapper, 0)
                            for run_name, row in mp_runs.items()}})
    return out


def _in_threads(fns: list) -> list:
    """Each of ``fns`` in a host thread of its own (the plain exchange's
    copies wait for each other at a barrier): their results, in order."""
    import threading

    out, errors = [None] * len(fns), []

    def run(i):
        try:
            out[i] = fns[i]()
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if errors:
        raise errors[0]
    return out


def phase_pair_exchange(dev) -> dict:
    """Phase 18o: the pair exchange (``csrc/pair_exchange.cu``: post, a
    one-block wait, max) between two copies on two positions of the card,
    each on a stream of its own, at the mesh's plane (M = 49152, n = 20:
    983,040 int32 words): five exchanges in a row (both parity slots,
    twice; the whole plane, a quarter and 7 live words) against the plain
    version (the copies in host threads, a barrier, ``torch.maximum``) on
    the same planes, max difference 0; the pair's time (CUDA events around
    both copies' launches, and each kernel's device time under the
    profiler) against its bound; the plain version's time; and a copy
    whose peer never posts raising within the timeout (0.5 s), a later
    exchange on it returning at once."""
    from tpu_tree_search_torch.ops import pair_exchange as PX

    rng = np.random.default_rng(20)
    n = 49152 * 20
    x = PX.PairExchange([dev, dev], n)
    ends = [x.endpoint(i) for i in range(2)]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    plain = PX.PairExchange(["cpu", "cpu"], n)
    pends = [plain.endpoint(i) for i in range(2)]
    cur = torch.cuda.current_stream(dev)

    def both(planes, cnt=None):
        for st in streams:
            st.wait_stream(cur)
        for e, st, pl in zip(ends, streams, planes):
            with torch.cuda.stream(st):
                e(pl, cnt)
        for st in streams:
            cur.wait_stream(st)

    err = 0
    for count in (None, None, n // 4, 7, None):
        planes = [torch.from_numpy(rng.integers(-2**30, 2**30, n).astype(np.int32))
                  for _ in range(2)]
        got = [p.to(dev) for p in planes]
        both(got, None if count is None else torch.tensor(count, dtype=torch.int32,
                                                          device=dev))
        torch.cuda.synchronize(dev)
        for e in ends:
            e.check()
        want = _in_threads([lambda i=i: pends[i](planes[i], count) for i in range(2)])
        err = max(err, *(_maxdiff(g.cpu(), w) for g, w in zip(got, want)))
    check(err == 0, f"pair_exchange: max difference {err} from the plain version")
    work = [torch.from_numpy(rng.integers(-2**30, 2**30, n).astype(np.int32)).to(dev)
            for _ in range(2)]
    ms = median_ms(lambda: both(work), 20)
    kms, timing = kernel_device_ms(lambda: both(work), 20,
                                   ("xchg_post", "xchg_wait", "xchg_max"))
    split = dict(LAST_LAUNCH_MS)
    plain_planes = [w.clone() for w in work]

    def plain_call():
        _in_threads([lambda i=i: PX.pair_exchange_plain(plain_planes[i], None, pends[i])
                     for i in range(2)])
        torch.cuda.synchronize(dev)

    plain_ms = float(np.median([_wall_ms(plain_call) for _ in range(5)]))
    # Bytes a call must move: each of the two copies writes its plane to
    # its peer and reads the mp = 2 planes for the max.
    nbytes = 2 * (1 + 2) * n * 4
    bms, by = bound_ms(nbytes, 0.0)
    # A copy whose peer is never launched: the wait gives up at the
    # timeout, the error word is set, a later exchange returns at once.
    xm = PX.PairExchange([dev, dev], 1024, timeout_s=0.5)
    lone = xm.endpoint(0)
    plane = torch.zeros(1024, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    with torch.cuda.stream(streams[0]):
        lone(plane)
    torch.cuda.synchronize(dev)
    waited = time.perf_counter() - t0
    raised = False
    try:
        lone.check()
    except RuntimeError:
        raised = True
    t0 = time.perf_counter()
    with torch.cuda.stream(streams[0]):
        lone(plane)
    torch.cuda.synchronize(dev)
    again = time.perf_counter() - t0
    check(raised and waited < 3.0 and again < 0.25,
          f"pair_exchange: a missing peer raised {raised} after {waited} s, "
          f"the next exchange took {again} s")
    row = dict(words=n, max_abs_err=err, ms=ms, timing="events, both copies",
               kernel_ms=kms, kernel_timing=timing, kernel_split=split,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by, bound_bytes=nbytes,
               buffer_bytes=x.nbytes, missing_peer_raised=raised,
               missing_peer_wait_s=waited, after_error_s=again)
    emit("pair_exchange", **row)
    return row


def _wall_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t0)


# The copies' runs of phase 18p: (name, device positions, staged); with
# two cards the same over cuda:0,cuda:1.
COPY_RUNS = [("copies2_staged", "cuda:0,cuda:0", True),
             ("copies2_single", "cuda:0,cuda:0", False),
             ("copies4_staged", "cuda:0,cuda:0,cuda:0,cuda:0", True),
             ("copies4_single", "cuda:0,cuda:0,cuda:0,cuda:0", False)]


def phase_mesh_mp_copies(counters: dict, mp_runs: dict, xchg: dict) -> dict:
    """Phase 18p: the mesh at D = 2, mp = 2 with each shard copied on the
    positions of its grid row (``parallel/resident_mesh.py``): ta014 lb2
    staged (the CLI) and single-pass (``mesh_resident_search``) over two
    and four positions of the card to the goldens, each run's counts set
    to 0 just before it (each copy launches its pair block and one
    exchange a cycle); each run's device ms beside phase 18j's in-turn
    layout on one position (mp = 2) and mp = 1, and the exchange's share
    of it (its launches a copy times phase 18o's time of a pair's
    exchange); then, dispatch by dispatch, three dispatches of each
    layout against the one-position program: every state row (but the
    loop's ``ST_ACTIVE``, ``loop_rows``) and live row equal, every copy's
    rows its primary's and its error word 0."""
    from tpu_tree_search_torch.engine.device import warmup
    from tpu_tree_search_torch.parallel.resident_mesh import (get_mesh_program,
                                                              loop_rows)
    from tpu_tree_search_torch.pool.pool import SoAPool
    from tpu_tree_search_torch.problems import PFSPProblem
    from tpu_tree_search_torch.problems.base import index_batch

    dev = torch.device("cuda", 0)
    runs = list(COPY_RUNS)
    if torch.cuda.device_count() > 1:
        runs += [("cards2_staged", "cuda:0,cuda:1", True),
                 ("cards2_single", "cuda:0,cuda:1", False)]
    rows = {}
    for name, devs, staged in runs:
        argv = LB2_MESH + ["--mp", "2", "--device", devs]
        zero_counts(counters)
        rec = (run_search(argv, GOLDEN_LB2) if staged else
               _library_mesh(LB2_MESH + ["--mp", "2"], GOLDEN_LB2, fused=False,
                             staged=False, devices=devs.split(",")))
        launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
        cycles = rec["device_cycles"]
        bound = "lb2_self_block" if staged else "lb2_block"
        check(rec["mp"] == 2 and not rec["fused"] and rec["staged"] == staged
              and launches.get(bound, 0) == 2 * cycles > 0
              and launches.get("pair_exchange", 0) == 2 * cycles
              and launches.get("lb1_bounds", 0) == (2 * cycles if staged else 0)
              and not launches.get("lb2_bounds") and not launches.get("lb2_self_bounds"),
              f"mesh_mp_copies {name}: launches {launches} for {cycles} cycles")
        ms = 1e3 * rec["dispatch_device_s"]
        base = mp_runs[f"mp2_{'staged' if staged else 'single'}"]
        mp1 = mp_runs[f"mp1_{'staged' if staged else 'single'}"]
        rows[name] = dict(positions=devs, staged=staged, dispatches=rec["dispatches"],
                          device_cycles=cycles, launches=launches,
                          dispatch_device_ms=ms,
                          device_ms_over_inturn=ms / base["dispatch_device_ms"],
                          device_ms_over_mp1=ms / mp1["dispatch_device_ms"],
                          exchange_share=(launches["pair_exchange"] / 2 * xchg["ms"]
                                          / ms),
                          per_worker_tree=rec["per_worker_tree"],
                          graph_build_s=rec["graph_build_s"],
                          phase2_s=rec["phases"][1][2], elapsed_s=rec["elapsed_s"])
        check(rec["per_worker_tree"] == base["per_worker_tree"],
              f"mesh_mp_copies {name}: shard trees {rec['per_worker_tree']} != "
              f"the in-turn layout's {base['per_worker_tree']}")
        emit(f"mesh_mp_copies_{name}", **rows[name])
    prob = PFSPProblem(inst=14, lb="lb2", ub=1)
    pool = SoAPool(prob.node_fields())
    pool.push_back(index_batch(prob.root(), 0))
    _, _, best = warmup(prob, pool, prob.initial_ub, 400)
    frontier = pool.as_batch()
    M = 49152
    C = 2 * M * prob.child_slots
    for name, devs, staged in runs:
        a = get_mesh_program(prob, 2, 25, M, 4, 2, 8192, C, dev, fused=False,
                             staged=staged, mp=2)
        b = get_mesh_program(prob, 2, 25, M, 4, 2, 8192, C, fused=False,
                             staged=staged, mp=2, devices=devs.split(","))
        sizes = []
        try:
            check(b.copied and len(b.groups) == len(devs.split(",")),
                  f"mesh_mp_copies {name}: groups {[g.shards for g in b.groups]}")
            for prog in (a, b):
                prog.host_slots(1)
                prog.upload(frontier, best)
            for _ in range(3):
                ra = a.enqueue()()[0]
                rb = b.enqueue()()[0]  # the read holds every copy to its primary
                check(loop_rows(ra) == loop_rows(rb),
                      f"mesh_mp_copies {name}: state rows differ")
                for d, _, state in b.copy_states():
                    s = ra[d][0]
                    check(torch.equal(a.states[d].pool_vals[:s], state.pool_vals[:s])
                          and torch.equal(a.states[d].pool_aux[:s], state.pool_aux[:s]),
                          f"mesh_mp_copies {name}: a copy of shard {d}'s live rows differ")
                sizes.append([r[0] for r in ra])
            errs = [int(g.st[j, 15]) for g in b.groups for j in range(len(g.copies))]
            check(not any(errs), f"mesh_mp_copies {name}: error words {errs}")
        finally:
            a.release()
            b.release()
        emit("mesh_mp_copies_rows", run=name, positions=devs, shard_sizes=sizes,
             groups=[g.shards for g in b.groups], error_words=errs, equal=True)
    return rows


#: The copies' CLI line of phase 18r (ta014 lb2, two copies of each of two
#: shards over two positions of the card).
COPIES_CLI = ["pfsp", "--inst", "14", "--lb", "lb2", "--ub", "1", "--tier", "mesh",
              "--D", "2", "--mp", "2", "--device", "cuda:0,cuda:0"]


def phase_copies_traced() -> dict:
    """Phase 18r: copies of one shard on one card under a trace, refused.
    The CLI exits 2 on ``COPIES_CLI`` with ``--profile`` (the reason on
    stderr, nothing run) and runs the same line untraced to the goldens.
    Then one dispatch of the copies' mesh (ta014 lb2 D = 2, mp = 2 staged,
    M = 49152, K = 16) over two and four positions of the card, untraced
    and then under ``torch.profiler``: ``MeshProgram`` raises the reason
    before it launches anything (where before the copies' waits timed out
    after 20 s), and an untraced dispatch after it still runs."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from tpu_tree_search_torch import cli
    from tpu_tree_search_torch.engine.device import warmup
    from tpu_tree_search_torch.parallel.resident_mesh import COPIES_TRACED, MeshProgram
    from tpu_tree_search_torch.pool.pool import SoAPool
    from tpu_tree_search_torch.problems import PFSPProblem
    from tpu_tree_search_torch.problems.base import index_batch

    err = io.StringIO()
    with tempfile.TemporaryDirectory() as d, contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(COPIES_CLI + ["--profile", d])
        wrote = os.listdir(d)
    check(rc == 2 and COPIES_TRACED in err.getvalue() and not wrote,
          f"--profile of copies on one card: rc {rc}, {err.getvalue()[-200:]!r}, {wrote}")
    rec = run_search(COPIES_CLI, GOLDEN_LB2)
    out = {"cli": dict(rc=rc, reason=err.getvalue().strip()[-160:],
                       untraced_dispatches=rec["dispatches"],
                       untraced_elapsed_s=rec["elapsed_s"])}
    prob = PFSPProblem(inst=14, lb="lb2", ub=1)
    pool = SoAPool(prob.node_fields())
    pool.push_back(index_batch(prob.root(), 0))
    _, _, best = warmup(prob, pool, prob.initial_ub, 2000)
    frontier = pool.as_batch()
    M = 49152
    for G in (2, 4):
        prog = MeshProgram(prob, 2, 25, M, 16, 2, 8192, 2 * M * prob.child_slots,
                           fused=False, staged=True, mp=2, devices=["cuda:0"] * G)
        try:
            prog.host_slots(1)
            prog.upload(frontier, best)
            _, _, ms = prog.enqueue()()
            prog.upload(frontier, best)
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CUDA]):
                try:
                    prog.enqueue()
                    row = dict(refused=False)
                except RuntimeError as e:
                    row = dict(refused=COPIES_TRACED in str(e), error=str(e)[:120])
                torch.cuda.synchronize()
            row.update(refuse_wall_s=time.perf_counter() - t0, untraced_ms=ms)
            _, _, ms2 = prog.enqueue()()
            row.update(untraced_after_ms=ms2)
        finally:
            prog.close()
        check(row["refused"], f"copies over {G} positions dispatched under a trace: {row}")
        out[f"positions{G}"] = row
    emit("copies_traced", **out)
    return out


def pair_exchange_row(xchg: dict, copies: dict) -> dict:
    """The kernels line's row of the pair exchange (not a TPU kernel: the
    JAX ``lax.pmax`` over the mp axis): the launches of phase 18p's staged
    run over two positions, phase 18o's times."""
    return {"name": "pair_exchange", "route": "cuda",
            "source": "tpu_tree_search_torch/csrc/pair_exchange.cu",
            "replaces": "tpu_tree_search/ops/pfsp_device.py:893",
            "launches": copies["copies2_staged"]["launches"]["pair_exchange"],
            "launches_path": "mesh_mp_copies copies2_staged",
            "shape": "two copies on one card, 983040 int32 words (M=49152, n=20)",
            "max_abs_err": xchg["max_abs_err"], "ms": xchg["ms"],
            "timing": xchg["timing"], "kernel_ms": xchg["kernel_ms"],
            "kernel_split": xchg["kernel_split"], "plain_ms": xchg["plain_ms"],
            "bound_ms": xchg["bound_ms"], "bound_by": xchg["bound_by"],
            "library_ms": None,
            "copies_launches": {k: r["launches"].get("pair_exchange", 0)
                                for k, r in copies.items()}}


def phase_whole_profile() -> dict:
    """Phase 18q: ``--profile DIR`` on the fused ta014 lb1 search (the
    goldens, and the Chrome trace naming kernel 2's launches), then, in a
    process of its own (a CUPTI fault would end it), on the unfused ta014
    lb1 M = 1024 search, whose whole trace faulted (ROADMAP C): the
    goldens, the window the CLI prints (K capped, the dispatches traced of
    all, their graph-body launches within the budget) and the trace
    written."""
    import os
    import re
    import tempfile

    with tempfile.TemporaryDirectory() as out:
        rec = run_search(PFSP_LB1 + ["--profile", out], GOLDEN)
        path = os.path.join(out, "torch_profile.json")
        text = open(path).read()
        size = os.path.getsize(path)
    named = {k: text.count(k) for k in CYCLE_KERNELS}
    check(all(named.values()), f"--profile: the trace names kernel 2's launches {named}")
    row = dict(trace_bytes=size, kernel2_names=named, dispatches=rec["dispatches"],
               device_cycles=rec["device_cycles"], elapsed_s=rec["elapsed_s"])
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "tpu_tree_search_torch", *PFSP_LB1,
                            "--M", "1024", "--unfused", "--profile", out, "--json"],
                           cwd=here, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        path = os.path.join(out, "torch_profile.json")
        tsize = os.path.getsize(path) if os.path.exists(path) else 0
    lines = p.stdout.strip().splitlines()
    check(p.returncode == 0 and lines, f"--profile of the unfused M=1024 search: rc "
          f"{p.returncode}, {p.stderr[-400:]!r}")
    urec = json.loads(lines[-1])
    got = {k: urec[k] for k in GOLDEN}
    check(got == GOLDEN, f"--profile unfused M=1024 counts {got} != golden {GOLDEN}")
    window = next((ln for ln in lines if ln.startswith("Profile window:")), "")
    m = re.search(r"dispatches 1\.\.(\d+) of (\d+) traced, (\d+) graph-body launches, "
                  r"budget (\d+)", window)
    check(m is not None and tsize > 0, f"--profile unfused: window {window!r}, trace {tsize} B")
    i, n, launches, budget = (int(v) for v in m.groups())
    check(1 <= i <= n == urec["dispatches"] and launches <= budget,
          f"--profile unfused: {window!r} for {urec['dispatches']} dispatches")
    row["unfused_M1024"] = dict(window=window, traced_dispatches=i, dispatches=n,
                                traced_launches=launches, budget=budget, K=urec["K"],
                                device_cycles=urec["device_cycles"], trace_bytes=tsize,
                                phase2_s=urec["phases"][1][2], wall_s=wall)
    emit("whole_profile", **row)
    return row


def main_copies(dev_info) -> int:
    """``--copies``: only the mesh's shard copies under mp (phases 18j,
    18o, 18p, 18r) and ``--profile`` (18q) after the build."""
    counters = kernel_counters()
    xchg = phase_pair_exchange(torch.device("cuda", 0))
    mp_runs = phase_mesh_mp(counters)
    copies = phase_mesh_mp_copies(counters, mp_runs, xchg)
    phase_copies_traced()
    phase_whole_profile()
    print(json.dumps({"kernels": [pair_exchange_row(xchg, copies)]}), flush=True)
    print(json.dumps({"ok": True, "phases": "copies", "device": dev_info}), flush=True)
    return 0


def main_mp(dev_info) -> int:
    """``--mp``: only the pair axis and the device positions (phases 18j to
    18m) after the build."""
    from tpu_tree_search_torch.problems import PFSPProblem

    dev = torch.device("cuda", 0)
    counters = kernel_counters()
    lb2_tables = {f"ta{i:03d}": PFSPProblem(inst=i, lb="lb2", ub=1).device_tables(dev)
                  for i in (14, 21)}
    blocks = phase_pair_blocks(dev, lb2_tables)
    mp_runs = phase_mesh_mp(counters)
    gate = phase_slot_gate(dev)
    phase_mesh_eval(dev)
    phase_mesh_cards(counters)
    print(json.dumps({"kernels": pair_block_rows(mp_runs, blocks)
                      + [slot_gate_row(gate, mp_runs)]}), flush=True)
    print(json.dumps({"ok": True, "phases": "mp", "device": dev_info}), flush=True)
    return 0


def kernel_counters() -> dict:
    """Every kernel wrapper (and the graph dispatch) by name: each counts
    its launches in ``launches``."""
    from tpu_tree_search_torch.ops import cycle as C
    from tpu_tree_search_torch.ops import cycle_nqueens as CN
    from tpu_tree_search_torch.ops import (
        lb1_d_kernel,
        lb1_kernel,
        lb2_kernel,
        lb2_self_kernel,
        nqueens_kernel,
    )
    from tpu_tree_search_torch.ops import tiled as T
    from tpu_tree_search_torch.ops.dispatch import (
        BatchGraph,
        DispatchGraph,
        batch_cond,
        batch_cond_obs,
        batch_init,
        dispatch_cond,
        dispatch_cond_obs,
        dispatch_init,
        phase_mark_cuda,
        slot_gate,
    )
    from tpu_tree_search_torch.ops.mesh import MeshGraph, mesh_balance_cuda
    from tpu_tree_search_torch.ops.pair_exchange import pair_exchange_cuda

    return {"lb1_bounds": lb1_kernel.lb1_bounds_cuda,
            "cycle_lb1": C.cycle_lb1_cuda,
            "nqueens_labels": nqueens_kernel.nqueens_labels_cuda,
            "cycle_nqueens": CN.cycle_nqueens_cuda,
            "lb1_d_bounds": lb1_d_kernel.lb1_d_bounds_cuda,
            "lb2_bounds": lb2_kernel.lb2_bounds_cuda,
            "lb2_self_bounds": lb2_self_kernel.lb2_self_bounds_cuda,
            "lb2_block": lb2_kernel.lb2_block_cuda,
            "lb2_self_block": lb2_self_kernel.lb2_self_block_cuda,
            "cycle_lb2": C.cycle_lb2_cuda,
            "tiled_lb1": T.tiled_lb1_cuda,
            "tiled_nqueens": T.tiled_nqueens_cuda,
            "tiled_lb2": T.tiled_lb2_cuda,
            "dispatch_graph": DispatchGraph,
            "dispatch_init": dispatch_init,
            "dispatch_cond": dispatch_cond,
            "dispatch_cond_obs": dispatch_cond_obs,
            "phase_mark": phase_mark_cuda,
            "batch_graph": BatchGraph,
            "batch_init": batch_init,
            "batch_cond": batch_cond,
            "batch_cond_obs": batch_cond_obs,
            "slot_gate": slot_gate,
            "mesh_balance": mesh_balance_cuda,
            "mesh_graph": MeshGraph,
            "pair_exchange": pair_exchange_cuda}


def main_host(dev_info) -> int:
    """``--host``: only the single-device tiers beside the resident engine
    (phase 18c), in a process whose kernels have not run yet: the offload
    runs twice, first use (``run`` "cold") then again ("warm"), then once
    more under ``torch.profiler`` (staged ta014 lb2: device time against
    phase 2), then the sequential tier, the cuts and the host phases; the
    last line says which phases ran."""
    counters = kernel_counters()
    phase_offload(counters, "cold")
    phase_offload(counters, "warm")
    phase_offload_profile()
    phase_seq(counters)
    phase_checkpoint(counters)
    phase_host_phases()
    print(json.dumps({"ok": True, "phases": "host", "device": dev_info}), flush=True)
    return 0


# The --cupti probes of the unfused ta014 lb1 graph at M = 1024 (2,519
# cycles, two dispatches at the CLI's K): (name, extra argv, traced, the
# capture pools kept for the process's life, under compute-sanitizer); a
# run cut by --max-steps is checked against no golden.
# The explicit survivor-path modes beside the auto one (dense at M = 1024 and
# on N-Queens): the unfused searches of each, and a guarded N = 14 under
# sort and search.
COMPACT_MODES = ("scatter", "sort", "search")
COMPACT_RUNS = [
    ("ta014_lb1_M1024", PFSP_LB1 + ["--M", "1024", "--unfused"], GOLDEN,
     "lb1_bounds"),
    ("nqueens_N14", NQ14 + ["--unfused"], NQ_GOLDEN[14], "nqueens_labels"),
    ("ta014_lb2_staged", PFSP_LB2 + ["--unfused"], GOLDEN_LB2,
     "lb2_self_bounds"),
]


def phase_compact(counters: dict) -> dict:
    """The unfused searches under each explicit ``--compact`` mode (the JAX
    ``TTS_COMPACT``), each to its goldens with every count set to 0 just
    before it: the record names the mode, the body's kernel ran once a
    cycle; then a guarded unfused N = 14 under sort and under search, every
    dispatch after the first checked (no host read: a stable sort's and a
    searchsorted's scratch come from the graph's pool)."""
    rows = {}
    for mode in COMPACT_MODES:
        for name, argv, golden, kernel in COMPACT_RUNS:
            rec = phase_search(f"compact_{mode}_{name}", argv + ["--compact", mode],
                               counters, golden)
            check(rec["compact"] == mode and not rec["fused"]
                  and rec["launches"][kernel] > 0,
                  f"compact {mode} {name}: compact {rec['compact']}, fused "
                  f"{rec['fused']}, {rec['launches'][kernel]} {kernel} launches")
            rows[f"{mode}/{name}"] = dict(
                phase2_s=rec["phases"][1][2], dispatches=rec["dispatches"],
                device_cycles=rec["device_cycles"],
                dispatch_device_ms=1e3 * (rec.get("dispatch_device_s") or 0.0))
    for mode in ("sort", "search"):
        zero_counts(counters)
        rec = run_search(NQ14 + ["--unfused", "--guard", "--K", "64", "--compact", mode],
                         NQ_GOLDEN[14])
        g = rec.get("guard") or {}
        check(rec["compact"] == mode and g.get("checked_dispatches", 0) > 1
              and "sync" in g.get("checks", ())
              and counters["dispatch_graph"].launches == rec["dispatches"],
              f"guarded unfused N=14 under {mode}: guard {g}, "
              f"{counters['dispatch_graph'].launches} graph launches for "
              f"{rec['dispatches']} dispatches")
        rows[f"guard/{mode}"] = dict(outcome="completed", guard=g,
                                     dispatches=rec["dispatches"],
                                     phase2_s=rec["phases"][1][2])
    emit("compact_modes", **{k.replace("/", "_"): v for k, v in rows.items()})
    return rows


def phase_check() -> dict:
    """``check`` through the CLI with no ``--device``, which is the card
    (`analysis/program_audit.py`): every matrix
    cell's program built on the card and its cycle captured into its
    dispatch graph under the recorder, the graph's node lists (names and
    types, outer and body) held to the contracts, beside the variants, the
    cache keys, the bare compactions, the pair blocks, the batches and the
    mesh graphs (every graph nested in a body too); the findings on a
    line, which must be none. Node kinds ride along: two cells' (the
    unfused dense lb1 body, the fused one), an unfused batch's and an
    unfused mesh's, each nested graph apart."""
    from collections import Counter

    from tpu_tree_search_torch import cli
    from tpu_tree_search_torch.analysis import program_audit as PA

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["check", "--json"])
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    kinds = {}
    for cell in (PA.Cell("pfsp-lb1", compact="dense"),
                 PA.Cell("pfsp-lb1", cycle="fused", obs="1")):
        art = PA.record_cell(cell, device="cuda")
        kinds[cell.key] = {part: dict(Counter(k for _, k in art.nodes[part]))
                           for part in ("outer", "body")}
    # The graphs nested in a body: the batch slots' and mesh shards' gated
    # bodies, a mesh round's body and balance step.
    for key, nodes in (
            ("batched|nqueens|B2|unfused",
             PA.batched_artifact(2, False, "cuda")["record"].nodes),
            ("mesh|nqueens|D2|unfused", PA.mesh_record(False, "cuda").nodes)):
        kinds[key] = {part: dict(Counter(k for _, k in got))
                      for part, got in nodes.items()}
    out = dict(rc=rc, cells=res["cells"], contracts=res["contracts"],
               findings=res["findings"], warnings=res["warnings"],
               node_kinds=kinds, seconds=time.perf_counter() - t0)
    emit("check", **out)
    check(rc == 0 and not res["findings"], f"check on the card: rc {rc}, "
          f"{len(res['findings'])} finding(s): {res['findings'][:8]}")
    return out



def capture_headline_graphs() -> dict:
    """The headline programs' dispatch graphs captured at the CLI's shapes,
    past check's small ones: the fused ta014 lb1 dispatch at M = 49152
    (uncached, freed after), and the ta014 lb2 --mp 2 mesh of D = 2 shards
    over two positions of the card (cuda:0, cuda:0: a copy of each shard at
    each, joined by the pair exchange), every group's round graphs. Returns
    each one's body node count."""
    from tpu_tree_search_torch.engine import resident as R
    from tpu_tree_search_torch.parallel.resident_mesh import MeshProgram
    from tpu_tree_search_torch.problems import PFSPProblem

    out = {}
    prob = PFSPProblem(inst=14, lb="lb1", ub=1)
    M, n = 49152, prob.child_slots
    fr = _frontier(prob, M + M // 2)
    prog = R.new_program(prob, 25, M, 4,
                         2 * fr[prob.vals_field].shape[0] + 2 * M * n, "cuda")
    try:
        state = prog.own_state(fr, getattr(prob, "initial_ub", INF))
        out["ta014_lb1_fused_M49152"] = len(prog._graph(state).nodes())
    finally:
        prog.close()
    lb2 = PFSPProblem(inst=14, lb="lb2", ub=1)
    M = 1024
    fr = _frontier(lb2, 2 * M)
    mesh = MeshProgram(lb2, 2, 25, M, 4, 2, 50, 4 * M * lb2.child_slots,
                       devices=["cuda:0", "cuda:0"], fused=False, staged=True,
                       mp=2)
    try:
        mesh.upload(fr, getattr(lb2, "initial_ub", INF))
        out["ta014_lb2_mesh_D2_mp2_copies"] = {
            f"group{i}.round{r}": len(mesh.graph(i, r).nodes())
            for i in range(len(mesh.groups)) for r in range(mesh.rounds)}
    finally:
        mesh.close()
    return out


def phase_capture_lint() -> dict:
    """The capture rules held to what the card's captures really enter
    (`analysis/torch_rules.py`): phase check (every matrix cell's dispatch
    graph, the variants, the batched graphs at B = 1, 2, the mesh graphs,
    the --mp copies') and the headline graphs (``capture_headline_graphs``)
    run under ``EnteredFunctions``, which records each function of the
    port's package that starts or resumes, on any thread, while
    ``torch.cuda.is_current_stream_capturing()`` is true (it reads code
    objects only, no tensor). Every recorded function must be in the
    lint's captured set (``captured_keys`` over the package), and the
    capture rules must find nothing new in the package. The line: the
    functions entered under capture, the captured set's size, the missing
    ones (none), the findings, the seconds."""
    import tpu_tree_search_torch as pkg
    from tpu_tree_search_torch.analysis import lint
    from tpu_tree_search_torch.analysis.torch_rules import (
        JAX_COUNTERPART,
        EnteredFunctions,
        captured_keys,
    )

    root = os.path.dirname(os.path.abspath(pkg.__file__))
    t0 = time.perf_counter()
    with EnteredFunctions(root, torch.cuda.is_current_stream_capturing) as probe:
        out = phase_check()
        headline = capture_headline_graphs()
    probe_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    captured = captured_keys([root])
    missing = [(os.path.relpath(p, root), name, line)
               for p, name, line in probe.missing(captured)]
    res = lint([root], rules=sorted(JAX_COUNTERPART))
    entered = sorted((os.path.relpath(p, root), name, line)
                     for p, name, line in probe.seen)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "capture_lint_entered.json"), "w") as f:
        json.dump({"entered": entered, "missing": missing}, f, indent=0)
    line = dict(entered=len(entered), captured=len(captured), missing=missing,
                new_findings=[x.render() for x in res["new"]],
                waived=len(res["waived"]), headline=headline,
                check_s=out["seconds"], probe_s=probe_s,
                lint_s=time.perf_counter() - t1,
                seconds=time.perf_counter() - t0)
    emit("capture_lint", **line)
    check(entered and not missing and not res["new"],
          f"capture lint: {len(missing)} function(s) entered under capture "
          f"outside the captured set {missing[:8]}, "
          f"{len(res['new'])} new finding(s)")
    return line

CUPTI_UNFUSED = PFSP_LB1 + ["--M", "1024", "--unfused"]
CUPTI_PROBES = (("untraced", [], False, False, False),
                ("memcheck", [], False, False, True),
                ("traced", [], True, False, False),
                ("traced_pools_kept", [], True, True, False),
                ("traced_K512", ["--K", "512"], True, False, False),
                ("traced_cut_1x1000", ["--K", "1000", "--max-steps", "1"], True, False,
                 False),
                ("traced_cut_4x250", ["--K", "250", "--max-steps", "4"], True, False,
                 False),
                ("traced_cut_1x2000", ["--K", "2000", "--max-steps", "1"], True, False,
                 False),
                ("traced_cut_8x250", ["--K", "250", "--max-steps", "8"], True, False,
                 False),
                ("traced_eager", ["--eager"], True, False, False))
#: The faulting probe (traced at the CLI's K) under each explicit survivor-path
#: mode (``--cupti-modes``): whether the fault follows the compaction it swaps;
#: and the clean modes' search run twice in one traced process (``--twice``),
#: past the kernel records of the dense one's single run.
CUPTI_MODE_PROBES = (("untraced", [], False, False, False),) + tuple(
    (f"traced_{mode}", ["--compact", mode], True, False, False)
    for mode in ("scatter", "sort", "search", "dense")) + tuple(
    (f"traced_{mode}_twice", ["--compact", mode, "--twice"], True, False, False)
    for mode in ("scatter", "search")) + (
    # Dispatches of 250 cycles, one in flight (TTS_PIPELINE=1): traced
    # whole (11 dispatches, about 560,000 kernel records of the dense
    # body), and under a torch.profiler schedule that stops recording once
    # the fourth dispatch is read (about 223,000), the rest run untraced.
    ("traced_dense_k250", ["--compact", "dense", "--K", "250", "--pipe1"], True,
     False, False),
    ("traced_dense_k250_sched", ["--compact", "dense", "--K", "250", "--pipe1",
                                 "--sched"], True, False, False))


def cupti_run(name: str) -> int:
    """One probe of CUPTI_PROBES in this process: the search, traced on
    the device alone or not; one JSON line (its counts against the
    goldens, dispatches, body runs a dispatch, the trace's kernel launches
    and device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_tree_search_torch.ops import dispatch as D

    _, extra, traced, keep, _ = next(p for p in CUPTI_PROBES + CUPTI_MODE_PROBES
                                     if p[0] == name)
    if keep:
        class _KeepAll(list):
            def clear(self):  # the retired pools are never destroyed
                pass
        D._RETIRED = _KeepAll()
    if "--pipe1" in extra:
        import os

        os.environ["TTS_PIPELINE"] = "1"
    t0 = time.perf_counter()
    argv = CUPTI_UNFUSED + [a for a in extra
                            if a not in ("--eager", "--twice", "--pipe1", "--sched")]
    window: dict = {}

    def ready(p):
        evs = [e for e in p.key_averages() if e.device_type == DeviceType.CUDA]
        window.update(trace_launches=sum(e.count for e in evs),
                      trace_device_ms=sum(e.self_device_time_total for e in evs) / 1e3)

    with contextlib.ExitStack() as stack:
        if "--eager" in extra:
            stack.enter_context(eager_cycles())
        sched = {}
        if "--sched" in extra:
            from torch.profiler import schedule

            sched = dict(schedule=schedule(wait=0, warmup=0, active=4, repeat=1),
                         on_trace_ready=ready)
        prof = (stack.enter_context(profile(activities=[ProfilerActivity.CUDA], **sched))
                if traced else None)
        if sched:
            # A profiler step at each dispatch's read: the window closes
            # once the fourth dispatch has run.
            count = D.DispatchGraph.count

            def stepped(self, runs, _count=count):
                _count(self, runs)
                prof.step()
            D.DispatchGraph.count = stepped
        for _ in range(2 if "--twice" in extra else 1):
            rec = run_search(argv, None if "--max-steps" in extra else GOLDEN)
            torch.cuda.synchronize()
    out = dict(probe=name, dispatches=rec["dispatches"], K=rec["K"],
               complete=rec.get("complete"),
               device_cycles=rec["device_cycles"],
               cycles_per_dispatch=rec["device_cycles"] / max(1, rec["dispatches"]),
               phase2_s=rec["phases"][1][2], seconds=time.perf_counter() - t0)
    if window:
        out.update(window, scheduled=True)
    elif prof is not None:
        ready(prof)
        out.update(window)
    print(json.dumps(out), flush=True)
    return 0


def main_cupti(dev_info, probes=CUPTI_PROBES) -> int:
    """``--cupti [DIR]``: the probes of CUPTI_PROBES (``--cupti-modes [DIR]``:
    of CUPTI_MODE_PROBES), a process each (a fault ends its process, not
    the script): each one's exit code, its line, and the tail of its
    errors; each one's whole output in DIR (default ``_checkout/cupti``
    beside this script). Fails only where the untraced search fails."""
    import os
    import shutil

    here = os.path.dirname(os.path.abspath(__file__))
    logs = sys.argv[2] if len(sys.argv) > 2 else os.path.join(here, "_checkout", "cupti")
    os.makedirs(logs, exist_ok=True)
    rows = {}
    for name, _, _, _, sanitize in probes:
        cmd = [sys.executable, os.path.abspath(__file__), "--cupti-run", name]
        if sanitize:
            tool = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/compute-sanitizer"
            cmd = [tool, "--tool", "memcheck", "--print-limit", "20"] + cmd
        t0 = time.perf_counter()
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=480 if sanitize else 300)
            rc, out, err = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as e:
            rc = "timeout"
            out = e.stdout.decode(errors="replace") if isinstance(e.stdout, bytes) else (e.stdout or "")
            err = e.stderr.decode(errors="replace") if isinstance(e.stderr, bytes) else (e.stderr or "")
        except OSError as e:
            rc, out, err = "not run", "", repr(e)
        with open(os.path.join(logs, f"{name}.log"), "w") as f:
            f.write(f"{cmd}\nrc {rc}\n--- stdout\n{out}\n--- stderr\n{err}")
        line = next((ln for ln in reversed(out.splitlines()) if ln.startswith('{"probe"')),
                    None)
        marks = [ln.strip() for ln in err.splitlines()
                 if "rror" in ln or "illegal" in ln or "terminate" in ln][:6]
        rows[name] = dict(rc=rc, seconds=time.perf_counter() - t0,
                          result=json.loads(line) if line else None,
                          stdout_tail=out.splitlines()[-12:] if sanitize else None,
                          stderr_errors=marks)
        emit(f"cupti_{name}", **rows[name])
    check(rows["untraced"]["rc"] == 0, "the untraced unfused search failed")
    print(json.dumps({"ok": True, "phases": "cupti", "device": dev_info}), flush=True)
    return 0


def main_check(dev_info) -> int:
    """``--check``: only the program contracts on the card (phase check) and
    the unfused searches under each explicit survivor-path mode (phase
    compact_modes, guarded N = 14 included), check under the capture
    probe (phase capture_lint) between two runs of check without it (phase
    probe_cost: the probe's cost, A B A)."""
    before = phase_check()
    probed = phase_capture_lint()
    after = phase_check()
    emit("probe_cost", check_s_unprobed_before=before["seconds"],
         check_s_probed=probed["check_s"],
         check_s_unprobed_after=after["seconds"])
    phase_compact(kernel_counters())
    print(json.dumps({"ok": True, "phases": "check", "device": dev_info}), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--cupti-run"]:
        return cupti_run(sys.argv[2])
    dev_info = phase_device()
    if sys.argv[1:] in (["--cycles"], ["--host"], ["--serve"], ["--parallel"],
                        ["--dist"], ["--fleet"], ["--mp"], ["--copies"], ["--cupti"],
                        ["--cupti-modes"], ["--check"]) or (
            sys.argv[1:2] in (["--cupti"], ["--cupti-modes"]) and len(sys.argv) == 3):
        phase_build()
        if sys.argv[1] == "--cupti":
            return main_cupti(dev_info)
        if sys.argv[1] == "--cupti-modes":
            return main_cupti(dev_info, CUPTI_MODE_PROBES)
        if sys.argv[1] == "--check":
            return main_check(dev_info)
        if sys.argv[1] == "--mp":
            return main_mp(dev_info)
        if sys.argv[1] == "--copies":
            return main_copies(dev_info)
        if sys.argv[1] == "--host":
            return main_host(dev_info)
        if sys.argv[1] == "--fleet":
            return main_fleet(dev_info)
        if sys.argv[1] == "--dist":
            return main_dist(dev_info)
        if sys.argv[1] == "--serve":
            return main_serve(torch.device("cuda", 0), dev_info)
        if sys.argv[1] == "--parallel":
            return main_parallel(torch.device("cuda", 0), dev_info)
        return main_cycles(torch.device("cuda", 0), dev_info)
    from tpu_tree_search_torch.ops import cycle as C
    from tpu_tree_search_torch.ops import cycle_nqueens as CN
    from tpu_tree_search_torch.ops import tiled as T
    from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem

    phase_build()
    dev = torch.device("cuda", 0)
    tables = PFSPProblem(inst=14, lb="lb1", ub=1).device_tables(dev)
    lb2_tables = {f"ta{i:03d}": PFSPProblem(inst=i, lb="lb2", ub=1).device_tables(dev)
                  for i in (14, 21, 51, 81)}
    lb1_tables = lb1_family_tables(dev)
    k1 = phase_lb1_family("kernel1", dev, lb1_tables)
    k2 = phase_pfsp_cycle("kernel2", dev, tables, "lb1", 1)
    # ta051 (50 jobs): two keep-mask words a parent, on an int32 pool.
    ta051 = PFSPProblem(inst=51, lb="lb1", ub=1).device_tables(dev)
    k2_51 = phase_pfsp_cycle("kernel2", dev, ta051, "lb1", 51, dtype=torch.int32,
                             inst="ta051")
    k3 = phase_kernel3(dev)
    k4 = phase_kernel4(dev)
    k5 = phase_lb1_family("kernel5", dev, lb1_tables)
    k6 = phase_kernel6(dev, lb2_tables)
    k7 = phase_kernel7(dev, lb2_tables["ta014"])
    k8 = phase_pfsp_cycle("kernel8", dev, lb2_tables["ta014"], "lb2", 8)
    # ta021: 20 machines, P = 190 pairs, where lb2 costs the most.
    k8_21 = phase_pfsp_cycle("kernel8", dev, lb2_tables["ta021"], "lb2", 21,
                             inst="ta021")
    # The streamed cycles: table rows 9b (kernel9), 9a (kernel10) and 9c
    # (kernel11); 9a and 9c also at mt = 8 (four tiles a block of 32
    # parents), 9c also on ta021.
    k9 = phase_pfsp_cycle("kernel9", dev, tables, "lb1", 9, tiled=True)
    k10 = phase_kernel4(dev, "kernel10", tiled=True)
    k11 = phase_pfsp_cycle("kernel11", dev, lb2_tables["ta014"], "lb2", 11, tiled=True,
                           shapes=((1024, 16), (49152, 64), (49152, 8)))
    k11_21 = phase_pfsp_cycle("kernel11", dev, lb2_tables["ta021"], "lb2", 111,
                              tiled=True, inst="ta021", shapes=((49152, 64),))
    # Past the old limits: kernels 6, 7, 8 and 9c on ta101 and ta111 (the
    # global table route), kernels 4 and 9a at N = 48 (two mask words a
    # parent; kernel 3's row is in phase kernel3).
    wide = phase_lb2_wide(dev)
    k4_48 = phase_kernel4(dev, N=48, shapes=[(50000, 80, 1)])
    k10_48 = phase_kernel4(dev, "kernel10", tiled=True, N=48, shapes=[(50000, 80, 1)])
    gd = phase_graph_dispatch(dev)
    bg = phase_batch_graph(dev)
    eval_probs = {"lb1": PFSPProblem(inst=14, lb="lb1", ub=1),
                  "lb2": PFSPProblem(inst=14, lb="lb2", ub=1),
                  "nqueens": NQueensProblem(15)}
    counters = kernel_counters()
    fused = phase_search("search_fused_M49152", PFSP_LB1, counters)
    check(fused["launches"]["cycle_lb1"] > 0, "kernel 2 not launched on the main path")
    fused1k = phase_search("search_fused_M1024", PFSP_LB1 + ["--M", "1024"], counters)
    check(fused1k["launches"]["cycle_lb1"] > 0, "kernel 2 not launched at M=1024")
    unfused = phase_search("search_unfused_M1024",
                           PFSP_LB1 + ["--M", "1024", "--unfused"], counters)
    check(unfused["launches"]["lb1_bounds"] > 0,
          "kernel 1 not launched on the unfused path")
    nq15 = phase_search("search_nqueens_N15_fused",
                        ["nqueens", "--N", "15", "--tier", "device"], counters,
                        NQ_GOLDEN[15])
    check(nq15["fused"] and nq15["launches"]["cycle_nqueens"] > 0,
          "kernel 4 not launched on the fused N-Queens path")
    # The fused cycles set the loop condition themselves; the unfused body
    # ends with dispatch_cond, once a cycle.
    check(fused["launches"]["dispatch_cond"] == nq15["launches"]["dispatch_cond"] == 0
          and unfused["launches"]["dispatch_cond"] == unfused["device_cycles"] > 0,
          "dispatch_cond launched on a fused path, or not once a cycle on the unfused one")
    nq14 = phase_search("search_nqueens_N14_unfused",
                        ["nqueens", "--N", "14", "--tier", "device", "--unfused"],
                        counters, NQ_GOLDEN[14])
    check(not nq14["fused"] and nq14["launches"]["nqueens_labels"] > 0,
          "kernel 3 not launched on the unfused N-Queens path")
    lb1d = phase_search("search_lb1_d", PFSP_LB1D, counters)
    check(not lb1d["fused"] and lb1d["launches"]["lb1_d_bounds"] > 0,
          "kernel 5 not launched on the lb1_d path")
    lb2f = phase_search("search_lb2_fused_M49152", PFSP_LB2, counters, GOLDEN_LB2)
    check(lb2f["fused"] and lb2f["launches"]["cycle_lb2"] > 0,
          "kernel 8 not launched on the fused lb2 path")
    lb2f1k = phase_search("search_lb2_fused_M1024", PFSP_LB2 + ["--M", "1024"],
                          counters, GOLDEN_LB2)
    check(lb2f1k["launches"]["cycle_lb2"] > 0, "kernel 8 not launched at M=1024")
    lb2s = phase_search("search_lb2_unfused_staged", PFSP_LB2 + ["--unfused"],
                        counters, GOLDEN_LB2)
    check(not lb2s["fused"] and lb2s["staged"]
          and lb2s["launches"]["lb1_bounds"] > 0
          and lb2s["launches"]["lb2_self_bounds"] > 0,
          "kernels 1 and 7 not launched on the staged lb2 path")
    lb2u = phase_search("search_lb2_unfused_unstaged", PFSP_LB2, counters,
                        GOLDEN_LB2, fused=False, staged=False)
    check(not lb2u["fused"] and not lb2u["staged"]
          and lb2u["launches"]["lb2_bounds"] > 0,
          "kernel 6 not launched on the unstaged lb2 path")
    lb1t = phase_search("search_lb1_tiled_M49152", PFSP_LB1 + ["--mt", "64"], counters)
    check(lb1t["megakernel_tiled"] and lb1t["megakernel_mt"] == 64
          and lb1t["launches"]["tiled_lb1"] > 0 and lb1t["launches"]["cycle_lb1"] == 0,
          "kernel 9b not launched on the streamed lb1 path")
    lb1t1k = phase_search("search_lb1_tiled_M1024",
                          PFSP_LB1 + ["--M", "1024", "--mt", "16"], counters)
    check(lb1t1k["megakernel_tiled"] and lb1t1k["launches"]["tiled_lb1"] > 0
          and lb1t1k["launches"]["cycle_lb1"] == 0,
          "kernel 9b not launched on the streamed lb1 path at M=1024")
    lb2t = phase_search("search_lb2_tiled_M49152", PFSP_LB2 + ["--mt", "64"], counters,
                        GOLDEN_LB2)
    check(lb2t["megakernel_tiled"] and lb2t["launches"]["tiled_lb2"] > 0
          and lb2t["launches"]["cycle_lb2"] == 0,
          "kernel 9c not launched on the streamed lb2 path")
    nqt = phase_search("search_nqueens_N15_tiled",
                       ["nqueens", "--N", "15", "--tier", "device", "--mt", "80"],
                       counters, NQ_GOLDEN[15])
    check(nqt["megakernel_tiled"] and nqt["launches"]["tiled_nqueens"] > 0
          and nqt["launches"]["cycle_nqueens"] == 0,
          "kernel 9a not launched on the streamed N-Queens path")
    # The dispatch pipeline: ta014 lb1, N-Queens N = 15 and ta014 lb2 (fused)
    # at TTS_PIPELINE 1 and 2 and at --K auto.
    pipe = {}
    for name, argv, golden, kernel, names, per_call in [
            ("ta014_lb1", PFSP_LB1, GOLDEN, "cycle_lb1", CYCLE_KERNELS, 3),
            ("nqueens_N15", ["nqueens", "--N", "15", "--tier", "device"], NQ_GOLDEN[15],
             "cycle_nqueens", NQ_CYCLE_KERNELS, 2),
            ("ta014_lb2", PFSP_LB2, GOLDEN_LB2, "cycle_lb2", LB2_CYCLE_KERNELS, 3)]:
        pipe[name] = phase_pipeline(name, argv, golden, counters, kernel, names,
                                    per_call)
    # Telemetry (obs/): the counter block and the phase clock on the main
    # path's searches, each off, armed, armed, off.
    obsp = phase_obs(dev, counters)
    # The batched engine and the serve daemon.
    serve = phase_serve(dev, counters)
    # The multi-device tiers: the balance step against its plain version,
    # one mesh dispatch against the plain one, then the multi and mesh
    # tiers at D = 2 and 4 on the card.
    bal = phase_mesh_balance(dev)
    mdisp = phase_mesh_dispatch(dev)
    multi = phase_multi(counters)
    mesh = phase_mesh(counters)
    # The multi-host tiers: virtual hosts of both (and a lockstep cut and
    # its resume), then a process a host.
    dist = phase_dist(counters)
    dmesh = phase_dist_mesh(counters)
    phase_dist_procs()
    # The guards and the fleet: the steady-state guard on the resident
    # loops (and its two tampers), then the router over daemons on the card.
    phase_guard(counters)
    fleet = phase_fleet(counters)
    # The lb2 pair axis (kernels 6 and 7 on pair blocks, the mesh tiers
    # under --mp), parallel/mesh.py's evaluator, and device positions.
    blocks = phase_pair_blocks(dev, lb2_tables)
    mp_runs = phase_mesh_mp(counters)
    gate = phase_slot_gate(dev)
    phase_mesh_eval(dev)
    phase_mesh_cards(counters)
    # The shard copies under mp: the pair exchange against its plain
    # version, the mesh over two and four positions of the card; and the
    # whole-session profile.
    xchg = phase_pair_exchange(dev)
    copies = phase_mesh_mp_copies(counters, mp_runs, xchg)
    phase_copies_traced()
    phase_whole_profile()
    # The survivor-path modes (--compact) on the unfused searches, and the
    # program contracts over every cell's dispatch graph.
    phase_compact(counters)
    phase_capture_lint()
    evp = phase_eval_pass(dev, eval_probs, counters)
    check(evp["launches"]["lb1_bounds"] == 1 and evp["launches"]["nqueens_labels"] == 1
          and evp["launches"]["lb2_bounds"] == 2,
          "kernels 1, 3 and 6 not launched once a call on the eval-only pass")
    # The single-device tiers beside the resident engine: the host's
    # sequential search, the offload engine, cut and resume, and the host
    # phases with and without the native runtime.
    phase_seq(counters)
    offload = phase_offload(counters)
    phase_checkpoint(counters)
    phase_host_phases()
    for name, extra, kwargs in [
            ("search_lb2_fused_M49152", [],
             dict(cycle=(C.cycle_lb2_cuda, LB2_CYCLE_KERNELS, 3))),
            ("search_lb2_fused_M1024", ["--M", "1024"],
             dict(cycle=(C.cycle_lb2_cuda, LB2_CYCLE_KERNELS, 3))),
            ("search_lb2_unfused_staged", ["--unfused"], dict(kernels=("lb1_bounds_kernel", "lb2_self_bounds_kernel"))),
            ("search_lb2_unfused_unstaged", [], dict(fused=False, staged=False)),
            ("search_lb2_tiled_M49152", ["--mt", "64"],
             dict(cycle=(T.tiled_lb2_cuda, TILED_KERNELS["lb2"], 3)))]:
        phase_profile(name, PFSP_LB2 + extra, GOLDEN_LB2, **kwargs)
    profs = {}
    # Kernels 1 and 5 on their search paths: their device time a search
    # (the unfused search's 2,519 cycles traced on the device alone).
    phase_profile("search_unfused_M1024", PFSP_LB1 + ["--M", "1024", "--unfused"], GOLDEN,
                  kernels=("lb1_bounds_kernel",), host=False, eager=True)
    phase_profile("search_lb1_d", PFSP_LB1D, GOLDEN, kernels=("lb1_d_bounds_kernel",))
    # Kernel 3 on its search path: its device time over the unfused N=14
    # search's 555 cycles (the device alone, as the unfused lb1 search).
    prof_nq14 = phase_profile("search_nqueens_N14_unfused",
                              ["nqueens", "--N", "14", "--tier", "device", "--unfused"],
                              NQ_GOLDEN[14], kernels=("nqueens_labels_kernel",), host=False)
    # The streamed searches beside the single-tile ones, in the same run;
    # the single-tile ones count kernel 2's and kernel 4's launches a cycle.
    for name, argv, golden, cycle in [
            ("search_fused_M49152", PFSP_LB1, GOLDEN,
             (C.cycle_lb1_cuda, CYCLE_KERNELS, 3)),
            ("search_lb1_tiled_M49152", PFSP_LB1 + ["--mt", "64"], GOLDEN,
             (T.tiled_lb1_cuda, TILED_KERNELS["lb1"], 3)),
            ("search_nqueens_N15_fused", ["nqueens", "--N", "15", "--tier", "device"],
             NQ_GOLDEN[15], (CN.cycle_nqueens_cuda, NQ_CYCLE_KERNELS, 2)),
            ("search_nqueens_N15_tiled",
             ["nqueens", "--N", "15", "--tier", "device", "--mt", "80"], NQ_GOLDEN[15],
             (T.tiled_nqueens_cuda, TILED_KERNELS["nqueens"], 2))]:
        profs[name] = phase_profile(name, argv, golden, cycle)

    k1_main = k1[("ta014", 1024, "torch.int8")]
    k2_main = k2[(49152, "full", "finite")]
    kernels = [
        {"name": "lb1_bounds", "route": "cuda",
         "source": "tpu_tree_search_torch/csrc/lb1_bounds.cu",
         "replaces": "tpu_tree_search/ops/pallas_kernels.py:535",
         "launches": unfused["launches"]["lb1_bounds"],
         "launches_path": "search_unfused_M1024",
         "shape": "B=1024 int8",
         "max_abs_err": max(r["max_abs_err"] for r in k1.values()),
         "ms": k1_main["ms"], "timing": k1_main["timing"], "call_ms": k1_main["call_ms"],
         "plain_ms": k1_main["plain_ms"],
         "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
         "library_ms": None, "block": k1_main["block"]},
        {"name": "cycle_lb1", "route": "cuda",
         "source": "tpu_tree_search_torch/csrc/cycle_lb1.cu",
         "replaces": "tpu_tree_search/ops/megakernel.py:570",
         "launches": fused["launches"]["cycle_lb1"],
         "captures": fused["captures"]["cycle_lb1"],
         "launches_path": "search_fused_M49152",
         "shape": "M=49152 full chunk, finite incumbent",
         "max_abs_err": max(r["max_abs_err"] for r in [*k2.values(), *k2_51.values()]),
         "ms": k2_main["ms"], "timing": k2_main["timing"], "call_ms": k2_main["call_ms"],
         "plain_ms": k2_main["plain_ms"],
         "bound_ms": k2_main["bound_ms"], "bound_by": k2_main["bound_by"],
         "library_ms": None, "launch_ms": k2_main["launch_ms"],
         "launches_per_cycle": k2_main["launches_per_cycle"]},
    ]
    k3_main = k3[(14, 50000, 1)]
    k4_main = k4[(50000, "full")]
    k5_main = k5[("ta014", 49152, "torch.int8")]
    for name, source, replaces, path, shape, rows, main_row in [
        ("nqueens_labels", "nqueens_labels.cu", "pallas_kernels.py:361",
         nq14, "B=50000 N=14 g=1 int8 depth", k3, k3_main),
        ("cycle_nqueens", "cycle_nqueens.cu", "megakernel.py:553",
         nq15, "M=50000 N=15 full chunk", k4, k4_main),
        ("lb1_d_bounds", "lb1_d_bounds.cu", "pallas_kernels.py:611",
         lb1d, "B=49152 int8", k5, k5_main),
        ("lb2_bounds", "lb2_bounds.cu", "pallas_kernels.py:746",
         lb2u, "ta014 B=49152 int8", k6, k6[("ta014", 49152, "torch.int8")]),
        ("lb2_self_bounds", "lb2_self_bounds.cu", "pallas_kernels.py:909",
         lb2s, "ta014 R=49152*20 int8, n_active=R/4 (random_nodes rows)", k7,
         k7[(49152 * 20, 49152 * 20 // 4)]),
        ("cycle_lb2", "cycle_lb2.cu", "megakernel.py:588",
         lb2f, "ta014 M=49152 full chunk, finite incumbent",
         {**k8, **{("ta021",) + k: r for k, r in k8_21.items()}},
         k8[(49152, "full", "finite")]),
        ("tiled_lb1", "tiled_lb1.cu", "megakernel.py:677",
         lb1t, "ta014 M=49152 mt=64 full chunk, finite incumbent", k9,
         k9[(49152, "full", "finite")]),
        ("tiled_nqueens", "tiled_nqueens.cu", "megakernel.py:650",
         nqt, "M=50000 mt=80 N=15 full chunk", k10, k10[(50000, "full")]),
        ("tiled_lb2", "tiled_lb2.cu", "megakernel.py:723",
         lb2t, "ta014 M=49152 mt=64 full chunk, finite incumbent",
         {**k11, **{("ta021",) + k: r for k, r in k11_21.items()}},
         k11[(49152, "full", "finite")]),
        # The eval-only pass's TPU kernels, on kernels 1, 3 and 6.
        ("eval_lb1", "lb1_bounds.cu", "megakernel.py:1115", evp,
         "ta014 B=49152 int8", dict(k1, eval_pass=evp), k1[("ta014", 49152, "torch.int8")]),
        ("eval_nqueens", "nqueens_labels.cu", "megakernel.py:1108", evp,
         "B=50000 N=15 g=1 int8 depth", dict(k3, eval_pass=evp), k3[(15, 50000, 1)]),
        ("eval_lb2", "lb2_bounds.cu", "megakernel.py:1123", evp,
         "ta014 B=49152 int8", dict(k6, eval_pass=evp), k6[("ta014", 49152, "torch.int8")]),
    ]:
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tpu_tree_search_torch/csrc/{source}",
            "replaces": f"tpu_tree_search/ops/{replaces}",
            "launches": path["launches"][EVAL_KERNEL.get(name, name)],
            # The cycles' rows: the graph captures beside the launches.
            **({"captures": path["captures"][name]}
               if name in path.get("captures", {}) else {}),
            "launches_path": path["phase"],
            "shape": shape,
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "ms": main_row["ms"], "timing": main_row["timing"],
            "call_ms": main_row["call_ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": None,
            # The lb2 rows: the per-child recurrence's bound (kernel 7: the
            # all-slots count, and its work split); the lb1_d, lb2 and
            # labels rows: the block shape; the cycles' rows: the device time
            # by launch and the launches a cycle.
            **{k: main_row[k] for k in ("child_loop_bound_ms", "all_slots_bound_ms",
                                        "split", "block", "launch_ms",
                                        "launches_per_cycle")
               if k in main_row}})
    # The rows past the old limits (lb2 past 100 jobs on the global table
    # route; N-Queens past 32 queens), by kernel: time, plain time, bound.
    def brief(row):
        return {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                                    "tables", "mask_words", "block") if k in row}

    wide_rows = {"lb2_bounds": {k[1]: brief(r) for k, r in wide.items() if k[0] == "kernel6"},
                 "lb2_self_bounds": {k[1]: brief(r) for k, r in wide.items()
                                     if k[0] == "kernel7"},
                 "cycle_lb2": {k[1]: brief(r) for k, r in wide.items() if k[0] == "kernel8"},
                 "tiled_lb2": {k[1]: brief(r) for k, r in wide.items() if k[0] == "kernel11"},
                 "nqueens_labels": {"N48": brief(k3[(48, 50000, 1)])},
                 "cycle_nqueens": {f"N48/{k[2]}": brief(r) for k, r in k4_48.items()},
                 "tiled_nqueens": {f"N48/{k[2]}": brief(r) for k, r in k10_48.items()}}
    for k in kernels:
        if k["name"] in wide_rows:
            k["wide"] = wide_rows[k["name"]]
    # The offload engine's launches of the bound kernels (one a chunk), by
    # search, beside each row's main-path launches.
    for k in kernels:
        runs = {name: row["launches"][k["name"]] for name, row in offload.items()
                if k["name"] in row["launches"]}
        if runs:
            k["offload_launches"] = runs
        # The multi and dist tiers' launches of the bound kernels (one a
        # chunk) and the mesh tiers' of the cycles, by run and D (the dist
        # tiers: two hosts of D each).
        runs = {f"{tier}_{key[0]}_D{key[1]}": row["launches"][k["name"]]
                for tier, rows in (("multi", multi), ("mesh", mesh),
                                   ("dist_H2", dist), ("dist_mesh_H2", dmesh))
                for key, row in rows.items()
                if key not in ("warm", "cut") and k["name"] in row["launches"]}
        if runs:
            k["parallel_launches"] = runs
        # The fleet phase's launches of the fused cycles (this process's).
        if k["name"] in fleet["launches"]:
            k["fleet_launches"] = fleet["launches"][k["name"]]
    # The graph dispatch (not a TPU kernel: the host loop's counterpart of the
    # JAX engine's lax.while_loop): one K = 4 dispatch against 4 plain cycles
    # at ta014 lb1 M = 49152, and its condition kernel's time a cycle on the
    # fused ta014 lb1 search.
    g_main = gd["ta014_lb1"]
    kernels.append({
        "name": "dispatch_graph", "route": "cuda",
        "source": "tpu_tree_search_torch/csrc/dispatch_graph.cu",
        "replaces": "tpu_tree_search/engine/resident.py:445",
        "launches": fused["launches"]["dispatch_graph"],
        "launches_path": "search_fused_M49152",
        "shape": "ta014 lb1 M=49152, one dispatch of K=4 cycles",
        "max_abs_err": max(r["max_abs_err"] for r in gd.values()),
        "ms": g_main["dispatch_ms"], "timing": "events", "plain_ms": g_main["plain_ms"],
        "bound_ms": g_main["bound_ms"], "bound_by": g_main["bound_by"], "library_ms": None,
        "graph_build_s": g_main["graph_build_s"],
        "cond_ms_per_cycle": {n: profs[n]["cond_ms_per_cycle"] for n in profs},
        "pipeline": pipe})
    kernels += graph_node_rows(dev, gd, fused, nq15, unfused, profs, prof_nq14)
    # The telemetry kernels (not TPU kernels: the counterparts of the JAX
    # while body's counter update and of the phase clock's boundary). Their
    # launches are those of the main path's armed runs (phase obs): the
    # counter node a cycle of ta014 lb1 with TTS_OBS=1, the marks of ta014
    # lb1 with TTS_PHASEPROF=1 (four a cycle and a seed a dispatch).
    cond_ms, cond_seen = obsp["prof_ms"]["dispatch_cond_obs"]
    mark_ms, mark_seen = obsp["prof_ms"]["phase_mark"]
    # Bytes a launch must move: the counter node reads and writes the block
    # and its two last values and reads size, tree, sol, cnt, cycles (17
    # int32 in, 11 out); a mark reads and writes three int64 slots.
    cond_bms, cond_by = bound_ms(28 * 4, 0.0)
    mark_bms, mark_by = bound_ms(6 * 8, 0.0)
    kernels.append({
        "name": "dispatch_cond_obs", "route": "cuda",
        "source": "tpu_tree_search_torch/csrc/dispatch_graph.cu",
        "replaces": "tpu_tree_search/engine/resident.py:284",
        "launches": obsp["launches"][("ta014_lb1", "obs", 1)]["dispatch_cond_obs"],
        "launches_path": "obs ta014_lb1 TTS_OBS=1",
        "shape": "one thread, the (8,) int32 counter block in the loop state",
        "max_abs_err": max(r.get("counters_max_abs_err", 0) for r in gd.values()),
        "ms": cond_ms, "timing": f"profiler ({cond_seen} launches, N=15 phaseprof)",
        "plain_ms": obsp["plain_cond_ms"], "bound_ms": cond_bms, "bound_by": cond_by,
        "library_ms": None})
    kernels.append({
        "name": "phase_mark", "route": "cuda",
        "source": "tpu_tree_search_torch/csrc/phase_clock.cuh",
        "replaces": "tpu_tree_search/obs/phases.py:143",
        "launches": obsp["launches"][("ta014_lb1", "phaseprof", 2)]["phase_mark"],
        "launches_path": "obs ta014_lb1 TTS_PHASEPROF=1",
        "shape": "one thread, the (10,) int64 phase block; %globaltimer",
        "max_abs_err": obsp["replay"]["max_abs_err"],
        "ms": mark_ms, "timing": f"profiler ({mark_seen} launches, N=15 phaseprof)",
        "plain_ms": obsp["plain_mark_ms"], "bound_ms": mark_bms, "bound_by": mark_by,
        "library_ms": None, "globaltimer_step_ns": obsp["timer"]["step_ns"]})
    # The batched graph's nodes (not TPU kernels: the JAX batched while
    # loop's init and OR of the slots' conditions).
    kernels += batch_kernel_rows(bg, serve)
    # The mesh's balance step (not a TPU kernel: the JAX pmin and ring
    # diffusion).
    kernels.append(mesh_kernel_row(bal, mdisp, mesh))
    kernels += pair_block_rows(mp_runs, blocks) + [slot_gate_row(gate, mp_runs)]
    kernels.append(pair_exchange_row(xchg, copies))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": dev_info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
