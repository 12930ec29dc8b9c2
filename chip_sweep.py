#!/usr/bin/env python3
"""Time the lb1-family kernels 1 and 5, the lb2 kernels 6 and 8 and the
fused and streamed cycles on one card, for this checkout or for variants of
its CUDA sources.

    python3 chip_sweep.py [--family lb1|lb2|tiled]   # this checkout, once
    python3 chip_sweep.py VARIANTS.json [--rounds N] [--family ...]
    python3 chip_sweep.py --lb1-steps [--rounds N]
    python3 chip_sweep.py --tiled-steps [--rounds N]
    python3 chip_sweep.py --lb2self-steps [--rounds N] [--parent DIR]
    python3 chip_sweep.py --optin-steps [--rounds N] [--parent DIR]

``--family lb1``: kernel 1 (``lb1_bounds``) and kernel 5
(``lb1_d_bounds``) on ta014 at B = 1024 and 49152, int8 and int32, on
ta021 (20 machines) at B = 49152, on a seeded 40-machine, 12-job instance
(the one-thread prologue) at B = 49152 and on ta111 (500 jobs, int32) at
B = 1024. ``--family lb2``: kernel 6 (``lb2_bounds``) on ta014 and ta021
at B = 1024 and 49152 and on ta081 at B = 1024, and kernel 8
(``cycle_lb2``) on a full chunk of ta014 and ta021 at M = 1024 and 49152.
``--family tiled``: the streamed N-Queens cycle (kernel 9a) on a full chunk
at N = 15, M = 50000 (mt = 80 and 8) and M = 1024 (mt = 16), the streamed
lb1 cycle (kernel 9b) on ta014 at M = 49152 (mt = 64) and M = 1024
(mt = 16), and the streamed lb2 cycle (kernel 9c) on ta014 at M = 49152
(mt = 64) and M = 1024 (mt = 16) and on ta021 at M = 49152 (mt = 64),
each beside the single-tile cycle whose launches it runs (kernels 4, 2 and
8) at its M; and the N-Queens labels (kernel 3) at B = 50000, N = 14 and
15, g = 1, and N = 15, g = 256, and at B = 1024, N = 15 and 20, g = 1.
``--family lb2self``: kernel 7 (``lb2_self_bounds``) on the rows of the
staged ta014 lb2 search's launches 1, 5 and 9 (R = 49152*20; n_active
185, 9,372 and 74,171; copied from a run of that search,
``capture_self_launches`` and ``K7_SEARCH_LAUNCHES`` of `chip_smoke.py`),
at a quarter and all of R ``random_nodes`` rows, and on ta021 at 9,372
``random_nodes`` rows, with the lanes a row and rows a thread each launch
took; then its device time and launches over the staged ta014 lb2 search
(``search_k7_ms``, ``search_k7_launches``). ``--family kernel6``: kernel
6's rows of `chip_smoke.py` (its phase ``kernel6``, in its order: ta014,
ta021, ta051, ta081).
Each kernel is checked against its plain version
(``err`` is the largest difference on the open slots; for a cycle, on the
state, the live pool rows and the per-tile scalars), then timed by the
profiler (a cycle: the whole cycle and by launch), with the block shape it
chose. Without ``--family``, lb1 and lb2. Prints one JSON line.

With VARIANTS.json, a list of ``[name, {source: {old: new}}]``: each
variant is a copy of the package under ``_checkout/sweep/<name>``
(gitignored) with each ``old`` text of ``tpu_tree_search_torch/csrc/
<source>`` replaced by ``new``; the copies run in turns, one process each,
``--rounds`` times (default 1), each printing its line. A variant that
changes what a kernel computes shows in its ``err``. ``--lb1-steps`` runs
the built-in variants ``LB1_STEPS`` of kernels 1 and 5 (the design steps
of their shared body, `csrc/lb1_family.cuh`) the same way, and
``--tiled-steps`` the variants ``TILED_STEPS`` of the cycles' shared
bodies (`csrc/cycle_common.cuh`) under ``--family tiled``, and
``--lb2self-steps`` the variants ``LB2SELF_STEPS`` of kernel 7 (the kernel
before its redesign first) under ``--family lb2self``, and
``--optin-steps`` ``OPTIN_STEPS`` (the shared-memory opt-in before and
after it learned to cache) under ``--family kernel6``. A variant may take
a source whole from a checkout of the commit before kernel 7's redesign
(``PARENT``): ``--parent DIR``, default ``_checkout/parent``, made by
``git archive <commit> | tar -x -C _checkout/parent``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
PKG = "tpu_tree_search_torch"

# The design steps of kernels 1 and 5 (csrc/lb1_family.cuh), as text
# substitutions of the committed source: its shape rule (`tts_lb1f_shape`)
# and prologue against the alternatives, and ablations that take out one
# part of the body (their planes differ from the plain ones: ``err`` is not
# 0).
_LB1F = "lb1_family.cuh"
_LOOP = ("  if (!sh->fits && sh->threads > TTS_LB1F_LOOP_THREADS)\n"
         "    sh->threads = TTS_LB1F_LOOP_THREADS;\n")
_LANES = ("  sh->lanes = m <= 32 && (sh->fits || sh->blocks < TTS_LB1F_FRONT_BLOCKS * sms)\n"
          "                  ? G : 0;\n")
_HALVE = ("  while (sh->parents > 1 && (B + sh->parents - 1) / sh->parents < sms)\n"
          "    sh->parents >>= 1;\n")
_PIPE = {"    const int next = time_at(step + 1 - j);\n": "",
         "    if (mine && i >= 0 && i <= last) f = (j == 0 ? f : max(f, left)) + pt;\n"
         "    pt = next;\n":
         "    if (mine && i >= 0 && i <= last) f = (j == 0 ? f : max(f, left)) + time_at(i);\n"}
_SPLIT = {"      const int w0 = blockDim.x > 32 ? 32 : 0;\n":
          "      const int w0 = blockDim.x;\n",
          "          lb1f_front_thread(par + p * n, static_cast<int>(lim[p]), n, m, s,\n"
          "                            s.front + p * ms);\n":
          "          lb1f_front_thread(par + p * n, static_cast<int>(lim[p]), n, m, s,\n"
          "                            s.front + p * ms);\n"
          "      if (t < 32)\n"
          "        for (int p = t; p < rows; p += 32)\n"
          "          for (int j = 0; j < m; ++j)\n"
          "            s.remain[p * ms + j] = lb1f_remain(par + p * n,\n"
          "                static_cast<int>(lim[p]), n, m, s, j);\n"}
_CHAIN = ("      o[slot] = Chain::bound(lb1f_job(par[slot], n), m, s, s.front + p * ms,\n"
          "                             s.remain + p * ms);\n")
_NO_PROLOGUE = {"      for (int p = t / G; p < rows;": "      for (int p = t / G; p < 0;",
                "        for (int p = t; p < rows; p += 32)\n          lb1f_front_thread(":
                "        for (int p = t; p < 0; p += 32)\n          lb1f_front_thread(",
                "      for (int e = t - w0; e >= 0 && e < rows * m;":
                "      for (int e = t - w0; e >= 0 && e < 0;"}
_NO_CHAIN = {_CHAIN: "      o[slot] = lb1f_job(par[slot], n) + s.front[p * ms];\n"}
LB1_STEPS = [
    # As committed: 32 parents a block, halved while the grid has fewer
    # blocks than SMs; one thread a slot when the grid fits on the card at
    # once, else blocks of 128 threads that loop over their slots; a
    # wavefront prologue (a lane a machine), or, in a looping grid of 4
    # blocks an SM or more, warp 0 the fronts and the other warps the
    # remaining work.
    ["committed", {}],
    # Grid form (b): a persistent grid of one wave of one-thread-a-slot
    # blocks that loop over groups of 32 parents, loading the tables once.
    ["persistent", {_LB1F: {_LOOP: "  if (!sh->fits) sh->blocks = per_sm * sms;\n"}}],
    # The prologue by lanes at every size (up to 32 machines), and by warp
    # 0's fronts at every size.
    ["lanes_always", {_LB1F: {_LANES: "  sh->lanes = m <= 32 ? G : 0;\n"}}],
    ["fronts_always", {_LB1F: {_LANES: "  sh->lanes = 0;\n"}}],
    # Warp 0 the remaining work too, after its fronts (one thread a
    # parent for both).
    ["unsplit", {_LB1F: _SPLIT}],
    # The lanes' loads after the shuffle, not a step ahead.
    ["unpipelined", {_LB1F: _PIPE}],
    # 32 parents a block at every size.
    ["parents32", {_LB1F: {_HALVE: ""}}],
    # 256 looping threads in place of 128.
    ["loop256", {_LB1F: {"#define TTS_LB1F_LOOP_THREADS 128":
                         "#define TTS_LB1F_LOOP_THREADS 256"}}],
    # Ablations: no parent prologue, no child chain, neither.
    ["no_prologue", {_LB1F: _NO_PROLOGUE}],
    ["no_chain", {_LB1F: _NO_CHAIN}],
    ["no_prologue_no_chain", {_LB1F: {**_NO_PROLOGUE, **_NO_CHAIN}}],
]


# The design steps of kernels 9a, 9b and 9c (the single-tile cycles'
# launches with the boundary row, csrc/cycle_common.cuh), as text
# substitutions: ablations of the boundary row and alternatives of the
# shared bodies, timed beside kernels 2, 4 and 8, which share them; and of
# kernel 3 (csrc/nqueens_labels.cu).
_COMMON = "cycle_common.cuh"
_NQL = "nqueens_labels.cu"
TILED_STEPS = [
    # As committed: a (survivors, solutions) pair a block, two blocks a
    # 16-byte load in the predecessor sum, warp 0 of each emit block writes
    # the rows of the tile boundaries among its parents.
    ["committed", {}],
    # Ablation: no row of a tile start written (the rows' cost; the per-tile
    # scalars then differ from the plain ones).
    ["no_tile_rows", {_COMMON: {"  if (lane < rows && i % mt == 0) {":
                                "  if (lane < rows && i % mt == 0 && mt < 0) {"}}],
    # The predecessor sum one pair (8 bytes) a load.
    ["pairs_8_bytes", {_COMMON: {
        "    for (int j = threadIdx.x; j < (b >> 1); j += blockDim.x) {\n"
        "      const int4 x = v[j];\n"
        "      pre += x.x + x.z;\n"
        "      sol += x.y + x.w;\n"
        "    }\n"
        "    if ((b & 1) && threadIdx.x == 0) {\n"
        "      pre += blkcnt[2 * b - 2];\n"
        "      sol += blkcnt[2 * b - 1];\n"
        "    }\n":
        "    for (int j = threadIdx.x; j < b; j += blockDim.x) {\n"
        "      const int2 x = reinterpret_cast<const int2*>(blkcnt)[j];\n"
        "      pre += x.x;\n"
        "      sol += x.y;\n"
        "    }\n"}}],
    # 256 looping threads a counting or emit block in place of 128 (all the
    # cycles).
    ["loop256", {_COMMON: {"#define TTS_CYCLE_LOOP_THREADS 128":
                           "#define TTS_CYCLE_LOOP_THREADS 256"}}],
    # Kernel 3: every parent on the scalar check (the packed compare's
    # gain), and tiles of 64 and 256 parents in place of 128.
    ["nql_scalar", {_NQL: {"s_wide[p] ? nq_label(": "true ? nq_label("}}],
    ["nql_parents64", {_NQL: {"#define TTS_NQL_PARENTS 128": "#define TTS_NQL_PARENTS 64"}}],
    ["nql_parents256", {_NQL: {"#define TTS_NQL_PARENTS 128":
                               "#define TTS_NQL_PARENTS 256"}}],
]


# A source taken whole from the parent checkout (``--parent``).
PARENT = "@parent"

# The design steps of kernel 7 (csrc/lb2_self_bounds.cu), as text
# substitutions: first the kernel as it was before its redesign (its source
# and the helpers it had in lb2_common.cuh, from the parent checkout), then
# the committed design and its steps one at a time: the walk over the free
# slots only (each row's free jobs through the pair's inverse table into a
# slot mask, its bits walked in order with __ffs; step 3's other walk), the
# grid sized by R (step 1 off), fixed lanes a row (step 2), at most 2 or 1
# rows a thread (the walk's shared slot loads), the recurrence's max by
# Hopper's DPX instruction (max(a + b, c) in one), the slot loop not
# unrolled, rows read from global memory (step 4, int8 rows only), and 256
# threads a block.
_K7 = "lb2_self_bounds.cu"
_K7_WALK = """    const typename Lb2Types<GT>::Tab* e = s.tab + q * ns;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const typename Lb2Types<GT>::Tab v = e[k];
      const uint32_t bit = 1u << (v.w & 31);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        uint32_t word = fm[i][0];
#pragma unroll
        for (int w = 1; w < W; ++w)
          if ((v.w >> 5) == w) word = fm[i][w];
        if (word & bit) {
          tmp0[i] += v.x;
          tmp1[i] = max(tmp1[i], tmp0[i] + v.z) + v.y;
        }
      }
    }
"""
_K7_FREE_SLOTS = {
    "  int* front;      // their fronts\n};":
    "  int* front;      // their fronts\n  uint8_t* inv;    // P*n: the slot of job j in pair q's order\n};",
    "         4 * static_cast<size_t>(U) * (1 + (m | 1));\n":
    "         4 * static_cast<size_t>(U) * (1 + (m | 1)) + static_cast<size_t>(P) * n;\n",
    "  s.front = s.l1 + U;\n":
    "  s.front = s.l1 + U;\n  s.inv = reinterpret_cast<uint8_t*>(s.front + U * (m | 1));\n",
    "      s.tab[q * ns + i - q * n] = tab[i];\n":
    "      const short4 v = tab[i];\n      s.tab[q * ns + i - q * n] = v;\n"
    "      s.inv[q * n + v.w] = static_cast<uint8_t>(i - q * n);\n",
    _K7_WALK: """    const typename Lb2Types<GT>::Tab* e = s.tab + q * ns;
    const uint8_t* iv = s.inv + q * n;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      uint32_t sm[W];
#pragma unroll
      for (int w = 0; w < W; ++w) sm[w] = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        uint32_t jb = fm[i][w];
        while (jb) {
          const int t = iv[32 * w + __ffs(jb) - 1];
          jb &= jb - 1;
#pragma unroll
          for (int u = 0; u < W; ++u)
            if ((t >> 5) == u) sm[u] |= 1u << (t & 31);
        }
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        uint32_t bits = sm[w];
        while (bits) {
          const typename Lb2Types<GT>::Tab v = e[32 * w + __ffs(bits) - 1];
          bits &= bits - 1;
          tmp0[i] += v.x;
          tmp1[i] = max(tmp1[i], tmp0[i] + v.z) + v.y;
        }
      }
    }
"""}
_K7_G = "  const int G = split.x, RT = split.y;\n"
LB2SELF_STEPS = [
    ["parent", {_K7: PARENT, "lb2_common.cuh": PARENT}],
    ["committed", {}],
    ["free_slots", {_K7: _K7_FREE_SLOTS}],
    ["grid_by_rows", {_K7: {
        "  sh.blocks = static_cast<int>(need < wave ? need : wave);\n":
        "  sh.blocks = static_cast<int>((R + sh.threads - 1) / sh.threads);\n"}}],
    ["lanes1", {_K7: {_K7_G: "  const int G = 1, RT = split.y;\n"}}],
    ["lanes4", {_K7: {_K7_G: "  const int G = 4, RT = 1;\n"}}],
    ["lanes32", {_K7: {_K7_G: "  const int G = 32, RT = 1;\n"}}],
    ["rows2", {_K7: {"#define TTS_LB2S_ROWS 4": "#define TTS_LB2S_ROWS 2"}}],
    ["rows1", {_K7: {"#define TTS_LB2S_ROWS 4": "#define TTS_LB2S_ROWS 1"}}],
    ["dpx", {_K7: {"max(tmp1[i], tmp0[i] + v.z)": "__viaddmax_s32(tmp0[i], v.z, tmp1[i])"}}],
    ["no_unroll", {_K7: {"#pragma unroll 4\n    for (int k = 0; k < n; ++k) {":
                         "#pragma unroll 1\n    for (int k = 0; k < n; ++k) {"}}],
    ["no_stage", {_K7: {
        "    const typename Lb2Types<GT>::Job* staged =\n"
        "        lb2s_stage<GT>(s, rows + static_cast<size_t>(r0) * n, limit1 + r0,\n"
        "                       rows_here, n);\n":
        "    for (int p = threadIdx.x; p < rows_here; p += blockDim.x)\n"
        "      s.l1[p] = min(max(static_cast<int>(limit1[r0 + p]), -1), n - 1);\n"
        "    __syncthreads();\n"
        "    const typename Lb2Types<GT>::Job* staged =\n"
        "        reinterpret_cast<const typename Lb2Types<GT>::Job*>(\n"
        "            rows + static_cast<size_t>(r0) * n);\n"}}],
    ["threads256", {_K7: {"#define TTS_LB2S_THREADS 128": "#define TTS_LB2S_THREADS 256"}}],
]

# The shared-memory opt-in (csrc/tts_common.cuh) before it learned to
# cache (one cudaFuncSetAttribute a launch above 48 KB) and as committed,
# under kernel 6's rows.
OPTIN_STEPS = [
    ["parent_optin", {"tts_common.cuh": PARENT}],
    ["committed", {}],
]


def make_variant(root: Path, dest: Path, subs: dict, parent: Path | None = None) -> None:
    """Copy ``root``'s package and this script to ``dest`` and apply
    ``subs`` ({source under csrc: {old: new}, or ``PARENT``: the source as
    the checkout ``parent`` has it}); each ``old`` must occur."""
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(root / PKG, dest / PKG,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name in ("chip_smoke.py", "chip_sweep.py"):
        shutil.copy(root / name, dest / name)
    for source, pairs in subs.items():
        path = dest / PKG / "csrc" / source
        if pairs == PARENT:
            if parent is None or not (parent / PKG / "csrc" / source).is_file():
                raise SystemExit(f"chip_sweep: no {source} in the parent checkout "
                                 f"{parent}: git archive <commit> | tar -x -C DIR")
            shutil.copy(parent / PKG / "csrc" / source, path)
            continue
        text = path.read_text()
        for old, new in pairs.items():
            if old not in text:
                raise ValueError(f"{source}: {old!r} not found")
            text = text.replace(old, new)
        path.write_text(text)


def measure_lb1(out: dict) -> None:
    """Kernels 1 and 5 into ``out`` (see the module docstring)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from tpu_tree_search_torch.ops import lb1_d_kernel, lb1_kernel
    from tpu_tree_search_torch.problems import PFSPProblem

    dev = torch.device("cuda", 0)
    ptm40 = np.random.default_rng(40).integers(1, 100, (40, 12))
    tabs = {"ta014": PFSPProblem(inst=14, lb="lb1", ub=1).device_tables(dev),
            "ta021": PFSPProblem(inst=21, lb="lb1", ub=1).device_tables(dev),
            "40x12": PFSPProblem(lb="lb1", ub=0, p_times=ptm40).device_tables(dev),
            "ta111": PFSPProblem(inst=111, lb="lb1", ub=1).device_tables(dev)}
    kernels = {"k1": (lb1_kernel.lb1_bounds_cuda, lb1_kernel.plain, "lb1_bounds"),
               "k5": (lb1_d_kernel.lb1_d_bounds_cuda, lb1_d_kernel.plain,
                      "lb1_d_bounds")}
    for inst, B, dtype in [("ta014", 1024, torch.int8), ("ta014", 1024, torch.int32),
                           ("ta014", 49152, torch.int8), ("ta014", 49152, torch.int32),
                           ("ta021", 49152, torch.int8), ("40x12", 49152, torch.int8),
                           ("ta111", 1024, torch.int32)]:
        t = tabs[inst]
        n = t.jobs
        prmu, l1 = cs.random_nodes(np.random.default_rng(n + B), n, B)
        p = torch.from_numpy(prmu).to(dev).to(dtype)
        lim = torch.from_numpy(l1).to(dev).to(dtype)
        op = torch.from_numpy(np.arange(n)[None, :] > l1[:, None]).to(dev)
        key = f"{inst}/B={B}/{str(dtype).split('.')[-1]}"
        for tag, (kernel, plain, source) in kernels.items():
            got = kernel(p, lim, t)
            want = plain(p, lim, t)
            out["err"] = max(out["err"],
                             int((got[op].long() - want[op].long()).abs().max()))
            out.setdefault(tag, {})[key], _ = cs.kernel_device_ms(
                lambda: kernel(p, lim, t), 50, (f"{source}_kernel",))
            out["block"][f"{tag}/{key}"] = lb1_kernel.last_shape(source)


def measure_lb2(out: dict) -> None:
    """Kernels 6 and 8 into ``out`` (see the module docstring)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from tpu_tree_search_torch.ops import lb2_kernel
    from tpu_tree_search_torch.ops import cycle as C
    from tpu_tree_search_torch.problems import PFSPProblem

    dev = torch.device("cuda", 0)
    out.update(k6={}, k8={}, k8_bounds_launch={})
    tabs = {i: PFSPProblem(inst=i, lb="lb2", ub=1).device_tables(dev)
            for i in (14, 21, 81)}
    for inst, B in [(14, 1024), (14, 49152), (21, 1024), (21, 49152), (81, 1024)]:
        t = tabs[inst]
        n = t.jobs
        prmu, l1 = cs.random_nodes(np.random.default_rng(inst + B), n, B)
        p = torch.from_numpy(prmu).to(dev).to(torch.int8)
        lim = torch.from_numpy(l1).to(dev).to(torch.int8)
        got = lb2_kernel.lb2_bounds_cuda(p, lim, t)
        want = lb2_kernel.plain(p, lim, t)
        op = torch.from_numpy(np.arange(n)[None, :] > l1[:, None]).to(dev)
        out["err"] = max(out["err"], int((got[op].long() - want[op].long()).abs().max()))
        key = f"ta{inst:03d}/B={B}"
        out["k6"][key], _ = cs.kernel_device_ms(
            lambda: lb2_kernel.lb2_bounds_cuda(p, lim, t), 30, ("lb2_bounds_kernel",))
        out["block"][f"k6/{key}"] = lb2_kernel.last_shape("lb2_bounds")
    for inst, M in [(14, 1024), (14, 49152), (21, 1024), (21, 49152)]:
        t = tabs[inst]
        n = t.jobs
        size = M + 517
        prmu, l1 = cs.random_nodes(np.random.default_rng(inst + M), n, size)
        cap = size + M * n
        pv0 = torch.zeros((cap, n), dtype=torch.int8, device=dev)
        pa0 = torch.zeros(cap, dtype=torch.int8, device=dev)
        pv0[:size] = torch.from_numpy(prmu).to(dev).to(torch.int8)
        pa0[:size] = torch.from_numpy(l1).to(dev).to(torch.int8)
        st0 = C.new_state(size, 1500 if inst == 14 else 2300, dev)
        scratch = C.cycle_scratch(M, n, torch.int8, dev)
        pv, pa, st = pv0.clone(), pa0.clone(), st0.clone()
        C.cycle_lb2_cuda(pv, pa, st, scratch, t, M, 25, 4)
        pv2, pa2, st2 = pv0.clone(), pa0.clone(), st0.clone()
        C.cycle_lb2_plain(pv2, pa2, st2, t, M, 25, 4)
        live = int(st2[C.ST_SIZE])
        out["err"] = max(out["err"],
                         int((st[:C.ST_BASE + 1] - st2[:C.ST_BASE + 1]).abs().max()),
                         int((pv[:live].int() - pv2[:live].int()).abs().max()))

        def restore():
            pv.copy_(pv0)
            pa.copy_(pa0)
            st.copy_(st0)

        key = f"ta{inst:03d}/M={M}"
        out["k8"][key], _ = cs.kernel_device_ms(
            lambda: C.cycle_lb2_cuda(pv, pa, st, scratch, t, M, 25, 4), 30,
            cs.LB2_CYCLE_KERNELS, restore)
        out["k8_bounds_launch"][key] = cs.LAST_LAUNCH_MS.get("lb2_cycle_bounds")
        out["block"][f"k8/{key}"] = lb2_kernel.last_shape("cycle_lb2")


def measure_lb2self(out: dict) -> None:
    """Kernel 7 into ``out`` (see the module docstring)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from tpu_tree_search_torch.ops import lb2_self_kernel as K
    from tpu_tree_search_torch.problems import PFSPProblem

    dev = torch.device("cuda", 0)
    out.update(k7={}, lanes={})
    with contextlib.redirect_stdout(io.StringIO()):
        launches = cs.capture_self_launches(
            lambda: cs.run_search(cs.PFSP_LB2 + ["--unfused"], cs.GOLDEN_LB2),
            keep=cs.K7_SEARCH_LAUNCHES)
    cases = {14: [(launches[i]["rows"], launches[i]["limit1"], (launches[i]["n_active"],))
                  for i in cs.K7_SEARCH_LAUNCHES], 21: []}
    R = 49152 * 20  # ta014 and ta021 have 20 jobs
    for inst, counts in ((14, (R // 4, R)), (21, (9372,))):
        prmu, limit1 = cs.random_nodes(np.random.default_rng(inst), 20, R)
        cases[inst].append((torch.from_numpy(prmu).to(dev).to(torch.int8),
                            torch.from_numpy(limit1).to(dev).to(torch.int8), counts))
    for inst, rows in cases.items():
        t = PFSPProblem(inst=inst, lb="lb2", ub=1).device_tables(dev)
        for p, lim, counts in rows:
            R = p.shape[0]
            for k in counts:
                na = torch.tensor(k, dtype=torch.int32, device=dev)
                got = K.lb2_self_bounds_cuda(p, lim, na, t)
                want = K.plain(p[:k], lim[:k], k, t)
                out["err"] = max(out["err"], int((got[:k].long() - want.long()).abs().max()))
                key = f"ta{inst:03d}/R={R}/n_active={k}"
                try:  # the kernel before its redesign reports no shape
                    out["lanes"][key] = K.last_split()
                    out["block"][key] = K.last_shape()
                except AttributeError:
                    pass
                out["k7"][key], _ = cs.kernel_device_ms(
                    lambda: K.lb2_self_bounds_cuda(p, lim, na, t), 50,
                    ("lb2_self_bounds_kernel",))
    # Kernel 7 on its search path: its device time and launches over the
    # staged ta014 lb2 search (goldens checked), traced on the device alone.
    with contextlib.redirect_stdout(io.StringIO()):
        prof = cs.phase_profile("search_lb2_unfused_staged", cs.PFSP_LB2 + ["--unfused"],
                                cs.GOLDEN_LB2, kernels=("lb2_self_bounds_kernel",),
                                host=False)
    out["search_k7_ms"] = prof["kernel_device_ms"]["lb2_self_bounds_kernel"]
    out["search_k7_launches"] = prof["kernel_launches"]["lb2_self_bounds_kernel"]


def measure_kernel6(out: dict) -> None:
    """Kernel 6's rows of `chip_smoke.py` into ``out`` (its phase
    ``kernel6``, in its order), and their sum."""
    import torch

    import chip_smoke as cs
    from tpu_tree_search_torch.problems import PFSPProblem

    dev = torch.device("cuda", 0)
    tables = {f"ta{i:03d}": PFSPProblem(inst=i, lb="lb2", ub=1).device_tables(dev)
              for i in (14, 21, 51, 81)}
    with contextlib.redirect_stdout(io.StringIO()):
        rows = cs.phase_kernel6(dev, tables)
    out["k6"] = {f"{inst}/B={B}/{dtype.split('.')[-1]}": r["ms"]
                 for (inst, B, dtype), r in rows.items()}
    out["k6_sum"] = sum(out["k6"].values())


def _cycle_case(run_cuda, run_plain, pv0, pa0, st0, names, scratch=None):
    """One cycle on a copy of the pool (pv0, pa0, st0) against its plain
    version, then timed by the profiler: (the largest difference in the
    state, the live rows and, streamed, the per-tile scalars; device ms a
    cycle; device ms by launch)."""
    import torch

    import chip_smoke as cs
    from tpu_tree_search_torch.ops import cycle as C

    pv, pa, st = pv0.clone(), pa0.clone(), st0.clone()
    run_cuda(pv, pa, st)
    pv2, pa2, st2 = pv0.clone(), pa0.clone(), st0.clone()
    scal2 = run_plain(pv2, pa2, st2)
    torch.cuda.synchronize()
    live = int(st2[C.ST_SIZE])
    err = max(int((st[:C.ST_BASE + 1] - st2[:C.ST_BASE + 1]).abs().max()),
              int((pv[:live].int() - pv2[:live].int()).abs().max()) if live else 0,
              int((pa[:live].int() - pa2[:live].int()).abs().max()) if live else 0,
              int((scratch.scal - scal2).abs().max()) if scratch is not None else 0)

    def restore():
        pv.copy_(pv0)
        pa.copy_(pa0)
        st.copy_(st0)

    ms, _ = cs.kernel_device_ms(lambda: run_cuda(pv, pa, st), 30, names, restore)
    return err, ms, dict(cs.LAST_LAUNCH_MS)


def measure_tiled(out: dict) -> None:
    """Kernels 9a, 9b and 9c beside 2, 4 and 8, and kernel 3, into ``out``
    (see the module docstring)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from tpu_tree_search_torch.ops import cycle as C
    from tpu_tree_search_torch.ops import cycle_nqueens as CN
    from tpu_tree_search_torch.ops import nqueens_kernel as NK
    from tpu_tree_search_torch.ops import tiled as T
    from tpu_tree_search_torch.problems import NQueensProblem, PFSPProblem

    dev = torch.device("cuda", 0)
    out.update(ms={}, launch_ms={})
    for N, B, g in [(14, 50000, 1), (15, 50000, 1), (15, 50000, 256), (15, 1024, 1),
                    (20, 1024, 1)]:
        board, depth = cs.random_boards(np.random.default_rng(N + g), N, B)
        b = torch.from_numpy(board).to(dev)
        d = torch.from_numpy(depth).to(dev).to(torch.int8)
        got = NK.nqueens_labels_cuda(b, d, N, g)
        out["err"] = max(out["err"], int((got.int() - NK.plain(b, d, N, g).int())
                                         .abs().max()))
        key = f"k3/B={B}/N={N}/g={g}"
        out["block"][key] = NK.last_shape()
        out["ms"][key], _ = cs.kernel_device_ms(
            lambda: NK.nqueens_labels_cuda(b, d, N, g), 30, ("nqueens_labels_kernel",))
    K, m = 4, 25
    prob = NQueensProblem(15)
    N = prob.N
    for M, mt in [(50000, None), (50000, 80), (50000, 8), (1024, None), (1024, 16)]:
        size = M + 517
        board, depth = cs.random_boards(np.random.default_rng(M), N, size)
        cap = size + M * N
        pv0 = torch.zeros((cap, N), dtype=torch.uint8, device=dev)
        pa0 = torch.zeros(cap, dtype=torch.int8, device=dev)
        pv0[:size] = torch.from_numpy(board).to(dev)
        pa0[:size] = torch.from_numpy(depth).to(dev).to(torch.int8)
        st0 = C.new_state(size, cs.INF, dev)
        if mt is None:
            sc = CN.nqueens_scratch(M, N, dev)
            case = (lambda pv, pa, st: CN.cycle_nqueens_cuda(pv, pa, st, sc, N, 1, M, m, K),
                    lambda pv, pa, st: CN.cycle_nqueens_plain(pv, pa, st, N, 1, M, m, K),
                    cs.NQ_CYCLE_KERNELS, None)
            key = f"k4/M={M}"
        else:
            sc = T.tiled_nqueens_scratch(M, N, mt, dev)
            case = (lambda pv, pa, st: T.tiled_nqueens_cuda(pv, pa, st, sc, prob, M, mt, m, K),
                    lambda pv, pa, st: T.tiled_nqueens_plain(pv, pa, st, prob, M, mt, m, K),
                    cs.TILED_KERNELS["nqueens"], sc)
            key = f"k9a/M={M}/mt={mt}"
        err, out["ms"][key], out["launch_ms"][key] = _cycle_case(
            case[0], case[1], pv0, pa0, st0, case[2], case[3])
        out["err"] = max(out["err"], err)
    tabs = {(i, lb): PFSPProblem(inst=i, lb=lb, ub=1).device_tables(dev)
            for i, lb in ((14, "lb1"), (14, "lb2"), (21, "lb2"))}
    for inst, lb, M, mt in [(14, "lb1", 49152, None), (14, "lb1", 49152, 64),
                            (14, "lb1", 1024, None), (14, "lb1", 1024, 16),
                            (14, "lb2", 49152, None),
                            (14, "lb2", 49152, 64), (14, "lb2", 1024, None),
                            (14, "lb2", 1024, 16), (21, "lb2", 49152, None),
                            (21, "lb2", 49152, 64)]:
        t = tabs[(inst, lb)]
        n = t.jobs
        size = M + 517
        prmu, l1 = cs.random_nodes(np.random.default_rng(inst + M), n, size)
        cap = size + M * n
        pv0 = torch.zeros((cap, n), dtype=torch.int8, device=dev)
        pa0 = torch.zeros(cap, dtype=torch.int8, device=dev)
        pv0[:size] = torch.from_numpy(prmu).to(dev).to(torch.int8)
        pa0[:size] = torch.from_numpy(l1).to(dev).to(torch.int8)
        st0 = C.new_state(size, 1500 if inst == 14 else 2300, dev)
        if mt is None:
            sc = C.cycle_scratch(M, n, torch.int8, dev)
            cuda, plain = ((C.cycle_lb1_cuda, C.cycle_lb1_plain) if lb == "lb1"
                           else (C.cycle_lb2_cuda, C.cycle_lb2_plain))
            case = (lambda pv, pa, st: cuda(pv, pa, st, sc, t, M, m, K),
                    lambda pv, pa, st: plain(pv, pa, st, t, M, m, K),
                    cs.CYCLE_KERNELS if lb == "lb1" else cs.LB2_CYCLE_KERNELS, None)
            key = f"{'k2' if lb == 'lb1' else 'k8'}/ta{inst:03d}/M={M}"
        else:
            make, cuda, plain = ((T.tiled_lb1_scratch, T.tiled_lb1_cuda, T.tiled_lb1_plain)
                                 if lb == "lb1" else
                                 (T.tiled_lb2_scratch, T.tiled_lb2_cuda, T.tiled_lb2_plain))
            sc = make(M, n, mt, torch.int8, dev)
            case = (lambda pv, pa, st: cuda(pv, pa, st, sc, t, M, mt, m, K),
                    lambda pv, pa, st: plain(pv, pa, st, t, M, mt, m, K),
                    cs.TILED_KERNELS[lb], sc)
            key = f"{'k9b' if lb == 'lb1' else 'k9c'}/ta{inst:03d}/M={M}/mt={mt}"
        err, out["ms"][key], out["launch_ms"][key] = _cycle_case(
            case[0], case[1], pv0, pa0, st0, case[2], case[3])
        out["err"] = max(out["err"], err)


def measure(family: str) -> dict:
    """The JSON line of one checkout: the build of the sources it times,
    then ``family`` ("lb1", "lb2", "all": both, or "tiled")."""
    from tpu_tree_search_torch.ops import _build

    t0 = time.perf_counter()
    sources = {"lb1": ("lb1_bounds", "lb1_d_bounds"),
               "lb2": ("lb2_bounds", "cycle_lb2"),
               "lb2self": ("lb2_self_bounds",),
               "kernel6": ("lb2_bounds",),
               "tiled": ("cycle_lb1", "cycle_nqueens", "cycle_lb2", "tiled_nqueens",
                         "tiled_lb2", "tiled_lb1", "nqueens_labels")}
    sources = {fam: names for fam, names in sources.items()
               if family == fam or (family == "all" and fam in ("lb1", "lb2"))}
    for names in sources.values():
        for name in names:
            _build.library(name)
    out = {"build_s": time.perf_counter() - t0, "block": {}, "err": 0,
           "ptxas": {name: [ln.strip() for ln in
                            _build.log_path(name).read_text(errors="replace").splitlines()
                            if "registers" in ln or "spill" in ln]
                     for names in sources.values() for name in names}}
    if family in ("lb1", "all"):
        measure_lb1(out)
    if family in ("lb2", "all"):
        measure_lb2(out)
    if family == "tiled":
        measure_tiled(out)
    if family == "lb2self":
        measure_lb2self(out)
    if family == "kernel6":
        measure_kernel6(out)
    return out



def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="?", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--name", default="this")
    ap.add_argument("--family", choices=("lb1", "lb2", "all", "tiled", "lb2self",
                                         "kernel6"), default=None)
    ap.add_argument("--lb1-steps", action="store_true")
    ap.add_argument("--tiled-steps", action="store_true")
    ap.add_argument("--lb2self-steps", action="store_true")
    ap.add_argument("--optin-steps", action="store_true")
    ap.add_argument("--parent", type=Path, default=HERE / "_checkout" / "parent")
    args = ap.parse_args()
    if args.lb1_steps:
        variants, family = LB1_STEPS, args.family or "lb1"
    elif args.lb2self_steps:
        variants, family = LB2SELF_STEPS, args.family or "lb2self"
    elif args.optin_steps:
        variants, family = OPTIN_STEPS, args.family or "kernel6"
    elif args.tiled_steps:
        variants, family = TILED_STEPS, args.family or "tiled"
    elif args.variants is not None:
        variants, family = json.loads(args.variants.read_text()), args.family or "all"
    else:
        print(json.dumps({"variant": args.name, **measure(args.family or "all")}),
              flush=True)
        return 0
    base = HERE / "_checkout" / "sweep"
    for name, subs in variants:
        make_variant(HERE, base / name, subs, args.parent)
    failed = False
    for _ in range(args.rounds):
        for name, _subs in variants:
            p = subprocess.run([sys.executable, "chip_sweep.py", "--name", name,
                                "--family", family],
                               cwd=base / name, capture_output=True, text=True,
                               timeout=900)
            failed |= p.returncode != 0
            print(p.stdout.strip() or json.dumps(
                {"variant": name, "rc": p.returncode, "stderr": p.stderr[-2000:]}),
                flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
