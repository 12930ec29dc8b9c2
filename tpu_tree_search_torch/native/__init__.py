"""The native (C++) host runtime: warm-up, drain, sequential search and the
consumption of device results, bound with ctypes.

``tpu_tree_search_torch/csrc/tts_native.cpp`` is compiled by ``g++``
(``$CXX``) at first use into ``tpu_tree_search_torch/_build/`` (not
committed) and loaded with ``ctypes``; it needs no CUDA toolkit, so it
builds on any host. The library is keyed on a hash of the source, the
compiler, the flags and, under ``-march=native``, the host CPU, and is
written to a per-process temporary name before it is renamed into place, so
concurrent builds (test workers, parallel runs) never load a half-written
file and an object built for one CPU is never loaded on another.

A failed build raises with the compiler's output; ``TTS_NATIVE=0`` selects
the Python host path (`problems/*.py`, `engine/device.py`), which stays the
semantic oracle of everything here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "tts_native.cpp"
# TTS_BUILD_DIR moves the build directory (the kernels' too, `ops/_build.py`).
BUILD = Path(os.environ.get("TTS_BUILD_DIR") or _PKG / "_build")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
# The loaded library of this process (one per process, never replaced).
_lib: ctypes.CDLL | None = None


def enabled() -> bool:
    """Whether the native runtime serves the host phases: ``TTS_NATIVE``
    unset or anything but ``0``."""
    return os.environ.get("TTS_NATIVE", "1") != "0"


def _cpu_tag() -> str:
    """The host CPU a ``-march=native`` object is built for."""
    try:
        text = Path("/proc/cpuinfo").read_text(errors="replace")
    except OSError:
        return platform.processor() or platform.machine()
    keys = ("model name", "flags", "Features", "CPU part")
    return "\n".join(sorted({ln for ln in text.splitlines()
                             if ln.split(":")[0].strip() in keys}))


def build() -> Path:
    """The shared library, compiled unless this source, compiler, flags and
    CPU already have one. Raises ``RuntimeError`` with the compiler's
    output when the compiler is missing or fails."""
    cxx = os.environ.get("CXX", "g++")
    flags = list(FLAGS)
    try:
        # -march=native where the compiler takes it.
        probe = subprocess.run(
            [cxx, "-march=native", "-E", "-x", "c++", "-", "-o", os.devnull],
            input=b"", capture_output=True)
    except OSError as e:
        raise RuntimeError(f"native build: cannot run {cxx!r}: {e}") from e
    if probe.returncode == 0:
        flags.insert(0, "-march=native")
    key = hashlib.sha256()
    for part in (SOURCE.read_bytes(), cxx.encode(), " ".join(flags).encode(),
                 (_cpu_tag() if "-march=native" in flags else "").encode()):
        key.update(part)
    out = BUILD / f"libtts_native-{key.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
    proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(SOURCE)],
                          capture_output=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native build failed ({cxx} {' '.join(flags)}):\n"
            + proc.stderr.decode(errors="replace").strip())
    os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32, i64, vp = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
    sigs = {
        "tts_nq_sequential": ([i32, i32, i64p, i64p], None),
        "tts_nq_warmup": ([i32, i32, i64, i32p, u8p, i64, i64p, i64p], i64),
        "tts_nq_drain": ([i32, i32, i32p, u8p, i64, i64p, i64p], None),
        "tts_nq_generate": ([i32, i32p, u8p, i64, u8p, i32p, u8p, i64p], i64),
        "tts_pfsp_new": ([i32, i32, i32, i32p, i32p, i32p, i32, i32p, i32p,
                          i32p], vp),
        "tts_pfsp_free": ([vp], None),
        "tts_pfsp_sequential": ([vp, i32, i64p, i64p, i32p], None),
        "tts_pfsp_warmup": ([vp, i64, i32p, i32p, i32p, i64, i64p, i64p,
                             i32p], i64),
        "tts_pfsp_drain": ([vp, i32p, i32p, i32p, i64, i64p, i64p, i32p],
                           None),
        "tts_pfsp_generate": ([vp, i32p, i32p, i32p, i64, i32p, i32p, i32p,
                               i32p, i64p, i32p], i64),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res


def load() -> ctypes.CDLL | None:
    """The loaded library, built at the first call of the process; None
    under ``TTS_NATIVE=0``. A failed build raises (``build``)."""
    global _lib
    if not enabled():
        return None
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def _i32(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _col(batch: dict, name: str, dtype, count: int | None = None) -> np.ndarray:
    """``batch[name][:count]`` as a contiguous array of ``dtype``: the node
    fields cross the boundary as int32 (uint8 boards), whatever the
    pool's storage type (``TTS_NARROW``)."""
    arr = batch[name] if count is None else batch[name][:count]
    return np.ascontiguousarray(arr, dtype=dtype)


class NativeNQueens:
    """Native host primitives for one N-Queens configuration (any N the
    problem takes: the diagonal masks past 32 queens fall back to the
    per-slot check)."""

    def __init__(self, lib: ctypes.CDLL, N: int, g: int):
        self._lib = lib
        self.N = N
        self.g = g

    def sequential(self) -> tuple[int, int]:
        tree, sol = ctypes.c_int64(), ctypes.c_int64()
        self._lib.tts_nq_sequential(self.N, self.g, ctypes.byref(tree),
                                    ctypes.byref(sol))
        return tree.value, sol.value

    def warmup(self, batch: dict, target: int) -> tuple[dict, int, int]:
        size_in = batch["depth"].shape[0]
        # The C contract: capacity >= max(size_in, target + N - 1).
        cap = max(size_in, target + self.N)
        depth = np.zeros(cap, dtype=np.int32)
        board = np.zeros((cap, self.N), dtype=np.uint8)
        depth[:size_in] = batch["depth"]
        board[:size_in] = batch["board"]
        tree, sol = ctypes.c_int64(), ctypes.c_int64()
        out = self._lib.tts_nq_warmup(
            self.N, self.g, target, _i32(depth), _u8(board), size_in,
            ctypes.byref(tree), ctypes.byref(sol))
        return ({"depth": depth[:out].copy(), "board": board[:out].copy()},
                tree.value, sol.value)

    def drain(self, batch: dict) -> tuple[int, int]:
        depth = _col(batch, "depth", np.int32)
        board = _col(batch, "board", np.uint8)
        tree, sol = ctypes.c_int64(), ctypes.c_int64()
        self._lib.tts_nq_drain(self.N, self.g, _i32(depth), _u8(board),
                               depth.shape[0], ctypes.byref(tree),
                               ctypes.byref(sol))
        return tree.value, sol.value

    def generate_children(self, parents: dict, count: int,
                          labels: np.ndarray) -> tuple[dict, int, int]:
        pdepth = _col(parents, "depth", np.int32, count)
        pboard = _col(parents, "board", np.uint8, count)
        lab = np.ascontiguousarray(labels[:count], dtype=np.uint8)
        cap = count * self.N
        cdepth = np.zeros(cap, dtype=np.int32)
        cboard = np.zeros((cap, self.N), dtype=np.uint8)
        sol_inc = ctypes.c_int64()
        k = self._lib.tts_nq_generate(
            self.N, _i32(pdepth), _u8(pboard), count, _u8(lab), _i32(cdepth),
            _u8(cboard), ctypes.byref(sol_inc))
        children = {"depth": cdepth[:k].copy(), "board": cboard[:k].copy()}
        return children, int(k), sol_inc.value


class NativePFSP:
    """Native host primitives for one PFSP (instance, lb) configuration.

    Owns an opaque context holding the instance tables built by the Python
    oracle (`problems/pfsp/bounds.py`), so every tier shares bit-identical
    tables. Node rows cross the boundary as int32: int8 and int16 storage
    (``TTS_NARROW``; int16 past 127 jobs) is widened on the way in."""

    _LB_KINDS = {"lb1": 0, "lb1_d": 1, "lb2": 2}

    def __init__(self, lib: ctypes.CDLL, lb1_data, lb2_data, lb: str):
        self._lib = lib
        self.jobs = int(lb1_data.jobs)
        # The context copies the tables; these stay alive beside it anyway.
        self._tables = tuple(np.ascontiguousarray(a, dtype=np.int32) for a in (
            lb1_data.p_times, lb1_data.min_heads, lb1_data.min_tails,
            lb2_data.pairs, lb2_data.lags, lb2_data.johnson_schedules))
        ptm, mh, mt, pairs, lags, jsched = self._tables
        self._ctx = lib.tts_pfsp_new(
            self.jobs, int(lb1_data.machines), self._LB_KINDS[lb], _i32(ptm),
            _i32(mh), _i32(mt), pairs.shape[0], _i32(pairs), _i32(lags),
            _i32(jsched))

    def __del__(self):
        ctx = getattr(self, "_ctx", None)
        if ctx:
            self._lib.tts_pfsp_free(ctx)
            self._ctx = None

    def sequential(self, best: int) -> tuple[int, int, int]:
        tree, sol = ctypes.c_int64(), ctypes.c_int64()
        best_out = ctypes.c_int32()
        self._lib.tts_pfsp_sequential(self._ctx, best, ctypes.byref(tree),
                                      ctypes.byref(sol), ctypes.byref(best_out))
        return tree.value, sol.value, best_out.value

    def warmup(self, batch: dict, best: int, target: int):
        size_in = batch["depth"].shape[0]
        cap = max(size_in, target + self.jobs)
        depth = np.zeros(cap, dtype=np.int32)
        limit1 = np.zeros(cap, dtype=np.int32)
        prmu = np.zeros((cap, self.jobs), dtype=np.int32)
        depth[:size_in] = batch["depth"]
        limit1[:size_in] = batch["limit1"]
        prmu[:size_in] = batch["prmu"]
        tree, sol = ctypes.c_int64(), ctypes.c_int64()
        best_io = ctypes.c_int32(best)
        out = self._lib.tts_pfsp_warmup(
            self._ctx, target, _i32(depth), _i32(limit1), _i32(prmu), size_in,
            ctypes.byref(tree), ctypes.byref(sol), ctypes.byref(best_io))
        frontier = {"depth": depth[:out].copy(), "limit1": limit1[:out].copy(),
                    "prmu": prmu[:out].copy()}
        return frontier, tree.value, sol.value, best_io.value

    def drain(self, batch: dict, best: int) -> tuple[int, int, int]:
        depth = _col(batch, "depth", np.int32)
        limit1 = _col(batch, "limit1", np.int32)
        prmu = _col(batch, "prmu", np.int32)
        tree, sol = ctypes.c_int64(), ctypes.c_int64()
        best_io = ctypes.c_int32(best)
        self._lib.tts_pfsp_drain(
            self._ctx, _i32(depth), _i32(limit1), _i32(prmu), depth.shape[0],
            ctypes.byref(tree), ctypes.byref(sol), ctypes.byref(best_io))
        return tree.value, sol.value, best_io.value

    def generate_children(self, parents: dict, count: int, bounds: np.ndarray,
                          best: int):
        n = self.jobs
        pdepth = _col(parents, "depth", np.int32, count)
        plimit1 = _col(parents, "limit1", np.int32, count)
        pprmu = _col(parents, "prmu", np.int32, count)
        bnds = np.ascontiguousarray(bounds[:count], dtype=np.int32)
        cap = count * n
        cdepth = np.zeros(cap, dtype=np.int32)
        climit1 = np.zeros(cap, dtype=np.int32)
        cprmu = np.zeros((cap, n), dtype=np.int32)
        sol_inc = ctypes.c_int64()
        best_io = ctypes.c_int32(best)
        k = self._lib.tts_pfsp_generate(
            self._ctx, _i32(pdepth), _i32(plimit1), _i32(pprmu), count,
            _i32(bnds), _i32(cdepth), _i32(climit1), _i32(cprmu),
            ctypes.byref(sol_inc), ctypes.byref(best_io))
        children = {"depth": cdepth[:k].copy(), "limit1": climit1[:k].copy(),
                    "prmu": cprmu[:k].copy()}
        return children, int(k), sol_inc.value, best_io.value
