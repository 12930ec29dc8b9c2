"""Build and load the port's CUDA kernels.

Every ``tpu_tree_search_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which is loaded
with ``ctypes`` — no PyTorch headers, so a source builds in seconds. The
build happens at first use, on the machine with the card, into
``tpu_tree_search_torch/_build/`` (not committed; ``TTS_BUILD_DIR`` moves
it). Each library is cached
under a hash of its source, the shared headers and the flags, so an edit
rebuilds and an unchanged tree reuses the build. All sources are compiled at
once, one ``nvcc`` process each, so the wall time is that of the slowest.

Calling convention of every C entry: pointers and the stream are
``c_void_p`` (``tensor.data_ptr()``, ``torch.cuda.current_stream()
.cuda_stream``), sizes are ``c_int``, and the return value is
``cudaGetLastError()`` after the entry's launches; ``check`` raises when it
is not 0. A kernel launches on the caller's stream, never synchronises and
allocates nothing: its wrapper allocates with ``torch.empty``.

Threads: the multi-device tier and the serve daemon launch kernels from
several host threads. ``library`` builds and loads under one lock, so the
first caller builds and the others wait for it, and the compiler writes
to a temporary name of its own thread. The C entries keep a few host-side
statics (the last launch shape a kernel asked the occupancy for, the
shared-memory size it set last), so ``entry`` returns the C function
behind a lock of its library: two threads never run one library's entries
at once. The entries only enqueue, so the lock is held for microseconds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
# TTS_BUILD_DIR moves the build directory (the native runtime's too).
BUILD = Path(os.environ.get("TTS_BUILD_DIR") or PKG / "_build")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v")
# Flags of one source beyond FLAGS: the dispatch graph's condition kernels
# call cudaGraphSetConditional, a device runtime function (relocatable
# device code, linked with the device runtime).
EXTRA_FLAGS = {"dispatch_graph": ("-rdc=true", "-lcudadevrt")}

# Loaded libraries by source stem: loaded once per process, never mutated.
_LIBS: dict[str, ctypes.CDLL] = {}
# Guards the build and the loading of ``_LIBS`` (``library``).
_LOCK = threading.Lock()
# One lock a library: its entries' host-side statics (``entry``).
_CALL_LOCKS: dict[str, threading.Lock] = {}
# Guards the wrappers' launch counts (``+=`` is not atomic across threads).
_COUNT_LOCK = threading.Lock()


def add_launches(wrapper, n: int = 1) -> None:
    """Add ``n`` to ``wrapper.launches`` (any thread may launch)."""
    with _COUNT_LOCK:
        wrapper.launches += n


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of tpu_tree_search_torch are built on the machine with the card"
        )
    return path


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _target(src: Path) -> Path:
    h = hashlib.sha256()
    for dep in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    h.update(" ".join(ARCH + FLAGS + EXTRA_FLAGS.get(src.stem, ())).encode())
    return BUILD / f"{src.stem}-{h.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of the current build of ``csrc/<name>.cu``."""
    return _target(CSRC / f"{name}.cu").with_suffix(".log")


def build_all() -> dict[str, float]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{stem: seconds}`` for the sources compiled by this call (an
    empty dict when everything was cached). Raises with the compiler's
    output when any source fails.
    """
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    t0 = time.perf_counter()
    for src in sources():
        so = _target(src)
        if so.exists():
            continue
        tmp = so.with_name(
            f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        proc = subprocess.Popen(
            [nvcc, *ARCH, *FLAGS, *EXTRA_FLAGS.get(src.stem, ()), "-o",
             str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        jobs.append((src, so, tmp, proc))
    seconds: dict[str, float] = {}
    failures = []
    for src, so, tmp, proc in jobs:
        out, _ = proc.communicate()
        seconds[src.stem] = time.perf_counter() - t0
        so.with_suffix(".log").write_bytes(out)
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{out.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, so)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building first if needed:
    under ``_LOCK``, so concurrent first calls build once."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            so = _target(CSRC / f"{name}.cu")
            if not so.exists():
                build_all()
            lib = ctypes.CDLL(str(so))
            lib.tts_error_string.argtypes = [ctypes.c_int]
            lib.tts_error_string.restype = ctypes.c_char_p
            _CALL_LOCKS[name] = threading.Lock()
            _LIBS[name] = lib
    return lib


@functools.cache
def entry(name: str, symbol: str, argtypes: tuple, restype=ctypes.c_int):
    """The loaded library of ``csrc/<name>.cu`` and its C function
    ``symbol``, with ``argtypes`` and ``restype`` declared (bound once),
    called under its library's lock."""
    lib = library(name)
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    lock = _CALL_LOCKS[name]

    def call(*args):
        with lock:
            return fn(*args)

    call.__name__ = symbol
    return lib, call


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronise would not report it)."""
    if err != 0:
        msg = lib.tts_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
