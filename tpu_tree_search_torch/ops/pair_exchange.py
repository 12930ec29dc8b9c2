"""The pair-max exchange between the copies of one mesh shard under the lb2
pair axis (``--mp``): the counterpart of the JAX evaluators' ``lax.pmax``
over the mp axis (`tpu_tree_search/ops/pfsp_device.py:893-922`
``lb2_bounds_mp``, `:723-764` ``lb2_self_bounds_mp``). Not a TPU kernel:
the JAX step is an XLA collective.

``PairExchange`` is the exchange group of one shard: one copy a device
position (`parallel/resident_mesh.py` places them), each computing the
pair blocks at its position and then calling its endpoint
(``PairExchange.endpoint(i)``) on its plane, the (M, n) child bounds or the
(R,) self bounds of which the first ``count`` are live. The endpoint
returns the elementwise max over every copy's plane (the first ``count``
words; the rest stay the copy's own), so every copy keeps the same rows.

  * On the card, ``pair_exchange_cuda``: three launches of
    ``csrc/pair_exchange.cu`` on the caller's stream (post, a one-block
    wait, max; its header note gives the design), which a dispatch graph
    captures. The buffers (two parity slots of every peer's plane, a flag
    a peer, a control block) are allocated, and the kernels loaded, when
    the group is made, outside any capture. Copies on different cards need peer access, enabled when
    the group is made; where the hardware has none the group raises: no
    copy ever falls back to running the blocks in turn. A peer that does
    not post within ``timeout_s`` sets the endpoint's error word (a word of
    the copy's state row in the mesh, ``ST_XERR``), which the host reads
    at each dispatch (``check``) and raises on.
  * On the CPU, the plain version: the copies run in host threads, each
    writes its plane into its parity slot, waits at a ``threading.Barrier``
    of the group (``timeout_s``: a missing peer raises) and takes the max
    with ``torch.maximum``. It is the oracle of the tests and runs nothing
    of the card's path.

``pair_exchange_cuda.launches`` counts the exchanges (three kernel
launches each)."""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from .backend import resolve_device
from .dispatch import count_launch, route

#: The state word that holds a mesh copy's exchange error (the words 10-14
#: are the mesh's sums, `ops/mesh.py`; 16-25 the counter block).
ST_XERR = 15
#: Seconds a copy waits for its peers before it fails the run: on the card
#: (the one-block wait's %globaltimer limit), and in the plain version,
#: whose host threads a loaded host or a first import can hold up for
#: seconds.
TIMEOUT_S = 5.0
HOST_TIMEOUT_S = 120.0
#: Peers a copy may have (``TTS_XCHG_MAX_PEERS``).
MAX_PEERS = 32

_VP = ctypes.c_void_p
# plane, count, n, links, P, L, recv, flags, ctl, err, timeout_ns, stream.
_ARGTYPES = (_VP, _VP, ctypes.c_int, _VP, ctypes.c_int, ctypes.c_longlong,
             _VP, _VP, _VP, _VP, ctypes.c_ulonglong, _VP)
_PEER_ARGS = (ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int))


def enable_peers(a: torch.device, b: torch.device) -> None:
    """Peer access between cards ``a`` and ``b`` both ways, or raise where
    the hardware has none."""
    if a == b:
        return
    lib, fn = _build.entry("pair_exchange", "pair_exchange_peers", _PEER_ARGS)
    can = ctypes.c_int()
    _build.check(lib, fn(a.index, b.index, ctypes.byref(can)),
                 "pair_exchange_peers")
    if not can.value:
        raise RuntimeError(
            f"pair exchange: {a} and {b} have no peer access, so the copies "
            "of a shard cannot exchange their planes there (the pair blocks "
            "never fall back to running in turn): give the mesh positions "
            "on cards with peer access")


class PairExchange:
    """The exchange group of one shard's copies, one on each of ``devices``
    (entries may repeat a card), over planes of at most ``capacity`` int32
    words (``timeout_s``: default ``TIMEOUT_S`` on cards, ``HOST_TIMEOUT_S``
    on the CPU). ``endpoint(i)`` is copy i's end."""

    def __init__(self, devices, capacity: int, timeout_s: float | None = None):
        self.devices = [resolve_device(d) for d in devices]
        self.n = len(self.devices)
        if not 2 <= self.n <= MAX_PEERS + 1:
            raise ValueError(f"an exchange joins 2 to {MAX_PEERS + 1} copies, "
                             f"got {self.n}")
        if len({d.type for d in self.devices}) > 1:
            raise ValueError("an exchange's copies are all on cards or all on "
                             "the CPU")
        self.capacity = int(capacity)
        self.cuda = self.devices[0].type == "cuda"
        self.timeout_s = float(timeout_s if timeout_s is not None else
                               TIMEOUT_S if self.cuda else HOST_TIMEOUT_S)
        # The receive planes' stride: a multiple of 4 words (16 bytes).
        self.L = -(-self.capacity // 4) * 4
        if self.cuda:
            lib, load = _build.entry("pair_exchange", "pair_exchange_load",
                                     (ctypes.c_int,))
            for d in {d.index for d in self.devices}:
                # Loaded before any wait spins (`csrc/pair_exchange.cu`).
                _build.check(lib, load(d), "pair_exchange_load")
            for a in self.devices:
                for b in self.devices:
                    if a.index < b.index:
                        enable_peers(a, b)
            P = self.n - 1
            self.recv = [torch.zeros((2, P, self.L), dtype=torch.int32,
                                     device=d) for d in self.devices]
            self.flags = [torch.zeros(P, dtype=torch.int32, device=d)
                          for d in self.devices]
            self.ctl = [torch.zeros(4, dtype=torch.int32, device=d)
                        for d in self.devices]
            self.links = []
            for i, d in enumerate(self.devices):
                row = []
                for k in self._peers(i):
                    j = self._peer_index(i, k)  # copy i's index among k's peers
                    row += [self.recv[k].data_ptr() + 4 * j * self.L,
                            self.flags[k].data_ptr() + 4 * j]
                self.links.append(torch.tensor(row, dtype=torch.int64,
                                               device=d))
        else:
            # The plain version's parity slots, one plane a copy.
            # guarded-by: barrier -- the barrier orders them: each copy
            # writes its own slot before it and reads the others' after it;
            # a slot is written again two exchanges later, once every copy
            # has read it.
            self.slots = [[None] * self.n for _ in range(2)]
            self.barrier = threading.Barrier(self.n, timeout=self.timeout_s)

    def _peers(self, i: int) -> list[int]:
        return [k for k in range(self.n) if k != i]

    @staticmethod
    def _peer_index(i: int, k: int) -> int:
        """Copy i's place in copy k's list of peers."""
        return i if i < k else i - 1

    def endpoint(self, i: int, err: torch.Tensor | None = None
                 ) -> "PairEndpoint":
        """Copy i's end; ``err`` a one-word int32 tensor on its device that
        takes the error word (default: a word of its own)."""
        return PairEndpoint(self, i, err)

    @property
    def nbytes(self) -> int:
        """Device bytes of the group's buffers (none on the CPU)."""
        if not self.cuda:
            return 0
        return sum(t.numel() * t.element_size()
                   for ts in (self.recv, self.flags, self.ctl, self.links)
                   for t in ts)


class PairEndpoint:
    """Copy ``index``'s end of a ``PairExchange``: called on the copy's
    plane (and the live count, an int or a device word), it returns the max
    over the group (``pair_exchange_cuda`` on a CUDA plane, in place; the
    plain version on a CPU one)."""

    def __init__(self, group: PairExchange, index: int,
                 err: torch.Tensor | None = None):
        self.group = group
        self.index = index
        self.device = group.devices[index]
        self.err = (torch.zeros(1, dtype=torch.int32, device=self.device)
                    if err is None else err)
        # What a program key holds of this end (`engine/resident.py`
        # ``program_key``): its group (one a shard; the id is unique while
        # the group lives), the copies' positions and this copy's place.
        self.key = (id(group), tuple(str(d) for d in group.devices), index)
        # The plain version's exchange number (its parity slot).
        self.seq = 0

    # tts-lint: traced (a mesh copy's captured cycle calls its endpoint)
    def __call__(self, plane: torch.Tensor, count=None) -> torch.Tensor:
        with route("pair_exchange_cuda"):
            if plane.is_cuda:
                return pair_exchange_cuda(plane, count, self)
            return pair_exchange_plain(plane, count, self)

    def check(self) -> None:
        """Raise where this copy's wait gave up (reads the error word: a
        host synchronisation)."""
        raise_on_error(int(self.err.reshape(-1)[0]), self.index)


def raise_on_error(word: int, copy: int) -> None:
    """Raise on a copy's exchange error word (0: none)."""
    if word:
        raise RuntimeError(
            f"pair exchange: copy {copy} waited past the timeout for a peer "
            f"that never posted (error word {word}); the copies of a shard "
            "must all be launched")


def pair_exchange_plain(plane: torch.Tensor, count,
                        ep: PairEndpoint) -> torch.Tensor:
    """The plain exchange: ``plane`` into this copy's parity slot, the
    group's barrier, the max of every copy's plane over the first ``count``
    words (a copy of ``plane``; past ``count`` its own words). Raises where
    a peer does not reach the barrier within the timeout."""
    g = ep.group
    s = ep.seq & 1
    ep.seq += 1
    g.slots[s][ep.index] = plane
    try:
        g.barrier.wait()
    except threading.BrokenBarrierError:
        raise RuntimeError(
            f"pair exchange: copy {ep.index} waited {g.timeout_s} s for a "
            "peer that never posted; the copies of a shard must all run"
        ) from None
    n = plane.numel() if count is None else min(int(count), plane.numel())
    out = plane.clone()
    flat = out.view(-1)
    for k, other in enumerate(g.slots[s]):
        if k != ep.index:
            flat[:n] = torch.maximum(flat[:n], other.reshape(-1)[:n])
    return out


def pair_exchange_cuda(plane: torch.Tensor, count,
                       ep: PairEndpoint) -> torch.Tensor:
    """Enqueue one exchange of ``plane`` (contiguous int32 on the copy's
    card, at most the group's capacity) on the current stream, in place:
    post, wait, max (`csrc/pair_exchange.cu`). ``count``: None (the whole
    plane) or a CUDA int32 word on the copy's card bounding the live words.
    Never synchronises; the host reads the error word later."""
    g = ep.group
    # tts-lint: waive tensor-branch -- g is the endpoint's exchange group (host fields: whether it is on cards)
    if not (g.cuda and plane.is_cuda and plane.dtype == torch.int32
            and plane.is_contiguous() and plane.device == ep.device):
        raise ValueError("pair_exchange_cuda takes a contiguous int32 plane "
                         "on the endpoint's card")
    # tts-lint: waive tensor-branch -- g.capacity is the exchange group's int capacity
    if plane.numel() > g.capacity:
        raise ValueError(f"a plane of {plane.numel()} words exceeds the "
                         f"exchange's capacity {g.capacity}")
    if count is not None and not (
            isinstance(count, torch.Tensor) and count.is_cuda
            and count.dtype == torch.int32 and count.device == ep.device):
        raise ValueError("count is a CUDA int32 word on the endpoint's card")
    i = ep.index
    lib, fn = _build.entry("pair_exchange", "pair_exchange_enqueue",
                           _ARGTYPES)
    stream = torch.cuda.current_stream(plane.device).cuda_stream
    err = fn(plane.data_ptr(), None if count is None else count.data_ptr(),
             plane.numel(), g.links[i].data_ptr(), g.n - 1, g.L,
             g.recv[i].data_ptr(), g.flags[i].data_ptr(), g.ctl[i].data_ptr(),
             # tts-lint: waive host-sync-in-capture -- g.timeout_s is the group's timeout, a Python float
             ep.err.data_ptr(), int(g.timeout_s * 1e9), stream)
    _build.check(lib, err, "pair_exchange")
    count_launch(pair_exchange_cuda)
    return plane


pair_exchange_cuda.launches = 0  # type: ignore[attr-defined]
pair_exchange_cuda.captures = 0  # type: ignore[attr-defined]
