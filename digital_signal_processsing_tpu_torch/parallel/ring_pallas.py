"""The ring right-shift (B6) and the fused ring windowed averager (B7).

Counterpart of ``digital_signal_processsing_tpu/parallel/ring_pallas.py``:

- :func:`ring_shift_right_shard` / :func:`ring_shift_right`: B6, a put of
  this rank's buffer into its right neighbour's receive buffer by a kernel
  (``csrc/ring.cu``) through a peer device pointer, where the reference's
  ``_ring_kernel`` starts and awaits a remote copy. Rank d receives rank
  d-1's buffer; rank 0 receives zeros (the causal halo).
- :func:`fused_ring_windowed_shard`: B7, the windowed averager (B1) over a
  shard with the halo put in flight under the interior tiles. The reference
  rotates a sequential grid so that tile 0, the one needing the remote
  halo, runs last. Here B1's spans carry nothing (each scans the halo before
  it), so one launch of ``csrc/ring.cu``'s ``ring_windowed_kernel`` puts the
  shard's trailing ``window * channels`` samples into the right neighbour's
  slot (block 0, first) and runs B1's spans over the tiles whose window lies
  inside the shard; a stream wait for the left neighbour's put and a second
  launch run the head tiles seeded from the received halo. (On one card the
  head block waiting inside the first launch, and B6's put as a launch of
  its own before B1's, were slower: ``tools/ab_ring.py`` times both.)

For CPU tensors both take their plain version, the ``ppermute`` spelling
(``mesh.shift_right``, ``dist.batch_isend_irecv``). For a CUDA tensor they
launch their kernels or raise: a refused IPC open, a failed build or launch
raise with the CUDA error, and nothing falls back to NCCL or to the plain
version.

Buffers. Each (bytes, mesh) key gets one ``cudaMalloc``'ed receive buffer on
every rank of the time axis: a header of 64-bit counters, one 128-byte line
each (:func:`counter_offset`: ``sent``, ``consumed`` and ``done``, the put's
count of finished blocks, one of each a slot), then ``RING_SLOTS`` slots.
The first call of a key exchanges the IPC handles once over the mesh's gloo
host group, and each rank maps its right neighbour's buffer. The last rank
puts nothing (its right neighbour is rank 0, which receives zeros), so at
world size 1 there is no buffer, no put and no wait.

Ordering, on the device. Calls of a key are numbered 1, 2, ... on every
rank (SPMD order) and :func:`ring_step` gives call N's slot and targets. The
sender's stream waits until the receiver's ``consumed[slot]`` reaches N -
RING_SLOTS (it has read that slot's last payload), the put stores through
the mapping and releases ``sent[slot] = N`` at system scope from its last
block; the receiver's stream waits until its ``sent[slot]`` reaches N, reads
the slot, and releases ``consumed[slot] = N``. Waits are stream memory
operations (``cuStreamWaitValue64``: the host engine polls, no SM is held;
with the flush of remote writes where the card offers it, which the H100
80GB HBM3 does not) and "at least N" names the call, so a wait never binds
to another call's signal and the hosts take no part after a key's first
call: no barrier, no gather, no synchronisation.
``tests/test_torch_ring_protocol.py`` runs this rule over random
interleavings of the ranks' steps.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .. import _build
from ..ops.pallas_scan import (
    _on_cuda,
    _resident,
    _stream,
    windowed_averager,
    windowed_geometry,
    windowed_supported,
)
from ..utils.layout import cdiv, round_up, validate_window
from .mesh import TIME_AXIS, Mesh, host_barrier, shift_right

RING_SLOTS = 2  # call N's put may land while the receiver still reads call N - 1's
COUNTERS = ("sent", "consumed", "done")  # a slot's counters, each on a line of its own
_LINE = 128  # bytes a counter: one cache line each
_HEADER = 1024  # the counters' lines, rounded to _SLOT_ALIGN
_SLOT_ALIGN = 256  # slots start 256-byte aligned: the put's 16-byte stores need 16
assert len(COUNTERS) * RING_SLOTS * _LINE <= _HEADER


@dataclasses.dataclass(frozen=True)
class RingStep:
    """What call ``call`` (1, 2, ...) of a key does on every rank.

    The sender waits until the receiver's ``consumed[slot] >= reuse`` (none
    when ``reuse < 1``), puts into ``slot`` and sets ``sent[slot] = call``;
    the receiver waits until its ``sent[slot] >= arrival``, reads the slot
    and sets ``consumed[slot] = call``.
    """

    call: int
    slot: int
    reuse: int
    arrival: int


def ring_step(call: int) -> RingStep:
    """Slot and wait targets of call ``call`` of a key, the same on every rank."""
    if call < 1:
        raise ValueError(f"calls count from 1, got {call}")
    return RingStep(call=call, slot=(call - 1) % RING_SLOTS, reuse=call - RING_SLOTS, arrival=call)


def ring_roles(n_time: int, t: int) -> tuple[bool, bool]:
    """(receives, puts) of rank ``t`` of the time axis: rank 0 receives
    zeros, and the last rank's right neighbour is rank 0, so it puts nothing."""
    return t > 0, t + 1 < n_time


def _handle() -> ctypes.Array:
    return ctypes.create_string_buffer(64)


def counter_offset(name: str, slot: int) -> int:
    """Byte offset of counter ``name`` (one of COUNTERS) of ``slot`` in a
    receive buffer's header. ``done`` is the sender's own count of its put's
    finished blocks: one a slot, so two puts of a key in flight at once (on
    two streams) never count into one line."""
    return (COUNTERS.index(name) * RING_SLOTS + slot) * _LINE


def _sent(base: int, slot: int) -> int:
    return base + counter_offset("sent", slot)


def _consumed(base: int, slot: int) -> int:
    return base + counter_offset("consumed", slot)


class _Ring:
    """Receive buffer of one key on one rank, and the mapping of its right
    neighbour's (a time axis of two ranks or more)."""

    def __init__(self, nbytes: int, mesh: Mesh):
        lib = _build.library()
        self.mesh = mesh
        self.nbytes = nbytes
        self.slot_bytes = round_up(max(nbytes, 1), _SLOT_ALIGN)
        self.calls = 0
        n, i = mesh.n_time, mesh.t
        self.has_left, self.has_right = ring_roles(n, i)
        self.right_base = None
        base, mem_h = ctypes.c_void_p(), _handle()
        with torch.cuda.device(mesh.device):
            _build.check(lib.dsp_ring_alloc(_HEADER + RING_SLOTS * self.slot_bytes,
                                            ctypes.byref(base), mem_h), "ring buffer cudaMalloc")
            self.base = base.value
        peers: list = [None] * n
        torch.distributed.all_gather_object(peers, mem_h.raw, group=mesh.host_group)
        if self.has_right:
            with torch.cuda.device(mesh.device):
                ptr = ctypes.c_void_p()
                _build.check(lib.dsp_ring_open(peers[i + 1], ctypes.byref(ptr)),
                             "cudaIpcOpenMemHandle of the right neighbour's ring buffer")
                self.right_base = ptr.value

    def next_step(self) -> RingStep:
        self.calls += 1
        return ring_step(self.calls)

    def done(self, step: RingStep) -> int:
        """This rank's count of the finished blocks of its put into ``step``'s slot."""
        return self.base + counter_offset("done", step.slot)

    def received(self, step: RingStep) -> int:
        """Device address of this rank's slot of ``step``."""
        return self.base + _HEADER + step.slot * self.slot_bytes

    def own_sent(self, step: RingStep) -> int:
        return _sent(self.base, step.slot)

    def own_consumed(self, step: RingStep) -> int:
        return _consumed(self.base, step.slot)

    def right_slot(self, step: RingStep) -> int:
        return self.right_base + _HEADER + step.slot * self.slot_bytes

    def right_sent(self, step: RingStep) -> int:
        return _sent(self.right_base, step.slot)

    def wait_reuse(self, step: RingStep, stream: int) -> None:
        """The sender's stream waits for the right neighbour's read of the slot's last payload."""
        if step.reuse >= 1:
            _build.check(_build.library().dsp_ring_wait(
                _consumed(self.right_base, step.slot), step.reuse, stream), "ring wait (consumed)")

    def put(self, src: int, step: RingStep, stream: int) -> None:
        """Once the right neighbour has read the slot's last payload, B6's
        kernel puts ``nbytes`` from ``src`` into it and its last block
        releases the neighbour's ``sent``."""
        self.wait_reuse(step, stream)
        _build.check(_build.library().dsp_ring_put(src, self.right_slot(step), self.nbytes,
                                                   self.right_sent(step), step.call,
                                                   self.done(step), stream), "ring_put")

    def release_slot(self, step: RingStep, stream: int) -> None:
        """After this rank's last read of the slot: ``consumed[slot] = call``."""
        _build.check(_build.library().dsp_ring_signal(self.own_consumed(step), step.call, stream),
                     "ring signal (consumed)")

    def wait_arrived(self, step: RingStep, stream: int) -> None:
        """The receiver's stream waits for the left neighbour's put of this call."""
        _build.check(_build.library().dsp_ring_wait(self.own_sent(step), step.arrival, stream),
                     "ring wait (sent)")

    def release(self) -> None:
        lib = _build.library()
        with torch.cuda.device(self.mesh.device):
            torch.cuda.synchronize(self.mesh.device)
            if self.right_base is not None:
                _build.check(lib.dsp_ring_close(self.right_base), "cudaIpcCloseMemHandle")
            self.right_base = None

    def free(self) -> None:
        with torch.cuda.device(self.mesh.device):
            _build.check(_build.library().dsp_ring_free(self.base), "ring buffer cudaFree")


def _ring(mesh: Mesh, nbytes: int) -> _Ring:
    """The receive buffer of this key, made (collectively) at its first use."""
    ring = mesh.rings.get(nbytes)
    if ring is None:
        ring = mesh.rings[nbytes] = _Ring(nbytes, mesh)
    return ring


def release_rings(mesh: Mesh) -> None:
    """Close the neighbours' buffers, then free this rank's.

    Collective over the time axis: no rank frees a buffer while a neighbour
    still maps it, and the counters go with their buffer.
    """
    if not mesh.rings:
        return
    host_barrier(mesh)
    for ring in mesh.rings.values():
        ring.release()
    host_barrier(mesh)
    for ring in mesh.rings.values():
        ring.free()
    mesh.rings.clear()


def _check_mesh(x: torch.Tensor, mesh: Mesh) -> None:
    if x.device != mesh.device:
        raise ValueError(f"shard on {x.device}, mesh on {mesh.device}")


def ring_shift_right_shard(x_loc: torch.Tensor, mesh: Mesh, axis: str = TIME_AXIS) -> torch.Tensor:
    """Receive the left neighbour's shard on the time axis; rank 0 gets zeros (B6).

    ``x_loc``: any contiguous tensor, of one shape on every rank. A CUDA
    tensor is put into the right neighbour's receive slot by the kernel, and
    the slot this rank received is copied out: the put lands in memory the
    receiver owns and mapped once, where the new output of each call could
    be mapped only by a host exchange a call. So the shard's bytes move
    twice, across the link and in one local copy (its bound counts them once
    in and once out). The last rank puts nothing (rank 0 reads zeros) and
    counts no launch. A CPU tensor takes the ``ppermute`` spelling.
    """
    if axis != TIME_AXIS:
        raise ValueError(f"the ring runs over the time axis {TIME_AXIS!r}, got {axis!r}")
    if not x_loc.is_contiguous():
        raise ValueError("x_loc must be contiguous")
    if not _on_cuda(x_loc):
        return shift_right(x_loc, mesh)
    _check_mesh(x_loc, mesh)
    _build.library()  # built at first use; raises if it cannot be
    if mesh.n_time == 1:
        return torch.zeros_like(x_loc)
    with torch.cuda.device(x_loc.device):
        ring = _ring(mesh, x_loc.numel() * x_loc.element_size())
        step, stream = ring.next_step(), _stream(x_loc)
        if ring.has_right:
            ring.put(x_loc.data_ptr(), step, stream)
            ring_shift_right_shard.launches += 1
        if not ring.has_left:  # the ring wraps; the causal halo of rank 0 is zeros
            return torch.zeros_like(x_loc)
        ring.wait_arrived(step, stream)
        out = torch.empty_like(x_loc)
        out.view(torch.uint8).view(-1).copy_(_device_view(ring.received(step), ring.nbytes,
                                                          x_loc.device))
        ring.release_slot(step, stream)
    return out


ring_shift_right_shard.launches = 0


def _device_view(ptr: int, nbytes: int, device: torch.device) -> torch.Tensor:
    """A uint8 tensor over device memory this module allocated (no copy)."""

    class _Buf:
        __cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False), "version": 3,
            "strides": None,
        }

    return torch.as_tensor(_Buf(), device=device)


def ring_shift_right(x: torch.Tensor, mesh: Mesh, axis: str = TIME_AXIS) -> torch.Tensor:
    """Whole-shard helper: this rank's shard of any shape, shifted one rank right."""
    flat = x.reshape(-1).contiguous()
    return ring_shift_right_shard(flat, mesh, axis).reshape(x.shape)


def fused_ring_split(n: int, window: int, channels: int, tile_samples: int | None = None):
    """B7's tiles for a shard of ``n`` samples: (B1's geometry, head tiles,
    tiles). The windows of tiles ``[0, head)`` reach before the shard (the
    received halo); those of tiles ``[head, tiles)``, and the H samples a
    span starting there scans first, lie inside it."""
    g = windowed_geometry(window, channels, tile_samples)
    tiles = g.tiles(n)
    return g, min(tiles, cdiv(window * channels, g.tile_samples)), tiles


@dataclasses.dataclass(frozen=True)
class RingLaunch:
    """One launch of ``ring_windowed_kernel``: B1's spans of ``span_tiles``
    over the tiles ``interior``, then, in the last block, the head tiles
    ``[0, head_tiles)``; block 0 first puts the tail where ``put``."""

    interior: tuple[int, int]
    span_tiles: int
    head_tiles: int
    put: bool


@functools.lru_cache(maxsize=256)
def fused_ring_launches(n: int, window: int, channels: int, resident: int, *, left: bool,
                        right: bool, tile_samples: int | None = None) -> tuple[RingLaunch, ...]:
    """B7's launches on a rank for a shard of ``n`` samples: ``left`` when a
    halo arrives (not rank 0), ``right`` when it puts its own (not the last
    rank). With a halo, the put and the interior, then, behind the stream's
    wait for the left neighbour's put, the head seeded from the slot; without
    one, a single launch with the head (unseeded) in its last block.
    ``resident``: blocks in one wave, over which the interior's spans spread."""
    _, head, tiles = fused_ring_split(n, window, channels, tile_samples)
    span = windowed_geometry(window, channels).range_span(tiles - head, resident) if head < tiles else 1
    if not left:
        return (RingLaunch((head, tiles), span, head, right),)
    first = (RingLaunch((head, tiles), span, 0, right),) if head < tiles or right else ()
    return first + (RingLaunch((tiles, tiles), 1, head, False),)


@functools.lru_cache(maxsize=64)
def _supported_geometry(window: int, channels: int):
    """B1's geometry, or the refusal of a halo outside its envelope."""
    if not windowed_supported(window, channels):
        raise ValueError(
            f"window*channels = {window * channels} is outside the windowed kernel's envelope; "
            "use sharded_moving_average, which takes the scan method there"
        )
    return windowed_geometry(window, channels)


def fused_ring_windowed_shard(
    xs: torch.Tensor,
    window: int,
    channels: int,
    mesh: Mesh,
    axis: str = TIME_AXIS,
    *,
    tile_samples: int | None = None,
) -> torch.Tensor:
    """Windowed averager of this rank's shard with the halo put overlapped (B7).

    Drop-in for the ``ppermute`` + seeded B1 spelling. Needs
    ``windowed_supported(window, channels, tile_samples)`` and a shard of
    whole frames holding at least one halo (``window * channels`` samples).
    """
    validate_window(window)
    if axis != TIME_AXIS:
        raise ValueError(f"the ring runs over the time axis {TIME_AXIS!r}, got {axis!r}")
    if xs.dtype != torch.int16 or xs.dim() != 1 or not xs.is_contiguous():
        raise ValueError(f"xs must be a contiguous 1-D int16 shard, got {xs.dtype}{tuple(xs.shape)}")
    n, halo = xs.numel(), window * channels
    if channels < 1 or n % channels:
        raise ValueError(f"shard of {n} samples is not whole frames of {channels} channels")
    if n < halo:
        raise ValueError(f"shard of {n} samples cannot source a {halo}-sample halo")
    g = _supported_geometry(window, channels)
    if not _on_cuda(xs):
        return windowed_averager(xs, window, channels, seed=shift_right(xs[n - halo :], mesh),
                                 tile_samples=tile_samples)
    _check_mesh(xs, mesh)
    lib = _build.library()  # a failed build raises before any CUDA call
    y = torch.empty_like(xs)
    with torch.cuda.device(xs.device):
        stream = _stream(xs)
        ring = _ring(mesh, halo * xs.element_size()) if mesh.n_time > 1 else None
        step = ring.next_step() if ring else ring_step(1)
        left, right = (ring.has_left, ring.has_right) if ring else (False, False)
        seed = ring.received(step) if left else None
        if right:
            ring.wait_reuse(step, stream)
        for launch in fused_ring_launches(n, window, channels, _resident(xs.device, g), left=left,
                                          right=right, tile_samples=tile_samples):
            seeded = left and launch.head_tiles > 0  # this launch's head reads the slot
            if seeded:
                ring.wait_arrived(step, stream)
            put = launch.put
            err = lib.dsp_ring_windowed(
                xs.data_ptr(), y.data_ptr(), seed, n, window, channels, g.kernel_c, g.nrun,
                *launch.interior, launch.span_tiles, launch.head_tiles, g.smem_bytes,
                xs.data_ptr() + 2 * (n - halo) if put else None,
                ring.right_slot(step) if put else None,
                ring.right_sent(step) if put else None,
                ring.own_consumed(step) if seeded else None, step.call, stream,
            )
            _build.check(err, "fused_ring_windowed_shard")
    fused_ring_windowed_shard.launches += 1
    return y


fused_ring_windowed_shard.launches = 0


def fused_ring_kernel_attrs(window: int, channels: int = 2) -> tuple:
    """What the compiler gave B7's kernel for ``channels`` (the card only):
    registers a thread, local bytes a thread, shared bytes a block, blocks an
    SM at ``window``, as ``pallas_scan.windowed_kernel_attrs`` gives B1's."""
    g = windowed_geometry(window, channels)
    out = (ctypes.c_int64 * 4)()
    _build.check(_build.library().dsp_ring_windowed_attrs(g.kernel_c, g.smem_bytes,
                                                          ctypes.addressof(out)),
                 "fused_ring_kernel_attrs")
    return tuple(out)


__all__ = [
    "RING_SLOTS",
    "COUNTERS",
    "counter_offset",
    "RingStep",
    "ring_step",
    "ring_roles",
    "RingLaunch",
    "fused_ring_launches",
    "fused_ring_split",
    "ring_shift_right_shard",
    "ring_shift_right",
    "fused_ring_windowed_shard",
    "fused_ring_kernel_attrs",
    "release_rings",
]
