"""The ring right-shift (B6) and the fused ring windowed averager (B7).

Counterpart of ``digital_signal_processsing_tpu/parallel/ring_pallas.py``:

- :func:`ring_shift_right_shard` / :func:`ring_shift_right`: B6, a put of
  this rank's buffer into its right neighbour's receive buffer by a kernel
  (``csrc/ring.cu``) through a peer device pointer, where the reference's
  ``_ring_kernel`` starts and awaits a remote copy. Rank d receives rank
  d-1's buffer; rank 0 receives zeros (the causal halo).
- :func:`fused_ring_windowed_shard`: B7, the windowed averager (B1) over a
  shard with the halo put in flight under the interior blocks. The
  reference rotates a sequential grid so that tile 0, the one needing the
  remote halo, runs last. B1's spans carry nothing (each scans the halo
  before it), so here one call is: the put of the shard's trailing
  ``window * channels`` samples on a side stream, B1 over the tiles whose
  window lies inside the shard, a wait for the left neighbour's put, and B1
  over the head tiles seeded from the received halo (``csrc/windowed.cu``,
  ``dsp_windowed_i16_range``).

For CPU tensors both take their plain version, the ``ppermute`` spelling
(``mesh.shift_right``, ``dist.batch_isend_irecv``). For a CUDA tensor they
launch their kernels or raise: a refused IPC open, a failed build or launch
raise with the CUDA error, and nothing falls back to NCCL or to the plain
version.

Buffers and ordering. Each (bytes, mesh) key gets one ``cudaMalloc``'ed
receive buffer of two slots on every rank of the time axis, and four
interprocess events: ``sent`` and ``consumed``, one a slot. The handles are
exchanged once over the mesh's gloo host group and the right neighbour's
buffer and the neighbours' events are opened (at world size 1 the rank is
its own neighbour and uses its own). Call N of a key uses slot N % 2 on
every rank:

1. the put waits for the right neighbour's ``consumed[slot]``, puts, and
   records ``sent[slot]``;
2. a host barrier over the time axis, so that every rank's record of this
   call precedes every wait on it;
3. the receiver's stream waits on the left neighbour's ``sent[slot]``,
   reads the slot, and records ``consumed[slot]``.

A stream wait binds to the latest record issued before it. The barrier of
call N orders step 1 of call N before step 3 of call N on the host; the
barrier of call N+1 orders step 3 of call N before step 1 of call N+2, the
next use of the slot. So no put overwrites a slot its reader has not read,
and no wait binds to another call's record: the hazards the reference
guards with its per-exchange collective ids.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..ops.pallas_scan import (
    _on_cuda,
    _stream,
    launch_windowed_range,
    windowed_averager,
    windowed_geometry,
    windowed_supported,
)
from ..utils.layout import cdiv, round_up, validate_window
from .mesh import TIME_AXIS, Mesh, host_barrier, shift_right

_SLOT_ALIGN = 256  # slots start 256-byte aligned: the put's 16-byte stores need 16


def _handle() -> ctypes.Array:
    return ctypes.create_string_buffer(64)


class _Ring:
    """Receive buffer (two slots) and events of one key on one rank."""

    def __init__(self, nbytes: int, mesh: Mesh):
        lib = _build.library()
        self.mesh = mesh
        self.nbytes = nbytes
        self.slot = round_up(max(nbytes, 1), _SLOT_ALIGN)
        self.calls = 0
        self.opened_mem = None
        self.opened_events: list[int] = []
        base, mem_h = ctypes.c_void_p(), _handle()
        with torch.cuda.device(mesh.device):
            _build.check(lib.dsp_ring_alloc(2 * self.slot, ctypes.byref(base), mem_h),
                         "ring buffer cudaMalloc")
            self.base = base.value
            self.sent, sent_h = self._events(lib)
            self.consumed, consumed_h = self._events(lib)
        self.side = torch.cuda.Stream(mesh.device)  # B7's put, beside the compute stream
        n, i = mesh.n_time, mesh.t
        if n == 1:  # the rank is its own neighbour; a process cannot open its own handles
            self.right_base, self.left_sent, self.right_consumed = self.base, self.sent, self.consumed
            return
        peers: list = [None] * n
        torch.distributed.all_gather_object(
            peers, (mem_h.raw, sent_h, consumed_h), group=mesh.host_group
        )
        right, left = peers[(i + 1) % n], peers[(i - 1) % n]
        with torch.cuda.device(mesh.device):
            ptr = ctypes.c_void_p()
            _build.check(lib.dsp_ring_open(right[0], ctypes.byref(ptr)),
                         "cudaIpcOpenMemHandle of the right neighbour's ring buffer")
            self.opened_mem = self.right_base = ptr.value
            self.left_sent = [self._open_event(lib, h) for h in left[1]]
            self.right_consumed = [self._open_event(lib, h) for h in right[2]]

    def _events(self, lib) -> tuple[list[int], list[bytes]]:
        events, handles = [], []
        for _ in range(2):
            ev, h = ctypes.c_void_p(), _handle()
            _build.check(lib.dsp_ring_event(ctypes.byref(ev), h), "ring interprocess event")
            events.append(ev.value)
            handles.append(h.raw)
        return events, handles

    def _open_event(self, lib, handle: bytes) -> int:
        ev = ctypes.c_void_p()
        _build.check(lib.dsp_ring_event_open(handle, ctypes.byref(ev)),
                     "cudaIpcOpenEventHandle of a neighbour's ring event")
        self.opened_events.append(ev.value)
        return ev.value

    def next_slot(self) -> int:
        s = self.calls % 2
        self.calls += 1
        return s

    def put(self, src: torch.Tensor, slot: int, stream: int) -> None:
        """Step 1: wait for the right neighbour's read of ``slot``, put, record."""
        lib = _build.library()
        _build.check(lib.dsp_ring_wait(stream, self.right_consumed[slot]), "ring wait (consumed)")
        _build.check(
            lib.dsp_ring_put(src.data_ptr(), self.right_base + slot * self.slot,
                             src.numel() * src.element_size(), stream),
            "ring_put",
        )
        _build.check(lib.dsp_ring_record(self.sent[slot], stream), "ring record (sent)")

    def wait_sent(self, slot: int, stream: int) -> None:
        """Step 3's wait: ``stream`` waits for the left neighbour's put into ``slot``."""
        lib = _build.library()
        _build.check(lib.dsp_ring_wait(stream, self.left_sent[slot]), "ring wait (sent)")

    def consumed_by(self, slot: int, stream: int) -> None:
        lib = _build.library()
        _build.check(lib.dsp_ring_record(self.consumed[slot], stream), "ring record (consumed)")

    def received(self, slot: int) -> int:
        """Device address of this rank's ``slot``."""
        return self.base + slot * self.slot

    def release(self) -> None:
        lib = _build.library()
        with torch.cuda.device(self.mesh.device):
            torch.cuda.synchronize(self.mesh.device)
            if self.opened_mem is not None:
                _build.check(lib.dsp_ring_close(self.opened_mem), "cudaIpcCloseMemHandle")
            for ev in self.opened_events:
                _build.check(lib.dsp_ring_event_destroy(ev), "ring event destroy")
            self.opened_mem, self.opened_events = None, []

    def free(self) -> None:
        lib = _build.library()
        with torch.cuda.device(self.mesh.device):
            for ev in self.sent + self.consumed:
                _build.check(lib.dsp_ring_event_destroy(ev), "ring event destroy")
            _build.check(lib.dsp_ring_free(self.base), "ring buffer cudaFree")


def _ring(mesh: Mesh, nbytes: int) -> _Ring:
    """The receive buffer of this key, made (collectively) at its first use."""
    ring = mesh.rings.get(nbytes)
    if ring is None:
        ring = mesh.rings[nbytes] = _Ring(nbytes, mesh)
    return ring


def release_rings(mesh: Mesh) -> None:
    """Close the neighbours' buffers and events, then free this rank's.

    Collective over the time axis: no rank frees a buffer while a neighbour
    still maps it.
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
    tensor is put into the right neighbour's receive buffer by the kernel
    and the received one copied out; a CPU tensor takes the ``ppermute``
    spelling.
    """
    if axis != TIME_AXIS:
        raise ValueError(f"the ring runs over the time axis {TIME_AXIS!r}, got {axis!r}")
    if not x_loc.is_contiguous():
        raise ValueError("x_loc must be contiguous")
    if not _on_cuda(x_loc):
        return shift_right(x_loc, mesh)
    _check_mesh(x_loc, mesh)
    _build.library()  # built at first use; raises if it cannot be
    with torch.cuda.device(x_loc.device):
        ring = _ring(mesh, x_loc.numel() * x_loc.element_size())
        slot, stream = ring.next_slot(), _stream(x_loc)
        ring.put(x_loc, slot, stream)
        ring_shift_right_shard.launches += 1
        host_barrier(mesh)
        ring.wait_sent(slot, stream)
        if mesh.t == 0:  # the ring wraps; the causal halo of rank 0 is zeros
            out = torch.zeros_like(x_loc)
        else:
            out = torch.empty_like(x_loc)
            src = _device_view(ring.received(slot), ring.nbytes, x_loc.device)
            out.view(torch.uint8).view(-1).copy_(src)
        ring.consumed_by(slot, stream)
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
    """B7's launch geometry for a shard of ``n`` samples: (B1's geometry, head
    tiles, tiles). The windows of tiles ``[0, head)`` reach before the shard
    (the received halo); those of tiles ``[head, tiles)``, and the H samples
    a span starting there scans first, lie inside it."""
    g = windowed_geometry(window, channels, tile_samples)
    tiles = g.tiles(n)
    return g, min(tiles, cdiv(window * channels, g.tile_samples)), tiles


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
    if not windowed_supported(window, channels, tile_samples):
        raise ValueError(
            f"window*channels = {halo} is outside the windowed kernel's envelope; "
            "use sharded_moving_average, which takes the scan method there"
        )
    tail = xs[n - halo :]
    if not _on_cuda(xs):
        return windowed_averager(xs, window, channels, seed=shift_right(tail, mesh),
                                 tile_samples=tile_samples)
    _check_mesh(xs, mesh)
    _, head, tiles = fused_ring_split(n, window, channels, tile_samples)
    y = torch.empty_like(xs)
    _build.library()  # a failed build raises before any CUDA call

    def launch(begin: int, end: int, seed: int | None) -> None:
        err = launch_windowed_range(xs, y, window, channels, seed, begin, end, stream)
        _build.check(err, "fused_ring_windowed_shard")

    with torch.cuda.device(xs.device):
        ring = _ring(mesh, halo * xs.element_size())
        slot = ring.next_slot()
        compute = torch.cuda.current_stream(xs.device)
        stream = compute.cuda_stream
        ring.side.wait_stream(compute)  # xs is ready
        ring.put(tail, slot, ring.side.cuda_stream)
        if head < tiles:
            launch(head, tiles, None)  # interior: the window lies inside the shard
        host_barrier(mesh)
        ring.wait_sent(slot, stream)
        compute.wait_stream(ring.side)  # later work on xs follows the put
        launch(0, head, ring.received(slot) if mesh.t > 0 else None)  # head >= 1: halo >= 1
        ring.consumed_by(slot, stream)
    fused_ring_windowed_shard.launches += 1
    return y


fused_ring_windowed_shard.launches = 0


__all__ = [
    "fused_ring_split",
    "ring_shift_right_shard",
    "ring_shift_right",
    "fused_ring_windowed_shard",
    "release_rings",
]
