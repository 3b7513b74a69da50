"""Process-group mesh, sharding helpers and the collectives of the sharded path.

Counterpart of ``digital_signal_processsing_tpu/parallel/mesh.py``. JAX
names a mesh of devices and runs one program over a global array
(``shard_map``); PyTorch runs one process a rank, so here every function of
the sharded path takes this rank's shard and a :class:`Mesh` and returns
this rank's output shard. Axis conventions are the reference's:

- ``"t"``: time, contiguous time blocks of the stream; scan carries and
  halos move along it, one rank to the next;
- ``"ch"``: channels, independent streams with no communication.

Ranks are laid out (channel, time), ``rank = ch * n_time + t``, as the
reference reshapes its devices to ``(n_channel, n_time)``. Every rank
creates every subgroup, in the same order, with ``dist.new_group``.

The data groups use the default group's backend: NCCL when every rank has
its own card, gloo for CPU tensors. A gloo group moving CUDA tensors stages
them through host memory. Host handshakes (barriers, exchanging IPC
handles) always go through a gloo group over the time axis: on the one-card
ring of several processes the default backend is gloo and only coordinates
the hosts, while the halos move by the ring put kernel (``ring_pallas.py``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

TIME_AXIS = "t"
CHANNEL_AXIS = "ch"


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a (channel, time) grid of processes.

    ``time_group`` holds the ranks of this rank's channel row in time order,
    ``channel_group`` those of its time column in channel order; ``group``
    is the whole world. ``rings`` keeps the ring kernels' receive buffers
    by key (``ring_pallas.py``).
    """

    n_channel: int
    n_time: int
    ch: int
    t: int
    device: torch.device
    group: object
    time_group: object
    channel_group: object
    host_group: object
    time_ranks: tuple[int, ...]
    channel_ranks: tuple[int, ...]
    backend: str
    rings: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return {CHANNEL_AXIS: self.n_channel, TIME_AXIS: self.n_time}

    @property
    def rank(self) -> int:
        return self.ch * self.n_time + self.t

    def axis_size(self, axis: str) -> int:
        return self.shape[_check_axis(axis)]

    def axis_index(self, axis: str) -> int:
        return self.t if _check_axis(axis) == TIME_AXIS else self.ch

    def axis_group(self, axis: str):
        return self.time_group if _check_axis(axis) == TIME_AXIS else self.channel_group

    def axis_ranks(self, axis: str) -> tuple[int, ...]:
        return self.time_ranks if _check_axis(axis) == TIME_AXIS else self.channel_ranks

    def close(self) -> None:
        """Release the ring kernels' buffers (collective over the time axis)."""
        from .ring_pallas import release_rings

        release_rings(self)


def _check_axis(axis: str) -> str:
    if axis not in (TIME_AXIS, CHANNEL_AXIS):
        raise ValueError(f"unknown mesh axis {axis!r}; options {TIME_AXIS!r}, {CHANNEL_AXIS!r}")
    return axis


def make_mesh(n_time: int | None = None, n_channel: int = 1, *, device="cuda") -> Mesh:
    """1-D or 2-D mesh, (channel, time), over the initialised process group.

    Defaults to every rank on the time axis. ``device`` is where this
    rank's shards live: the card unless the caller asks for the CPU (an
    index-less ``"cuda"`` takes the current card).
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialised; call initialize_multihost() or "
            "dist.init_process_group() first"
        )
    world = dist.get_world_size()
    if n_time is None:
        n_time = world // n_channel
    if n_time < 1 or n_channel < 1 or n_time * n_channel != world:
        raise ValueError(f"mesh {n_channel}x{n_time} != {world} ranks")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = dist.get_backend()
    rank = dist.get_rank()
    ch, t = divmod(rank, n_time)
    rows = [tuple(c * n_time + i for i in range(n_time)) for c in range(n_channel)]
    cols = [tuple(c * n_time + i for c in range(n_channel)) for i in range(n_time)]
    time_groups = [dist.new_group(list(r)) for r in rows]
    channel_groups = [dist.new_group(list(c)) for c in cols]
    if backend == "gloo":
        host_groups = time_groups
    else:
        host_groups = [dist.new_group(list(r), backend="gloo") for r in rows]
    mesh = Mesh(
        n_channel=n_channel, n_time=n_time, ch=ch, t=t, device=dev, group=dist.group.WORLD,
        time_group=time_groups[ch], channel_group=channel_groups[t],
        host_group=host_groups[ch], time_ranks=rows[ch], channel_ranks=cols[t],
        backend=backend,
    )
    if backend == "nccl":
        # NCCL wants every rank of a group in its first call; later calls may
        # leave ranks out (the first and last rank of a shift)
        for g in (mesh.time_group, mesh.channel_group):
            dist.all_reduce(torch.zeros(1, device=dev), group=g)
    return mesh


def make_time_mesh(*, device="cuda") -> Mesh:
    """1-D mesh with only the time axis: every rank in one ring.

    The reference needs it for its ring kernels (Pallas remote copies take
    one named axis); the port's ring kernels run over the time axis of any
    mesh, so this is ``make_mesh()``.
    """
    return make_mesh(device=device)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a global tensor is cut into this rank's shard, and put back. Made
    by :func:`time_sharding`, :func:`planar_sharding` or :func:`batch_sharding`,
    whose ``kind`` is:

    - ``"time"``: the last axis over ``t`` (a flat stream, replicated over
      ``ch``): the reference's ``P("t")``;
    - ``"planar"``: a (channels, time) tensor with channels over ``ch`` and
      time over ``t``: ``P("ch", "t")``;
    - ``"batch"``: the leading (batch) axis over ``ch``, replicated over
      ``t``: ``P("ch")``. A batch that ``n_channel`` does not divide is
      refused, as ``jax.device_put`` refuses an uneven ``NamedSharding``.
    """

    mesh: Mesh
    kind: str

    def shard(self, x) -> torch.Tensor:
        """This rank's contiguous shard of the global ``x`` (a tensor or an array),
        where ``x`` is."""
        m = self.mesh
        x = torch.as_tensor(x)
        if self.kind == "batch":
            if x.dim() < 1 or x.shape[0] % m.n_channel:
                raise ValueError(
                    f"batch sharding needs a leading axis divisible by {m.n_channel} "
                    f"(the ch axis), got shape {tuple(x.shape)}"
                )
            b = x.shape[0] // m.n_channel
            return x[m.ch * b : (m.ch + 1) * b].contiguous()
        t = x.shape[-1]
        if t % m.n_time:
            raise ValueError(f"time length {t} not divisible by {m.n_time} shards")
        tl = t // m.n_time
        x = x[..., m.t * tl : (m.t + 1) * tl]
        if self.kind == "planar":
            if x.dim() != 2 or x.shape[0] % m.n_channel:
                raise ValueError(
                    f"planar sharding needs (channels, time) with channels divisible by "
                    f"{m.n_channel}, got shape {tuple(x.shape)}"
                )
            cl = x.shape[0] // m.n_channel
            x = x[m.ch * cl : (m.ch + 1) * cl]
        return x.contiguous()

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """The global tensor from every rank's shard (on every rank)."""
        m = self.mesh
        if self.kind != "batch":
            y = torch.cat(all_gather(y, m, TIME_AXIS), dim=-1)
        if self.kind != "time":
            y = torch.cat(all_gather(y, m, CHANNEL_AXIS), dim=0)
        return y


def time_sharding(mesh: Mesh) -> Sharding:
    """Flat stream sharded into contiguous time blocks."""
    return Sharding(mesh, "time")


def planar_sharding(mesh: Mesh) -> Sharding:
    """(channels, time) planar signal: channels over ch, time over t."""
    return Sharding(mesh, "planar")


def batch_sharding(mesh: Mesh) -> Sharding:
    """A batch of independent items (CPIs, snapshot blocks, streams): the
    leading axis over ch, every rank of a channel row holding the same share."""
    return Sharding(mesh, "batch")


def check_mesh(mesh) -> Mesh:
    """``mesh`` if it is a :class:`Mesh`, else TypeError."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh (make_mesh()), got {type(mesh).__name__}")
    return mesh


def _wire(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` as the data groups' backend moves it: real, contiguous and, for
    gloo, on the host, with int16 and bool as their bytes (gloo has neither)."""
    if x.is_complex():
        x = torch.view_as_real(x)
    x = x.contiguous()
    if mesh.backend == "gloo":
        x = x.cpu()
        if x.dtype in (torch.int16, torch.bool):
            x = x.view(torch.uint8)
    return x


def _unwire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype in (torch.int16, torch.bool) and w.dtype != like.dtype:
        w = w.view(like.dtype)
    if like.is_complex():
        w = torch.view_as_complex(w)
    return w.to(like.device)


def shift_right(x: torch.Tensor, mesh: Mesh, axis: str = TIME_AXIS, stride: int = 1) -> torch.Tensor:
    """Receive the tensor of the rank ``stride`` places left on ``axis``.

    The first ``stride`` ranks receive zeros: the reference's ``ppermute``
    with ``perm=[(i, i + stride)]``, one send and one receive a rank
    (``dist.batch_isend_irecv``). Every rank passes a tensor of one shape.
    """
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    ranks, group = mesh.axis_ranks(axis), mesh.axis_group(axis)
    buf = _wire(x, mesh)
    out = torch.zeros_like(buf)
    ops = []
    if i + stride < n:
        ops.append(dist.P2POp(dist.isend, buf, ranks[i + stride], group))
    if i - stride >= 0:
        ops.append(dist.P2POp(dist.irecv, out, ranks[i - stride], group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return _unwire(out, x)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str = TIME_AXIS) -> list[torch.Tensor]:
    """Every rank's ``x`` along ``axis``, in axis order."""
    if mesh.axis_size(axis) == 1:
        return [x]
    buf = _wire(x, mesh)
    parts = [torch.empty_like(buf) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, buf, group=mesh.axis_group(axis))
    return [_unwire(p, x) for p in parts]


def psum(x: torch.Tensor, mesh: Mesh, axis: str = TIME_AXIS) -> torch.Tensor:
    """Sum of every rank's ``x`` along ``axis``, on every rank."""
    if mesh.axis_size(axis) == 1:
        return x
    buf = _wire(x, mesh).clone()
    dist.all_reduce(buf, group=mesh.axis_group(axis))
    return _unwire(buf, x)


def world_max(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Elementwise maximum of every rank's ``x`` over the whole mesh, on every rank."""
    if mesh.n_time * mesh.n_channel == 1:
        return x
    buf = _wire(x, mesh).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=mesh.group)
    return _unwire(buf, x)


def host_barrier(mesh: Mesh) -> None:
    """Every rank of the time axis has reached this point (host side only)."""
    if mesh.n_time > 1:
        dist.barrier(group=mesh.host_group)


class HostSteps:
    """Counts, while entered, the host steps a ring call could take: barriers,
    object gathers and device synchronisations (``dist.barrier``,
    ``dist.all_gather_object``, ``torch.cuda.synchronize``). The ring's
    tests and ``chip_smoke.py`` hold its calls after a key's first to zero."""

    PATCHED = ((dist, "barrier"), (dist, "all_gather_object"), (torch.cuda, "synchronize"))

    def __enter__(self):
        self.counts = {name: 0 for _, name in self.PATCHED}
        self._saved = [(mod, name, getattr(mod, name)) for mod, name in self.PATCHED]
        for mod, name, fn in self._saved:
            setattr(mod, name, self._counting(name, fn))
        return self

    def _counting(self, name, fn):
        def counted(*a, **k):
            self.counts[name] += 1
            return fn(*a, **k)

        return counted

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


__all__ = [
    "TIME_AXIS",
    "CHANNEL_AXIS",
    "Mesh",
    "Sharding",
    "make_mesh",
    "make_time_mesh",
    "time_sharding",
    "planar_sharding",
    "batch_sharding",
    "check_mesh",
    "shift_right",
    "all_gather",
    "psum",
    "world_max",
    "host_barrier",
    "HostSteps",
]
