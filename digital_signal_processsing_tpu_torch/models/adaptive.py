"""Adaptive filters: the block-LMS trainer, its sharded step, NLMS and RLS, and the
frequency-tracking notch.

Counterpart of ``digital_signal_processsing_tpu/models/adaptive.py``.

**The block-LMS trainer** learns FIR taps theta minimising
``mean((fir(x, theta) - d)^2)`` by gradient descent: ``AdaptiveFir`` holds the
taps (an ``nn.Parameter``, float32, zeros) and a ``torch.optim.Adam`` with
optax's ``adam`` defaults (b1 0.9, b2 0.999, eps 1e-8). ``_lms_step_body`` is
the one update rule of the single step (:func:`lms_train_step`) and of the
sharded one (:func:`make_sharded_train_step`: streams over the mesh's ``ch``
axis, time over ``t``, a ``k-1``-sample halo from the left time neighbour,
loss and gradient summed over both axes). The FIR is ``conv1d`` under IEEE
float32 and cuDNN's deterministic algorithms, forward and backward, so a step
gives the same bits every time (a resumed run continues bit for bit).
:func:`opt_state_from_optax` carries a JAX run's optimizer state over.

**NLMS and RLS** (:func:`nlms`, :func:`rls`) adapt a sample at a time, the
leading axes independent streams. On the card each is one launch of a kernel
of ``csrc/adaptive.cu`` (S1 ``nlms_block_kernel``, one CTA a stream running
the exact block recursion, :func:`nlms_geometry`; S2 by :func:`rls_geometry`):
the reference runs them as one ``lax.scan``, which eager PyTorch would spell
as about ten launches a sample.
On the CPU the wrappers take their plain versions, per-sample loops in the
reference's order of operations.

**The notch** adapts a frame at a time: each frame's dominant tone comes from
a Hann-windowed ``rfft`` peak refined by parabolic interpolation, a notch row
is designed for it, and the rows run through ``sosfilt_tv_frames`` (B18 on
the card). Tracking latency is one frame; once locked the rejection matches a
sample-by-sample loop.

Entry points given NumPy arrays put them on ``device`` (the card unless the
caller passes ``device="cpu"``); tensors stay where they are.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..ops import iir
from ..ops.fft import rfft, spectral_window
from ..ops.fir import ieee_fp32_conv
from ..ops.pallas_scan import SMEM_MAX, _on_cuda, _stream
from ..parallel.mesh import CHANNEL_AXIS, TIME_AXIS, Mesh, planar_sharding, psum, shift_right
from ..utils.device import as_tensor, resolve_device
from ..utils.dispatch import refuse_grad
from ..utils.layout import overlapping_frames


def estimate_tone_frequency(x: torch.Tensor, frame_len: int, *,
                            nfft: int | None = None) -> torch.Tensor:
    """Per-frame dominant-tone frequency in Nyquist units, ``(..., F)`` float32.

    Hann-windowed ``rfft`` magnitude peak (DC and Nyquist excluded), refined
    by parabolic interpolation on the log magnitude.
    """
    if nfft is None:
        nfft = frame_len
    nframes = max(0, x.shape[-1] // frame_len)
    fr = overlapping_frames(x.to(torch.float32), nframes, frame_len, frame_len)
    w = torch.from_numpy(spectral_window("hann", frame_len)).to(x.device)
    spec = torch.abs(rfft(fr * w, n=nfft, axis=-1))
    k = torch.argmax(spec[..., 1:-1], dim=-1) + 1
    logm = torch.log(torch.clamp(spec, min=1e-20))
    km1 = torch.gather(logm, -1, (k - 1)[..., None])[..., 0]
    k0 = torch.gather(logm, -1, k[..., None])[..., 0]
    kp1 = torch.gather(logm, -1, (k + 1)[..., None])[..., 0]
    denom = km1 - 2.0 * k0 + kp1
    safe = torch.where(torch.abs(denom) > 1e-12, denom, torch.ones_like(denom))
    delta = torch.where(torch.abs(denom) > 1e-12, 0.5 * (km1 - kp1) / safe, torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)
    return (k.to(torch.float32) + delta) * (2.0 / nfft)


def notch_rows(w0: torch.Tensor, q: float) -> torch.Tensor:
    """scipy-layout notch rows ``(..., 6)``, one a frequency of ``w0`` (Nyquist
    units), -3 dB bandwidth ``w0 / q`` (scipy's ``iirnotch``)."""
    om = np.pi * w0.to(torch.float32)
    gain = 1.0 / (1.0 + torch.tan(om / (2.0 * q)))
    c = torch.cos(om)
    one = torch.ones_like(gain)
    return torch.stack(
        [gain, -2.0 * gain * c, gain, one, -2.0 * gain * c, 2.0 * gain - 1.0], -1
    )


def tracking_notch(x: torch.Tensor, frame_len: int, *,
                   q: float = 30.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Remove a frequency-wandering narrowband interferer: ``(cleaned, freqs)``.

    Estimates the dominant tone of each ``frame_len`` block and applies that
    frame's notch through the time-varying SOS kernel (B18 inside the
    reference's frames envelope). ``freqs``: the per-frame estimates in
    Nyquist units. The tail past the last whole frame takes the last frame's
    notch.
    """
    n = x.shape[-1]
    nf = n // frame_len
    if nf == 0:
        raise ValueError(f"signal shorter than one frame ({n} < {frame_len})")
    w0 = estimate_tone_frequency(x[..., : nf * frame_len], frame_len)
    rows = notch_rows(w0, q)  # (..., F, 6)
    pad_frames = -(-n // frame_len) - nf
    if pad_frames:
        rows = torch.cat([rows, rows[..., -1:, :].expand(rows.shape[:-2] + (pad_frames, 6))], -2)
    return iir.sosfilt_tv_frames(rows[None], x, frame_len), w0




# --- the block-LMS trainer ------------------------------------------------------


@contextlib.contextmanager
def _conv_pins():
    """IEEE float32 and cuDNN's deterministic algorithms for the FIR's ``conv1d``,
    forward and backward (both read the settings when they run). Restored on exit."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        with ieee_fp32_conv():
            yield
    finally:
        cudnn.deterministic = saved


def _fir_batched(x: torch.Tensor, taps: torch.Tensor, *, halo: torch.Tensor | None = None):
    """Causal FIR of (streams, time): ``conv1d`` with the taps reversed over ``k-1``
    samples in front (zeros, or ``halo``: the stream's samples before this block)."""
    k = taps.shape[0]
    if halo is None:
        halo = x.new_zeros(x.shape[0], k - 1)
    ext = torch.cat([halo, x], dim=-1)
    with _conv_pins():
        return F.conv1d(ext[:, None, :], taps.flip(0)[None, None, :])[:, 0, :]


def lms_loss(taps: torch.Tensor, x: torch.Tensor, d: torch.Tensor, *,
             halo: torch.Tensor | None = None, count: int | None = None) -> torch.Tensor:
    """``mean((fir(x, taps) - d)^2)``, spelled as the sum over ``count`` samples
    (``x``'s by default; the sharded step gives the global count and its halo)."""
    err = _fir_batched(x, taps, halo=halo) - d
    return (err * err).sum() / (x.numel() if count is None else count)


class AdamState(NamedTuple):
    """Adam's state of the taps: optax's ``ScaleByAdamState(count, mu, nu)``."""

    step: torch.Tensor  # () float32, on the host (torch.optim.Adam's step)
    exp_avg: torch.Tensor  # (k,) the first moment, on the taps' device
    exp_avg_sq: torch.Tensor  # (k,) the second moment


class AdaptiveFir(torch.nn.Module):
    """Learnable causal FIR taps (float32, zeros at first) and their Adam optimizer
    (``torch.optim.Adam(lr)``: optax's ``adam`` defaults, the same update)."""

    def __init__(self, num_taps: int, learning_rate: float = 1e-2, *, device="cuda"):
        super().__init__()
        if num_taps < 1:
            raise ValueError(f"num_taps must be >= 1, got {num_taps}")
        dev = resolve_device(device)
        self.taps = torch.nn.Parameter(torch.zeros(num_taps, dtype=torch.float32, device=dev))
        self.opt = torch.optim.Adam([self.taps], lr=learning_rate)

    @staticmethod
    def create(num_taps: int, learning_rate: float = 1e-2, *, device="cuda") -> "AdaptiveFir":
        return AdaptiveFir(num_taps, learning_rate, device=device)

    def opt_state(self) -> AdamState:
        """A copy of the optimizer's state (zeros before the first step)."""
        st = self.opt.state.get(self.taps)
        if not st:
            z = torch.zeros_like(self.taps)
            return AdamState(torch.zeros((), dtype=torch.float32), z, z.clone())
        return AdamState(*(st[k].detach().clone() for k in AdamState._fields))

    def restore(self, taps, opt_state: AdamState) -> None:
        """Set the taps and the optimizer's state (from a checkpoint or another run)."""
        step, m, v = opt_state
        shape = self.taps.shape
        taps = torch.as_tensor(taps)
        if taps.shape != shape or m.shape != shape or v.shape != shape:
            raise ValueError(f"taps and moments must be {tuple(shape)}, got {tuple(taps.shape)}, "
                             f"{tuple(m.shape)}, {tuple(v.shape)}")
        with torch.no_grad():
            self.taps.copy_(taps)
        dev = self.taps.device
        self.opt.state[self.taps] = {
            "step": torch.as_tensor(step, dtype=torch.float32).detach().cpu().clone(),
            "exp_avg": m.detach().to(dev, torch.float32).clone(),
            "exp_avg_sq": v.detach().to(dev, torch.float32).clone(),
        }


def _lms_step_body(fir: AdaptiveFir, x: torch.Tensor, d: torch.Tensor, *,
                   halo: torch.Tensor | None = None, count: int | None = None,
                   reduce=None) -> torch.Tensor:
    """The one update rule of the single and the sharded step: the squared error
    summed over ``count`` samples (``x``'s by default), its gradient, ``reduce``
    (the sharded step's sum over the mesh) on both, then Adam. Returns the loss."""
    fir.opt.zero_grad(set_to_none=True)
    with _conv_pins():
        loss = lms_loss(fir.taps, x, d, halo=halo, count=count)
        loss.backward()
    loss = loss.detach()
    if reduce is not None:
        both = reduce(torch.cat([fir.taps.grad, loss[None]]))
        fir.taps.grad.copy_(both[:-1])
        loss = both[-1]
    fir.opt.step()
    return loss


def lms_train_step(fir: AdaptiveFir, x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """One block-LMS step on (streams, time) float32 batches; returns the loss
    (a tensor: reading it is the caller's host sync)."""
    return _lms_step_body(fir, x, d)


def make_sharded_train_step(mesh: Mesh):
    """Train step with streams over the mesh's ``ch`` axis and time over ``t``.

    Returns ``step(fir, xs, ds) -> loss`` for this rank's (ch, t) shard of the
    batch (every rank's shard of one shape, as ``planar_sharding(mesh)`` cuts
    it; ``step.sharding`` is that sharding). Each rank receives the last
    ``k-1`` samples of its left time neighbour's shard (zeros on the first),
    sums its squared error over the global count, and the loss and gradient are
    summed over both axes: Adam then steps identically on every rank, taps and
    optimizer state replicated.
    """

    def reduce(v: torch.Tensor) -> torch.Tensor:
        return psum(psum(v, mesh, CHANNEL_AXIS), mesh, TIME_AXIS)

    def step(fir: AdaptiveFir, xs: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
        k = fir.taps.shape[0]
        if xs.dim() != 2 or ds.shape != xs.shape or xs.shape[-1] < k - 1:
            raise ValueError(f"shards must be (streams, time) of one shape with time >= {k - 1}, "
                             f"got {tuple(xs.shape)} and {tuple(ds.shape)}")
        halo = None
        if k > 1:
            halo = shift_right(xs[:, xs.shape[-1] - (k - 1):].contiguous(), mesh, TIME_AXIS)
        count = xs.numel() * mesh.n_channel * mesh.n_time
        return _lms_step_body(fir, xs, ds, halo=halo, count=count, reduce=reduce)

    step.sharding = planar_sharding(mesh)
    return step


def identify_system(
    true_taps: np.ndarray,
    *,
    num_taps: int | None = None,
    steps: int = 200,
    batch: tuple[int, int] = (8, 4096),
    lr: float = 5e-2,
    seed: int = 0,
    train_step=None,
    device="cuda",
) -> tuple[np.ndarray, float]:
    """Fit taps to an unknown FIR from input/output pairs: ``(taps, final loss)``.

    The batches are the reference's, in its order: ``rng.normal(size=batch)``
    each step from ``default_rng(seed)``, as float32, through the true FIR.
    ``train_step(fir, x, d) -> loss`` replaces :func:`lms_train_step`; a step
    from :func:`make_sharded_train_step` is given this rank's shard. The loss
    is read back once, after the last step. (The reference's ``tx`` has no
    counterpart: the optimizer is ``torch.optim.Adam(lr)``.)
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    true_taps = np.asarray(true_taps, np.float32)
    fir = AdaptiveFir.create(num_taps or true_taps.shape[0], lr, device=dev)
    ht = torch.from_numpy(true_taps).to(dev)
    sharding = getattr(train_step, "sharding", None)
    loss = None
    for _ in range(steps):
        x = torch.from_numpy(rng.normal(size=batch).astype(np.float32)).to(dev)
        with torch.no_grad():
            d = _fir_batched(x, ht)
        if train_step is None:
            loss = lms_train_step(fir, x, d)
        else:
            if sharding is not None:
                x, d = sharding.shard(x), sharding.shard(d)
            loss = train_step(fir, x, d)
    return fir.taps.detach().cpu().numpy(), (np.inf if loss is None else float(loss))


def _adam_leaf(opt_state):
    """The ``ScaleByAdamState`` (count, mu, nu) inside an optax state tuple."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _adam_leaf(part)
            if found is not None:
                return found
    return None


def opt_state_from_optax(opt_state, taps, learning_rate: float = 1e-2, *,
                         device="cuda") -> AdaptiveFir:
    """An :class:`AdaptiveFir` that continues a run of the reference package.

    ``taps`` and ``opt_state`` are the reference's (``optax.adam`` state, its
    leaves as arrays): ``count`` becomes Adam's ``step``, ``mu`` its
    ``exp_avg``, ``nu`` its ``exp_avg_sq``.
    """
    adam = _adam_leaf(opt_state)
    if adam is None:
        raise ValueError("opt_state holds no ScaleByAdamState (count, mu, nu): not optax.adam's")
    taps = np.array(taps, np.float32)
    fir = AdaptiveFir.create(taps.shape[0], learning_rate, device=device)
    fir.restore(torch.from_numpy(taps), AdamState(
        torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32),
        torch.from_numpy(np.array(adam.mu, np.float32)),
        torch.from_numpy(np.array(adam.nu, np.float32)),
    ))
    return fir


# --- the sample-recursive filters: S1 (NLMS) and S2 (RLS) -------------------------

NLMS_BLOCK = 16  # S1's block length L (csrc/adaptive.cu kNlmsBlock)
NLMS_THREADS = 416  # S1's CTA: the chain warp, group A's 4 warps, group B's 8
RLS_CHUNK = 256  # samples S2's block route stages a chunk (csrc/adaptive.cu kRlsChunk)
RLS_WARP_TAPS = 32  # S2's warp route: a lane a row of P, up to 32 taps
RLS_WARP_STREAMS = 4  # most streams (warps) a block of the warp route
RLS_MAX_WARPS = 32  # the block route's warps a block
RLS_SMS = 132  # the H100's SMs, over which the warp route spreads its blocks
RLS_ROUTES = ("warp", "block, triangle in shared memory", "block, triangle in device memory")


@dataclasses.dataclass(frozen=True)
class RlsGeometry:
    """S2's launch for ``p`` taps over ``streams`` streams: the route (0 the
    warp, 1 the block), warps a block (streams a block on the warp route), the
    block route's x ring (a power of two of at least p - 1 + RLS_CHUNK), whether
    its packed triangle of P sits in shared memory, and the dynamic shared bytes."""

    route: int
    warps: int
    ring: int
    shared_tri: bool
    smem_bytes: int

    @property
    def name(self) -> str:
        return RLS_ROUTES[0 if self.route == 0 else 1 if self.shared_tri else 2]

    @property
    def threads(self) -> int:
        return 32 * self.warps


def rls_geometry(p: int, streams: int = 1, sms: int = RLS_SMS) -> RlsGeometry:
    """S2's geometry; raises where even the block route's staging buffers exceed
    shared memory."""
    if p < 1:
        raise ValueError(f"num_taps must be >= 1, got {p}")
    if p <= RLS_WARP_TAPS:
        return RlsGeometry(0, max(1, min(RLS_WARP_STREAMS, -(-streams // sms))), 0, False, 0)
    ring = 1 << (p - 1 + RLS_CHUNK - 1).bit_length()
    vectors = ring + 3 * RLS_CHUNK + 3 * p  # x ring; d, y, e stages; pu, k, w
    tri = p * (p + 1) // 2
    shared_tri = 4 * (tri + vectors) <= SMEM_MAX
    smem = 4 * ((tri if shared_tri else 0) + vectors)
    if smem > SMEM_MAX:
        raise ValueError(f"rls: {p} taps need {smem} bytes of shared memory beside P, "
                         f"more than {SMEM_MAX}")
    return RlsGeometry(1, min(RLS_MAX_WARPS, -(-p // 4)), ring, shared_tri, smem)


# the most taps whose packed triangle of P fits in shared memory beside S2's buffers
RLS_SHARED_MAX_TAPS = max(p for p in range(RLS_WARP_TAPS + 1, 1024) if rls_geometry(p).shared_tri)


@dataclasses.dataclass(frozen=True)
class NlmsGeometry:
    """S1's launch for ``taps`` taps over ``ctas`` streams, one CTA of
    ``NLMS_THREADS`` a stream: the ring of x (a power of two of at least
    taps + 5 NLMS_BLOCK, mirrored: 2 ring floats), whether the ring and the
    taps sit in shared memory beside the correlation tables (else a
    device-memory scratch of 2 ring + taps floats a stream), and the dynamic
    shared bytes."""

    ring: int
    shared: bool
    smem_bytes: int
    ctas: int
    taps: int

    @property
    def scratch_floats(self) -> int:
        """Device-memory floats a stream: 0 when everything sits in shared memory."""
        return 0 if self.shared else 2 * self.ring + self.taps


def nlms_geometry(p: int, streams: int = 1) -> NlmsGeometry:
    """S1's geometry: three correlation tables of 2 L^2 floats (L =
    ``NLMS_BLOCK``), d, 1 / nu and nu thrice, W u and g twice, then the mirrored
    ring and the taps while they fit. Refuses only what no launch can take: no
    taps, more CTAs than a grid."""
    if p < 1:
        raise ValueError(f"num_taps must be >= 1, got {p}")
    if not 1 <= streams <= 2**31 - 1:
        raise ValueError(f"nlms: {streams} streams; a launch takes 1 to 2^31 - 1")
    block = NLMS_BLOCK
    tables = 6 * block * block + 13 * block
    ring = 1 << (p + 5 * block - 1).bit_length()
    shared = 4 * (tables + 2 * ring + p) <= SMEM_MAX
    return NlmsGeometry(ring, shared, 4 * (tables + (2 * ring + p if shared else 0)), streams, p)


# the most taps S1 keeps in shared memory beside its tables
NLMS_SHARED_MAX_TAPS = max(p for p in range(1, 1 << 15) if nlms_geometry(p).shared)


def _stacked(rows: list, like: torch.Tensor) -> torch.Tensor:
    """Per-sample (streams,) outputs as (streams, n)."""
    return torch.stack(rows, dim=1) if rows else torch.empty_like(like)


def _nlms_plain(xb: torch.Tensor, db: torch.Tensor, p: int, step: float, eps: float):
    """S1's plain version: the reference's per-sample loop, in its order of operations."""
    b, n = xb.shape
    w = xb.new_zeros(b, p)
    u = xb.new_zeros(b, p)
    ys, es = [], []
    for t in range(n):
        u = torch.cat([xb[:, t : t + 1], u[:, :-1]], dim=1)
        y = torch.sum(w * u, dim=1)
        e = db[:, t] - y
        norm = eps + torch.sum(u * u, dim=1)
        w = w + step * (e / norm)[:, None] * u
        ys.append(y)
        es.append(e)
    return _stacked(ys, xb), _stacked(es, xb), w


def _rls_plain(xb: torch.Tensor, db: torch.Tensor, p: int, forget: float, delta: float):
    """S2's plain version: the reference's per-sample loop, in its order of operations."""
    b, n = xb.shape
    w = xb.new_zeros(b, p)
    u = xb.new_zeros(b, p)
    P = (delta * torch.eye(p, dtype=torch.float32, device=xb.device)).expand(b, p, p).clone()
    ys, es = [], []
    for t in range(n):
        u = torch.cat([xb[:, t : t + 1], u[:, :-1]], dim=1)
        pu = torch.einsum("bij,bj->bi", P, u)
        denom = forget + torch.einsum("bi,bi->b", u, pu)
        k = pu / denom[:, None]
        y = torch.sum(w * u, dim=1)
        e = db[:, t] - y
        w = w + k * e[:, None]
        P = (P - torch.einsum("bi,bj->bij", k, pu)) / forget
        P = 0.5 * (P + P.transpose(-1, -2))  # re-symmetrised: float32 P drifts otherwise
        ys.append(y)
        es.append(e)
    return _stacked(ys, xb), _stacked(es, xb), w


def _check_streams(xb: torch.Tensor, db: torch.Tensor, p: int, what: str) -> None:
    if xb.dim() != 2 or db.shape != xb.shape or xb.device != db.device:
        raise ValueError(f"{what}: x and d must be (streams, n) of one shape on one device, got "
                         f"{tuple(xb.shape)} on {xb.device} and {tuple(db.shape)} on {db.device}")
    if p < 1:
        raise ValueError(f"{what}: num_taps must be >= 1, got {p}")


def _outputs(xb: torch.Tensor, p: int):
    b = xb.shape[0]
    return torch.empty_like(xb), torch.empty_like(xb), xb.new_empty(b, p)


def nlms_scan(xb: torch.Tensor, db: torch.Tensor, p: int, step: float = 0.5, eps: float = 1e-6):
    """NLMS over (streams, n) float32 by S1: ``(y, e, w)``, w (streams, p).

    A CPU tensor takes the plain per-sample loop; a CUDA tensor one launch of
    S1 (``csrc/adaptive.cu``), counted in ``launches``, or raises: one CTA a
    stream, its ring of x and the taps in shared memory up to
    ``NLMS_SHARED_MAX_TAPS`` taps and in a device-memory scratch past that.
    """
    _check_streams(xb, db, p, "nlms_scan")
    xb, db = xb.to(torch.float32).contiguous(), db.to(torch.float32).contiguous()
    if not _on_cuda(xb):
        return _nlms_plain(xb, db, p, step, eps)
    refuse_grad("nlms_scan (S1)", xb, db)
    y, e, w = _outputs(xb, p)
    b, n = xb.shape
    if b == 0:
        return y, e, w
    g = nlms_geometry(p, b)
    scratch = xb.new_empty(b, g.scratch_floats) if g.scratch_floats else None
    lib = _build.library()
    with torch.cuda.device(xb.device):
        err = lib.dsp_nlms(
            xb.data_ptr(), db.data_ptr(), y.data_ptr(), e.data_ptr(), w.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, n, p, g.ring, int(g.shared),
            g.smem_bytes, float(np.float32(step)), float(np.float32(eps)),
            _stream(xb),
        )
    _build.check(err, "nlms_scan")
    nlms_scan.launches += 1
    return y, e, w


nlms_scan.launches = 0


def rls_scan(xb: torch.Tensor, db: torch.Tensor, p: int, forget: float = 0.99,
             delta: float = 1e2):
    """RLS over (streams, n) float32 by S2: ``(y, e, w)``, w (streams, p).

    A CPU tensor takes the plain per-sample loop; a CUDA tensor one launch of
    S2 (``csrc/adaptive.cu``), counted in ``launches``, or raises: a warp a
    stream up to ``RLS_WARP_TAPS`` taps, else a block a stream with P's packed
    upper triangle in shared memory up to ``RLS_SHARED_MAX_TAPS`` taps and in a
    device-memory scratch of p (p + 1) / 2 floats a stream past that.
    """
    _check_streams(xb, db, p, "rls_scan")
    xb, db = xb.to(torch.float32).contiguous(), db.to(torch.float32).contiguous()
    if not _on_cuda(xb):
        return _rls_plain(xb, db, p, forget, delta)
    refuse_grad("rls_scan (S2)", xb, db)
    y, e, w = _outputs(xb, p)
    b, n = xb.shape
    if b == 0:
        return y, e, w
    lib = _build.library()
    g = rls_geometry(p, b, torch.cuda.get_device_properties(xb.device).multi_processor_count)
    gp = xb.new_empty(b, p * (p + 1) // 2) if g.route == 1 and not g.shared_tri else None
    with torch.cuda.device(xb.device):
        err = lib.dsp_rls(
            xb.data_ptr(), db.data_ptr(), y.data_ptr(), e.data_ptr(), w.data_ptr(),
            None if gp is None else gp.data_ptr(), b, n, p, g.route, g.warps, g.ring,
            int(g.shared_tri), g.smem_bytes, float(np.float32(forget)),
            float(np.float32(delta)), _stream(xb),
        )
    _build.check(err, "rls_scan")
    rls_scan.launches += 1
    return y, e, w


rls_scan.launches = 0


def adaptive_kernel_attrs(kind: str, p: int) -> tuple:
    """What the compiler gave the instance of S1 (``kind="S1"``) or S2 that runs
    ``p`` taps (the card only): (registers a thread, local bytes a thread, static
    shared bytes, S1's block length, or S2's register slots a lane: its row of P
    on the warp route and its columns on the block route, 0 past 256 taps)."""
    out = (ctypes.c_int64 * 4)()
    code = (0 if nlms_geometry(p).shared else 2) if kind == "S1" else 1
    with torch.cuda.device(torch.cuda.current_device()):
        err = _build.library().dsp_adaptive_attrs(code, p, ctypes.addressof(out))
    _build.check(err, "adaptive_kernel_attrs")
    return tuple(out)


def _recursive(scan, x, d, num_taps: int, device, **kw):
    """Leading axes of ``x`` as streams through ``scan``; the reference's shapes back."""
    x = as_tensor(x, device)
    d = as_tensor(d, x.device)
    if x.dim() < 1 or d.shape != x.shape:
        raise ValueError(f"x and d must be (..., n) of one shape, got {tuple(x.shape)} and "
                         f"{tuple(d.shape)}")
    shape = x.shape
    streams = (int(np.prod(shape[:-1])), shape[-1])
    y, e, w = scan(x.reshape(streams), d.reshape(streams), num_taps, **kw)
    w = w.reshape(shape[:-1] + (num_taps,)) if x.dim() > 1 else w[0]
    return y.reshape(shape), e.reshape(shape), w


def nlms(x, d, num_taps: int, *, step: float = 0.5, eps: float = 1e-6, device="cuda"):
    """Normalized LMS: ``w += step * e * u / (eps + |u|^2)`` per sample.

    ``x``, ``d``: (..., n) input and desired streams, the leading axes
    independent filters. Returns ``(y, e, w)``: the filter output, the error
    stream and the final taps (..., p), float32. One launch of S1 on the card.
    """
    return _recursive(nlms_scan, x, d, num_taps, device, step=step, eps=eps)


def rls(x, d, num_taps: int, *, forget: float = 0.99, delta: float = 1e2, device="cuda"):
    """Recursive least squares with exponential forgetting (``P0 = delta * I``),
    re-symmetrising P every sample. Returns ``(y, e, w)`` as :func:`nlms` does.
    One launch of S2 on the card."""
    return _recursive(rls_scan, x, d, num_taps, device, forget=forget, delta=delta)


__all__ = [
    "estimate_tone_frequency",
    "notch_rows",
    "tracking_notch",
    "AdamState",
    "AdaptiveFir",
    "lms_loss",
    "lms_train_step",
    "make_sharded_train_step",
    "identify_system",
    "opt_state_from_optax",
    "nlms",
    "rls",
    "nlms_scan",
    "rls_scan",
    "nlms_geometry",
    "NLMS_SHARED_MAX_TAPS",
    "rls_geometry",
    "RLS_SHARED_MAX_TAPS",
    "adaptive_kernel_attrs",
]
