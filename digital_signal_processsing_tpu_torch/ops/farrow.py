"""Farrow arbitrary-rate resampling: cubic Lagrange fractional delay.

Counterpart of ``digital_signal_processsing_tpu/ops/farrow.py``. ``rate`` is
snapped once to a rational ``up/down``; output m sits at the exact integer
position ``(n, mu_num) = divmod(4*up + m*down, up)`` of ``ext = [0, 0, 0, 0,
x]`` and is the cubic Lagrange combination of ``ext[n-1 .. n+2]``. Layout:
planar ``(channels, time)`` float32 or ``(time,)``; ``y[0] = x[0]`` and
``y[m] ~ x(m / rate)``.

Routes of :func:`resample_farrow`, with the reference's names:

- ``matmul``: input frames of ``down`` samples (+ the stencil's spill)
  against the banded (down+8, up) phase matrix, one IEEE float32 matmul
  (the reference leaves this einsum to XLA, outside any Pallas kernel);
- ``segmented``: B21 (``csrc/farrow.cu``) through
  :func:`resample_farrow_segmented`, the exact schedule for any rate;
- ``gather``: the pointwise spelling in plain PyTorch over the int64
  schedule, the bit-exact partner of the streaming :func:`farrow_chunk`;
- ``auto``: ``matmul`` while up*down <= MATMUL_MAX_PRODUCT_CUDA on the
  card (0: B21 at every rate) or the reference's MATMUL_MAX_PRODUCT on the
  CPU, else ``segmented``.

The streaming pairs (``farrow_init``/``farrow_chunk`` and the matmul
spelling's ``farrow_matmul_*``) keep their carried phase as a Python int, so
no count ever waits on the card.
"""

from __future__ import annotations

import dataclasses
import functools
from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..utils.dispatch import record_choice, refuse_grad
from ..utils.device import resolve_device
from ..utils.layout import cdiv, overlapping_frames
from .fir import _as_planar, ieee_fp32_matmul
from .pallas_scan import _on_cuda, _stream

# Denominator cap for float -> rational snapping (the reference's): the worst
# timing error stays below 1/(2*2^32) sample a step.
MAX_DENOMINATOR = 1 << 16
# Phase-matrix (matmul) envelope: the (down+8, up) weight matrix of at most
# 2^22 entries (16 MB of float32).
MATMUL_MAX_PRODUCT = 1 << 22
# The same envelope on the card. The reference's keeps a TPU off its slow
# gathers. On an H100 (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase 5,
# 16 channels, PERF.md) B21 beat the matmul at every rate and length
# measured, by 4x or more: 5.2x at 160/147, 7.2x at 3/2 and 23x at 441/2560
# on 16 x 2^22. The matmul does 2*(down+8) flops an output where B21 does
# about 20. So `auto` takes B21 on the card at every rate; a CPU tensor keeps
# the reference's envelope.
MATMUL_MAX_PRODUCT_CUDA = 0


def as_rational_rate(rate) -> tuple[int, int]:
    """(up, down) for an output/input rate ratio; floats snapped exactly once.

    Accepts a positive float/int, a ``(up, down)`` pair, or a Fraction.
    """
    if isinstance(rate, tuple):
        up, down = int(rate[0]), int(rate[1])
    elif isinstance(rate, Fraction):
        up, down = rate.numerator, rate.denominator
    else:
        if not rate > 0:
            raise ValueError(f"rate must be positive, got {rate}")
        f = Fraction(float(rate)).limit_denominator(MAX_DENOMINATOR)
        up, down = f.numerator, f.denominator
    if up < 1 or down < 1:
        raise ValueError(f"rate must be positive, got {rate!r}")
    g = np.gcd(up, down)
    return int(up // g), int(down // g)


def farrow_output_len(num_samples: int, rate) -> int:
    """Output length of :func:`resample_farrow` for an input of ``num_samples``."""
    up, down = as_rational_rate(rate)
    if num_samples < 4:
        return 0
    return (num_samples - 3) * up // down + 1


def _lagrange4(mu, g0, g1, g2, g3):
    """Cubic Lagrange through nodes {-1, 0, 1, 2} at mu in [0, 1), in the
    reference's order of float32 operations."""
    a = mu - 1.0
    b = mu - 2.0
    c = mu + 1.0
    w0 = mu * a * b * float(np.float32(-1.0 / 6.0))
    w1 = a * c * b * 0.5
    w2 = mu * c * b * -0.5
    w3 = mu * c * a * float(np.float32(1.0 / 6.0))
    return w0 * g0 + w1 * g1 + w2 * g2 + w3 * g3


def _schedule(m_out: int, up: int, down: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact int64 schedule: ext index n and float32 mu of each output."""
    num = 4 * up + torch.arange(m_out, dtype=torch.int64, device=device) * down
    n = torch.div(num, up, rounding_mode="floor")
    mu = (num - n * up).to(torch.float32) * float(np.float32(1.0 / up))
    return n, mu


def resample_farrow(x: torch.Tensor, rate, *, method: str = "auto") -> torch.Tensor:
    """Arbitrary-rate resample by cubic Lagrange (Farrow) interpolation.

    ``rate`` = output rate / input rate (float, Fraction, or (up, down)).
    ``y[m]`` interpolates the input at ``m / rate`` (so ``y[0] == x[0]``);
    the outputs stop where the 4-tap stencil runs out of input. Zero left
    halo: positions before x[1] blend with zeros through the x[n-1] tap.
    """
    up, down = as_rational_rate(rate)
    xp, squeeze = _as_planar(x)
    t = xp.shape[-1]
    m_out = farrow_output_len(t, (up, down))
    if m_out <= 0:
        raise ValueError(f"input too short to resample: {t} samples at rate {up}/{down}")
    if method == "auto":
        limit = MATMUL_MAX_PRODUCT_CUDA if _on_cuda(xp) else MATMUL_MAX_PRODUCT
        method = "matmul" if up * down <= limit else "segmented"
    if method not in ("matmul", "segmented", "gather"):
        raise ValueError(
            f"unknown method {method!r}; options ('auto', 'matmul', 'segmented', 'gather')"
        )
    record_choice("resample_farrow", method)
    if method == "matmul":
        y = _farrow_matmul(xp, up, down, m_out)
    elif method == "segmented":
        y = resample_farrow_segmented(xp, (up, down))
    else:
        n, mu = _schedule(m_out, up, down, xp.device)
        ext = F.pad(xp.to(torch.float32), (4, 0))
        y = _lagrange4(mu, ext[:, n - 1], ext[:, n], ext[:, n + 1], ext[:, n + 2])
    return y[0] if squeeze else y


@functools.lru_cache(maxsize=32)
def _phase_matrix(up: int, down: int, device: str) -> torch.Tensor:
    """(down+8, up) float32 on ``device``, built once a rate: K[c, r] = Lagrange
    weight of frame column c for output phase r (columns 3 .. down+6 used), in
    float64 rounded to float32."""
    k = np.zeros((down + 8, up), np.float64)
    r = np.arange(up, dtype=np.int64)
    base = 4 + (r * down) // up
    mu = ((r * down) % up).astype(np.float64) / up
    w = [
        -mu * (mu - 1) * (mu - 2) / 6,
        (mu - 1) * (mu + 1) * (mu - 2) / 2,
        -mu * (mu + 1) * (mu - 2) / 2,
        mu * (mu + 1) * (mu - 1) / 6,
    ]
    for j in range(4):
        k[base + (j - 1), r] = w[j]
    return torch.from_numpy(k.astype(np.float32)).to(device)


def _frames_matmul(frames: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """(C, F, down+8) frames @ the phase matrix -> (C, F*up), IEEE float32."""
    k = _phase_matrix(up, down, str(frames.device))
    with ieee_fp32_matmul():
        y = frames @ k
    return y.reshape(frames.shape[0], -1)


def _farrow_matmul(xp: torch.Tensor, up: int, down: int, m_out: int) -> torch.Tensor:
    n_frames = cdiv(m_out, up)
    # ext = 4-zero halo + signal + tail pad covering the last frame's spill
    need = n_frames * down + 8
    ext = F.pad(xp.to(torch.float32), (4, 0))
    if ext.shape[-1] < need:
        ext = F.pad(ext, (0, need - ext.shape[-1]))
    frames = overlapping_frames(ext, n_frames, down, down + 8)
    return _frames_matmul(frames, up, down)[:, :m_out]


# --- streaming --------------------------------------------------------------------


@dataclasses.dataclass
class FarrowState:
    """Carry for streaming Farrow resampling.

    ``tail``: the last 4 raw input samples a channel (the stencil halo).
    ``phase_num``: integer numerator of the next output position relative
    to the current ext origin (ext = tail ++ chunk), in 1/up units.
    """

    tail: torch.Tensor  # (channels, 4) float32
    phase_num: int


def farrow_init(rate, channels: int = 1, *, device="cuda") -> FarrowState:
    up, _ = as_rational_rate(rate)
    tail = torch.zeros((channels, 4), dtype=torch.float32, device=resolve_device(device))
    return FarrowState(tail=tail, phase_num=4 * up)


def farrow_state_from_jax(state, *, device="cuda") -> FarrowState:
    """The reference's ``FarrowState`` carried across: its tail and phase."""
    tail = torch.from_numpy(np.array(state.tail, np.float32)).to(resolve_device(device))
    return FarrowState(tail=tail, phase_num=int(np.asarray(state.phase_num)))


def farrow_max_chunk_out(chunk_len: int, rate) -> int:
    """Output capacity of one streaming chunk (the valid count is <= this)."""
    up, down = as_rational_rate(rate)
    return max(((chunk_len + 1) * up - (up + 1)) // down + 1, 0)


def farrow_chunk(
    state: FarrowState, x: torch.Tensor, rate
) -> tuple[FarrowState, torch.Tensor, int]:
    """One chunk of streaming Farrow resampling.

    Returns ``(state, y, count)``: ``y`` has the per-chunk capacity
    (:func:`farrow_max_chunk_out`), only ``y[..., :count]`` is valid and the
    rest is zero. The valid outputs of all chunks, concatenated, are
    bit-exact with ``resample_farrow(method="gather")`` on the concatenated
    stream: the same integer schedule and the same float32 operations.
    """
    up, down = as_rational_rate(rate)
    squeeze = x.dim() == 1
    x2d = x[None, :] if squeeze else x
    tc = x2d.shape[-1]
    if tc < 1:
        raise ValueError("empty chunk")
    # the reference's int32 envelope for its in-graph phase arithmetic
    if (tc + 4) * up + down >= 2**31:
        raise ValueError(
            f"chunk of {tc} samples at rate {up}/{down} exceeds the int32 "
            f"phase envelope; use chunks <= {(2**31 - down) // up - 4} "
            "samples (or a smaller rate denominator)"
        )
    ext = torch.cat([state.tail, x2d.to(torch.float32)], dim=-1)
    m_max = farrow_max_chunk_out(tc, (up, down))
    count = max(((tc + 1) * up - state.phase_num) // down + 1, 0)
    num = state.phase_num + torch.arange(m_max, dtype=torch.int64, device=ext.device) * down
    n = torch.clamp(torch.div(num, up, rounding_mode="floor"), 1, tc + 1)
    mu = torch.remainder(num, up).to(torch.float32) * float(np.float32(1.0 / up))
    y = _lagrange4(mu, ext[:, n - 1], ext[:, n], ext[:, n + 1], ext[:, n + 2])
    y[:, count:] = 0.0
    new_state = FarrowState(tail=ext[:, -4:].clone(), phase_num=state.phase_num + count * down - tc * up)
    return new_state, (y[0] if squeeze else y), count


# --- streaming (matmul spelling) ----------------------------------------------------
#
# Whole frames of `up` outputs through the same phase matrix as the one-shot
# matmul, carrying a right-aligned (down+8)-sample input tail; the final
# sub-frame of the stream waits for more input or the flush.


@dataclasses.dataclass
class FarrowMatmulState:
    """Carry for the matmul spelling's streaming: a right-aligned raw-input tail.

    ``buf``: the last ``down + 8`` input samples a channel (garbage in the
    unused prefix); ``valid``: how many trailing samples are real and not
    yet consumed by emitted frames (the initial 4-zero halo included).
    """

    buf: torch.Tensor  # (channels, down + 8) float32
    valid: int


def farrow_matmul_init(rate, channels: int = 1, *, device="cuda") -> FarrowMatmulState:
    _, down = as_rational_rate(rate)
    buf = torch.zeros((channels, down + 8), dtype=torch.float32, device=resolve_device(device))
    return FarrowMatmulState(buf=buf, valid=4)


def farrow_matmul_state_from_jax(state, *, device="cuda") -> FarrowMatmulState:
    """The reference's ``FarrowMatmulState`` carried across: its tail and count."""
    buf = torch.from_numpy(np.array(state.buf, np.float32)).to(resolve_device(device))
    return FarrowMatmulState(buf=buf, valid=int(np.asarray(state.valid)))


def farrow_matmul_max_out(chunk_len: int, rate) -> int:
    """Output capacity of one matmul-spelling chunk."""
    up, down = as_rational_rate(rate)
    return ((chunk_len + down) // down) * up


def farrow_matmul_chunk(
    state: FarrowMatmulState, x: torch.Tensor, rate
) -> tuple[FarrowMatmulState, torch.Tensor, int]:
    """One chunk of matmul-spelling Farrow resampling.

    Returns ``(state, y, count)`` like :func:`farrow_chunk`; counts are whole
    multiples of ``up``. The valid outputs concatenated equal
    ``resample_farrow(method="matmul")`` on the concatenated stream, up to
    the deferred final sub-frame (:func:`farrow_matmul_flush`).
    """
    up, down = as_rational_rate(rate)
    squeeze = x.dim() == 1
    x2d = x[None, :] if squeeze else x
    c, tc = x2d.shape
    if tc < 1:
        raise ValueError("empty chunk")
    ht = down + 8
    ext = torch.cat([state.buf, x2d.to(torch.float32)], dim=-1)
    a_max = (tc + ht - 8) // down
    n_avail = state.valid + tc
    a_valid = max((n_avail - 8) // down, 0)
    # the real samples start at ht - valid; frame a covers [a*down, a*down + down + 8)
    sl = F.pad(ext, (0, ht))[:, ht - state.valid : ht - state.valid + tc + ht]
    y = _frames_matmul(overlapping_frames(sl, a_max, down, down + 8), up, down)
    y[:, a_valid * up :] = 0.0
    new_state = FarrowMatmulState(buf=ext[:, -ht:].clone(), valid=n_avail - a_valid * down)
    return new_state, (y[0] if squeeze else y), a_valid * up


def farrow_matmul_flush_cap(rate) -> int:
    """Capacity of :func:`farrow_matmul_flush`'s output."""
    up, down = as_rational_rate(rate)
    return up + (2 * up) // down + 2


def farrow_matmul_flush(state: FarrowMatmulState, rate) -> tuple[torch.Tensor, int]:
    """Emit the stream-end outputs the whole-frame chunks deferred.

    Returns ``(y, count)``, ``y`` of capacity :func:`farrow_matmul_flush_cap`
    with only ``y[..., :count]`` valid: the exact pointwise schedule on the
    carried tail.
    """
    up, down = as_rational_rate(rate)
    ht = down + 8
    cap = farrow_matmul_flush_cap((up, down))
    r = np.arange(cap, dtype=np.int64)
    n_rel = 4 + (r * down) // up  # the pattern of frame 0
    mu = torch.from_numpy(((r * down) % up).astype(np.float32) / up).to(state.buf.device)
    ok = n_rel + 2 <= state.valid - 1  # the stencil fits the valid tail
    idx = torch.from_numpy(np.clip(ht - state.valid + n_rel, 1, ht - 3)).to(state.buf.device)
    g = [state.buf[:, idx + (j - 1)] for j in range(4)]
    y = _lagrange4(mu, *g)
    count = int(ok.sum())
    y[:, count:] = 0.0
    return y, count


def segmented_plain(xp: torch.Tensor, up: int, down: int, m_out: int) -> torch.Tensor:
    """Plain version of B21: the Farrow power form over the int64 schedule."""
    n, mu = _schedule(m_out, up, down, xp.device)
    ext = F.pad(xp.to(torch.float32), (4, 0))
    xm1, x0, x1, x2 = (ext[:, n + j] for j in (-1, 0, 1, 2))
    third, sixth = float(np.float32(1 / 3)), float(np.float32(1 / 6))
    v0 = x0
    v1 = -third * xm1 - 0.5 * x0 + x1 - sixth * x2
    v2 = 0.5 * (xm1 + x1) - x0
    v3 = sixth * (x2 - xm1) + 0.5 * (x0 - x1)
    return v0 + mu * (v1 + mu * (v2 + mu * v3))


def resample_farrow_segmented(x: torch.Tensor, rate, *, segment: int = 512) -> torch.Tensor:
    """Exact-schedule Farrow resample by B21, for any rational rate.

    The output of ``resample_farrow(method="gather")`` to float rounding (the
    same integer schedule, the cubic in Farrow power form). A block of the
    kernel computes ``segment`` outputs of one channel from one int64 start.
    """
    up, down = as_rational_rate(rate)
    xp, squeeze = _as_planar(x)
    c, t = xp.shape
    m_out = farrow_output_len(t, (up, down))
    if m_out <= 0:
        raise ValueError(f"input too short to resample: {t} samples at rate {up}/{down}")
    s_out = int(segment)
    if s_out % 128 != 0:
        raise ValueError(f"segment must be a multiple of 128, got {segment}")
    if 1024 * up + s_out * down >= 2**31:
        raise ValueError(
            f"segment {s_out} at rate {up}/{down} exceeds the int32 phase "
            "envelope; use a smaller segment"
        )
    if not _on_cuda(xp):
        y = segmented_plain(xp, up, down, m_out)
        return y[0] if squeeze else y
    refuse_grad("resample_farrow_segmented (B21)", xp)
    if c > 65535:
        raise ValueError(f"resample_farrow_segmented takes at most 65535 channels, got {c}")
    xc = xp.to(torch.float32).contiguous()
    y = torch.empty((c, m_out), dtype=torch.float32, device=xc.device)
    lib = _build.library()
    with torch.cuda.device(xc.device):
        err = lib.dsp_farrow(
            xc.data_ptr(), y.data_ptr(), t, c, m_out, up, down, s_out,
            float(np.float32(1.0 / up)), _stream(xc),
        )
    _build.check(err, "resample_farrow_segmented")
    resample_farrow_segmented.launches += 1
    return y[0] if squeeze else y


resample_farrow_segmented.launches = 0


__all__ = [
    "MAX_DENOMINATOR",
    "MATMUL_MAX_PRODUCT",
    "MATMUL_MAX_PRODUCT_CUDA",
    "FarrowState",
    "FarrowMatmulState",
    "as_rational_rate",
    "farrow_chunk",
    "farrow_init",
    "farrow_state_from_jax",
    "farrow_max_chunk_out",
    "farrow_matmul_chunk",
    "farrow_matmul_flush",
    "farrow_matmul_flush_cap",
    "farrow_matmul_init",
    "farrow_matmul_max_out",
    "farrow_matmul_state_from_jax",
    "farrow_output_len",
    "resample_farrow",
    "resample_farrow_segmented",
    "segmented_plain",
]
