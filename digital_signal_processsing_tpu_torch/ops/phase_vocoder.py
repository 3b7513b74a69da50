"""Phase vocoder: time stretching and pitch shifting on the STFT, the port of
``digital_signal_processsing_tpu/ops/phase_vocoder.py``.

The classic Flanagan/Dolson phase vocoder:

- analysis and synthesis are :func:`ops.fft.stft` / :func:`ops.fft.istft`
  (``torch.fft``, the WOLA overlap-add as shifted adds);
- phase propagation is batched: the per-bin instantaneous frequency comes
  from wrapped frame-to-frame phase differences, and the synthesis phase
  ramp is one ``torch.cumsum`` over the frame axis. The phase chain runs in
  float64 and the synthesis phase is wrapped to [0, 2 pi) before it meets
  the float32 magnitudes: the reference keeps the running phase in float32,
  where it grows to millions of radians over a long stream and keeps only
  ulp(phase) of it (about 1e-2 of max|y| after 600 frames at nfft 2048,
  and on the card, whose ``cumsum`` adds in float32, 3e-2 after 150). The
  same function, without that loss; the state carries the wrapped phase;
- the synthesis hop is fixed at ``nfft // 4`` (COLA-exact for the
  sqrt-hann pair at 4x overlap) and the analysis hop is quantized to
  ``round(hs * rate)``. ``pitch_shift`` resamples through
  ``ops.farrow.resample_farrow`` (B21 on the card).

Everything runs on the input's device; ``time_stretch_init`` makes its
state on the card unless the caller names the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device
from .fft import _real32, istft, stft

__all__ = [
    "time_stretch",
    "pitch_shift",
    "TimeStretchState",
    "time_stretch_init",
    "time_stretch_chunk",
    "time_stretch_flush",
    "time_stretch_state_from_jax",
    "spectral_subtract",
]


def _princarg(p: torch.Tensor) -> torch.Tensor:
    """Wrap phase to (-pi, pi] (round half to even, as ``jnp.round``)."""
    two_pi = 2.0 * np.pi
    return p - two_pi * torch.round(p / two_pi)


def _bin_freqs(nfft: int, device) -> torch.Tensor:
    """2 pi k / nfft rad/sample for each one-sided bin, float64."""
    k = np.arange(nfft // 2 + 1)
    return torch.from_numpy(2.0 * np.pi * k / nfft).to(device)


def _increments(ph_chain: torch.Tensor, nfft: int, ha: int, hs: int) -> torch.Tensor:
    """hs * the instantaneous frequency between consecutive frames of the
    analysis phases (..., F+1, K), float64: (..., F, K)."""
    ph64 = ph_chain.to(torch.float64)
    wk = _bin_freqs(nfft, ph64.device)
    # heterodyned phase increment -> per-bin instantaneous frequency
    dph = ph64[..., 1:, :] - ph64[..., :-1, :] - wk * ha
    return hs * (wk + _princarg(dph) / ha)


def _cumsum_frames(inc: torch.Tensor) -> torch.Tensor:
    """Running sum over the frame axis (-2), taken along the last axis of the
    transposed view: the card's scan of an outer axis walks its frames in one
    thread a column, the innermost scan in parallel."""
    return torch.cumsum(inc.transpose(-1, -2), dim=-1).transpose(-1, -2)


def _wrapped(phase64: torch.Tensor) -> torch.Tensor:
    """A float64 phase wrapped to [0, 2 pi), as float32."""
    return torch.remainder(phase64, 2.0 * np.pi).to(torch.float32)


def time_stretch(
    x,
    rate: float,
    *,
    nfft: int = 2048,
    window: str = "sqrt_hann",
) -> torch.Tensor:
    """Change duration without changing pitch: output lasts ~1/rate times
    the input (rate > 1 compresses, rate < 1 stretches).

    (..., T) real -> (..., T_out) float32; T_out = (frames-1)*nfft//4
    + nfft with frames = (T - nfft)//round(nfft/4*rate) + 1. The
    effective rate is quantized to hs/ha (hs = nfft//4, ha = the rounded
    analysis hop); compose with the resamplers for exact ratios.
    """
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    if window != "sqrt_hann":
        # the fixed 2*hs/nfft OLA normalization below is the sqrt-hann
        # pair's COLA constant; other windows would silently mis-scale
        raise ValueError("time_stretch supports window='sqrt_hann' only")
    hs = nfft // 4
    ha = max(1, int(round(hs * rate)))
    xp = _real32(x)
    if xp.shape[-1] < nfft + ha:
        raise ValueError(
            f"input too short: need at least nfft+ha = {nfft + ha} samples,"
            f" got {xp.shape[-1]}"
        )
    s = stft(xp, nfft=nfft, hop=ha, window=window)  # (..., F, K)
    mag = s.abs()
    ph = torch.angle(s)
    # synthesis phases: phi[0] = ph[0]; phi[t] = phi[t-1] + hs*inst[t]
    ph0 = ph[..., :1, :].to(torch.float64)
    phs = torch.cat([ph0, ph0 + _cumsum_frames(_increments(ph, nfft, ha, hs))], dim=-2)
    y = istft(torch.polar(mag, _wrapped(phs)), nfft=nfft, hop=hs, window=window)
    # sqrt-hann analysis x synthesis overlap-adds to nfft/(2*hs) at this hop
    return y * (2.0 * hs / nfft)


def pitch_shift(
    x,
    factor: float,
    *,
    nfft: int = 2048,
    window: str = "sqrt_hann",
    resample_method: str = "auto",
) -> torch.Tensor:
    """Scale pitch by ``factor`` (2.0 = up one octave) at ~constant
    duration: time-stretch by 1/factor, then resample by 1/factor
    (``ops.farrow.resample_farrow``: B21 on the card)."""
    if factor <= 0:
        raise ValueError(f"factor must be positive, got {factor}")
    from .farrow import resample_farrow

    stretched = time_stretch(x, 1.0 / factor, nfft=nfft, window=window)
    return resample_farrow(stretched, 1.0 / factor, method=resample_method)


# ---------------------------------------------------------------------------
# Streaming form: carried STFT tail + phase chain + WOLA tail, so an
# unbounded stream time-stretches chunk by chunk. Chunked output matches the
# one-shot time_stretch of the concatenated stream to float32 rounding (the
# synthesis-phase cumsum re-associates at chunk boundaries).


@dataclasses.dataclass
class TimeStretchState:
    """Carry: analysis STFT tail, WOLA synthesis tail, the previous
    frame's analysis/synthesis phases (the synthesis phase wrapped to
    [0, 2 pi)), and a started flag (the stream's first frame passes its
    analysis phase through). Tensors on the stream's device; ``started`` a
    host bool."""

    stft_tail: torch.Tensor  # (C, nfft - ha) float32
    ola_tail: torch.Tensor  # (C, nfft - hs) float32
    prev_ph: torch.Tensor  # (C, K) float32
    prev_synth: torch.Tensor  # (C, K) float32
    started: bool


def _vocoder_hops(nfft: int, rate: float) -> tuple[int, int]:
    hs = nfft // 4
    return max(1, int(round(hs * rate))), hs


def time_stretch_init(
    rate: float, *, nfft: int = 2048, channels: int = 1, device="cuda"
) -> TimeStretchState:
    """Zero state for :func:`time_stretch_chunk` on ``device`` (the card by default)."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    ha, hs = _vocoder_hops(nfft, rate)
    k = nfft // 2 + 1
    dev = resolve_device(device)

    def zeros(n):
        return torch.zeros((channels, n), dtype=torch.float32, device=dev)

    return TimeStretchState(
        stft_tail=zeros(nfft - ha), ola_tail=zeros(nfft - hs),
        prev_ph=zeros(k), prev_synth=zeros(k), started=False,
    )


def time_stretch_state_from_jax(state, *, device="cuda") -> TimeStretchState:
    """The state of the reference package's ``time_stretch_chunk``, carried over.

    ``state`` is a ``digital_signal_processsing_tpu.ops.phase_vocoder.
    TimeStretchState`` (or any object with its five fields); each field is
    read with ``np.asarray`` and the stream continues here.
    """
    dev = resolve_device(device)
    fields = {}
    for name in ("stft_tail", "ola_tail", "prev_ph", "prev_synth"):
        a = np.asarray(getattr(state, name))
        if a.dtype != np.float32 or a.ndim != 2:
            raise ValueError(f"expected a float32 (channels, n) {name}, got {a.dtype} {a.shape}")
        fields[name] = torch.from_numpy(a.copy()).to(dev)
    return TimeStretchState(**fields, started=bool(np.asarray(state.started)))


def time_stretch_chunk(
    state: TimeStretchState,
    x: torch.Tensor,
    *,
    rate: float,
    nfft: int = 2048,
) -> tuple[TimeStretchState, torch.Tensor]:
    """One chunk: (C, L) -> (C, L//ha * hs) stretched samples, L a nonzero
    multiple of the analysis hop ha = round(nfft//4 * rate). Stream tail:
    :func:`ops.streaming.istft_flush` semantics via ``state.ola_tail``.
    """
    from .streaming import IstftState, StftState, istft_chunk, stft_chunk

    ha, hs = _vocoder_hops(nfft, rate)
    squeeze = x.dim() == 1
    xp = (x[None, :] if squeeze else x).to(torch.float32)
    st, s = stft_chunk(
        StftState(tail=state.stft_tail), xp, nfft=nfft, hop=ha, window="sqrt_hann",
    )
    mag = s.abs()  # (C, F, K)
    ph = torch.angle(s)
    ph_chain = torch.cat([state.prev_ph[:, None, :], ph], dim=1)
    cum = _cumsum_frames(_increments(ph_chain, nfft, ha, hs))
    if state.started:
        synth = _wrapped(state.prev_synth.to(torch.float64)[:, None, :] + cum)
    else:
        synth = _wrapped(ph[:, :1, :].to(torch.float64) + (cum - cum[:, :1, :]))
    ist, y = istft_chunk(
        IstftState(tail=state.ola_tail), torch.polar(mag, synth),
        nfft=nfft, hop=hs, window="sqrt_hann",
    )
    y = y * (2.0 * hs / nfft)
    new = TimeStretchState(
        stft_tail=st.tail, ola_tail=ist.tail, prev_ph=ph[:, -1, :].clone(),
        prev_synth=synth[:, -1, :].clone(), started=True,
    )
    return new, (y[0] if squeeze else y)


def time_stretch_flush(state: TimeStretchState) -> torch.Tensor:
    """The final WOLA tail, scaled like the chunk outputs (2*hs/nfft = 1/2
    at the fixed 4x-overlap synthesis hop)."""
    return state.ola_tail * 0.5


def spectral_subtract(
    x,
    *,
    nfft: int = 1024,
    noise_frames: int = 8,
    noise_psd=None,
    oversubtract: float = 2.0,
    floor: float = 0.05,
) -> torch.Tensor:
    """Classic magnitude spectral subtraction (Boll/Berouti) on the STFT:
    estimate the noise magnitude from the first ``noise_frames`` frames (or
    take ``noise_psd`` of shape (nfft//2+1,) directly), subtract
    ``oversubtract`` times it from every frame's magnitude with a
    ``floor``-scaled spectral floor, and resynthesize with the original
    phases. Output keeps :func:`ops.fft.istft`'s length at 50% overlap.
    """
    if not 0.0 <= floor < 1.0:
        raise ValueError(f"floor must be in [0, 1), got {floor}")
    hop = nfft // 2
    xp = _real32(x)
    s = stft(xp, nfft=nfft, hop=hop, window="sqrt_hann")
    mag = s.abs()
    if noise_psd is None:
        if s.shape[-2] <= noise_frames:
            raise ValueError(
                f"need more than noise_frames={noise_frames} frames,"
                f" got {s.shape[-2]}"
            )
        noise = mag[..., :noise_frames, :].mean(dim=-2, keepdim=True)
    else:
        noise = torch.as_tensor(noise_psd, dtype=torch.float32).to(mag.device)[None, :]
    cleaned = torch.maximum(mag - oversubtract * noise, floor * mag)
    # keep the noisy phase: scale the complex frames by the magnitude gain
    gain = cleaned / torch.clamp(mag, min=1e-30)
    return istft(s * gain, nfft=nfft, hop=hop, window="sqrt_hann")
