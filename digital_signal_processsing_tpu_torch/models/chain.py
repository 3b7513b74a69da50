"""The flagship model: a multi-channel FM receiver chain.

Counterpart of ``digital_signal_processsing_tpu/models/chain.py``
(BASELINE.json config 5: "full chain: overlap-save FIR + polyphase decimate
+ FM demod, 16 channels"). Complex baseband in, per-channel audio out:

    IQ (C, T) complex64
      -> frequency translate (per-channel LO, exact phase at any t0)
      -> channel-select FIR lowpass (``fir_filter``: conv1d, or B8/B9 past
         the crossover)
      -> polyphase decimate by D (strided conv1d)
      -> FM quadrature discriminator
      -> audio FIR lowpass (conv1d)
      -> optional Farrow resampling to a non-integer audio rate
         (``resample_farrow``: B21 on the card, the reference's phase-matrix
         matmul on the CPU inside its envelope)

``DspChain`` is an ``nn.Module`` whose taps, decimator taps and LO comb are
buffers on its device (the card unless ``device="cpu"``). When the
channel-select taps take the fused route, their spectrum is computed once at
construction and kept as buffers too, so a forward copies nothing to the
host. ``chain_from_jax`` and ``chain_state_from_jax`` carry the reference
chain's weights and streaming state across.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.demod import fm_demodulate, oscillator_bank
from ..ops.farrow import resample_farrow
from ..ops.fft_mxu import TapResponse, fused_geometry, pick_fused_block, tap_response
from ..ops.fir import FIR_FFT_CROSSOVER, design_lowpass, fir_direct, fir_filter
from ..ops.resample import decimate
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    channels: int = 16
    decimation: int = 8
    channel_taps: int = 257  # channel-select lowpass
    audio_taps: int = 63  # post-demod audio lowpass (direct)
    fm_gain: float = 1.0
    # fuse channel-select + anti-alias + downsample into ONE polyphase
    # decimating FIR (the classic channelizer frontend); False keeps the
    # explicit two-stage pipeline, the reference shape and the default.
    fused_frontend: bool = False
    # lock the audio output to a non-integer rate ratio (e.g. (441, 2560):
    # 44.1 kHz from 256 kHz) through the Farrow stage; None keeps the
    # decimated rate.
    audio_resample: float | tuple[int, int] | None = None

    def lo_frequencies(self) -> np.ndarray:
        """Default LO comb: evenly spaced channels in (-0.4, 0.4) cyc/sample."""
        return np.linspace(-0.4, 0.4, self.channels, dtype=np.float32)


class DspChain(torch.nn.Module):
    """Stateless receiver chain; taps designed once at construction."""

    def __init__(self, config: ChainConfig = ChainConfig(), *, device="cuda"):
        super().__init__()
        self.config = config
        c = config
        self._set_weights(
            design_lowpass(c.channel_taps, 0.8 / c.decimation),
            design_lowpass(c.audio_taps, 0.5),
            c.lo_frequencies(),
            device=resolve_device(device),
        )

    def _set_weights(self, channel_taps, audio_taps, lo, *, device) -> None:
        """Set the taps and LO comb (float32 arrays) as buffers on ``device``."""
        c = self.config

        def buffer(a) -> torch.Tensor:
            return torch.from_numpy(np.array(a, np.float32)).to(device)

        self.register_buffer("channel_taps", buffer(channel_taps))
        self.register_buffer("audio_taps", buffer(audio_taps))
        self.register_buffer("lo", buffer(lo))
        # decimate()'s default taps, designed once instead of every call
        d = c.decimation
        self.register_buffer("decimation_taps", buffer(design_lowpass(8 * d, 0.8 / d)))
        k = self.channel_taps.shape[0]
        block = pick_fused_block(k)
        self._channel_geometry = None
        if not c.fused_frontend and k > FIR_FFT_CROSSOVER and block is not None:
            self._channel_geometry = fused_geometry(k, block)
            r = tap_response(self.channel_taps, self._channel_geometry, self.channel_taps.device)
            self.register_buffer("channel_h", r.h)
            self.register_buffer("channel_h_kernel", r.h_kernel)

    def channel_response(self) -> TapResponse | None:
        """The channel-select taps' spectrum for the fused route, or None on the direct route."""
        if self._channel_geometry is None:
            return None
        return TapResponse(self._channel_geometry, self.channel_h, self.channel_h_kernel)

    def forward(self, iq: torch.Tensor, t0=0, lo_freqs: torch.Tensor | None = None) -> torch.Tensor:
        """(channels, T) complex64 -> (channels, T // decimation) float32, or
        ``farrow_output_len(T // decimation, audio_resample)`` columns.

        ``t0`` is the global index of the first sample: the LO phase is
        absolute, so chunks and shards mix coherently. ``lo_freqs``
        overrides the per-channel LO comb.
        """
        c = self.config
        if iq.device != self.channel_taps.device:
            raise ValueError(f"input on {iq.device}, chain on {self.channel_taps.device}")
        t = iq.shape[-1]
        lo_f = self.lo if lo_freqs is None else lo_freqs
        lo_cos, lo_sin = oscillator_bank(lo_f, t, t0)
        mixed = iq.to(torch.complex64) * torch.complex(lo_cos, lo_sin)
        if c.fused_frontend:
            # one polyphase decimating FIR does select + anti-alias + drop
            di = decimate(mixed.real, c.decimation, taps=self.channel_taps)
            dq = decimate(mixed.imag, c.decimation, taps=self.channel_taps)
        else:
            response = self.channel_response()
            fi = fir_filter(mixed.real, self.channel_taps, response=response)
            fq = fir_filter(mixed.imag, self.channel_taps, response=response)
            di = decimate(fi, c.decimation, taps=self.decimation_taps)
            dq = decimate(fq, c.decimation, taps=self.decimation_taps)
        audio = fm_demodulate(torch.complex(di, dq), gain=c.fm_gain)
        audio = fir_direct(audio, self.audio_taps)
        if c.audio_resample is not None:
            audio = resample_farrow(audio, c.audio_resample)
        return audio

    def forward_planar(
        self, i: torch.Tensor, q: torch.Tensor, t0=0, lo_freqs: torch.Tensor | None = None
    ) -> torch.Tensor:
        """Forward from separate I/Q float32 planes."""
        iq = torch.complex(i.to(torch.float32), q.to(torch.float32))
        return self(iq, t0=t0, lo_freqs=lo_freqs)

    def example_input(self, t: int = 1 << 16, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        shape = (self.config.channels, t)
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)

    def example_planar_input(self, t: int = 1 << 16, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(seed)
        shape = (self.config.channels, t)
        return (
            rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32),
        )


def chain_from_jax(params: dict, config: ChainConfig, *, device="cuda") -> DspChain:
    """A chain with the reference chain's weights.

    ``params`` holds ``channel_taps``, ``audio_taps`` and ``lo`` as NumPy
    arrays (``np.asarray`` of the reference ``DspChain``'s attributes).
    """
    chain = DspChain(config, device=device)
    chain._set_weights(
        params["channel_taps"], params["audio_taps"], params["lo"],
        device=chain.channel_taps.device,
    )
    return chain


@dataclasses.dataclass
class ChainStreamState:
    """Carry for chunked chain processing: the raw I/Q halo and the global offset.

    Keep the last ``chain_halo`` raw samples, prepend them to the next chunk,
    drop the halo's outputs. Chunked output matches the one-shot chain on
    the concatenated stream to float32 rounding.
    """

    tail_i: torch.Tensor  # (channels, halo) float32
    tail_q: torch.Tensor  # (channels, halo) float32
    t0: int  # absolute index of the next chunk's sample 0


def chain_stream_init(chain: DspChain) -> ChainStreamState:
    from ..parallel.pipeline import chain_halo

    z = torch.zeros(
        (chain.config.channels, chain_halo(chain)), dtype=torch.float32,
        device=chain.channel_taps.device,
    )
    return ChainStreamState(tail_i=z, tail_q=z.clone(), t0=0)


def chain_state_from_jax(state, *, device="cuda") -> ChainStreamState:
    """The reference's ``ChainStreamState`` carried across: its tails and ``t0``."""
    dev = resolve_device(device)
    return ChainStreamState(
        tail_i=torch.from_numpy(np.array(state.tail_i, np.float32)).to(dev),
        tail_q=torch.from_numpy(np.array(state.tail_q, np.float32)).to(dev),
        t0=int(np.asarray(state.t0)),
    )


def chain_stream_chunk(
    chain: DspChain, state: ChainStreamState, i: torch.Tensor, q: torch.Tensor
) -> tuple[ChainStreamState, torch.Tensor]:
    """One chunk of the receiver chain with the carried raw-sample halo.

    ``i``/``q``: (channels, chunk_t) float32 planes, chunk_t a multiple of
    the decimation. Returns audio (channels, chunk_t // decimation) aligned
    with the one-shot chain's output at the same absolute offsets.
    """
    d = chain.config.decimation
    t_loc = i.shape[-1]
    halo = state.tail_i.shape[-1]
    ext_i = torch.cat([state.tail_i, i.to(torch.float32)], dim=-1)
    ext_q = torch.cat([state.tail_q, q.to(torch.float32)], dim=-1)
    out = chain.forward_planar(ext_i, ext_q, t0=state.t0 - halo)
    new_state = ChainStreamState(
        tail_i=ext_i[:, t_loc:].clone(),
        tail_q=ext_q[:, t_loc:].clone(),
        t0=state.t0 + t_loc,
    )
    return new_state, out[:, halo // d :]


__all__ = [
    "ChainConfig",
    "DspChain",
    "ChainStreamState",
    "chain_from_jax",
    "chain_state_from_jax",
    "chain_stream_init",
    "chain_stream_chunk",
]
