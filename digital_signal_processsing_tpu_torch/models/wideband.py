"""Wideband PFB receiver: one real stream -> N demodulated channels.

Counterpart of ``digital_signal_processsing_tpu/models/wideband.py``, the
second receiver beside ``DspChain``: it takes ONE wideband real stream and
splits it itself with the polyphase filter-bank channelizer, then
demodulates every channel in one batched pass:

    x (T,) real @ fs
      -> PFB channelize: (N, T/N) I and Q planes @ fs/N (B19 on the card
         inside its envelope, B20 outside it)
      -> FM quadrature discriminator a channel
      -> audio FIR lowpass a channel (IEEE fp32 conv1d)
      -> squelch: mute channels whose mean magnitude is below a fraction of
         the strongest, on the device (no host sync)

``WidebandFmReceiver`` is an ``nn.Module`` whose prototype and audio taps
are buffers on its device (the card unless ``device="cpu"``).
``wideband_from_jax`` carries the reference receiver's taps across. The
reference's time-sharded run (GSPMD on a ``P("t")`` input) is
``parallel.sharded_wideband``: the same stages on each rank's time block.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.channelizer import design_prototype, pfb_channelize_planar
from ..ops.demod import fm_demodulate
from ..ops.fir import design_lowpass, fir_direct
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class WidebandConfig:
    n_channels: int = 64
    taps_per_phase: int = 8
    audio_taps: int = 63
    fm_gain: float = 1.0
    # mute channels whose mean baseband magnitude is below this fraction of
    # the strongest channel's (an FM discriminator turns an empty channel into
    # full-scale noise: the scanner's squelch). None: no squelch.
    squelch: float | None = 0.1


class WidebandFmReceiver(torch.nn.Module):
    """Stateless wideband FM scanner; filters designed once at construction."""

    def __init__(self, config: WidebandConfig = WidebandConfig(), *, device="cuda"):
        super().__init__()
        self.config = config
        self._set_weights(
            design_prototype(config.n_channels, config.taps_per_phase),
            design_lowpass(config.audio_taps, 0.5),
            device=resolve_device(device),
        )

    def _set_weights(self, prototype, audio_taps, *, device) -> None:
        def buffer(a) -> torch.Tensor:
            return torch.from_numpy(np.array(a, np.float32)).to(device)

        self.register_buffer("prototype", buffer(prototype))
        self.register_buffer("audio_taps", buffer(audio_taps))

    def channelize(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The receiver's first stage: (T,) -> (I, Q) planes, (N, T/N) each."""
        if x.device != self.prototype.device:
            raise ValueError(f"input on {x.device}, receiver on {self.prototype.device}")
        return pfb_channelize_planar(x.to(torch.float32), self.config.n_channels, self.prototype)

    def demodulate(self, i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """The discriminator and the audio FIR: (I, Q) planes -> (N, M) audio."""
        audio = fm_demodulate(torch.complex(i, q), gain=self.config.fm_gain)
        return fir_direct(audio, self.audio_taps)

    def gate(self, audio: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
        """``audio`` with the channels whose ``level`` (N,) is below the squelch
        fraction of the strongest zeroed."""
        gate = level >= self.config.squelch * torch.max(level)
        return audio * gate[:, None].to(audio.dtype)

    def squelch(self, audio: torch.Tensor, i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """``audio`` with the channels below the squelch level zeroed: each
        channel's level is its mean baseband magnitude."""
        return self.gate(audio, torch.mean(torch.sqrt(i * i + q * q), dim=-1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(T,) real float32 -> (n_channels, T // n_channels) float32 audio."""
        i, q = self.channelize(x)
        audio = self.demodulate(i, q)
        if self.config.squelch is not None:
            audio = self.squelch(audio, i, q)
        return audio

    def example_input(self, t: int | None = None, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        t = t or self.config.n_channels * 4096
        return rng.normal(size=t).astype(np.float32)


def wideband_from_jax(params: dict, config: WidebandConfig, *, device="cuda") -> WidebandFmReceiver:
    """A receiver with the reference receiver's taps.

    ``params`` holds ``prototype`` and ``audio_taps`` as NumPy arrays
    (``np.asarray`` of the reference ``WidebandFmReceiver``'s attributes).
    """
    rx = WidebandFmReceiver(config, device=device)
    rx._set_weights(params["prototype"], params["audio_taps"], device=rx.prototype.device)
    return rx


__all__ = ["WidebandConfig", "WidebandFmReceiver", "wideband_from_jax"]
