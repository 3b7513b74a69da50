"""Sharded receiver pipeline: the flagship chain over a (ch, t) mesh.

Counterpart of ``digital_signal_processsing_tpu/parallel/pipeline.py``
(BASELINE.json config 5: the full chain, 16 channels over several hosts).

- receiver channels shard over ``ch``, with no communication;
- time shards over ``t`` with ONE raw-sample halo exchange that covers the
  causal memory of every stage at once (:func:`chain_halo`): each rank runs
  the unchanged chain on ``[halo | shard]`` and drops the halo's outputs;
- the LO mix takes the absolute time of the shard's first sample (the
  chain's ``t0``), so the shards' phases are coherent and the output equals
  the one-card chain's.

The same halo serves the chain's streamed chunks (``chain_stream_chunk``).

The wideband receiver (``models/wideband.py``) shards the same way over
``t`` (:func:`sharded_wideband`, the counterpart of the reference's GSPMD run
on a ``P("t")`` input): one raw halo covers the PFB's look-back, the
discriminator's previous sample and the audio FIR; the squelch's levels are
means over the whole stream, so each rank sums its own samples' magnitudes
and the sums meet in one ``psum`` over ``t``.
"""

from __future__ import annotations

import math

import torch

from ..utils.layout import cdiv, round_up
from .mesh import TIME_AXIS, Mesh, psum, shift_right


def chain_halo(chain) -> int:
    """Raw-sample causal memory of the full chain, rounded to the decimation
    grid (so every chunk's polyphase phase matches the one-shot run)."""
    c = chain.config
    k_chan = int(chain.channel_taps.shape[0])
    k_audio = int(chain.audio_taps.shape[0])
    if c.fused_frontend:
        h = (k_chan - 1) + c.decimation + (k_audio - 1) * c.decimation
    else:
        k_dec = 8 * c.decimation  # decimate()'s default taps_per_phase * D
        h = (k_chan - 1) + (k_dec - 1) + c.decimation + (k_audio - 1) * c.decimation
    return round_up(h, c.decimation)


def sharded_chain(chain, iq: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the chain's audio: channels over ``ch``, time over ``t``.

    ``iq``: this rank's (channels, time) complex shard, on the chain's
    device; the chain's LO comb holds every channel of the mesh. Returns
    (channels, time // decimation).
    """
    c = chain.config
    if iq.dim() != 2:
        raise ValueError(f"expected a (channels, time) shard, got shape {tuple(iq.shape)}")
    c_loc, t_loc = iq.shape
    n_lo = int(chain.lo.shape[0])
    if c_loc * mesh.n_channel != n_lo:
        raise ValueError(
            f"{c_loc} channels a shard over a ch-axis of {mesh.n_channel} do not divide "
            f"the chain's {n_lo} channels"
        )
    if t_loc % c.decimation:
        raise ValueError(
            f"time shard {t_loc} must divide into whole decimation frames ({c.decimation})"
        )
    halo = chain_halo(chain)
    if halo > t_loc:
        raise ValueError(f"chain halo {halo} exceeds one time shard ({t_loc})")
    lo_loc = chain.lo[mesh.ch * c_loc : (mesh.ch + 1) * c_loc]
    left = shift_right(iq[:, t_loc - halo :].contiguous(), mesh, TIME_AXIS)
    ext = torch.cat([left, iq], dim=-1)
    # absolute index of ext[0]: rank 0's halo is zeros before the stream
    # starts, the zero history the one-card chain has
    t0 = mesh.t * t_loc - halo
    out = chain(ext, t0=t0, lo_freqs=lo_loc)
    return out[:, halo // c.decimation :]


def sharded_chain_planar(chain, i: torch.Tensor, q: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """:func:`sharded_chain` from separate I/Q float32 planes of this rank's shard."""
    return sharded_chain(chain, torch.complex(i.to(torch.float32), q.to(torch.float32)), mesh)


# B19 (the raw-stream PFB kernel) takes a stream of a multiple of 128 samples
# at 32, 64 and 128 channels: the halo keeps an extended shard on that grid
_RAW_GRID = 128


def wideband_halo(rx) -> int:
    """Raw-sample causal memory of the wideband receiver, in whole commutator
    steps of ``n_channels`` samples (and of 128 samples, so that a shard inside
    B19's envelope stays there once extended).

    Output column m of the PFB reads x[N*m - j] for j < len(prototype): the
    look-back is ceil((len - 1) / N) steps. The discriminator reads the column
    before (one step), the audio FIR ``audio_taps - 1`` columns before that.
    """
    n = rx.config.n_channels
    steps = cdiv(int(rx.prototype.shape[0]) - 1, n) + 1 + int(rx.audio_taps.shape[0]) - 1
    return round_up(steps * n, math.lcm(n, _RAW_GRID))


def sharded_wideband(rx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the wideband receiver's audio: time over ``t``.

    ``x``: this rank's contiguous time block of the (T,) float32 stream, a
    whole number of commutator steps and at least one halo long, on the
    receiver's device (ranks along ``ch`` hold the same block; blocks along
    ``t`` may differ in length). Returns (n_channels, T_loc // n_channels).
    The squelch gates each channel on its mean magnitude over the whole
    stream: each rank's float32 sums and its column count meet in one
    ``psum`` over ``t`` (in float64), in another order than the one-card
    mean, so a channel within rounding of the threshold may gate differently.
    """
    c = rx.config
    n = c.n_channels
    if x.dim() != 1:
        raise ValueError(f"expected a flat (time,) shard, got shape {tuple(x.shape)}")
    t_loc = x.shape[0]
    if t_loc % n:
        raise ValueError(f"time shard {t_loc} must be whole commutator steps of {n} samples")
    halo = wideband_halo(rx)
    if halo > t_loc:
        raise ValueError(f"wideband halo {halo} exceeds one time shard ({t_loc})")
    left = shift_right(x[t_loc - halo :].contiguous(), mesh, TIME_AXIS)
    # rank 0's halo is zeros, the one-card run's zero history: it runs on its block
    # alone, as the receiver on one card does
    drop = 0 if mesh.t == 0 else halo // n
    i, q = rx.channelize(x if drop == 0 else torch.cat([left, x]))
    audio = rx.demodulate(i, q)[:, drop:]
    if c.squelch is None:
        return audio
    i, q = i[:, drop:], q[:, drop:]
    sums = torch.sum(torch.sqrt(i * i + q * q), dim=-1).double()
    total = psum(torch.cat([sums, sums.new_tensor([i.shape[1]])]), mesh, TIME_AXIS)
    return rx.gate(audio, total[:-1] / total[-1])


__all__ = ["chain_halo", "sharded_chain", "sharded_chain_planar", "wideband_halo",
           "sharded_wideband"]
