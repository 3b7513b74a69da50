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
"""

from __future__ import annotations

import torch

from ..utils.layout import round_up
from .mesh import TIME_AXIS, Mesh, shift_right


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


__all__ = ["chain_halo", "sharded_chain", "sharded_chain_planar"]
