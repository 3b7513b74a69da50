"""The time-varying IIR and LPC synthesis with channels over ``ch``.

Counterpart of ``digital_signal_processsing_tpu/parallel/sharded_tv.py``.
Both ops are independent across their stream axis (per-channel coefficient
schedules, per-stream LPC frames), so the sharded spelling has NO
collectives: each rank runs the one-card op (B16-B18, B22 on the card) on
its channel shard, and the result equals the unsharded op's rows. Ranks of
one channel shard along ``t`` repeat the same work, as the reference's
``shard_map`` replicates it over the time axis.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import iir, lpc
from .mesh import Mesh


def sharded_sosfilt_tv(sos_t, x: torch.Tensor, *, mesh: Mesh, tile_rows: int = 256) -> torch.Tensor:
    """:func:`ops.iir.sosfilt_tv` on this rank's channel shard.

    ``x``: this rank's (channels, T) shard; ``sos_t``: (S, T, 6), shared by
    every channel, or (S, channels, T, 6), this rank's shard of a
    per-channel schedule.
    """
    if x.dim() != 2:
        raise ValueError(f"expected (channels, time), got shape {tuple(x.shape)}")
    shape = np.shape(sos_t)
    if len(shape) not in (3, 4):
        raise ValueError("sos_t must be (S, T, 6) or (S, C, T, 6)")
    if len(shape) == 4 and shape[1] != x.shape[0]:
        raise ValueError(
            f"a per-channel schedule shards with the channels: {shape[1]} rows for "
            f"{x.shape[0]} channels of this rank (mesh ch-axis {mesh.n_channel})"
        )
    return iir.sosfilt_tv(sos_t, x, tile_rows=tile_rows)


def sharded_lpc_synthesis(a, gain, excitation: torch.Tensor, frame_len: int, *,
                          mesh: Mesh) -> torch.Tensor:
    """:func:`ops.lpc.lpc_synthesis` on this rank's shard of the stream axis.

    ``a``: (streams, F, p+1), ``gain``: (streams, F), ``excitation``:
    (streams, F*frame_len), each this rank's streams.
    """
    if np.shape(a)[0] != excitation.shape[0] or np.shape(gain)[0] != excitation.shape[0]:
        raise ValueError(
            f"a, gain and excitation must hold this rank's streams alike, got "
            f"{np.shape(a)[0]}, {np.shape(gain)[0]} and {excitation.shape[0]} "
            f"(mesh ch-axis {mesh.n_channel})"
        )
    return lpc.lpc_synthesis(a, gain, excitation, frame_len)


__all__ = ["sharded_sosfilt_tv", "sharded_lpc_synthesis"]
