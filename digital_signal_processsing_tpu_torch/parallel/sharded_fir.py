"""Time-sharded FIR by overlap-save halo exchange.

Counterpart of ``digital_signal_processsing_tpu/parallel/sharded_fir.py``.
Each rank filters its time block after receiving the last ``k - 1`` samples
of its left neighbour (rank 0 receives zeros: the causal start), and drops
the halo's outputs: overlap-save lifted from blocks to ranks. Channels shard
over ``ch`` untouched.

The reference keeps a cache of jitted programs that close over concrete
taps, so that its ``auto`` ladder can reach the fused kernel; PyTorch runs
eagerly and ``fir_filter`` sees the taps as they are, so ``auto`` takes B8
(or B9) above the crossover with no cache.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fir import fir_direct, fir_filter, fir_overlap_save
from .mesh import TIME_AXIS, Mesh, shift_right

METHODS = ("auto", "direct", "overlap_save")


def _shard_body(xs: torch.Tensor, taps, mesh: Mesh, method: str) -> torch.Tensor:
    k = int(taps.shape[0])
    ext = xs
    if k > 1:
        halo = shift_right(xs[..., -(k - 1) :].contiguous(), mesh, TIME_AXIS)
        ext = torch.cat([halo, xs], dim=-1)
    if method == "direct":
        y = fir_direct(ext, taps)
    elif method == "auto":
        y = fir_filter(ext, taps, method="auto")
    else:
        y = fir_overlap_save(ext, taps)
    return y[..., k - 1 :]


def sharded_fir_filter(x: torch.Tensor, taps, *, mesh: Mesh, method: str = "auto") -> torch.Tensor:
    """Causal FIR of this rank's block of a (channels, time) or (time,) signal.

    ``x``: this rank's shard, (channels over ``ch``, time over ``t``), the
    same length on every rank of the time axis; taps - 1 must fit in one
    time shard (single-hop halo). ``method='auto'`` runs each shard through
    :func:`fir_filter`'s ladder; ``'direct'`` and ``'overlap_save'`` are the
    reference's A/B spellings.
    """
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; options {METHODS}")
    k = int(np.shape(taps)[0])
    t_loc = x.shape[-1]
    if k - 1 > t_loc:
        raise ValueError(f"taps-1 = {k - 1} exceeds one time shard ({t_loc})")
    return _shard_body(x, taps, mesh, method)


__all__ = ["sharded_fir_filter"]
