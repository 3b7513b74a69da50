"""Plain PyTorch direct averager: the ``xla_direct`` anchor.

Counterpart of ``digital_signal_processsing_tpu/ops/direct_xla.py``, which
computes the O(N*k) direct window sum with ``lax.reduce_window`` (the
reference's profilable_parallel_averager.cu:13-23 as a first, compiler-
scheduled spelling). Here it is ``window`` shifted adds on the
``(frames, channels)`` view, in int32. It launches no kernel of this
package; it is also the plain version of the direct kernel (B5).
"""

from __future__ import annotations

import torch

from ..utils.numerics import trunc_div


def moving_average_reduce_window(x: torch.Tensor, window: int, channels: int = 1) -> torch.Tensor:
    """Causal box sum as shifted adds on the (frames, channels) view.

    int32 is exact: |window sum| <= 65535 * 32768 < 2^31.
    """
    frames = x.numel() // channels
    xi = x.reshape(frames, channels).to(torch.int32)
    wsum = xi.clone()
    for j in range(1, min(window, frames)):
        wsum[j:] += xi[:-j]
    return trunc_div(wsum, window).to(torch.int16).reshape(-1)


__all__ = ["moving_average_reduce_window"]
