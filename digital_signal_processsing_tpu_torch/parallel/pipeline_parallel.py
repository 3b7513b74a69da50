"""Pipeline parallelism: a streaming FIR cascade staged across ranks.

Counterpart of ``digital_signal_processsing_tpu/parallel/pipeline_parallel.py``.
S filter stages, one a rank of the time axis; microbatches (consecutive
chunks of one stream) flow left to right, one send and receive a tick: a
GPipe schedule where the model is the cascade and the activations are audio
chunks. Each stage carries its streaming FIR tail across microbatches, so
the result is the cascade over the unchunked stream.

Ticks t = 0 .. m+S-2; rank d filters microbatch t-d when 0 <= t-d < m. The
last stage keeps its outputs, and a final sum over the axis (every other
rank adds zeros) gives every rank the result.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fir import fir_direct
from .mesh import TIME_AXIS, Mesh, psum, shift_right


def _stage_body(taps: torch.Tensor, x_chunks: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    s, d = mesh.n_time, mesh.t
    m, c, L = x_chunks.shape
    k = taps.shape[-1]
    recv = torch.zeros(c, L, dtype=torch.float32, device=x_chunks.device)
    tail = torch.zeros(c, k - 1, dtype=torch.float32, device=x_chunks.device)
    out = torch.zeros(m, c, L, dtype=torch.float32, device=x_chunks.device)
    for t in range(m + s - 1):
        y = torch.zeros_like(recv)
        if 0 <= t - d < m:  # this stage's microbatch t - d
            act_in = x_chunks[t] if d == 0 else recv
            ext = torch.cat([tail, act_in], dim=-1)
            y = fir_direct(ext, taps)[..., k - 1 :]
            tail = ext[..., L:]
            if d == s - 1:
                out[t - d] = y
        recv = shift_right(y, mesh, TIME_AXIS)  # to the next stage for the next tick
    return psum(out if d == s - 1 else torch.zeros_like(out), mesh, TIME_AXIS)


def pipelined_fir_cascade(x_chunks, stage_taps, *, mesh: Mesh) -> torch.Tensor:
    """Apply a cascade of FIR stages, one stage a rank of the time axis, pipelined.

    ``x_chunks``: (microbatches, channels, chunk_len) float32, consecutive
    chunks of a continuous stream (every rank passes it; rank 0 reads it).
    ``stage_taps``: (num_stages, taps), num_stages the time axis's size.
    Returns the cascaded chunks on every rank, on ``x_chunks``'s device (or
    the mesh's, for NumPy input).
    """
    s = mesh.n_time
    if np.shape(stage_taps)[0] != s:
        raise ValueError(f"{np.shape(stage_taps)[0]} stages != {s} devices on the pp axis")
    dev = x_chunks.device if isinstance(x_chunks, torch.Tensor) else mesh.device
    x = torch.as_tensor(x_chunks, dtype=torch.float32, device=dev)
    if x.dim() != 3:
        raise ValueError(f"x_chunks must be (microbatches, channels, chunk_len), got {tuple(x.shape)}")
    if isinstance(stage_taps, torch.Tensor):
        taps = stage_taps[mesh.t]
    else:
        taps = torch.from_numpy(np.asarray(stage_taps, np.float32)[mesh.t])
    taps = taps.to(device=dev, dtype=torch.float32)
    return _stage_body(taps, x, mesh)


__all__ = ["pipelined_fir_cascade"]
