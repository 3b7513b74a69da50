"""The receiver chain's causal memory, for the halo of chunked and sharded runs.

Counterpart of ``chain_halo`` in
``digital_signal_processsing_tpu/parallel/pipeline.py``. The sharded chain
itself (``sharded_chain``, time over cards with one halo exchange) waits for
the multi-card slice.
"""

from __future__ import annotations

from ..utils.layout import round_up


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


__all__ = ["chain_halo"]
