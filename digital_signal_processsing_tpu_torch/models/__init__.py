from .adaptive import estimate_tone_frequency, notch_rows, tracking_notch  # noqa: F401
from .averager_zoo import AVERAGER_ZOO, VariantInfo, run_variant  # noqa: F401
from .chain import (  # noqa: F401
    ChainConfig,
    ChainStreamState,
    DspChain,
    chain_from_jax,
    chain_state_from_jax,
    chain_stream_chunk,
    chain_stream_init,
)
from .wideband import WidebandConfig, WidebandFmReceiver, wideband_from_jax  # noqa: F401

__all__ = [
    "estimate_tone_frequency",
    "notch_rows",
    "tracking_notch",
    "AVERAGER_ZOO",
    "VariantInfo",
    "run_variant",
    "ChainConfig",
    "ChainStreamState",
    "DspChain",
    "chain_from_jax",
    "chain_state_from_jax",
    "chain_stream_chunk",
    "chain_stream_init",
    "WidebandConfig",
    "WidebandFmReceiver",
    "wideband_from_jax",
]
