from .adaptive import (  # noqa: F401
    AdaptiveFir,
    estimate_tone_frequency,
    identify_system,
    lms_train_step,
    make_sharded_train_step,
    nlms,
    notch_rows,
    opt_state_from_optax,
    rls,
    tracking_notch,
)
from . import adaptive  # noqa: F401
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
from .ofdm import OfdmConfig, OfdmReceiver  # noqa: F401
from .modem import ModemConfig  # noqa: F401
from . import modem  # noqa: F401
from .radar import RadarConfig  # noqa: F401
from . import radar  # noqa: F401
from .beamform import ArrayConfig  # noqa: F401
from . import beamform  # noqa: F401
from .tracking import TrackerConfig, tracker_state_from_jax  # noqa: F401
from . import tracking  # noqa: F401

__all__ = [
    "AdaptiveFir",
    "adaptive",
    "identify_system",
    "lms_train_step",
    "make_sharded_train_step",
    "nlms",
    "opt_state_from_optax",
    "rls",
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
    "ArrayConfig",
    "beamform",
    "TrackerConfig",
    "tracker_state_from_jax",
    "tracking",
    "ModemConfig",
    "modem",
    "RadarConfig",
    "radar",
    "OfdmConfig",
    "OfdmReceiver",
]
