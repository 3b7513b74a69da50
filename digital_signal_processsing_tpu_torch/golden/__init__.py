from .reference import (  # noqa: F401
    cumsum_per_channel_golden,
    moving_average_golden,
    moving_average_golden_loop,
)

__all__ = [
    "moving_average_golden",
    "moving_average_golden_loop",
    "cumsum_per_channel_golden",
]
