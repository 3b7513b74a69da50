from .direct_xla import moving_average_reduce_window  # noqa: F401
from .moving_average import METHODS, moving_average  # noqa: F401
from .pallas_direct import MAX_DIRECT_WINDOW, direct_averager  # noqa: F401
from .pallas_scan import (  # noqa: F401
    SCAN_VARIANTS,
    cumsum,
    moving_average_two_pass,
    scan_averager,
    windowed_averager,
    windowed_averager_packed,
)
from .scan_xla import cumsum_ref, moving_average_xla  # noqa: F401
from .streaming import (  # noqa: F401
    MovingAverageState,
    moving_average_chunk,
    moving_average_init,
    state_from_jax,
)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel of csrc/ since the last reset, B3 by variant."""
    return {
        "B1": windowed_averager.launches,
        "B2": windowed_averager_packed.launches,
        **{f"B3/{v}": n for v, n in scan_averager.launches.items()},
        "B4": cumsum.launches,
        "B5": direct_averager.launches,
    }


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in (windowed_averager, windowed_averager_packed, cumsum, direct_averager):
        fn.launches = 0
    scan_averager.launches = dict.fromkeys(SCAN_VARIANTS, 0)
