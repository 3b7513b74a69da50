from .moving_average import METHODS, moving_average  # noqa: F401
from .pallas_scan import (  # noqa: F401
    cumsum,
    moving_average_two_pass,
    windowed_averager,
    windowed_averager_packed,
)
from .scan_xla import cumsum_ref, moving_average_ref  # noqa: F401
from .streaming import (  # noqa: F401
    MovingAverageState,
    moving_average_chunk,
    moving_average_init,
    state_from_jax,
)
