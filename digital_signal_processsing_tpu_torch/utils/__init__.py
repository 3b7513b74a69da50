from . import layout, numerics  # noqa: F401
from .device import resolve_device  # noqa: F401
from .dispatch import choices, last_choice, record_choice  # noqa: F401
from .layout import cdiv, overlapping_frames, round_up, validate_window  # noqa: F401
from .numerics import MAX_EXACT_WINDOW, trunc_div, wrap_int32  # noqa: F401
