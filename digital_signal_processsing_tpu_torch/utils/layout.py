"""Shape arithmetic shared by the wrappers and the kernels' launch geometry."""

from __future__ import annotations

from .numerics import MAX_EXACT_WINDOW


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x``."""
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def validate_window(window: int, max_window: int | None = None) -> None:
    bound = MAX_EXACT_WINDOW if max_window is None else max_window
    if not (1 <= window <= bound):
        raise ValueError(
            f"window must be in [1, {bound}] for exact int32 modular scans, "
            f"got {window}"
        )


__all__ = ["round_up", "cdiv", "validate_window"]
