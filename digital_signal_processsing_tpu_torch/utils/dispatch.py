"""Dispatch observability: which route did ``method='auto'`` take?

The averager's routes are all bit-exact but differ in cost (the windowed
kernel against the two-pass fallback), so a silent switch reads as a
regression with nothing to point at. Dispatchers record their choice here:

- ``last_choice(op)`` returns the most recent route an op dispatched to;
- ``choices()`` snapshots the whole table;
- with ``DSP_TPU_LOG_DISPATCH=1`` each change of choice is printed to stderr.

The op and route names are those of the reference package, so a caller can
compare the two packages' routes directly.
"""

from __future__ import annotations

import os
import sys
import threading

_lock = threading.Lock()
_choices: dict[str, str] = {}


def record_choice(op: str, method: str) -> None:
    """Called by dispatchers after resolving ``auto`` (or an explicit method)."""
    with _lock:
        changed = _choices.get(op) != method
        _choices[op] = method
    if changed and os.environ.get("DSP_TPU_LOG_DISPATCH"):
        print(f"[dsp dispatch] {op} -> {method}", file=sys.stderr)


def last_choice(op: str) -> str | None:
    """Most recent method dispatched for ``op`` (None if never called)."""
    with _lock:
        return _choices.get(op)


def choices() -> dict[str, str]:
    """Snapshot of every op's most recent dispatch choice."""
    with _lock:
        return dict(_choices)


__all__ = ["record_choice", "last_choice", "choices"]
