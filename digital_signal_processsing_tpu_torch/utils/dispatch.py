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

import torch

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


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise where a float kernel would drop an autograd graph (ROADMAP §3 F3).

    A ctypes launch returns tensors with no graph, so a loss through it would
    get no gradient from the stage and nothing would say so. Each float
    kernel wrapper calls this on its kernel branch with the data, taps, rows,
    seeds and states it hands the kernel; ``None`` and non-tensors are
    skipped. Under ``torch.no_grad()`` nothing is refused, and the plain
    versions on the CPU carry the graph as they always did.
    """
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.requires_grad:
            raise NotImplementedError(
                f"{kernel} has no backward (ROADMAP §3 F3): an input requires a gradient "
                "in grad mode; detach it, call under torch.no_grad(), or run on the CPU, "
                "whose plain version carries the graph"
            )


__all__ = ["record_choice", "last_choice", "choices", "refuse_grad"]
