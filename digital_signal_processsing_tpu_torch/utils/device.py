"""The device a caller names, checked before any work is placed on it."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising if it names CUDA and there is no card.

    Nothing on the averager's path moves to the CPU on its own: a caller who
    wants the CPU passes ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def as_tensor(x, device="cuda") -> torch.Tensor:
    """A tensor stays where it is; anything else goes to ``device``, checked by
    :func:`resolve_device` (so NumPy input and the default raise without a card)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def as_planar(i, q, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Planar (i, q) as float32 tensors on one device: ``i``'s where it is a
    tensor, else ``device`` (see :func:`as_tensor`)."""
    i = as_tensor(i, device).to(torch.float32)
    return i, as_tensor(q, i.device).to(i.device, torch.float32)


__all__ = ["as_planar", "as_tensor", "resolve_device"]
