"""The device a caller names, checked before any work is placed on it."""

from __future__ import annotations

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


__all__ = ["resolve_device"]
