"""The reference's twelve example scripts, through the port's API.

Each module is the counterpart of ``examples/<same name>.py``: the same NumPy
seeds, sizes and anchors, with the same ``ok``/``OK``/``PASS``/``MISS``
wording. Each takes ``--device`` (``cuda`` by default, ``cpu`` for the plain
PyTorch path), prints ``MISS`` for an anchor that fails and then exits
non-zero:

    python -m digital_signal_processsing_tpu_torch.examples.fm_receiver --device cpu

``main(argv)`` runs one in-process and returns its exit code.
"""

from __future__ import annotations

import argparse

import torch

from ..utils.device import resolve_device

NAMES = (
    "filter_and_analyze",
    "fm_receiver",
    "wideband_scanner",
    "design_filterbank",
    "production_pipeline",
    "control_design",
    "speech_pipeline",
    "radar_rangedoppler",
    "radar_tracker",
    "qam_link",
    "doa_scanner",
    "audio_timestretch",
)


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with ``--device``, described by the first line of ``doc``."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def device_of(args: argparse.Namespace) -> torch.device:
    """The device ``--device`` names, checked (``cuda`` without a card raises)."""
    return resolve_device(args.device)


class Anchors:
    """The example's anchors: each that fails prints ``MISS: <what>``."""

    def __init__(self) -> None:
        self.missed: list[str] = []

    def check(self, ok, what: str) -> bool:
        if not bool(ok):
            self.missed.append(what)
            print(f"MISS: {what}")
        return bool(ok)

    def exit_code(self) -> int:
        return 1 if self.missed else 0


__all__ = ["NAMES", "Anchors", "device_of", "parser"]
