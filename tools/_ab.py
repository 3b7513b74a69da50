"""Helpers shared by the A/B scripts under ``tools/``: patched copies of a
kernel source, their nvcc builds, and CUDA-event timings on one card.

A variant is a copy of a source with hooks: (anchor, replacement) pairs,
each anchor found exactly once, and ``-D`` defines that the hooks read.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from digital_signal_processsing_tpu_torch import _build  # noqa: E402


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def patched(src: Path, hooks, out: Path) -> Path:
    """``src`` with each hook applied, written into directory ``out``."""
    text = src.read_text()
    for old, new in hooks:
        if text.count(old) != 1:
            raise RuntimeError(f"{src.name}: hook anchor found {text.count(old)} times: {old[:60]!r}")
        text = text.replace(old, new)
    dst = out / src.name
    dst.write_text(text)
    return dst


def build(src: Path, defines: dict, so: Path) -> Path:
    """nvcc ``src`` into the shared library ``so`` with the package's flags and ``defines``."""
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(src),
           *(f"-D{k}={v}" for k, v in defines.items())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {so.name}:\n{res.stdout}{res.stderr}")
    return so


def bind(so: Path, name: str, argtypes) -> ctypes.CDLL:
    """The library ``so`` with its entry ``name`` typed as ``argtypes``, returning int."""
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib


def device_ms(fn, reps: int = 20) -> list[float]:
    """Device ms of each of ``reps`` calls of ``fn`` after 5 warm-ups, by CUDA events."""
    for _ in range(5):
        fn()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    events[0].record()
    for ev in events[1:]:
        fn()
        ev.record()
    events[-1].synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def timed(runs: dict, reps: int = 20) -> dict:
    """{name: (median, min, max)} of 2 * ``reps`` calls each: two rounds, in turns
    forward and back."""
    got = {name: [] for name in runs}
    for name in (*runs, *reversed(runs)):
        got[name] += device_ms(runs[name], reps)
    return {k: (statistics.median(v), min(v), max(v)) for k, v in got.items()}
