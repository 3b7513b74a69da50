#!/usr/bin/env python3
"""B8 (the fused overlap-save FIR) of another checkout of the port against this one, on one card.

    python3 tools/ab_fused_fir.py OTHER_CHECKOUT [OUT_DIR]

Builds both packages' kernels, times B8 at 257 and 8193 taps on 16 x 2^22
float32 samples with CUDA events (20 calls after 5 warm-ups, six rounds in
turns other, this, this, other, other, this), and compares the SASS of
B8's nfft-16384 kernel in the two libraries (``cuobjdump``), writing each
listing to OUT_DIR where one is given. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import importlib
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from _ab import card, device_ms

KERNEL = "_ZN3dsp2b816fused_fir_kernelILi14EEEvPKfPfPK6float2xxxxx"  # fused_fir_kernel<14>


def load(root: Path):
    """The checkout's fft_mxu module and built library path."""
    for name in [k for k in sys.modules if k.startswith("digital_signal_processsing_tpu_torch")]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    try:
        fm = importlib.import_module("digital_signal_processsing_tpu_torch.ops.fft_mxu")
        build = importlib.import_module("digital_signal_processsing_tpu_torch._build")
        so = build.build()
        build.library()
    finally:
        sys.path.remove(str(root))
    return fm, so


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    out = Path(sys.argv[2]) if len(sys.argv) > 2 else None
    trees = {"other": load(Path(sys.argv[1]).resolve()), "this": load(Path(__file__).resolve().parents[1])}
    x = torch.randn(16, 1 << 22, device="cuda")
    rng = np.random.default_rng(0)
    times: dict = {}
    for k in (257, 8193):
        h = rng.normal(size=k).astype(np.float32)
        for who in ("other", "this", "this", "other", "other", "this"):
            fm = trees[who][0]
            r = fm.tap_response(h, fm.fused_geometry(k, fm.pick_fused_block(k)), "cuda")
            times.setdefault((k, who), []).extend(device_ms(lambda: fm.fused_fir(x, r)))
    print(card())
    for (k, who), t in sorted(times.items()):
        print(f"B8 k={k} {who}: median {statistics.median(t):.4f} ms "
              f"({min(t):.4f}-{max(t):.4f}) of {len(t)}")
    sass = {}
    for who, (_, so) in trees.items():
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        listing = subprocess.run([tool, "-sass", "-fun", KERNEL, str(so)],
                                 capture_output=True, text=True).stdout
        sass[who] = [ln.split("*/")[-1].strip() for ln in listing.splitlines() if "/*" in ln and ";" in ln]
        if out is not None:
            out.mkdir(exist_ok=True)
            (out / f"b8_sass_{who}.txt").write_text("\n".join(sass[who]))
    print(f"fused_fir_kernel<14>: {len(sass['this'])} instructions; SASS identical: "
          f"{sass['this'] == sass['other']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
