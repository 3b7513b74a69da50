#!/usr/bin/env python3
"""Design A/Bs of B1 (the windowed averager) and B13 (the unrolled SOS cascade), on one card.

    python3 tools/ab_windowed_b13.py

B1 on 64M int16 samples at k=1024, C=2: its two halo sources (spans of one
wave of resident blocks, the wrapper's, against spans of 1, 2 and 4 tiles,
each span scanning the H samples before it), and where its time goes:
variants of ``run_tile.cuh`` built with ``windowed.cu`` with the in-tile scan
or the window pass left out (``tools/ab_fir3_scan.py``'s hooks), and B3's
Hillis-Steele kernel beside it. B13 on 16 x 2^22 float32 through
butter(8, 0.1), 4 sections: variants of ``iir.cu`` with the sections of its
cascade unrolled (with or without every section's coefficients held in
registers), other launch bounds, or a phase left out, beside B12 (the same
pass with the count read at run time). A variant that leaves a part out computes a wrong
result: it is a timing of what remains, never a port; the others are
checked against the plain versions first. Times are CUDA events, 20 calls
after 5 warm-ups in two rounds, the variants in turns. Needs a CUDA device
and nvcc.
"""

from __future__ import annotations

import shutil
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from _ab import ROOT, bind, build, card, patched, timed
from ab_fir3_scan import NEW_SCAN_HOOKS

from digital_signal_processsing_tpu_torch import _build  # noqa: E402
from digital_signal_processsing_tpu_torch.ops import iir  # noqa: E402
from digital_signal_processsing_tpu_torch.ops import pallas_scan as ps  # noqa: E402
from digital_signal_processsing_tpu_torch.ops.scan_xla import moving_average_xla  # noqa: E402

CSRC = ROOT / "digital_signal_processsing_tpu_torch" / "csrc"
N, K, C = 64 * 2**20, 1024, 2
B1_VARIANTS = {"B1": {"AB_MODE": 0}, "B1 without the in-tile scan": {"AB_MODE": 1},
               "B1 without the window pass": {"AB_MODE": 2}, "B1 load and store only": {"AB_MODE": 3}}
B13_HOOKS = [
    ("  for (int i = tid; i < S * kTabL; i += kLbThreads) stab[i] = tab[i];\n",
     "  for (int i = tid; i < S * kTabL; i += kLbThreads) stab[i] = tab[i];\n#if AB_REGCOEF\n"
     "  Coef ab_co[NS > 0 ? NS : 1];\n#pragma unroll\n"
     "  for (int k = 0; k < NS; ++k) ab_co[k] = coef_of(tab + k * kTabL);\n#endif\n"),
    ("#pragma unroll 1\n      for (int k = 0; k < S; ++k) {\n        float* eb",
     "#if AB_UNROLL\n#pragma unroll\n#else\n#pragma unroll 1\n#endif\n"
     "      for (int k = 0; k < ((AB_MODE & 4) ? 0 : S); ++k) {\n        float* eb"),
    ("        lb_section<SEG>(v, stab + k * kTabL, coef_of(stab + k * kTabL), scar + warp * D + 2 * k,\n",
     "#if AB_REGCOEF\n        lb_section<SEG>(v, stab + k * kTabL, ab_co[k], scar + warp * D + 2 * k,\n"
     "#else\n        lb_section<SEG>(v, stab + k * kTabL, coef_of(stab + k * kTabL), scar + warp * D + 2 * k,\n"
     "#endif\n"),
    ("__launch_bounds__(kLbThreads, 3)\nsos_lookback_kernel(",
     "__launch_bounds__(kLbThreads, AB_MINB)\nsos_lookback_kernel("),
    ("    if (!last) {\n      const int comp", "    if (!last && !(AB_MODE & 1)) {\n      const int comp"),
]
B13_DEFAULTS = {"AB_REGCOEF": 0, "AB_UNROLL": 0, "AB_MINB": 3, "AB_MODE": 0}
B13_VARIANTS = {
    "B13": {},
    "B13 sections unrolled": {"AB_UNROLL": 1},
    "B13 sections unrolled, coefficients in registers": {"AB_UNROLL": 1, "AB_REGCOEF": 1},
    "B13 2 blocks an SM": {"AB_MINB": 2},
    "B13 without B (end state)": {"AB_MODE": 1},
    "B13 without D's sections": {"AB_MODE": 4},
    "B13 stage and store only": {"AB_MODE": 5},
}


def b1_call(lib, x, y, span):
    g = ps.windowed_geometry(K, C)
    tiles = g.tiles(x.numel())
    if span is None:
        span = g.range_span(tiles, ps._resident(x.device, g))
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.dsp_windowed_i16_range(x.data_ptr(), y.data_ptr(), None, x.numel(), K, C,
                                         g.kernel_c, g.nrun, 0, tiles, span, g.smem_bytes, stream)
        if err:
            raise RuntimeError(f"dsp_windowed_i16_range: CUDA error {err}")
        return y

    return run


def b13_call(lib, x, rows, y):
    c, t = x.shape
    s = rows.shape[0]
    tile = iir.lookback_tile(c, t)
    tab, mats = iir._lookback_tables(rows.tobytes(), tile, str(x.device))
    rec = torch.empty(1 + 2 * c * (-(-t // tile)) * 2 * s, dtype=torch.int64, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.dsp_sos_unrolled(x.data_ptr(), y.data_ptr(), tab.data_ptr(), mats.data_ptr(),
                                   rec.data_ptr(), t, c, s, tile, stream)
        if err:
            raise RuntimeError(f"dsp_sos_unrolled: CUDA error {err}")
        return y

    return run


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    print(f"card: {card()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    tmp = Path(tempfile.mkdtemp())
    try:
        work = tmp / "csrc"
        shutil.copytree(CSRC, work)
        patched(CSRC / "run_tile.cuh", NEW_SCAN_HOOKS, work)
        iir_src = patched(CSRC / "iir.cu", B13_HOOKS, work)
        jobs = {name: (work / "windowed.cu", {"AB_MINB": 4, **d}, tmp / f"b1_{i}.so")
                for i, (name, d) in enumerate(B1_VARIANTS.items())}
        jobs.update({name: (iir_src, {**B13_DEFAULTS, **d}, tmp / f"b13_{i}.so")
                     for i, (name, d) in enumerate(B13_VARIANTS.items())})
        with ThreadPoolExecutor(8) as pool:
            built = dict(zip(jobs, pool.map(lambda j: build(*j), jobs.values())))

        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.integers(-32768, 32768, size=N, dtype=np.int16)).cuda()
        want = moving_average_xla(x, K, C)
        runs, keep = {}, []
        for name in B1_VARIANTS:
            lib = bind(built[name], "dsp_windowed_i16_range", _build._SIGNATURES["dsp_windowed_i16_range"])
            for span in ((None, 1, 2, 4) if name == "B1" else (None,)):
                y = torch.empty_like(x)
                keep.append((lib, y))
                run = b1_call(lib, x, y, span)
                if B1_VARIANTS[name]["AB_MODE"] == 0 and not torch.equal(run(), want):
                    raise AssertionError(f"{name} spans of {span}: differs from plain")
                label = "spans of one wave" if span is None else f"spans of {span} tiles"
                runs[f"{name}, {label}"] = run
        runs["B3 hillis_steele (the same tile, no seed or range)"] = \
            lambda: ps.scan_averager(x, K, C, variant="hillis_steele")
        print(f"B1 variants, 64M int16, k={K}, C={C}; ms median (min-max) of 40:")
        for name, (med, lo, hi) in timed(runs).items():
            print(f"  {name:60s} {med:.4f} ({lo:.4f}-{hi:.4f})")
        del runs, keep, want, x

        xf = torch.from_numpy(rng.standard_normal((16, 1 << 22), dtype=np.float32)).cuda()
        rows = iir._sos_rows(iir.design_butterworth(8, 0.1))
        want = iir._sos_plain(xf, rows, None)[0]
        runs, keep = {}, []
        for name, d in B13_VARIANTS.items():
            lib = bind(built[name], "dsp_sos_unrolled", _build._SIGNATURES["dsp_sos_unrolled"])
            y = torch.empty_like(xf)
            keep.append((lib, y))
            run = b13_call(lib, xf, rows, y)
            if d.get("AB_MODE", 0) == 0:
                err = ((run() - want).abs().max() / want.abs().max()).item()
                if not err < 1e-5:
                    raise AssertionError(f"{name}: {err:.3e} of max|y| from plain")
            runs[name] = run
        runs["B12 (the count at run time)"] = lambda: iir.sos_cascade(xf, rows)
        print("B13 variants, 16 x 2^22 float32, butter(8, 0.1), 4 sections; ms median (min-max) of 40:")
        for name, (med, lo, hi) in timed(runs).items():
            print(f"  {name:60s} {med:.4f} ({lo:.4f}-{hi:.4f})")
        for name, so in built.items():  # the compiler's report of each B13 variant at NS = 4
            if name.startswith("B13"):
                print(f"  {name}: registers, local bytes, shared bytes, blocks an SM "
                      f"{attrs(so)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def attrs(so: Path) -> tuple:
    import ctypes

    lib = bind(so, "dsp_sos_attrs", _build._SIGNATURES["dsp_sos_attrs"])
    out = (ctypes.c_int64 * 4)()
    if lib.dsp_sos_attrs(4, iir.lookback_tile(16, 1 << 22), 1, ctypes.addressof(out)):
        raise RuntimeError("dsp_sos_attrs failed")
    return tuple(out)


if __name__ == "__main__":
    sys.exit(main())
