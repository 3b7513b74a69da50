#!/usr/bin/env python3
"""Design A/Bs of B12 (the one-pass SOS cascade) and B5 (the direct averager), on one card.

    python3 tools/ab_lookback_direct.py [OUT_DIR]

Builds variants of ``csrc/iir.cu`` and ``csrc/direct.cu`` with nvcc, each
from a copy of the sources with one design choice changed (a constant, the
launch bounds, a phase left out), and times them with CUDA events (20 calls
after 5 warm-ups, in two rounds, the variants in turns): B12 on 16 x 2^22
float32 through butter(8, 0.1), 4 sections (the IIR main path) and on
2 x 2^20 and 2 x 2^19 serving chunks, by tile; B5 on 64M int16 samples,
C=2, at k=64 and 256.
A variant that leaves a phase out computes a wrong result: it is a timing of
what remains, never a port. Writes each library's SASS opcode counts
(``cuobjdump``) to OUT_DIR where one is given. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from _ab import ROOT, bind, build, card, patched, timed

from digital_signal_processsing_tpu_torch import _build  # noqa: E402
from digital_signal_processsing_tpu_torch.ops import iir  # noqa: E402
from digital_signal_processsing_tpu_torch.ops import pallas_direct as pd  # noqa: E402

CSRC = ROOT / "digital_signal_processsing_tpu_torch" / "csrc"

# (anchor in the source, its replacement with the hook): each must occur once
IIR_HOOKS = [
    ("constexpr int kLbSeg = 16;", "constexpr int kLbSeg = AB_SEG;"),
    ("constexpr int kLbThreads = 256;", "constexpr int kLbThreads = AB_THREADS;"),
    ("constexpr int kMaxDepth = 8;", "constexpr int kMaxDepth = AB_DEPTH;"),
    ("return sections <= 8 ? 8 : 4;", "return sections <= 8 ? AB_DEPTH : 4;"),
    ("__launch_bounds__(kLbThreads, 3)\nsos_lookback_kernel(",
     "__launch_bounds__(kLbThreads, AB_MINB)\nsos_lookback_kernel("),
    ("    if (!last) {\n      const int comp", "    if (!last && !(AB_MODE & 1)) {\n      const int comp"),
    ("          while (!(zw[m] & kFlag)) {", "          while (!(AB_MODE & 2) && !(zw[m] & kFlag)) {"),
    ("          sb = lb_poll(srec", "          sb = (AB_MODE & 2) ? 0.0f : lb_poll(srec"),
    ("      for (int k = 0; k < S; ++k) {\n        float* eb",
     "      for (int k = 0; k < ((AB_MODE & 4) ? 0 : S); ++k) {\n        float* eb"),
]
IIR_HOOKS.append(("          lb_wait_for(keep - 1 - j);", "          lb_wait_for(AB_ALLWAIT ? 0 : keep - 1 - j);"))
IIR_DEFAULTS = {"AB_SEG": 16, "AB_DEPTH": 8, "AB_MINB": 3, "AB_MODE": 0, "AB_THREADS": 256,
                "AB_ALLWAIT": 0}
IIR_VARIANTS = {
    "B12": {},
    "B12 kSeg=32": {"AB_SEG": 32},
    "B12 128 threads": {"AB_THREADS": 128, "AB_MINB": 6},
    "B12 every sub-tile waited for at once": {"AB_ALLWAIT": 1},
    "B12 min 4 blocks": {"AB_MINB": 4},
    "B12 depth 16": {"AB_DEPTH": 16},
    "B12 without B (end state)": {"AB_MODE": 1},
    "B12 without the waits": {"AB_MODE": 2},
    "B12 without D's sections": {"AB_MODE": 4},
    "B12 stage and store only": {"AB_MODE": 7},
}
DIRECT_HOOKS = [
    ("constexpr int kAluSums = 12;", "constexpr int kAluSums = AB_ALU;"),
    ("    run_sums(planes + c * plane_words + q * kRunWords, k, one, acc);",
     "    run_sums(planes + c * plane_words + q * kRunWords, (AB_MODE & 2) ? 16 : k, one, acc);"),
]
DIRECT_DEFAULTS = {"AB_ALU": 12, "AB_MODE": 0}
DIRECT_VARIANTS = {
    "B5": {},
    "B5 every middle add on the ALU": {"AB_ALU": 16},
    "B5 10 sums on the ALU": {"AB_ALU": 10},
    "B5 13 sums on the ALU": {"AB_ALU": 13},
    "B5 14 sums on the ALU": {"AB_ALU": 14},
    "B5 at k=16's walk": {"AB_MODE": 2},
}
SIG_LOOKBACK = _build._SIGNATURES["dsp_sos_lookback"]
SIG_DIRECT = _build._SIGNATURES["dsp_direct_i16"]


def sass_counts(so: Path) -> dict:
    """{kernel: Counter of opcodes} for the library's kernels."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True).stdout
    counts, fn = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if m and fn:
            counts[fn][m.group(2).split(".")[0]] += 1
    return counts


def lookback_call(lib, x, rows, state, tile, v):
    """One B12 launch through ``lib``, its tables built for variant ``v`` (samples a
    thread, threads a block, look-back depth)."""
    saved = iir.LB_SEG, iir.LB_THREADS, iir.LB_SUB, iir.lookback_depth
    iir.LB_SEG, iir.LB_THREADS = v["AB_SEG"], v["AB_THREADS"]
    iir.LB_SUB = v["AB_SEG"] * v["AB_THREADS"]
    iir.lookback_depth = lambda sections: v["AB_DEPTH"] if sections <= 8 else 4
    try:
        tab = torch.from_numpy(iir.lookback_table(rows)).to(x.device)
        mats = torch.from_numpy(iir.lookback_mats(rows, tile)).to(x.device)
    finally:
        iir.LB_SEG, iir.LB_THREADS, iir.LB_SUB, iir.lookback_depth = saved
    c, t = x.shape
    s = rows.shape[0]
    y = torch.empty_like(x)
    end = None if state is None else torch.empty_like(state)
    rec = torch.empty(1 + 2 * c * (-(-t // tile)) * 2 * s, dtype=torch.int64, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.dsp_sos_lookback(
            x.data_ptr(), y.data_ptr(), tab.data_ptr(), mats.data_ptr(),
            None if state is None else state.data_ptr(), None if end is None else end.data_ptr(),
            rec.data_ptr(), t, c, s, tile, stream)
        if err:
            raise RuntimeError(f"dsp_sos_lookback: CUDA error {err}")
        return y

    return run


def direct_call(lib, x, k, c):
    g = pd.direct_geometry(k, c)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.dsp_direct_i16(x.data_ptr(), y.data_ptr(), x.numel(), k, c, g.tile_frames,
                                 g.plane_words, g.in_words, g.smem_bytes, stream)
        if err:
            raise RuntimeError(f"dsp_direct_i16: CUDA error {err}")
        return y

    return run


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else None
    print(f"card: {card()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    tmp = Path(tempfile.mkdtemp())
    try:
        work = tmp / "csrc"
        work.mkdir()
        shutil.copy(CSRC / "block_prefix.cuh", work)
        iir_src = patched(CSRC / "iir.cu", IIR_HOOKS, work)
        direct_src = patched(CSRC / "direct.cu", DIRECT_HOOKS, work)
        jobs = {}
        for i, (name, d) in enumerate(IIR_VARIANTS.items()):
            jobs[name] = (iir_src, {**IIR_DEFAULTS, **d}, tmp / f"iir{i}.so")
        for i, (name, d) in enumerate(DIRECT_VARIANTS.items()):
            jobs[name] = (direct_src, {**DIRECT_DEFAULTS, **d}, tmp / f"direct{i}.so")
        with ThreadPoolExecutor(8) as pool:
            built = dict(zip(jobs, pool.map(lambda j: build(*j), jobs.values())))
        libs = {}
        for name, so in built.items():
            b12 = name.startswith("B12")
            libs[name] = bind(so, *(("dsp_sos_lookback", SIG_LOOKBACK) if b12 else
                                    ("dsp_direct_i16", SIG_DIRECT)))
            if out is not None:
                out.mkdir(parents=True, exist_ok=True)
                with open(out / f"sass_{re.sub(r'[^A-Za-z0-9]+', '_', name)}.txt", "w") as f:
                    for kernel, cnt in sass_counts(so).items():
                        if "lookback" in kernel or "direct_kernel" in kernel:
                            f.write(f"{kernel} total {sum(cnt.values())}: {dict(cnt.most_common())}\n")
        if out is not None:
            tool = Path(_build._nvcc()).with_name("cuobjdump")
            for name, fn in (("B5", "_ZN3dsp13direct_kernelILi2EEEvPKsPslijiiii"),):
                listing = subprocess.run([str(tool), "-sass", "-fun", fn, str(built[name])],
                                         capture_output=True, text=True).stdout
                (out / f"listing_{name}.sass").write_text(listing)
        for name in ("B12", "B5"):
            for kernel, cnt in sass_counts(built[name]).items():
                if "lookback" in kernel or "direct_kernel" in kernel:
                    print(f"  {kernel[:60]} {sum(cnt.values())} instructions, top "
                          f"{cnt.most_common(14)}")

        rng = np.random.default_rng(0)
        rows = iir._sos_rows(iir.design_butterworth(8, 0.1))
        for c, t in ((16, 1 << 22), (2, 1 << 20), (2, 1 << 19)):
            x = torch.from_numpy(rng.standard_normal((c, t), dtype=np.float32)).cuda()
            st = torch.zeros(4, c, 2, device="cuda")
            want = iir._sos_plain(x, rows, st)[0]
            tiles = (iir.lookback_tile(c, t), 4096, 8192, 12288, 16384)
            runs = {}
            for name, d in IIR_VARIANTS.items():
                v = {**IIR_DEFAULTS, **d}
                more = {"B12": tiles, "B12 kSeg=32": (16384,), "B12 depth 16": (4096, 8192),
                        "B12 128 threads": (8192, 12288)}
                for tile in more.get(name, tiles[:1]):
                    run = lookback_call(libs[name], x, rows, st, tile, v)
                    if (d.get("AB_MODE", 0)) == 0:
                        err = ((run() - want).abs().max() / want.abs().max()).item()
                        if not err < 1e-5:
                            raise AssertionError(f"{name} tile {tile}: {err:.3e} from plain")
                    runs[f"{name} tile {tile}"] = run
            print(f"B12 variants, {c} x {t}, butter(8, 0.1), seeded; ms median (min-max) of 20:")
            for name, (med, lo, hi) in timed(runs, 10).items():
                print(f"  {name:40s} {med:.4f} ({lo:.4f}-{hi:.4f})")
        x = torch.from_numpy(rng.integers(-32768, 32768, size=64 * 2**20, dtype=np.int16)).cuda()
        for k in (64, 256):
            runs = {name: direct_call(libs[name], x, k, 2) for name in DIRECT_VARIANTS}
            want = runs["B5"]().clone()
            for name in DIRECT_VARIANTS:
                if DIRECT_VARIANTS[name].get("AB_MODE", 0) == 0 and not torch.equal(runs[name](), want):
                    raise AssertionError(f"{name} differs")
            print(f"B5 variants, 64M int16, C=2, k={k}; ms median (min-max) of 20:")
            for name, (med, lo, hi) in timed(runs, 10).items():
                print(f"  {name:40s} {med:.4f} ({lo:.4f}-{hi:.4f})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
