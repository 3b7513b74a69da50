#!/usr/bin/env python3
"""Where B9 (the four-step overlap-save FIR) and B3 (the scan averager) spend their time, on one card.

    python3 tools/ab_fir3_scan.py [--csrc DIR]

Builds variants of ``fused_fir3.cu`` and ``scan.cu`` (its tile in
``run_tile.cuh`` where the sources have one) with nvcc, each from a
copy of the sources in DIR (default: the package's ``csrc/``) with one part
of the kernel left out or one constant changed, and times them with CUDA
events (20 calls after 5 warm-ups, in two rounds, the variants in turns) at
the main path's shapes: B9 on 16 x 2^22 float32 at 8194 taps (nfft 131072),
B3 on 64M int16 samples at k=1024, C=2, in each of its three variants.

The sources may be either design the repository has had: the three
shared-memory launches of ``fft.cuh`` and the shared-memory tile scans
(``git archive 3125eff digital_signal_processsing_tpu_torch/csrc``), or the
register-resident redesign. The tool finds which from the sources and
applies that design's hooks; each design's launch geometry is computed
here. A variant that leaves a part out computes a wrong result: it is a
timing of what remains, never a port. The full kernels are checked against
the plain versions first. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from _ab import ROOT, bind, build, card, patched, timed

from digital_signal_processsing_tpu_torch import _build  # noqa: E402
from digital_signal_processsing_tpu_torch.ops import fft_mxu as fm  # noqa: E402
from digital_signal_processsing_tpu_torch.ops import pallas_scan as ps  # noqa: E402
from digital_signal_processsing_tpu_torch.ops.scan_xla import moving_average_xla  # noqa: E402
from digital_signal_processsing_tpu_torch.utils.layout import cdiv  # noqa: E402

FIR_C, FIR_T, FIR_K = 16, 1 << 22, 8194
SCAN_N, SCAN_K, SCAN_C = 64 * 2**20, 1024, 2
VARIANTS = ("blelloch", "hillis_steele", "mxu")

# ---- the shared-memory design (commit 3125eff: three launches through fft.cuh; tile scans)

OLD_FIR_HOOKS = [
    ("  fft_dif(buf, p.logn1, g1, tw, n2);", "  if (!(AB_MODE & 1)) fft_dif(buf, p.logn1, g1, tw, n2);"),
    ("  fft_dif(buf, p.logn2, g2, tw, n1);", "  if (!(AB_MODE & 1)) fft_dif(buf, p.logn2, g2, tw, n1);"),
    ("  ifft_dit(buf, p.logn2, g2, tw, n1);", "  if (!(AB_MODE & 1)) ifft_dit(buf, p.logn2, g2, tw, n1);"),
    ("  ifft_dit(buf, p.logn1, g1, tw, n2);", "  if (!(AB_MODE & 1)) ifft_dit(buf, p.logn1, g1, tw, n2);"),
    ("cmul(buf[slot(l, pos, p.logn1)], tw[i2 * f1]);",
     "cmul(buf[slot(l, pos, p.logn1)], tw[(AB_MODE & 2) ? (threadIdx.x & 63) : i2 * f1]);"),
    ("cmul_conj(buf[slot(l, i2, p.logn2)], tw[i2 * (f1_0 + l)]);",
     "cmul_conj(buf[slot(l, i2, p.logn2)], tw[(AB_MODE & 2) ? (threadIdx.x & 63) : i2 * (f1_0 + l)]);"),
]
OLD_FFT_HOOKS = [
    ("    const float2 w = tw[(j << (logM - 1 - s)) * stride];",
     "    const float2 w = tw[(AB_MODE & 2) ? (threadIdx.x & 63) : (j << (logM - 1 - s)) * stride];"),
    ("    const float2 w4 = tw[(f.j << (logM - 2 - t)) * stride];  // W_{4m}^j",
     "    const float2 w4 = tw[(AB_MODE & 2) ? (threadIdx.x & 63) : (f.j << (logM - 2 - t)) * stride];"),
    ("    const float2 w2 = tw[(f.j << (logM - 1 - t)) * stride];  // W_{2m}^j",
     "    const float2 w2 = tw[(AB_MODE & 2) ? ((threadIdx.x + 7) & 63) : (f.j << (logM - 1 - t)) * stride];"),
]
OLD_FIR_VARIANTS = {
    "B9": ({}, None),
    "B9 without the twiddle gathers": ({"AB_MODE": 2}, None),
    "B9 stage and store only": ({"AB_MODE": 3}, None),
    "B9 waves of 16 pairs": ({}, 16),
    "B9 waves of 32 pairs": ({}, 32),
    "B9 waves of 16 pairs, stage and store only": ({"AB_MODE": 3}, 16),
}
OLD_SCAN_HOOKS = [
    ("    if constexpr (kVariant == kBlelloch) {\n      tree_scan(res, tf, C);",
     "    if constexpr ((AB_MODE & 1) != 0) {\n    } else if constexpr (kVariant == kBlelloch) {\n"
     "      tree_scan(res, tf, C);"),
    ("        const uint32_t before = t >= H ? cum[t - H] : tail[t] - carry[t % C];",
     "        if constexpr ((AB_MODE & 2) != 0) {\n          y[g] = static_cast<int16_t>(cum[t]);\n"
     "          continue;\n        }\n"
     "        const uint32_t before = t >= H ? cum[t - H] : tail[t] - carry[t % C];"),
    ("    for (int j = threadIdx.x; j < H; j += blockDim.x) tail[j] =",
     "    for (int j = threadIdx.x; j < ((AB_MODE & 2) ? 0 : H); j += blockDim.x) tail[j] ="),
]
_P, _I = ctypes.c_void_p, ctypes.c_int64
# x, y, scratch, twiddles, permuted response, t, channels, k, block, log2n1, log2n2,
# g1, g2, wave_pairs, threads, smem_bytes, stream
OLD_FIR_SIGNATURE = (_P, _P, _P, _P, _P, *(_I,) * 11, _P)
# x, y, n, window, channels, variant, tile_frames, span_tiles, smem_bytes, stream
OLD_SCAN_SIGNATURE = (_P, _P, *(_I,) * 7, _P)
SCAN_MODES = {"": 0, " without the in-tile scan": 1, " without the window pass": 2,
              " load and store only": 3}


def old_fir_args(x, y, h, wave):
    """The shared-memory design's launch of dsp_fused_fir3 at 8194 taps: its geometry and permuted spectrum."""
    k = h.numel()
    block = fm.pick_fused_block(k)
    nfft = 1 << (block + k - 2).bit_length()
    l1 = (nfft.bit_length() - 1) // 2
    n1, n2 = 1 << l1, nfft >> l1
    g1, g2 = min(8192 // n1, n2), min(8192 // n2, n1)
    smem = 8 * max(g1 * (n1 + n1 // 16 + 1), g2 * (n2 + n2 // 16 + 1))
    c, t = x.shape
    pairs = cdiv(c * cdiv(t, block), 2)
    wave = min(pairs, wave or (1 << 28) // (8 * nfft))
    H = torch.fft.fft(h.double(), n=nfft).to(torch.complex64)
    q = np.zeros(n2, np.int64)
    for b in range(n2.bit_length() - 1):  # bit-reversed
        q |= ((np.arange(n2) >> b) & 1) << (n2.bit_length() - 2 - b)
    idx = (np.arange(n1)[:, None] + n1 * q[None, :]).reshape(-1)
    hp = H[torch.from_numpy(idx).to(x.device)].contiguous()
    tw = torch.from_numpy(np.exp(-2j * np.pi * np.arange(nfft) / nfft).astype(np.complex64)).to(x.device)
    scratch = torch.empty(wave * nfft, dtype=torch.complex64, device=x.device)
    keep = (hp, tw, scratch)
    args = (x.data_ptr(), y.data_ptr(), scratch.data_ptr(), tw.data_ptr(), hp.data_ptr(), t, c, k,
            block, l1, nfft.bit_length() - 1 - l1, g1, g2, wave, 256, smem)
    return args, keep


def old_scan_args(n, variant):
    """The shared-memory design's launch of dsp_scan_i16 at k=1024, C=2."""
    c, k = SCAN_C, SCAN_K
    tf = cdiv(8192, c)
    t = tf * c
    words = t + k * c + 2 * c
    extra = 0
    if variant == "hillis_steele":
        words += t
    elif variant == "mxu":
        words += (t // 16) * c
        extra = 256 + 2 * t
    smem = 4 * words + extra
    per_sm = max(1, min(8, 233472 // (smem + 1024)))
    tiles = cdiv(n, t)
    span = cdiv(tiles, max(1, min(tiles, 132 * per_sm)))
    return (n, k, c, ps.SCAN_VARIANTS[variant], tf, span, smem)


# ---- the register-resident design -------------------------------------------------

NEW_FIR_HOOKS = [
    ("  using L = Line<LOG>;\n  if constexpr (L::kWarp) {",
     "  using L = Line<LOG>;\n  if constexpr ((AB_MODE & 1) != 0) {\n  } else if constexpr (L::kWarp) {"),
    ("  float s, c;\n  sincospif(static_cast<float>(e) * two_over_n, &s, &c);",
     "  float s, c;\n  if constexpr ((AB_MODE & 2) != 0) {\n    s = 0.0f;\n    c = 1.0f + two_over_n * e;\n"
     "    return make_float2(c, s);\n  }\n  sincospif(static_cast<float>(e) * two_over_n, &s, &c);"),
    ("  extern __shared__ float2 buf[];  // H's rows, the staged rows, the plans' exchanges",
     "  if constexpr ((AB_MODE & 4) != 0) return;\n"
     "  extern __shared__ float2 buf[];  // H's rows, the staged rows, the plans' exchanges"),
    ("fir3_columns(const float* __restrict__ x, float2* __restrict__ scratch, Fir3 p) {\n",
     "fir3_columns(const float* __restrict__ x, float2* __restrict__ scratch, Fir3 p) {\n"
     "  if constexpr ((AB_MODE & 8) != 0) return;\n"),
    ("fir3_outputs(const float2* __restrict__ scratch, float* __restrict__ y, Fir3 p) {\n",
     "fir3_outputs(const float2* __restrict__ scratch, float* __restrict__ y, Fir3 p) {\n"
     "  if constexpr ((AB_MODE & 16) != 0) return;\n"),
    ('  asm volatile("cp.async.wait_group 1;\\n" ::: "memory");',
     '  asm volatile("cp.async.wait_group %0;\\n" ::"n"(AB_WAIT) : "memory");'),
    ("  static constexpr int kColBlocks = kColThreads > 256 ? 1 : 2;",
     "  static constexpr int kColBlocks = kColThreads > 256 ? 1 : AB_COLB;"),
    ("__launch_bounds__(256, 2)\nfir3_rows(", "__launch_bounds__(256, AB_ROWB)\nfir3_rows("),
    ("template <> struct Line<8> { static constexpr int P = 16, R0 = 16, R1 = 16, R2 = 0; "
     "static constexpr bool kWarp = true; };",
     "template <> struct Line<8> { static constexpr int P = 16, R0 = 16, R1 = 16, R2 = 0; "
     "static constexpr bool kWarp = AB_WARP8; };"),
    ("    const bool la = ga >= 0 && ga < p.t, lb = k.has_b && gb >= 0 && gb < p.t;",
     "    if constexpr ((AB_MODE & 32) != 0) continue;\n"
     "    const bool la = ga >= 0 && ga < p.t, lb = k.has_b && gb >= 0 && gb < p.t;"),
    ("      sc[static_cast<long long>(e / G) * n2",
     "      if constexpr ((AB_MODE & 64) != 0) continue;\n      sc[static_cast<long long>(e / G) * n2"),
    ("  static constexpr int G = T >= 32 ? 8 : 256 / T;", "  static constexpr int G = T >= 32 ? 8 : AB_COLS / T;"),
]
NEW_FIR_DEFAULTS = {"AB_MODE": 0, "AB_COLB": 2, "AB_ROWB": 2, "AB_WAIT": 1, "AB_COLS": 256,
                    "AB_WARP8": 1}
# name: (defines, scratch MB or None for the package's)
NEW_FIR_VARIANTS = {
    "B9": ({}, None),
    "B9 waves of 16 MB (in L2)": ({}, 16),
    "B9 waves of 32 MB (in L2)": ({}, 32),
    "B9 waves of 64 MB": ({}, 64),
    "B9 waves of 128 MB": ({}, 128),
    "B9 waves of 256 MB": ({}, 256),
    "B9 without the twiddles": ({"AB_MODE": 2}, None),
    "B9 without the line FFTs": ({"AB_MODE": 1}, None),
    "B9 stage and store only": ({"AB_MODE": 3}, None),
    "B9 without the row launch": ({"AB_MODE": 4}, None),
    "B9 without the column launch": ({"AB_MODE": 8}, None),
    "B9 without the output launch": ({"AB_MODE": 16}, None),
    "B9 3 blocks an SM (85 registers)": ({"AB_COLB": 3, "AB_ROWB": 3}, None),
    "B9 without the next task's prefetch": ({"AB_WAIT": 0}, None),
    "B9 32 columns a task (512 threads)": ({"AB_COLS": 512}, None),
    "B9 the column launch alone": ({"AB_MODE": 4 | 16}, None),
    "B9 the row launch alone": ({"AB_MODE": 8 | 16}, None),
    "B9 the output launch alone": ({"AB_MODE": 4 | 8}, None),
    "B9 the column launch alone, stage and store only": ({"AB_MODE": 3 | 4 | 16}, None),
    "B9 the column launch alone, stage and store only, no x": ({"AB_MODE": 3 | 4 | 16 | 32}, None),
    "B9 the column launch alone, stage and store only, no scratch": ({"AB_MODE": 3 | 4 | 16 | 64}, None),
    "B9 the column launch alone, no x and no scratch": ({"AB_MODE": 4 | 16 | 32 | 64}, None),
    "B9 rows at 1 block an SM (255 registers)": ({"AB_ROWB": 1}, None),
    "B9 256-point columns through shared memory (16 x 16)": ({"AB_WARP8": 0}, None),
    "B9 256-point columns through shared memory, 3 blocks an SM": ({"AB_WARP8": 0, "AB_COLB": 3}, None),
    "B9 the row launch alone, stage and store only": ({"AB_MODE": 3 | 8 | 16}, None),
    "B9 the output launch alone, stage and store only": ({"AB_MODE": 3 | 4 | 8}, None),
}
NEW_SCAN_HOOKS = [
    ("    // 2-3. in-run prefix, then the lanes' offsets chained over q",
     "#if (AB_MODE & 1) != 0\n    uint32_t off[kNQ][SL] = {};\n#else\n"
     "    // 2-3. in-run prefix, then the lanes' offsets chained over q"),
    ("    // 5. absolute prefixes into the ring", "#endif\n    // 5. absolute prefixes into the ring"),
    ("    // 6. cum[i] - cum[i - H], divided",
     "#if (AB_MODE & 2) != 0\n#pragma unroll\n    for (int q = 0; q < kNQ; ++q) {\n"
     "      int16_t o[kRun];\n#pragma unroll\n"
     "      for (int m = 0; m < kRun; ++m) o[m] = static_cast<int16_t>(v[q][m]);\n"
     "      store_run(a, y, t0 + static_cast<long long>((warp * kNQ + q) * 32 + lane) * kRun, o);\n"
     "    }\n#else\n    // 6. cum[i] - cum[i - H], divided"),
    ("      store_run(a, y, t0 + static_cast<long long>(run) * kRun, o);\n    }\n",
     "      store_run(a, y, t0 + static_cast<long long>(run) * kRun, o);\n    }\n#endif\n"),
    ("__launch_bounds__(kThreads, C >= 8 ? 3 : 4) scan_kernel(",
     "__launch_bounds__(kThreads, AB_MINB) scan_kernel("),
]
NEW_SCAN_DEFAULTS = {"AB_MODE": 0, "AB_MINB": 4}
NEW_SCAN_VARIANTS = {"": {}, " without the in-tile scan": {"AB_MODE": 1},
                     " without the window pass": {"AB_MODE": 2}, " load and store only": {"AB_MODE": 3},
                     " 3 blocks an SM (85 registers)": {"AB_MINB": 3}}


def new_fir_args(x, y, h, scratch_mb):
    """The launch of dsp_fused_fir3 at 8194 taps, at a scratch of ``scratch_mb``."""
    g = fm.fused_geometry(h.numel(), fm.pick_fused_block(h.numel()))
    r = fm.tap_response(h, g, x.device)
    c, t = x.shape
    saved = fm.FUSED3_SCRATCH_BYTES
    if scratch_mb:
        fm.FUSED3_SCRATCH_BYTES = scratch_mb << 20
    try:
        wave = g.wave(g.pairs(c, t))
    finally:
        fm.FUSED3_SCRATCH_BYTES = saved
    scratch = torch.empty(wave * g.nfft, dtype=torch.complex64, device=x.device)
    args = (x.data_ptr(), y.data_ptr(), scratch.data_ptr(), r.h_kernel.data_ptr(), t, c, g.k,
            g.block, g.log2n, wave)
    return args, (r, scratch)


def new_scan_args(n, variant, blocks_per_sm):
    """The launch of dsp_scan_i16 at k=1024, C=2, spans for ``blocks_per_sm``."""
    g = ps.scan_geometry(SCAN_K, SCAN_C, variant)
    span = g.span_tiles(n, blocks_per_sm * torch.cuda.get_device_properties(0).multi_processor_count)
    return (n, SCAN_K, SCAN_C, ps.SCAN_VARIANTS[variant], g.kernel_c, g.nrun, span, g.smem_bytes)


# ---- common ----------------------------------------------------------------------


def call(fn, args, stream):
    def run():
        err = fn(*args, stream)
        if err:
            raise RuntimeError(f"{fn.__name__}: CUDA error {err}")

    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path, default=ROOT / "digital_signal_processsing_tpu_torch" / "csrc")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    print(f"card: {card()}; torch {torch.__version__}, CUDA {torch.version.cuda}; sources {args.csrc}")
    old = "fir3_columns(const float* __restrict__ x, float2* __restrict__ scratch,\n             " \
          "const float2* __restrict__ tw" in (args.csrc / "fused_fir3.cu").read_text()
    print("design: " + ("the shared-memory one (three launches through fft.cuh, tile scans)" if old
                        else "the register-resident one (lines and tiles in registers)"))
    if old:
        fir_hooks, scan_hooks = OLD_FIR_HOOKS, OLD_SCAN_HOOKS
        fir_variants = {name: ({"AB_MODE": 0, **d}, wave) for name, (d, wave) in OLD_FIR_VARIANTS.items()}
        scan_variants = {suffix: {"AB_MODE": mode} for suffix, mode in SCAN_MODES.items()}
    else:
        fir_hooks, scan_hooks = NEW_FIR_HOOKS, NEW_SCAN_HOOKS
        fir_variants = {name: ({**NEW_FIR_DEFAULTS, **d}, mb) for name, (d, mb) in NEW_FIR_VARIANTS.items()}
        scan_variants = {suffix: {**NEW_SCAN_DEFAULTS, **d} for suffix, d in NEW_SCAN_VARIANTS.items()}
    tmp = Path(tempfile.mkdtemp())
    try:
        work = tmp / "csrc"
        shutil.copytree(args.csrc, work)
        if old:
            patched(args.csrc / "fft.cuh", OLD_FFT_HOOKS, work)
        fir_src = patched(args.csrc / "fused_fir3.cu", fir_hooks, work)
        # the register-resident design's tile lives in run_tile.cuh where the sources have one
        tile_src = args.csrc / "run_tile.cuh"
        if not old and tile_src.exists():
            patched(tile_src, scan_hooks, work)
            scan_src = work / "scan.cu"
        else:
            scan_src = patched(args.csrc / "scan.cu", scan_hooks, work)
        jobs = {}
        for i, (name, (d, _)) in enumerate(fir_variants.items()):
            jobs[name] = (fir_src, d, tmp / f"fir{i}.so")
        for i, (suffix, d) in enumerate(scan_variants.items()):
            jobs[f"B3{suffix}"] = (scan_src, d, tmp / f"scan{i}.so")
        with ThreadPoolExecutor(8) as pool:
            built = dict(zip(jobs, pool.map(lambda j: build(*j), jobs.values())))
        stream = torch.cuda.current_stream().cuda_stream

        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((FIR_C, FIR_T), dtype=np.float32)).cuda()
        h = torch.from_numpy((rng.standard_normal(FIR_K) / np.sqrt(FIR_K)).astype(np.float32)).cuda()
        g = fm.fused_geometry(FIR_K, fm.pick_fused_block(FIR_K))
        want = fm.overlap_save_plain(x, fm.tap_response(h, g, x.device))
        sig = (OLD_FIR_SIGNATURE if old else _build._SIGNATURES["dsp_fused_fir3"])
        runs, keep = {}, []
        for name, (d, wave) in fir_variants.items():
            lib = bind(built[name], "dsp_fused_fir3", sig)
            y = torch.empty_like(x)
            a, kept = (old_fir_args if old else new_fir_args)(x, y, h, wave)
            keep.append((lib, y, kept))
            runs[name] = call(lib.dsp_fused_fir3, a, stream)
            if d.get("AB_MODE", 0) == 0:
                runs[name]()
                err = ((y - want).abs().max() / want.abs().max()).item()
                if not err < 1e-5:
                    raise AssertionError(f"{name}: {err:.3e} of max|y| from plain")
        print(f"B9, {FIR_C} x {FIR_T} float32, k={FIR_K}; ms median (min-max) of 40:")
        for name, (med, lo, hi) in timed(runs).items():
            print(f"  {name:48s} {med:.4f} ({lo:.4f}-{hi:.4f})")
        del runs, keep, want

        xs = torch.from_numpy(rng.integers(-32768, 32768, size=SCAN_N, dtype=np.int16)).cuda()
        want = moving_average_xla(xs, SCAN_K, SCAN_C)
        sig = OLD_SCAN_SIGNATURE if old else _build._SIGNATURES["dsp_scan_i16"]
        for v in VARIANTS:
            runs, keep = {}, []
            for suffix, d in scan_variants.items():
                lib = bind(built[f"B3{suffix}"], "dsp_scan_i16", sig)
                y = torch.empty_like(xs)
                keep.append((lib, y))
                launch = old_scan_args(SCAN_N, v) if old else new_scan_args(SCAN_N, v, d["AB_MINB"])
                runs[f"B3 {v}{suffix}"] = call(lib.dsp_scan_i16, (xs.data_ptr(), y.data_ptr(), *launch), stream)
                if d.get("AB_MODE", 0) == 0:
                    runs[f"B3 {v}{suffix}"]()
                    if not torch.equal(y, want):
                        raise AssertionError(f"B3 {v}{suffix} differs from plain")
            print(f"B3 {v}, 64M int16, k={SCAN_K}, C={SCAN_C}; ms median (min-max) of 40:")
            for name, (med, lo, hi) in timed(runs).items():
                print(f"  {name:48s} {med:.4f} ({lo:.4f}-{hi:.4f})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
