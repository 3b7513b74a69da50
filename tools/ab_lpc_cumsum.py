#!/usr/bin/env python3
"""Where B22 (the LPC synthesis recurrence) and B4 (the per-channel cumsum) spend their time, on one card.

    python3 tools/ab_lpc_cumsum.py [--old DIR]

Builds variants of ``lpc.cu`` and ``cumsum.cu`` with nvcc, each from a copy
of the package's ``csrc/`` with one part of the kernel left out or one
constant changed, and times them with CUDA events (20 calls after 5
warm-ups, in two rounds, the variants in turns) at the main path's shapes:
B22 on 65536 frames x 256 samples at p = 12 (``lpc_vocoder`` at 128 x 512 x
256), B4 on 64M int16 samples at C = 16 (the two-pass averager's) and C = 1,
beside ``torch.cumsum`` of the 1-D stream, and at C = 3 (the generic
kernel). With ``--old DIR`` (the previous design's ``csrc/``: ``git archive
e099f97 digital_signal_processsing_tpu_torch/csrc``) it times that design's
B22 and B4 in the same turns, and B22's parts: its loads and stores alone,
and its recurrence without the stores. A variant that leaves a part out
computes a wrong result: it is a timing of what remains, never a port; the
whole kernels are checked bit for bit against the plain versions first.
Needs a CUDA device and nvcc.
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
from digital_signal_processsing_tpu_torch.ops import lpc  # noqa: E402
from digital_signal_processsing_tpu_torch.ops import pallas_scan as ps  # noqa: E402
from digital_signal_processsing_tpu_torch.ops.scan_xla import cumsum_ref  # noqa: E402

CSRC = ROOT / "digital_signal_processsing_tpu_torch" / "csrc"
FRAMES, LENGTH, ORDER = 65536, 256, 12
N = 64 * 2**20
_P, _I = ctypes.c_void_p, ctypes.c_int64
OLD_CUMSUM_SIGNATURE = (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P)

# ---- the previous design (e099f97): B22 staged through one buffer, three barriers a chunk
OLD_LPC_HOOKS = [
    ("    if (live) {\n      for (int j = 0; j < cnt; ++j) {",
     "    if (live && !(AB_MODE & 1)) {\n      for (int j = 0; j < cnt; ++j) {"),
    ("    stage_out(y, buf, f0, frames, L, t0, cnt);",
     "    if (!(AB_MODE & 2)) stage_out(y, buf, f0, frames, L, t0, cnt);"),
]
OLD_LPC_VARIANTS = {
    "B22 before (e099f97)": {"AB_MODE": 0},
    "B22 before, loads and stores alone": {"AB_MODE": 1},
    "B22 before, the recurrence without the stores": {"AB_MODE": 2},
}

# ---- this design: B22's staged ring, its history unrolled, its state-only entry; B4's
# look-back by the whole block (and, as tried first, by a thread a channel)
LPC_HOOKS = [
    ("    if (live) {\n      if constexpr (P > 0) {",
     "    if (live && !(AB_MODE & 1)) {\n      if constexpr (P > 0) {"),
    ("__launch_bounds__(kFrames, kMinBlocks)", "__launch_bounds__(kFrames, AB_MINB)"),
]
LPC_VARIANTS = {
    "B22": {"AB_MODE": 0, "AB_MINB": "kMinBlocks"},
    "B22 without the recurrence": {"AB_MODE": 1, "AB_MINB": "kMinBlocks"},
    "B22 no register bound": {"AB_MODE": 0, "AB_MINB": 1},
    "B22 no register bound, without the recurrence": {"AB_MODE": 1, "AB_MINB": 1},
}

CUMSUM_HOOKS = [
    ("constexpr int kBatch = 8;",
     "constexpr int kBatch = AB_BATCH;\n__device__ unsigned long long ab_counts[3];  // look-backs, rounds, spins"),
    ("  uint32_t open = (1u << C) - 1u;  // the channels still looking\n",
     "  uint32_t open = (1u << C) - 1u;  // the channels still looking\n"
     "  if (AB_COUNT && tid == 0) atomicAdd(&ab_counts[0], 1ull);\n"),
    ("    int* h = hit[r % 3];\n",
     "    int* h = hit[r % 3];\n    if (AB_COUNT && tid == 0) atomicAdd(&ab_counts[1], 1ull);\n"),
    ("      while (w < kAgg) {\n        __nanosleep(32);\n",
     "      while (w < kAgg) {\n        __nanosleep(32);\n        if (AB_COUNT) atomicAdd(&ab_counts[2], 1ull);\n"),
    ("    tile_prefix<kHillisSteele, C>(v, off, carry, wt, lane, warp, u);\n",
     "#if AB_MODE & 2\n#pragma unroll\n    for (int q = 0; q < kNQ; ++q)\n#pragma unroll\n"
     "      for (int c = 0; c < SL; ++c) off[q][c] = 0u;\n#else\n"
     "    tile_prefix<AB_VARIANT, C>(v, off, carry, wt, lane, warp, u);\n#endif\n"),
    ("    if (tile > 0) block_look_back<C>(st, tile, cs, hit);\n",
     "#if AB_MODE & 1\n#elif AB_MODE & 4\n"
     "    if (tile > 0 && tid < C) while (ld_status(st + (tile - 1) * C + tid) < kAgg) __nanosleep(32);\n"
     "#elif AB_MODE & 8\n    if (tile > 0 && tid < C) cs[tid] = look_back(st, tile, C, tid);\n"
     "#else\n    if (tile > 0) block_look_back<C>(st, tile, cs, hit);\n#endif\n"),
    ("  out[3] = blocks;\n  return 0;\n}\n",
     "  out[3] = blocks;\n  return 0;\n}\n\nextern \"C\" int ab_counts_swap(unsigned long long* out) {\n"
     "  unsigned long long z[3] = {0, 0, 0};\n  cudaError_t err = cudaMemcpyFromSymbol(out, dsp::cum::ab_counts, sizeof(z));\n"
     "  if (err != cudaSuccess) return static_cast<int>(err);\n"
     "  return static_cast<int>(cudaMemcpyToSymbol(dsp::cum::ab_counts, z, sizeof(z)));\n}\n"),
]
CUMSUM_DEFAULTS = {"AB_BATCH": 8, "AB_MODE": 0, "AB_VARIANT": "kHillisSteele", "AB_COUNT": 0}
CUMSUM_VARIANTS = {
    "B4": {},
    "B4 look-back a thread a channel, 8 words at a time": {"AB_MODE": 8},
    "B4 look-back a thread a channel, 16 words at a time": {"AB_MODE": 8, "AB_BATCH": 16},
    "B4 Blelloch in-tile scan": {"AB_VARIANT": "kBlelloch"},
    "B4 without the chain, waiting on the previous tile's total": {"AB_MODE": 4},
    "B4 counting its look-back": {"AB_COUNT": 1},
    "B4 without the look-back": {"AB_MODE": 1},
    "B4 loads and stores alone": {"AB_MODE": 3},
}


def lpc_call(lib, a_f, s0, e, y, z):
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.dsp_lpc_synth(a_f.data_ptr(), s0.data_ptr(), e.data_ptr(),
                                None if y is None else y.data_ptr(), z.data_ptr(), None,
                                FRAMES, LENGTH, ORDER, stream)
        if err:
            raise RuntimeError(f"dsp_lpc_synth: CUDA error {err}")
        return y, z

    return run


def cumsum_call(lib, x, y, c, old):
    g = ps.cumsum_geometry(c)
    stream = torch.cuda.current_stream().cuda_stream
    n = x.numel()
    if old:
        scratch = torch.empty(g.blocks(n) * c, dtype=torch.int32, device=x.device)
    else:
        scratch = torch.empty(ps.cumsum_status_words(n, c), dtype=torch.int64, device=x.device)

    def run():
        if old:
            err = lib.dsp_cumsum_i16(x.data_ptr(), y.data_ptr(), scratch.data_ptr(), n, c,
                                     g.tile_frames, g.seg_frames, g.segs, g.smem_bytes, stream)
        else:
            err = lib.dsp_cumsum_i16(x.data_ptr(), y.data_ptr(), scratch.data_ptr(), n, c,
                                     ps.cumsum_kernel_c(c), g.tile_frames, g.seg_frames, g.segs,
                                     g.smem_bytes, stream)
        if err:
            raise RuntimeError(f"dsp_cumsum_i16: CUDA error {err}")
        return y

    return run


def attrs(so: Path, name: str, *args) -> tuple:
    lib = bind(so, name, _build._SIGNATURES[name])
    out = (ctypes.c_int64 * 4)()
    if getattr(lib, name)(*args, ctypes.addressof(out)):
        raise RuntimeError(f"{name} failed")
    return tuple(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, default=None, help="the previous design's csrc/")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    print(f"card: {card()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    tmp = Path(tempfile.mkdtemp())
    try:
        work = tmp / "csrc"
        shutil.copytree(CSRC, work)
        lpc_src = patched(CSRC / "lpc.cu", LPC_HOOKS, work)
        cum_src = patched(CSRC / "cumsum.cu", CUMSUM_HOOKS, work)
        jobs = {name: (lpc_src, d, tmp / f"lpc_{i}.so") for i, (name, d) in enumerate(LPC_VARIANTS.items())}
        jobs.update({name: (cum_src, {**CUMSUM_DEFAULTS, **d}, tmp / f"cum_{i}.so")
                     for i, (name, d) in enumerate(CUMSUM_VARIANTS.items())})
        if args.old is not None:
            old = tmp / "old"
            shutil.copytree(args.old, old)
            old_lpc = patched(args.old / "lpc.cu", OLD_LPC_HOOKS, old)
            jobs.update({name: (old_lpc, d, tmp / f"old_lpc_{i}.so")
                         for i, (name, d) in enumerate(OLD_LPC_VARIANTS.items())})
            jobs["B4 before (e099f97)"] = (old / "cumsum.cu", {}, tmp / "old_cum.so")
        with ThreadPoolExecutor(8) as pool:
            built = dict(zip(jobs, pool.map(lambda j: build(*j), jobs.values())))

        # B22 at the main path's shape
        rng = np.random.default_rng(0)
        a_f = torch.from_numpy((0.9 / ORDER * rng.uniform(-1, 1, (FRAMES, ORDER))).astype(np.float32)).cuda()
        e = torch.from_numpy(rng.standard_normal((FRAMES, LENGTH), dtype=np.float32)).cuda()
        s0 = torch.from_numpy(rng.standard_normal((FRAMES, ORDER), dtype=np.float32)).cuda()
        yp, zp = lpc._lpc_pass_plain(a_f, s0, e)
        runs, keep = {}, []
        names = [n for n in (*OLD_LPC_VARIANTS, *LPC_VARIANTS) if n in built]
        for name in names:
            lib = bind(built[name], "dsp_lpc_synth", _build._SIGNATURES["dsp_lpc_synth"])
            modes = [("", True)] + ([(", state only", False)] if name in LPC_VARIANTS else [])
            for label, full in modes:
                y = torch.empty_like(e) if full else None
                z = torch.empty_like(s0)
                keep.append((lib, y, z))
                run = lpc_call(lib, a_f, s0, e, y, z)
                run()
                torch.cuda.synchronize()
                whole = "without" not in name and "alone" not in name
                if whole and (not torch.equal(z, zp) or (full and not torch.equal(y, yp))):
                    raise AssertionError(f"{name}{label}: differs from plain")
                runs[name + label] = run
        print(f"B22, {FRAMES} frames x {LENGTH}, p = {ORDER}; ms median (min-max) of 40:")
        for name, (med, lo, hi) in timed(runs).items():
            print(f"  {name:60s} {med:.4f} ({lo:.4f}-{hi:.4f})")
        for name in ("B22", "B22 no register bound"):
            print(f"  {name}: registers, local bytes, shared bytes, blocks an SM by p: " + "; ".join(
                f"p={p} {attrs(built[name], 'dsp_lpc_attrs', p)}" for p in (1, 2, 12, 16, 24, 32, 40)))
        del runs, keep, a_f, e, s0, yp, zp

        # B4 at C = 16, 1 and 3
        x = torch.from_numpy(rng.integers(-32768, 32768, size=N, dtype=np.int16)).cuda()
        for c in (16, 1, 3):
            xc = x[: N // c * c]
            want = cumsum_ref(xc, c)
            runs, keep = {}, []
            for name in (n for n in ("B4 before (e099f97)", *CUMSUM_VARIANTS) if n in built):
                if c == 3 and name not in ("B4", "B4 before (e099f97)"):
                    continue
                old_design = "before" in name
                sig = OLD_CUMSUM_SIGNATURE if old_design else _build._SIGNATURES["dsp_cumsum_i16"]
                lib = bind(built[name], "dsp_cumsum_i16", sig)
                y = torch.empty(xc.numel(), dtype=torch.int32, device=x.device)
                keep.append((lib, y))
                run = cumsum_call(lib, xc, y, c, old_design)
                if "without" not in name and "alone" not in name and not torch.equal(run(), want):
                    raise AssertionError(f"{name} C={c}: differs from plain")
                runs[name] = run
            if c == 1:
                runs["torch.cumsum of the 1-D stream"] = lambda: torch.cumsum(x, 0, dtype=torch.int32)
            print(f"B4, 64M int16, C = {c}; ms median (min-max) of 40:")
            for name, (med, lo, hi) in timed(runs).items():
                print(f"  {name:60s} {med:.4f} ({lo:.4f}-{hi:.4f})")
            del runs, keep, want
        # the look-back's batches and spins, counted over one call at C = 16 and 1
        lib = bind(built["B4 counting its look-back"], "dsp_cumsum_i16", _build._SIGNATURES["dsp_cumsum_i16"])
        swap = getattr(lib, "ab_counts_swap")
        swap.argtypes, swap.restype = (ctypes.c_void_p,), ctypes.c_int
        counts = (ctypes.c_uint64 * 3)()
        for c in (16, 1):
            y = torch.empty(N, dtype=torch.int32, device=x.device)
            run = cumsum_call(lib, x, y, c, False)
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            swap(ctypes.addressof(counts))
            run()
            torch.cuda.synchronize()
            swap(ctypes.addressof(counts))
            looks, batches, spins = counts
            print(f"  B4 C={c}, one call: {looks} look-backs, {batches / max(looks, 1):.2f} rounds "
                  f"and {spins / max(looks, 1):.2f} spins a look-back ({256 // c} tiles a round)")
        for c in (16, 1, 3):
            kc = ps.cumsum_kernel_c(c)
            smem = 0 if kc else ps.cumsum_geometry(c).smem_bytes
            print(f"  B4 C={c} registers, local bytes, shared bytes, blocks an SM: "
                  f"{attrs(built['B4'], 'dsp_cumsum_attrs', kc, smem)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
