"""Build the package's CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` (Hopper), one process a
source, all started together, and links the objects into one shared library
with a plain C interface. The library lands in ``_build/`` next to this
file, named by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. The compiler's resource
report (``-Xptxas -v``: registers, shared memory, spills) is kept beside it
as ``.log``.

Nothing is downloaded. If ``nvcc`` is missing or fails, :func:`library`
raises: a CUDA tensor never falls back to the plain PyTorch path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int64
_PP = ctypes.POINTER(ctypes.c_void_p)
# name -> argument types; every function returns a cudaError_t as int
_SIGNATURES = {
    # x, y, seed, n, window, channels, kernel_c, nrun, tile_begin, tile_end,
    # span_tiles, smem_bytes, stream
    "dsp_windowed_i16_range": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # kernel_c, smem_bytes, out: registers, local bytes, shared bytes, blocks
    # an SM (4 int64)
    "dsp_windowed_attrs": (_I, _I, _P),
    # x, y, rec (ticket and status words), n, channels, kernel_c, tile_frames,
    # seg_frames, segs, smem_bytes, stream
    "dsp_cumsum_i16": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # kernel_c, smem_bytes, out: registers, local bytes, shared bytes, blocks
    # an SM (4 int64)
    "dsp_cumsum_attrs": (_I, _I, _P),
    # x, y, n, window, channels, variant, kernel_c, nrun, span_tiles,
    # smem_bytes, stream
    "dsp_scan_i16": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # variant, kernel_c, smem_bytes, out: registers, local bytes, shared bytes,
    # blocks an SM (4 int64)
    "dsp_scan_attrs": (_I, _I, _I, _P),
    # x, y, n, window, channels, tile_frames, plane_words, in_words, smem_bytes,
    # stream
    "dsp_direct_i16": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # channels, smem_bytes, out: registers, local bytes, shared bytes, blocks an
    # SM (4 int64)
    "dsp_direct_attrs": (_I, _I, _P),
    # x, y, response, t, channels, k, block, log2n, threads, smem_bytes, stream
    "dsp_fused_fir": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # log2n, out: registers, local bytes, shared bytes, blocks an SM, threads
    # a block (5 int64)
    "dsp_fused_fir_attrs": (_I, _P),
    # x, y, scratch, response as [f1][f2], t, channels, k, block, log2n,
    # wave_pairs, stream
    "dsp_fused_fir3": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # log2n, launch (0 columns, 1 rows, 2 outputs), out: as dsp_fused_fir_attrs
    "dsp_fused_fir3_attrs": (_I, _I, _P),
    # x, y, table, mats, seed, state_out, records, n, channels, sections, tile,
    # stream
    "dsp_sos_lookback": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, y, table, mats, records, n, channels, sections, tile, stream
    "dsp_sos_unrolled": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # sections, tile, unrolled (B13), out: registers, local bytes, shared
    # bytes, blocks an SM (4 int64)
    "dsp_sos_attrs": (_I, _I, _I, _P),
    # x, y, scratch, table, carry, M, seed, state_out, n, channels, sections,
    # tile, stream
    "dsp_sos_sections": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, y, table, carry, M, n, channels, tile, stream
    "dsp_iir1": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # x, y, carry, a, b, n, channels, tile, stream
    "dsp_iir1_affine": (_P, _P, _P, ctypes.c_float, ctypes.c_float, _I, _I, _I, _P),
    # x, y, table, T's fragments, carry, M, n, channels, sections, tile, stream
    "dsp_sos_cascade_mxu": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # sections, out: registers, local bytes, shared bytes, blocks an SM, warps
    # a block (5 int64)
    "dsp_mxu_attrs": (_I, _P),
    # x (B19) or u (B20), hq, twiddles, re, im, M, N, P, dilation, sign, stride of k,
    # stride of m, layout, rows, steps, interleave, lookback, prefetch, smem_bytes, stream
    "dsp_pfb_raw": (_P, _P, _P, _P, _P, *(_I,) * 14, _P),
    "dsp_pfb_branch": (_P, _P, _P, _P, _P, *(_I,) * 14, _P),
    # kind (0 B19, 1 B20), N, smem_bytes, out: as dsp_fused_fir_attrs
    "dsp_pfb_attrs": (_I, _I, _I, _P),
    # x, y, t, channels, m_out, up, down, segment, 1/up, stream
    "dsp_farrow": (_P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P),
    # x, y, rows, section stride, channel stride, frame_len, carry, trans, seed,
    # state_out, n, channels, coefficient channels, sections, tile, kind, stream
    "dsp_tv_cascade": (_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # kind, sections, coefficient channels, out: registers, local bytes, shared
    # bytes, blocks an SM, columns a block (5 int64)
    "dsp_tv_attrs": (_I, _I, _I, _P),
    # a, s0, e, y, z, history scratch, frames, frame length, order, stream
    "dsp_lpc_synth": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # p, out: registers, local bytes, shared bytes, blocks an SM (4 int64)
    "dsp_lpc_attrs": (_I, _P),
    # src, dst, bytes, sent counter (or null), call, done count, stream
    "dsp_ring_put": (_P, _P, _I, _P, _I, _P, _P),
    # x, y, seed, n, window, channels, kernel_c, nrun, interior_begin,
    # interior_end, span_tiles, head_tiles, smem_bytes, tail, slot, sent,
    # consumed, call, stream
    "dsp_ring_windowed": (_P, _P, _P, *(_I,) * 10, _P, _P, _P, _P, _I, _P),
    # kernel_c, smem_bytes, out: as dsp_windowed_attrs
    "dsp_ring_windowed_attrs": (_I, _I, _P),
    # counter, value, stream
    "dsp_ring_wait": (_P, _I, _P),
    # out: 1 where the card's stream waits flush remote writes (one int64)
    "dsp_ring_can_flush": (_P,),
    "dsp_ring_signal": (_P, _I, _P),
    # bytes, out pointer, out 64-byte IPC handle
    "dsp_ring_alloc": (_I, _PP, ctypes.c_char_p),
    "dsp_ring_free": (_P,),
    # 64-byte IPC handle, out pointer
    "dsp_ring_open": (ctypes.c_char_p, _PP),
    "dsp_ring_close": (_P,),
    # x, d, y, e, w, ring and taps scratch, streams, n, p, ring, ring and taps
    # in shared memory, smem_bytes, step, eps, stream
    "dsp_nlms": (*(_P,) * 6, *(_I,) * 6, ctypes.c_float, ctypes.c_float, _P),
    # x, d, y, e, w, P's triangle scratch, streams, n, p, route, warps a block,
    # ring, triangle in shared memory, smem_bytes, forget, delta, stream
    "dsp_rls": (*(_P,) * 6, *(_I,) * 8, ctypes.c_float, ctypes.c_float, _P),
    # kind (0 S1 with its ring and taps in shared memory, 2 in device memory,
    # 1 S2), p, out: registers, local bytes, static shared bytes, S1's block
    # length or S2's slots a lane (4 int64)
    "dsp_adaptive_attrs": (_I, _I, _P),
    # [[A B]; [C D]], u, x0, y, xs, steps, n, p, q, route, cluster, rows a CTA,
    # state slots, chunk, threads, smem_bytes, stream
    "dsp_dlsim": (*(_P,) * 5, *(_I,) * 11, _P),
    # route, slots, out: registers, local bytes, static shared bytes, most
    # threads a block (4 int64)
    "dsp_dlsim_attrs": (_I, _I, _P),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels cannot be built"
    )


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libdsp_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if no library for them exists; return its path."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    objs = {src: BUILD_DIR / f"{tag}.{src.stem}.o" for src in sorted(CSRC.glob("*.cu"))}
    tmp = so.with_name(f"{tag}.so.tmp")
    try:
        procs = [
            (src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
            for src, obj in objs.items()
        ]
        log, failed = [], []
        for src, proc in procs:
            out = proc.communicate()[0]
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(f"{src.name} (exit code {proc.returncode})")
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n" + "".join(log))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs.values())],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to link, exit code {link.returncode}:\n{link.stdout}{link.stderr}"
            )
        so.with_suffix(".log").write_text("".join(log))
        os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs.values():
            obj.unlink(missing_ok=True)
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dsp_error_string.argtypes = (ctypes.c_int,)
    lib.dsp_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = library().dsp_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "library_path", "build", "library", "check"]
