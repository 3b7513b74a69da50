"""Fused overlap-save FIR on the card (B8, B9) and the plain overlap-save route.

Counterpart of the overlap-save part of
``digital_signal_processsing_tpu/ops/fft_mxu.py``. The reference runs each
segment's DFT, tap multiply and inverse DFT as matmuls on the TPU's matrix
unit, all in VMEM (``_fused_kernel``, ``_fused3_kernel``). The port computes
the same causal FIR with FFTs of its own, in its own segments:

- :func:`fused_fir`  B8, ``csrc/fused_fir.cu``: T threads transform two
  segments at once (packed as ``a + i*b``), each thread holding nfft/T
  points in registers through Stockham passes of radix 4 to 32
  (:data:`B8_PLANS`), shared memory only for the exchanges between passes,
  nfft up to FUSED_MAX_NFFT;
- :func:`fused_fir3` B9, ``csrc/fused_fir3.cu``: the four-step split
  nfft = n1 * n2 in three persistent launches a wave of pairs through a
  scratch in device memory (FUSED3_SCRATCH_BYTES), each line held in
  registers by the same Stockham passes (:data:`B9_LINE_PLANS`), every
  twiddle computed, nfft up to FUSED3_MAX_NFFT;
- :func:`overlap_save_fused` picks one of the two by the segment's nfft;
- :func:`overlap_save_plain` the plain version of both, the same segments
  and the same spectrum of the taps with ``torch.fft``;
- :func:`overlap_save_mxu` the reference's XLA-composed matmul DFT route,
  here the plain ``torch.fft`` overlap-save;
- the reference's planar DFT functions (:func:`dft_factored`,
  :func:`fft_large`, :func:`rfft_dense`, :func:`irfft_dense`,
  :func:`rfft_dense_framed`) with its names, arguments, limits and
  refusals, computed by ``torch.fft`` (cuFFT on the card) in IEEE float32:
  the matrix-unit matmuls that spell them on the TPU are not ported, and
  ``ops/fft.py`` does not route through them.

A segment of ``block`` kept samples reads the k-1 samples before it too, so
nfft is the power of two >= block + k - 1. Each wrapper takes its plain
version for a tensor on the CPU; for a CUDA tensor it launches its kernel,
adds one to its ``launches`` count, and raises if the build or the launch
fails.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .. import _build
from ..utils.device import as_tensor
from ..utils.dispatch import refuse_grad
from ..utils.layout import cdiv
from .fir import _as_planar, _pick_block, _taps_on, overlap_save_frames
from .pallas_scan import SMEM_MAX, _on_cuda, _stream

# Largest nfft of B8: a pair of 16384 complex float32 points is 128 KB of
# registers (half an SM's register file) and, padded, 136 KB of exchange
# in shared memory; 32768 would need 272 KB, past the 227 KB a block may have.
FUSED_MAX_NFFT = 16384
# Largest nfft of B9 (the reference's cap too): n1 = n2 = 1024.
FUSED3_MAX_NFFT = 1 << 20
# B8's plan at each log2 nfft (csrc/fused_fir.cu Plan<>): points a thread and
# the radices of its Stockham passes, the smallest first (the first pass
# needs no twiddles); a block holds enough pairs for B8_MIN_THREADS threads.
B8_PLANS = {
    7: (16, (8, 16)),
    8: (16, (16, 16)),
    9: (16, (8, 8, 8)),
    10: (16, (4, 16, 16)),
    11: (16, (8, 16, 16)),
    12: (16, (16, 16, 16)),
    13: (32, (16, 16, 32)),
    14: (32, (16, 32, 32)),
}
B8_MIN_THREADS = 256
# B9's line plans at each log2 of a line's length (csrc/fused_fir3.cu Line<>):
# points a thread and the radices of its passes; the two-pass plans are warp
# plans (the lanes of a line exchange by shuffles), the others exchange
# through shared memory as B8's do.
B9_LINE_PLANS = {
    7: (16, (16, 8)),
    8: (16, (16, 16)),
    9: (16, (8, 8, 8)),
    10: (16, (4, 16, 16)),
}
B9_ROW_THREADS = 256
# Bound on B9's scratch: one nfft-point complex buffer per pair of segments
# in flight, the pairs in waves of equal size that fit this much. One wave
# holds fir_filter's 16 x 2^22 at 8194 taps (280 pairs of 1 MB); waves small
# enough to stay in the H100's 50 MB L2 measured slower (PERF.md §6).
FUSED3_SCRATCH_BYTES = 512 << 20


def line_slots(m: int) -> int:
    """Complex slots a line of m points takes in B9's shared memory: one pad after
    every 16 points (``xslot`` in ``csrc/stockham.cuh``) and one after the line."""
    return m + m // 16 + 1


def line_threads(m: int) -> int:
    """Threads that hold a B9 line of m points."""
    return m // B9_LINE_PLANS[m.bit_length() - 1][0]


def pick_factored_nfft(min_n: int, n1: int = 128) -> int:
    """Smallest multiple of ``n1`` >= min_n (the reference's factored-DFT grid)."""
    return -(-min_n // n1) * n1


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class FusedGeometry:
    """Segments and launch geometry of B8 and B9 for k taps.

    Segment s of a row keeps outputs [s*block, (s+1)*block) and transforms
    the nfft samples from s*block - (k-1) on (zeros outside the signal).
    Two segments (rows of the flattened (channels, segments) grid, in
    order) form a pair: one complex transform of ``a + i*b``.
    """

    k: int
    block: int
    nfft: int

    @property
    def kernel(self) -> str:
        return "B8" if self.nfft <= FUSED_MAX_NFFT else "B9"

    @property
    def log2n(self) -> int:
        return self.nfft.bit_length() - 1

    @property
    def n1(self) -> int:
        """B9's column length: transform point n = n2*i1 + i2 (``csrc/fused_fir3.cu``)."""
        return 1 << (self.log2n // 2)

    @property
    def n2(self) -> int:
        return self.nfft // self.n1

    @property
    def g1(self) -> int:
        """Lines of n1 points (columns) a block of B9's column launches holds."""
        t = line_threads(self.n1)
        return 8 if t >= 32 else 256 // t

    @property
    def g2(self) -> int:
        """Lines of n2 points (rows) a block of B9's row launch holds."""
        return B9_ROW_THREADS // line_threads(self.n2)

    @property
    def column_threads(self) -> int:
        return self.g1 * line_threads(self.n1)

    @property
    def column_smem_bytes(self) -> int:
        """B9's column and output launches: two stages of g1 padded lines of n1 points
        (a task's and the next one's, loaded meanwhile)."""
        return 2 * 8 * self.g1 * line_slots(self.n1)

    @property
    def row_smem_bytes(self) -> int:
        """B9's row launch: g2 rows of the taps' spectrum, g2 staged rows of a pair,
        and the exchanges of a shared-memory plan (none for a warp plan)."""
        warp = len(B9_LINE_PLANS[self.n2.bit_length() - 1][1]) == 2
        return 8 * (2 * self.g2 * self.n2 + (0 if warp else self.g2 * line_slots(self.n2)))

    @property
    def points(self) -> int:
        """B8: points a thread holds in registers."""
        return B8_PLANS[self.log2n][0]

    @property
    def radices(self) -> tuple:
        """B8: the radices of its Stockham passes, in order."""
        return B8_PLANS[self.log2n][1]

    @property
    def pair_threads(self) -> int:
        """B8: threads that carry one pair."""
        return self.nfft // self.points

    @property
    def pairs_per_block(self) -> int:
        """B8: pairs a block carries, so that it has at least B8_MIN_THREADS threads."""
        return max(1, B8_MIN_THREADS // self.pair_threads)

    @property
    def threads(self) -> int:
        if self.kernel == "B8":
            return self.pairs_per_block * self.pair_threads
        return self.column_threads

    @property
    def smem_bytes(self) -> int:
        """Bytes of dynamic shared memory a block takes: B8's exchange of each
        pair (one pad after every 16 points), the larger of B9's launches'."""
        if self.kernel == "B8":
            return 8 * self.pairs_per_block * (self.nfft + self.nfft // 16)
        return max(self.column_smem_bytes, self.row_smem_bytes)

    @property
    def wave_pairs(self) -> int:
        """Pairs of segments B9's scratch may hold at once (FUSED3_SCRATCH_BYTES)."""
        return max(1, min(65535, FUSED3_SCRATCH_BYTES // (8 * self.nfft)))

    def wave(self, pairs: int) -> int:
        """Pairs in B9's largest wave: ``pairs`` in ceil(pairs / wave_pairs) waves
        of equal size (wave w takes pairs [w*pairs/waves, (w+1)*pairs/waves))."""
        return cdiv(pairs, cdiv(pairs, self.wave_pairs))

    def segments(self, t: int) -> int:
        return cdiv(t, self.block)

    def pairs(self, channels: int, t: int) -> int:
        return cdiv(channels * self.segments(t), 2)


def fused_geometry(k: int, block: int) -> FusedGeometry:
    """The geometry for k taps and ``block`` kept samples a segment."""
    if k < 1:
        raise ValueError(f"need at least one tap, got {k}")
    if block < 128 or block % 128 != 0:
        raise ValueError(f"block must be a positive multiple of 128, got {block}")
    nfft = _next_pow2(block + k - 1)
    if nfft > FUSED3_MAX_NFFT:
        raise ValueError(
            f"no 3-factor split for nfft {nfft} (cap {FUSED3_MAX_NFFT}); "
            "shrink block or use overlap_save_mxu"
        )
    g = FusedGeometry(k, block, nfft)
    if g.smem_bytes > SMEM_MAX:
        raise AssertionError(f"{g} needs {g.smem_bytes} bytes of shared memory")
    return g


def pick_fused_block(k: int) -> int | None:
    """The block ``fir_filter`` gives ``overlap_save_fused`` for k taps.

    The port's counterpart of the reference's ``pick_fused3_block``: the
    reference's nfft (the power of two >= 8k) capped at B8's envelope, and
    the largest 128-multiple block that fits with the k-1 overlap. B8 takes
    it while the block is at least half the transform (at most twice the
    work of a transform with no overlap, the reference's ``block >= k``
    rule), so k up to FUSED_MAX_NFFT/2 + 1; then B9 under the same rule up
    to FUSED3_MAX_NFFT/2 + 1; beyond, None (the plain ``overlap_save_mxu``).
    """
    for cap in (FUSED_MAX_NFFT, FUSED3_MAX_NFFT):
        nfft = min(cap, _pick_block(k))
        block = (nfft - (k - 1)) // 128 * 128
        if block >= nfft // 2:
            return block
    return None


@dataclasses.dataclass(frozen=True)
class TapResponse:
    """The taps' spectrum at a geometry's nfft, as B8, B9 and the plain version read it.

    ``h`` is in natural bin order (complex64); ``h_kernel`` is ``h`` as the
    kernel's tap product reads it: for B8 ``h`` itself (its Stockham passes
    leave the spectrum in natural order, ``csrc/fused_fir.cu``), for B9 the
    four-step layout ``h_kernel[f1 * n2 + f2] = h[f1 + n1 * f2]``, a
    transpose, so that a row of the row launch reads its taps in order
    (``csrc/fused_fir3.cu``).
    """

    geometry: FusedGeometry
    h: torch.Tensor
    h_kernel: torch.Tensor


def tap_response(taps, geometry: FusedGeometry, device) -> TapResponse:
    """The spectrum of ``taps`` in float64, rounded to complex64, on ``device``.

    The reference takes it on the host with NumPy in float64; here
    ``torch.fft`` does it in float64 on the taps' device, so CUDA taps are
    never copied to the host.
    """
    if isinstance(taps, torch.Tensor):
        t64 = taps.to(device=device, dtype=torch.float64)
    else:
        t64 = torch.from_numpy(np.asarray(taps, np.float64)).to(device)
    if t64.dim() != 1 or t64.numel() != geometry.k:
        raise ValueError(f"taps of shape {tuple(t64.shape)} for a geometry of {geometry.k} taps")
    g = geometry
    h = torch.fft.fft(t64, n=g.nfft).to(torch.complex64)
    hk = h if g.kernel == "B8" else h.view(g.n2, g.n1).t().contiguous().view(-1)
    return TapResponse(g, h, hk)


@functools.lru_cache(maxsize=16)
def _twiddles(nfft: int, device: str) -> torch.Tensor:
    """exp(-2*pi*i*q/nfft) for q in [0, nfft), in float64 rounded to complex64."""
    w = np.exp(-2j * np.pi * np.arange(nfft) / nfft).astype(np.complex64)
    return torch.from_numpy(w).to(device)


def overlap_save_plain(xp: torch.Tensor, response: TapResponse) -> torch.Tensor:
    """Plain PyTorch version of B8 and B9: their segments, with ``torch.fft``."""
    g = response.geometry
    return overlap_save_frames(xp, response.h[: g.nfft // 2 + 1], g.k, g.block, g.nfft)


def _check_launch(x: torch.Tensor, response: TapResponse, kernel: str) -> None:
    g = response.geometry
    if g.kernel != kernel:
        raise ValueError(f"nfft {g.nfft} is {g.kernel}'s, not {kernel}'s")
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError("x must be a (channels, time) tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if x.device.type == "cuda":
        if not x.is_contiguous():
            raise ValueError("x must be contiguous")
        if response.h_kernel.device != x.device or response.h_kernel.dtype != torch.complex64:
            raise ValueError(
                f"the taps' response is {response.h_kernel.dtype} on "
                f"{response.h_kernel.device}, the signal on {x.device}"
            )


def fused_fir(x: torch.Tensor, response: TapResponse) -> torch.Tensor:
    """Causal FIR of (channels, time) float32 by B8 (nfft <= FUSED_MAX_NFFT)."""
    _check_launch(x, response, "B8")
    if not _on_cuda(x):
        return overlap_save_plain(x, response)
    refuse_grad("fused_fir (B8)", x, response.h_kernel)
    g = response.geometry
    c, t = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.dsp_fused_fir(
            x.data_ptr(), y.data_ptr(), response.h_kernel.data_ptr(),
            t, c, g.k, g.block, g.log2n, g.threads, g.smem_bytes, _stream(x),
        )
    _build.check(err, "fused_fir")
    fused_fir.launches += 1
    return y


fused_fir.launches = 0


def fused_kernel_attrs(log2n: int) -> tuple:
    """What the compiler gave B8's kernel at nfft 2^log2n (the card only):
    (registers a thread, local bytes a thread, shared bytes a block, blocks an
    SM, threads a block)."""
    lib = _build.library()
    out = (ctypes.c_int64 * 5)()
    _build.check(lib.dsp_fused_fir_attrs(log2n, ctypes.addressof(out)), "fused_kernel_attrs")
    return tuple(out)


def fused3_kernel_attrs(geometry: FusedGeometry) -> dict:
    """What the compiler gave B9's three launches at ``geometry`` (the card only):
    {launch: (registers a thread, local bytes a thread, shared bytes a block,
    blocks an SM, threads a block)}."""
    lib = _build.library()
    out = (ctypes.c_int64 * 5)()
    attrs = {}
    for which, name in enumerate(("columns", "rows", "outputs")):
        _build.check(lib.dsp_fused_fir3_attrs(geometry.log2n, which, ctypes.addressof(out)),
                     "fused3_kernel_attrs")
        attrs[name] = tuple(out)
    return attrs


def fused_fir3(x: torch.Tensor, response: TapResponse) -> torch.Tensor:
    """Causal FIR of (channels, time) float32 by B9 (FUSED_MAX_NFFT < nfft <= 2^20)."""
    _check_launch(x, response, "B9")
    if not _on_cuda(x):
        return overlap_save_plain(x, response)
    refuse_grad("fused_fir3 (B9)", x, response.h_kernel)
    g = response.geometry
    c, t = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    wave = g.wave(g.pairs(c, t))
    scratch = torch.empty(wave * g.nfft, dtype=torch.complex64, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.dsp_fused_fir3(
            x.data_ptr(), y.data_ptr(), scratch.data_ptr(), response.h_kernel.data_ptr(),
            t, c, g.k, g.block, g.log2n, wave, _stream(x),
        )
    _build.check(err, "fused_fir3")
    fused_fir3.launches += 1
    return y


fused_fir3.launches = 0


def overlap_save_fused(
    x: torch.Tensor, taps, *, block: int = 8192, response: TapResponse | None = None
) -> torch.Tensor:
    """Fused overlap-save FIR: B8, or B9 once nfft passes FUSED_MAX_NFFT.

    ``block`` (kept samples a segment, a multiple of 128) plus the k-1
    overlap sets nfft, the next power of two; past FUSED3_MAX_NFFT it
    raises. ``response`` is the taps' ``TapResponse`` for this geometry,
    computed here when not given.
    """
    xp, squeeze = _as_planar(x)
    k = int(taps.shape[0])
    g = fused_geometry(k, block)
    if response is None:
        response = tap_response(taps, g, xp.device)
    elif response.geometry != g:
        raise ValueError(f"response is for {response.geometry}, the call needs {g}")
    xp = xp.to(torch.float32).contiguous()
    y = (fused_fir if g.kernel == "B8" else fused_fir3)(xp, response)
    return y[0] if squeeze else y


def overlap_save_mxu(x: torch.Tensor, taps, *, block: int, n1: int = 128) -> torch.Tensor:
    """Causal FIR via overlap-save with ``torch.fft`` at the reference's nfft.

    The reference's route of the same name runs its matmul DFT; nfft is
    ``block + k`` rounded up to a multiple of ``n1``, and the taps' spectrum
    is taken in float64.
    """
    xp, squeeze = _as_planar(x)
    k = int(taps.shape[0])
    nfft = pick_factored_nfft(block + k, n1)
    h64 = _taps_on(taps, xp.device).to(torch.float64)
    h = torch.fft.rfft(h64, n=nfft).to(torch.complex64)
    y = overlap_save_frames(xp, h, k, block, nfft)
    return y[0] if squeeze else y


# The reference's limits of its matmul DFT engines, kept as its contract: the
# factored DFT's largest single-level length (also each factor of fft_large)
# and the dense real DFT's largest length.
FACTORED_MAX_N = 32768
DENSE_RFFT_MAX_N = 4096


def _complex_in(x_re, x_im, device) -> torch.Tensor:
    """Planar ``(x_re, x_im)`` as one complex64 tensor (``x_im=None``: the real
    float32 one) on ``x_re``'s device, or ``device`` for NumPy input."""
    re = as_tensor(x_re, device).to(torch.float32)
    if x_im is None:
        return re
    return torch.complex(re, as_tensor(x_im, re.device).to(re.device, torch.float32))


def _planar(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return z.real.contiguous(), z.imag.contiguous()


def _dft(z: torch.Tensor, inverse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward DFT, or the inverse with its 1/N, over the last axis."""
    return _planar(torch.fft.ifft(z) if inverse else torch.fft.fft(z))


def dft_factored(x_re, x_im, *, n1: int = 128, inverse: bool = False,
                 device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Planar complex DFT over the last axis (the reference's two-stage matmul DFT).

    ``x_im=None`` marks a real input. Returns planar float32 ``(re, im)``; the
    inverse applies the 1/N scale. The last axis must be a multiple of ``n1``,
    as in the reference, which factors N = n1 * (N / n1); here ``torch.fft``
    computes it. A tensor stays on its device; NumPy input goes to ``device``.
    """
    n = np.shape(x_re)[-1]
    if n % n1 != 0:
        raise ValueError(f"factored DFT needs len % {n1} == 0, got {n}")
    return _dft(_complex_in(x_re, x_im, device), inverse)


def _check_large_length(n: int) -> None:
    """The reference's refusals of its four-step split n = n1 * n2, both factors
    multiples of 128 and at most FACTORED_MAX_N."""
    if n % (128 * 128) != 0:
        raise ValueError(
            f"fft_large needs len % {128 * 128} == 0, got {n} "
            "(use dft_factored / torch.fft for short transforms)"
        )
    m, most = n // (128 * 128), FACTORED_MAX_N // 128  # n1 = 128 d, n2 = 128 m / d
    if not any(m % d == 0 and m // d <= most for d in range(1, most + 1)):
        raise ValueError(
            f"no balanced 128-multiple factorization of {n} with both factors <= {FACTORED_MAX_N}"
        )


def fft_large(x_re, x_im, *, inverse: bool = False,
              device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Planar complex DFT for large n (the reference's four-step split of two
    factored DFTs): n a multiple of 128^2 with a split both of whose factors are
    at most FACTORED_MAX_N, else the reference's ``ValueError``. ``torch.fft``
    computes it; the arguments and outputs are :func:`dft_factored`'s."""
    _check_large_length(np.shape(x_re)[-1])
    return _dft(_complex_in(x_re, x_im, device), inverse)


def rfft_dense(x, *, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Real ``(..., n)`` -> planar ``(re, im)`` half spectrum ``(..., n//2 + 1)``, float32."""
    return _planar(torch.fft.rfft(as_tensor(x, device).to(torch.float32)))


def irfft_dense(s_re, s_im, nfft: int, *, device="cuda") -> torch.Tensor:
    """Planar half spectrum ``(..., nfft//2 + 1)`` -> real ``(..., nfft)``, with the
    1/nfft scale; the imaginary parts of the DC and (even nfft) Nyquist bins are
    dropped, as the reference's synthesis matrices drop them."""
    return torch.fft.irfft(_complex_in(s_re, s_im, device), n=nfft)


def rfft_dense_framed(x, num_frames: int, hop: int, nfft: int, window, *,
                      detrend: bool = False, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Windowed framed real DFT: ``out[..., i, k] = sum_t w[t] x[..., i*hop + t] W[t, k]``.

    The reference's contract: ``hop`` divides ``nfft`` and is a multiple of
    128; a signal shorter than ``(num_frames - 1) * hop + nfft`` is padded
    with zeros; ``detrend`` removes each frame's mean before the window.
    Returns planar float32 ``(re, im)``, each ``(..., num_frames, nfft//2 + 1)``.
    """
    if nfft % hop or hop % 128:
        raise ValueError(f"need hop | nfft and 128 | hop, got {nfft=} {hop=}")
    xf = as_tensor(x, device).to(torch.float32)
    need = (num_frames + nfft // hop - 1) * hop
    if xf.shape[-1] < need:
        xf = torch.nn.functional.pad(xf, (0, need - xf.shape[-1]))
    frames = xf[..., :need].unfold(-1, nfft, hop)[..., :num_frames, :]
    if detrend:
        frames = frames - frames.mean(-1, keepdim=True)
    w = torch.as_tensor(np.asarray(window, np.float32), device=xf.device)
    return _planar(torch.fft.rfft(frames * w))


__all__ = [
    "FACTORED_MAX_N",
    "DENSE_RFFT_MAX_N",
    "dft_factored",
    "fft_large",
    "rfft_dense",
    "irfft_dense",
    "rfft_dense_framed",
    "FUSED_MAX_NFFT",
    "FUSED3_MAX_NFFT",
    "FUSED3_SCRATCH_BYTES",
    "B9_LINE_PLANS",
    "FusedGeometry",
    "TapResponse",
    "fused_geometry",
    "pick_fused_block",
    "pick_factored_nfft",
    "tap_response",
    "fused_fir",
    "fused_fir3",
    "fused_kernel_attrs",
    "fused3_kernel_attrs",
    "overlap_save_fused",
    "overlap_save_plain",
    "overlap_save_mxu",
]
