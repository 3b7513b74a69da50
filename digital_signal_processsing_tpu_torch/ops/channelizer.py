"""Polyphase filter-bank (PFB) channelizer: one wideband stream into N bands.

Counterpart of ``digital_signal_processsing_tpu/ops/channelizer.py``:

    Y[k, m] = sum_j h[j] x[N*m - j] * e^{2*pi*i*k*j/N}
            = sum_q v_q[m] e^{2*pi*i*q*k/N},   v_q = h_q (*) u_q

with branch taps h_q[r] = h[r*N + q] and branch inputs u_q[m] = x[N*m - q]
(the reverse-running commutator, zeros before the stream).

Routes of :func:`pfb_channelize`, with the reference's names:

- ``fused_raw``: B19 (``csrc/pfb.cu``), the branch FIR and the channel DFT
  straight from the raw stream, envelope as the reference's;
- ``fused``: B20 (``csrc/pfb.cu``), the same on the commutated (M, N)
  tensor u, for any N;
- ``composed``: ``branch_fir`` + ``dft_matmul`` in plain PyTorch;
- ``auto``: on a CUDA tensor with more than one tap a phase, ``fused_raw``
  inside B19's envelope and ``fused`` outside it; otherwise ``composed``.

The kernels' wrappers :func:`fused_pfb_raw` and :func:`fused_branch_dft`
take their plain version (the composed pair on the same inputs) for a tensor
on the CPU; for a CUDA tensor they launch the kernel, add one to their
``launches`` count, and raise if the build or the launch fails. Their
``layout`` writes the planes the caller returns: ``rows`` (M, N) planes, the
reference's; ``channels`` (N, M) planes; ``complex`` one (N, M) complex64
tensor, so that no transpose or interleave pass follows the kernel.

:func:`pfb_geometry` is the launch geometry both kernels take (the plan for
N, rows a step, the ring of staged input rows, steps a block), the same
numbers ``csrc/pfb.cu`` checks and the NumPy emulation in
``tests/test_torch_channelizer.py`` walks.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..utils.device import resolve_device
from ..utils.dispatch import record_choice, refuse_grad
from ..utils.layout import cdiv
from .fft_mxu import _twiddles
from .fir import _taps_on, design_lowpass, ieee_fp32_matmul
from .pallas_scan import SMEM_MAX, SMEM_PER_SM, _on_cuda, _stream

LAYOUTS = ("rows", "channels", "complex")
# Largest N the kernels take (the reference's envelope reaches 1024 for B19).
PFB_MAX_N = 8192
PFB_THREADS = 256
# The FFT plans of csrc/pfb.cu Plan<>, by (log2 M, K3) for N = 3^K3 * M: points
# a thread in each sub-transform, the radices of its passes, and whether the
# passes exchange by shuffles inside a warp (radices (P, T) or (P,)) or
# through shared memory. Every other N takes the direct DFT.
PFB_PLANS = {
    (1, 0): (2, (2,), True),
    (2, 0): (4, (4,), True),
    (3, 0): (8, (8,), True),
    (4, 0): (8, (8, 2), True),
    (5, 0): (8, (8, 4), True),
    (6, 0): (8, (8, 8), True),
    (7, 0): (16, (16, 8), True),
    (8, 0): (16, (16, 16), True),
    (9, 0): (16, (8, 8, 8), False),
    (10, 0): (16, (4, 16, 16), False),
    (11, 0): (16, (8, 16, 16), False),
    (12, 0): (16, (16, 16, 16), False),
    (13, 0): (32, (16, 16, 32), False),
    (0, 1): (1, (), True),
    (1, 1): (2, (2,), True),
    (2, 1): (4, (4,), True),
    (3, 1): (4, (4, 2), True),
    (4, 1): (4, (4, 4), True),
    (5, 1): (8, (8, 4), True),
    (6, 1): (8, (8, 8), True),
    (7, 1): (8, (8, 4, 4), False),
    (8, 1): (8, (8, 8, 4), False),
    (9, 1): (8, (8, 8, 8), False),
    (10, 1): (8, (8, 8, 4, 4), False),
    (11, 1): (8, (8, 8, 8, 4), False),
}
# Output rows a step of the direct DFT: about this many points.
PFB_DIRECT_POINTS = 2048
# Blocks a launch aims at: a block walks ceil(steps / PFB_BLOCKS) steps.
PFB_BLOCKS = 1024
# Shared bytes a block may take while two blocks share an SM (228 KB an SM,
# 1 KB of it reserved a block).
PFB_SMEM_TWO = SMEM_PER_SM // 2 - 1024
# The channel-major layouts walk interleaved steps where a step writes less than
# a line of this many bytes of a channel (see PfbGeometry.interleave).
PFB_LINE_BYTES = 128


def pfb_plan(n: int) -> tuple[int, int] | None:
    """(log2 M, K3) of the FFT plan for N = 3^K3 * M, or None for the direct DFT."""
    k3 = 1 if n % 3 == 0 else 0
    m = n // 3 if k3 else n
    if m < 1 or m & (m - 1) or (n == 1):
        return None
    key = (m.bit_length() - 1, k3)
    return key if key in PFB_PLANS else None


def ring_stride(n: int) -> int:
    """Floats a staged input row takes (csrc/pfb.cu ring_stride)."""
    r4 = -(-n // 4) * 4
    return r4 + 4 if r4 % 16 == 0 else r4


def exchange_slots(n: int) -> int:
    """Complex slots a transform's exchange takes in the shared-memory plans."""
    return n + n // 16 + 4


@dataclasses.dataclass(frozen=True)
class PfbGeometry:
    """The launch geometry of B19 (``raw``) or B20 for an (m, n) analysis with
    p taps a phase at dilation d: the plan, rows a step, the ring of staged
    input rows (its look-back and prefetch), steps a block, shared bytes."""

    n: int
    p: int
    d: int
    raw: bool
    m: int
    layout: str = "rows"

    @property
    def plan(self) -> tuple[int, int] | None:
        return pfb_plan(self.n)

    @property
    def k(self) -> int:
        """Sub-transforms: 3 for N = 3M, else 1."""
        return 3 if self.plan and self.plan[1] else 1

    @property
    def sub_n(self) -> int:
        """M: points of a sub-transform."""
        return self.n // self.k

    @property
    def points(self) -> int:
        return PFB_PLANS[self.plan][0]

    @property
    def radices(self) -> tuple:
        return PFB_PLANS[self.plan][1]

    @property
    def warp(self) -> bool:
        """The exchanges are shuffles inside a warp (else shared memory)."""
        return PFB_PLANS[self.plan][2]

    @property
    def threads_per_transform(self) -> int:
        return self.sub_n // self.points

    @property
    def rows(self) -> int:
        """Output rows a step: two a transform (FFT plans), or the direct DFT's."""
        if self.plan is None:
            return max(1, PFB_DIRECT_POINTS // self.n)
        return 2 * (PFB_THREADS // self.threads_per_transform)

    @property
    def rs(self) -> int:
        return ring_stride(self.n)

    @property
    def extra_bytes(self) -> int:
        """Shared bytes beside the ring: the exchange (shared-memory plans), or
        the direct DFT's v lines and twiddles."""
        if self.plan is None:
            return 4 * (-(-self.rows * (self.n + 1) // 2) * 2) + 8 * self.n
        if self.warp:
            return 0
        return 8 * (PFB_THREADS // self.threads_per_transform) * exchange_slots(self.n)

    @property
    def full_lookback(self) -> int:
        """Input rows before a step that its taps read: d (P-1), one more for B19."""
        return self.d * (self.p - 1) + (1 if self.raw else 0)

    @property
    def interleave(self) -> bool:
        """Block b walks steps b, b + blocks, ... rather than a run of consecutive
        steps: in the channel-major layouts, where a step writes less than a
        PFB_LINE_BYTES line of each channel, so that the blocks running together
        complete each line in L2 (a run would keep a part-written line of every
        channel open a block: 67 MB at n=1024, past the 50 MB L2). Each step then
        stages its own look-back."""
        width = {"rows": 0, "channels": 4, "complex": 8}[self.layout]
        return width > 0 and self.rows * width < PFB_LINE_BYTES

    def ring_rows(self, lookback: int, prefetch: int) -> int:
        if self.interleave:
            return (1 + prefetch) * (lookback + self.rows)
        return lookback + (1 + prefetch) * self.rows

    def ring_bytes(self, lookback: int, prefetch: int) -> int:
        return 4 * self.ring_rows(lookback, prefetch) * self.rs

    @property
    def staging(self) -> tuple[int, int]:
        """(lookback, prefetch): the whole look-back with the next step prefetched
        where two blocks still fit an SM, then without, then one block an SM;
        past that the look-back is cut (its older taps read device memory)."""
        full = self.full_lookback
        for limit in (PFB_SMEM_TWO, SMEM_MAX):
            for prefetch in (1, 0):
                if self.extra_bytes + self.ring_bytes(full, prefetch) <= limit:
                    return full, prefetch
        room = (SMEM_MAX - self.extra_bytes) // (4 * self.rs) - self.rows
        if room < 0:
            raise ValueError(f"the PFB kernels have no room for one step at n={self.n}")
        return min(full, room), 0

    @property
    def lookback(self) -> int:
        return self.staging[0]

    @property
    def prefetch(self) -> int:
        return self.staging[1]

    @property
    def cap(self) -> int:
        """Ring rows: the look-back, this step, and the next one when prefetched."""
        return self.ring_rows(self.lookback, self.prefetch)

    @property
    def resident(self) -> int:
        """Taps r < resident read the ring; the rest read device memory."""
        raw = 1 if self.raw else 0
        if self.lookback < raw:
            return 0
        return min(self.p, (self.lookback - raw) // self.d + 1)

    @property
    def smem_bytes(self) -> int:
        return self.extra_bytes + self.ring_bytes(self.lookback, self.prefetch)

    @property
    def total_steps(self) -> int:
        return cdiv(self.m, self.rows)

    @property
    def steps(self) -> int:
        """Steps a block walks."""
        return max(1, cdiv(self.total_steps, PFB_BLOCKS))

    @property
    def blocks(self) -> int:
        return cdiv(self.total_steps, self.steps)


def pfb_geometry(n: int, p: int = 8, d: int = 1, raw: bool = False, m: int = 1,
                 layout: str = "rows") -> PfbGeometry:
    """B19's (``raw``) or B20's launch geometry (see :class:`PfbGeometry`)."""
    if not 1 <= n <= PFB_MAX_N:
        raise ValueError(f"the PFB kernels take N <= {PFB_MAX_N}, got {n}")
    return PfbGeometry(n, p, d, raw, m, layout)


def pfb_rows(n: int) -> int:
    """Output rows a step of B19/B20 at N channels."""
    return pfb_geometry(n).rows


def pfb_kernel_attrs(kind: str, n: int, p: int = 8, d: int = 1) -> tuple:
    """What the compiler gave B19 (``kind="B19"``) or B20 at n channels, with the
    shared memory of p taps at dilation d (the card only): (registers a thread,
    local bytes a thread, shared bytes a block, blocks an SM, threads a block)."""
    g = pfb_geometry(n, p, d, kind == "B19")
    lib = _build.library()
    out = (ctypes.c_int64 * 5)()
    _build.check(
        lib.dsp_pfb_attrs(0 if kind == "B19" else 1, n, g.smem_bytes, ctypes.addressof(out)),
        "pfb_kernel_attrs",
    )
    return tuple(out)


def branch_fir(u: torch.Tensor, hq: torch.Tensor, *, dilation: int = 1) -> torch.Tensor:
    """Per-phase causal FIR over the block index m: (batch, M, N) -> (batch, M, N).

    ``v[b, m, q] = sum_r hq[r, q] * u[b, m - dilation*r, q]``, zeros before
    m = 0, summed over r in order (as B19 and B20 do).
    """
    p, _ = hq.shape
    m = u.shape[-2]
    up = F.pad(u.to(hq.dtype), (0, 0, dilation * (p - 1), 0))
    v = None
    for r in range(p):
        off = dilation * (p - 1 - r)
        term = up[..., off : off + m, :] * hq[r]
        v = term if v is None else v + term
    return v


@functools.lru_cache(maxsize=32)
def _dft_constants(n: int, sign: int, device: str,
                   dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sign*sin of 2*pi*q*k/N, in float64 rounded to ``dtype`` (float32: the
    reference's)."""
    qk = np.outer(np.arange(n), np.arange(n)) * (2.0 * np.pi / n)
    cos = torch.from_numpy(np.cos(qk)).to(device, dtype)
    sin = torch.from_numpy(np.sin(qk) * sign).to(device, dtype)
    return cos, sin


def dft_matmul(
    re_in: torch.Tensor, im_in: torch.Tensor | None, n: int, *, sign: int = 1
) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., N) @ DFT_N as matmuls: sum_q v[q] e^{sign*2*pi*i*q*k/N}, in IEEE float32
    (float64 for float64 input)."""
    dtype = torch.float64 if re_in.dtype == torch.float64 else torch.float32
    cos, sin = _dft_constants(n, sign, str(re_in.device), dtype)
    with ieee_fp32_matmul():
        if im_in is None:
            return re_in @ cos, re_in @ sin
        return re_in @ cos - im_in @ sin, re_in @ sin + im_in @ cos


def _check_taps(hq: torch.Tensor, n: int, device: torch.device) -> torch.Tensor:
    if hq.dim() != 2 or hq.shape[1] != n or hq.shape[0] < 1:
        raise ValueError(f"hq must be (P, {n}), got shape {tuple(hq.shape)}")
    if hq.device != device:
        raise ValueError(f"hq on {hq.device}, signal on {device}")
    return hq.to(torch.float32).contiguous()


def _arrange(re: torch.Tensor, im: torch.Tensor, layout: str):
    """(M, N) planes in the caller's layout (the plain versions' last step)."""
    if layout == "rows":
        return re, im
    if layout == "channels":
        return re.T, im.T
    return torch.complex(re, im).T


def _pfb_plain(u: torch.Tensor, hq: torch.Tensor, sign: int, dilation: int, layout: str):
    v = branch_fir(u[None], hq, dilation=dilation)[0]
    re, im = dft_matmul(v, None, hq.shape[1], sign=sign)
    return _arrange(re, im, layout)


def commutate(x: torch.Tensor, n: int) -> torch.Tensor:
    """The branch inputs u[m, q] = x[N*m - q] of a (M*N,) stream, zeros before it."""
    xp = x.to(torch.float32).reshape(-1, n)
    rev = xp.flip(1)
    return torch.cat([xp[:, :1], F.pad(rev[:-1, : n - 1], (0, 0, 1, 0))], dim=1)


_LAYOUT_CODES = {"rows": 0, "channels": 1, "complex": 2}


def _launch(entry: str, src: torch.Tensor, hq: torch.Tensor, m: int, n: int, sign: int,
            dilation: int, layout: str):
    g = pfb_geometry(n, hq.shape[0], dilation, entry == "dsp_pfb_raw", max(m, 1), layout)
    dev = src.device
    if layout == "complex":
        y = torch.empty((n, m), dtype=torch.complex64, device=dev)
        re_ptr, im_ptr = y.data_ptr(), y.data_ptr() + 4
        sk, sm = 2 * m, 2
        out = y
    else:
        shape, (sk, sm) = ((m, n), (1, n)) if layout == "rows" else ((n, m), (m, 1))
        re, im = (torch.empty(shape, dtype=torch.float32, device=dev) for _ in range(2))
        re_ptr, im_ptr = re.data_ptr(), im.data_ptr()
        out = (re, im)
    if m == 0:
        return out
    tw = _twiddles(n, str(dev)) if g.plan is None else None  # the direct DFT's table
    lib = _build.library()
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            src.data_ptr(), hq.data_ptr(), None if tw is None else tw.data_ptr(), re_ptr, im_ptr,
            m, n, hq.shape[0], dilation, sign, sk, sm, _LAYOUT_CODES[layout], g.rows, g.steps,
            int(g.interleave), g.lookback, g.prefetch, g.smem_bytes, _stream(src),
        )
    _build.check(err, entry)
    return out


def _check_options(sign: int, dilation: int, layout: str) -> None:
    if sign not in (1, -1):
        raise ValueError(f"sign must be +1 or -1, got {sign}")
    if dilation < 1:
        raise ValueError(f"dilation must be >= 1, got {dilation}")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; options {LAYOUTS}")


def _b20(u: torch.Tensor, hq: torch.Tensor, sign: int, dilation: int, layout: str):
    m, n = u.shape
    y = _launch("dsp_pfb_branch", u.to(torch.float32).contiguous(), hq, m, n, sign, dilation,
                layout)
    fused_branch_dft.launches += 1
    return y


class BranchDftTapsGrad(torch.autograd.Function):
    """B20 (the plain pair on the CPU) with its gradients with respect to ``u`` and ``hq``.

    With ``re[m, k] = sum_q v[m, q] C[q, k]``, ``im[m, k] = sum_q v[m, q] S[q, k]``
    (C, S the cos and sign*sin of the DFT) and ``v[m, q] = sum_r hq[r, q]
    u[m - d r, q]``: the incoming (re, im) gradients go back through the DFT's
    adjoint, ``gv = g_re C^T + g_im S^T``; then ``g_hq[r, q] = sum_m gv[m, q]
    u[m - d r, q]`` correlates them with u at the dilation, and ``g_u[m, q] =
    sum_r hq[r, q] gv[m + d r, q]`` is the anti-causal correlation of gv with
    the taps, cut at the end of the stream. Plain PyTorch (IEEE float32
    products; float64 on the CPU for float64 input): the reference has no
    backward kernel. Each gradient is computed only where it is asked for.
    """

    @staticmethod
    def forward(ctx, u, hq, sign: int, dilation: int, layout: str):
        ctx.save_for_backward(u, hq)
        ctx.options = (sign, dilation, layout)
        if _on_cuda(u):
            return _b20(u, hq, sign, dilation, layout)
        return _pfb_plain(u, hq, sign, dilation, layout)

    @staticmethod
    def backward(ctx, *grads):
        u, hq = ctx.saved_tensors
        sign, dilation, layout = ctx.options
        p, n = hq.shape
        m = u.shape[0]
        if layout == "complex":
            g = grads[0]
            g_re, g_im = (None, None) if g is None else (g.real.T, g.imag.T)
        elif layout == "channels":
            g_re, g_im = (None if g is None else g.T for g in grads)
        else:
            g_re, g_im = grads
        cos, sin = _dft_constants(n, sign, str(u.device), hq.dtype)
        gv = torch.zeros((m, n), dtype=hq.dtype, device=u.device)
        with ieee_fp32_matmul():
            if g_re is not None:
                gv = gv + g_re.to(hq.dtype) @ cos.T
            if g_im is not None:
                gv = gv + g_im.to(hq.dtype) @ sin.T
        lag = dilation * (p - 1)
        g_u = g_hq = None
        if ctx.needs_input_grad[0]:
            gvp = F.pad(gv, (0, 0, 0, lag))  # zeros past the stream's end
            g_u = hq[0] * gvp[:m]
            for r in range(1, p):
                g_u = g_u + hq[r] * gvp[dilation * r : dilation * r + m]
            g_u = g_u.to(u.dtype)
        if ctx.needs_input_grad[1]:
            up = F.pad(u.to(hq.dtype), (0, 0, lag, 0))
            g_hq = torch.stack([
                (gv * up[lag - dilation * r : lag - dilation * r + m]).sum(0) for r in range(p)
            ])
        return g_u, g_hq, None, None, None


def fused_branch_dft(
    u: torch.Tensor, hq: torch.Tensor, *, sign: int = 1, dilation: int = 1, layout: str = "rows"
):
    """Fused ``branch_fir`` + ``dft_matmul`` (real input) by B20: (M, N) -> planes.

    Returns (re, im) in ``layout`` "rows" (M, N) or "channels" (N, M), or one
    (N, M) complex64 tensor for "complex". Where grad mode is on and ``u`` or
    ``hq`` requires a gradient the call goes through
    :class:`BranchDftTapsGrad`: B20 forward on the card, the gradients in
    plain PyTorch.
    """
    _check_options(sign, dilation, layout)
    if not isinstance(u, torch.Tensor) or u.dim() != 2:
        raise ValueError("u must be an (M, N) tensor")
    hq = _check_taps(hq, u.shape[1], u.device)
    if torch.is_grad_enabled() and (u.requires_grad or hq.requires_grad):
        return BranchDftTapsGrad.apply(u, hq, sign, dilation, layout)
    if not _on_cuda(u):
        return _pfb_plain(u, hq, sign, dilation, layout)
    return _b20(u, hq, sign, dilation, layout)


fused_branch_dft.launches = 0


def raw_envelope(t: int, n: int) -> bool:
    """B19's envelope, the reference's: T % 128 == 0 with n in (32, 64, 128), or
    T % n == 0 with n in (256, 512, 1024)."""
    if n <= 128:
        return t % 128 == 0 and n in (32, 64, 128)
    return n in (256, 512, 1024) and t % n == 0


def fused_pfb_raw(
    x: torch.Tensor, n: int, hq: torch.Tensor, *, sign: int = 1, dilation: int = 1,
    layout: str = "rows",
):
    """Raw-stream fused PFB analysis by B19: (T,) float32 -> planes (``layout`` as
    for :func:`fused_branch_dft`; the reference's (M, N) planes by default)."""
    _check_options(sign, dilation, layout)
    t = x.shape[-1]
    if not raw_envelope(t, n):
        raise ValueError(
            "fused_pfb_raw needs len % 128 == 0 and n in "
            f"(32, 64, 128, 256, 512, 1024); got len={t}, n={n}"
        )
    if x.dim() != 1:
        raise ValueError(f"expected a flat (time,) stream, got shape {tuple(x.shape)}")
    hq = _check_taps(hq, n, x.device)
    if not _on_cuda(x):
        return _pfb_plain(commutate(x, n), hq, sign, dilation, layout)
    refuse_grad("fused_pfb_raw (B19)", x, hq)
    y = _launch("dsp_pfb_raw", x.to(torch.float32).contiguous(), hq, t // n, n, sign, dilation,
                layout)
    fused_pfb_raw.launches += 1
    return y


fused_pfb_raw.launches = 0


def design_prototype(
    n_channels: int, taps_per_phase: int = 8, *, window: str | tuple = "hamming"
) -> np.ndarray:
    """Prototype lowpass for an N-channel PFB: cutoff at the channel edge."""
    return design_lowpass(n_channels * taps_per_phase, 1.0 / n_channels, window=window)


def _phase_taps(taps, n: int, device: torch.device) -> torch.Tensor:
    """(P, N) branch taps hq[r, q] = h[r*N + q] of ``taps`` (the prototype when None)."""
    h = _taps_on(design_prototype(n) if taps is None else taps, device)
    p = cdiv(h.shape[0], n)
    return F.pad(h, (0, p * n - h.shape[0])).reshape(p, n)


def _channelize(x: torch.Tensor, n: int, taps, method: str, layout: str):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.dim() != 1:
        raise ValueError(f"expected a flat (time,) stream, got shape {tuple(x.shape)}")
    t = x.shape[0]
    if t % n != 0:
        raise ValueError(f"stream length {t} not a multiple of n_channels {n}")
    hq = _phase_taps(taps, n, x.device)
    if method == "auto":
        if _on_cuda(x) and hq.shape[0] > 1:
            method = "fused_raw" if raw_envelope(t, n) else "fused"
        else:
            method = "composed"
    if method not in ("fused_raw", "fused", "composed"):
        raise ValueError(
            f"unknown method {method!r}; options ('auto', 'fused_raw', 'fused', 'composed')"
        )
    record_choice("pfb_channelize", method)
    if method == "fused_raw":
        return fused_pfb_raw(x, n, hq, sign=1, layout=layout)
    u = commutate(x, n)
    if method == "fused":
        return fused_branch_dft(u, hq, sign=1, layout=layout)
    return _pfb_plain(u, hq, 1, 1, layout)


def pfb_channelize(
    x: torch.Tensor, n_channels: int, taps=None, *, method: str = "auto"
) -> torch.Tensor:
    """Split a real stream into N complex baseband channels at rate fs/N.

    ``x``: (time,) float32, length a multiple of ``n_channels``. Returns
    (n_channels, time // n_channels) complex64, channel k centred at
    normalised frequency k/N cycles a sample (k > N/2 the negative
    frequencies, as in an FFT).
    """
    return _channelize(x, n_channels, taps, method, "complex")


def pfb_channelize_planar(
    x: torch.Tensor, n_channels: int, taps=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`pfb_channelize` as (I, Q) float32 planes, each (N, T/N); on the card
    the kernel writes the planes directly."""
    return _channelize(x, n_channels, taps, "auto", "channels")


def pfb_synthesize(channels: torch.Tensor, taps=None) -> torch.Tensor:
    """Inverse of :func:`pfb_channelize`: N complex basebands -> wideband.

    ``x[n] = sum_k sum_m Y[k, m] g[n - m*N] e^{2*pi*i*k*n/N}``: the channel
    DFT across k, the per-phase interpolation FIR with the gain-compensated
    prototype, the plain phase interleave. ``channels``: (N, M) complex64 ->
    (N*M,) complex64.
    """
    n, _ = channels.shape
    g = _phase_taps(taps, n, channels.device) * n
    yi = channels.real.to(torch.float32).T
    yq = channels.imag.to(torch.float32).T
    s_re, s_im = dft_matmul(yi, yq, n)
    v = branch_fir(torch.stack([s_re, s_im]), g)  # (2, M, N)
    return torch.complex(v[0].reshape(-1), v[1].reshape(-1))


def pfb_synthesize_planar(
    ch_i: torch.Tensor, ch_q: torch.Tensor, taps=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`pfb_synthesize` with planar I/Q in and out."""
    y = pfb_synthesize(torch.complex(ch_i.to(torch.float32), ch_q.to(torch.float32)), taps)
    return y.real, y.imag


def pfb_stream_init(n_channels: int, taps_len: int | None = None, *, device="cuda") -> torch.Tensor:
    """Zero carry for :func:`pfb_channelize_chunk`: the last ceil(taps/N) input
    blocks (the analysis filter's memory)."""
    p = cdiv(taps_len or 8 * n_channels, n_channels)
    return torch.zeros((p * n_channels,), dtype=torch.float32, device=resolve_device(device))


def _chunk_ext(state: torch.Tensor, x: torch.Tensor, n: int, taps) -> torch.Tensor:
    halo = state.shape[0]
    taps_len = 8 * n if taps is None else int(taps.shape[0])
    need = cdiv(taps_len, n) * n
    if halo != need:
        raise ValueError(
            f"carried state holds {halo} samples but these taps need {need} "
            f"(pfb_stream_init(n_channels, taps_len={taps_len}))"
        )
    return torch.cat([state, x.to(torch.float32)])


def pfb_channelize_chunk(
    state: torch.Tensor, x: torch.Tensor, n_channels: int, taps=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the analysis bank with the carried raw-sample blocks.

    Prepend the carried blocks, channelize, drop their output columns. The
    chunk length must be a multiple of ``n_channels``; the outputs match one
    shot on the concatenated stream to float rounding.
    """
    ext = _chunk_ext(state, x, n_channels, taps)
    halo = state.shape[0]
    y = pfb_channelize(ext, n_channels, taps)[:, halo // n_channels :]
    return ext[ext.shape[0] - halo :], y


def pfb_channelize_chunk_planar(
    state: torch.Tensor, x: torch.Tensor, n_channels: int, taps=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`pfb_channelize_chunk` returning (state, I, Q) float32."""
    ext = _chunk_ext(state, x, n_channels, taps)
    halo = state.shape[0]
    i, q = pfb_channelize_planar(ext, n_channels, taps)
    return ext[ext.shape[0] - halo :], i[:, halo // n_channels :], q[:, halo // n_channels :]


__all__ = [
    "LAYOUTS",
    "PFB_MAX_N",
    "pfb_channelize",
    "pfb_channelize_planar",
    "pfb_synthesize",
    "pfb_synthesize_planar",
    "pfb_stream_init",
    "pfb_channelize_chunk",
    "pfb_channelize_chunk_planar",
    "branch_fir",
    "commutate",
    "fused_branch_dft",
    "fused_pfb_raw",
    "dft_matmul",
    "design_prototype",
    "raw_envelope",
    "pfb_geometry",
    "pfb_kernel_attrs",
]
