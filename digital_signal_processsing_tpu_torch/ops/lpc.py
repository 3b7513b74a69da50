"""Linear-predictive coding: frame-wise analysis and the all-pole vocoder filter.

Counterpart of ``digital_signal_processsing_tpu/ops/lpc.py``. Analysis is the
autocorrelation method with a batched Levinson-Durbin recursion; synthesis
runs ``y = gain * e / A(z)`` with one polynomial a frame and the state carried
across frames, by five methods with the reference's names:

- ``refine`` (``auto`` when ``frame_len % 8 == 0``): every frame from rest,
  then ``sweeps`` passes re-seeding frame f with frame f-1's end state;
- ``pallas``: one pass from rest, the frame-entry states from the affine
  compose (A^L by squaring, a Hillis-Steele scan over frames), one seeded
  pass;
- ``scan``: the compose with a zero-input basis instead of a second pass;
- ``factored``: the polynomials factored on the host into biquads, run by
  ``sosfilt_tv_frames`` (B18): the engine for poles near the unit circle;
- ``auto``: ``factored`` for a frame-constant set whose largest pole radius
  is 0.95 or more, else ``refine`` (``scan`` when ``frame_len % 8 != 0``).

The passes of ``refine`` and ``pallas`` are kernel B22 (``csrc/lpc.cu``: a
thread walks one frame with its history in registers): :func:`lpc_synth_pass`
where y is kept, :func:`lpc_synth_state` (the end state alone, half the
bytes) where it is thrown away; on a CPU tensor each takes its plain
version, the same recurrence vectorised over frames, bit for bit. The p x p products and the scan over
frames are plain PyTorch, pinned to IEEE float32.

Where this module differs from the reference on purpose:

- ``auto`` moves the coefficients to the host once and factors them at most
  once a call, passing the sections on to the factored engine (the
  reference factors twice);
- torch tensors are never traced, so ``lpc_synthesis_factored`` has no
  refusal of traced coefficients;
- ``lpc_vocoder(excitation=None)`` draws its noise from a ``torch.Generator``
  seeded 0, which cannot give ``jax.random``'s numbers: pass the excitation
  to compare the two packages.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..utils.device import resolve_device
from ..utils.dispatch import record_choice, refuse_grad
from ..utils.layout import overlapping_frames
from .fft import spectral_window
from .fir import ieee_fp32_matmul
from .iir import _coef, sosfilt_tv_frames
from .pallas_scan import _on_cuda, _stream

_LPC_BT = 8  # the reference's unrolled steps a kernel call: refine/pallas need L % 8 == 0
MAX_UNROLLED_ORDER = 32  # csrc/lpc.cu: orders with the history in registers


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def levinson(r, *, device="cuda"):
    """Batched Levinson-Durbin: Toeplitz autocorrelation -> AR coefficients.

    ``r``: ``(..., p+1)`` lags (lag 0 first); a tensor stays on its device,
    anything else goes to ``device``. Returns ``(a, k, err)``: the
    prediction polynomial ``(..., p+1)`` with ``a[..., 0] == 1``, the
    reflection coefficients ``(..., p)`` and the final prediction-error power
    ``(...,)``, all float32 (scipy's ``solve_toeplitz`` / librosa's
    convention: the synthesis filter is ``1/A(z)``).
    """
    r = _coef(r, r.device if isinstance(r, torch.Tensor) else resolve_device(device))
    p = r.shape[-1] - 1
    a = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
    a[..., 0] = 1.0
    err = r[..., 0]
    ks = []
    for m in range(1, p + 1):
        # acc = r[m] + sum_{i=1}^{m-1} a[i] r[m-i]  (a[i] = 0 for i >= m)
        rrev = torch.zeros_like(r)
        rrev[..., : m + 1] = torch.flip(r[..., : m + 1], [-1])
        acc = torch.sum(a * rrev, -1)
        k = -acc / torch.where(err > 0, err, torch.ones_like(err))
        k = torch.where(err > 0, k, torch.zeros_like(k))
        arev = torch.zeros_like(a)
        arev[..., : m + 1] = torch.flip(a[..., : m + 1], [-1])
        a = a + k[..., None] * arev
        err = err * (1.0 - k * k)
        ks.append(k)
    k_all = torch.stack(ks, -1) if ks else r.new_zeros(r.shape[:-1] + (0,))
    return a, k_all, err


def frame_autocorr(x: torch.Tensor, order: int, frame_len: int, *, hop: int | None = None,
                   window: str | None = "hamming") -> torch.Tensor:
    """Windowed per-frame autocorrelation lags ``(..., F, order+1)``.

    Frame f covers ``x[..., f*hop : f*hop + frame_len]`` (``hop`` defaults
    to ``frame_len``).
    """
    if hop is None:
        hop = frame_len
    n = x.shape[-1]
    nframes = max(0, (n - frame_len) // hop + 1)
    fr = overlapping_frames(x.to(torch.float32), nframes, hop, frame_len)
    if window is not None:
        fr = fr * torch.from_numpy(spectral_window(window, frame_len)).to(x.device)
    lags = [torch.sum(fr * fr, -1)]
    for k in range(1, order + 1):
        lags.append(torch.sum(fr[..., : frame_len - k] * fr[..., k:], -1))
    return torch.stack(lags, -1)


def lpc(x: torch.Tensor, order: int, frame_len: int, *, hop: int | None = None,
        window: str | None = "hamming") -> tuple[torch.Tensor, torch.Tensor]:
    """Frame-wise LPC analysis: ``(a, gain)``.

    ``a``: ``(..., F, order+1)`` prediction polynomials (``a[..., 0] = 1``);
    ``gain``: ``(..., F)``, the square root of the residual power, so unit
    white excitation through ``gain / A(z)`` reproduces each frame's
    spectrum.
    """
    r = frame_autocorr(x, order, frame_len, hop=hop, window=window)
    a, _, err = levinson(r)
    return a, torch.sqrt(torch.clamp(err, min=0.0))


def _companion(a: torch.Tensor) -> torch.Tensor:
    """(..., p+1) polynomial -> (..., p, p) companion transition matrix."""
    p = a.shape[-1] - 1
    below = torch.diag(torch.ones(max(p - 1, 0), dtype=a.dtype, device=a.device), -1)
    m = below.expand(a.shape[:-1] + (p, p)).clone()
    m[..., 0, :] = -a[..., 1:]
    return m


def _matrix_power(m: torch.Tensor, n: int) -> torch.Tensor:
    """Batched m^n by square-and-multiply, in IEEE float32."""
    p = m.shape[-1]
    acc = torch.eye(p, dtype=m.dtype, device=m.device).expand(m.shape)
    with ieee_fp32_matmul():
        while n:
            if n & 1:
                acc = acc @ m
            n >>= 1
            if n:
                m = m @ m
    return acc


def _compose_frames(m: torch.Tensor, z: torch.Tensor, axis: int) -> torch.Tensor:
    """Frame-entry states: s0[f] = z-part of the maps of frames < f composed.

    m: (..., F, p, p) each frame's transition, z: (..., F, p) its end state
    from rest, F at ``axis``. A Hillis-Steele scan in place of the
    reference's associative scan: (M, z) after (M', z') is (M M', M z' + z).
    """
    m = m.movedim(axis, 0)
    z = z.movedim(axis, 0)
    nf = m.shape[0]
    d = 1
    with ieee_fp32_matmul():
        while d < nf:
            z = torch.cat([z[:d], (m[d:] @ z[:-d, ..., None])[..., 0] + z[d:]], 0)
            m = torch.cat([m[:d], m[d:] @ m[:-d]], 0)
            d *= 2
    s0 = torch.cat([torch.zeros_like(z[:1]), z[:-1]], 0)
    return s0.movedim(0, axis)


# --- B22: the seeded recurrence, a thread a frame ----------------------------------


def _lpc_pass_plain(a_f: torch.Tensor, s0: torch.Tensor, e: torch.Tensor):
    """Plain version of B22: the recurrence vectorised over frames, in the
    kernel's order of operations (each product and difference rounded apart)."""
    frames, length = e.shape
    p = a_f.shape[1]
    coef = [a_f[:, i] for i in range(p)]
    h = [s0[:, i] for i in range(p)]
    y = torch.empty_like(e)
    for t in range(length):
        acc = e[:, t]
        for i in range(p):
            acc = acc - coef[i] * h[i]
        h = [acc] + h[:-1]
        y[:, t] = acc
    return y, (torch.stack(h, 1) if p else s0.clone())


def _check_pass(a_f: torch.Tensor, s0: torch.Tensor, e: torch.Tensor, name: str) -> None:
    for arg, v in (("a_f", a_f), ("s0", s0), ("e", e)):
        if not isinstance(v, torch.Tensor) or v.dim() != 2 or v.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be a 2-D float32 tensor")
        if v.device != e.device:
            raise ValueError(f"{name}: {arg} on {v.device}, e on {e.device}")
    frames = e.shape[0]
    p = a_f.shape[1]
    if a_f.shape[0] != frames or tuple(s0.shape) != (frames, p):
        raise ValueError(
            f"{name}: a_f {tuple(a_f.shape)} and s0 {tuple(s0.shape)} for {frames} frames"
        )


def _launch_pass(a_f: torch.Tensor, s0: torch.Tensor, e: torch.Tensor, keep_y: bool, name: str):
    """One launch of B22 on CUDA tensors the caller has checked: (y or None, end state)."""
    p = a_f.shape[1]
    a_f, s0, e = a_f.contiguous(), s0.contiguous(), e.contiguous()
    y = torch.empty_like(e) if keep_y else None
    z = torch.empty_like(s0)
    hist = torch.empty_like(s0) if p > MAX_UNROLLED_ORDER else None
    lib = _build.library()
    with torch.cuda.device(e.device):
        err = lib.dsp_lpc_synth(
            a_f.data_ptr(), s0.data_ptr(), e.data_ptr(), None if y is None else y.data_ptr(),
            z.data_ptr(), None if hist is None else hist.data_ptr(), e.shape[0], e.shape[1], p,
            _stream(e),
        )
    _build.check(err, name)
    lpc_synth_pass.launches += 1
    return y, z


def lpc_synth_pass(a_f: torch.Tensor, s0: torch.Tensor, e: torch.Tensor):
    """One seeded synthesis sweep by B22: ``(y, end state)``.

    ``a_f``: (frames, p) the polynomials' coefficients after the leading 1;
    ``s0``: (frames, p) each frame's entry state, most recent output first;
    ``e``: (frames, L) the scaled excitation. All float32 on one device; the
    end state has ``s0``'s layout.
    """
    _check_pass(a_f, s0, e, "lpc_synth_pass")
    if not _on_cuda(e):
        return _lpc_pass_plain(a_f, s0, e)
    refuse_grad("lpc_synth_pass (B22)", a_f, s0, e)
    if e.numel() == 0 or a_f.shape[1] == 0:
        return e.clone(), s0.clone()
    return _launch_pass(a_f, s0, e, True, "lpc_synth_pass")


def lpc_synth_state(a_f: torch.Tensor, s0: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The end state of :func:`lpc_synth_pass` alone, by B22's state-only
    launch: e and the state are read and only the end state is written (4
    bytes a sample against 8). Bit for bit the full pass's end state; counted
    among B22's launches."""
    _check_pass(a_f, s0, e, "lpc_synth_state")
    if not _on_cuda(e):
        return _lpc_pass_plain(a_f, s0, e)[1]
    refuse_grad("lpc_synth_state (B22)", a_f, s0, e)
    if e.numel() == 0 or a_f.shape[1] == 0:
        return s0.clone()
    return _launch_pass(a_f, s0, e, False, "lpc_synth_state")[1]


def lpc_kernel_attrs(p: int) -> tuple:
    """What the compiler gave B22's kernel for order ``p`` (the card only):
    (registers a thread, local bytes a thread, shared bytes a block, blocks an SM)."""
    out = (ctypes.c_int64 * 4)()
    with torch.cuda.device(torch.cuda.current_device()):
        err = _build.library().dsp_lpc_attrs(p, ctypes.addressof(out))
    _build.check(err, "lpc_kernel_attrs")
    return tuple(out)


lpc_synth_pass.launches = 0


# --- synthesis ------------------------------------------------------------------------


def _scaled(a, gain, excitation: torch.Tensor, frame_len: int):
    """(a (..., F, p+1), e * gain as (..., F, L), batch, F) on the excitation's device."""
    if not isinstance(excitation, torch.Tensor):
        raise TypeError(f"excitation must be a torch.Tensor, got {type(excitation).__name__}")
    dev = excitation.device
    a = _coef(a, dev)
    batch, nf = tuple(a.shape[:-2]), a.shape[-2]
    e = excitation.to(torch.float32).reshape(batch + (nf, frame_len))
    return a, e * _coef(gain, dev)[..., None], batch, nf


def lpc_synthesis(a, gain, excitation: torch.Tensor, frame_len: int, *,
                  method: str = "auto") -> torch.Tensor:
    """Time-varying all-pole synthesis ``y = gain * e / A(z)``, one polynomial
    a frame and the state carried across frames.

    ``a``: ``(..., F, p+1)``; ``gain``: ``(..., F)``; ``excitation``:
    ``(..., F*frame_len)`` on the device the work runs on. Returns
    ``(..., F*frame_len)``, the sequential recurrence ``y[t] = g_f e[t] -
    sum_i a_f[i] y[t-i]`` up to float32 association. Methods: see the module
    docstring; the reference's accuracy envelope holds (the compose of
    ``scan``/``pallas`` loses digits from pole radius about 0.95, refine's
    sweeps stop contracting near the circle, ``factored`` holds there).
    """
    if method not in ("auto", "scan", "pallas", "refine", "factored"):
        raise ValueError(f"unknown method {method!r}")
    if method == "factored":
        return lpc_synthesis_factored(a, gain, excitation, frame_len)
    if method == "auto":
        # one host copy and at most one factoring; the sections go on to the engine
        a_np = _host(a)
        row = _constant_frame_row(a_np)
        if row is not None:
            sos_row, radius = lpc_to_sections(row)
            if radius >= 0.95:
                record_choice("lpc_synthesis", "factored")
                sos = np.broadcast_to(sos_row, sos_row.shape[:-2] + (a_np.shape[-2], 6))
                return _synthesize_sections(sos, gain, excitation, frame_len)
    return _lpc_synthesis_core(a, gain, excitation, frame_len, method=method)


def _lpc_synthesis_core(a, gain, excitation, frame_len: int, *, method: str) -> torch.Tensor:
    if frame_len % _LPC_BT == 0:
        if method in ("auto", "refine"):
            return lpc_synthesis_refine(a, gain, excitation, frame_len)
        if method == "pallas":
            return lpc_synthesis_pallas(a, gain, excitation, frame_len)
    elif method in ("refine", "pallas"):
        raise ValueError(
            f"method {method!r}: frame_len must be a multiple of {_LPC_BT}, got {frame_len}"
        )
    a, e, batch, nf = _scaled(a, gain, excitation, frame_len)
    p = a.shape[-1] - 1
    big_a = _companion(a)  # (..., F, p, p)
    w = -a[..., 1:]  # e0^T A
    s = torch.zeros(batch + (nf, p), dtype=torch.float32, device=a.device)
    y0, basis = [], []
    with ieee_fp32_matmul():
        for t in range(frame_len):
            y = e[..., t] - torch.sum(a[..., 1:] * s, -1)
            s = torch.cat([y[..., None], s[..., :-1]], -1)
            basis.append(w)
            w = (w[..., None, :] @ big_a)[..., 0, :]
            y0.append(y)
    # frame-entry states: s0[f] = M[f-1] s0[f-1] + z[f-1], M = A^L, z the end from rest
    s0 = _compose_frames(_matrix_power(big_a, frame_len), s, len(batch))
    with ieee_fp32_matmul():
        y = torch.stack(y0, -1) + torch.einsum("t...fp,...fp->...ft", torch.stack(basis), s0)
    return y.reshape(batch + (nf * frame_len,))


def _frames_of(v: torch.Tensor, k: int) -> torch.Tensor:
    return v.reshape(-1, k).contiguous()


def lpc_synthesis_refine(a, gain, excitation: torch.Tensor, frame_len: int, *,
                         sweeps: int = 2) -> torch.Tensor:
    """All-pole synthesis by a pass from rest and ``sweeps`` refinement passes
    of B22: each re-seeds frame f with frame f-1's end state and re-runs.

    Entry-state errors contract by the frame's zero-input decay a sweep, so
    two sweeps reach the sequential float32 floor for damped polynomials;
    poles hugging the unit circle need ``factored``. Needs
    ``frame_len % 8 == 0``, as the reference does. Every pass but the last
    keeps only its end state (:func:`lpc_synth_state`).
    """
    if frame_len % _LPC_BT != 0:
        raise ValueError(f"frame_len must be a multiple of {_LPC_BT}, got {frame_len}")
    a, e, batch, nf = _scaled(a, gain, excitation, frame_len)
    p = a.shape[-1] - 1
    a_f, e_f = _frames_of(a[..., 1:], p), _frames_of(e, frame_len)
    s0 = torch.zeros_like(a_f)
    for _ in range(sweeps):
        z = lpc_synth_state(a_f, s0, e_f)
        # entry of frame f <- end of frame f-1, zero at each stream's head
        z = z.reshape(batch + (nf, p))
        s0 = _frames_of(torch.cat([torch.zeros_like(z[..., :1, :]), z[..., :-1, :]], -2), p)
    y, _ = lpc_synth_pass(a_f, s0, e_f)
    return y.reshape(batch + (nf * frame_len,))


def lpc_synthesis_pallas(a, gain, excitation: torch.Tensor, frame_len: int) -> torch.Tensor:
    """All-pole synthesis by two passes of B22 around the affine compose.

    Pass 1 runs every frame from rest for its end state alone
    (:func:`lpc_synth_state`); the frame-entry states come from the compose
    (A^L by squaring, a scan over frames); pass 2 re-runs every frame seeded.
    Needs ``frame_len % 8 == 0``.
    """
    if frame_len % _LPC_BT != 0:
        raise ValueError(f"frame_len must be a multiple of {_LPC_BT}, got {frame_len}")
    a, e, batch, nf = _scaled(a, gain, excitation, frame_len)
    p = a.shape[-1] - 1
    a_f, e_f = _frames_of(a[..., 1:], p), _frames_of(e, frame_len)
    z = lpc_synth_state(a_f, torch.zeros_like(a_f), e_f)
    m = _matrix_power(_companion(a), frame_len)
    s0 = _compose_frames(m, z.reshape(batch + (nf, p)), len(batch))
    y, _ = lpc_synth_pass(a_f, _frames_of(s0, p), e_f)
    return y.reshape(batch + (nf * frame_len,))


def lpc_synthesis_ref(a, gain, excitation, frame_len):
    """Sequential float64 golden model of :func:`lpc_synthesis` (NumPy, host)."""
    a = np.asarray(_host(a), np.float64)
    g = np.asarray(_host(gain), np.float64)
    e = np.asarray(_host(excitation), np.float64)
    p = a.shape[-1] - 1
    nf = a.shape[-2]
    y = np.zeros(nf * frame_len)
    hist = np.zeros(p)
    for f in range(nf):
        for t in range(frame_len):
            idx = f * frame_len + t
            v = g[f] * e[idx] - np.dot(a[f, 1:], hist)
            hist = np.concatenate([[v], hist[:-1]])
            y[idx] = v
    return y


def _constant_frame_row(a: np.ndarray) -> np.ndarray | None:
    """``(..., F, p+1)`` -> the shared ``(..., 1, p+1)`` row if every frame
    carries the same coefficients, else None (the ``auto`` router sends only
    frame-constant resonant sets to the factored engine)."""
    row = a[..., :1, :]
    return row if bool(np.all(a == row)) else None


def lpc_to_sections(a: np.ndarray) -> tuple[np.ndarray, float]:
    """Host-side root factoring: AR polynomials -> biquad cascade rows.

    ``a``: ``(..., F, p+1)``. Returns ``(sos, max_radius)``, ``sos`` of shape
    ``(S, ..., F, 6)`` in scipy layout (all-pole: b = [1, 0, 0]), S =
    ceil(p/2), and the largest pole magnitude. Float64 companion
    eigenvalues; conjugate pairs become (1, -2 Re r, |r|^2) sections, real
    roots pair by magnitude, an odd one left over a first-order section.
    """
    a = np.asarray(_host(a), np.float64)
    p = a.shape[-1] - 1
    batch = a.shape[:-1]  # (..., F)
    an = a / a[..., :1]
    comp = np.zeros(batch + (p, p))
    comp[..., 0, :] = -an[..., 1:]
    idx = np.arange(p - 1)
    comp[..., idx + 1, idx] = 1.0
    roots = np.linalg.eigvals(comp)  # (..., F, p) complex
    n_sec = -(-p // 2)
    flat = roots.reshape(-1, p)
    sos = np.zeros((flat.shape[0], n_sec, 6))
    sos[..., 0] = 1.0  # b0
    sos[..., 3] = 1.0  # a0
    tol = 1e-9
    for i, r in enumerate(flat):
        cplx = r[np.abs(r.imag) > tol * np.maximum(1.0, np.abs(r))]
        cplx = cplx[cplx.imag > 0]
        real = np.sort(r[np.abs(r.imag) <= tol * np.maximum(1.0, np.abs(r))].real)
        s = 0
        for rt in cplx:
            sos[i, s, 4] = -2.0 * rt.real
            sos[i, s, 5] = abs(rt) ** 2
            s += 1
        j = 0
        while j + 1 < real.size:
            sos[i, s, 4] = -(real[j] + real[j + 1])
            sos[i, s, 5] = real[j] * real[j + 1]
            s += 1
            j += 2
        if j < real.size:
            sos[i, s, 4] = -real[j]
            s += 1
        assert s == n_sec or (s == n_sec - 1 and real.size == 0 and p % 2), (s, n_sec, r)
    sos = sos.reshape(batch + (n_sec, 6))
    sos = np.moveaxis(sos, -2, 0)  # (..., F, S, 6) -> (S, ..., F, 6)
    return sos.astype(np.float32), float(np.max(np.abs(roots)))


def _synthesize_sections(sos: np.ndarray, gain, excitation: torch.Tensor,
                         frame_len: int) -> torch.Tensor:
    """The factored engine on given sections (S, ..., F, 6): B18 over the
    scaled excitation."""
    batch, nf = sos.shape[1:-2], sos.shape[-2]
    dev = excitation.device
    e = excitation.to(torch.float32).reshape(batch + (nf, frame_len)) * _coef(gain, dev)[..., None]
    rows = torch.from_numpy(np.ascontiguousarray(sos)).to(dev)
    return sosfilt_tv_frames(rows, e.reshape(batch + (nf * frame_len,)), frame_len)


def lpc_synthesis_factored(a, gain, excitation: torch.Tensor, frame_len: int) -> torch.Tensor:
    """All-pole synthesis through host-factored biquad sections (B18), the
    engine for poles near the unit circle.

    Each biquad's recurrence is well conditioned where the order-p
    recurrence is not, so the cascade tracks the sequential float64 model
    within the sequential float32 floor up to radius 0.999. Transition
    contract: frames carry the cascade's per-section states; for
    frame-constant coefficients this is the direct form exactly, for
    coefficients that change across frames the two realizations differ
    transiently at every jump (so ``auto`` routes only frame-constant sets
    here).
    """
    a_np = _host(a)
    row = _constant_frame_row(a_np)
    if row is not None:
        sos_row, _ = lpc_to_sections(row)  # factor one row, broadcast across frames
        sos = np.broadcast_to(sos_row, sos_row.shape[:-2] + (a_np.shape[-2], 6))
    else:
        sos, _ = lpc_to_sections(a_np)
    return _synthesize_sections(sos, gain, excitation, frame_len)


def lpc_vocoder(x: torch.Tensor, order: int, frame_len: int,
                excitation: torch.Tensor | None = None) -> torch.Tensor:
    """Analyze-resynthesize round trip: ``x``'s LPC envelope driven by
    ``excitation`` (pulses or noise; the prediction residual reconstructs
    the input). ``excitation=None`` draws unit white noise from a
    ``torch.Generator`` seeded 0 on ``x``'s device.
    """
    a, gain = lpc(x, order, frame_len)
    n = a.shape[-2] * frame_len
    if excitation is None:
        gen = torch.Generator(device=x.device)
        gen.manual_seed(0)
        excitation = torch.randn(tuple(x.shape[:-1]) + (n,), generator=gen, device=x.device)
    return lpc_synthesis(a, gain, excitation[..., :n], frame_len)


def ar_psd(x: torch.Tensor, order: int, *, nfft: int = 1024, frame_len: int | None = None,
           hop: int | None = None, window: str | None = "rect"):
    """AR (maximum-entropy) one-sided PSD by Levinson-Durbin: ``(f, psd)``.

    Fits an order-``order`` all-pole model and evaluates ``gain^2 /
    |A(e^{j 2 pi f})|^2`` on the ``nfft//2 + 1`` grid ``f = k/nfft``
    (cycles a sample), by products against cos/sin tables. With
    ``frame_len`` the estimate is frame-wise ``(..., F, nfft//2+1)``.
    """
    n = x.shape[-1]
    fl = n if frame_len is None else frame_len
    a, gain = lpc(x, order, fl, hop=hop, window=window)
    f = np.arange(nfft // 2 + 1) / nfft
    m = np.arange(order + 1)[:, None]
    cosb = torch.from_numpy(np.cos(2 * np.pi * m * f[None, :]).astype(np.float32)).to(x.device)
    sinb = torch.from_numpy(np.sin(2 * np.pi * m * f[None, :]).astype(np.float32)).to(x.device)
    with ieee_fp32_matmul():
        ar_ = a @ cosb  # Re A(e^{jw}) with the e^{-jwm} convention
        ai_ = -(a @ sinb)
    psd = (gain[..., None] ** 2) / torch.clamp(ar_ * ar_ + ai_ * ai_, min=1e-30)
    if frame_len is None:
        psd = psd[..., 0, :]
    return f, psd


__all__ = [
    "levinson",
    "frame_autocorr",
    "lpc",
    "lpc_synth_pass",
    "lpc_synthesis",
    "lpc_synthesis_refine",
    "lpc_synthesis_pallas",
    "lpc_synthesis_ref",
    "lpc_to_sections",
    "lpc_synthesis_factored",
    "lpc_vocoder",
    "ar_psd",
]
