"""scipy.signal drop-in namespace.

``from digital_signal_processsing_tpu_torch import compat as signal`` gives a
namespace whose callables carry scipy.signal's names and signatures, so a
scipy-written program runs against the port's ops unchanged. It mirrors the
reference package's ``compat.py`` with three kinds of members:

1. direct re-exports of ops written scipy-compatible from the start
   (``firwin``, ``find_peaks_cwt``, ``cont2discrete``, the LTI, spline,
   wavelet and 2-D surfaces, ...);
2. signature adapters, thin wrappers where the port's API is spelled
   differently (the classical designers with ``analog``/``output``/``fs``,
   ``sosfilt`` with ``axis`` and ``zi``, the spectral estimators with scipy's
   ``(f[, t], result)`` returns, ...);
3. nothing else: every adapter delegates to a tested op module.

Arrays that are not tensors go to the keyword-only ``device`` of each adapter
(the card by default), as everywhere in the port; a tensor stays on its
device. The filters run the port's kernels on the card: ``sosfilt``,
``lfilter``, ``sosfiltfilt``, ``filtfilt`` and ``decimate`` the SOS cascade
(B12), ``convolve``/``oaconvolve`` and the long ``hilbert`` the fused FIR (B8).
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.device import as_tensor

# --- 1. direct re-exports ------------------------------------------------------

from .ops.fir import (  # noqa: F401
    firwin,
    firwin_2d,
    kaiser_atten,
    kaiser_beta,
    kaiserord,
    minimum_phase,
    deconvolve,
)
from .ops.fft import (  # noqa: F401
    CZT,
    ZoomFFT,
    check_cola as check_COLA,
    check_nola as check_NOLA,
    czt,
    czt_points,
    get_window,
    hilbert2,
    envelope,
)
from .ops.fft import zoomfft as zoom_fft  # noqa: F401
from .ops.iir import (  # noqa: F401
    freqz,
    group_delay,
    lfilter_zi,
    lfiltic,
    sosfilt_zi,
    sosfreqz,
)
from .ops.iir_design import (  # noqa: F401
    BadCoefficients,
    besselap,
    bilinear,
    bilinear_zpk,
    buttap,
    buttord,
    cheb1ap,
    cheb1ord,
    cheb2ap,
    cheb2ord,
    ellipap,
    ellipord,
    findfreqs,
    freqs,
    freqs_zpk,
    freqz_sos,
    gammatone,
    iircomb,
    iirdesign,
    iirnotch,
    iirpeak,
    lp2bp,
    lp2bp_zpk,
    lp2bs,
    lp2bs_zpk,
    lp2hp,
    lp2hp_zpk,
    lp2lp,
    lp2lp_zpk,
    normalize,
    sos2tf,
    sos2zpk,
    tf2sos,
    tf2zpk,
    zpk2sos,
    zpk2tf,
)
from .ops.lti import (  # noqa: F401
    StateSpace,
    TransferFunction,
    ZerosPolesGain,
    abcd_normalize,
    bode,
    cont2discrete,
    dbode,
    dfreqresp,
    dimpulse,
    dlsim,
    dlti,
    dstep,
    freqresp,
    freqz_zpk,
    impulse,
    invres,
    invresz,
    lsim,
    lti,
    place_poles,
    residue,
    residuez,
    ss2tf,
    ss2zpk,
    step,
    tf2ss,
    unique_roots,
    zpk2ss,
)
from .ops.correlate import (  # noqa: F401
    choose_conv_method,
    correlation_lags,
    fftconvolve,
    oaconvolve,
    vectorstrength,
)
from .ops.twod import (  # noqa: F401
    convolve2d,
    correlate2d,
    medfilt2d,
    sepfir2d,
)
from .ops.wavelets import cwt, lombscargle, morlet2, ricker  # noqa: F401
from .ops.splines import (  # noqa: F401
    cspline1d,
    cspline1d_eval,
    cspline2d,
    gauss_spline,
    qspline1d,
    qspline1d_eval,
    qspline2d,
    spline_filter,
    symiirorder1,
    symiirorder2,
)
from .ops.peaks import (  # noqa: F401
    argrelextrema,
    argrelmax,
    argrelmin,
    find_peaks_cwt,
    peak_prominences,
    peak_widths,
)
from .ops.rank import medfilt, order_filter, wiener  # noqa: F401
from .ops.signal import (  # noqa: F401
    chirp,
    gausspulse,
    max_len_seq,
    sawtooth,
    square,
    sweep_poly,
    unit_impulse,
)
from .ops.resample import upfirdn  # noqa: F401
from .ops.stft_class import (  # noqa: F401
    ShortTimeFFT,
    closest_STFT_dual_window,
)


# --- 2. signature adapters -----------------------------------------------------


_BTYPES = {
    "low": "lowpass",
    "lowpass": "lowpass",
    "high": "highpass",
    "highpass": "highpass",
    "band": "bandpass",
    "bandpass": "bandpass",
    "stop": "bandstop",
    "bandstop": "bandstop",
}


def _classic_design(
    proto, N, Wn, btype, analog, output, fs, norm_even=None
):
    from .ops import iir_design as d

    try:
        btype = _BTYPES[btype]
    except KeyError:
        raise ValueError(f"invalid btype {btype!r}") from None
    if output not in ("ba", "zpk", "sos"):
        raise ValueError(f"invalid output {output!r}")
    z, p, k = proto()
    Wn = np.asarray(Wn, np.float64)
    if fs is not None:
        Wn = 2.0 * Wn / fs
    if analog:
        if btype == "lowpass":
            z, p, k = d.lp2lp_zpk(z, p, k, float(Wn))
        elif btype == "highpass":
            z, p, k = d.lp2hp_zpk(z, p, k, float(Wn))
        else:
            w1, w2 = (float(v) for v in Wn.reshape(2))
            wo, bw = np.sqrt(w1 * w2), w2 - w1
            f = d.lp2bp_zpk if btype == "bandpass" else d.lp2bs_zpk
            z, p, k = f(z, p, k, wo, bw)
    else:
        if np.any(Wn <= 0) or np.any(Wn >= 1):
            raise ValueError(
                "digital cutoffs must be inside (0, 1) Nyquist "
                "(or (0, fs/2) with fs given)"
            )
        warped = np.tan(np.pi * Wn / 2.0)
        if btype == "lowpass":
            z, p, k = d.lp2lp_zpk(z, p, k, float(warped))
        elif btype == "highpass":
            z, p, k = d.lp2hp_zpk(z, p, k, float(warped))
        else:
            w1, w2 = (float(v) for v in warped.reshape(2))
            wo, bw = np.sqrt(w1 * w2), w2 - w1
            f = d.lp2bp_zpk if btype == "bandpass" else d.lp2bs_zpk
            z, p, k = f(z, p, k, wo, bw)
        z, p, k = d._bilinear_zpk(z, p, k)
    if output == "zpk":
        return z, p, k
    if output == "sos":
        return d.zpk2sos(z, p, k)
    return d.zpk2tf(z, p, k)


def butter(N, Wn, btype="low", analog=False, output="ba", fs=None):
    """Butterworth design with scipy.signal.butter's signature."""
    from .ops import iir_design as d

    return _classic_design(
        lambda: d.buttap(N), N, Wn, btype, analog, output, fs
    )


def cheby1(N, rp, Wn, btype="low", analog=False, output="ba", fs=None):
    """Chebyshev-I design (scipy.signal.cheby1 signature)."""
    from .ops import iir_design as d

    return _classic_design(
        lambda: d.cheb1ap(N, rp), N, Wn, btype, analog, output, fs
    )


def cheby2(N, rs, Wn, btype="low", analog=False, output="ba", fs=None):
    """Chebyshev-II design (scipy.signal.cheby2 signature)."""
    from .ops import iir_design as d

    return _classic_design(
        lambda: d.cheb2ap(N, rs), N, Wn, btype, analog, output, fs
    )


def ellip(N, rp, rs, Wn, btype="low", analog=False, output="ba", fs=None):
    """Elliptic design (scipy.signal.ellip signature)."""
    from .ops import iir_design as d

    return _classic_design(
        lambda: d.ellipap(N, rp, rs), N, Wn, btype, analog, output, fs
    )


def bessel(N, Wn, btype="low", analog=False, output="ba", norm="phase", fs=None):
    """Bessel design (scipy.signal.bessel signature)."""
    from .ops import iir_design as d

    return _classic_design(
        lambda: d.besselap(N, norm), N, Wn, btype, analog, output, fs
    )


def iirfilter(
    N, Wn, rp=None, rs=None, btype="band", analog=False,
    ftype="butter", output="ba", fs=None,
):
    """Generic classical design (scipy.signal.iirfilter signature)."""
    from .ops import iir_design as d

    protos = {
        "butter": lambda: d.buttap(N),
        "butterworth": lambda: d.buttap(N),
        "cheby1": lambda: d.cheb1ap(N, rp),
        "cheby2": lambda: d.cheb2ap(N, rs),
        "ellip": lambda: d.ellipap(N, rp, rs),
        "elliptic": lambda: d.ellipap(N, rp, rs),
        "bessel": lambda: d.besselap(N),
    }
    if ftype not in protos:
        raise ValueError(f"unknown ftype {ftype!r}")
    return _classic_design(protos[ftype], N, Wn, btype, analog, output, fs)


def firwin2(numtaps, freq, gain, *, nfreqs=None, window="hamming", fs=2.0):
    """Frequency-sampling FIR design (scipy.signal.firwin2 signature)."""
    from .ops.fir import design_firwin2

    freq = np.asarray(freq, np.float64) * (2.0 / fs)
    return design_firwin2(numtaps, freq, gain, window=window, nfreqs=nfreqs)


def firls(numtaps, bands, desired, *, weight=None, fs=2.0):
    """Least-squares FIR design (scipy.signal.firls signature)."""
    from .ops.fir import design_firls

    bands = np.asarray(bands, np.float64) * (2.0 / fs)
    return design_firls(numtaps, bands, desired, weights=weight)


def remez(numtaps, bands, desired, *, weight=None, fs=1.0, maxiter=25):
    """Parks-McClellan design (scipy.signal.remez signature: band edges
    in Hz of ``fs``, one desired value per band)."""
    from .ops.fir import design_remez

    bands = np.asarray(bands, np.float64) / fs * 2.0
    return design_remez(
        numtaps, bands, desired, weights=weight, max_iterations=maxiter
    )


def savgol_coeffs(window_length, polyorder, *, deriv=0, delta=1.0):
    """Savitzky-Golay coefficients (scipy.signal.savgol_coeffs
    signature)."""
    from .ops.fir import design_savgol

    return design_savgol(
        window_length, polyorder, deriv=deriv, delta=delta
    )


def savgol_filter(
    x, window_length, polyorder, deriv=0, delta=1.0, axis=-1,
    mode="interp", cval=0.0, *, device="cuda",
):
    """Savitzky-Golay smoothing (scipy.signal.savgol_filter signature)."""
    from .ops import fir as _fir

    if cval != 0.0:
        raise ValueError("cval is not supported (constant mode pads 0)")
    return _axis_last(
        lambda v: _fir.savgol_filter(
            v, window_length, polyorder, deriv=deriv, delta=delta, mode=mode
        ),
        x, axis, device,
    )


def resample(x, num, *, axis=-1, device="cuda"):
    """Fourier resampling (scipy.signal.resample signature subset)."""
    from .ops.resample import resample_fft

    return _axis_last(lambda v: resample_fft(v, num), x, axis, device)


def decimate(x, q, n=None, ftype="iir", axis=-1, zero_phase=True, *, device="cuda"):
    """Decimation with anti-aliasing (scipy.signal.decimate signature subset)."""
    from .ops import iir as _iir, resample as _res

    if not zero_phase and ftype == "iir":
        raise ValueError(
            "only zero_phase=True is supported for the IIR path (decimate_iir "
            "is forward-backward)"
        )
    if ftype == "iir":
        return _axis_last(lambda v: _iir.decimate_iir(v, q, order=n or 8), x, axis, device)
    return _axis_last(lambda v: _res.decimate(v, q), x, axis, device)


def _axis_last(fn, x, axis, device):
    """``fn`` over the last axis of ``x`` (a tensor, or ``device`` for other input)
    with ``axis`` moved there and back; leading axes past one go through ``fn`` as
    rows of a (rows, time) tensor."""
    xt = as_tensor(x, device)
    moved = axis not in (-1, xt.dim() - 1)
    if moved:
        xt = torch.movedim(xt, axis, -1)
    if xt.dim() > 2:
        lead = tuple(xt.shape[:-1])
        y = fn(xt.reshape(-1, xt.shape[-1]))
        y = y.reshape(lead + tuple(y.shape[-1:]))
    else:
        y = fn(xt)
    return torch.movedim(y, -1, axis) if moved else y


def _state(zi, like: torch.Tensor) -> torch.Tensor:
    """A filter state as float32 on ``like``'s device."""
    return as_tensor(zi, like.device).to(like.device, torch.float32)


def sosfilt(sos, x, axis=-1, zi=None, *, device="cuda"):
    """SOS filtering with scipy.signal.sosfilt's signature: ``axis`` and the
    streaming ``zi`` state (``(y, zf)`` when given), through the seeded chunk
    kernel (B12 on the card)."""
    from .ops import iir as _iir

    if zi is None:
        return _axis_last(lambda v: _iir.sosfilt(np.asarray(sos), v), x, axis, device)
    xt = as_tensor(x, device)
    if axis not in (-1, xt.dim() - 1):
        xm = torch.movedim(xt, axis, -1)
        # scipy's zi carries the section state along the same moved axes
        zax = axis + 1 if axis >= 0 else axis
        zim = np.moveaxis(np.asarray(zi), zax, -1)
        zf, y = _iir.sosfilt_chunk(_state(zim, xm), np.asarray(sos), xm)
        return torch.movedim(y, -1, axis), np.moveaxis(zf.cpu().numpy(), -1, zax)
    zf, y = _iir.sosfilt_chunk(_state(zi, xt), np.asarray(sos), xt)
    return y, zf


def lfilter(b, a, x, axis=-1, zi=None, *, device="cuda"):
    """(b, a) filtering with scipy.signal.lfilter's signature (``axis``
    supported; carry streaming state through ``tf2sos`` and :func:`sosfilt`)."""
    from .ops import iir as _iir

    if zi is not None:
        raise ValueError(
            "zi on the (b, a) form is not supported; convert with tf2sos "
            "and carry state through sosfilt(..., zi=...)"
        )
    return _axis_last(lambda v: _iir.lfilter(b, a, v), x, axis, device)


_CONV_METHODS = {"auto": "auto", "direct": "auto", "fft": "auto"}


def correlate(in1, in2, mode="full", method="auto", *, device="cuda"):
    """Correlation with scipy.signal.correlate's signature; scipy's 'direct' and
    'fft' hints both go to the port's own dispatch (equal to float tolerance)."""
    from .ops import correlate as _corr

    if method not in _CONV_METHODS:
        raise ValueError(f"unknown method {method!r}")
    return _corr.correlate(as_tensor(in1, device), in2, mode=mode)


def convolve(in1, in2, mode="full", method="auto", *, device="cuda"):
    """Convolution with scipy.signal.convolve's signature."""
    from .ops import correlate as _corr

    a = as_tensor(in1, device)
    if method == "fft":
        return _corr.fftconvolve(a, in2, mode)
    if method not in _CONV_METHODS:
        raise ValueError(f"unknown method {method!r}")
    return _corr.convolve(a, in2, mode)


def hilbert(x, N=None, axis=-1, *, device="cuda"):
    """Analytic signal with scipy.signal.hilbert's signature (``N`` pads or
    truncates to the transform length)."""
    from .ops import fft as _fft

    xt = as_tensor(x, device)
    moved = axis not in (-1, xt.dim() - 1)
    if moved:
        xt = torch.movedim(xt, axis, -1)
    n = xt.shape[-1]
    if N is not None:
        N = int(N)
        if N < 1:
            raise ValueError("N must be positive")
        if N < n:
            xt = xt[..., :N]
        elif N > n:
            xt = torch.nn.functional.pad(xt, (0, N - n))
    out = _fft.hilbert(xt)
    return torch.movedim(out, -1, axis) if moved else out


def detrend(data, axis=-1, type="linear", bp=0, *, device="cuda"):
    """Trend removal with scipy.signal.detrend's signature (breakpoints
    unsupported: pass bp=0)."""
    from .ops import gain as _gain

    if np.ndim(bp) != 0 or bp != 0:
        raise ValueError("breakpoints (bp) are not supported")
    return _axis_last(lambda v: _gain.detrend(v, type=type), data, axis, device)


def find_peaks(
    x,
    height=None,
    threshold=None,
    distance=None,
    prominence=None,
    width=None,
    wlen=None,
    rel_height=0.5,
    plateau_size=None,
):
    """Peak finding with scipy.signal.find_peaks's full condition set.

    height/threshold/distance/prominence run in the native implementation
    (scipy-ordered); width and plateau_size are applied here through the
    native ``peak_widths``/plateau machinery in scipy's order, with the
    matching properties added to the dict.
    """
    from .ops import peaks as _peaks

    if wlen is not None:
        raise ValueError("wlen is not supported")

    xa = np.asarray(x, np.float64)
    peaks_idx, props = _peaks.find_peaks(
        xa, height=height, threshold=threshold, distance=distance,
        prominence=prominence,
    )
    if plateau_size is not None:
        # plateau sizes: scipy measures the flat-top extent of each peak
        sizes = np.empty(peaks_idx.size, int)
        ledges = np.empty(peaks_idx.size, int)
        redges = np.empty(peaks_idx.size, int)
        for i, pk in enumerate(peaks_idx):
            lo = pk
            while lo > 0 and xa[lo - 1] == xa[pk]:
                lo -= 1
            hi = pk
            while hi < xa.size - 1 and xa[hi + 1] == xa[pk]:
                hi += 1
            ledges[i], redges[i] = lo, hi
            sizes[i] = hi - lo + 1
        pmin, pmax = _as_interval(plateau_size)
        keep = (sizes >= pmin) & (sizes <= pmax)
        peaks_idx = peaks_idx[keep]
        props = {k: v[keep] for k, v in props.items()}
        props["plateau_sizes"] = sizes[keep]
        props["left_edges"] = ledges[keep]
        props["right_edges"] = redges[keep]
    if width is not None:
        if "prominences" not in props:
            pr, lb, rb = _peaks.peak_prominences(xa, peaks_idx)
            props["prominences"] = pr
            props["left_bases"] = lb
            props["right_bases"] = rb
        widths, wh, lips, rips = _peaks.peak_widths(
            xa, peaks_idx, rel_height=rel_height,
            prominence_data=(
                props["prominences"], props["left_bases"],
                props["right_bases"],
            ),
        )
        wmin, wmax = _as_interval(width)
        keep = (widths >= wmin) & (widths <= wmax)
        peaks_idx = peaks_idx[keep]
        props = {k: np.asarray(v)[keep] for k, v in props.items()}
        props["widths"] = np.asarray(widths)[keep]
        props["width_heights"] = np.asarray(wh)[keep]
        props["left_ips"] = np.asarray(lips)[keep]
        props["right_ips"] = np.asarray(rips)[keep]
    return peaks_idx, props


def _as_interval(v):
    arr = np.atleast_1d(np.asarray(v, np.float64))
    if arr.size == 1:
        return float(arr[0]), np.inf
    return float(arr[0]), float(arr[1])



def _upfirdn_len(len_h, len_x, up, down):
    return ((len_x - 1) * up + len_h - 1) // down + 1


def resample_poly(x, up, down, axis=-1, window=("kaiser", 5.0), *, device="cuda"):
    """Polyphase resampling with scipy.signal.resample_poly's signature and its
    exact output (scipy's Kaiser filter, delay-compensating pad and trim, on
    the port's ``upfirdn``)."""
    from .ops.fir import firwin as _firwin
    from .ops.resample import upfirdn as _upfirdn

    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError("up and down must be positive integers")
    g = np.gcd(up, down)
    up, down = up // g, down // g

    def poly(xt):
        xt = xt.to(torch.float32)
        if up == down == 1:
            return xt
        n = xt.shape[-1]
        n_out = n * up
        n_out = n_out // down + bool(n_out % down)
        mx = max(up, down)
        half_len = 10 * mx
        h = _firwin(2 * half_len + 1, 1.0 / mx, window=window) * up
        n_pre_pad = down - half_len % down
        n_post_pad = 0
        n_pre_remove = (half_len + n_pre_pad) // down
        while (
            _upfirdn_len(len(h) + n_pre_pad + n_post_pad, n, up, down)
            < n_out + n_pre_remove
        ):
            n_post_pad += 1
        h2 = np.concatenate([np.zeros(n_pre_pad), h, np.zeros(n_post_pad)]).astype(np.float32)
        y = _upfirdn(h2, xt, up, down)
        return y[..., n_pre_remove : n_pre_remove + n_out]

    return _axis_last(poly, x, axis, device)


def filtfilt(b, a, x, axis=-1, padtype="odd", padlen=None, method="pad", irlen=None, *,
             device="cuda"):
    """Zero-phase filtering with scipy.signal.filtfilt's signature (the default
    'odd'/'pad' recipe; other padtypes unsupported)."""
    from .ops import iir as _iir

    if padtype != "odd" or padlen is not None or method != "pad":
        raise ValueError(
            "only the default padtype='odd', padlen=None, method='pad' "
            "recipe is supported"
        )
    return _axis_last(lambda v: _iir.filtfilt(b, a, v), x, axis, device)


def sosfiltfilt(sos, x, axis=-1, padtype="odd", padlen=None, *, device="cuda"):
    """Zero-phase SOS filtering with scipy.signal.sosfiltfilt's signature
    (default 'odd' recipe)."""
    from .ops import iir as _iir

    if padtype != "odd" or padlen is not None:
        raise ValueError(
            "only the default padtype='odd', padlen=None recipe is supported"
        )
    return _axis_last(lambda v: _iir.sosfiltfilt(np.asarray(sos), v), x, axis, device)


# --- spectral estimation with scipy's (f[, t], result) conventions -------------


def _resolve_spectral(window, nperseg, noverlap, nfft, detrend):
    if nperseg is None:
        nperseg = 256
    nperseg = int(nperseg)
    if nfft is not None and int(nfft) != nperseg:
        raise ValueError(
            "this implementation requires nfft == nperseg (frames are not "
            "zero-padded); resample or change nperseg instead"
        )
    noverlap = nperseg // 2 if noverlap is None else int(noverlap)
    if detrend in ("constant",):
        dt = True
    elif detrend in (False, None):
        dt = False
    else:
        raise ValueError(
            f"unsupported detrend {detrend!r} (use 'constant' or False)"
        )
    win = "rect" if window == "boxcar" else window
    if isinstance(win, list):
        win = tuple(win)
    return win, nperseg, nperseg - noverlap, dt


def welch(
    x, fs=1.0, window="hann", nperseg=None, noverlap=None, nfft=None,
    detrend="constant", scaling="density", *, device="cuda",
):
    """Welch PSD with scipy.signal.welch's signature; returns (f, Pxx)."""
    from .ops import fft as _fft

    n = np.shape(x)[-1]
    if nperseg is None or int(nperseg) > n:
        # scipy caps nperseg at the signal length (with a warning)
        nperseg = min(256 if nperseg is None else int(nperseg), n)
        noverlap = None if noverlap is None else min(int(noverlap), nperseg - 1)
    win, nseg, hop, dt = _resolve_spectral(window, nperseg, noverlap, nfft, detrend)
    p = _fft.welch(
        as_tensor(x, device), nfft=nseg, hop=hop, window=win, fs=fs, scaling=scaling,
        detrend_segments=dt,
    )
    return np.fft.rfftfreq(nseg, 1.0 / fs), p


def periodogram(
    x, fs=1.0, window="boxcar", nfft=None, detrend="constant",
    scaling="density", *, device="cuda",
):
    """Single-frame PSD with scipy.signal.periodogram's signature; returns (f, Pxx)."""
    from .ops import fft as _fft

    if detrend not in ("constant", False, None):
        raise ValueError("unsupported detrend (use 'constant' or False)")
    win = "rect" if window == "boxcar" else window
    n = np.shape(x)[-1]
    p = _fft.periodogram(as_tensor(x, device), fs=fs, nfft=nfft, window=win, scaling=scaling)
    return np.fft.rfftfreq(nfft or n, 1.0 / fs), p


def csd(
    x, y, fs=1.0, window="hann", nperseg=None, noverlap=None, nfft=None,
    detrend="constant", scaling="density", *, device="cuda",
):
    """Cross-spectral density (scipy.signal.csd signature); returns (f, Pxy)."""
    from .ops import fft as _fft

    win, nseg, hop, dt = _resolve_spectral(window, nperseg, noverlap, nfft, detrend)
    xt = as_tensor(x, device)
    p = _fft.csd(
        xt, as_tensor(y, xt.device), nfft=nseg, hop=hop, window=win, fs=fs,
        scaling=scaling, detrend_segments=dt,
    )
    return np.fft.rfftfreq(nseg, 1.0 / fs), p


def coherence(x, y, fs=1.0, window="hann", nperseg=None, noverlap=None,
              nfft=None, detrend="constant", *, device="cuda"):
    """Magnitude-squared coherence (scipy.signal.coherence signature); returns
    (f, Cxy)."""
    xt = as_tensor(x, device)
    yt = as_tensor(y, xt.device)
    fr, pxy = csd(xt, yt, fs, window, nperseg, noverlap, nfft, detrend)
    _, pxx = welch(xt, fs, window, nperseg, noverlap, nfft, detrend)
    _, pyy = welch(yt, fs, window, nperseg, noverlap, nfft, detrend)
    return fr, (torch.abs(pxy) ** 2) / (pxx * pyy)


def spectrogram(
    x, fs=1.0, window=("tukey", 0.25), nperseg=None, noverlap=None,
    nfft=None, detrend="constant", scaling="density", mode="psd", *, device="cuda",
):
    """Spectrogram with scipy.signal.spectrogram's signature (noverlap defaults
    to nperseg // 8); returns (f, t, Sxx)."""
    from .ops import fft as _fft

    if nperseg is None:
        nperseg = 256
    if noverlap is None:
        noverlap = nperseg // 8
    win, nseg, hop, dt = _resolve_spectral(window, nperseg, noverlap, nfft, detrend)
    s = _fft.stft(as_tensor(x, device), nfft=nseg, hop=hop, window=win, detrend_segments=dt)
    wv = _fft.spectral_window(win, nseg).astype(np.float64)
    if scaling == "density":
        norm = fs * float((wv**2).sum())
    elif scaling == "spectrum":
        norm = float(wv.sum()) ** 2
    else:
        raise ValueError(f"unknown scaling {scaling!r}")
    onesided = np.full(nseg // 2 + 1, 2.0, np.float32)
    onesided[0] = 1.0
    if nseg % 2 == 0:
        onesided[-1] = 1.0
    if mode == "psd":
        out = (torch.abs(s) ** 2) / norm * torch.from_numpy(onesided).to(s.device)
    elif mode in ("magnitude", "complex"):
        # the amplitude modes take the square root of the psd normalisation
        amp = 1.0 / np.sqrt(norm)
        out = (torch.abs(s) if mode == "magnitude" else s) * amp
    else:
        raise ValueError(f"unsupported mode {mode!r}")
    nframes = out.shape[-2]
    t = (np.arange(nframes) * hop + nseg / 2.0) / fs
    f = np.fft.rfftfreq(nseg, 1.0 / fs)
    return f, t, torch.movedim(out, -2, -1)


def stft(
    x, fs=1.0, window="hann", nperseg=256, noverlap=None, nfft=None,
    detrend=False, boundary="zeros", padded=True, *, device="cuda",
):
    """Legacy STFT (scipy.signal.stft signature); returns (f, t, Zxx), on
    :class:`~.ops.stft_class.ShortTimeFFT` with scipy's legacy mapping
    (magnitude scaling, no phase shift, slices 0..p_max)."""
    from .ops.fft import get_window as _gw
    from .ops.stft_class import ShortTimeFFT as _S

    if detrend not in (False, None):
        raise ValueError("detrend is not supported on the legacy stft")
    if boundary != "zeros" or not padded:
        raise ValueError("only boundary='zeros', padded=True supported")
    nperseg = int(nperseg)
    noverlap = nperseg // 2 if noverlap is None else int(noverlap)
    if nfft is not None and int(nfft) != nperseg:
        raise ValueError("this implementation requires nfft == nperseg")
    win = np.asarray(_gw("rect" if window == "boxcar" else window, nperseg))
    st = _S(win, nperseg - noverlap, fs, scale_to="magnitude", phase_shift=None)
    xt = as_tensor(x, device)
    n = xt.shape[-1]
    z = st.stft(xt, p0=0, p1=st.p_max(n))
    t = np.arange(st.p_max(n)) * st.delta_t
    return st.f, t, z


def istft(
    Zxx, fs=1.0, window="hann", nperseg=None, noverlap=None, nfft=None,
    input_onesided=True, boundary=True, *, device="cuda",
):
    """Legacy inverse STFT (scipy.signal.istft signature); returns (t, x)."""
    from .ops.fft import get_window as _gw
    from .ops.stft_class import ShortTimeFFT as _S

    if not input_onesided or not boundary:
        raise ValueError("only input_onesided=True, boundary=True supported")
    zt = as_tensor(Zxx, device)
    q = zt.shape[-2]
    if nperseg is None:
        nperseg = 2 * (q - 1)
    nperseg = int(nperseg)
    noverlap = nperseg // 2 if noverlap is None else int(noverlap)
    if nfft is not None and int(nfft) != nperseg:
        raise ValueError("this implementation requires nfft == nperseg")
    win = np.asarray(_gw("rect" if window == "boxcar" else window, nperseg))
    hop = nperseg - noverlap
    st = _S(win, hop, fs, scale_to="magnitude", phase_shift=None)
    n_slices = zt.shape[-1]
    # legacy output length: everything the slices cover past the boundary
    n_out = (n_slices - 1) * hop
    x = st.istft(zt, k0=0, k1=n_out)
    t = np.arange(x.shape[-1]) / fs
    return t, x


__all__ = [n for n in dir() if not n.startswith("_")]
