"""Peak detection: a peak mask on tensors and scipy-style ``find_peaks``.

Peak index lists have data-dependent lengths, so the device op is a
same-shape boolean mask (:func:`peak_mask`), and the scipy.signal
``find_peaks``-compatible index and property API runs on the host on the
fetched stream, as in the reference package (``ops/peaks.py``; this module
keeps its own copy of those host functions). ``find_peaks_cwt`` runs the
port's :func:`~.wavelets.cwt` on ``device`` and links ridge lines on the host.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from ..utils.device import as_tensor


def peak_mask(x, *, height: float | None = None, device="cuda") -> torch.Tensor:
    """Boolean mask of strict local maxima over the last axis (the end samples
    never qualify). ``height``: an optional minimum value. Plateaus do not
    count; :func:`find_peaks` takes scipy's plateau midpoints."""
    xf = as_tensor(x, device).to(torch.float32)
    inf = torch.full(xf.shape[:-1] + (1,), torch.inf, dtype=xf.dtype, device=xf.device)
    left = torch.cat([inf, xf[..., :-1]], -1)
    right = torch.cat([xf[..., 1:], inf], -1)
    m = (xf > left) & (xf > right)
    if height is not None:
        m = m & (xf >= height)
    return m


def _local_maxima_plateau(x: np.ndarray) -> np.ndarray:
    """Indices of local maxima, plateaus resolved to their midpoint
    (scipy.signal._peak_finding semantics): each run of equal samples that
    neither touches an end nor has a taller neighbour run, at the midpoint
    (start + end) // 2, found over the runs at once."""
    n = x.shape[0]
    if n < 3:
        return np.zeros(0, np.intp)
    change = np.nonzero(x[1:] != x[:-1])[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change - 1, [n - 1]])
    v = x[starts]
    r = np.arange(1, starts.size - 1)
    keep = (v[r - 1] < v[r]) & (v[r + 1] < v[r])
    r = r[keep]
    return ((starts[r] + ends[r]) // 2).astype(np.intp)


def _contour_min(x: np.ndarray, p: int, h: float, step: int) -> tuple[float, int]:
    """The lowest sample (and its index) walking from peak ``p`` by ``step`` (-1
    or 1) until a sample above ``h`` or the end; strict minima only, the first
    met on the walk, ``(h, p)`` where none lies below ``h``. The walk goes in
    windows that double, so its cost follows its length."""
    n = x.shape[0]
    w = 64
    while True:
        if step < 0:
            lo = max(0, p - w)
            seg = x[lo:p][::-1]
            at_end = lo == 0
        else:
            hi = min(n, p + 1 + w)
            seg = x[p + 1 : hi]
            at_end = hi == n
        stop = np.nonzero(~(seg <= h))[0]
        if stop.size or at_end:
            region = seg[: stop[0]] if stop.size else seg
            break
        w *= 2
    if region.size == 0:
        return h, p
    k = int(np.argmin(region))
    if not region[k] < h:
        return h, p
    return float(region[k]), p + step * (k + 1)


def peak_prominences(x, peaks):
    """(prominences, left_bases, right_bases) of each peak
    (scipy.signal.peak_prominences, host-side): height above the higher of
    the two lowest contour points reached before a taller sample in each
    direction; the bases are those contour minima's indices."""
    x = np.asarray(x, np.float64)
    peaks = np.asarray(peaks, np.intp)
    prom = np.empty(peaks.shape, np.float64)
    lbase = np.empty(peaks.shape, np.intp)
    rbase = np.empty(peaks.shape, np.intp)
    for k, p in enumerate(peaks):
        h = x[p]
        left_min, lb = _contour_min(x, int(p), h, -1)
        right_min, rb = _contour_min(x, int(p), h, 1)
        prom[k] = h - max(left_min, right_min)
        lbase[k], rbase[k] = lb, rb
    return prom, lbase, rbase


def find_peaks(
    x,
    *,
    height: float | None = None,
    threshold: float | None = None,
    distance: int | None = None,
    prominence: float | None = None,
):
    """scipy.signal.find_peaks-compatible peak indices + properties dict.

    Host-side numpy (dynamic output shapes can't live under jit — fetch
    the stream or a :func:`peak_mask` reduction first). Supported
    conditions: ``height`` (min value), ``threshold`` (min vertical
    distance to neighbors), ``distance`` (min index spacing, taller peaks
    kept first), ``prominence``. Evaluation order matches scipy.
    """
    x = np.asarray(x, np.float64)
    if x.ndim != 1:
        raise ValueError(f"find_peaks wants a 1-D stream, got shape {x.shape}")
    peaks = _local_maxima_plateau(x)
    props: dict[str, np.ndarray] = {}
    if height is not None:
        keep = x[peaks] >= height
        peaks = peaks[keep]
    if threshold is not None:
        lt = x[peaks] - x[peaks - 1]
        rt = x[peaks] - x[peaks + 1]
        keep = np.minimum(lt, rt) >= threshold
        peaks, lt, rt = peaks[keep], lt[keep], rt[keep]
        props["left_thresholds"], props["right_thresholds"] = lt, rt
    if distance is not None:
        if distance < 1:
            raise ValueError(f"distance must be >= 1, got {distance}")
        order = np.argsort(x[peaks])[::-1]  # tallest first, like scipy
        keep = np.ones(peaks.shape, bool)
        for o in order:
            if not keep[o]:
                continue
            p = peaks[o]
            kill = (np.abs(peaks - p) < distance) & keep
            kill[o] = False
            keep &= ~kill
        peaks = peaks[keep]
        for k in props:
            props[k] = props[k][keep]
    if prominence is not None:
        prom, lbase, rbase = peak_prominences(x, peaks)
        keep = prom >= prominence
        peaks = peaks[keep]
        props["prominences"] = prom[keep]
        props["left_bases"] = lbase[keep]
        props["right_bases"] = rbase[keep]
        for k in ("left_thresholds", "right_thresholds"):
            if k in props:
                props[k] = props[k][keep]
    if height is not None:
        props["peak_heights"] = x[peaks]
    return peaks, props


def peak_widths(x, peaks, *, rel_height: float = 0.5, prominence_data=None):
    """(widths, width_heights, left_ips, right_ips) of each peak at
    ``rel_height`` of its prominence (scipy.signal.peak_widths, host-side).

    The evaluation height is ``peak_height - rel_height * prominence``;
    crossings are linearly interpolated between samples, searched only
    within each peak's prominence bases like scipy.
    """
    if rel_height < 0:
        raise ValueError(f"rel_height must be >= 0, got {rel_height}")
    x = np.asarray(x, np.float64)
    peaks = np.asarray(peaks, np.intp)
    if prominence_data is None:
        prominence_data = peak_prominences(x, peaks)
    prom, lbase, rbase = prominence_data
    widths = np.empty(peaks.shape, np.float64)
    wh = np.empty(peaks.shape, np.float64)
    lips = np.empty(peaks.shape, np.float64)
    rips = np.empty(peaks.shape, np.float64)
    for k, p in enumerate(peaks):
        height = x[p] - rel_height * prom[k]
        wh[k] = height
        i = p
        while i > lbase[k] and x[i] > height:
            i -= 1
        lip = float(i)
        if x[i] < height:  # interpolate between i and i+1
            lip = i + (height - x[i]) / (x[i + 1] - x[i])
        j = p
        while j < rbase[k] and x[j] > height:
            j += 1
        rip = float(j)
        if x[j] < height:
            rip = j - (height - x[j]) / (x[j - 1] - x[j])
        lips[k], rips[k] = lip, rip
        widths[k] = rip - lip
    return widths, wh, lips, rips


def argrelextrema(x, comparator, *, order: int = 1):
    """Indices of relative extrema under ``comparator`` vs every neighbor
    within ``order`` samples on both sides (scipy.signal.argrelextrema,
    1-D, 'clip' boundary semantics)."""
    x = np.asarray(x)
    if x.ndim != 1:
        raise ValueError(f"argrelextrema wants 1-D, got shape {x.shape}")
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    n = x.shape[0]
    keep = np.ones(n, bool)
    idx = np.arange(n)
    for shift in range(1, order + 1):
        keep &= comparator(x, x[np.minimum(idx + shift, n - 1)])
        keep &= comparator(x, x[np.maximum(idx - shift, 0)])
    return (np.nonzero(keep)[0],)


def argrelmax(x, *, order: int = 1):
    """Relative maxima (scipy.signal.argrelmax)."""
    return argrelextrema(x, np.greater, order=order)


def argrelmin(x, *, order: int = 1):
    """Relative minima (scipy.signal.argrelmin)."""
    return argrelextrema(x, np.less, order=order)


# --- CWT-based peak finding (scipy.signal.find_peaks_cwt) ----------------------
#
# The Du-Kibbe-Lin ridge-line method (Bioinformatics 22(17), 2006): peaks
# persist as connected relative maxima across wavelet scales while noise
# does not. The CWT is the FFT bank of ops.wavelets.cwt; ridge tracking is a
# host-side O(scales x peaks) bookkeeping pass over the (few) per-scale maxima.


def _relmax_rows(matr: np.ndarray) -> np.ndarray:
    """Boolean order-1 relative maxima along the last axis, edges
    clipped (never maxima)."""
    left = np.concatenate([matr[:, :1], matr[:, :-1]], axis=1)
    right = np.concatenate([matr[:, 1:], matr[:, -1:]], axis=1)
    return (matr > left) & (matr > right)


def _identify_ridge_lines(matr, max_distances, gap_thresh):
    """Link per-scale relative maxima into ridge lines (largest scale
    down), allowing up to ``gap_thresh`` skipped scales per line."""
    if len(max_distances) < matr.shape[0]:
        raise ValueError(
            "max_distances must have at least as many rows as matr"
        )
    all_max = _relmax_rows(matr)
    has_relmax = np.nonzero(all_max.any(axis=1))[0]
    if len(has_relmax) == 0:
        return []
    start_row = has_relmax[-1]
    ridge_lines = [
        [[start_row], [col], 0] for col in np.nonzero(all_max[start_row])[0]
    ]
    final_lines = []
    cols = np.arange(matr.shape[1])
    for row in range(start_row - 1, -1, -1):
        this_max_cols = cols[all_max[row]]
        for line in ridge_lines:
            line[2] += 1
        prev_cols = np.array([line[1][-1] for line in ridge_lines])
        for col in this_max_cols:
            line = None
            if prev_cols.size:
                diffs = np.abs(col - prev_cols)
                closest = int(np.argmin(diffs))
                if diffs[closest] <= max_distances[row]:
                    line = ridge_lines[closest]
            if line is not None:
                line[1].append(col)
                line[0].append(row)
                line[2] = 0
            else:
                ridge_lines.append([[row], [col], 0])
        for ind in range(len(ridge_lines) - 1, -1, -1):
            if ridge_lines[ind][2] > gap_thresh:
                final_lines.append(ridge_lines[ind])
                del ridge_lines[ind]
    out = []
    for line in final_lines + ridge_lines:
        sortargs = np.argsort(line[0])
        rows_s = np.zeros_like(sortargs)
        cols_s = np.zeros_like(sortargs)
        rows_s[sortargs] = line[0]
        cols_s[sortargs] = line[1]
        out.append([rows_s, cols_s])
    return out


def _sliding_percentile(v: np.ndarray, m: int, perc: float) -> np.ndarray:
    """``np.percentile(v[k : k + m], perc)`` for every k, by a sorted window that
    slides a sample at a time (memory moves, not a sort a window): NumPy's
    linear method, its virtual index, bounds and lerp, so the values are
    np.percentile's (finite input)."""
    q = np.true_divide(perc, 100)
    vi = (m - 1) * q  # numpy's linear method: its virtual index, floor and gamma
    if vi >= m - 1:
        lo_i = hi_i = m - 1
    elif vi < 0:
        lo_i = hi_i = 0
    else:
        lo_i = int(np.floor(vi))
        hi_i = lo_i + 1
    gamma = vi - np.floor(vi)
    win = sorted(v[:m].tolist())
    out = np.empty(v.shape[0] - m + 1)
    for k in range(out.shape[0]):
        a, b = win[lo_i], win[hi_i]
        d = b - a
        out[k] = b - d * (1 - gamma) if gamma >= 0.5 else a + d * gamma
        if k + m < v.shape[0]:
            del win[bisect.bisect_left(win, v[k])]
            bisect.insort(win, v[k + m])
    return out


def _filter_ridge_lines(
    cwt_mat, ridge_lines, window_size=None, min_length=None,
    min_snr=1.0, noise_perc=10.0,
):
    num_points = cwt_mat.shape[1]
    if min_length is None:
        min_length = np.ceil(cwt_mat.shape[0] / 4)
    if window_size is None:
        window_size = np.ceil(num_points / 20)
    window_size = int(window_size)
    hf, odd = divmod(window_size, 2)
    row_one = cwt_mat[0, :]
    noises = np.empty_like(row_one)
    full = range(hf, num_points - hf - odd + 1) if num_points >= window_size > 0 else range(0)
    if len(full):
        noises[hf : hf + len(full)] = _sliding_percentile(row_one, window_size, noise_perc)
    for ind in range(num_points):  # the shorter windows at the ends
        if ind in full:
            continue
        lo = max(ind - hf, 0)
        hi = min(ind + hf + odd, num_points)
        noises[ind] = np.percentile(row_one[lo:hi], noise_perc)

    def keep(line):
        if len(line[0]) < min_length:
            return False
        with np.errstate(divide="ignore", invalid="ignore"):
            snr = abs(cwt_mat[line[0][0], line[1][0]] / noises[line[1][0]])
        return not snr < min_snr

    return [line for line in ridge_lines if keep(line)]


def find_peaks_cwt(
    vector,
    widths,
    *,
    wavelet=None,
    max_distances=None,
    gap_thresh=None,
    min_length=None,
    min_snr: float = 1.0,
    noise_perc: float = 10.0,
    window_size=None,
    device="cuda",
) -> np.ndarray:
    """Wavelet-persistence peak finding (scipy.signal.find_peaks_cwt): the ricker
    CWT on ``device``, ridge lines linked across scales and filtered by SNR and
    length on the host. Returns NumPy indices."""
    from .wavelets import cwt as _cwt, ricker as _ricker

    widths = np.atleast_1d(np.asarray(widths))
    if gap_thresh is None:
        gap_thresh = np.ceil(widths[0])
    if max_distances is None:
        max_distances = widths / 4.0
    if wavelet is None:
        wavelet = _ricker
    vec = vector if isinstance(vector, torch.Tensor) else np.asarray(vector, np.float64)
    cwt_mat = _cwt(vec, wavelet, widths, device=device).cpu().numpy().astype(np.float64)
    ridge_lines = _identify_ridge_lines(cwt_mat, max_distances, gap_thresh)
    filtered = _filter_ridge_lines(
        cwt_mat, ridge_lines, window_size=window_size,
        min_length=min_length, min_snr=min_snr, noise_perc=noise_perc,
    )
    locs = np.asarray([line[1][0] for line in filtered], int)
    locs.sort()
    return locs


__all__ = [
    "peak_mask",
    "find_peaks",
    "peak_prominences",
    "peak_widths",
    "argrelextrema",
    "argrelmax",
    "argrelmin",
    "find_peaks_cwt",
]
