"""Array processing: beamforming and direction finding on a ULA.

Counterpart of ``digital_signal_processsing_tpu/models/beamform.py``:
narrowband snapshots of a uniform linear array turned into spatial spectra
(Bartlett, MVDR, MUSIC) and bearings.

As in the reference, complex Hermitian algebra runs in its real embedding:
R = Rr + jRi maps to the real-symmetric C(R) = [[Rr, -Ri], [Ri, Rr]] and a
steering vector a = ai + j aq to [ai; aq]. MVDR is a Cholesky solve
(``torch.linalg.cholesky`` + ``cholesky_solve``) of the loaded embedding,
MUSIC a ``torch.linalg.eigh`` (ascending) whose 2(M-K) smallest
eigenvectors span the embedded noise subspace. Every covariance and
spectrum product runs in IEEE float32 (``ieee_fp32_matmul``). Spectra and
covariances take leading batch axes, so ``spectrum_batch`` is one call and
wideband MUSIC one batched ``eigh`` over its bins. The peak pick and the
tiny grid-free solves (ESPRIT's least squares and eigenvalues, root-MUSIC's
roots) run on the host, as in the reference.

NumPy snapshots go to ``device`` (the card by default); tensors stay where
they are. Steering vectors given as NumPy go to the covariance's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.fft import stft
from ..ops.fir import ieee_fp32_matmul
from ..parallel.mesh import batch_sharding, check_mesh
from ..utils.device import as_planar, as_tensor

__all__ = [
    "ArrayConfig",
    "scan_angles",
    "steering",
    "synthesize",
    "sample_covariance",
    "smoothed_covariance",
    "bartlett_spectrum",
    "mvdr_spectrum",
    "mvdr_weights",
    "music_spectrum",
    "spatial_spectrum",
    "estimate_doa",
    "esprit",
    "root_music",
    "synthesize_wideband",
    "wideband_music_spectrum",
    "estimate_doa_wideband",
    "spectrum_batch",
]


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    """Uniform linear array and scan grid. ``spacing`` is the element
    pitch in wavelengths (0.5 = the classic half-wavelength grating-lobe
    limit); the grid spans [-90, 90] degrees broadside-relative."""

    n_sensors: int = 8
    spacing: float = 0.5
    n_grid: int = 361
    diagonal_loading: float = 1e-3  # relative to tr(R)/M

    def __post_init__(self):
        if self.n_sensors < 2:
            raise ValueError(f"need >= 2 sensors, got {self.n_sensors}")
        if not 0.0 < self.spacing <= 0.5:
            raise ValueError(f"spacing must be in (0, 0.5] wavelengths, got {self.spacing}")
        if self.n_grid < 3:
            raise ValueError(f"n_grid must be >= 3, got {self.n_grid}")


def scan_angles(cfg: ArrayConfig) -> np.ndarray:
    """The bearing grid in degrees, inclusive of both endfires."""
    return np.linspace(-90.0, 90.0, cfg.n_grid)


def steering(cfg: ArrayConfig, angles_deg) -> tuple[np.ndarray, np.ndarray]:
    """Planar ULA steering matrix for bearings in degrees.

    Element m at position m*spacing sees phase -2*pi*spacing*m*sin(theta)
    relative to element 0. Returns (ai, aq), each float32 (n_sensors,
    n_angles), unit per-element gain.
    """
    angles = np.atleast_1d(np.asarray(angles_deg, dtype=np.float64))
    m = np.arange(cfg.n_sensors, dtype=np.float64)[:, None]
    phase = -2.0 * np.pi * cfg.spacing * m * np.sin(np.deg2rad(angles))[None, :]
    return np.cos(phase).astype(np.float32), np.sin(phase).astype(np.float32)


def synthesize(
    cfg: ArrayConfig,
    angles_deg,
    n_snapshots: int,
    snr_db: float = 10.0,
    seed: int = 0,
    coherent: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Planar (n_sensors, n_snapshots) snapshots: unit-power circular
    Gaussian sources at the given bearings plus white noise at the given
    per-source SNR. ``coherent=True`` drives every source with the same
    waveform (multipath)."""
    rng = np.random.default_rng(seed)
    angles = np.atleast_1d(np.asarray(angles_deg, dtype=np.float64))
    k = angles.size
    ai, aq = steering(cfg, angles)
    a = ai.astype(np.float64) + 1j * aq.astype(np.float64)
    if coherent:
        base = (rng.standard_normal(n_snapshots) + 1j * rng.standard_normal(n_snapshots)) / np.sqrt(2.0)
        s = np.tile(base, (k, 1))
    else:
        s = (
            rng.standard_normal((k, n_snapshots)) + 1j * rng.standard_normal((k, n_snapshots))
        ) / np.sqrt(2.0)
    sigma = 10.0 ** (-snr_db / 20.0)
    noise = (
        rng.standard_normal((cfg.n_sensors, n_snapshots))
        + 1j * rng.standard_normal((cfg.n_sensors, n_snapshots))
    ) * (sigma / np.sqrt(2.0))
    x = a @ s + noise
    return x.real.astype(np.float32), x.imag.astype(np.float32)


def _flip2(a: torch.Tensor) -> torch.Tensor:
    return a.flip(-1, -2)


def sample_covariance(xi, xq, *, forward_backward: bool = False, device="cuda"):
    """Planar sample covariance R = X X^H / T from (..., M, T) snapshots.

    Rr = (Xi Xi^T + Xq Xq^T)/T, Ri = (Xq Xi^T - Xi Xq^T)/T, in IEEE float32.
    ``forward_backward=True`` averages in J conj(R) J (persymmetric
    smoothing).
    """
    xi, xq = as_planar(xi, xq, device)
    t = xi.shape[-1]
    with ieee_fp32_matmul():
        rr = (xi @ xi.mT + xq @ xq.mT) / t
        ri = (xq @ xi.mT - xi @ xq.mT) / t
    if forward_backward:
        rr = 0.5 * (rr + _flip2(rr))
        ri = 0.5 * (ri - _flip2(ri))
    return rr, ri


def smoothed_covariance(xi, xq, *, subarray: int, forward_backward: bool = True, device="cuda"):
    """Spatially smoothed covariance: the average over all length-``subarray``
    sliding subarrays (plus forward-backward by default); subarray x
    subarray, to pair with steering vectors of a ``subarray``-element
    config."""
    xi, xq = as_planar(xi, xq, device)
    m = xi.shape[0]
    if not 1 < subarray <= m:
        raise ValueError(f"subarray must be in [2, {m}], got {subarray}")
    j = m - subarray + 1
    idx = (torch.arange(subarray)[None, :] + torch.arange(j)[:, None]).to(xi.device)  # (J, L)
    bi = xi[idx]  # (J, L, T)
    bq = xq[idx]
    t = xi.shape[-1]
    with ieee_fp32_matmul():
        rr = torch.einsum("jlt,jkt->lk", bi, bi) + torch.einsum("jlt,jkt->lk", bq, bq)
        ri = torch.einsum("jlt,jkt->lk", bq, bi) - torch.einsum("jlt,jkt->lk", bi, bq)
    rr = rr / (j * t)
    ri = ri / (j * t)
    if forward_backward:
        rr = 0.5 * (rr + _flip2(rr))
        ri = 0.5 * (ri - _flip2(ri))
    return rr, ri


def _embed(rr: torch.Tensor, ri: torch.Tensor) -> torch.Tensor:
    """Real embedding of a complex Hermitian matrix: [[Rr, -Ri], [Ri, Rr]]."""
    return torch.cat([torch.cat([rr, -ri], dim=-1), torch.cat([ri, rr], dim=-1)], dim=-2)


def _embed_vectors(ai, aq, like: torch.Tensor) -> torch.Tensor:
    """(M, A) or (M,) planar steering -> (2M, A) or (2M,) embedded real
    columns on ``like``'s device."""
    ai = as_tensor(ai, like.device).to(like.device, torch.float32)
    aq = as_tensor(aq, like.device).to(like.device, torch.float32)
    return torch.cat([ai, aq], dim=0)


def _loaded(rr: torch.Tensor, loading: float) -> torch.Tensor:
    """Diagonal loading scaled by the mean sensor power tr(R)/M."""
    m = rr.shape[-1]
    eps = loading * torch.diagonal(rr, dim1=-2, dim2=-1).sum(-1) / m
    return rr + eps[..., None, None] * torch.eye(m, device=rr.device)


def bartlett_spectrum(rr, ri, ai, aq) -> torch.Tensor:
    """Conventional (delay-and-sum) spatial spectrum a^H R a per bearing,
    normalized by the array gain M."""
    c = _embed(rr, ri)
    av = _embed_vectors(ai, aq, c)
    with ieee_fp32_matmul():
        ca = c @ av
    return torch.sum(av * ca, dim=-2) / rr.shape[-1]


def _cho_solve(c: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with ieee_fp32_matmul():
        return torch.cholesky_solve(b.expand(c.shape[:-2] + b.shape[-2:]), torch.linalg.cholesky(c))


def mvdr_spectrum(rr, ri, ai, aq, *, loading: float = 1e-3) -> torch.Tensor:
    """Capon/MVDR spectrum 1/(a^H R^{-1} a) via a Cholesky solve on the
    diagonally loaded real embedding (one factorization, all bearings)."""
    c = _embed(_loaded(rr, loading), ri)
    av = _embed_vectors(ai, aq, c)
    y = _cho_solve(c, av)
    return 1.0 / torch.sum(av * y, dim=-2)


def mvdr_weights(rr, ri, ai, aq, *, loading: float = 1e-3) -> tuple[torch.Tensor, torch.Tensor]:
    """Distortionless weights w = R^{-1} a / (a^H R^{-1} a) for one look
    direction (ai, aq of shape (M,)). Returns planar (wi, wq)."""
    c = _embed(_loaded(rr, loading), ri)
    av = _embed_vectors(ai, aq, c)[:, None]
    y = _cho_solve(c, av)
    w = (y / torch.sum(av * y))[:, 0]
    m = rr.shape[-1]
    return w[:m], w[m:]


def _noise_spectrum(c: torch.Tensor, av: torch.Tensor, m: int, n_sources: int) -> torch.Tensor:
    """MUSIC's m / ||E_n^T a||^2 over the columns of ``av`` (batched)."""
    _, vecs = torch.linalg.eigh(c)  # ascending eigenvalues
    en = vecs[..., : 2 * (m - n_sources)]
    with ieee_fp32_matmul():
        g = en.mT @ av
    return m / torch.sum(g * g, dim=-2)


def music_spectrum(rr, ri, ai, aq, *, n_sources: int) -> torch.Tensor:
    """MUSIC pseudospectrum 1 / ||E_n^H a||^2 on the scan grid.

    eigh runs on the real embedding; each complex eigenvalue lands twice, so
    the embedded noise subspace is the 2(M - n_sources) smallest
    eigenvectors and the projector equals the complex one. Normalized by
    ||a||^2 = M so a flat (noise-only) spectrum sits at 1.
    """
    m = rr.shape[-1]
    if not 0 < n_sources < m:
        raise ValueError(f"n_sources must be in [1, {m - 1}], got {n_sources}")
    c = _embed(rr, ri)
    return _noise_spectrum(c, _embed_vectors(ai, aq, c), m, n_sources)


def _spectrum(cfg: ArrayConfig, rr, ri, ai, aq, method: str, n_sources: int) -> torch.Tensor:
    if method == "bartlett":
        return bartlett_spectrum(rr, ri, ai, aq)
    if method == "mvdr":
        return mvdr_spectrum(rr, ri, ai, aq, loading=cfg.diagonal_loading)
    if method == "music":
        return music_spectrum(rr, ri, ai, aq, n_sources=n_sources)
    raise ValueError(f"unknown method {method!r}")


def spatial_spectrum(
    cfg: ArrayConfig,
    xi,
    xq,
    *,
    method: str = "music",
    n_sources: int = 1,
    forward_backward: bool = False,
    device="cuda",
) -> torch.Tensor:
    """Snapshots -> spectrum over the cfg scan grid."""
    ai, aq = steering(cfg, scan_angles(cfg))
    rr, ri = sample_covariance(xi, xq, forward_backward=forward_backward, device=device)
    return _spectrum(cfg, rr, ri, ai, aq, method, n_sources)


def _pick_peaks(angles: np.ndarray, spectrum: np.ndarray, k: int) -> np.ndarray:
    """Top-k interior local maxima with 3-point parabolic refinement of the
    reciprocal spectrum; falls back to the k largest samples if the surface
    is too flat (host NumPy, the reference's)."""
    s = np.asarray(spectrum, dtype=np.float64)
    interior = np.nonzero((s[1:-1] >= s[:-2]) & (s[1:-1] > s[2:]))[0] + 1
    if interior.size < k:
        order = np.argsort(s)[::-1]
        keep = []
        for i in order:
            if all(abs(i - j) > 1 for j in keep):
                keep.append(int(i))
            if len(keep) == k:
                break
        interior = np.asarray(sorted(keep))
    peaks = interior[np.argsort(s[interior])[::-1][:k]]
    step = angles[1] - angles[0]
    r = 1.0 / np.maximum(s, np.finfo(np.float64).tiny)
    out = []
    for p in peaks:
        if 0 < p < s.size - 1:
            denom = r[p - 1] - 2.0 * r[p] + r[p + 1]
            delta = 0.0 if denom == 0.0 else 0.5 * (r[p - 1] - r[p + 1]) / denom
            delta = float(np.clip(delta, -0.5, 0.5))
        else:
            delta = 0.0
        out.append(angles[p] + delta * step)
    return np.sort(np.asarray(out))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def estimate_doa(
    cfg: ArrayConfig,
    xi,
    xq,
    *,
    n_sources: int,
    method: str = "music",
    forward_backward: bool = False,
    device="cuda",
) -> np.ndarray:
    """Full chain: snapshots -> spectrum on the device -> bearings (degrees,
    ascending) by the host peak pick."""
    spec = spatial_spectrum(
        cfg, xi, xq, method=method, n_sources=n_sources, forward_backward=forward_backward,
        device=device,
    )
    return _pick_peaks(scan_angles(cfg), _host(spec), n_sources)


def _subspace_complex(rr, ri, n_sources: int, which: str) -> np.ndarray:
    """Orthonormal complex basis of the signal or noise subspace.

    The eigh runs on the covariance's device over the real embedding; each
    complex eigenvector lands twice, so complexifying the selected real
    block spans the complex subspace, and a host SVD of the tiny (M, 2K)
    block gives the orthonormal K-dim basis.
    """
    m = rr.shape[-1]
    if not 0 < n_sources < m:
        raise ValueError(f"n_sources must be in [1, {m - 1}], got {n_sources}")
    _, vecs = torch.linalg.eigh(_embed(rr, ri))
    v = _host(vecs)
    if which == "signal":
        block = v[:, 2 * (m - n_sources) :]
        k = n_sources
    else:
        block = v[:, : 2 * (m - n_sources)]
        k = m - n_sources
    comp = block[:m] + 1j * block[m:]
    q = np.linalg.svd(comp, full_matrices=False)[0]
    return q[:, :k]


def esprit(
    cfg: ArrayConfig, xi, xq, *, n_sources: int, forward_backward: bool = False, device="cuda"
) -> np.ndarray:
    """Grid-free ESPRIT bearings (degrees, ascending): the covariance and
    eigh on the device, the K x K least squares and eigenvalues on the host."""
    rr, ri = sample_covariance(xi, xq, forward_backward=forward_backward, device=device)
    es = _subspace_complex(rr, ri, n_sources, "signal")
    psi = np.linalg.lstsq(es[:-1], es[1:], rcond=None)[0]
    phi = np.linalg.eigvals(psi)
    s = np.clip(-np.angle(phi) / (2.0 * np.pi * cfg.spacing), -1.0, 1.0)
    return np.sort(np.degrees(np.arcsin(s)))


def root_music(
    cfg: ArrayConfig, xi, xq, *, n_sources: int, forward_backward: bool = False, device="cuda"
) -> np.ndarray:
    """Grid-free root-MUSIC bearings (degrees, ascending): the K roots of the
    null-spectrum polynomial nearest the unit circle (from inside); the
    covariance and eigh on the device, ``np.roots`` on the host."""
    rr, ri = sample_covariance(xi, xq, forward_backward=forward_backward, device=device)
    en = _subspace_complex(rr, ri, n_sources, "noise")
    m = en.shape[0]
    pn = en @ en.conj().T
    # coefficient of z^k (k = -(M-1) .. M-1) is the k-th diagonal sum
    coefs = np.array([np.trace(pn, offset=k) for k in range(m - 1, -m, -1)])
    roots = np.roots(coefs)
    roots = roots[np.abs(roots) < 1.0]  # keep the inside-circle mirror
    order = np.argsort(np.abs(np.abs(roots) - 1.0))
    picked = roots[order[:n_sources]]
    s = np.clip(-np.angle(picked) / (2.0 * np.pi * cfg.spacing), -1.0, 1.0)
    return np.sort(np.degrees(np.arcsin(s)))


def synthesize_wideband(
    cfg: ArrayConfig,
    angles_deg,
    n_samples: int,
    *,
    spacing_samples: float,
    snr_db: float = 10.0,
    seed: int = 0,
) -> np.ndarray:
    """Real broadband snapshots: white Gaussian sources delayed across the
    ULA by ``m * spacing_samples * sin(theta)`` samples (exact fractional
    delays via FFT phase ramps) plus white noise. Returns (M, T) float32."""
    rng = np.random.default_rng(seed)
    angles = np.atleast_1d(np.asarray(angles_deg, dtype=np.float64))
    x = np.zeros((cfg.n_sensors, n_samples), dtype=np.float64)
    f = np.fft.rfftfreq(n_samples)
    for th in angles:
        s = rng.standard_normal(n_samples)
        sf = np.fft.rfft(s)
        tau = spacing_samples * np.sin(np.deg2rad(th))
        for m in range(cfg.n_sensors):
            x[m] += np.fft.irfft(sf * np.exp(-2j * np.pi * f * m * tau), n_samples)
    sigma = 10.0 ** (-snr_db / 20.0)
    x += sigma * rng.standard_normal(x.shape)
    return x.astype(np.float32)


def wideband_music_spectrum(
    cfg: ArrayConfig,
    x,
    *,
    n_sources: int,
    spacing_samples: float,
    nfft: int = 256,
    hop: int | None = None,
    band: tuple[float, float] = (0.05, 0.45),
    window: str = "hann",
    device="cuda",
) -> torch.Tensor:
    """Incoherent wideband MUSIC: the STFT of each sensor, the per-bin
    sample covariance over frames, each bin's noise subspace by one batched
    real-embedded ``eigh``, per-bin frequency-scaled steering, and the
    normalized pseudospectra averaged over the band. (M, T) real snapshots
    -> (n_grid,) spectrum.

    ``spacing_samples`` is the inter-sensor propagation delay in samples at
    endfire (the wideband geometry knob).
    """
    m = cfg.n_sensors
    if not 0 < n_sources < m:
        raise ValueError(f"n_sources must be in [1, {m - 1}], got {n_sources}")
    if not 0.0 <= band[0] < band[1] <= 0.5:
        raise ValueError(f"band must satisfy 0 <= lo < hi <= 0.5, got {band}")
    hop = hop or nfft // 2
    x = as_tensor(x, device).to(torch.float32)
    s = stft(x, nfft=nfft, hop=hop, window=window)
    kbins = np.arange(nfft // 2 + 1)
    keep = (kbins / nfft >= band[0]) & (kbins / nfft <= band[1])
    sel = np.nonzero(keep)[0]
    s = s[..., torch.from_numpy(sel).to(s.device)]  # drop out-of-band bins first
    sr = s.real  # (M, frames, Kb)
    si = s.imag
    nframes = s.shape[1]
    with ieee_fp32_matmul():
        rr = (torch.einsum("mfk,nfk->kmn", sr, sr) + torch.einsum("mfk,nfk->kmn", si, si)) / nframes
        ri = (torch.einsum("mfk,nfk->kmn", si, sr) - torch.einsum("mfk,nfk->kmn", sr, si)) / nframes
    # per-bin steering, frequency-scaled: phase_m(k) = -2*pi*(k/nfft)*
    # spacing_samples*m*sin(theta) -> (Kb, 2M, A) embedded columns
    angles = scan_angles(cfg)
    marr = np.arange(m, dtype=np.float64)[:, None]
    sin_t = np.sin(np.deg2rad(angles))[None, :]
    av = np.empty((sel.size, 2 * m, angles.size), np.float32)
    for i, k in enumerate(sel):
        phase = -2.0 * np.pi * (k / nfft) * spacing_samples * marr * sin_t
        av[i, :m] = np.cos(phase)
        av[i, m:] = np.sin(phase)
    spec = _noise_spectrum(_embed(rr, ri), torch.from_numpy(av).to(x.device), m, n_sources)  # (Kb, A)
    return torch.mean(spec, dim=0)


def estimate_doa_wideband(
    cfg: ArrayConfig, x, *, n_sources: int, spacing_samples: float, **kw
) -> np.ndarray:
    """Wideband chain: STFT-MUSIC spectrum -> host top-K peak pick."""
    spec = wideband_music_spectrum(cfg, x, n_sources=n_sources, spacing_samples=spacing_samples, **kw)
    return _pick_peaks(scan_angles(cfg), _host(spec), n_sources)


def spectrum_batch(
    cfg: ArrayConfig,
    xi,
    xq,
    *,
    method: str = "music",
    n_sources: int = 1,
    mesh=None,
    device="cuda",
) -> torch.Tensor:
    """Batch of (batch, M, T) snapshot blocks -> (batch, n_grid) spectra in
    one call: batched covariances, factorizations and products.

    With ``mesh`` (the family's dp step, as :func:`radar.detect_batch`): every
    rank passes the global batch, scans its ``ch`` share of the blocks on the
    mesh's device, and gathers the spectra over ``ch``; no collective inside
    the step.
    """
    sharding = None
    if mesh is not None:
        sharding = batch_sharding(check_mesh(mesh))
        xi, xq = (sharding.shard(v).to(mesh.device) for v in (xi, xq))
    ai, aq = steering(cfg, scan_angles(cfg))
    rr, ri = sample_covariance(xi, xq, device=device)
    spec = _spectrum(cfg, rr, ri, ai, aq, method, n_sources)
    return spec if sharding is None else sharding.gather(spec)
