from .channelizer import (  # noqa: F401
    branch_fir,
    design_prototype,
    dft_matmul,
    fused_branch_dft,
    fused_pfb_raw,
    pfb_channelize,
    pfb_channelize_chunk,
    pfb_channelize_chunk_planar,
    pfb_channelize_planar,
    pfb_stream_init,
    pfb_synthesize,
    pfb_synthesize_planar,
)
from .cic import cic_decimate, cic_interpolate, design_cic_compensator  # noqa: F401
from .companding import (  # noqa: F401
    alaw_decode,
    alaw_encode,
    mu_compress,
    mu_expand,
    mulaw_decode,
    mulaw_encode,
)
from .demod import (  # noqa: F401
    am_demodulate,
    fm_demodulate,
    fm_modulate,
    frequency_translate,
    oscillator_bank,
)
from .direct_xla import moving_average_reduce_window  # noqa: F401
from .farrow import (  # noqa: F401
    MATMUL_MAX_PRODUCT,
    MATMUL_MAX_PRODUCT_CUDA,
    MAX_DENOMINATOR,
    FarrowMatmulState,
    FarrowState,
    as_rational_rate,
    farrow_chunk,
    farrow_init,
    farrow_matmul_chunk,
    farrow_matmul_flush,
    farrow_matmul_init,
    farrow_matmul_state_from_jax,
    farrow_output_len,
    farrow_state_from_jax,
    resample_farrow,
    resample_farrow_segmented,
)
from .cepstrum import (  # noqa: F401
    cepstral_pitch,
    complex_cepstrum,
    inverse_complex_cepstrum,
    real_cepstrum,
    unwrap,
)
# ``fft``, ``correlate`` and ``lti`` stay the names of their modules (as in
# the reference package); their functions of those names are ``ops.fft.fft``,
# ``ops.correlate.correlate`` and ``ops.lti.lti``.
from .correlate import (  # noqa: F401
    DIRECT_MAX_TAPS,
    DIRECT_MIN_STREAM,
    MODES,
    autocorrelate,
    choose_conv_method,
    convolve,
    correlate_complex,
    correlation_lags,
    fftconvolve,
    find_delay,
    find_delay_phat,
    gcc_phat,
    oaconvolve,
    vectorstrength,
)
from .fft import (  # noqa: F401
    CZT,
    FFT_METHODS,
    HILBERT_BLOCKED_MIN_T,
    HILBERT_XLA_MAX_T,
    XLA_FFT_MAX_N,
    ZoomFFT,
    check_cola,
    check_nola,
    coherence,
    csd,
    czt,
    czt_points,
    design_hilbert_fir,
    dpss_windows,
    envelope,
    get_window,
    hilbert,
    hilbert2,
    hilbert_fir,
    ifft,
    irfft,
    istft,
    multitaper_psd,
    periodogram,
    power_spectrum,
    rfft,
    spectral_window,
    spectrogram,
    stft,
    tone_power,
    welch,
    zoomfft,
)
from .fft_mxu import (  # noqa: F401
    FUSED3_MAX_NFFT,
    FUSED_MAX_NFFT,
    fused_fir,
    fused_fir3,
    overlap_save_fused,
    overlap_save_mxu,
    pick_factored_nfft,
    pick_fused_block,
)
from .fir import (  # noqa: F401
    FIR_FFT_CROSSOVER,
    box_taps,
    design_firwin2,
    design_lowpass,
    design_remez,
    fir_direct,
    fir_filter,
    fir_overlap_save,
    kaiser_beta,
    kaiser_num_taps,
    savgol_filter,
)
from .gain import agc, db, dc_block, detrend, soft_clip  # noqa: F401
from .iir import (  # noqa: F401
    PALLAS_IIR_MIN_T,
    ba_to_sos,
    decimate_iir,
    design_butterworth,
    design_chebyshev1,
    filtfilt,
    iir1_affine_scan,
    iir1_block_scan,
    iir_first_order,
    lfilter,
    sos_cascade,
    sos_cascade_mxu,
    sos_cascade_unrolled,
    sos_sections,
    sos_state_from_jax,
    sosfilt,
    sosfilt_chunk,
    sosfilt_init,
    sosfilt_tv,
    sosfilt_tv_chunk,
    sosfilt_tv_frames,
    sosfilt_tv_frames_chunk,
    sosfilt_tv_fused,
    sosfiltfilt,
    tv_cascade,
    tv_frames_cascade,
    tv_section,
)
from .iir_design import ellipord, iirdesign, iirfilter  # noqa: F401
from .mel import (  # noqa: F401
    dct_matrix,
    delta,
    hz_to_mel,
    log_melspectrogram,
    mel_filterbank,
    mel_frequencies,
    mel_to_hz,
    melspectrogram,
    mfcc,
    mfcc_chunk,
    mfcc_init,
)
from .lti import (  # noqa: F401
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
    dlsim_scan,
    dlti,
    dstep,
    freqresp,
    freqz_zpk,
    impulse,
    invres,
    invresz,
    lsim,
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
from .lpc import (  # noqa: F401
    ar_psd,
    levinson,
    lpc_synth_pass,
    lpc_synth_state,
    lpc_synthesis,
    lpc_synthesis_factored,
    lpc_synthesis_pallas,
    lpc_synthesis_refine,
    lpc_vocoder,
)
from .metrics import enob, sfdr, sinad, snr_tone, thd, tone_metrics  # noqa: F401
from .moving_average import METHODS, moving_average  # noqa: F401
from .pallas_direct import MAX_DIRECT_WINDOW, direct_averager  # noqa: F401
from .pallas_scan import (  # noqa: F401
    SCAN_VARIANTS,
    cumsum,
    moving_average_two_pass,
    scan_averager,
    windowed_averager,
    windowed_averager_packed,
)
from .phase_vocoder import (  # noqa: F401
    TimeStretchState,
    pitch_shift,
    spectral_subtract,
    time_stretch,
    time_stretch_chunk,
    time_stretch_flush,
    time_stretch_init,
    time_stretch_state_from_jax,
)
from .peaks import (  # noqa: F401
    argrelextrema,
    argrelmax,
    argrelmin,
    find_peaks,
    find_peaks_cwt,
    peak_mask,
    peak_prominences,
    peak_widths,
)
from .pfb_os import design_pr_prototype, pfb_analyze_os, pfb_synthesize_os  # noqa: F401
from .rank import medfilt, order_filter, rank_filter, wiener  # noqa: F401
from .resample import decimate, interpolate, resample_fft, resample_poly, upfirdn  # noqa: F401
from .scan_xla import cumsum_ref, moving_average_xla  # noqa: F401
from .signal import (  # noqa: F401
    chirp,
    gausspulse,
    max_len_seq,
    sawtooth,
    square,
    sweep_poly,
    tone,
    unit_impulse,
    white_noise,
)
from .splines import cspline1d, qspline1d, spline_filter  # noqa: F401
from .stft_class import ShortTimeFFT, closest_STFT_dual_window  # noqa: F401
from .twod import convolve2d, correlate2d, medfilt2d, sepfir2d  # noqa: F401
from .wavelets import cwt, lombscargle, morlet2, ricker  # noqa: F401
from .streaming import (  # noqa: F401
    FirState,
    IstftState,
    StftState,
    istft_chunk,
    istft_flush,
    istft_init,
    istft_state_from_jax,
    stft_chunk,
    stft_init,
    stft_state_from_jax,
    MovingAverageState,
    fir_chunk,
    fir_init,
    fir_state_from_jax,
    moving_average_chunk,
    moving_average_init,
    state_from_jax,
)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel of csrc/ since the last reset, B3 by variant.

    B6 and B7 are the ring kernels of ``parallel/ring_pallas.py``; S1 and S2
    the NLMS and RLS recursions of ``models/adaptive.py``; S3 the state-space
    recursion of ``ops/lti.py``.
    """
    from ..models import adaptive
    from ..parallel import ring_pallas

    return {
        "B1": windowed_averager.launches,
        "B2": windowed_averager_packed.launches,
        **{f"B3/{v}": n for v, n in scan_averager.launches.items()},
        "B4": cumsum.launches,
        "B5": direct_averager.launches,
        "B6": ring_pallas.ring_shift_right_shard.launches,
        "B7": ring_pallas.fused_ring_windowed_shard.launches,
        "B8": fused_fir.launches,
        "B9": fused_fir3.launches,
        "B10": iir1_block_scan.launches,
        "B11": iir1_affine_scan.launches,
        "B12": sos_cascade.launches,
        "B13": sos_cascade_unrolled.launches,
        "B14": sos_cascade_mxu.launches,
        "B15": sos_sections.launches,
        "B16": tv_cascade.launches,
        "B17": tv_section.launches,
        "B18": tv_frames_cascade.launches,
        "B19": fused_pfb_raw.launches,
        "B20": fused_branch_dft.launches,
        "B21": resample_farrow_segmented.launches,
        "B22": lpc_synth_pass.launches,
        "S1": adaptive.nlms_scan.launches,
        "S2": adaptive.rls_scan.launches,
        "S3": dlsim_scan.launches,
    }


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from ..models import adaptive
    from ..parallel import ring_pallas

    for fn in (
        ring_pallas.ring_shift_right_shard, ring_pallas.fused_ring_windowed_shard,
        windowed_averager, windowed_averager_packed, cumsum, direct_averager, fused_fir, fused_fir3,
        iir1_block_scan, iir1_affine_scan, sos_cascade, sos_cascade_unrolled, sos_cascade_mxu,
        sos_sections, tv_cascade, tv_section,
        tv_frames_cascade, fused_pfb_raw, fused_branch_dft, resample_farrow_segmented,
        lpc_synth_pass, adaptive.nlms_scan, adaptive.rls_scan, dlsim_scan,
    ):
        fn.launches = 0
    scan_averager.launches = dict.fromkeys(SCAN_VARIANTS, 0)
