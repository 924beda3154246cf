"""nx_signal_tpu — a digital-signal-processing framework on JAX/XLA.

Built from scratch on JAX/XLA with the full capability surface of the
nx_signal reference library (scipy.signal-equivalent semantics): windowed
STFT/ISTFT with deterministic overlap-add, window families, FIR design and
application (direct / FFT / overlap-add / overlap-save convolution), mel
spectrograms, waveform generators, median/Wiener filters, peak finding, and
Lambert W — plus multi-chip channel and time-block sharding with ppermute
halo exchange (bit-comparable to single-device runs), which the reference
does not have.

Layering (see SURVEY.md §7):
  ops/       scipy-semantics primitives (windows, waveforms, convolution,
             filters, peak finding, lambert_w, fft helpers)
  spectral/  composite STFT pipeline (framing, stft/istft, mel)
  kernels/   framed-DFT and fused FIR+DFT matmul kernels for the hot paths
  parallel/  mesh + sharding + halo exchange + streaming
  models/    end-to-end pipelines (spectrogram, filter chains)
"""

from nx_signal_tpu.ops import (
    convolution,
    filters,
    mixing,
    peak_finding,
    resample,
    transforms,
    waveforms,
    windows,
)
from nx_signal_tpu.ops import iir, iir_design, ltisys
from nx_signal_tpu.ops.convolution import (
    choose_conv_method,
    convolve,
    correlate,
    correlation_lags,
    deconvolve,
    fftconvolve,
    oaconvolve,
)
from nx_signal_tpu.ops.czt import CZT, ZoomFFT, czt, czt_points, zoom_fft
from nx_signal_tpu.ops.filters import (
    detrend,
    firwin,
    firwin_2d,
    freqs,
    freqs_zpk,
    freqz,
    freqz_zpk,
    gammatone,
    group_delay,
    max_len_seq,
    medfilt,
    medfilt2d,
    median,
    order_filter,
    sosfreqz,
    wiener,
)
from nx_signal_tpu.ops.ltisys import (
    BadCoefficients,
    StateSpace,
    TransferFunction,
    ZerosPolesGain,
    abcd_normalize,
    bilinear,
    bode,
    cont2discrete,
    dbode,
    dfreqresp,
    dimpulse,
    dlsim,
    dlti,
    dstep,
    findfreqs,
    freqresp,
    impulse,
    invres,
    invresz,
    lsim,
    lti,
    normalize,
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
from nx_signal_tpu.ops.splines import (
    cspline1d,
    cspline1d_eval,
    cspline2d,
    cubic_bspline,
    gauss_spline,
    qspline1d,
    qspline1d_eval,
    qspline2d,
    quadratic_bspline,
    sepfir2d,
    spline_filter,
    symiirorder1,
    symiirorder2,
)
from nx_signal_tpu.ops.transforms import envelope, hilbert, hilbert2
from nx_signal_tpu.ops.iir import (
    filtfilt,
    lfilter,
    lfilter_zi,
    lfiltic,
    sosfilt,
    sosfilt_zi,
    sosfiltfilt,
)
from nx_signal_tpu.ops.iir_design import (
    bessel,
    besselap,
    bilinear_zpk,
    buttap,
    butter,
    band_stop_obj,
    buttord,
    cheb1ap,
    cheb1ord,
    cheb2ap,
    cheb2ord,
    cheby1,
    cheby2,
    ellip,
    ellipap,
    ellipord,
    iircomb,
    iirdesign,
    iirfilter,
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
    sos2tf,
    sos2zpk,
    tf2sos,
    tf2zpk,
    zpk2sos,
    zpk2tf,
)
from nx_signal_tpu.ops.convolution import convolve2d, correlate2d
from nx_signal_tpu.ops.filters import freqz_sos, savgol_coeffs, savgol_filter
from nx_signal_tpu.ops.fir_design import (
    firls,
    firwin2,
    kaiser_atten,
    kaiser_beta,
    kaiserord,
    minimum_phase,
    remez,
)
from nx_signal_tpu.ops.waveforms import (
    GaussianPulse,
    chirp,
    gaussian_pulse,
    gausspulse,
    polynomial_sweep,
    sawtooth,
    sinc,
    square,
    sweep_poly,
    unit_impulse,
)
from nx_signal_tpu.ops.windows import (
    boxcar,
    get_window,
    kaiser_bessel_derived,
    triang,
)
from nx_signal_tpu.spectral.estimation import lombscargle, vectorstrength
from nx_signal_tpu.ops.find_peaks import (
    Peaks,
    find_peaks,
    find_peaks_cwt,
    peak_prominences,
    peak_widths,
)
from nx_signal_tpu.ops.wavelets import cwt, morlet, morlet2, qmf, ricker
from nx_signal_tpu.ops.lambert_w import lambert_w
from nx_signal_tpu.ops.peak_finding import argrelextrema, argrelmax, argrelmin
from nx_signal_tpu.ops.mixing import demodulate_channel, mix_down
from nx_signal_tpu.ops.resample import (
    decimate,
    pfb_analyze,
    resample,
    resample_poly,
    upfirdn,
)
from nx_signal_tpu.spectral.framing import as_windowed, overlap_and_add
from nx_signal_tpu.spectral.mel import mel_filters, stft_to_mel
from nx_signal_tpu.spectral.estimation import coherence, csd, periodogram, welch
from nx_signal_tpu.spectral.short_time_fft import (
    ShortTimeFFT,
    closest_STFT_dual_window,
)
from nx_signal_tpu.spectral.spectrogram import spectrogram
from nx_signal_tpu.spectral.stft import (
    STFTResult,
    check_COLA,
    check_NOLA,
    check_cola,
    check_nola,
    fft_frequencies,
    istft,
    stft,
)

__version__ = "0.1.0"

__all__ = [
    # submodules
    "windows", "waveforms", "transforms", "convolution", "filters",
    "peak_finding", "resample",
    # spectral pipeline
    "stft", "istft", "STFTResult", "fft_frequencies", "as_windowed",
    "overlap_and_add", "mel_filters", "stft_to_mel", "spectrogram",
    "periodogram", "welch", "csd", "coherence", "check_cola", "check_nola",
    "check_COLA", "check_NOLA", "closest_STFT_dual_window",
    "ShortTimeFFT",
    # convolution family
    "convolve", "correlate", "correlation_lags", "deconvolve",
    "choose_conv_method", "fftconvolve", "oaconvolve",
    # filters & design
    "firwin", "firwin_2d", "median", "medfilt", "medfilt2d", "order_filter", "wiener",
    "gammatone", "max_len_seq",
    "lfilter", "lfilter_zi", "lfiltic", "filtfilt", "sosfilt", "sosfilt_zi",
    "sosfiltfilt", "butter", "cheby1", "cheby2", "ellip", "bessel",
    "iirfilter", "iirnotch", "iirpeak", "iircomb", "iirdesign",
    "band_stop_obj", "buttord", "cheb1ord", "cheb2ord", "ellipord", "iir", "iir_design",
    "buttap", "cheb1ap", "cheb2ap", "ellipap", "besselap",
    "lp2lp", "lp2hp", "lp2bp", "lp2bs",
    "lp2lp_zpk", "lp2hp_zpk", "lp2bp_zpk", "lp2bs_zpk", "bilinear_zpk",
    "zpk2tf", "tf2zpk", "zpk2sos", "tf2sos", "sos2tf", "sos2zpk",
    "freqz", "sosfreqz", "freqz_zpk", "freqs", "freqs_zpk", "group_delay",
    "czt", "zoom_fft", "czt_points", "CZT", "ZoomFFT", "BadCoefficients",
    # LTI systems
    "ltisys", "normalize", "bilinear", "tf2ss", "ss2tf", "zpk2ss", "ss2zpk",
    "abcd_normalize", "cont2discrete", "unique_roots", "residue", "residuez",
    "invres", "invresz", "hilbert", "hilbert2", "envelope",
    "dlsim", "dimpulse", "dstep", "lsim", "impulse", "step", "lti", "dlti",
    "TransferFunction", "ZerosPolesGain", "StateSpace", "place_poles",
    "findfreqs", "freqresp", "bode", "dfreqresp", "dbode",
    # splines
    "gauss_spline", "cubic_bspline", "quadratic_bspline", "symiirorder1",
    "symiirorder2", "cspline1d", "qspline1d", "cspline1d_eval",
    "qspline1d_eval", "cspline2d", "qspline2d", "sepfir2d", "spline_filter",
    # resampling & mixing
    "upfirdn", "resample_poly", "pfb_analyze", "resample", "decimate",
    "mix_down", "demodulate_channel", "mixing", "detrend",
    # peak finding & special
    "argrelmin", "argrelmax", "argrelextrema", "lambert_w",
    "find_peaks", "peak_prominences", "peak_widths", "Peaks",
    "find_peaks_cwt",
    # wavelets
    "ricker", "morlet", "morlet2", "qmf", "cwt",
    # waveforms
    "sawtooth", "square", "chirp", "gaussian_pulse", "gausspulse",
    "GaussianPulse", "polynomial_sweep", "sweep_poly", "unit_impulse",
    "sinc",
    # windows + 2-D conv + estimation extras
    "get_window", "convolve2d", "correlate2d", "lombscargle",
    "vectorstrength",
    # FIR design long tail
    "kaiser_beta", "kaiser_atten", "kaiserord", "firwin2", "firls",
    "remez", "minimum_phase", "savgol_coeffs", "savgol_filter",
    "freqz_sos",
    "__version__",
]
