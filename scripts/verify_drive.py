"""End-to-end user-style drive of the public package surface.

This is the /verify skill's drive script (kept in-repo so each round's
end-to-end recipe persists). Run from anywhere:

    PYTHONPATH=<checkout> python <checkout>/scripts/verify_drive.py

Covers: firwin design gates, convolve/oaconvolve agreement + stopband,
stft/istft round-trip, stft_to_mel, sharded bitwise parity on the 8-device
CPU mesh, error paths, the round-2 additions (iircomb/ord-selection/
gammatone/cont2discrete/check_nola/envelope/ShortTimeFFT), and the native
prefetching IO layer.
"""

import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

from nx_signal_tpu.ops.filters import firwin
from nx_signal_tpu.ops.convolution import convolve, oaconvolve
from nx_signal_tpu.spectral import stft, istft
from nx_signal_tpu.spectral.mel import stft_to_mel
from nx_signal_tpu.ops.windows import hann
from nx_signal_tpu.parallel.mesh import make_dsp_mesh
from nx_signal_tpu.parallel.sharded import (
    sharded_convolve_same, sharded_istft, sharded_stft)

rng = np.random.default_rng(42)

# 1. firwin DC gain
h = firwin(255, [2000.0], sampling_rate=16000.0)
dc = float(jnp.sum(h))
assert abs(dc - 1.0) < 1e-6, dc
print("1. firwin DC gain OK:", dc)

# 2. convolve vs oaconvolve + stopband attenuation
t = np.arange(16000) / 16000.0
x = (np.sin(2*np.pi*500*t) + np.sin(2*np.pi*6000*t)).astype(np.float32)
y1 = convolve(x, h, mode="same")
y2 = oaconvolve(x, h, mode="same")
rel = float(jnp.max(jnp.abs(y1 - y2)) / jnp.max(jnp.abs(y1)))
assert rel < 1e-5, rel
# stopband: 6 kHz tone must be >= 60 dB down
seg = slice(2000, 14000)
yf = np.fft.rfft(np.asarray(y1)[seg] * np.hanning(12000))
f = np.fft.rfftfreq(12000, 1/16000)
p500 = np.abs(yf[np.argmin(np.abs(f-500))]); p6k = np.abs(yf[np.argmin(np.abs(f-6000))])
att = 20*np.log10(p500/p6k)
assert att >= 60, att
print(f"2. convolve/oa agree ({rel:.2e}), stopband {att:.0f} dB OK")

# 3. stft -> istft round-trip
w = hann(512)
sig = rng.normal(size=16384).astype(np.float32)
z, times, freqs = stft(sig, w, overlap_length=384, fft_length=512, sampling_rate=16000.0)
rec = istft(z, w, overlap_length=384, fft_length=512, sampling_rate=16000.0)
n = min(rec.shape[-1], sig.shape[-1])
err = float(np.max(np.abs(np.asarray(rec)[512:n-512] - sig[512:n-512])))
assert err <= 1e-5, err
print("3. stft/istft interior round-trip OK:", err)

# 4. stft_to_mel
mel = stft_to_mel(z, 16000.0, fft_length=512, mel_bins=80)
assert mel.shape == (z.shape[0], 80) and bool(jnp.all(jnp.isfinite(mel)))
print("4. stft_to_mel OK:", mel.shape, float(mel.min()), float(mel.max()))

# 5. sharded parity on (2,4) mesh
mesh = make_dsp_mesh(2, 4)
xs = rng.normal(size=(4, 8192)).astype(np.float32)
taps = np.asarray(h, np.float32)
got = sharded_convolve_same(xs, taps, mesh=mesh, method="conv")
from nx_signal_tpu.ops.convolution import _direct_convolve
want = _direct_convolve(jnp.asarray(xs), jnp.asarray(taps)[None, :], "same", use_matmul=False)
np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
zs, _, _ = stft(jnp.asarray(xs), w, overlap_length=384, fft_length=512, sampling_rate=16000.0)
sz, _, _ = sharded_stft(jnp.asarray(xs), w, mesh=mesh, overlap_length=384, fft_length=512, sampling_rate=16000.0)
srel = float(jnp.max(jnp.abs(sz - zs)) / jnp.max(jnp.abs(zs)))
assert srel <= 1e-6, srel
gi = sharded_istft(zs, w, mesh=mesh, overlap_length=384, fft_length=512, sampling_rate=16000.0, method="matmul")
si = istft(zs, w, overlap_length=384, fft_length=512, sampling_rate=16000.0, method="matmul")
np.testing.assert_array_equal(np.asarray(gi), np.asarray(si))
print(f"5. sharded parity OK (conv bitwise, stft rel {srel:.1e}, istft bitwise)")

# 6. error paths
errs = 0
try: stft(sig, w, scaling="bogus")
except ValueError as e: errs += 1; print("   scaling err:", str(e)[:60])
try: firwin(64, [9000.0], sampling_rate=16000.0)
except ValueError as e: errs += 1; print("   cutoff err:", str(e)[:60])
try: stft(sig, w, overlap_length=512)
except ValueError as e: errs += 1; print("   overlap err:", str(e)[:60])
assert errs == 3
print("6. error paths OK")

# 7. this round's fixes: iircomb/ordsel through the public surface
import nx_signal_tpu as nst
import scipy.signal as sps
b, a = nst.iircomb(50.0, 30.0, fs=1000.0)
b2, a2 = sps.iircomb(50.0, 30.0, fs=1000.0)
np.testing.assert_allclose(b, b2, rtol=1e-12); np.testing.assert_allclose(a, a2, rtol=1e-12)
n1, wn1 = nst.cheb2ord([0.2, 0.5], [0.1, 0.6], 3, 40)
n2, wn2 = sps.cheb2ord([0.2, 0.5], [0.1, 0.6], 3, 40)
assert n1 == n2 and np.allclose(wn1, wn2, rtol=1e-8)
print("7. iircomb + cheb2ord public-surface parity OK")
print("ALL VERIFY CHECKS PASSED")

# 8. round-2 scipy surface through the package root
import nx_signal_tpu as nst2
import scipy.signal as sps2
b, a = nst2.gammatone(440.0, 'iir', fs=16000.0)
b2, a2 = sps2.gammatone(440.0, 'iir', fs=16000.0)
np.testing.assert_allclose(np.asarray(b), b2, rtol=1e-10)
sysd = nst2.cont2discrete(([1.0],[1.0, 2.0]), 0.1)
wantd = sps2.cont2discrete(([1.0],[1.0, 2.0]), 0.1)
np.testing.assert_allclose(sysd[0], wantd[0], atol=1e-12)
assert nst2.check_nola(np.asarray(hann(64)), 64, 48)
env = nst2.envelope(np.asarray(x, np.float64))
assert env.shape[0] == 2
print("8. round-2 surface (gammatone/cont2discrete/check_nola/envelope) OK")
print("VERIFY DRIVE COMPLETE")

# 9. ShortTimeFFT through the package root
SFT = nst.ShortTimeFFT(np.hanning(64), hop=16, fs=1000.0)
sig9 = rng.normal(size=1000).astype(np.float64)
S9 = SFT.stft(sig9)
rec9 = np.asarray(SFT.istft(S9, k1=1000))
assert np.max(np.abs(rec9 - sig9)) < 1e-4, np.max(np.abs(rec9 - sig9))
import scipy.signal as _sps9
S9r = _sps9.ShortTimeFFT(np.hanning(64), hop=16, fs=1000.0).stft(sig9)
np.testing.assert_allclose(np.asarray(S9), S9r, atol=1e-4)  # f32 runtime vs scipy f64
print("9. ShortTimeFFT round-trip + scipy parity OK")

# 10. native IO: write -> prefetching stream -> bitwise vs batch read
import tempfile, os as _os
from nx_signal_tpu.io.wav import PrefetchingWavReader, read_wav, write_wav
_d = tempfile.mkdtemp()
_p = _os.path.join(_d, "drive.wav")
_data = rng.normal(size=(2, 30000)).astype(np.float32) * 0.4
write_wav(_p, _data, 16000, float32=True)
_whole, _sr = read_wav(_p)
_blocks = []
with PrefetchingWavReader(_p, block_frames=4000) as _pf:
    for _b in _pf:
        _blocks.append(_b)
np.testing.assert_array_equal(np.concatenate(_blocks, axis=1), np.asarray(_whole))
np.testing.assert_array_equal(np.asarray(_whole), _data)
print("10. native prefetching IO bitwise OK")

# 11. design long tail: lp2* tf transforms, sos2zpk, lfiltic, analog
#     responses, CZT/ZoomFFT class forms
bt, at = nst.lp2bp([1.0, 0.5], [1.0, 2.0, 2.0, 1.0], wo=2.0, bw=0.5)
bts, ats = sps.lp2bp([1.0, 0.5], [1.0, 2.0, 2.0, 1.0], wo=2.0, bw=0.5)
_, h_ours = sps.freqs(np.asarray(bt), np.asarray(at), np.logspace(-1, 1, 41))
_, h_sp = sps.freqs(bts, ats, np.logspace(-1, 1, 41))
np.testing.assert_allclose(h_ours, h_sp, rtol=1e-7)
z11, p11, k11 = nst.sos2zpk(sps.butter(6, 0.3, output="sos"))
z11s, p11s, k11s = sps.sos2zpk(sps.butter(6, 0.3, output="sos"))
np.testing.assert_allclose(sorted(np.asarray(p11), key=abs),
                           sorted(p11s, key=abs), atol=1e-10)
zi11 = nst.lfiltic([0.5, 0.25], [1.0, -0.5], [1.0, 2.0], [0.5, 0.2])
np.testing.assert_allclose(np.asarray(zi11),
                           sps.lfiltic([0.5, 0.25], [1.0, -0.5],
                                       [1.0, 2.0], [0.5, 0.2]), atol=1e-12)
w11, hf11 = nst.freqs(*nst.butter(4, 100.0, analog=True), 50)
w11s, hf11s = sps.freqs(*sps.butter(4, 100.0, analog=True), 50)
np.testing.assert_allclose(np.asarray(hf11), hf11s, rtol=1e-4)
x11 = rng.normal(size=96)
np.testing.assert_allclose(np.asarray(nst.CZT(96, 64)(x11)),
                           sps.CZT(96, 64)(x11), atol=1e-4)
np.testing.assert_allclose(np.asarray(nst.ZoomFFT(96, [0.1, 0.4])(x11)),
                           sps.ZoomFFT(96, [0.1, 0.4])(x11), atol=1e-4)
np.testing.assert_allclose(np.asarray(nst.czt_points(12)),
                           sps.czt_points(12), atol=1e-6)
print("11. design long tail (lp2*, sos2zpk, lfiltic, freqs, CZT/ZoomFFT) OK")

# 12. wavelets + find_peaks_cwt through the package root
x12 = np.zeros(400)
for c in (90, 200, 310):
    x12 += np.exp(-((np.arange(400) - c) ** 2) / (2 * 8.0 ** 2))
x12 += 0.03 * rng.normal(size=400)
locs12 = nst.find_peaks_cwt(x12, np.arange(2, 16))
want12 = sps.find_peaks_cwt(x12, np.arange(2, 16))
np.testing.assert_array_equal(np.asarray(locs12), np.asarray(want12))
cw12 = nst.cwt(x12, nst.ricker, np.arange(1, 9))
assert cw12.shape == (8, 400) and bool(np.all(np.isfinite(np.asarray(cw12))))
print("12. wavelets + find_peaks_cwt scipy-exact OK:", list(locs12))

# 13. round-3 surface: linear/callable detrend in the Welch family and the
#     shared-block framed-DFT strategy, through the package root
import numpy as np
import scipy.signal as sps13

import nx_signal_tpu as nst13

rng13 = np.random.default_rng(13)
x13 = (rng13.normal(size=4096) + np.linspace(0.0, 20.0, 4096)).astype(np.float32)
for dt13 in ("constant", "linear", False):
    f13, p13 = nst13.welch(x13, sampling_rate=250.0, segment_length=256,
                           detrend=dt13)
    f13r, p13r = sps13.welch(x13.astype(np.float64), fs=250.0, nperseg=256,
                             detrend=dt13)
    sc13 = np.abs(p13r).max()
    np.testing.assert_allclose(np.asarray(p13), p13r, atol=1e-4 * sc13,
                               rtol=1e-4)
_, pc13 = nst13.welch(x13, segment_length=256,
                      detrend=lambda s: s - s.mean(axis=-1, keepdims=True))
_, pc13r = sps13.welch(x13.astype(np.float64), nperseg=256,
                       detrend=lambda s: s - s.mean(axis=-1, keepdims=True))
np.testing.assert_allclose(np.asarray(pc13), pc13r,
                           atol=1e-4 * np.abs(pc13r).max(), rtol=1e-4)
from nx_signal_tpu.kernels.dft import (
    fir_framed_dft,
    fir_framed_dft_shared,
    recognize_cosine_window,
)
from nx_signal_tpu.ops.windows import hann as hann13

w13 = np.asarray(hann13(512))
co13 = recognize_cosine_window(w13, 512)
assert co13 == (0.5, -0.5), co13
taps13 = rng13.normal(size=255).astype(np.float32)
sig13 = rng13.normal(size=(2, 4096)).astype(np.float32)
dn13 = np.asarray(fir_framed_dft(sig13, taps13, w13, stride=128, n_fft=512,
                                 onesided=True, output="power"))
sh13 = np.asarray(fir_framed_dft_shared(sig13, taps13, stride=128, n_fft=512,
                                        window_coeffs=co13, onesided=True,
                                        output="power"))
np.testing.assert_allclose(sh13, dn13, atol=1e-5 * dn13.max(), rtol=1e-5)
print("13. linear/callable detrend + shared-block framed DFT OK")

# 14. round-3 aux: scipy-named waveform wrappers, failure detection +
#     elastic recovery, metrics counters
import numpy as np
import scipy.signal as sps14

import nx_signal_tpu as nst14

t14 = np.linspace(-0.01, 0.01, 201)
np.testing.assert_allclose(np.asarray(nst14.gausspulse(t14, fc=800.0)),
                           sps14.gausspulse(t14, fc=800.0), atol=1e-6)
assert abs(nst14.gausspulse("cutoff", fc=800.0)
           - sps14.gausspulse("cutoff", fc=800.0)) < 1e-12
t14b = np.linspace(0, 1.5, 301)
np.testing.assert_allclose(
    np.asarray(nst14.sweep_poly(t14b, [0.1, -0.5, 2.0], phi=10.0)),
    sps14.sweep_poly(t14b, np.poly1d([0.1, -0.5, 2.0]), phi=10.0), atol=1e-4)
from nx_signal_tpu.parallel.failure import FailureDetected, heartbeat, run_with_recovery
from nx_signal_tpu.parallel.streaming import StreamingFIR
from nx_signal_tpu.utils.metrics import Metrics, ThroughputMeter

assert heartbeat(timeout=60.0) < 60.0
try:
    import time as _time14
    heartbeat(timeout=0.2, probe=lambda: _time14.sleep(5.0))
    raise AssertionError("hung probe not detected")
except FailureDetected:
    pass
import os as _os14, tempfile as _tf14
_fir14 = StreamingFIR(np.asarray(nst14.firwin(33, [0.3])))
_x14 = np.random.default_rng(14).normal(size=(1, 20 * 64)).astype(np.float32)
_outs14 = {}
for tag, fail in (("clean", None), ("recovered", 9)):
    buf = np.zeros_like(_x14)
    armed = [fail is not None]
    def _step14(state, i, buf=buf, armed=armed, fail=fail):
        if armed[0] and i == fail:
            armed[0] = False
            raise RuntimeError("injected")
        s, y = _fir14.process(state, _x14[:, i * 64:(i + 1) * 64])
        buf[:, i * 64:(i + 1) * 64] = np.asarray(y)
        return s
    run_with_recovery(_step14, _fir14.init_state(batch_shape=(1,)), 20,
                      checkpoint_path=_os14.path.join(_tf14.mkdtemp(), "c.npz"),
                      checkpoint_every=4)
    _outs14[tag] = buf
np.testing.assert_array_equal(_outs14["recovered"], _outs14["clean"])
_m14 = Metrics()
_m14.count("blocks", 20)
with _m14.timer("run"):
    pass
_tp14 = ThroughputMeter(n_devices=2)
_tp14.update(4_000_000, 1.0)
assert _tp14.msamples_per_second_per_chip == 2.0
assert _m14.snapshot()["blocks"] == 20
print("14. scipy-named wrappers + failure detection/recovery + metrics OK")

# 15. round-3 surface: representation classes, place_poles, firwin_2d,
# closest_STFT_dual_window, band_stop_obj, scipy casing aliases
import nx_signal_tpu as nst15
import scipy.signal as sps15
tf15 = nst15.TransferFunction([1.0, 3.0], [1.0, 2.0, 1.0])
zpk15 = tf15.to_zpk()
assert isinstance(zpk15, nst15.ZerosPolesGain)
np.testing.assert_allclose(np.sort(zpk15.poles), [-1.0, -1.0], atol=1e-10)
ss15 = nst15.StateSpace(tf15)
np.testing.assert_allclose(ss15.A, sps15.TransferFunction([1.0, 3.0], [1.0, 2.0, 1.0]).to_ss().A)
t15 = np.linspace(0.0, 4.0, 120)
np.testing.assert_allclose(tf15.step(t=t15)[1],
                           sps15.TransferFunction([1.0, 3.0], [1.0, 2.0, 1.0]).step(T=t15)[1],
                           atol=1e-4)  # f32 runtime gate (x64 off outside tests)
A15 = np.array([[0.0, 1.0], [-2.0, -3.0]]); B15 = np.array([[0.0], [1.0]])
res15 = nst15.place_poles(A15, B15, [-4.0, -5.0])
np.testing.assert_allclose(
    np.sort(np.linalg.eigvals(A15 - B15 @ res15.gain_matrix).real),
    [-5.0, -4.0], atol=1e-8)
h2d = np.asarray(nst15.firwin_2d((9, 9), ("hamming", "hann"), fc=0.4))
np.testing.assert_allclose(h2d, sps15.firwin_2d((9, 9), ("hamming", "hann"), fc=0.4), atol=1e-6)
w15 = np.asarray(nst15.get_window("hann", 32, periodic=True), np.float64)
d15, a15 = nst15.closest_STFT_dual_window(w15, 8)
d15r, a15r = sps15.closest_STFT_dual_window(w15, 8)
np.testing.assert_allclose(d15, d15r, atol=1e-10)
assert abs(a15 - a15r) < 1e-12
assert nst15.check_COLA("hann", 256, 128) == sps15.check_COLA("hann", 256, 128) == True
np.testing.assert_allclose(
    np.asarray(nst15.kaiser_bessel_derived(32, 5.0)),
    sps15.windows.kaiser_bessel_derived(32, 5.0), atol=1e-6)
np.testing.assert_allclose(np.asarray(nst15.triang(7)),
                           sps15.windows.triang(7), atol=1e-6)
np.testing.assert_allclose(
    nst15.band_stop_obj(0.25, 0, np.array([0.2, 0.7]), np.array([0.35, 0.5]), 3.0, 40.0, "butter"),
    sps15.band_stop_obj(0.25, 0, np.array([0.2, 0.7]), np.array([0.35, 0.5]), 3.0, 40.0, "butter"),
    rtol=1e-10)
print("15. round-3 surface (classes/place_poles/firwin_2d/dual-window/aliases) OK")

# 16. frame-chunked fused power path against the unchunked one
from nx_signal_tpu.kernels.dft import fir_framed_dft as _ffd16
_x16 = np.random.default_rng(16).normal(size=(3, 6000)).astype(np.float32)
_t16 = np.asarray(nst15.firwin(101, [0.25]), np.float32)
_w16 = np.hanning(512).astype(np.float32)
_ref16 = np.asarray(_ffd16(_x16, _t16, _w16, stride=128, n_fft=512,
                           onesided=True, output="power"))
for _k16 in (2, 5):
    _got16 = np.asarray(_ffd16(_x16, _t16, _w16, stride=128, n_fft=512,
                               onesided=True, output="power",
                               frame_chunks=_k16))
    np.testing.assert_allclose(_got16, _ref16, atol=1e-5 * _ref16.max())
_auto16 = np.asarray(_ffd16(_x16, _t16, _w16, stride=128, n_fft=512,
                            onesided=True, output="power",
                            frame_chunks="auto"))
np.testing.assert_allclose(_auto16, _ref16, atol=1e-5 * _ref16.max())
_xe16 = np.random.default_rng(18).normal(size=(2, 6400)).astype(np.float32)
_re16 = np.asarray(_ffd16(_xe16, _t16, _w16, stride=128, n_fft=512,
                          onesided=True, output="power"))
_ce16 = np.asarray(_ffd16(_xe16, _t16, _w16, stride=128, n_fft=512,
                          onesided=True, output="power", edge="conv"))
np.testing.assert_allclose(_ce16, _re16, atol=1e-5 * _re16.max())
_g16 = np.asarray(nst15.get_window("hann", 32, periodic=True), np.float64)
_S16 = nst15.ShortTimeFFT.from_win_equals_dual(_g16, 8, fs=100.0, scale_to="unitary")
import scipy.signal as _sps16
_R16 = _sps16.ShortTimeFFT.from_win_equals_dual(_g16, 8, fs=100.0, scale_to="unitary")
np.testing.assert_allclose(_S16.win, _R16.win, atol=1e-10)
np.testing.assert_allclose(_S16.dual_win, _R16.dual_win, atol=1e-9)
from nx_signal_tpu.parallel.sharded import sharded_fir_framed_dft_power as _sfc16
from nx_signal_tpu.parallel.mesh import make_dsp_mesh as _mdm16
from nx_signal_tpu.parallel.mesh import channel_block_sharding as _cbs16
import jax as _jax16
_mesh16 = _mdm16(2, 4)
_xs16 = _jax16.device_put(jnp.asarray(_x16[:2].repeat(2, 0)), _cbs16(_mesh16, ndim=2))
_ref_s16 = np.asarray(_ffd16(np.asarray(_xs16), _t16, _w16, stride=128,
                             n_fft=512, onesided=True, output="power",
                             precision="highest"))
_got_s16 = np.asarray(_sfc16(_xs16, _t16, _w16, mesh=_mesh16, stride=128,
                             n_fft=512, precision="highest"))
np.testing.assert_allclose(_got_s16, _ref_s16, atol=2e-6 * _ref_s16.max())
print("16. frame-chunked power + sharded fused chain + from_win_equals_dual OK")

# 17. shared-block partial DFT (2x fewer matmul FLOPs) against the dense
# fused chain
from nx_signal_tpu.kernels.dft import recognize_cosine_window as _rcw17
from nx_signal_tpu.kernels.dft import fir_framed_dft_shared as _sp17
from nx_signal_tpu.ops.windows import hann as _hann17
_w17 = np.asarray(_hann17(512), np.float64)
_c17 = _rcw17(_w17, 512)
assert _c17 == (0.5, -0.5), _c17
_ref17 = np.asarray(_ffd16(_x16, _t16, _w17, stride=128, n_fft=512,
                           onesided=True, output="power"))
_got17 = np.asarray(_sp17(_x16, _t16, stride=128, n_fft=512,
                          window_coeffs=_c17, onesided=True, output="power"))
np.testing.assert_allclose(_got17, _ref17, atol=1e-4 * _ref17.max())
assert _rcw17(np.kaiser(512, 8.0), 512) is None
print("17. shared-block partial DFT vs dense fused chain OK")

# 18. round-4 PFB matmul strategies: the channelizer as an aliased-DFT
# conv-of-blocks matmul / factored polyphase+DFT vs the einsum oracle
from nx_signal_tpu.ops.resample import pfb_analyze as _pfb18
_x18 = np.random.default_rng(18).normal(size=(2, 60000)).astype(np.float32)
_ref18 = np.asarray(_pfb18(_x18, 64, taps_per_channel=8, strategy="einsum"))
for _st18 in ("matmul", "factored", "auto"):
    _got18 = np.asarray(_pfb18(_x18, 64, taps_per_channel=8, strategy=_st18))
    assert _got18.shape == _ref18.shape
    np.testing.assert_allclose(_got18, _ref18,
                               atol=2e-6 * np.abs(_ref18).max())
_got18b = np.asarray(_pfb18(_x18[0], 1024, taps_per_channel=8))  # 'factored'
assert _got18b.shape == ((60000 - 8192) // 1024 + 1, 1024)
print("18. PFB matmul strategies (matmul/factored/auto, 64 + 1024 bands) OK")

# 19. round-4 raw/IQ stream IO (the SDR ingest path): native decode of
# all capture dtypes + prefetching iterator + IQ assembly
from nx_signal_tpu.io.raw import (PrefetchingRawReader as _PR19,
                                  read_iq as _riq19, read_raw as _rr19,
                                  write_iq as _wiq19, write_raw as _wr19)
_d19 = tempfile.mkdtemp()
_x19 = np.random.default_rng(19).uniform(-0.9, 0.9, (2, 5000)).astype(np.float32)
for _dt19, _at19 in (("f32", 1e-7), ("i16", 1e-4), ("u8", 1e-2)):
    _p19 = _os.path.join(_d19, f"cap.{_dt19}")
    _wr19(_p19, _x19, dtype=_dt19)
    np.testing.assert_allclose(_rr19(_p19, dtype=_dt19, channels=2), _x19,
                               atol=_at19)
_z19 = (_x19[0] + 1j * _x19[1]).astype(np.complex64)
_pz19 = _os.path.join(_d19, "cap.iq")
_wiq19(_pz19, _z19, dtype="i16")
np.testing.assert_allclose(_riq19(_pz19, dtype="i16"), _z19, atol=1e-4)
_pp19 = _os.path.join(_d19, "pf.i16")
_wr19(_pp19, _x19, dtype="i16")
with _PR19(_pp19, dtype="i16", channels=2, block_frames=1024) as _pf19:
    _blocks19 = [b for b in _pf19]
np.testing.assert_allclose(np.concatenate(_blocks19, axis=1), _x19, atol=1e-4)
print("19. raw/IQ stream IO (native, all dtypes, prefetch) OK")

# 20. round-5 streaming channelizer + resampler: chunked == offline after
# the documented lead, zero-chunk flush drains the resampler tail
from nx_signal_tpu.ops.resample import resample_poly as _rp20
from nx_signal_tpu.parallel.streaming import (StreamingPFB as _SPFB20,
                                              StreamingResamplePoly as _SRP20)
_x20 = np.random.default_rng(20).normal(size=4096).astype(np.float32)
_pfb20 = _SPFB20(32, taps_per_channel=4)
_st20 = _pfb20.init_state()
_zs20 = []
for _i20 in range(0, 4096, 1024):
    _st20, _z20 = _pfb20.process(_st20, jnp.asarray(_x20[_i20:_i20 + 1024]))
    _zs20.append(np.asarray(_z20))
_got20 = np.concatenate(_zs20, axis=0)[_pfb20.lead_frames:]
_ref20 = np.asarray(_pfb18(_x20, 32, taps_per_channel=4))
assert _got20.shape == _ref20.shape
np.testing.assert_allclose(_got20, _ref20, atol=2e-5)
_sr20 = _SRP20(1, 3)
_st20b = _sr20.init_state()
_ys20 = []
for _i20 in range(0, 4096 - 4096 % 300, 300):
    _st20b, _y20 = _sr20.process(_st20b, jnp.asarray(_x20[_i20:_i20 + 300]))
    _ys20.append(np.asarray(_y20))
_ref20b = np.asarray(_rp20(jnp.asarray(_x20[:3900]), 1, 3))
while sum(_o.shape[-1] for _o in _ys20) < _sr20.lead_out + _ref20b.shape[0]:
    _st20b, _y20 = _sr20.process(_st20b, jnp.zeros(300, np.float32))
    _ys20.append(np.asarray(_y20))
_got20b = np.concatenate(_ys20)[_sr20.lead_out:][:_ref20b.shape[0]]
np.testing.assert_allclose(_got20b, _ref20b, atol=2e-5)
print("20. streaming PFB + resample_poly (chunked == offline, flush) OK")

# 22. round-5 config-5 ingest pipeline: PrefetchingRawReader ->
# StreamingPFB -> on-device band power == offline PFB power
from nx_signal_tpu.models.pipeline import channelize_power_stream as _cps22
_x22 = np.random.default_rng(23).uniform(-0.9, 0.9, (1, 20000)).astype(np.float32)
_p22 = _os.path.join(tempfile.mkdtemp(), "cap22.i16")
_wr19(_p22, _x22, dtype="i16")
with _PR19(_p22, dtype="i16", channels=1, block_frames=4096) as _pf22:
    _pow22, _fr22 = _cps22(_pf22, 64, taps_per_channel=8)
assert _fr22 == 20000 // 64
_dec22 = np.round(np.clip(_x22 * 32768, -32768, 32767)) / 32768
_full22 = np.pad(_dec22.astype(np.float32), [(0, 0), (448, 0)])[:, :448 + 312 * 64]
_ref22 = np.asarray(_pfb18(jnp.asarray(_full22), 64, taps_per_channel=8))
_refp22 = (_ref22.real**2 + _ref22.imag**2).sum(axis=-2)
np.testing.assert_allclose(np.asarray(_pow22), _refp22, rtol=1e-4,
                           atol=1e-4 * _refp22.max())
print("22. config-5 ingest pipeline (raw decode -> StreamingPFB -> power) OK")
