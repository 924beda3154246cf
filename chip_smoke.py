"""Run the STFT+FIR chain once on the GPU at its full size and check every
result against a plain float32 `jax.numpy` reference.

    python chip_smoke.py                 # one card: device, chain, stft_roundtrip
    python chip_smoke.py --four-cards    # four cards: the sharded paths only

Phases (each failure exits non-zero):

* device — JAX must find a GPU; prints its kind, the device count and
  `nvidia-smi`'s name and power limit.
* chain — `stft_fir_chain` on 768 channels x 10 s at 48 kHz (255-tap FIR,
  512-point Hann STFT, hop 128, one-sided power), with and without the
  filtered signal, and the FIR-folded matmul-DFT chain, against the
  reference; prints the step's `memory_analysis()`.
* stft_roundtrip — `stft` then `istft` on the same input; the interior of
  the round trip must match the input.
* four_cards (only with --four-cards) — the sharded chain, FIR, STFT and
  ISTFT on a four-card mesh against the single-device calls on card 0.

The last line of standard output is one JSON object naming the device.
"""

import argparse
import functools
import json
import subprocess
import sys

import jax
import jax.numpy as jnp

from nx_signal_tpu.models.pipeline import CHAIN_PRECISION, stft_fir_chain
from nx_signal_tpu.ops.filters import firwin
from nx_signal_tpu.ops.windows import hann
from nx_signal_tpu.utils.profiling import configure_compile_cache

CHANNELS, SECONDS, RATE = 768, 10, 48000
NUM_TAPS, CUTOFF = 255, 2000.0
FRAME, HOP, NFFT = 512, 128, 512
#: the repo's 1e-4 scipy gate, taken relative to the largest reference value
GATE = 1e-4
#: channels per reference call: bounds the reference's device memory
REF_CHUNK = 64
#: sharded paths that README.md and guides/sharding.md state are bitwise
#: equal to the single-device call on the H100
BITWISE_CLAIMS = {"convolve_same": True, "istft": True}


def device_info(min_devices=1):
    """Describe JAX's devices; exit unless they are at least `min_devices`
    GPUs. Prints nvidia-smi's name and power limit of each card."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found {devices[0].platform!r}")
    if len(devices) < min_devices:
        raise SystemExit(
            f"chip_smoke: needs {min_devices} GPUs, JAX found {len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"device: {devices[0].device_kind} x {len(devices)}")
    print(smi.strip())
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def make_signal(channels, length, seed):
    """(channels, length) float32 standard-normal signal made on the device."""
    return jax.random.normal(jax.random.PRNGKey(seed), (channels, length),
                             jnp.float32)


def chain_filters():
    """The chain's 255-tap 2 kHz low-pass at 48 kHz and its Hann window."""
    return (firwin(NUM_TAPS, [CUTOFF], sampling_rate=float(RATE)),
            hann(FRAME))


# ------------------------------------------------------------- reference

def reference_fir_same(x, taps):
    """'same'-mode FIR by FFT convolution, scipy's centre alignment."""
    n, k = x.shape[-1], taps.shape[-1]
    nfft = 1 << (n + k - 2).bit_length()
    full = jnp.fft.irfft(jnp.fft.rfft(x, nfft) * jnp.fft.rfft(taps, nfft),
                         nfft)
    start = (k - 1) // 2
    return full[..., start:start + n]


def reference_power(y, window, hop, n_fft):
    """One-sided power spectrogram of explicitly sliced, windowed frames."""
    frame = window.shape[-1]
    m = (y.shape[-1] - frame) // hop + 1
    idx = jnp.arange(m)[:, None] * hop + jnp.arange(frame)[None, :]
    z = jnp.fft.rfft(y[..., idx] * window, n=n_fft)
    return jnp.real(z) ** 2 + jnp.imag(z) ** 2


@functools.partial(jax.jit, static_argnames=("hop", "n_fft"))
def _reference_chain(x, taps, window, *, hop, n_fft):
    with jax.default_matmul_precision("highest"):
        y = reference_fir_same(x, taps)
        return {"filtered": y, "power": reference_power(y, window, hop, n_fft)}


@jax.jit
def _max_errors(got, ref):
    return jnp.max(jnp.abs(got - ref)), jnp.max(jnp.abs(ref))


def compare_to_reference(outputs, x, taps, window, *, hop, n_fft,
                         chunk=REF_CHUNK):
    """Largest |got - ref| and |ref| for each named output, the reference
    computed `chunk` channels at a time. `outputs` maps a name to
    (array, reference key: 'filtered' or 'power')."""
    diff = {name: 0.0 for name in outputs}
    peak = {name: 0.0 for name in outputs}
    for c0 in range(0, x.shape[0], chunk):
        ref = _reference_chain(x[c0:c0 + chunk], taps, window, hop=hop,
                               n_fft=n_fft)
        for name, (got, key) in outputs.items():
            d, p = _max_errors(got[c0:c0 + chunk], ref[key])
            diff[name] = max(diff[name], float(d))
            peak[name] = max(peak[name], float(p))
    return {name: diff[name] / peak[name] for name in outputs}


def _check_finite(name, arr, shape):
    if arr.shape != shape:
        raise AssertionError(f"{name}: shape {arr.shape}, expected {shape}")
    if not bool(jnp.all(jnp.isfinite(arr))):
        raise AssertionError(f"{name}: non-finite values")


# ------------------------------------------------------------- phases

def phase_chain(x, taps, window, *, hop=HOP, n_fft=NFFT,
                precision=CHAIN_PRECISION):
    """The chain through `stft_fir_chain` as a user calls it, power only
    and with the filtered signal, at `precision`; and the FIR-folded
    matmul-DFT chain (`fir_framed_dft`, the sharded chain's local program)
    at 'highest' and 'high'. Returns each output's error relative to the
    reference peak; fails when a result at `precision`, or the matmul
    chain at 'highest', misses the gate."""
    from nx_signal_tpu.kernels.dft import fir_framed_dft

    frame = window.shape[-1]
    num_frames = (x.shape[-1] - frame) // hop + 1
    p_shape = (*x.shape[:-1], num_frames, n_fft // 2 + 1)
    kwargs = dict(fft_length=n_fft, overlap_length=frame - hop,
                  sampling_rate=float(RATE), frame_chunks="auto")
    step = jax.jit(functools.partial(
        stft_fir_chain, taps=taps, window=window, return_filtered=False,
        precision=precision, **kwargs))
    compiled = step.lower(x).compile()
    print(f"chain memory_analysis: {compiled.memory_analysis()}")
    out = compiled(x)
    _check_finite("chain", out, p_shape)
    outputs = {"chain": (out, "power")}
    step_f = jax.jit(functools.partial(
        stft_fir_chain, taps=taps, window=window, return_filtered=True,
        precision=precision, **kwargs))
    y, pf = step_f(x)
    _check_finite("chain filtered", y, x.shape)
    _check_finite("chain power with filtered", pf, p_shape)
    outputs["chain filtered"] = (y, "filtered")
    outputs["chain power with filtered"] = (pf, "power")
    for p in ("highest", "high"):
        step_m = jax.jit(functools.partial(
            fir_framed_dft, taps=taps, window=window, stride=hop,
            n_fft=n_fft, onesided=True, output="power", precision=p,
            frame_chunks="auto"))
        out = step_m(x)
        _check_finite(f"matmul-DFT chain[{p}]", out, p_shape)
        outputs[f"matmul-DFT chain[{p}]"] = (out, "power")
    errors = compare_to_reference(outputs, x, taps, window, hop=hop,
                                  n_fft=n_fft)
    for name, err in errors.items():
        print(f"{name}: max|p - p_ref| / max|p_ref| = {err:.3e}")
    gated = ["chain", "chain filtered",
             "chain power with filtered", "matmul-DFT chain[highest]"]
    failed = [n for n in gated if not errors[n] <= GATE]
    if failed:
        raise AssertionError(f"chain outside the {GATE:g} gate: {failed}")
    return errors


def phase_stft_roundtrip(x, window, *, hop=HOP, n_fft=NFFT):
    """`stft` then `istft` (method='auto' both ways, one-sided); the
    interior, one frame in from each end, must match the input to the
    gate relative to max|x|. Returns that relative error."""
    from nx_signal_tpu.kernels.dft import good_matmul_fft_length
    from nx_signal_tpu.spectral import istft, stft

    frame = window.shape[-1]

    @jax.jit
    def roundtrip(x):
        z, _, _ = stft(x, window, sampling_rate=float(RATE), fft_length=n_fft,
                       overlap_length=frame - hop, onesided=True)
        return istft(z, window, fft_length=n_fft, overlap_length=frame - hop,
                     onesided=True)

    xr = roundtrip(x)
    _check_finite("roundtrip", xr, x.shape)
    d, p = _max_errors(xr[..., frame:-frame], x[..., frame:-frame])
    err = float(d) / float(p)
    dispatch = "matmul" if good_matmul_fft_length(n_fft) else "fft"
    print(f"stft_roundtrip ({dispatch} DFT): interior max|x_r - x| / "
          f"max|x| = {err:.3e}")
    if not err <= GATE:
        raise AssertionError(f"stft round trip outside the {GATE:g} gate")
    return err


def _compare_on(device, got, ref):
    """(bitwise, max|got - ref| / max|ref|) with both moved to `device`."""
    got = jax.device_put(got, device)
    ref = jax.device_put(ref, device)
    d, p = _max_errors(got, ref)
    return bool(jnp.array_equal(got, ref)), float(d) / float(p)


def _check_spread(name, arr, devices):
    """Fail unless `arr` has one shard on each of `devices`."""
    held = {s.device for s in arr.addressable_shards}
    if held != set(devices):
        raise AssertionError(
            f"{name}: shards on {sorted(d.id for d in held)}, expected "
            f"{sorted(d.id for d in devices)}")


def phase_four_cards(x, taps, window, devices, *, hop=HOP, n_fft=NFFT,
                     precision=CHAIN_PRECISION, claims=BITWISE_CLAIMS):
    """Sharded paths on a mesh over `devices` against single-device calls
    on devices[0]: the fused chain with len(devices) copies of x's channel
    count on the 'channel' axis; FIR, STFT and ISTFT of x split along the
    'block' axis. Returns {name: (bitwise, relative error)}; fails on a
    result outside the gate, a broken bitwise claim (`claims`: name ->
    expected bitwise), or a mesh that does not use every device."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nx_signal_tpu.kernels.dft import fir_framed_dft
    from nx_signal_tpu.ops.convolution import convolve
    from nx_signal_tpu.parallel.mesh import make_dsp_mesh
    from nx_signal_tpu.parallel.sharded import (
        sharded_convolve_same, sharded_fir_framed_dft_power, sharded_istft,
        sharded_stft)
    from nx_signal_tpu.spectral import istft, stft

    n = len(devices)
    card0 = devices[0]
    frame = window.shape[-1]
    ch = x.shape[0]
    results = {}

    # channels on the 'channel' axis: n stacked copies of x, each scaled
    # differently so no two cards hold the same data
    mesh_c = make_dsp_mesh(n, 1, devices=devices)
    scales = jnp.arange(1, n + 1, dtype=jnp.float32)
    wide = jax.jit(
        lambda x: (x[None] * scales[:, None, None]).reshape(n * ch, -1),
        out_shardings=NamedSharding(mesh_c, P("channel", "block")))(x)
    _check_spread("channel-sharded input", wide, devices)
    p_sh = jax.jit(functools.partial(
        sharded_fir_framed_dft_power, taps=taps, window=window, mesh=mesh_c,
        stride=hop, n_fft=n_fft, precision=precision))(wide)
    _check_spread("sharded_fir_framed_dft_power", p_sh, devices)
    single = jax.jit(functools.partial(
        fir_framed_dft, taps=taps, window=window, stride=hop, n_fft=n_fft,
        onesided=True, output="power", precision=precision))
    worst = (True, 0.0)
    for i in range(n):
        xi = jax.device_put(wide[i * ch:(i + 1) * ch], card0)
        bit, err = _compare_on(card0, p_sh[i * ch:(i + 1) * ch], single(xi))
        worst = (worst[0] and bit, max(worst[1], err))
    results["fir_framed_dft_power"] = worst
    del wide, p_sh

    # one stream split along the 'block' axis
    mesh_b = make_dsp_mesh(1, n, devices=devices)
    xb = jax.device_put(x, NamedSharding(mesh_b, P("channel", "block")))
    _check_spread("block-sharded input", xb, devices)
    x0 = jax.device_put(x, card0)
    y_sh = jax.jit(functools.partial(sharded_convolve_same, mesh=mesh_b))(
        xb, taps)
    _check_spread("sharded_convolve_same", y_sh, devices)
    y_1 = jax.jit(lambda x, t: convolve(x, t[None, :], mode="same"))(x0, taps)
    results["convolve_same"] = _compare_on(card0, y_sh, y_1)
    del y_sh, y_1

    stft_kw = dict(sampling_rate=float(RATE), fft_length=n_fft,
                   overlap_length=frame - hop, onesided=True)
    z_sh = jax.jit(lambda x: sharded_stft(x, window, mesh=mesh_b,
                                          **stft_kw).z)(xb)
    _check_spread("sharded_stft", z_sh, devices)
    z_1 = jax.jit(lambda x: stft(x, window, **stft_kw).z)(x0)
    results["stft"] = _compare_on(card0, z_sh, z_1)
    del z_sh

    # 'istft' takes the matmul inverse, the non-FFT path the bitwise
    # overlap-add claim is about; 'istft_fft' the FFT inverse 'auto' picks
    z_rep = jax.device_put(z_1, NamedSharding(mesh_b, P()))
    for name, method in (("istft", "matmul"), ("istft_fft", "auto")):
        istft_kw = dict(fft_length=n_fft, overlap_length=frame - hop,
                        onesided=True, method=method)
        r_sh = jax.jit(lambda z: sharded_istft(z, window, mesh=mesh_b,
                                               **istft_kw))(z_rep)
        _check_spread(f"sharded_istft[{method}]", r_sh, devices)
        r_1 = jax.jit(lambda z: istft(z, window, **istft_kw))(z_1)
        results[name] = _compare_on(card0, r_sh, r_1)
        del r_sh, r_1

    failed = []
    for name, (bit, err) in results.items():
        print(f"four_cards {name}: bitwise={bit} max|sharded - single| / "
              f"max|single| = {err:.3e}")
        if not err <= GATE:
            failed.append(f"{name} outside the {GATE:g} gate")
        if claims.get(name) and not bit:
            failed.append(f"{name} is claimed bitwise but is not")
    if failed:
        raise AssertionError("; ".join(failed))
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded paths on four cards")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    device = device_info(min_devices=4 if args.four_cards else 1)
    configure_compile_cache()
    taps, window = chain_filters()
    x = make_signal(CHANNELS, SECONDS * RATE, args.seed)
    if args.four_cards:
        devices = jax.devices()[:4]
        phase_four_cards(x, taps, window, devices)
        device["count"] = len(devices)
    else:
        phase_chain(x, taps, window)
        phase_stft_roundtrip(x, window)
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    sys.exit(main())
