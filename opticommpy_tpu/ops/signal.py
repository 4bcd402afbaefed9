"""Signal conditioning primitives: power/normalization, resampling, sync.

Counterparts of reference ``optic/dsp/core.py`` functions (cited
per-function below). Everything is vectorized across modes (no per-mode Python
loops) and jit-friendly (static shapes, data-dependent *values* only).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from opticommpy_tpu.ops.filtering import fir_filter, lowpass_fir

__all__ = [
    "sig_pow",
    "signal_power",
    "pnorm",
    "anorm",
    "upsample",
    "quantizer",
    "clock_sampling_interp",
    "decimate",
    "resample",
    "finddelay",
    "symbol_sync",
    "moving_average",
    "delay_signal",
    "iq_mixing",
    "freq_shift",
]


def sig_pow(x):
    """Average power ``mean(|x|^2)`` over all elements (core.py:50)."""
    x = jnp.asarray(x)
    return jnp.mean(jnp.abs(x) ** 2)


def signal_power(x):
    """Total power: sum over modes of the per-mode average power (core.py:69)."""
    x = jnp.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    return jnp.sum(jnp.mean((x * jnp.conj(x)).real, axis=0))


def pnorm(x):
    """Normalize ``x`` to unit average power (global mean, core.py:701)."""
    x = jnp.asarray(x)
    return x / jnp.sqrt(jnp.mean((x * jnp.conj(x)).real))


def anorm(x):
    """Normalize ``x`` to unit peak amplitude (core.py:720)."""
    x = jnp.asarray(x)
    return x / jnp.max(jnp.abs(x))


def upsample(x, factor):
    """Insert ``factor-1`` zeros between samples along axis 0 (core.py:395)."""
    x = jnp.asarray(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    n, m = x.shape
    up = jnp.zeros((n, factor, m), dtype=x.dtype).at[:, 0, :].set(x)
    up = up.reshape(n * factor, m)
    return up[:, 0] if squeeze else up


@partial(jax.jit, static_argnames=("n_bits",))
def quantizer(x, n_bits=16, max_v=1.0, min_v=-1.0):
    """Uniform quantizer with 2**n_bits levels spanning [min_v, max_v].

    Same decision levels as the reference (core.py:317) but O(1)/sample
    (round-to-nearest on the uniform grid) instead of an argmin over all
    levels.
    """
    x = jnp.asarray(x)
    delta = (max_v - min_v) / (2**n_bits - 1)
    idx = jnp.clip(jnp.round((x - min_v) / delta), 0, 2**n_bits - 1)
    return (min_v + idx * delta).astype(jnp.float32)


def _interp_columns(t_out, t_in, x):
    """jnp.interp vmapped over columns of x."""
    return jax.vmap(lambda col: jnp.interp(t_out, t_in, col), in_axes=1, out_axes=1)(x)


def clock_sampling_interp(x, in_fs, out_fs, jitter_rms=0.0, key=None):
    """Linear-interpolation resampling to a new clock (core.py:272).

    Optional sampling-clock jitter is drawn from the explicit ``key``
    (the reference mutates numpy's global RNG).
    """
    x = jnp.asarray(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    n = x.shape[0]
    in_ts = 1.0 / in_fs
    out_ts = 1.0 / out_fs
    n_out = int(np.ceil(n * in_ts / out_ts - 1e-12))
    t_in = jnp.arange(n) * in_ts
    t_out = jnp.arange(n_out) * out_ts
    if jitter_rms > 0:
        if key is None:
            raise ValueError("jitter requested but no PRNG key provided")
        t_out = t_out + jitter_rms * jax.random.normal(key, (n_out,))
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        y = _interp_columns(t_out, t_in, x.real) + 1j * _interp_columns(
            t_out, t_in, x.imag
        )
        y = y.astype(x.dtype)
    else:
        y = _interp_columns(t_out, t_in, x).astype(x.dtype)
    return y[:, 0] if squeeze else y


@partial(jax.jit, static_argnames=("sps_in", "sps_out"))
def decimate(x, sps_in, sps_out=1):
    """Decimate with max-variance sampling-phase selection (core.py:435).

    For each mode, picks the sampling phase with maximum variance (a crude
    timing recovery), rolls the signal there, then downsamples. The
    data-dependent phase pick is a dynamic roll under jit.
    """
    x = jnp.asarray(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    dec = sps_in // sps_out
    n, m = x.shape
    n_sym = n // sps_in
    phase_var = jnp.var(
        x[: n_sym * sps_in].reshape(n_sym, sps_in, m), axis=0
    )  # (sps_in, m); complex var -> use abs deviation like np.var on complex
    # np.var on complex returns mean |x - mean|^2 which jnp.var also does.
    delays = jnp.argmax(phase_var.real, axis=0)  # (m,)

    def roll_col(col, d):
        return jnp.roll(col, -d)

    rolled = jax.vmap(roll_col, in_axes=(1, 0), out_axes=1)(x, delays)
    y = rolled[::dec, :]
    return y[:, 0] if squeeze else y


def resample(x, in_fs, out_fs, n_taps=501):
    """Rational/arbitrary resampling with anti-aliasing FIRs (core.py:494)."""
    x = jnp.asarray(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    if out_fs < in_fs:
        n_ = min(x.shape[0], n_taps)
        hi = jnp.asarray(lowpass_fir(out_fs / 2, in_fs, n_))
        x = fir_filter(hi, x)
    y = clock_sampling_interp(x, in_fs, out_fs)
    if out_fs > in_fs:
        n_ = min(y.shape[0], n_taps)
        ho = jnp.asarray(lowpass_fir(in_fs / 2, out_fs, n_))
        y = fir_filter(ho, y)
    return y[:, 0] if squeeze else y


def _xcorr_full(a, v):
    """np.correlate(a, v, mode='full') via FFT: length len(a)+len(v)-1."""
    n, m = a.shape[0], v.shape[0]
    nfft = 1 << int(np.ceil(np.log2(n + m - 1)))
    A = jnp.fft.fft(a, n=nfft)
    V = jnp.fft.fft(jnp.conj(v[::-1]), n=nfft)
    c = jnp.fft.ifft(A * V)[: n + m - 1]
    if not (
        jnp.issubdtype(a.dtype, jnp.complexfloating)
        or jnp.issubdtype(v.dtype, jnp.complexfloating)
    ):
        c = c.real
    return c


def finddelay(x, y):
    """Delay between x and y via FFT cross-correlation argmax (core.py:678)."""
    xcorr = jnp.abs(_xcorr_full(jnp.asarray(x), jnp.asarray(y)))
    return jnp.argmax(xcorr) - x.shape[0] + 1


def symbol_sync(rx, tx, sps, mode="amp"):
    """Align the transmitted sequence to the received one (core.py:552).

    Decimates ``rx`` to 1 SpS, resolves mode swaps via the cross-correlation
    matrix of centered amplitudes ('amp' mode) or real parts with pi/2-rotation
    and conjugation resolution ('real' mode), then rolls out the per-mode
    delays. Returns the synchronized transmit sequence.
    """
    rx = jnp.asarray(rx)
    tx = jnp.asarray(tx)
    squeeze = rx.ndim == 1
    if squeeze:
        rx = rx[:, None]
    if tx.ndim == 1:
        tx = tx[:, None]
    n_modes = rx.shape[1]

    if sps > 1:
        rx = decimate(rx, sps, 1)

    def centered_abs(z):
        a = jnp.abs(z)
        return a - jnp.mean(a, axis=0, keepdims=True)

    if mode == "amp":
        atx = centered_abs(tx)
        arx = centered_abs(rx)

        def corr_peak(m, n):
            return jnp.max(jnp.abs(_xcorr_full(atx[:, m], arx[:, n])))

        corr = jnp.stack(
            [
                jnp.stack([corr_peak(m, n) for n in range(n_modes)])
                for m in range(n_modes)
            ]
        )  # (m, n)
        swap = jnp.argmax(corr, axis=0)
        tx = tx[:, swap]
        atx = centered_abs(tx)
        delays = jnp.stack(
            [
                jnp.argmax(jnp.abs(_xcorr_full(atx[:, k], arx[:, k])))
                - tx.shape[0]
                + 1
                for k in range(n_modes)
            ]
        )
    elif mode == "real":
        peaks = jnp.zeros((n_modes, n_modes))
        rots = jnp.ones((n_modes, n_modes), dtype=jnp.complex64)
        for m in range(n_modes):
            for n in range(n_modes):
                crr = _xcorr_full(tx[:, m].real, rx[:, n].real)
                cir = _xcorr_full(tx[:, m].imag, rx[:, n].real)
                crr_peak = crr[jnp.argmax(jnp.abs(crr))]
                cir_peak = cir[jnp.argmax(jnp.abs(cir))]
                use_rr = jnp.abs(crr_peak) > jnp.abs(cir_peak)
                rot = jnp.where(
                    use_rr,
                    jnp.where(crr_peak > 0, 1.0 + 0j, -1.0 + 0j),
                    jnp.where(cir_peak > 0, -1j, 1j),
                )
                peaks = peaks.at[m, n].set(
                    jnp.maximum(jnp.abs(crr_peak), jnp.abs(cir_peak))
                )
                rots = rots.at[m, n].set(rot)
        swap = jnp.argmax(peaks, axis=0)
        tx = tx[:, swap]
        rot_diag = rots[swap, jnp.arange(n_modes)]
        tx = tx * rot_diag[None, :]
        delays = []
        cols = []
        for k in range(n_modes):
            col = tx[:, k]
            delays.append(
                jnp.argmax(jnp.abs(_xcorr_full(col.real, rx[:, k].real)))
                - tx.shape[0]
                + 1
            )
            cii = _xcorr_full(col.imag, rx[:, k].imag)
            cii_peak = cii[jnp.argmax(jnp.abs(cii))]
            cols.append(jnp.where(cii_peak < 0, jnp.conj(col), col))
        tx = jnp.stack(cols, axis=1)
        delays = jnp.stack(delays)
    else:
        raise ValueError("mode must be 'amp' or 'real'")

    tx = jax.vmap(lambda col, d: jnp.roll(col, -d), in_axes=(1, 0), out_axes=1)(
        tx, delays
    )
    return tx[:, 0] if squeeze else tx


def moving_average(x, window):
    """Sliding-window moving average with edge zero-padding (core.py:829)."""
    x = jnp.asarray(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    pad = window // 2
    xp = jnp.pad(x, ((pad, pad), (0, 0)))
    c = jnp.cumsum(xp, axis=0)
    c = jnp.concatenate([jnp.zeros((1, x.shape[1]), dtype=c.dtype), c], axis=0)
    means = (c[window:] - c[:-window]) / window  # 'valid' windows over padded
    y = means[: x.shape[0]].astype(x.dtype)
    return y[:, 0] if squeeze else y


def delay_signal(sig, delay, fs=1.0, nfft=None):
    """Apply a (possibly fractional) time delay via an FFT phase ramp.

    Parity with reference delaySignal (core.py:880): the signal is zero-padded
    by ceil(|delay*fs|) to avoid circular wrap, delayed with
    ``exp(-j*2*pi*f*delay)`` over the full padded FFT, and cropped back. The
    reference routes this through a length-NFFT/2 frequency-sampled filter +
    overlap-save; the direct full-FFT ramp is its exact limit and maps to one
    batched XLA FFT.
    """
    sig = jnp.asarray(sig)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[:, None]
    n = sig.shape[0]
    pad_len = int(np.ceil(abs(delay * fs))) + 1
    real_in = not jnp.issubdtype(sig.dtype, jnp.complexfloating)
    xp = jnp.pad(sig, ((0, pad_len), (0, 0)))
    freq = jnp.fft.fftfreq(xp.shape[0], d=1.0 / fs)
    ramp = jnp.exp(-1j * 2 * jnp.pi * freq * delay)
    y = jnp.fft.ifft(jnp.fft.fft(xp, axis=0) * ramp[:, None], axis=0)[:n]
    if real_in:
        y = y.real
    y = y.astype(sig.dtype)
    return y[:, 0] if squeeze else y


def iq_mixing(sig, fs, amp_imb_db=0.0, phase_imb=0.0, time_skew=0.0):
    """Apply IQ amplitude/phase imbalance and IQ time skew (core.py:925)."""
    sig = jnp.asarray(sig)
    eps = 10 ** (amp_imb_db / 20) - 1
    k1 = (1 - eps) * jnp.exp(1j * phase_imb / 2) / 2 + (1 + eps) * jnp.exp(
        -1j * phase_imb / 2
    ) / 2
    k2 = (1 - eps) * jnp.exp(-1j * phase_imb / 2) / 2 - (1 + eps) * jnp.exp(
        1j * phase_imb / 2
    ) / 2
    mixed = k1 * sig + k2 * jnp.conj(sig)
    if time_skew == 0.0:
        return mixed
    delay = time_skew / 2
    s_i = delay_signal(mixed.real, -delay, fs)
    s_q = delay_signal(mixed.imag, delay, fs)
    return s_i + 1j * s_q


def freq_shift(x, delta_f, fs):
    """Shift the signal spectrum by ``delta_f`` Hz (core.py:1049)."""
    x = jnp.asarray(x)
    t = jnp.arange(x.shape[0]) / fs
    ph = jnp.exp(1j * 2 * jnp.pi * delta_f * t).astype(jnp.complex64)
    if x.ndim > 1:
        ph = ph[:, None]
    return x * ph
