"""Clock and timing recovery: Gardner TED + Farrow interpolator + PI loop/NCO.

Counterpart of reference ``optic/dsp/clockRecovery.py``. The NCO
loop is a true sequential recurrence with data-dependent pointer moves
(sample skip/stuff, clockRecovery.py:160-171); it runs as a ``lax.while_loop``
carrying the output buffer and loop-filter state, with masked scatter writes.
The drift estimator is a host-side analysis helper (scipy find_peaks).
"""

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from scipy.signal import find_peaks

__all__ = [
    "ClockRecoveryConfig",
    "FFWClockRecoveryConfig",
    "gardner_ted",
    "gardner_ted_nyquist",
    "interpolator",
    "gardner_clock_recovery",
    "ffw_clock_recovery",
    "calc_clock_drift",
]


@dataclass(frozen=True)
class ClockRecoveryConfig:
    """Gardner clock recovery parameters (clockRecovery.py:108-114 defaults)."""

    kp: float = 1e-3
    ki: float = 1e-6
    isNyquist: bool = True
    lpad: int = 1
    maxPPM: float = 500.0


def gardner_ted(x):
    """Gardner timing error on a 3-sample segment (clockRecovery.py:24)."""
    return jnp.real(jnp.conj(x[1]) * (x[2] - x[0]))


def gardner_ted_nyquist(x):
    """Modified Gardner TED for Nyquist pulses (clockRecovery.py:42)."""
    return jnp.abs(x[1]) ** 2 * (jnp.abs(x[0]) ** 2 - jnp.abs(x[2]) ** 2)


def interpolator(x, t):
    """Cubic Farrow interpolation over a 4-sample segment (clockRecovery.py:60)."""
    return (
        x[0] * (-1 / 6 * t**3 + 1 / 6 * t)
        + x[1] * (1 / 2 * t**3 + 1 / 2 * t**2 - t)
        + x[2] * (-1 / 2 * t**3 - t**2 + 1 / 2 * t + 1)
        + x[3] * (1 / 6 * t**3 + 1 / 2 * t**2 + 1 / 3 * t)
    )


@partial(jax.jit, static_argnames=("cfg", "n_out"))
def _gardner_one_mode(col, cfg: ClockRecoveryConfig, n_out):
    """NCO loop for one mode: lax.while_loop over output samples."""
    n_in = col.shape[0]

    def cond(state):
        n, m, _, _, _, _ = state
        return (n < n_out - 1) & (m < n_in - 2)

    def body(state):
        n, m, int_part, t_nco, eo, t_vals = state
        seg = jax.lax.dynamic_slice_in_dim(col, m - 2, 4)
        val = interpolator(seg, t_nco)
        eo = eo.at[n].set(val)

        def run_ted(args):
            int_part, t_nco, eo = args
            seg3 = jax.lax.dynamic_slice_in_dim(eo, n - 2, 3)
            if cfg.isNyquist:
                ted = gardner_ted_nyquist(seg3)
            else:
                ted = gardner_ted(seg3)
            int_part = cfg.ki * ted + int_part
            t_nco = t_nco - (cfg.kp * ted + int_part)
            return int_part, t_nco

        int_part, t_nco = jax.lax.cond(
            n % 2 == 0,
            run_ted,
            lambda args: (args[0], args[1]),
            (int_part, t_nco, eo),
        )

        # NCO clock gap: skip/stuff samples (clockRecovery.py:160-171)
        over = t_nco > 1
        under = t_nco < -1
        t_nco = jnp.where(over, t_nco - 1, jnp.where(under, t_nco + 1, t_nco))
        dn = jnp.where(over, -1, jnp.where(under, 2, 1))
        dm = jnp.where(over, 0, 1)
        n = n + dn
        m = m + dm
        t_vals = t_vals.at[jnp.clip(n, 0, n_out - 1)].set(t_nco)
        return n, m, int_part, t_nco, eo, t_vals

    eo0 = jnp.zeros(n_out, dtype=jnp.complex64)
    tv0 = jnp.zeros(n_out, dtype=jnp.float32)
    n, m, _, _, eo, t_vals = jax.lax.while_loop(
        cond, body, (2, 2, 0.0, 0.0, eo0, tv0)
    )
    return eo, t_vals, n


def gardner_clock_recovery(sig, config: ClockRecoveryConfig = ClockRecoveryConfig(),
                           return_timing=False, static_out=False):
    """Gardner clock recovery with PI loop filter and NCO (clockRecovery.py:85).

    Input is expected at 2 samples/symbol; output is retimed at 2
    samples/symbol. Returns the recovered signal (and the NCO timing values if
    ``return_timing``).

    ``static_out=True`` keeps the output length STATIC at
    ``n_out = (1 - maxPPM/1e6) * n_in`` instead of truncating to the
    realized sample count (which forces a host sync and makes the function
    untraceable under an outer ``jit``). Use it to compose clock recovery
    into one-jit chains: for any true offset ``|ppm| < maxPPM - margin``
    the NCO produces ~``(1 - ppm/1e6) * n_in > n_out`` samples, so the
    fixed-length output is fully valid; only if the input runs dry early
    is the tail zero-filled.
    """
    sig = jnp.asarray(sig)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[:, None]
    sig = jnp.pad(sig, ((0, config.lpad), (0, 0)))
    n_in = sig.shape[0]
    n_out = int((1 - config.maxPPM / 1e6) * n_in)

    outs, t_vals, n_fin = [], [], []
    for k in range(sig.shape[1]):
        eo, tv, n = _gardner_one_mode(sig[:, k], config, n_out)
        outs.append(eo)
        t_vals.append(tv)
        n_fin.append(n)
    eo = jnp.stack(outs, axis=1)
    tv = jnp.stack(t_vals, axis=1)
    if not static_out:
        last_n = max(int(n) for n in n_fin)  # host sync: data-dependent crop
        eo, tv = eo[:last_n], tv[:last_n]
    if squeeze:
        eo = eo[:, 0]
        tv = tv[:, 0]
    return (eo, tv) if return_timing else eo


@dataclass(frozen=True)
class FFWClockRecoveryConfig:
    """Feedforward (block-parallel) clock recovery parameters.

    Block-parallel alternative to the Gardner PI/NCO loop: the sequential
    recurrence is replaced by a per-block spectral-line timing estimator
    plus a fully parallel cubic resampler, so the whole stage is dense
    XLA ops (batched FFTs, reductions, slices) with no per-sample
    dependence. Functional counterpart of reference
    ``optic/dsp/clockRecovery.py:85`` for the constant/slowly-varying
    clock-offset case (the dominant ADC impairment model,
    ``core.py:272`` ``clockSamplingInterp``).
    """

    # samples per timing-estimation block. The mod-1-symbol unwrap of the
    # per-block estimates limits the trackable clock offset to
    # |ppm| < 0.5 * sps / blockLen * 1e6 (488 ppm at the default);
    # shorten the block for larger offsets (noisier per-block estimates,
    # compensated by the fit), lengthen it for low-SNR small offsets.
    blockLen: int = 2048
    maxPPM: float = 500.0  # static output-length contract, as Gardner
    rollOff: float = 0.1  # pulse excess bandwidth (sets the spectral window)
    fit: str = "linear"  # 'linear' (constant clock offset) | 'pwl' (tracking)
    sps: int = 2  # samples/symbol of the input


def _ffw_timing_estimate(x, L, W, sps=2):
    """Per-block Godard/O&M timing phase at ``sps`` samples/symbol.

    Computes ``A_b = sum_k X_b[k] conj(X_b[k - L/sps])`` over a window
    of bins around ``k = L/(2*sps)`` — the POSITIVE-frequency band-edge
    overlap only. (At 2 SpS summing the full spectrum gives the DFT of
    ``|x|^2`` at Nyquist, which is real-valued: the symbol-rate tone
    sits exactly at Nyquist and its phase is unobservable — the classic
    degeneracy. The single-sided sum keeps the analytic part, whose
    phase is ``-2*pi*tau/T``, at any oversampling.)

    Returns the unwrapped per-block timing ``tau`` (symbols) and the
    estimator magnitudes ``|A_b|`` (fit weights).
    """
    nb = x.shape[0] // L
    xb = x[: nb * L].reshape(nb, L, -1)
    X = jnp.fft.fft(xb, axis=1)
    # symbol rate = fs/sps -> L/sps bins; band-edge overlap around Rs/2
    Xs = jnp.roll(X, L // sps, axis=1)
    c = L // (2 * sps)
    sl = slice(c - W, c + W)
    A = jnp.sum(X[:, sl] * jnp.conj(Xs[:, sl]), axis=(1, 2))
    eps = -jnp.angle(A) / (2 * jnp.pi)  # symbols, in [-0.5, 0.5)
    d = eps[1:] - eps[:-1]
    d = (d + 0.5) % 1.0 - 0.5  # unwrap mod one symbol
    tau = jnp.concatenate([eps[:1], eps[0] + jnp.cumsum(d)])
    return tau, jnp.abs(A)


def _resample_cubic_blocks(x, off, block=2048):
    """Evaluate ``y[i] = x(i + off[i])`` by block-parallel cubic interp.

    ``off`` is the (small, slowly varying) timing offset in samples —
    passing the offset rather than the absolute position ``i + off[i]``
    keeps f32 timing resolution independent of the signal length (at
    N=2^20 an absolute f32 position quantizes to 1/16 sample; the offset
    stays exact to ~1e-5). Blocks of ``block`` outputs share one
    dynamically-offset CONTIGUOUS input window (long contiguous rows, not
    per-sample gathers); within a block the 4-tap
    cubic is a sum over ~12 statically shifted slices weighted by
    per-sample coefficient planes, so there are no per-sample gathers.
    """
    n_in, modes = x.shape
    n_out = off.shape[0]
    nb = -(-n_out // block)
    n_pad = nb * block - n_out
    off = jnp.concatenate([off, jnp.full((n_pad,), off[-1], off.dtype)])
    off_fl = jnp.floor(off)
    i_out = jnp.arange(nb * block, dtype=jnp.int32)
    base = jnp.clip(i_out + off_fl.astype(jnp.int32), 1, n_in - 3)
    frac = (off - off_fl).astype(jnp.float32)

    S_LO, S_RANGE = 4, 10  # shift slack: |slope-1|*block <= ~2 plus margins
    lw = block + S_RANGE + 4
    xpad = jnp.pad(x, ((S_LO + 2, S_RANGE + 8), (0, 0)))
    starts = base[::block] - 1 - S_LO  # tap0 of each block's first output
    win = jax.vmap(
        lambda s: jax.lax.dynamic_slice_in_dim(xpad, s + S_LO + 2, lw)
    )(starts)  # (nb, lw, modes) — contiguous-row gather

    j = jnp.arange(block)
    base_b = base.reshape(nb, block)
    frac_b = frac.reshape(nb, block)
    # tap0 (= base-1) position inside the window, minus the output index
    s = base_b - 1 - starts[:, None] - j[None, :]  # in [0, S_RANGE)
    f = frac_b
    # Lagrange cubic on nodes {-1,0,1,2} evaluated at f in [0,1)
    c = (
        -f * (f - 1) * (f - 2) / 6,
        (f + 1) * (f - 1) * (f - 2) / 2,
        -f * (f + 1) * (f - 2) / 2,
        f * (f + 1) * (f - 1) / 6,
    )
    out = jnp.zeros((nb, block, modes), dtype=x.dtype)
    for u in range(S_RANGE + 3):
        coef = jnp.zeros_like(f)
        for tap in range(4):
            coef = coef + jnp.where(s == u - tap, c[tap], 0.0)
        out = out + coef[..., None] * jax.lax.dynamic_slice_in_dim(
            win, u, block, axis=1
        )
    return out.reshape(nb * block, modes)[:n_out]


def ffw_clock_recovery(sig, config: FFWClockRecoveryConfig = FFWClockRecoveryConfig(),
                       return_est=False):
    """Feedforward block-parallel clock recovery (no recurrence).

    Pipeline (one jit, static shapes): per-block band-edge spectral-line
    timing estimates (joint over modes — one ADC clock), mod-1-symbol
    unwrap, |A|-weighted linear fit (``fit='linear'``) or smoothed
    piecewise-linear interpolation (``fit='pwl'``) of the timing
    trajectory, then block-parallel cubic resampling of all modes on the
    corrected grid. Output length is STATIC at
    ``(1 - maxPPM/1e6) * n_in`` (same contract as
    ``gardner_clock_recovery(static_out=True)``), so it composes into
    one-jit chains; the T/2 equalizer absorbs the residual phase.

    Behavioral counterpart of reference ``clockRecovery.py:85`` for
    constant or slowly varying sampling-clock offsets; unlike the
    Gardner NCO it has no feedback loop, so throughput is that of a few
    dense passes over the signal (~2 orders above the sequential loop).

    Returns the retimed signal, plus ``(ppm_est, tau_blocks)`` if
    ``return_est``.
    """
    cfg = config
    sig = jnp.asarray(sig)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[:, None]
    n_in = sig.shape[0]
    L = cfg.blockLen
    sps = cfg.sps
    if n_in < 2 * L:
        raise ValueError(f"need >= {2 * L} samples for {L}-sample blocks")
    W = max(8, int(cfg.rollOff * L / (2 * sps)) + 32)
    W = min(W, L // (2 * sps))  # window must stay in the positive band
    tau, w = _ffw_timing_estimate(sig, L, W, sps)
    nb = tau.shape[0]

    # |A|-weighted least squares tau ~ a + b*block (timing drifts
    # ppm*1e-6*L/sps symbols per block for a ppm clock offset)
    idx = jnp.arange(nb, dtype=jnp.float32)
    sw = jnp.sum(w)
    sx = jnp.sum(w * idx)
    sy = jnp.sum(w * tau)
    sxx = jnp.sum(w * idx * idx)
    sxy = jnp.sum(w * idx * tau)
    slope = (sw * sxy - sx * sy) / (sw * sxx - sx * sx)
    max_slope = cfg.maxPPM * 1e-6 * L / sps
    slope = jnp.clip(slope, -max_slope, max_slope)
    intercept = (sy - slope * sx) / sw
    delta = slope * sps / L  # fractional clock offset (samples/sample)
    ppm_est = delta * 1e6

    n_out = int((1 - cfg.maxPPM / 1e6) * n_in)
    i = jnp.arange(n_out, dtype=jnp.float32)
    if cfg.fit == "linear":
        # tau_b is measured over block b centered at (b + 1/2)*L, so the
        # intercept refers to the block-0 CENTER: offset at sample i is
        # sps*(intercept + slope*(i - L/2)/L). Wrap the constant part to
        # +-1 sample (half symbol) so the stage never introduces an
        # integer-symbol slip against an upstream symbol_sync reference.
        phi = intercept * sps - delta * (L / 2)
        phi = (phi + sps / 2) % sps - sps / 2
        off = i * delta + phi
    elif cfg.fit == "pwl":
        # smooth the per-block timing with a short triangular kernel,
        # then piecewise-linear interpolate between block centers —
        # tracks slowly varying (e.g. thermal) clock drift the single
        # global line cannot.
        kern = jnp.asarray([1.0, 2.0, 3.0, 2.0, 1.0]) / 9.0
        tau_s = jnp.convolve(jnp.pad(tau, (2, 2), mode="edge"), kern,
                             mode="valid")
        phi0 = tau_s[0] * sps
        phi0_w = (phi0 + sps / 2) % sps - sps / 2
        tau_s = tau_s - tau_s[0]
        pos = (i - L / 2) / L  # sample i in units of block index
        k = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, nb - 2)
        fr = jnp.clip(pos - k, 0.0, None)  # extrapolate linearly at ends
        tau_i = tau_s[k] * (1 - fr) + tau_s[k + 1] * fr
        off = sps * tau_i + phi0_w
    else:
        raise ValueError(f"unknown fit mode {cfg.fit!r}")
    y = _resample_cubic_blocks(sig, off)
    if squeeze:
        y = y[:, 0]
    return (y, (ppm_est, tau)) if return_est else y


def calc_clock_drift(t_nco_values):
    """Clock drift estimate in ppm from NCO timing values (clockRecovery.py:194).

    Host-side analysis (find_peaks on the wrap events of the timing error).
    """
    t = np.asarray(t_nco_values)
    if t.ndim == 1:
        t = t[:, None]
    timing_err = t - np.mean(t, axis=0, keepdims=True)
    ppm = np.zeros(t.shape[1])
    for k in range(t.shape[1]):
        peaks, _ = find_peaks(np.abs(np.diff(timing_err[:, k])), height=0.5)
        if len(peaks) < 2:
            ppm[k] = 0.0
            continue
        mean_period = np.mean(np.diff(peaks))
        ppm[k] = np.sign(np.mean(t[:, k])) * (1 / mean_period) * 1e6
    return ppm
