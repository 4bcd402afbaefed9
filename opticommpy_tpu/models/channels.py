"""Fiber channel models: linear fiber, scalar SSFM, Manakov SSFM, AWGN.

Counterpart of reference ``optic/models/channels.py`` (and its GPU twin
``modelsGPU.py``, whose SSFM runs on cuFFT). The split-step loops are the
hottest code in the framework; they are structured for XLA:

- both polarizations and all batched signals (WDM channels / power sweeps /
  Monte-Carlo seeds) are stacked on leading axes of a single (2, B, N) field
  tensor, so every FFT is one batched XLA FFT over the time (lane) axis —
  replacing the reference's per-array numpy/cupy FFTs,
- spans run under ``lax.scan``; the z-stepping inside a span is a
  ``lax.while_loop`` (supports the reference's adaptive step-size rule,
  channels.py:392-397, with data-dependent trip count), and the trapezoidal
  nonlinear iteration (channels.py:413-436) is an inner ``lax.while_loop``
  with the same convergence criterion,
- ASE injection uses per-span PRNG keys derived with ``fold_in`` (the GPU
  reference advances its seed per span, modelsGPU.py:259-260).

The batched-leading-axis layout is exactly what ``vmap``/``shard_map`` need to
scale WDM sweeps across devices (see opticommpy_tpu.parallel).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import scipy.constants as sconst

from opticommpy_tpu.models.config import AWGNConfig, EDFAConfig, LinearFiberConfig, SSFMConfig
from opticommpy_tpu.models.devices import edfa
from opticommpy_tpu.ops.noise import gaussian_complex_noise, gaussian_noise
from opticommpy_tpu.ops.signal import sig_pow

_fft = partial(jnp.fft.fft, axis=-1)
_ifft = partial(jnp.fft.ifft, axis=-1)

__all__ = [
    "linear_fiber_channel",
    "ssfm",
    "manakov_ssf",
    "nlin_phase_rot",
    "convergence_condition",
    "awgn",
    "fiber_coefficients",
]


def fiber_coefficients(alpha_db_km, D_ps_nm_km, fc_hz):
    """(alpha [1/km], beta2 [ps^2/km]) from engineering units (channels.py:78-82)."""
    c_kms = sconst.c / 1e3
    lam = c_kms / fc_hz
    alpha = alpha_db_km / (10 * np.log10(np.e))
    beta2 = -(D_ps_nm_km * lam**2) / (2 * np.pi * c_kms)
    return alpha, beta2


def _solver_cdtype(cfg):
    """Complex dtype for the SSFM solvers (cfg.prec: 'c64' | 'c128')."""
    if cfg.prec == "c128":
        if not jax.config.jax_enable_x64:
            raise ValueError(
                "prec='c128' requires x64 mode (jax.config.update("
                "'jax_enable_x64', True) before tracing)"
            )
        return jnp.complex128
    if cfg.prec != "c64":
        raise ValueError(f"prec must be 'c64' or 'c128', got {cfg.prec!r}")
    return jnp.complex64


def linear_fiber_channel(e_in, config: LinearFiberConfig):
    """Linear fiber: one-shot frequency-domain loss + chromatic dispersion.

    Parity with reference channels.py:30: ``H(w) = exp(-a/2*L + j*b2/2*w^2*L)``.
    """
    if config.Fs is None:
        raise ValueError("Simulation sampling frequency (Fs) not provided.")
    e_in = jnp.asarray(e_in)
    squeeze = e_in.ndim == 1
    if squeeze:
        e_in = e_in[:, None]
    alpha, beta2 = fiber_coefficients(config.alpha, config.D, config.Fc)
    n = e_in.shape[0]
    w = 2 * jnp.pi * config.Fs * jnp.fft.fftfreq(n)
    H = jnp.exp(
        (-alpha / 2) * config.L + 1j * (beta2 / 2) * (w**2) * config.L
    ).astype(jnp.complex64)
    out = jnp.fft.ifft(jnp.fft.fft(e_in, axis=0) * H[:, None], axis=0)
    return out[:, 0] if squeeze else out


def nlin_phase_rot(ex, ey, pch, gamma_):
    """Manakov nonlinear phase rotation per km (reference channels.py:471).

    Trapezoidal form: 8/9*gamma*(P_start + |Ex|^2 + |Ey|^2)/2.
    """
    return ((8 / 9) * gamma_ * (pch + jnp.abs(ex) ** 2 + jnp.abs(ey) ** 2) / 2).real


def convergence_condition(e_fd, e_conv):
    """Normalized RMS change between trapezoidal iterations (channels.py:496)."""
    num = jnp.sum(jnp.abs(e_fd - e_conv) ** 2)
    den = jnp.sum(jnp.abs(e_conv) ** 2)
    return jnp.sqrt(num) / jnp.sqrt(den)


# ---------------------------------------------------------------------------
# Scalar NLSE SSFM (single polarization), fixed step
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("config",))
def ssfm(e_in, config: SSFMConfig, key=None):
    """Symmetric split-step Fourier for the scalar NLSE (channels.py:112).

    Fixed step size ``hz``; ``Nspans = floor(Ltotal/Lspan)`` spans of
    ``Nsteps = floor(Lspan/hz)`` steps, with per-span EDFA/ideal/no
    amplification. Accepts (N,) or (N, B) input (each column propagates
    independently — mode batching as in the GPU reference's parallel-power
    trick, modelsGPU.py:775).
    """
    if config.Fs is None:
        raise ValueError("Simulation sampling frequency (Fs) not provided.")
    cdtype = _solver_cdtype(config)
    e_in = jnp.asarray(e_in, dtype=cdtype)
    squeeze = e_in.ndim == 1
    if squeeze:
        e_in = e_in[:, None]
    e = e_in.T  # (B, N): batch leading, time on lanes
    n = e.shape[-1]

    alpha, beta2 = fiber_coefficients(config.alpha, config.D, config.Fc)
    gamma_ = config.gamma
    hz = config.hz
    n_spans = int(np.floor(config.Ltotal / config.Lspan))
    n_steps = int(np.floor(config.Lspan / hz))

    w = 2 * jnp.pi * config.Fs * jnp.fft.fftfreq(n)
    lin_arg = (-(alpha / 2) + 1j * (beta2 / 2) * w**2).astype(cdtype)
    lin_half = jnp.exp(lin_arg * (hz / 2))

    amp_cfg = EDFAConfig(G=config.alpha * config.Lspan, NF=config.NF,
                         Fc=config.Fc, Fs=config.Fs)
    if key is None:
        key = jax.random.PRNGKey(0)

    if config.fusedLinear:
        # merged half-steps (see _manakov_span): one fft+ifft pair per step,
        # field carried in the frequency domain
        lin_full = jnp.exp(lin_arg * hz)

        def fstep(_, ef):
            et = _ifft(ef)
            et = et * jnp.exp(1j * gamma_ * (et * jnp.conj(et)) * hz)
            return _fft(et) * lin_full

        def span_steps(e):
            ef = _fft(e) * lin_half
            ef = jax.lax.fori_loop(0, n_steps - 1, fstep, ef)
            et = _ifft(ef)
            et = et * jnp.exp(1j * gamma_ * (et * jnp.conj(et)) * hz)
            return _ifft(_fft(et) * lin_half)
    else:
        def step(_, ef):
            # ef: frequency-domain field (B, N)
            ef = ef * lin_half
            et = _ifft(ef)
            et = et * jnp.exp(1j * gamma_ * (et * jnp.conj(et)) * hz)
            return _fft(et) * lin_half

        def span_steps(e):
            ef = _fft(e)
            ef = jax.lax.fori_loop(0, n_steps, step, ef)
            return jnp.fft.ifft(ef, axis=-1)

    def span(e, span_idx):
        e = span_steps(e)
        if config.amp == "edfa":
            e = edfa(e, amp_cfg, jax.random.fold_in(key, span_idx))
        elif config.amp == "ideal":
            e = e * float(np.exp(alpha / 2 * n_steps * hz))  # weak: no x64 promotion
        return e, None

    e, _ = jax.lax.scan(span, e, jnp.arange(n_spans))
    out = e.T
    return out[:, 0] if squeeze else out


# ---------------------------------------------------------------------------
# Manakov SSFM (dual polarization), adaptive or fixed step
# ---------------------------------------------------------------------------


def _manakov_step(e, pch, lin_op, hz_, cfg: SSFMConfig, nl_sign):
    """One symmetric split step with trapezoidal nonlinear correction.

    Shared by the adaptive (while_loop) and static (scan) paths. Returns the
    stepped field. ``pch`` is the start-of-step power (trapezoid anchor).
    """
    gamma_ = cfg.gamma
    e_hd = jnp.fft.ifft(jnp.fft.fft(e, axis=-1) * lin_op, axis=-1)

    def one_iter(e_conv):
        phi = nlin_phase_rot(e_conv[0], e_conv[1], pch, gamma_)
        rot = jnp.exp(nl_sign * 1j * phi * hz_).astype(e.dtype)
        return jnp.fft.ifft(jnp.fft.fft(e_hd * rot, axis=-1) * lin_op, axis=-1)

    if cfg.trapIters > 0:
        # fixed iteration count: static control flow (unrolled at trace time)
        e_fd = e
        for _ in range(cfg.trapIters):
            e_fd = one_iter(e_fd)
        return e_fd

    def it_cond(it_carry):
        _, _, lim, n_it = it_carry
        return (n_it < cfg.maxIter) & (lim >= cfg.tol)

    def it_body(it_carry):
        _, e_conv, _, n_it = it_carry
        e_fd = one_iter(e_conv)
        lim = convergence_condition(e_fd, e_conv)
        return e_fd, e_fd, lim, n_it + 1

    lim0 = jnp.real(e[0, 0, 0]) * 0.0 + jnp.inf
    e_fd, _, _, _ = jax.lax.while_loop(it_cond, it_body, (e_hd, e, lim0, 0))
    return e_fd


def _manakov_span(e, lin_arg, span_len, cfg: SSFMConfig, nl_sign=1.0):
    """Propagate the (2, B, N) field through one span (z while-loop).

    Mirrors the reference step structure (channels.py:387-441): adaptive or
    fixed step size, symmetric linear half-steps, trapezoidal iteration of the
    nonlinear phase rotation with convergence check. ``nl_sign=-1`` inverts
    the nonlinear rotation (digital backpropagation, equalization.py:976,
    which keeps gamma positive for the step-size rule and flips the operator
    sign).
    """
    if not cfg.nlprMethod:
        # static path: the step schedule is known at trace time -> lax.scan
        # over per-step sizes (uniform hz + one partial final step). With
        # trapIters > 0 this path contains no while_loop at all.
        #
        # The linear operators are closure CONSTANTS, not scanned-over arrays:
        # a (n_steps, N) operator tensor is multi-GB at 2^20 samples and its
        # per-step HBM reads would dominate each step. The uniform
        # prefix of the schedule shares one operator; the <=2 trailing steps
        # around a partial final step are unrolled with their own operators.
        n_full = int(np.floor(span_len / cfg.hz))
        hz_last = span_len - n_full * cfg.hz
        sizes = np.asarray(
            [cfg.hz] * n_full + ([hz_last] if hz_last > 1e-9 else []),
            dtype=np.float64,
        )

        if cfg.fusedLinear and cfg.trapIters == 1:
            # merged half-steps: the linear operator between nonlinear steps
            # k and k+1 covers (h_k + h_{k+1})/2; edges get h/2. The field is
            # carried in the frequency domain -> one fft+ifft pair per step.
            mid = (sizes[:-1] + sizes[1:]) / 2 if len(sizes) > 1 else []
            gaps = np.concatenate([mid, [sizes[-1] / 2]])
            gamma_ = cfg.gamma

            def fstep_with(ef, hz_, lin_gap):
                et = jnp.fft.ifft(ef, axis=-1)
                pch = jnp.sum((et * jnp.conj(et)).real, axis=0)
                # trapezoid anchor = current power, so nlin_phase_rot
                # (channels.py:471) reduces to (8/9)*gamma*pch here
                rot = jnp.exp(
                    nl_sign * 1j * ((8 / 9) * gamma_ * hz_) * pch
                ).astype(et.dtype)
                return jnp.fft.fft(et * rot, axis=-1) * lin_gap

            n_uni = 0
            while (n_uni < len(sizes) and sizes[n_uni] == cfg.hz
                   and gaps[n_uni] == cfg.hz):
                n_uni += 1

            ef = jnp.fft.fft(e, axis=-1) * jnp.exp(lin_arg * (sizes[0] / 2))
            if n_uni:
                lin_full = jnp.exp(lin_arg * cfg.hz)

                def fstep(ef, _):
                    return fstep_with(ef, cfg.hz, lin_full), None

                ef, _ = jax.lax.scan(fstep, ef, None, length=n_uni)
            for k in range(n_uni, len(sizes)):  # <= 2 trailing steps
                ef = fstep_with(ef, sizes[k], jnp.exp(lin_arg * gaps[k]))
            return jnp.fft.ifft(ef, axis=-1)

        def step_with(e, hz_, lin_op):
            pch = jnp.sum(jnp.abs(e) ** 2, axis=0)
            return _manakov_step(e, pch, lin_op, hz_, cfg, nl_sign)

        n_uni = int(np.sum(sizes == cfg.hz))
        lin_half = jnp.exp(lin_arg * (cfg.hz / 2))

        def step(e, _):
            return step_with(e, cfg.hz, lin_half), None

        e, _ = jax.lax.scan(step, e, None, length=n_uni)
        for k in range(n_uni, len(sizes)):  # at most the partial final step
            e = step_with(e, sizes[k], jnp.exp(lin_arg * (sizes[k] / 2)))
        return e

    # adaptive path: data-dependent step size (channels.py:392-397) -> while
    def z_cond(carry):
        _, z = carry
        return z < span_len

    def z_body(carry):
        e, z = carry
        pch = jnp.sum(jnp.abs(e) ** 2, axis=0)  # (B, N)
        phi_rot = nlin_phase_rot(e[0], e[1], pch, cfg.gamma)
        hz_cand = cfg.maxNlinPhaseRot / jnp.max(phi_rot)
        hz_ = jnp.minimum(hz_cand, span_len - z)
        lin_op = jnp.exp(lin_arg * (hz_ / 2))
        e_fd = _manakov_step(e, pch, lin_op, hz_, cfg, nl_sign)
        return e_fd, z + hz_

    # initial z derived from the field so its device-varying type matches the
    # loop-carried value under shard_map
    z0 = jnp.real(e[0, 0, 0]) * 0.0
    e, _ = jax.lax.while_loop(z_cond, z_body, (e, z0))
    return e


@partial(jax.jit, static_argnames=("config", "save_all_spans"))
def manakov_ssf(e_in, config: SSFMConfig, key=None, save_all_spans=False):
    """Manakov split-step Fourier propagation (reference channels.py:252).

    Parameters
    ----------
    e_in : (N, 2*k) array
        Dual-polarization field(s); columns alternate x/y polarization for k
        independently-propagating signals (k > 1 batches WDM channels or
        launch powers through one solver call, as modelsGPU.py:775 does).
    config : SSFMConfig
        Physical/simulation parameters (static; changes trigger recompilation).
    key : PRNG key for per-span ASE noise.
    save_all_spans : bool
        If True, additionally return the field after every span as a
        (Nspans, N, 2*k) array (reference ``saveSpanN``, channels.py:453-456).

    Returns
    -------
    (N, 2*k) output field, or (output, per_span_fields) if save_all_spans.
    """
    if config.Fs is None:
        raise ValueError("Simulation sampling frequency (Fs) not provided.")
    cdtype = _solver_cdtype(config)
    e_in = jnp.asarray(e_in, dtype=cdtype)
    n = e_in.shape[0]
    # (2, B, N): pol axis leading, batch of signals, time on lanes
    ex = e_in[:, 0::2].T
    ey = e_in[:, 1::2].T
    e = jnp.stack([ex, ey])

    alpha, beta2 = fiber_coefficients(config.alpha, config.D, config.Fc)
    n_spans = int(np.floor(config.Ltotal / config.Lspan))
    w = 2 * jnp.pi * config.Fs * jnp.fft.fftfreq(n)
    lin_arg = (-(alpha / 2) + 1j * (beta2 / 2) * w**2).astype(cdtype)

    amp_cfg = EDFAConfig(G=config.alpha * config.Lspan, NF=config.NF,
                         Fc=config.Fc, Fs=config.Fs)
    if key is None:
        key = jax.random.PRNGKey(0)

    def span(e, span_idx):
        e = _manakov_span(e, lin_arg, config.Lspan, config)
        if config.amp == "edfa":
            e = edfa(e, amp_cfg, jax.random.fold_in(key, span_idx))
        elif config.amp == "ideal":
            e = e * float(np.exp(alpha / 2 * config.Lspan))  # weak: no x64 promotion
        out = _to_columns(e, n) if save_all_spans else None
        return e, out

    e, span_fields = jax.lax.scan(span, e, jnp.arange(n_spans))
    out = _to_columns(e, n)
    if save_all_spans:
        return out, span_fields
    return out


def _to_columns(e, n):
    """(2, B, N) pol-stacked field -> (N, 2*B) interleaved columns."""
    b = e.shape[1]
    out = jnp.zeros((n, 2 * b), dtype=e.dtype)
    out = out.at[:, 0::2].set(e[0].T)
    out = out.at[:, 1::2].set(e[1].T)
    return out


def awgn(sig, key, config: AWGNConfig = AWGNConfig()):
    """AWGN channel calibrated to an SNR in the signal bandwidth.

    Parity with reference channels.py:522: noise variance is
    ``(Fs/B) * sigPow(sig) / SNR_lin``.
    """
    sig = jnp.asarray(sig)
    snr_lin = 10 ** (config.snr / 10)
    noise_var = sig_pow(sig) / snr_lin
    var = (config.Fs / config.B) * noise_var
    if config.complexNoise:
        noise = gaussian_complex_noise(key, sig.shape, var)
    else:
        noise = gaussian_noise(key, sig.shape, var / 2)
    return sig + noise
