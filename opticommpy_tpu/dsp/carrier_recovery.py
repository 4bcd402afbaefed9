"""Carrier phase and frequency recovery: BPS, DD-PLL, Viterbi&Viterbi, 4th-power FOE.

Counterpart of reference ``optic/dsp/carrierRecovery.py`` (and its
GPU twin ``carrierRecoveryGPU.py``):

- :func:`bps` follows the *vectorized GPU formulation*
  (carrierRecoveryGPU.py:54-66), not the per-symbol CPU loop: the full
  (N, B, M) distance tensor reduces over the constellation, then a windowed
  sum over time — all batched over modes, no sequential dependence.
- :func:`ddpll` is the true per-symbol PLL recurrence as a ``lax.scan``
  (carrierRecovery.py:226), vmapped over modes.
- :func:`viterbi` / :func:`fourth_power_foe` are closed-form vector ops.
- :func:`cpr` is the dispatcher (carrierRecovery.py:37) with the same
  post-processing: 4x unwrap, residual-linewidth estimate, derotation.
"""

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from opticommpy_tpu.comm.modulation import gray_mapping
from opticommpy_tpu.comm.sources import symbol_pmf
from opticommpy_tpu.ops.signal import moving_average, pnorm

__all__ = ["CPRConfig", "cpr", "bps", "ddpll", "viterbi", "fourth_power_foe",
           "residual_linewidth"]


@dataclass(frozen=True)
class CPRConfig:
    """Carrier phase recovery parameters (carrierRecovery.py:96-108 defaults)."""

    alg: str = "bps"  # 'bps' | 'ddpll' | 'viterbi'
    M: int = 4
    constType: str = "qam"
    shapingFactor: float = 0.0
    B: int = 64  # BPS test phases
    N: int = 35  # moving-average window
    Kv: float = 0.1
    tau1: float = 1 / (2 * np.pi * 10e6)
    tau2: float = 1 / (2 * np.pi * 10e6)
    Ts: float = 1 / 32e9
    runFOE: bool = True


@partial(jax.jit, static_argnames=("n_half", "n_phases"))
def bps(sig, n_half, const_symb, n_phases):
    """Blind phase search (Pfau et al. 2009; reference carrierRecovery.py:172).

    Fully vectorized (the template is the reference's own GPU version,
    carrierRecoveryGPU.py:54-66): for every symbol and test phase the minimum
    constellation distance is computed in one broadcast reduction, then the
    (2*n_half+1)-symbol sliding window sum runs as a cumsum difference.

    Parameters
    ----------
    sig : (N,) or (N, modes) complex
    n_half : int — half window (reference passes N//2)
    const_symb : (M,) constellation
    n_phases : int — number of test phases B over [0, pi/2)

    Returns
    -------
    (N, modes) float — estimated phases in [0, pi/2).
    """
    sig = jnp.asarray(sig)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[:, None]
    const_symb = jnp.asarray(const_symb)
    phases = (jnp.arange(n_phases) * (jnp.pi / 2) / n_phases).astype(jnp.float32)
    rot = jnp.exp(1j * phases).astype(jnp.complex64)  # (B,)

    # minimum constellation distance per (symbol, mode, test phase):
    # accumulate the min over constellation points to keep the working set at
    # (N, modes, B) instead of materializing the (N, modes, B, M) tensor
    z = sig[:, :, None] * rot[None, None, :]  # (N, modes, B)
    dmin = jnp.full(z.shape, jnp.inf, dtype=jnp.float32)
    for i in range(const_symb.shape[0]):
        dmin = jnp.minimum(dmin, jnp.abs(z - const_symb[i]) ** 2)

    # sliding-window sum over time (zero-padded, same output length).
    # reduce_window adds the 2*n_half+1 window values directly — a cumsum
    # difference loses ~eps*N relative accuracy to cancellation at large N,
    # which flips argmin decisions between near-tied test phases.
    win = 2 * n_half + 1
    pad = jnp.pad(dmin, ((n_half, n_half), (0, 0), (0, 0)))
    sums = jax.lax.reduce_window(
        pad, 0.0, jax.lax.add, (win, 1, 1), (1, 1, 1), "valid"
    )  # (N, modes, B)

    ind = jnp.argmin(sums, axis=-1)  # (N, modes)
    est = phases[ind]
    return est[:, 0] if squeeze else est


@jax.jit
def ddpll(sig, ts, kv, tau1, tau2, const_symb, symb_tx=None, pilot_ind=None):
    """Decision-directed PLL with 2nd-order loop filter (carrierRecovery.py:226).

    The symbol recurrence (phase estimate feeds the next decision) runs as a
    ``lax.scan`` vmapped over modes. Pilot symbols (``pilot_ind``) use the
    known transmitted symbol for the phase detector.
    """
    sig = jnp.asarray(sig)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[:, None]
    n, modes = sig.shape
    const_symb = jnp.asarray(const_symb)
    if symb_tx is None:
        symb_tx = jnp.zeros_like(sig)
    if symb_tx.ndim == 1:
        symb_tx = symb_tx[:, None]
    is_pilot = jnp.zeros(n, dtype=bool)
    if pilot_ind is not None:
        is_pilot = is_pilot.at[jnp.asarray(pilot_ind)].set(True)

    a1b = jnp.array(
        [
            1.0,
            ts / (2 * tau1) * (1 - 1 / jnp.tan(ts / (2 * tau2))),
            ts / (2 * tau1) * (1 + 1 / jnp.tan(ts / (2 * tau2))),
        ]
    )

    def one_mode(col, ref_col):
        def step(carry, inp):
            phi, u_f, u_d = carry
            x, ref, pilot = inp
            u_d1 = u_d
            eo = x * jnp.exp(1j * phi)
            dec = const_symb[jnp.argmin(jnp.abs(eo - const_symb))]
            target = jnp.where(pilot, ref, dec)
            u_d = jnp.imag(eo * jnp.conj(target))
            u_f = a1b[0] * u_f + a1b[1] * u_d1 + a1b[2] * u_d
            phi_next = phi - kv * u_f
            return (phi_next, u_f, u_d), phi

        (_, _, _), phis = jax.lax.scan(
            step, (0.0, 0.0, 0.0), (col, ref_col, is_pilot)
        )
        return phis

    est = jax.vmap(one_mode, in_axes=(1, 1), out_axes=1)(sig, symb_tx)
    return est[:, 0] if squeeze else est


def viterbi(sig, n_win=35, m_power=4):
    """Viterbi & Viterbi M-th power phase estimation (carrierRecovery.py:303)."""
    sig = jnp.asarray(sig)
    ma = moving_average(sig**m_power, n_win)
    return (
        -jnp.unwrap(jnp.angle(ma) / m_power, period=2 * jnp.pi / m_power, axis=0)
        - jnp.pi / 4
    )


def fourth_power_foe(sig, fs, m_power=4):
    """M-th power frequency offset estimation + compensation (carrierRecovery.py:331).

    Returns (compensated signal, estimated offsets per mode).
    """
    sig = jnp.asarray(sig)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[:, None]
    n = sig.shape[0]
    f = jnp.fft.fftfreq(n) * fs
    spec = jnp.abs(jnp.fft.fft(sig**m_power, axis=0))
    ind = jnp.argmax(spec, axis=0)
    fo = f[ind] / m_power  # (modes,)
    t = jnp.arange(n)[:, None] / fs
    out = sig * jnp.exp(-1j * 2 * jnp.pi * fo[None, :] * t)
    if squeeze:
        return out[:, 0], fo[0]
    return out, fo


def residual_linewidth(phase_est, Ts):
    """Residual phase-noise linewidth after CPR, in Hz.

    The reference estimates and logs this inside cpr
    (carrierRecovery.py:154-162): the variance of the phase increments on
    the central half of the estimate (1/4 discarded each end), averaged
    over modes, scaled by 1/(2 pi Ts) — the Lorentzian linewidth that
    would produce that random-walk step variance.
    """
    phase_est = jnp.asarray(phase_est)
    if phase_est.ndim == 1:
        phase_est = phase_est[:, None]
    discard = phase_est.shape[0] // 4
    d = jnp.diff(phase_est[discard:-discard], axis=0)
    sigma2 = jnp.mean(jnp.var(d, axis=0))
    return sigma2 / (2 * jnp.pi * Ts)


def cpr(sig, config: CPRConfig = CPRConfig(), symb_tx=None, pilot_ind=None,
        return_phases=False, return_linewidth=False):
    """Carrier phase recovery dispatcher (reference carrierRecovery.py:37).

    Optionally runs 4th-power FOE first, then the selected CPR algorithm,
    unwraps the 4x phase, and derotates. Where the reference *logs* the
    residual linewidth (carrierRecovery.py:154-162), this pure function
    returns it when asked: ``return_linewidth=True`` appends the
    :func:`residual_linewidth` estimate [Hz] to the return tuple.
    """
    sig = jnp.asarray(sig)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[:, None]

    const = gray_mapping(config.M, config.constType)
    px = symbol_pmf(
        config.M, config.constType,
        "maxwell-boltzmann" if config.shapingFactor else "uniform",
        config.shapingFactor,
    )
    const = jnp.asarray(
        (const / np.sqrt(np.sum(np.abs(const) ** 2 * px))).astype(np.complex64)
    )

    if config.runFOE:
        m_foe = config.M if config.constType in ("psk", "apsk") else 4
        sig, _ = fourth_power_foe(sig, 1 / config.Ts, m_foe)
        sig = pnorm(sig)

    if config.alg == "bps":
        phase_est = bps(sig, config.N // 2, const, config.B)
    elif config.alg == "ddpll":
        phase_est = ddpll(
            sig, config.Ts, config.Kv, config.tau1, config.tau2, const,
            symb_tx, pilot_ind,
        )
    elif config.alg == "viterbi":
        if config.constType == "psk":
            phase_est = viterbi(sig, config.N, config.M) + jnp.pi / 4
        else:
            phase_est = viterbi(sig, config.N)
    else:
        raise ValueError("CPR algorithm incorrectly specified.")

    phase_est = jnp.unwrap(4 * phase_est, axis=0) / 4
    out = pnorm(sig * jnp.exp(1j * phase_est))
    lw = residual_linewidth(phase_est, config.Ts) if return_linewidth else None
    if squeeze:
        out = out[:, 0]
        phase_est = phase_est[:, 0]
    ret = (out,)
    if return_phases:
        ret += (phase_est,)
    if return_linewidth:
        ret += (lw,)
    return ret if len(ret) > 1 else out
