"""Optoelectronic device models: modulators, receivers, amplifiers, converters.

Counterpart of reference ``optic/models/devices.py``. All device
transfer functions are pure, vectorized JAX; stochastic devices (photodiode,
EDFA, laser, ADC) thread explicit PRNG keys. The reference's GPU/CPU firFilter
dispatch (devices.py:45-53) disappears — one XLA path serves both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import scipy.constants as sconst

from opticommpy_tpu.models.config import (
    ADCConfig,
    CoherentFrontendConfig,
    DACConfig,
    EDFAConfig,
    IQMConfig,
    LaserConfig,
    MZMConfig,
    PDMFrontendConfig,
    PhotodiodeConfig,
)
from opticommpy_tpu.ops.filtering import fir_filter, lowpass_fir
from opticommpy_tpu.ops.modulator import calc_mzm, calc_pm
from opticommpy_tpu.ops.noise import gaussian_complex_noise, gaussian_noise, phase_noise
from opticommpy_tpu.ops.signal import (
    clock_sampling_interp,
    delay_signal,
    iq_mixing,
    quantizer,
)
from opticommpy_tpu.utils.units import dbm2w

__all__ = [
    "pm",
    "mzm",
    "iqm",
    "pbs",
    "voa",
    "photodiode",
    "balanced_pd",
    "optical_hybrid_2x4",
    "coherent_receiver",
    "pdm_coherent_receiver",
    "edfa",
    "basic_laser_model",
    "adc",
    "dac",
]


def pm(e_in, u, v_pi):
    """Optical phase modulator (reference devices.py:56)."""
    return calc_pm(jnp.asarray(e_in), v_pi, jnp.asarray(u))


def mzm(e_in, u, config: MZMConfig = MZMConfig()):
    """Mach-Zehnder amplitude modulator (reference devices.py:94)."""
    return calc_mzm(jnp.asarray(e_in), config.Vpi, jnp.asarray(u), config.Vb, config.ER)


def iqm(e_in, u, config: IQMConfig = IQMConfig()):
    """IQ modulator: two MZMs + 90-degree combiner (reference devices.py:147)."""
    e_in = jnp.asarray(e_in)
    u = jnp.asarray(u)
    eo_i = calc_mzm(e_in / jnp.sqrt(2.0), config.Vpi, u.real, config.VbI, config.ERI)
    eo_q = calc_mzm(e_in / jnp.sqrt(2.0), config.Vpi, u.imag, config.VbQ, config.ERQ)
    return eo_i + calc_pm(eo_q, config.Vpi, config.Vphi * jnp.ones(u.shape))


def pbs(e, theta=0.0):
    """Polarization beam splitter with input rotation (reference devices.py:223).

    Accepts (N,) single-pol (second pol assumed empty) or (N, 2) input;
    returns (Ex, Ey).
    """
    e = jnp.asarray(e)
    if e.ndim == 1:
        e = jnp.stack([e, jnp.zeros_like(e)], axis=1)
    rot = jnp.array(
        [[jnp.cos(theta), -jnp.sin(theta)], [jnp.sin(theta), jnp.cos(theta)]],
        dtype=e.dtype,
    )
    # HIGHEST: a default f32 matmul may run in TF32 on a GPU (~1e-3
    # relative error on the optical field)
    out = jnp.matmul(e, rot, precision=jax.lax.Precision.HIGHEST)
    return out[:, 0], out[:, 1]


def voa(e, att_db=0.0):
    """Variable optical attenuator (reference devices.py:263)."""
    return jnp.asarray(e) * 10 ** (-att_db / 20)


def photodiode(e, config: PhotodiodeConfig = None, key=None):
    """Pin photodiode with shot/thermal noise, saturation, and bandwidth.

    Parity with reference devices.py:289: ideal photocurrent ``R*|E|^2``
    (summed over modes for multimode input), optional saturation clip, shot
    noise ``2q(ipd+Id)B`` and thermal noise ``4kTB/RL`` (scaled to the
    simulation bandwidth), then a lowpass FIR frequency response.
    """
    if config is None:
        config = PhotodiodeConfig()
    e = jnp.asarray(e)
    k_b = sconst.k
    q = sconst.e

    if e.ndim > 1 and e.shape[1] > 1:
        ipd = config.R * jnp.sum(jnp.abs(e) ** 2, axis=1)
    else:
        ipd = config.R * (e * jnp.conj(e)).real
        if ipd.ndim > 1:
            ipd = ipd[:, 0]

    if config.ideal:
        return ipd.real

    fs = config.Fs
    if fs is None:
        raise ValueError("Simulation sampling frequency (Fs) not provided.")
    if fs < 2 * config.B:
        raise ValueError("Sampling frequency Fs needs to be at least twice of B.")

    n_taps = config.N + (config.N % 2 == 0)  # force odd

    if config.currentSaturation:
        ipd = jnp.minimum(ipd, config.IpdSat)

    if config.shotNoise or config.thermalNoise:
        if key is None:
            key = jax.random.PRNGKey(0)
        k_shot, k_th = jax.random.split(key)
    if config.shotNoise:
        var_shot = 2 * q * (ipd + config.Id) * config.B
        ipd = ipd + jnp.sqrt(fs * var_shot / (2 * config.B)) * jax.random.normal(
            k_shot, ipd.shape
        )
    if config.thermalNoise:
        t_kelvin = config.Tc + 273.15
        var_th = 4 * k_b * t_kelvin * config.B / config.RL
        ipd = ipd + gaussian_noise(k_th, ipd.shape, fs * var_th / (2 * config.B))
    if config.bandwidthLimitation:
        h = jnp.asarray(lowpass_fir(config.B, fs, n_taps, config.fType))
        ipd = fir_filter(h, ipd)
    return ipd.real


def balanced_pd(e1, e2, config: PhotodiodeConfig = None, key=None):
    """Balanced photodiode pair: i1 - i2 (reference devices.py:402)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    i1 = photodiode(e1, config, k1)
    i2 = photodiode(e2, config, k2)
    return i1 - i2


def optical_hybrid_2x4(e_s, e_lo):
    """2x4 90-degree optical hybrid (reference devices.py:462).

    Returns the four output fields as a (4, N) array.
    """
    e_s = jnp.asarray(e_s)
    e_lo = jnp.asarray(e_lo)
    T = jnp.array(
        [
            [0.5, 0.5j, 0.5j, -0.5],
            [0.5j, -0.5, 0.5, 0.5j],
            [0.5j, 0.5, -0.5j, -0.5],
            [-0.5, 0.5j, -0.5, 0.5j],
        ],
        dtype=jnp.complex64,
    )
    zeros = jnp.zeros_like(e_s)
    e_in = jnp.stack([e_s, zeros, zeros, e_lo])
    return jnp.matmul(T, e_in, precision=jax.lax.Precision.HIGHEST)


def coherent_receiver(
    e_s,
    e_lo,
    config_fe: CoherentFrontendConfig = None,
    config_pd: PhotodiodeConfig = None,
    key=None,
):
    """Single-polarization coherent front end (reference devices.py:503).

    Optical hybrid -> two balanced PDs (I and Q) -> IQ impairments.
    """
    if config_fe is None:
        config_fe = CoherentFrontendConfig()
    fs = config_fe.Fs
    if config_pd is None:
        config_pd = PhotodiodeConfig(ideal=True, Fs=fs)
    if key is None:
        key = jax.random.PRNGKey(0)
    k_i, k_q = jax.random.split(key)

    eo = optical_hybrid_2x4(e_s, e_lo)
    s_i = balanced_pd(eo[1, :], eo[0, :], config_pd, k_i)
    s_q = balanced_pd(eo[2, :], eo[3, :], config_pd, k_q)
    s = s_i + 1j * s_q
    return iq_mixing(
        s, fs, config_fe.ampImb, config_fe.phaseImb, config_fe.timeSkew
    )


def pdm_coherent_receiver(
    e_s,
    e_lo,
    config_fe: PDMFrontendConfig = None,
    config_pd: PhotodiodeConfig = None,
    key=None,
):
    """Polarization-multiplexed coherent front end (reference devices.py:574).

    Splits signal and LO with PBSs (LO at 45 degrees), applies polarization
    delay/PDL impairments, and detects each polarization with a single-pol
    coherent receiver. Returns an (N, 2) array [Sx, Sy].
    """
    if config_fe is None:
        config_fe = PDMFrontendConfig()
    fs = config_fe.Fs
    if config_pd is None:
        config_pd = PhotodiodeConfig(ideal=True, Fs=fs)
    if key is None:
        key = jax.random.PRNGKey(0)
    kx, ky = jax.random.split(key)

    e_lo_x, e_lo_y = pbs(jnp.asarray(e_lo), theta=jnp.pi / 4)
    e_s_x, e_s_y = pbs(jnp.asarray(e_s), theta=config_fe.polRotation)

    if config_fe.polDelay != 0:
        e_s_x = delay_signal(e_s_x, -config_fe.polDelay / 2, fs)
        e_s_y = delay_signal(e_s_y, config_fe.polDelay / 2, fs)
    if config_fe.pdl != 0:
        e_s_x = 10 ** (-(config_fe.pdl / 2) / 20) * e_s_x
        e_s_y = 10 ** ((config_fe.pdl / 2) / 20) * e_s_y

    fe_x = CoherentFrontendConfig(
        Fs=fs,
        phaseImb=config_fe.phaseImbX,
        ampImb=config_fe.ampImbX,
        timeSkew=config_fe.timeSkewX,
    )
    fe_y = CoherentFrontendConfig(
        Fs=fs,
        phaseImb=config_fe.phaseImbY,
        ampImb=config_fe.ampImbY,
        timeSkew=config_fe.timeSkewY,
    )
    s_x = coherent_receiver(e_s_x, e_lo_x, fe_x, config_pd, kx)
    s_y = coherent_receiver(e_s_y, e_lo_y, fe_y, config_pd, ky)
    return jnp.stack([s_x, s_y], axis=1)


def edfa(e_in, config: EDFAConfig = None, key=None):
    """Lumped EDFA: flat gain + additive ASE noise (reference devices.py:671).

    ASE PSD follows Essiambre et al. (2010) Eq. (54):
    ``N_ase = (G-1) * nsp * h * Fc`` with ``nsp = (G*NF-1)/(2(G-1))``.
    """
    if config is None:
        config = EDFAConfig()
    if config.Fs is None:
        raise ValueError("Simulation sampling frequency (Fs) not provided.")
    if config.G <= 0:
        raise ValueError("EDFA gain should be a positive scalar")
    if config.NF < 3:
        raise ValueError("The minimal EDFA noise figure is 3 dB")
    e_in = jnp.asarray(e_in)
    nf_lin = 10 ** (config.NF / 10)
    g_lin = 10 ** (config.G / 10)
    nsp = (g_lin * nf_lin - 1) / (2 * (g_lin - 1))
    n_ase = (g_lin - 1) * nsp * sconst.h * config.Fc
    p_noise = n_ase * config.Fs
    if key is None:
        key = jax.random.PRNGKey(0)
    noise = gaussian_complex_noise(key, e_in.shape, p_noise)
    return e_in * jnp.sqrt(g_lin) + noise


def basic_laser_model(config: LaserConfig = None, key=None):
    """CW laser with random-walk phase noise, RIN and frequency offset.

    Parity with reference devices.py:729 (basicLaserModel).
    """
    if config is None:
        config = LaserConfig()
    if config.Fs is None:
        raise ValueError("Simulation sampling frequency (Fs) not provided.")
    if key is None:
        key = jax.random.PRNGKey(0)
    k_pn, k_rin = jax.random.split(key)
    pn = phase_noise(k_pn, config.lw, config.Ns, 1 / config.Fs)
    delta_p = gaussian_complex_noise(k_rin, pn.shape, config.RIN_var)
    if config.freqShift != 0:
        fo = 2 * jnp.pi * config.freqShift * jnp.arange(config.Ns) / config.Fs
    else:
        fo = 0.0
    return jnp.sqrt(dbm2w(config.P) + delta_p) * jnp.exp(1j * (fo + pn))


def adc(sig_in, config: ADCConfig = ADCConfig(), key=None):
    """ADC: anti-aliasing, clock interp + jitter, clip, quantize, ENOB noise.

    Parity with reference devices.py:793.
    """
    sig_in = jnp.asarray(sig_in)
    squeeze = sig_in.ndim == 1
    if squeeze:
        sig_in = sig_in[:, None]
    is_complex = jnp.issubdtype(sig_in.dtype, jnp.complexfloating)
    if key is None:
        key = jax.random.PRNGKey(0)
    k_ji, k_jq, k_enob = jax.random.split(key, 3)

    if config.AAF:
        n_taps = min(sig_in.shape[0], config.N)
        hi = jnp.asarray(lowpass_fir(config.outFs / 2, config.inFs, n_taps))
        ho = jnp.asarray(lowpass_fir(config.outFs / 2, config.outFs, n_taps))
        sig_in = fir_filter(hi, sig_in)

    if is_complex:
        s_r = clock_sampling_interp(
            sig_in.real, config.inFs, config.outFs, config.jitter, k_ji
        )
        s_i = clock_sampling_interp(
            sig_in.imag, config.inFs, config.outFs, config.jitter, k_jq
        )
        s_r = jnp.clip(s_r, config.Vmin, config.Vmax)
        s_i = jnp.clip(s_i, config.Vmin, config.Vmax)
        out = quantizer(s_r, config.nBits, config.Vmax, config.Vmin) + 1j * quantizer(
            s_i, config.nBits, config.Vmax, config.Vmin
        )
    else:
        s = clock_sampling_interp(
            sig_in, config.inFs, config.outFs, config.jitter, k_ji
        )
        s = jnp.clip(s, config.Vmin, config.Vmax)
        out = quantizer(s, config.nBits, config.Vmax, config.Vmin)

    if config.AAF:
        out = fir_filter(ho, out)

    if config.nBits > config.ENOB:
        scale = config.Vmax - config.Vmin
        pn_extra = scale**2 / 12 * (
            2.0 ** (-2 * config.ENOB) - 2.0 ** (-2 * config.nBits)
        )
        if is_complex:
            out = out + gaussian_complex_noise(k_enob, out.shape, 2 * pn_extra)
        else:
            out = out + gaussian_noise(k_enob, out.shape, pn_extra)
    return out[:, 0] if squeeze else out


def dac(sig_in, config: DACConfig = DACConfig(), key=None):
    """DAC: quantize, clock interp + jitter, anti-imaging, ENOB noise, Vpp scale.

    Parity with reference devices.py:912.
    """
    sig_in = jnp.asarray(sig_in)
    squeeze = sig_in.ndim == 1
    if squeeze:
        sig_in = sig_in[:, None]
    is_complex = jnp.issubdtype(sig_in.dtype, jnp.complexfloating)
    if key is None:
        key = jax.random.PRNGKey(0)
    k_ji, k_jq, k_enob = jax.random.split(key, 3)

    if is_complex:
        v_max = jnp.maximum(jnp.max(sig_in.real), jnp.max(sig_in.imag))
        v_min = jnp.minimum(jnp.min(sig_in.real), jnp.min(sig_in.imag))
        out = quantizer(sig_in.real, config.nBits, v_max, v_min) + 1j * quantizer(
            sig_in.imag, config.nBits, v_max, v_min
        )
        out = clock_sampling_interp(
            out.real, config.inFs, config.outFs, config.jitter, k_ji
        ) + 1j * clock_sampling_interp(
            out.imag, config.inFs, config.outFs, config.jitter, k_jq
        )
    else:
        v_max = jnp.max(sig_in)
        v_min = jnp.min(sig_in)
        out = quantizer(sig_in, config.nBits, v_max, v_min)
        out = clock_sampling_interp(out, config.inFs, config.outFs, config.jitter, k_ji)

    if config.AIF:
        n_taps = min(out.shape[0], config.N)
        ho = jnp.asarray(lowpass_fir(config.outFs / 2, config.outFs, n_taps))
        out = fir_filter(ho, out)

    if config.nBits > config.ENOB:
        scale = v_max - v_min
        pn_extra = scale**2 / 12 * (
            2.0 ** (-2 * config.ENOB) - 2.0 ** (-2 * config.nBits)
        )
        if is_complex:
            out = out + gaussian_complex_noise(k_enob, out.shape, 2 * pn_extra)
        else:
            out = out + gaussian_noise(k_enob, out.shape, pn_extra)

    out = out * (config.Vpp / (v_max - v_min))
    return out[:, 0] if squeeze else out
