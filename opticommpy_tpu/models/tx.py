"""Optical transmitters: WDM pol-mux coherent Tx and PAM IM-DD Tx.

Counterpart of reference ``optic/models/tx.py``. The reference
loops over channels and polarization modes in Python (tx.py:176,182); here the
whole (nChannels, nPolModes) grid of signals is generated, pulse-shaped,
modulated, frequency-shifted and summed as batched array ops — one traced
graph that XLA fuses and that vmap/shard_map can spread over chips.
"""

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from opticommpy_tpu.comm.modulation import gray_mapping
from opticommpy_tpu.comm.sources import symbol_pmf
from opticommpy_tpu.models.config import IQMConfig, MZMConfig
from opticommpy_tpu.models.devices import iqm, mzm
from opticommpy_tpu.ops.filtering import fir_filter, pulse_shape
from opticommpy_tpu.ops.noise import phase_noise
from opticommpy_tpu.ops.signal import upsample
from opticommpy_tpu.utils.rng import ensure_key
from opticommpy_tpu.utils.units import dbm2w

__all__ = ["WDMTxConfig", "PAMTxConfig", "simple_wdm_tx", "pam_transmitter",
           "set_power_for_par_ssfm"]


@dataclass(frozen=True)
class WDMTxConfig:
    """WDM transmitter parameters (reference tx.py:42 defaults)."""

    M: int = 16
    constType: str = "qam"
    Rs: float = 32e9
    SpS: int = 16
    probDist: str = "uniform"
    shapingFactor: float = 0.0
    nBits: int = 60000
    pulseType: str = "rrc"
    nFilterTaps: int = 1024
    pulseRollOff: float = 0.01
    mzmScale: float = 0.5
    powerPerChannel: tuple = (-3.0,)  # dBm; scalar broadcast if len==1
    nChannels: int = 5
    Fc: float = 193.1e12
    laserLinewidth: float = 0.0
    wdmGridSpacing: float = 50e9
    nPolModes: int = 1

    @property
    def Fs(self):
        return self.Rs * self.SpS

    @property
    def nSymbols(self):
        return int(self.nBits / np.log2(self.M))


@dataclass(frozen=True)
class PAMTxConfig:
    """PAM transmitter parameters (reference tx.py:231 defaults)."""

    M: int = 4
    Rs: float = 32e9
    SpS: int = 16
    probDist: str = "uniform"
    shapingFactor: float = 0.0
    nBits: int = 40000
    pulseType: str = "nrz"
    nFilterTaps: int = 256
    pulseRollOff: float = 0.01
    mzmVpi: float = 3.0
    mzmVb: float = 1.5
    mzmER: float = 80.0
    mzmScale: float = 0.25
    nPolModes: int = 1
    power: float = -3.0  # dBm

    @property
    def Fs(self):
        return self.Rs * self.SpS

    @property
    def nSymbols(self):
        return int(self.nBits / np.log2(self.M))


def wdm_freq_grid(n_channels, spacing):
    """Center frequencies of the WDM channels relative to Fc (tx.py:140-146)."""
    grid = (
        np.arange(-np.floor(n_channels / 2), np.floor(n_channels / 2) + 1) * spacing
    )
    if n_channels % 2 == 0:
        grid = grid[:n_channels] + spacing / 2
    return grid[:n_channels]


def simple_wdm_tx(key_or_seed, config: WDMTxConfig = WDMTxConfig()):
    """Multi-channel WDM pol-mux transmitter (reference tx.py:42).

    Per channel x polarization: shaped random symbols -> upsample -> pulse
    shaping -> IQ modulation of a phase-noisy carrier -> frequency shift onto
    the WDM grid; channels are summed per polarization.

    Returns
    -------
    sig_wdm : (nSamples, nPolModes) complex
    symb_wdm : (nSymbols, nPolModes, nChannels) complex
    freq_grid : (nChannels,) numpy array of channel offsets [Hz]
    """
    key = ensure_key(key_or_seed)
    cfg = config
    n_ch, n_pol = cfg.nChannels, cfg.nPolModes
    n_sym = cfg.nSymbols
    fs = cfg.Fs
    n_samples = n_sym * cfg.SpS

    # constellation + pmf (unit-energy normalized under the pmf)
    const = gray_mapping(cfg.M, cfg.constType)
    px = symbol_pmf(cfg.M, cfg.constType, cfg.probDist, cfg.shapingFactor)
    const = const / np.sqrt(np.sum(px * np.abs(const) ** 2))

    freq_grid = wdm_freq_grid(n_ch, cfg.wdmGridSpacing)
    p_ch = np.asarray(cfg.powerPerChannel, dtype=np.float64).reshape(-1)
    if p_ch.size == 1:
        p_ch = np.full(n_ch, p_ch[0])
    if p_ch.size != n_ch:
        raise ValueError("powerPerChannel length does not match nChannels")
    p_ch_w = 10 ** (p_ch / 10) * 1e-3

    k_sym, k_pn = jax.random.split(key)

    # symbols for the whole (ch, pol) grid in one draw: (nCh, nPol, nSym)
    idx = jax.random.choice(
        k_sym, cfg.M, (n_ch, n_pol, n_sym), p=jnp.asarray(px)
    )
    symbols = jnp.asarray(const)[idx]

    # upsample + pulse shaping, batched over all (ch, pol) signals as columns
    pulse = jnp.asarray(
        pulse_shape(cfg.pulseType, cfg.SpS, cfg.nFilterTaps, cfg.pulseRollOff)
    )
    cols = symbols.reshape(n_ch * n_pol, n_sym).T  # (nSym, nCh*nPol)
    sig = fir_filter(pulse, upsample(cols, cfg.SpS))  # (nSamples, nCh*nPol)
    sig = sig / jnp.max(jnp.abs(sig), axis=0, keepdims=True)
    sig = sig.T.reshape(n_ch, n_pol, n_samples)

    # one phase-noisy carrier per channel (shared across its polarizations,
    # tx.py:205-210)
    ch_keys = jax.random.split(k_pn, n_ch)
    pn = jax.vmap(lambda k: phase_noise(k, cfg.laserLinewidth, n_samples, 1 / fs))(
        ch_keys
    )  # (nCh, nSamples)
    sig_lo = jnp.exp(1j * pn)[:, None, :]  # (nCh, 1, nSamples)

    # IQ modulation (broadcast over the grid)
    sig_ch = iqm(jnp.broadcast_to(sig_lo, sig.shape), cfg.mzmScale * sig, IQMConfig())

    # per-signal power normalization: sqrt(Pch/nPol) * pnorm
    power = (sig_ch * jnp.conj(sig_ch)).real.mean(axis=-1, keepdims=True)
    sig_ch = sig_ch / jnp.sqrt(power)
    sig_ch = sig_ch * jnp.sqrt(jnp.asarray(p_ch_w)[:, None, None] / n_pol)

    # shift each channel onto the WDM grid and sum channels
    t = jnp.arange(n_samples) / fs
    shift = jnp.exp(
        1j * 2 * jnp.pi * jnp.asarray(freq_grid)[:, None] * t[None, :]
    ).astype(jnp.complex64)  # (nCh, nSamples)
    sig_wdm = jnp.sum(sig_ch * shift[:, None, :], axis=0).T  # (nSamples, nPol)

    # symbols: (nCh, nPol, nSym) -> (nSym, nPol, nCh)
    symb_wdm = jnp.transpose(symbols, (2, 1, 0))
    return sig_wdm, symb_wdm, freq_grid


def pam_transmitter(key_or_seed, config: PAMTxConfig = PAMTxConfig()):
    """Optical PAM/IM-DD transmitter (reference tx.py:231).

    Returns (sig_tx, symb_tx): the MZM-modulated optical signal of shape
    (nSamples,) or (nSamples, nPolModes), and the transmitted PAM symbols.
    """
    key = ensure_key(key_or_seed)
    cfg = config
    n_pol = cfg.nPolModes
    n_sym = cfg.nSymbols

    const = gray_mapping(cfg.M, "pam")
    px = symbol_pmf(cfg.M, "pam", cfg.probDist, cfg.shapingFactor)
    const = const / np.sqrt(np.sum(px * np.abs(const) ** 2))

    idx = jax.random.choice(key, cfg.M, (n_sym, n_pol), p=jnp.asarray(px))
    symb = jnp.asarray(const)[idx]  # (nSym, nPol), real

    pulse = jnp.asarray(
        pulse_shape(cfg.pulseType, cfg.SpS, cfg.nFilterTaps, cfg.pulseRollOff)
    )
    sig = fir_filter(pulse, upsample(symb, cfg.SpS))
    sig = cfg.mzmVpi * sig / jnp.max(jnp.abs(sig), axis=0, keepdims=True)

    mzm_cfg = MZMConfig(Vpi=cfg.mzmVpi, Vb=-cfg.mzmVb, ER=cfg.mzmER)
    sig_o = mzm(jnp.ones_like(sig), cfg.mzmScale * sig, mzm_cfg)
    sig_o = jnp.sqrt(dbm2w(cfg.power)) * (
        sig_o / jnp.sqrt(jnp.mean((sig_o * jnp.conj(sig_o)).real, axis=0, keepdims=True))
    )
    if n_pol == 1:
        return sig_o[:, 0], symb[:, 0]
    return sig_o, symb


def set_power_for_par_ssfm(sig, powers_dbm, verbose=False):
    """Scale polarization pairs of a mode-batched field to launch powers.

    Counterpart of the GPU reference's parallel-power helper
    (modelsGPU.py:775): column pairs (2k, 2k+1) of ``sig`` form the k-th
    polmux signal; each is scaled so the pair's total power is
    ``powers_dbm[k]`` (half per polarization). One vectorized rescale, no
    per-column loop.
    """
    import jax.numpy as jnp

    from opticommpy_tpu.ops.signal import signal_power
    from opticommpy_tpu.utils.units import dbm2w

    sig = jnp.asarray(sig)
    p_lin = jnp.repeat(dbm2w(jnp.asarray(powers_dbm, dtype=jnp.float32)), 2) / 2
    cur = jnp.mean((sig * jnp.conj(sig)).real, axis=0)
    out = sig * jnp.sqrt(p_lin / cur)[None, :]
    if verbose:
        for i in range(out.shape[1]):
            print("power mode %d: %.2f dBm"
                  % (i, 10 * np.log10(float(signal_power(out[:, i])) / 1e-3)))
    return out
