"""OFDM modulation/demodulation with cyclic prefix and pilot equalization.

Counterpart of reference ``optic/comm/ofdm.py``. The reference
loops over OFDM frames in Python (ofdm.py:158,255); here all frames are
processed as one batched (nFrames, Nfft) IFFT/FFT —
and the pilot-based channel estimate is computed with a closed-form linear
interpolation/extrapolation instead of scipy.interp1d.
"""

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

__all__ = [
    "OFDMConfig",
    "hermit",
    "zero_pad",
    "calc_symbol_rate",
    "modulate_ofdm",
    "demodulate_ofdm",
]


@dataclass(frozen=True)
class OFDMConfig:
    """OFDM parameters (reference ofdm.py:128-135 defaults)."""

    Nfft: int = 512
    G: int = 4  # cyclic prefix length
    hermitSymmetry: bool = False
    pilot: complex = 0.25 + 0.25j
    pilotCarriers: tuple = ()
    nullCarriers: tuple = ()
    SpS: int = 2


def hermit(v):
    """Arrange a length-L vector with Hermitian symmetry (ofdm.py:21).

    Output has length 2L+2: [0, v, 0, conj(v[::-1])]; its IFFT is real.
    """
    v = jnp.asarray(v)
    zero = jnp.zeros(v.shape[:-1] + (1,), dtype=v.dtype)
    return jnp.concatenate(
        [zero, v, zero, jnp.conj(v[..., ::-1])], axis=-1
    )


def zero_pad(x, L):
    """Pad ``x`` with ``L`` zeros on both ends (reference ofdm.py:46)."""
    return jnp.pad(jnp.asarray(x), (L, L))


def calc_symbol_rate(M, Rb, nfft, n_pilots, g, hermit_sym):
    """OFDM symbol rate for a bit rate Rb (ofdm.py:71)."""
    n_data = (nfft // 2 - 1 - n_pilots) if hermit_sym else (nfft - n_pilots)
    return Rb / (n_data / (nfft + g) * np.log2(M))


def _carrier_sets(cfg: OFDMConfig):
    ns = cfg.Nfft // 2 - 1 if cfg.hermitSymmetry else cfg.Nfft
    pilots = np.asarray(cfg.pilotCarriers, dtype=np.int64)
    nulls = np.asarray(cfg.nullCarriers, dtype=np.int64)
    data = np.setdiff1d(np.arange(ns), np.union1d(pilots, nulls))
    return ns, pilots, nulls, data


def modulate_ofdm(symb, config: OFDMConfig = OFDMConfig()):
    """OFDM modulator with CP and oversampling (reference ofdm.py:99).

    All frames are assembled and IFFT'd in one batched operation.
    """
    cfg = config
    symb = jnp.asarray(symb)
    ns, pilots, nulls, data = _carrier_sets(cfg)
    ni = ns - len(pilots) - len(nulls)
    n_symb = symb.shape[0]
    if n_symb % ni != 0:
        raise ValueError(
            f"Number of symbols ({n_symb}) is not divisible by number of data "
            f"carriers per OFDM frame ({ni})."
        )
    n_frames = n_symb // ni

    frames = jnp.zeros((n_frames, ns), dtype=jnp.complex64)
    frames = frames.at[:, jnp.asarray(data)].set(symb.reshape(n_frames, ni))
    if len(pilots):
        frames = frames.at[:, jnp.asarray(pilots)].set(cfg.pilot)

    if cfg.hermitSymmetry:
        frames = hermit(frames)

    # zero-pad symmetrically to SpS*Nfft, centered spectrum -> ifftshift -> IFFT
    pad = (cfg.Nfft * (cfg.SpS - 1)) // 2
    frames = jnp.pad(frames, ((0, 0), (pad, pad)))
    time_frames = jnp.fft.ifft(
        jnp.fft.fftshift(frames, axes=-1), axis=-1
    ) * np.sqrt(cfg.SpS * cfg.Nfft)

    # cyclic prefix
    if cfg.G > 0:
        cp = time_frames[:, -cfg.SpS * cfg.G :]
        time_frames = jnp.concatenate([cp, time_frames], axis=-1)
    return time_frames.reshape(-1)


def demodulate_ofdm(sig, config: OFDMConfig = OFDMConfig(), return_channel=False):
    """OFDM demodulator with pilot channel estimation (reference ofdm.py:185).

    Input must be at one sample per symbol (CP + Nfft per frame). Channel
    magnitude/phase estimated at the pilot carriers is linearly interpolated
    (with edge extrapolation) over all carriers and averaged over frames.
    """
    cfg = config
    sig = jnp.asarray(sig)
    ns, pilots, nulls, data = _carrier_sets(cfg)
    n = sig.shape[0]
    if n % (cfg.Nfft + cfg.G) != 0:
        raise ValueError(
            f"Number of received symbols ({n}) is not divisible by Nfft + G "
            f"({cfg.Nfft + cfg.G})."
        )
    n_frames = n // (cfg.Nfft + cfg.G)
    frames = sig.reshape(n_frames, cfg.Nfft + cfg.G)[:, cfg.G :]
    spec = jnp.fft.fftshift(jnp.fft.fft(frames, axis=-1), axes=-1) / np.sqrt(cfg.Nfft)

    if cfg.hermitSymmetry:
        spec = spec[:, 1 : 1 + ns]

    h_chan = None
    if len(pilots):
        h_est = spec[:, jnp.asarray(pilots)] / cfg.pilot  # (frames, Np)
        h_abs = jnp.mean(jnp.abs(h_est), axis=0)
        h_pha = jnp.mean(jnp.angle(h_est), axis=0)
        carriers = jnp.arange(ns, dtype=jnp.float32)
        xp = jnp.asarray(pilots, dtype=jnp.float32)
        h_abs_i = _interp_extrap(carriers, xp, h_abs)
        h_pha_i = _interp_extrap(carriers, xp, h_pha)
        h_chan = h_abs_i * jnp.exp(1j * h_pha_i)
        spec = spec / h_chan[None, :]

    out = spec[:, jnp.asarray(data)].reshape(-1)
    if return_channel:
        return out, h_chan
    return out


def _interp_extrap(x, xp, fp):
    """Linear interpolation with linear extrapolation at both edges."""
    y = jnp.interp(x, xp, fp)
    if xp.shape[0] < 2:
        return y
    slope_lo = (fp[1] - fp[0]) / (xp[1] - xp[0])
    slope_hi = (fp[-1] - fp[-2]) / (xp[-1] - xp[-2])
    y = jnp.where(x < xp[0], fp[0] + slope_lo * (x - xp[0]), y)
    y = jnp.where(x > xp[-1], fp[-1] + slope_hi * (x - xp[-1]), y)
    return y
