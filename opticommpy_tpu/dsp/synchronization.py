"""Sequence synchronization: align Tx references to received signals.

Counterpart of reference ``optic/dsp/synchronization.py``
(syncDataSequences, synchronization.py:30): tiles/pads the reference to the
received length, runs the cross-correlation symbol synchronizer, and
regenerates the reference waveform ('symbols' mode) or re-detects symbols
('signal' mode).
"""

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from opticommpy_tpu.comm.modulation import detector, gray_mapping
from opticommpy_tpu.ops.filtering import fir_filter, pulse_shape
from opticommpy_tpu.ops.signal import decimate, pnorm, resample, symbol_sync, upsample

__all__ = ["SyncConfig", "sync_data_sequences"]


@dataclass(frozen=True)
class SyncConfig:
    """Synchronization parameters (synchronization.py:66-74 defaults)."""

    SpS: int = 1
    reference: str = "signal"  # 'signal' | 'symbols'
    syncMode: str = "amp"  # 'amp' | 'real'
    pulseType: str = "rrc"
    rollOff: float = 0.01
    nFilterTaps: int = 1024
    constType: str = "pam"
    M: int = 4


def sync_data_sequences(rx, tx, config: SyncConfig = SyncConfig()):
    """Synchronize the transmitted reference to the received signal.

    Returns (tx_synced, symbols): the aligned reference waveform and the
    corresponding symbol sequence (extracted or re-detected, matching
    reference synchronization.py:118-152).
    """
    cfg = config
    rx = jnp.asarray(rx)
    tx = jnp.asarray(tx)
    squeeze = rx.ndim == 1
    if squeeze:
        rx = rx[:, None]
    if tx.ndim == 1:
        tx = tx[:, None]

    pulse = jnp.asarray(
        pulse_shape(cfg.pulseType, cfg.SpS, cfg.nFilterTaps, cfg.rollOff)
    )

    if cfg.reference == "symbols":
        tx = upsample(tx, cfg.SpS)

    repeats = int(np.ceil(rx.shape[0] / tx.shape[0]))
    tx_t = jnp.tile(tx, (repeats, 1))
    pad_l = tx_t.shape[0] - rx.shape[0]
    if pad_l > 0:
        rx = jnp.pad(rx, ((0, pad_l), (0, 0)))

    tx_s = symbol_sync(rx, tx_t, 1, mode=cfg.syncMode)
    tx_s = tx_s[: rx.shape[0] - max(pad_l, 0)]

    if cfg.reference == "symbols":
        n_symb = tx_s.shape[0] // cfg.SpS + 1
        symb_cols = []
        for k in range(tx_s.shape[1]):
            col = tx_s[:, k]
            nz = jnp.asarray(np.flatnonzero(np.asarray(col) != 0))
            out = pnorm(col[nz])
            padded = jnp.zeros(n_symb, dtype=col.dtype).at[: out.shape[0]].set(out)
            symb_cols.append(padded)
        symb = jnp.stack(symb_cols, axis=1)
        tx_s = pnorm(fir_filter(pulse, tx_s))
    else:
        # resample to a fine grid then decimate at max-variance phase
        fine_sps = 41
        x = resample(tx_s, cfg.SpS, fine_sps)
        n_symb = x.shape[0] // fine_sps
        symb = decimate(x[: n_symb * fine_sps], fine_sps, 1)
        const = pnorm(jnp.asarray(gray_mapping(cfg.M, cfg.constType)))
        shape = symb.shape
        dec, _ = detector(pnorm(symb.reshape(-1)), 1e-4, const, rule="ML")
        symb = pnorm(dec.reshape(shape))

    if squeeze:
        tx_s = tx_s[:, 0]
    return tx_s, symb
