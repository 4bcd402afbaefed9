"""11-channel WDM polmux 16-QAM over a multi-span EDFA link (north-star workload).

JAX analog of the reference ``test_WDM_amp_transmission`` workflow at
the BASELINE.json scale: 11 channels on a 50 GHz grid, Manakov propagation,
center-channel coherent detection, full DSP chain, GMI/NGMI per polarization.

Usage: python examples/wdm_11ch_transmission.py [--cpu] [--small]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

import time

import jax
import jax.numpy as jnp
import numpy as np

from opticommpy_tpu.comm.metrics import fast_ber_calc, monte_carlo_gmi
from opticommpy_tpu.dsp import CPRConfig, EDCConfig, MIMOEqualizerConfig, cpr, edc, mimo_adapt_equalizer
from opticommpy_tpu.models import (
    LaserConfig,
    PDMFrontendConfig,
    SSFMConfig,
    basic_laser_model,
    manakov_ssf,
    pdm_coherent_receiver,
)
from opticommpy_tpu.models.tx import WDMTxConfig, simple_wdm_tx
from opticommpy_tpu.ops import decimate, fir_filter, lowpass_fir, pnorm, pulse_shape, symbol_sync

SMALL = ("--small" in sys.argv
         or os.environ.get("OPTICOMMPY_FAST") == "1")


def main():
    key = jax.random.PRNGKey(5)
    k_tx, k_ch, k_lo, k_rx = jax.random.split(key, 4)

    n_bits = 2**15 if SMALL else 2**17
    cfg_tx = WDMTxConfig(
        M=16, Rs=32e9, SpS=16, nBits=n_bits, nChannels=11, nPolModes=2,
        nFilterTaps=1024, pulseRollOff=0.01, powerPerChannel=(-2.0,),
        laserLinewidth=100e3, wdmGridSpacing=50e9,
    )
    fs = cfg_tx.Fs  # 512 GHz aggregate simulation bandwidth
    t0 = time.time()
    sig_tx, symb_tx, grid = simple_wdm_tx(k_tx, cfg_tx)
    print(f"Tx 11-ch WDM: {sig_tx.shape} samples @ {fs/1e9:.0f} GHz "
          f"({time.time()-t0:.1f}s)")

    cfg_ch = SSFMConfig(
        Ltotal=300 if SMALL else 500, Lspan=50, alpha=0.2, D=16, gamma=1.3,
        Fs=fs, amp="edfa", NF=4.5, nlprMethod=True, maxNlinPhaseRot=2e-2,
    )
    t0 = time.time()
    sig_ch = manakov_ssf(sig_tx, cfg_ch, k_ch)
    sig_ch.block_until_ready()
    print(f"Manakov SSFM {cfg_ch.Ltotal:.0f} km: {time.time()-t0:.1f}s")

    # center-channel coherent detection
    center = cfg_tx.nChannels // 2
    lo = basic_laser_model(
        LaserConfig(P=10.0, lw=100e3, Ns=sig_ch.shape[0], Fs=fs,
                    freqShift=float(grid[center]) + 80e6, RIN_var=0.0), k_lo)
    sig_rx = pdm_coherent_receiver(sig_ch, lo, PDMFrontendConfig(Fs=fs), key=k_rx)
    sig_rx = fir_filter(jnp.asarray(lowpass_fir(0.6 * cfg_tx.Rs, fs, 501)), sig_rx)

    t0 = time.time()
    pulse = jnp.asarray(pulse_shape("rrc", cfg_tx.SpS, 1024, cfg_tx.pulseRollOff))
    sig_mf = fir_filter(pulse, sig_rx)
    sig_dec = decimate(sig_mf, cfg_tx.SpS, 2)
    sig_cd = edc(sig_dec, EDCConfig(L=cfg_ch.Ltotal, D=16, Fs=2 * 32e9, Rs=32e9))
    d_ref = pnorm(symbol_sync(sig_cd, symb_tx[:, :, center], 2))
    n_sym = d_ref.shape[0]
    n_train = min(12000, n_sym // 2)
    y_eq = mimo_adapt_equalizer(
        pnorm(sig_cd),
        MIMOEqualizerConfig(nTaps=15, SpS=2, mu=(5e-3, 2e-3),
                            alg=("da-rde", "dd-lms"),
                            L=(n_train, n_sym - n_train), M=16, numIter=2),
        symb_ref=d_ref,
    )
    y = cpr(y_eq, CPRConfig(alg="bps", M=16, N=75, B=64, Ts=1 / 32e9))
    print(f"DSP chain: {time.time()-t0:.1f}s")

    disc = n_train + 2000
    y, d = y[disc:-100], d_ref[disc:-100]
    ber, _, snr = fast_ber_calc(y, d, 16, "qam")
    gmi, ngmi = monte_carlo_gmi(y, d, 16, "qam")
    print(f"center channel BER  = {np.asarray(ber)}")
    print(f"center channel SNR  = {np.asarray(snr)} dB")
    print(f"center channel GMI  = {np.asarray(gmi)} bits (NGMI {np.asarray(ngmi)})")


if __name__ == "__main__":
    main()
