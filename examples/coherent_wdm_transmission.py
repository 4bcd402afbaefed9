"""Coherent 16-QAM polmux over the nonlinear Manakov channel, full DSP chain.

JAX analog of the reference ``test_WDM_transmission.ipynb`` flagship
workload (BASELINE.json config 3): WDM Tx -> Manakov SSFM + EDFAs -> PDM
coherent receiver -> matched filter -> decimation -> EDC -> sync -> MIMO
adaptive EQ -> BPS carrier recovery -> BER/GMI/EVM. Saves ``wdm_const.png``.

Usage: python examples/coherent_wdm_transmission.py [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import sys
import time

if "--cpu" in sys.argv:
    import os

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax
import jax.numpy as jnp
import numpy as np

from opticommpy_tpu.comm.metrics import calc_evm, fast_ber_calc, monte_carlo_gmi
from opticommpy_tpu.dsp import (
    CPRConfig,
    EDCConfig,
    MIMOEqualizerConfig,
    cpr,
    edc,
    mimo_adapt_equalizer,
)
from opticommpy_tpu.models import (
    LaserConfig,
    PDMFrontendConfig,
    SSFMConfig,
    basic_laser_model,
    manakov_ssf,
    pdm_coherent_receiver,
)
from opticommpy_tpu.models.tx import WDMTxConfig, simple_wdm_tx
from opticommpy_tpu.ops import decimate, fir_filter, pnorm, pulse_shape, symbol_sync
from opticommpy_tpu.plot import pconst


def main():
    key = jax.random.PRNGKey(7)
    k_tx, k_ch, k_lo, k_rx = jax.random.split(key, 4)

    cfg_tx = WDMTxConfig(M=16, Rs=32e9, SpS=8, nBits=2**17, nChannels=1,
                         nPolModes=2, nFilterTaps=1024, pulseRollOff=0.01,
                         powerPerChannel=(1.0,), laserLinewidth=100e3)
    fs = cfg_tx.Fs
    t0 = time.time()
    sig_tx, symb_tx, _ = simple_wdm_tx(k_tx, cfg_tx)
    print(f"Tx: {sig_tx.shape} in {time.time()-t0:.1f}s")

    cfg_ch = SSFMConfig(Ltotal=400, Lspan=50, alpha=0.2, D=16, gamma=1.3,
                        Fs=fs, amp="edfa", NF=4.5, nlprMethod=True)
    t0 = time.time()
    sig_ch = manakov_ssf(sig_tx, cfg_ch, k_ch)
    sig_ch.block_until_ready()
    print(f"Manakov SSFM 400 km: {time.time()-t0:.1f}s")

    lo = basic_laser_model(
        LaserConfig(P=10.0, lw=100e3, Ns=sig_ch.shape[0], Fs=fs,
                    freqShift=150e6, RIN_var=0.0), k_lo)
    sig_rx = pdm_coherent_receiver(sig_ch, lo, PDMFrontendConfig(Fs=fs), key=k_rx)

    t0 = time.time()
    pulse = jnp.asarray(pulse_shape("rrc", cfg_tx.SpS, 1024, cfg_tx.pulseRollOff))
    sig_mf = fir_filter(pulse, sig_rx)
    sig_dec = decimate(sig_mf, cfg_tx.SpS, 2)
    sig_cd = edc(sig_dec, EDCConfig(L=400, D=16, Fs=2 * 32e9, Rs=32e9))
    d_ref = pnorm(symbol_sync(sig_cd, symb_tx[:, :, 0], 2))
    n_sym = d_ref.shape[0]
    n_train = 12000
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
    ber, ser, snr = fast_ber_calc(y, d, 16, "qam")
    gmi, ngmi = monte_carlo_gmi(y, d, 16, "qam")
    evm = calc_evm(y, 16, "qam", symb_tx=d)
    print(f"BER  = {np.asarray(ber)}")
    print(f"SNR  = {np.asarray(snr)} dB")
    print(f"GMI  = {np.asarray(gmi)} bits  (NGMI {np.asarray(ngmi)})")
    print(f"EVM  = {100 * np.asarray(evm)} %")

    ax = pconst(np.asarray(y), density=True)
    ax.figure.savefig("wdm_const.png", dpi=120, bbox_inches="tight")
    print("saved wdm_const.png")


if __name__ == "__main__":
    main()
