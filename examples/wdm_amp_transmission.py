"""WDM transmission with the physical (Giles) EDFA amplifying each span.

JAX analog of the reference example ``test_WDM_amp_transmission.ipynb``:
3-channel polmux 16-QAM WDM -> per span {Manakov SSFM (amp='none') on device,
stateful Giles EDFA with AGC on host} -> coherent detection of the center
channel -> full DSP chain -> BER/SNR/GMI. The split mirrors the reference
architecture: nonlinear propagation is the hot loop (jitted SSFM,
channels.py:252); the EDFA BVP solver (amplification.py:420) is a host-side
control problem run once per span.

Usage: python examples/wdm_amp_transmission.py [--cpu]
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
from opticommpy_tpu.models.amplification import EDFASMConfig, edfa_sm
from opticommpy_tpu.models.tx import WDMTxConfig, simple_wdm_tx
from opticommpy_tpu.ops import (
    decimate,
    fir_filter,
    lowpass_fir,
    pnorm,
    pulse_shape,
    symbol_sync,
)

FC = 193.1e12
N_SPANS = 3
L_SPAN = 50.0


def main():
    key = jax.random.PRNGKey(11)
    k_tx, k_lo, k_rx = jax.random.split(key, 3)

    cfg_tx = WDMTxConfig(
        M=16, Rs=32e9, SpS=8, nBits=2**14, nChannels=3, nPolModes=2,
        nFilterTaps=1024, pulseRollOff=0.01, powerPerChannel=(-2.0,),
        laserLinewidth=100e3, wdmGridSpacing=50e9,
    )
    fs = cfg_tx.Fs
    sig, symb_tx, grid = simple_wdm_tx(k_tx, cfg_tx)
    print(f"Tx: {cfg_tx.nChannels}-ch WDM, {sig.shape[0]} samples "
          f"@ {fs/1e9:.0f} GHz")

    # one span of fiber, no inline amplification (loss stays in the field)
    cfg_span = SSFMConfig(Ltotal=L_SPAN, Lspan=L_SPAN, alpha=0.2, D=16,
                          gamma=1.3, Fs=fs, amp="none", nlprMethod=True,
                          maxNlinPhaseRot=2e-2)
    span = jax.jit(lambda e: manakov_ssf(e, cfg_span))

    # physical EDFA restoring the 10 dB span loss via AGC pump control
    cfg_edfa = EDFASMConfig(type="AGC", value=cfg_span.alpha * L_SPAN,
                            lngth=8.0, forPumpW=(60e-3,), bckPumpW=(0.0,),
                            noiseBand=100e9, tolCtrl=0.5)

    for n in range(N_SPANS):
        t0 = time.time()
        sig = span(sig)
        t_ssfm = time.time() - t0
        t0 = time.time()
        amplified, ppf, _, _ = edfa_sm(np.asarray(sig), fs, FC, cfg_edfa,
                                       rng=np.random.default_rng(n))
        gain = 10 * np.log10(np.mean(np.abs(amplified) ** 2)
                             / np.mean(np.abs(np.asarray(sig)) ** 2))
        sig = jnp.asarray(amplified.astype(np.complex64))
        print(f"span {n+1}: SSFM {t_ssfm:.1f}s | Giles EDFA "
              f"{time.time()-t0:.1f}s, gain {gain:.2f} dB, "
              f"pump {1e3*float(np.ravel(ppf)[0]):.1f} mW")

    # --- coherent detection of the center channel --------------------------
    center = cfg_tx.nChannels // 2
    lo = basic_laser_model(
        LaserConfig(P=10.0, lw=100e3, Ns=sig.shape[0], Fs=fs,
                    freqShift=float(grid[center]) + 80e6, RIN_var=0.0), k_lo)
    rx = pdm_coherent_receiver(sig, lo, PDMFrontendConfig(Fs=fs), key=k_rx)
    rx = fir_filter(jnp.asarray(lowpass_fir(0.6 * cfg_tx.Rs, fs, 501)), rx)

    pulse = jnp.asarray(pulse_shape("rrc", cfg_tx.SpS, 1024,
                                    cfg_tx.pulseRollOff))
    mf = fir_filter(pulse, rx)
    dec = decimate(mf, cfg_tx.SpS, 2)
    cd = edc(dec, EDCConfig(L=N_SPANS * L_SPAN, D=16, Fs=2 * cfg_tx.Rs,
                            Rs=cfg_tx.Rs))
    d_ref = pnorm(symbol_sync(cd, symb_tx[:, :, center], 2))
    n_sym = d_ref.shape[0]
    n_train = min(2000, n_sym // 2)
    y = mimo_adapt_equalizer(
        pnorm(cd),
        MIMOEqualizerConfig(nTaps=15, SpS=2, mu=(5e-3, 2e-3),
                            alg=("da-rde", "dd-lms"),
                            L=(n_train, n_sym - n_train), M=16, numIter=2),
        symb_ref=d_ref,
    )
    y = cpr(y, CPRConfig(alg="bps", M=16, N=35, B=64, Ts=1 / cfg_tx.Rs))

    disc = n_train + 500
    y, d = y[disc:-64], d_ref[disc:-64]
    ber, _, snr = fast_ber_calc(y, d, 16, "qam")
    gmi, ngmi = monte_carlo_gmi(y, d, 16, "qam")
    print(f"center channel after {N_SPANS*L_SPAN:.0f} km w/ Giles EDFAs:")
    print(f"  BER = {np.asarray(ber)}")
    print(f"  SNR = {np.asarray(snr)} dB")
    print(f"  GMI = {np.asarray(gmi)} bits (NGMI {np.asarray(ngmi)})")


if __name__ == "__main__":
    main()
