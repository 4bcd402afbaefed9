"""Nonlinearity compensation with digital backpropagation (DBP).

JAX analog of the reference ``test_NLC_withDBP_WDM_transmission.ipynb``
(BASELINE.json config 5): a single-channel 16-QAM polmux link propagated with
the Manakov SSFM is received coherently and equalized twice — once with linear
chromatic-dispersion compensation (EDC) and once with Manakov digital
backpropagation (``dsp.manakov_dbp``) — across a launch-power sweep. DBP
removes (deterministic) intra-channel nonlinearity, so its SNR keeps growing
past the EDC curve's nonlinear peak.

Everything per power point runs as one jitted chain; the power sweep is
batched through the SSFM's native batch axis (modelsGPU.py:775 trick).

Usage: python examples/nlc_dbp_transmission.py [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax
import jax.numpy as jnp
import numpy as np

from opticommpy_tpu.comm.metrics import fast_ber_calc
from opticommpy_tpu.dsp import (
    CPRConfig,
    EDCConfig,
    MIMOEqualizerConfig,
    cpr,
    edc,
    manakov_dbp,
    mimo_adapt_equalizer,
)
from opticommpy_tpu.models import SSFMConfig, manakov_ssf
from opticommpy_tpu.models.tx import WDMTxConfig, simple_wdm_tx
from opticommpy_tpu.models.tx import set_power_for_par_ssfm
from opticommpy_tpu.ops import decimate, fir_filter, pnorm, pulse_shape, symbol_sync

M = 16
RS = 32e9
SPS = 8
N_BITS = 2**15
LINK_KM, SPAN_KM = 400.0, 50.0
DISP = 16.0
POWERS_DBM = np.arange(-2.0, 7.0, 2.0)


def dsp_chain(sig_cd, symb_ref, n_train=4000):
    d_ref = pnorm(symbol_sync(sig_cd, symb_ref, 2))
    n_sym = d_ref.shape[0]
    y = mimo_adapt_equalizer(
        pnorm(sig_cd),
        # data-aided NLMS first: it absorbs the constant nonlinear phase
        # rotation (~0.4 rad at 2 dBm) into H, which the phase-blind da-rde
        # cannot, keeping the dd-lms stage's decisions honest pre-CPR
        MIMOEqualizerConfig(nTaps=15, SpS=2, mu=(2e-3, 2e-3),
                            alg=("nlms", "dd-lms"),
                            L=(n_train, n_sym - n_train), M=M, numIter=2),
        symb_ref=d_ref,
    )
    y = cpr(y, CPRConfig(alg="bps", M=M, N=50, B=64, Ts=1 / RS))
    disc = n_train + 1000
    return y[disc:-100], d_ref[disc:-100]


def main():
    key = jax.random.PRNGKey(7)
    k_tx, k_ch = jax.random.split(key)
    cfg_tx = WDMTxConfig(M=M, Rs=RS, SpS=SPS, nBits=N_BITS, nChannels=1,
                         nPolModes=2, nFilterTaps=1024, pulseRollOff=0.01,
                         powerPerChannel=(0.0,), laserLinewidth=0.0)
    fs = cfg_tx.Fs
    sig_tx, symb_tx, _ = simple_wdm_tx(k_tx, cfg_tx)
    symb_ref = symb_tx[:, :, 0]

    # batch all launch powers through one SSFM call (columns = pol pairs)
    sig_batch = jnp.concatenate([sig_tx] * len(POWERS_DBM), axis=1)
    sig_batch = set_power_for_par_ssfm(sig_batch, jnp.asarray(POWERS_DBM))

    cfg_ch = SSFMConfig(Ltotal=LINK_KM, Lspan=SPAN_KM, hz=0.25, alpha=0.2,
                        D=DISP, gamma=1.3, Fs=fs, amp="ideal",
                        nlprMethod=False, trapIters=1, fusedLinear=True)
    sig_rx_all = manakov_ssf(sig_batch, cfg_ch, key=k_ch)

    pulse = jnp.asarray(pulse_shape("rrc", SPS, 1024, 0.01))
    cfg_dbp = SSFMConfig(Ltotal=LINK_KM, Lspan=SPAN_KM, hz=SPAN_KM / 10,
                         alpha=0.2, D=DISP, gamma=1.3, Fs=RS * 2, amp="ideal",
                         nlprMethod=False, trapIters=1, fusedLinear=True)

    from opticommpy_tpu.comm.metrics import monte_carlo_gmi

    print(f"{'P[dBm]':>7} {'SNR_EDC[dB]':>12} {'SNR_DBP[dB]':>12} "
          f"{'BER_EDC':>9} {'BER_DBP':>9}")
    gmi_rows = []
    for i, p_dbm in enumerate(POWERS_DBM):
        sig_rx = sig_rx_all[:, 2 * i:2 * i + 2]
        sig_dec = decimate(fir_filter(pulse, sig_rx), SPS, 2)

        sig_edc = edc(sig_dec, EDCConfig(L=LINK_KM, D=DISP, Fs=2 * RS, Rs=RS))
        # DBP needs the true launch level: each polarization carries half
        # the pair power (set_power_for_par_ssfm semantics)
        sig_dbp = manakov_dbp(sig_dec * jnp.sqrt(
            10 ** (p_dbm / 10) * 1e-3 / 2 / jnp.mean(
                (sig_dec * jnp.conj(sig_dec)).real)), cfg_dbp)

        rows = {}
        for name, sig_cd in (("edc", sig_edc), ("dbp", sig_dbp)):
            y, d = dsp_chain(sig_cd, symb_ref)
            ber, _, snr = fast_ber_calc(y, d, M, "qam")
            rows[name] = (float(jnp.mean(snr)), float(jnp.mean(ber)))
            if name == "dbp":
                gmi, _ = monte_carlo_gmi(y, d, M, "qam")
                gmi_rows.append((p_dbm, float(jnp.mean(gmi))))
        print(f"{p_dbm:7.1f} {rows['edc'][0]:12.2f} {rows['dbp'][0]:12.2f} "
              f"{rows['edc'][1]:9.2e} {rows['dbp'][1]:9.2e}")
    for p_dbm, g in gmi_rows:
        print(f"GMI_DBP {p_dbm:+.1f} dBm = {g:.4f} bits")


if __name__ == "__main__":
    main()
