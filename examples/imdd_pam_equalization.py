"""4-PAM IM-DD link with FFE/DFE equalization (BASELINE config 2).

JAX analog of the reference ``test_equalizers_for_IMDD_transmission``
workflow: PAM4 Tx -> dispersive fiber -> pin photodiode -> FFE vs DFE.

Usage: python examples/imdd_pam_equalization.py [--cpu]
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

from opticommpy_tpu.dsp import DFEConfig, FFEConfig, dfe, ffe
from opticommpy_tpu.models import LinearFiberConfig, PhotodiodeConfig, linear_fiber_channel, photodiode
from opticommpy_tpu.models.tx import PAMTxConfig, pam_transmitter
from opticommpy_tpu.ops import pnorm


def main():
    key = jax.random.PRNGKey(3)
    k_tx, k_pd = jax.random.split(key)

    cfg_tx = PAMTxConfig(M=4, Rs=25e9, SpS=8, nBits=2**16, pulseType="nrz",
                         power=3.0)
    fs = cfg_tx.Fs
    sig, symb = pam_transmitter(k_tx, cfg_tx)
    print(f"PAM4 Tx: {sig.shape}")

    # dispersive short-reach link: CD creates ISI after direct detection
    rx = linear_fiber_channel(sig, LinearFiberConfig(L=10, alpha=0.2, D=17, Fs=fs))
    i_rx = photodiode(rx, PhotodiodeConfig(Fs=fs, B=20e9), k_pd)

    # sample at symbol rate, normalize
    samples = pnorm(i_rx[0 :: cfg_tx.SpS][: cfg_tx.nSymbols] - jnp.mean(i_rx))
    ref = pnorm(symb)

    n_train = 8000
    y_ffe, _, mse_ffe = ffe(samples, ref,
                            FFEConfig(nTaps=15, mu=2e-3, nTrain=n_train, M=4,
                                      constType="pam", trainingMode="fulltime"))
    y_dfe, _, _, mse_dfe = dfe(samples, ref,
                               DFEConfig(nTapsFF=15, nTapsFB=5, mu=2e-3,
                                         nTrain=n_train, M=4, constType="pam",
                                         trainingMode="fulltime"))
    tail = slice(-20000, None)
    print(f"FFE steady-state MSE: {float(jnp.mean(mse_ffe[tail])):.4f}")
    print(f"DFE steady-state MSE: {float(jnp.mean(mse_dfe[tail])):.4f}")


if __name__ == "__main__":
    main()
