"""OFDM transmission over a dispersive channel with pilot equalization.

JAX analog of the reference OFDM example workflow: QAM mapping ->
OFDM modulation (CP, pilots) -> linear fiber -> demodulation with pilot
channel estimation -> EVM/BER.

Usage: python examples/ofdm_transmission.py [--cpu]
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

from opticommpy_tpu.comm import modulate_gray
from opticommpy_tpu.comm.metrics import calc_evm, fast_ber_calc
from opticommpy_tpu.comm.ofdm import OFDMConfig, demodulate_ofdm, modulate_ofdm
from opticommpy_tpu.models import AWGNConfig, LinearFiberConfig, awgn, linear_fiber_channel
from opticommpy_tpu.ops import pnorm


def main():
    key = jax.random.PRNGKey(9)
    rng = np.random.default_rng(0)

    nfft, cp = 256, 32
    pilots = tuple(range(0, nfft, 16))
    cfg = OFDMConfig(Nfft=nfft, G=cp, SpS=1, pilotCarriers=pilots)
    ni = nfft - len(pilots)
    n_frames = 100

    M = 16
    bits = rng.integers(0, 2, size=ni * n_frames * 4)
    symb = pnorm(modulate_gray(jnp.asarray(bits), M, "qam"))

    sig = modulate_ofdm(symb, cfg)
    print(f"OFDM signal: {sig.shape[0]} samples "
          f"({n_frames} frames of {nfft}+{cp})")

    fs = 10e9
    rx = linear_fiber_channel(sig, LinearFiberConfig(L=40, alpha=0.0, D=17, Fs=fs))
    rx = awgn(rx, key, AWGNConfig(snr=25.0))

    rec, h_est = demodulate_ofdm(rx, cfg, return_channel=True)
    ber, ser, snr = fast_ber_calc(rec, symb, M, "qam")
    evm = calc_evm(rec, M, "qam", symb_tx=symb)
    print(f"BER = {float(ber[0]):.2e}   SNR = {float(snr[0]):.1f} dB   "
          f"EVM = {100 * float(evm[0]):.2f} %")
    print(f"estimated channel magnitude range: "
          f"{float(jnp.min(jnp.abs(h_est))):.2f} .. {float(jnp.max(jnp.abs(h_est))):.2f}")


if __name__ == "__main__":
    main()
