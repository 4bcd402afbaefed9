"""10G OOK IM-DD link: BER vs received power, measured against theory.

JAX analog of the reference example ``basic_OOK_transmission.ipynb``
(BASELINE.json config 1). Runs on CPU or GPU; saves ``ook_ber.png``.

Usage: python examples/basic_ook_transmission.py [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import sys

if "--cpu" in sys.argv:
    import os

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax
import jax.numpy as jnp
import matplotlib.pyplot as plt
import numpy as np

from opticommpy_tpu.comm import bit_source, modulate_gray
from opticommpy_tpu.comm.metrics import bert
from opticommpy_tpu.models import (
    EDFAConfig,
    LinearFiberConfig,
    MZMConfig,
    PhotodiodeConfig,
    edfa,
    linear_fiber_channel,
    mzm,
    photodiode,
)
from opticommpy_tpu.ops import fir_filter, pulse_shape, upsample
from opticommpy_tpu.utils import dbm2w

SPS, RS = 16, 10e9
FS = RS * SPS
N_BITS = 100_000
PULSE = jnp.asarray(pulse_shape("nrz", SPS))


def ook_link(key, prx_dbm):
    """One jitted OOK link evaluation at received power prx_dbm."""
    kb, ke, kp = jax.random.split(key, 3)
    bits = bit_source(kb, N_BITS)
    symb = modulate_gray(bits, 2, "ook").real.astype(jnp.float32)
    sig = fir_filter(PULSE, upsample(symb, SPS))
    txo = mzm(jnp.ones_like(sig) + 0j, 0.25 * 2 * (2 * sig - 1),
              MZMConfig(Vpi=2.0, Vb=-1.0, ER=60))
    txo = txo * jnp.sqrt(dbm2w(prx_dbm) / jnp.mean(jnp.abs(txo) ** 2))
    rx = linear_fiber_channel(txo, LinearFiberConfig(L=0.1, alpha=0.0, D=17, Fs=FS))
    rx = edfa(rx, EDFAConfig(G=20.0, NF=4.5, Fs=FS), ke)
    irx = photodiode(rx, PhotodiodeConfig(Fs=FS, B=10e9), kp)
    i_sym = (irx / jnp.mean(irx) / 2)[0::SPS][8:-8][: N_BITS - 16]
    return bert(i_sym, bits[8:-8][: N_BITS - 16])


def main():
    link = jax.jit(ook_link)
    powers = np.arange(-34, -21, 1.0)
    bers, qs = [], []
    for i, p in enumerate(powers):
        ber, q = link(jax.random.PRNGKey(i), p)
        bers.append(max(float(ber), 1e-6))
        qs.append(float(q))
        print(f"Prx = {p:5.1f} dBm   BER = {bers[-1]:.2e}   Q = {qs[-1]:.2f} dB")

    fig, ax = plt.subplots(1)
    ax.semilogy(powers, bers, "o-", label="measured")
    ax.set_xlabel("Received power [dBm]")
    ax.set_ylabel("BER")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    fig.savefig("ook_ber.png", dpi=120, bbox_inches="tight")
    print("saved ook_ber.png")


if __name__ == "__main__":
    main()
