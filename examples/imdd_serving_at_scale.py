"""Batched IM-DD PAM4 serving: B short-reach links through ONE program.

The IM-DD counterpart of `coded_receiver_serve.py`: B independent
25 GBd PAM4 10 km dispersive links (PAM Tx -> fiber CD -> pin photodiode)
are received by :func:`opticommpy_tpu.pipelines.imdd_dsp_chain_batch` —
DC removal, symbol-rate sampling, per-row normalization and ALL B
decision-feedback equalizer recurrences (one vmapped XLA scan), BER computed
in-jit. Mirrors the reference IM-DD
workload (tx.py:231, equalization.py:1176,
test_equalizers_for_IMDD_transmission.ipynb) at serving scale, which the
reference's per-signal Numba loop cannot batch.

The same chain at B=8, 2^16 symbols each, is bench.py's
imdd_chain_Msym_per_s_b8 row (error-free past the training region).

Usage: python examples/imdd_serving_at_scale.py [--cpu] [--signals N]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.argv.remove("--cpu")

n_signals = 8
if "--signals" in sys.argv:
    i = sys.argv.index("--signals")
    n_signals = int(sys.argv[i + 1])
    del sys.argv[i : i + 2]

import jax
import jax.numpy as jnp
import numpy as np

from opticommpy_tpu.comm.metrics import fast_ber_calc
from opticommpy_tpu.models import (LinearFiberConfig, PhotodiodeConfig,
                                   linear_fiber_channel, photodiode)
from opticommpy_tpu.models.tx import PAMTxConfig, pam_transmitter
from opticommpy_tpu.ops import pnorm
from opticommpy_tpu.pipelines import IMDDConfig, imdd_dsp_chain_batch

FAST = os.environ.get("OPTICOMMPY_FAST") == "1"
N_SYM = 2**13 if FAST else 2**16


def main():
    cfg_tx = PAMTxConfig(M=4, Rs=25e9, SpS=8, nBits=2 * N_SYM,
                         pulseType="nrz", power=3.0)
    fs = cfg_tx.Fs
    cfg = IMDDConfig(SpS_in=8, nTapsFF=15, nTapsFB=5, mu=2e-3,
                     nTrain=min(8000, N_SYM // 4))

    @jax.jit
    def synth(key):
        def one(k):
            k_tx, k_pd = jax.random.split(k)
            sig, symb = pam_transmitter(k_tx, cfg_tx)
            rx = linear_fiber_channel(
                sig, LinearFiberConfig(L=10, alpha=0.2, D=17, Fs=fs))
            i_rx = photodiode(rx, PhotodiodeConfig(Fs=fs, B=20e9), k_pd)
            return i_rx.astype(jnp.float32), symb.real.astype(jnp.float32)

        return jax.vmap(one)(jax.random.split(key, n_signals))

    i_b, ref_b = synth(jax.random.PRNGKey(5))
    print(f"{n_signals} PAM4 links x {N_SYM} symbols "
          f"({i_b.shape[1]} samples each)")

    @jax.jit
    def serve(i, r):
        y, mse = imdd_dsp_chain_batch(i, r, cfg)
        ref_n = jax.vmap(pnorm)(r)
        post = 2 * cfg.nTrain
        bers = jax.vmap(lambda yy, rr: fast_ber_calc(
            yy.real, rr, 4, "pam")[0][0])(y[:, post:], ref_n[:, post:])
        return bers, jnp.mean(mse[:, -2000:], axis=1)

    bers, mses = serve(i_b, ref_b)  # compile
    t0 = time.perf_counter()
    bers, mses = serve(i_b, ref_b)
    bers = np.asarray(bers)
    dt = time.perf_counter() - t0
    print(f"one dispatch: {dt * 1e3:.1f} ms -> "
          f"{n_signals * N_SYM / dt / 1e6:.2f} Msym/s aggregate")
    for k in range(n_signals):
        print(f"  link {k}: BER={bers[k]:.2e}  tail MSE={float(mses[k]):.4f}")
    assert bers.max() < 1e-2, "equalization failed"


if __name__ == "__main__":
    main()
