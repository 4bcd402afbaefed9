"""LDPC-coded 16-QAM over AWGN: coded vs uncoded BER.

JAX analog of the reference ``test_fec.ipynb``: encode with a
(3,6)-regular LDPC code (or the IEEE 802.11n 648b matrix if a path is given),
map to 16-QAM, add noise, compute LLRs, and decode with belief propagation.

Usage: python examples/ldpc_coded_qam.py [--cpu] [alist_path]
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
    sys.argv.remove("--cpu")

import jax.numpy as jnp
import numpy as np

from opticommpy_tpu.comm.fec import (
    LDPCConfig,
    decode_ldpc,
    encode_ldpc,
    gallager_ldpc,
    ldpc_graph,
    par2gen,
    read_alist,
)
from opticommpy_tpu.comm.metrics import calc_llr
from opticommpy_tpu.comm.modulation import bit_map, gray_mapping, modulate_gray
from opticommpy_tpu.ops import gaussian_complex_noise
import jax


def main():
    if len(sys.argv) > 1:
        H = read_alist(sys.argv[1])
        print(f"loaded ALIST H {H.shape}")
    else:
        H = gallager_ldpc(1200, 3, 6, seed=1)
        print(f"Gallager (3,6) H {H.shape}")
    G, _, Hm = par2gen(H)
    k, n = G.shape
    graph = ldpc_graph(Hm)

    M = 16
    b = 4
    const = gray_mapping(M, "qam")
    es = np.mean(np.abs(const) ** 2)
    const_n = jnp.asarray(const / np.sqrt(es))
    bmap = bit_map(M, "qam")

    rng = np.random.default_rng(0)
    n_cw = 16
    bits = rng.integers(0, 2, size=(k, n_cw))
    cw = np.asarray(encode_ldpc(jnp.asarray(bits), H=Hm,
                                config=LDPCConfig(mode="G"), G=G))

    print(f"{'SNR':>5} {'uncoded BER':>12} {'coded BER':>12} {'frame fails':>12}")
    for snr_db in [6.0, 7.0, 8.0, 9.0]:
        noise_var = 10 ** (-snr_db / 10)
        # modulate each codeword column (pad bits to a multiple of b)
        pad = (-cw.shape[0]) % b
        cw_pad = np.vstack([cw, np.zeros((pad, n_cw), dtype=cw.dtype)])
        tx = modulate_gray(jnp.asarray(cw_pad.T.reshape(-1)), M, "qam") / np.sqrt(es)
        key = jax.random.PRNGKey(int(snr_db * 10))
        rx = tx + gaussian_complex_noise(key, tx.shape, noise_var)
        llr = calc_llr(rx, noise_var, const_n, bmap, jnp.ones(M) / M)
        llr = np.asarray(llr).reshape(n_cw, -1).T[: cw.shape[0]]
        raw_ber = np.mean((np.asarray(llr) < 0).astype(int) != cw)
        dec, _, fail = decode_ldpc(jnp.asarray(llr), graph=graph,
                                   config=LDPCConfig(maxIter=30))
        coded_ber = np.mean(np.asarray(dec) != cw)
        print(f"{snr_db:5.1f} {raw_ber:12.2e} {coded_ber:12.2e} "
              f"{int(np.sum(np.asarray(fail))):12d}")


if __name__ == "__main__":
    main()
