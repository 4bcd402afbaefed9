"""Complete coded coherent receiver in ONE program: DSP + LLR + DVB-S2 FEC.

`coherent_coded_serve` traces the whole steady-state receive path into a
single XLA program: the fused LTI front end (matched filter + CD
compensation + pnorm + frozen MIMO taps as one decimating frequency-domain
filter), BPS carrier recovery with the batch folded into the mode axis, the
bit-LLR contraction, and quasi-cyclic LDPC belief propagation. The reference runs these stages
eagerly across notebook cells (test_WDM_transmission.ipynb +
test_fec.ipynb); here one dispatch decodes every codeword of the batch.

A k*pi/2 blind-CPR phase ambiguity is resolved against a short pilot
block per (signal, mode).

At full size, 8 polmux-16QAM signals x 65536 symbols -> 64 DVB-S2 64800b
R4/5 codewords in one dispatch (``chip_smoke.py`` stage 5 runs and checks
the same path). The time of the dispatch and the extra time to pull the
(64800, 64) decoded-bit matrix to the host are both printed; the
production pattern keeps decisions on the device (or transfers packed
bits).

Usage: python examples/coded_receiver_serve.py [--cpu] [--signals N]
"""

import os
import sys

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

import numpy as np

import jax
import jax.numpy as jnp

from opticommpy_tpu.comm.fec import LDPCConfig, encode_ldpc, standard_ldpc
from opticommpy_tpu.ops.filtering import fir_filter, pulse_shape
from opticommpy_tpu.ops.signal import upsample
from opticommpy_tpu.pipelines import CoherentDSPConfig, coherent_coded_serve

FAST = os.environ.get("OPTICOMMPY_FAST") == "1"


def main():
    rng = np.random.default_rng(1)
    if FAST:
        # CI size: one 802.11n 1944b codeword per signal
        from opticommpy_tpu.comm.codes import ldpc_parity_matrix
        from opticommpy_tpu.comm.fec import ldpc_graph, par2gen, triang_p1p2

        H = ldpc_parity_matrix(mode="IEEE_802.11nD2", n=1944, R="1/2")
        P1, P2, Hm = triang_p1p2(H)
        if P1 is not None:
            enc = lambda b: encode_ldpc(b, H=Hm, P1=P1, P2=P2,
                                        config=LDPCConfig(mode="triang"))
        else:
            G, _, Hm = par2gen(H)
            enc = lambda b: encode_ldpc(b, H=Hm, G=G,
                                        config=LDPCConfig(mode="G"))
        graph = ldpc_graph(Hm)
        n_code, k_code = 1944, 972
        B, n_sym = 1, 256
    else:
        # DVB-S2 64800b R4/5: B polmux signals x 2^16 symbols = 8B codewords
        graph, edges = standard_ldpc("DVBS2", 64800, "4/5")
        enc = lambda b: encode_ldpc(b, edges=edges)
        n_code, k_code = 64800, 51840
        B, n_sym = n_signals, 2**16
    modes, bps = 2, 4  # polmux 16QAM
    nbits = n_sym * modes * bps
    ncw = nbits // n_code
    print(f"{B} signals x {n_sym} syms -> {B * ncw} codewords of {n_code}b")

    msg = rng.integers(0, 2, size=(k_code, B * ncw)).astype(np.int8)
    cw = np.asarray(enc(jnp.asarray(msg)))
    sps, taps = 2, 257
    pulse = jnp.asarray(pulse_shape("rrc", sps, taps, 0.01))
    from opticommpy_tpu.backend import implementation
    from opticommpy_tpu.comm.modulation import gray_mapping

    const_np = np.asarray(gray_mapping(16, "qam"))
    weights = 1 << np.arange(bps - 1, -1, -1)
    grids = []
    for b in range(B):
        stream = np.concatenate([
            cw[:, b * ncw:(b + 1) * ncw].T.reshape(-1),
            rng.integers(0, 2, size=nbits - ncw * n_code)])
        syms = const_np[(stream.reshape(-1, bps) * weights).sum(1)]
        grids.append(syms.reshape(modes, n_sym).T)
    grids = np.stack(grids).astype(np.complex64)

    w = np.asarray(jax.jit(jax.vmap(
        lambda x: fir_filter(pulse, upsample(x, sps))))(jnp.asarray(grids)))
    wav = (w + 0.05 * (rng.normal(size=w.shape) + 1j * rng.normal(
        size=w.shape))).astype(np.complex64)

    Hb = np.zeros((B, 2, 2, 15), np.complex64)
    Hb[:, 0, 0, 7] = Hb[:, 1, 1, 7] = 1
    cfg = CoherentDSPConfig(nFilterTaps=taps, L=0.5, cpr_window=33,
                            cpr_phases=32, M=16)
    # earlyExit: the reference decoder's break-on-parity serving loop,
    # taken where compiled device code runs (the platform table); off for
    # the CPU smoke run, where the while_loop variant compiles for minutes
    fcfg = LDPCConfig(maxIter=20, alg="NMSA", msgDtype="bf16",
                      earlyExit=implementation() == "kernel")
    pil = (grids[:, :64] / np.sqrt(np.mean(np.abs(grids) ** 2))).astype(
        np.complex64)

    @jax.jit
    def run(w, h, p):
        bits, fail, _ = coherent_coded_serve(
            w, h, cfg, 0.02, fec_graph=graph, fec_config=fcfg, pilot_grid=p)
        return bits, fail

    args = tuple(jnp.asarray(a) for a in (wav, Hb, pil))
    import time
    t0 = time.perf_counter()
    jax.block_until_ready(run(*args))
    print(f"compile+run {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    jax.block_until_ready(run(*args))  # the device computation alone
    dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    bits, fail = jax.tree.map(np.asarray, run(*args))
    dt_dl = time.perf_counter() - t0
    n_info = k_code * bits.shape[1]
    print(f"one dispatch: {dt * 1e3:.1f} ms -> "
          f"{B * n_sym / dt / 1e6:.2f} Msym/s, "
          f"{n_info / dt / 1e6:.1f} Mbit/s information throughput "
          f"(+{(dt_dl - dt) * 1e3:.0f} ms if the full bit matrix is "
          f"pulled to the host)")
    # codewords away from filter edge transients must be error-free
    errs = (bits != cw).sum(axis=0)
    print("frame fails:", int(fail.sum()), "/", bits.shape[1],
          "| bit errors per codeword (first 8):", errs[:8].tolist())


if __name__ == "__main__":
    main()
