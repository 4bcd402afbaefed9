"""Auxiliary benchmark: LDPC belief-propagation decode throughput (Mbit/s).

Decodes batches of AWGN-corrupted all-zero codewords with the padded
edge-array BP decoder (comm/fec.py) at 20 iterations — the analog of the
reference's `test_fec.ipynb` workload, run as one jitted program per
(code, algorithm) — and the DVB-S2 / 802.11n / AR4JA codes through the
roll-based XLA decoders (comm/fec_qc.py, comm/fec_lift.py).

Prints one JSON line per configuration. Not invoked by the driver (bench.py
is the headline); run manually: ``python bench_fec.py [--lift |
--early-exit]`` (``JAX_PLATFORMS=cpu`` for a CPU run).
"""

import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from opticommpy_tpu.comm import fec

BATCH = 128
MAX_ITER = 20


def _make_dec(g, alg, msg_dtype=jnp.float32):
    """One jitted decode closure over the degree-bucketed graph arrays."""
    bk = g["bk"]
    cn_var = tuple(jnp.asarray(a) for a in bk["cn_var"])
    vn_edge = tuple(jnp.asarray(a) for a in bk["vn_edge"])
    vn_var = tuple(jnp.asarray(a) for a in bk["vn_var"])
    var_pos = jnp.asarray(bk["var_pos"])

    @jax.jit
    def dec(llrs):
        out, iters, fail = fec._bp_decode_bucketed_batch(
            llrs, cn_var, vn_edge, vn_var, var_pos, MAX_ITER, alg,
            msg_dtype)
        return (jnp.mean(out) + jnp.sum(iters).astype(jnp.float32)
                + jnp.sum(fail))

    return dec


def main():
    rng = np.random.default_rng(0)
    for n_code, dv, dc in [(1296, 3, 6), (16200, 3, 6)]:
        H = fec.gallager_ldpc(n_code, dv, dc, seed=0)
        g = fec.ldpc_graph(H)
        llrs = jnp.asarray(
            (2.0 + rng.normal(scale=1.2, size=(n_code, BATCH))).astype(np.float32)
        )
        for alg in ("MSA", "SPA"):
            dec = _make_dec(g, alg)
            float(dec(llrs))  # compile
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                float(dec(llrs))
                ts.append(time.perf_counter() - t0)
            print(json.dumps({
                "metric": f"LDPC BP decode ({alg}, n={n_code}, "
                          f"{MAX_ITER} iters, B={BATCH})",
                "value": round(n_code * BATCH / min(ts) / 1e6, 2),
                "unit": "Mbit/s",
            }))

    # full-scale standard code, constructed from the ETSI tables
    # (self-contained; comm/codes.py). decode_ldpc routes DVB-S2 through
    # the quasi-cyclic roll-based decoder (fec_qc) — bench both layouts.
    from opticommpy_tpu.comm import fec_qc

    g, _ = fec.standard_ldpc("DVBS2", 64800, "4/5")
    for b in (128, 256):
        llrs = jnp.asarray(
            (2.0 + rng.normal(scale=1.2, size=(g["n"], b))).astype(np.float32)
        )
        for md, mdname in ((jnp.float32, "f32"), (jnp.bfloat16, "bf16")):
            dec64800 = _make_dec(g, "MSA", md)
            float(dec64800(llrs))
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                float(dec64800(llrs))
                ts.append(time.perf_counter() - t0)
            print(json.dumps({
                "metric": f"LDPC BP decode gather-path (MSA, DVB-S2 n=64800 "
                          f"R4/5, {MAX_ITER} iters, B={b}, msg={mdname})",
                "value": round(g["n"] * b / min(ts) / 1e6, 2),
                "unit": "Mbit/s",
            }))
        for mdname in ("f32", "bf16"):
            qdec = fec_qc.make_qc_decoder(64800, "4/5", MAX_ITER, "MSA",
                                          mdname)

            def qrun(llrs, qdec=qdec):
                out, iters, fail = qdec(llrs)
                return float(jnp.mean(out) + jnp.sum(iters)
                             + jnp.sum(fail))

            qrun(llrs)
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                qrun(llrs)
                ts.append(time.perf_counter() - t0)
            print(json.dumps({
                "metric": f"LDPC BP decode QC-roll path (MSA, DVB-S2 "
                          f"n=64800 R4/5, {MAX_ITER} iters, B={b}, "
                          f"msg={mdname})",
                "value": round(g["n"] * b / min(ts) / 1e6, 2),
                "unit": "Mbit/s",
            }))


def bench_early_exit():
    """Fixed-20 vs early exit at a realistic operating point.

    All-zeros-codeword BPSK/AWGN LLRs at Es/N0 = 2.3 dB (waterfall knee
    + 0.4, FER 0 — codewords converge in ~9-14 of the 20-iteration
    budget), NMSA bf16 — the serving configuration. Decisions are
    bit-identical between the two (tests pin it); only wall time moves.
    """
    from opticommpy_tpu.comm import fec_qc

    rng = np.random.default_rng(5)
    sigma = np.sqrt(0.5 * 10 ** (-2.3 / 10))
    for b in (128, 512, 1024):
        y = 1.0 + sigma * rng.normal(size=(64800, b))
        llrs = jnp.asarray((2 * y / sigma**2).astype(np.float32))
        for label, ee in (("fixed-20", False), ("early-exit", True)):
            dec = fec_qc.make_qc_decoder(64800, "4/5", MAX_ITER, "NMSA",
                                         "bf16", early_exit=ee)

            def run(llrs, dec=dec):
                out, iters, fail = dec(llrs)
                return float(jnp.mean(out) + jnp.sum(iters) + jnp.sum(fail))

            run(llrs)
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                run(llrs)
                ts.append(time.perf_counter() - t0)
            print(json.dumps({
                "metric": f"DVB-S2 R4/5 NMSA-{MAX_ITER} bf16 {label} "
                          f"@ Es/N0 2.3 dB, B={b}",
                "value": round(64800 * b / min(ts) / 1e6, 2),
                "unit": "Mbit/s"}), flush=True)


def bench_lift():
    """802.11n / AR4JA: gather path vs the lifted-circulant roll path."""
    from opticommpy_tpu.comm import fec_lift

    rng = np.random.default_rng(0)
    for mode, n, R in (("IEEE_802.11nD2", 1944, "1/2"),
                       ("AR4JA", 2048, "1/2"), ("AR4JA", 8192, "1/2")):
        g, _ = fec.standard_ldpc(mode, n, R)
        for b in (128, 1024):
            llrs = jnp.asarray((2.0 + rng.normal(
                scale=1.2, size=(g["n"], b))).astype(np.float32))
            dec_g = _make_dec(g, "MSA")
            float(dec_g(llrs))
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                float(dec_g(llrs))
                ts.append(time.perf_counter() - t0)
            # value counts mother-code bits (g[n]*B/t); info_Mbit_per_s
            # counts k*B/t with k = transmitted-n * nominal rate
            # (bench.py's ar4ja key uses info bits; AR4JA's g[n] is the
            # UNpunctured mother code, 1.25x the transmitted length)
            num, den = (int(s) for s in R.split("/"))
            k_info = n * num // den
            print(json.dumps({
                "metric": f"LDPC BP decode gather-path (MSA, {mode} n={n} "
                          f"R{R}, {MAX_ITER} iters, B={b})",
                "value": round(g["n"] * b / min(ts) / 1e6, 2),
                "unit": "coded-Mbit/s",
                "info_Mbit_per_s": round(k_info * b / min(ts) / 1e6,
                                         2)}), flush=True)
            ldec = fec_lift.make_lift_decoder(mode, n, R, MAX_ITER, "MSA",
                                              "bf16")

            def lrun(llrs, ldec=ldec):
                out, iters, fail = ldec(llrs)
                return float(jnp.mean(out) + jnp.sum(iters) + jnp.sum(fail))

            lrun(llrs)
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                lrun(llrs)
                ts.append(time.perf_counter() - t0)
            print(json.dumps({
                "metric": f"LDPC BP decode lift-roll path (MSA, {mode} "
                          f"n={n} R{R}, {MAX_ITER} iters, B={b}, msg=bf16)",
                "value": round(g["n"] * b / min(ts) / 1e6, 2),
                "unit": "coded-Mbit/s",
                "info_Mbit_per_s": round(k_info * b / min(ts) / 1e6,
                                         2)}), flush=True)


if __name__ == "__main__":
    if "--lift" in sys.argv:
        bench_lift()
    elif "--early-exit" in sys.argv:
        bench_early_exit()
    else:
        main()
        bench_lift()
        bench_early_exit()
