"""Tests for FEC: GF(2) algebra, encoders, BP decoders, Hamming, ALIST.

The reference has no FEC tests at all (SURVEY.md §4 coverage gaps) — these
close that gap.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from opticommpy_tpu.comm.fec import (
    LDPCConfig,
    decode_hamming,
    decode_ldpc,
    encode_hamming,
    encode_ldpc,
    gallager_ldpc,
    gauss_elim_gf2,
    hamming_parity_check_matrix,
    inverse_matrix_gf2,
    ldpc_graph,
    par2gen,
    parse_alist,
    read_alist,
    triang_p1p2,
    write_alist,
)

def _check_parity(H, cw):
    return np.all((np.asarray(H, dtype=np.int64) @ np.asarray(cw, dtype=np.int64)) % 2 == 0)


def test_gauss_elim_idempotent_and_gf2():
    rng = np.random.default_rng(0)
    M = rng.integers(0, 2, size=(20, 40)).astype(np.uint8)
    E = gauss_elim_gf2(M)
    assert set(np.unique(E)) <= {0, 1}
    # row space preserved: every row of E is a GF(2) combination of M's rows
    # (check rank equality via both directions of elimination)
    assert np.array_equal(gauss_elim_gf2(E), E)


def test_inverse_matrix_gf2():
    rng = np.random.default_rng(1)
    while True:
        A = rng.integers(0, 2, size=(12, 12)).astype(np.uint8)
        Ainv, ok = inverse_matrix_gf2(A)
        if ok:
            break
    assert np.array_equal((A @ Ainv) % 2, np.eye(12, dtype=np.uint8))


def test_par2gen_generator_orthogonal_to_H():
    H = gallager_ldpc(48, 3, 6, seed=2)
    G, col_swaps, Hm = par2gen(H)
    # G @ Hm^T = 0 over GF(2)
    prod = (G.astype(np.int64) @ Hm.T.astype(np.int64)) % 2
    assert np.all(prod == 0)


def test_encode_ldpc_generator_mode_valid_codewords():
    H = gallager_ldpc(48, 3, 6, seed=3)
    G, _, Hm = par2gen(H)
    k = G.shape[0]
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, size=(k, 5))
    cw = np.asarray(encode_ldpc(jnp.asarray(bits), H=Hm,
                                config=LDPCConfig(mode="G"), G=G))
    assert cw.shape == (48, 5)
    assert _check_parity(Hm, cw)
    assert np.array_equal(cw[:k], bits)  # systematic


def test_encode_dvbs2_mode_prefix_xor():
    """DVB-S2 staircase: H = [A | L] with L the dual-diagonal parity part."""
    rng = np.random.default_rng(5)
    m, k = 12, 24
    A = rng.integers(0, 2, size=(m, k)).astype(np.uint8)
    L = np.eye(m, dtype=np.uint8)
    L[np.arange(1, m), np.arange(0, m - 1)] = 1  # staircase
    H = np.concatenate([A, L], axis=1)
    bits = rng.integers(0, 2, size=(k, 7))
    cw = np.asarray(encode_ldpc(jnp.asarray(bits), H=H,
                                config=LDPCConfig(mode="DVBS2")))
    assert _check_parity(H, cw)


def test_bp_decoder_corrects_errors():
    H = gallager_ldpc(96, 3, 6, seed=6)
    G, _, Hm = par2gen(H)
    k = G.shape[0]
    rng = np.random.default_rng(7)
    n_cw = 8
    bits = rng.integers(0, 2, size=(k, n_cw))
    cw = np.asarray(encode_ldpc(jnp.asarray(bits), H=Hm,
                                config=LDPCConfig(mode="G"), G=G))
    # BPSK over AWGN at moderate SNR (above the small random code's waterfall)
    snr_db = 4.0
    sigma = np.sqrt(0.5 * 10 ** (-snr_db / 10))
    x = 1 - 2.0 * cw
    y = x + sigma * rng.normal(size=x.shape)
    llr = 2 * y / sigma**2
    for alg in ["SPA", "MSA"]:
        dec, out_llr, fail = decode_ldpc(
            jnp.asarray(llr), H=Hm, config=LDPCConfig(maxIter=30, alg=alg)
        )
        dec = np.asarray(dec)
        raw_errs = np.sum((y < 0).astype(int) != cw)
        post_errs = np.sum(dec != cw)
        assert raw_errs > 0  # channel actually flipped bits
        assert post_errs == 0, f"{alg}: {post_errs} errors remain (raw {raw_errs})"
        assert np.all(np.asarray(fail) == 0)


def test_bp_decoder_reports_failure_at_low_snr():
    H = gallager_ldpc(96, 3, 6, seed=8)
    G, _, Hm = par2gen(H)
    k = G.shape[0]
    rng = np.random.default_rng(9)
    bits = rng.integers(0, 2, size=(k, 4))
    cw = np.asarray(encode_ldpc(jnp.asarray(bits), H=Hm,
                                config=LDPCConfig(mode="G"), G=G))
    sigma = np.sqrt(0.5 * 10 ** (0.5))  # ~-5 dB: hopeless
    y = (1 - 2.0 * cw) + sigma * rng.normal(size=cw.shape)
    llr = 2 * y / sigma**2
    dec, _, fail = decode_ldpc(jnp.asarray(llr), H=Hm,
                               config=LDPCConfig(maxIter=10))
    assert np.any(np.asarray(fail) == 1)


def test_hamming_encode_decode_single_error():
    m = 4  # (15, 11)
    rng = np.random.default_rng(10)
    bits = rng.integers(0, 2, size=(11, 6))
    cw, Hm = encode_hamming(jnp.asarray(bits), m=m)
    cw = np.asarray(cw)
    assert cw.shape == (15, 6)
    assert _check_parity(Hm, cw)
    # flip one bit per codeword, decode with BP soft decisions
    corrupted = cw.copy()
    for j in range(6):
        corrupted[rng.integers(0, 15), j] ^= 1
    llr = (1 - 2.0 * corrupted) * 4.0
    dec, _, fail = decode_hamming(jnp.asarray(llr), m=m)
    assert np.array_equal(np.asarray(dec), cw)


def test_alist_roundtrip(tmp_path):
    H = gallager_ldpc(24, 3, 6, seed=11)
    path = str(tmp_path / "test.alist")
    write_alist(H, path)
    H2 = read_alist(path)
    assert np.array_equal(H, H2)
    info = parse_alist(path)
    assert info["n"] == 24 and info["m"] == 12


def test_ieee80211n_standard_decode():
    """Construct the standard IEEE 802.11n 648b R1/2 matrix and decode.

    Self-contained (comm/codes.py); no ALIST asset needed — the reference
    only works here with its shipped data files (fec.py:197).
    """
    from opticommpy_tpu.comm.codes import ldpc_parity_matrix

    H = ldpc_parity_matrix(mode="IEEE_802.11nD2", n=648, R="1/2")
    assert H.shape == (324, 648)
    rng = np.random.default_rng(12)
    k = 324
    bits = rng.integers(0, 2, size=(k, 2))
    # triangular encoding when possible, generator fallback otherwise
    # (mirrors reference encodeLDPC dispatch, fec.py:213-235)
    P1, P2, Hm = triang_p1p2(H)
    if P1 is not None:
        cw = np.asarray(encode_ldpc(jnp.asarray(bits), H=Hm, P1=P1, P2=P2,
                                    config=LDPCConfig(mode="triang")))
    else:
        G, _, Hm = par2gen(H)
        cw = np.asarray(encode_ldpc(jnp.asarray(bits), H=Hm,
                                    config=LDPCConfig(mode="G"), G=G))
    assert _check_parity(Hm, cw)
    snr_db = 2.5
    sigma = np.sqrt(0.5 * 10 ** (-snr_db / 10))
    y = (1 - 2.0 * cw) + sigma * rng.normal(size=cw.shape)
    llr = 2 * y / sigma**2
    dec, _, fail = decode_ldpc(jnp.asarray(llr), H=Hm,
                               config=LDPCConfig(maxIter=50))
    assert np.sum(np.asarray(dec) != cw) == 0


@pytest.mark.slow
def test_dvbs2_64800_encode_decode():
    """Full-scale DVB-S2 64800b R4/5: prefix-XOR encoder + MSA decoder.

    Self-contained: H is constructed from the ETSI EN 302 307 tables
    (comm/codes.py), no ALIST asset needed.
    """
    from opticommpy_tpu.comm.fec import standard_ldpc

    graph, edges = standard_ldpc(mode="DVBS2", n=64800, R="4/5")
    n, m, rows, cols = edges
    assert (m, n) == (12960, 64800)
    k = n - m
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, size=(k, 1))
    cw = np.asarray(encode_ldpc(jnp.asarray(bits), edges=edges,
                                config=LDPCConfig(mode="DVBS2")))
    syn = np.zeros(m, dtype=np.int64)
    np.add.at(syn, rows, cw[cols, 0])
    assert np.all(syn % 2 == 0)
    snr_db = 3.5
    sigma = np.sqrt(0.5 * 10 ** (-snr_db / 10))
    y = (1 - 2.0 * cw) + sigma * rng.normal(size=cw.shape)
    llr = (2 * y / sigma**2).astype(np.float32)
    dec, _, fail = decode_ldpc(jnp.asarray(llr),
                               config=LDPCConfig(maxIter=12, alg="MSA"),
                               graph=graph)
    raw = np.sum((y < 0).astype(int) != cw)
    post = np.sum(np.asarray(dec) != cw)
    assert raw > 100  # channel flipped plenty of bits
    assert post == 0
    assert int(np.asarray(fail)[0]) == 0


def test_nmsa_outperforms_plain_minsum():
    """Normalized min-sum ('NMSA', alpha=0.75, Chen & Fossorier 2002)
    recovers most of plain min-sum's loss: at an SNR where MSA leaves
    residual errors, NMSA decodes cleanly (like SPA). The reference has
    only SPA/MSA (fec.py:738)."""
    H = gallager_ldpc(1296, 3, 6, seed=0)
    g = ldpc_graph(H)
    rng = np.random.default_rng(5)
    n, B = 1296, 64
    sigma2 = 1 / (2 * 0.5 * 10 ** (2.2 / 10))  # Eb/N0 = 2.2 dB at R = 1/2
    y = 1.0 + rng.normal(scale=np.sqrt(sigma2), size=(n, B))  # all-zero cw
    llr = jnp.asarray((2 * y / sigma2).astype(np.float32))
    errs = {}
    for alg in ("MSA", "NMSA"):
        dec, _, fail = decode_ldpc(
            llr, graph=g, config=LDPCConfig(maxIter=30, alg=alg))
        errs[alg] = (int(np.sum(np.asarray(dec))), int(np.sum(fail)))
    assert errs["MSA"][0] > 100  # plain min-sum stuck at this SNR
    assert errs["NMSA"] == (0, 0)  # normalized min-sum decodes all frames


def test_qc_decoder_matches_bucketed():
    """The DVB-S2 quasi-cyclic (roll-based) decoder reproduces the general
    degree-bucketed decoder: same totals, iteration counts, and failure
    flags (fec_qc.py message layout change only)."""
    import jax.numpy as jnp

    from opticommpy_tpu.comm import fec_qc
    from opticommpy_tpu.comm.fec import _bp_decode_bucketed_batch, standard_ldpc

    graph, _ = standard_ldpc(mode="DVBS2", n=64800, R="3/5")
    rng = np.random.default_rng(7)
    llrs = jnp.asarray(
        (1.0 + rng.normal(scale=1.5, size=(64800, 2))).astype(np.float32))
    bk = graph["bk"]
    out_b, it_b, fail_b = _bp_decode_bucketed_batch(
        llrs,
        tuple(jnp.asarray(a) for a in bk["cn_var"]),
        tuple(jnp.asarray(a) for a in bk["vn_edge"]),
        tuple(jnp.asarray(a) for a in bk["vn_var"]),
        jnp.asarray(bk["var_pos"]), 5, "MSA", jnp.float32)
    dec = fec_qc.make_qc_decoder(64800, "3/5", 5, "MSA", "f32")
    out_q, it_q, fail_q = dec(llrs)
    assert np.array_equal(np.asarray(it_b), np.asarray(it_q))
    assert np.array_equal(np.asarray(fail_b), np.asarray(fail_q))
    scale = float(jnp.max(jnp.abs(out_b)))
    assert float(jnp.max(jnp.abs(out_b - out_q))) / scale < 1e-5


def test_qc_early_exit_identical_outputs():
    """earlyExit=True (while_loop, stops when the whole batch converged)
    returns bit-identical results to the fixed-trip scan path."""
    import jax.numpy as jnp

    from opticommpy_tpu.comm.fec import standard_ldpc

    graph, edges = standard_ldpc(mode="DVBS2", n=64800, R="4/5")
    k = 64800 - 12960
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, size=(k, 2)).astype(np.int8)
    cw = np.asarray(encode_ldpc(jnp.asarray(bits), edges=edges))
    sigma = np.sqrt(0.5 * 10 ** (-3.5 / 10))
    y = (1 - 2.0 * cw) + sigma * rng.normal(size=cw.shape)
    llr = jnp.asarray((2 * y / sigma**2).astype(np.float32))
    a = decode_ldpc(llr, graph=graph,
                    config=LDPCConfig(maxIter=20, alg="MSA"))
    b = decode_ldpc(llr, graph=graph,
                    config=LDPCConfig(maxIter=20, alg="MSA",
                                      earlyExit=True))
    assert np.array_equal(np.asarray(a[0]), np.asarray(b[0]))
    assert np.array_equal(np.asarray(a[1]), np.asarray(b[1]))
    assert np.array_equal(np.asarray(a[2]), np.asarray(b[2]))
    assert np.all(np.asarray(a[2]) == 0)  # batch actually converged


def test_summarize_alist_folder(tmp_path, capsys):
    from opticommpy_tpu.comm.fec import summarize_alist_folder

    H = gallager_ldpc(24, 3, 6, seed=11)
    write_alist(H, str(tmp_path / "code.alist"))
    table = summarize_alist_folder(str(tmp_path))
    assert "code.alist" in table and "24" in table
    assert "File" in capsys.readouterr().out


def test_plot_binary_matrix():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from opticommpy_tpu.comm.fec import plot_binary_matrix

    H = hamming_parity_check_matrix(3)
    ax = plot_binary_matrix(H)
    assert ax is not None
    plt.close("all")


def test_ldpc_graph_from_edges_matches_dense():
    """Sparse-support graph builder == dense builder (same edge layout)."""
    import numpy as np
    from opticommpy_tpu.comm.fec import ldpc_graph, ldpc_graph_from_edges

    H = gallager_ldpc(96, 3, 6, seed=9)
    rows, cols = np.nonzero(H)
    # shuffle edge order: the builder must sort row-major itself
    perm = np.random.default_rng(0).permutation(rows.size)
    g1 = ldpc_graph(H)
    g2 = ldpc_graph_from_edges(H.shape[1], H.shape[0], rows[perm], cols[perm])
    for k in ("cn_idx", "cn_mask", "edge_var", "vn_edge"):
        np.testing.assert_array_equal(g1[k], g2[k])
    assert g1["dc_max"] == g2["dc_max"]

def test_bucketed_bp_matches_padded_on_irregular_code():
    """Degree-bucketed BP == uniformly padded BP (bits, iters, failures)."""
    import numpy as np
    import jax.numpy as jnp
    from opticommpy_tpu.comm import fec

    # irregular degree profile: dv in {1,2,3}, dc in {2,3,4}
    rng = np.random.default_rng(3)
    n, m = 48, 24
    H = gallager_ldpc(n, 3, 6, seed=3)
    # knock out random edges to make the degrees irregular
    rows, cols = np.nonzero(H)
    drop = rng.random(rows.size) < 0.3
    H = H.copy()
    H[rows[drop], cols[drop]] = 0
    g = fec.ldpc_graph(H)
    assert len(g["bk"]["cn_var"]) > 1 and len(g["bk"]["vn_edge"]) > 1

    llr = (1.5 + rng.normal(scale=1.2, size=(n, 8))).astype(np.float32)
    for alg in ("MSA", "SPA"):
        o1, it1, f1 = fec._bp_decode_batch(
            jnp.asarray(llr), jnp.asarray(g["cn_idx"]),
            jnp.asarray(g["cn_mask"]), jnp.asarray(g["vn_edge"]),
            n, 15, alg)
        bk = g["bk"]
        o2, it2, f2 = fec._bp_decode_bucketed_batch(
            jnp.asarray(llr),
            tuple(jnp.asarray(a) for a in bk["cn_var"]),
            tuple(jnp.asarray(a) for a in bk["vn_edge"]),
            tuple(jnp.asarray(a) for a in bk["vn_var"]),
            jnp.asarray(bk["var_pos"]), 15, alg)
        np.testing.assert_array_equal(np.asarray(it1), np.asarray(it2))
        np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
        np.testing.assert_array_equal(np.asarray(o1 < 0), np.asarray(o2 < 0))
        np.testing.assert_allclose(np.asarray(o1), np.asarray(o2),
                                   atol=5e-3)


def test_bucketed_graph_handles_isolated_variables():
    """Degree-0 variables decode to their channel LLR (empty gather path)."""
    import numpy as np
    import jax.numpy as jnp
    from opticommpy_tpu.comm import fec

    H = gallager_ldpc(24, 3, 6, seed=5).copy()
    H[:, 7] = 0  # isolate variable 7
    g = fec.ldpc_graph(H)
    llr = np.full((24, 2), 4.0, dtype=np.float32)
    llr[7] = -1.25
    dec, out, fail = fec.decode_ldpc(jnp.asarray(llr), graph=g,
                                     config=fec.LDPCConfig(maxIter=5,
                                                           alg="MSA"))
    np.testing.assert_allclose(np.asarray(out)[7], -1.25)
    assert np.all(np.asarray(dec)[7] == 1)


def test_qc_tables_cover_all_dvbs2_rates():
    """The QC addressing tables reproduce the exact edge set of every
    shipped DVB-S2 rate (info part: one roll per (column, slot) entry;
    parity part: the staircase) — so the roll-based decoder is walking
    the same Tanner graph as the general decoder for all 11 codes."""
    from opticommpy_tpu.comm import fec_qc
    from opticommpy_tpu.comm.codes import available_ldpc_codes, dvbs2_edges

    rates = [R for (mode, n, R) in available_ldpc_codes()
             if mode == "DVBS2" and n == 64800]
    assert len(rates) == 11
    for R in rates:
        n, m, rows, cols = dvbs2_edges(R, 64800)
        tb = fec_qc.qc_tables(R, 64800)
        q, S, k = tb["q"], tb["S"], tb["k"]
        Z = fec_qc.Z
        g_tab, s_tab = tb["g_tab"], tb["s_tab"]
        # rebuild the info edge set from the QC tables
        s = np.arange(Z)
        qc_rows, qc_cols = [], []
        for a0 in range(q):
            for sl in range(S):
                g, x1 = int(g_tab[a0, sl]), int(s_tab[a0, sl])
                t = (s - x1) % Z  # check row s <- variable (g, t)
                qc_rows.append(a0 + q * s)
                qc_cols.append(360 * g + t)
        j = np.arange(m)
        qc_rows.append(np.concatenate([j, j[:-1] + 1]))
        qc_cols.append(np.concatenate([k + j, k + j[:-1]]))
        qc = set(zip(np.concatenate(qc_rows).tolist(),
                     np.concatenate(qc_cols).tolist()))
        ref = set(zip(np.asarray(rows).tolist(), np.asarray(cols).tolist()))
        assert qc == ref, f"rate {R}: QC edge set mismatch"


def test_qc_early_exit_identical_nmsa_bf16():
    """The XLA QC decoder's early exit (a while_loop over the batch)
    returns BIT-identical totals, decisions, iteration counts and failure
    flags to the fixed-iteration scan for NMSA with bf16 messages, on a
    workload that converges inside the budget, so the exit really fires
    (reference break-on-parity serving semantics, fec.py:494-497)."""
    from opticommpy_tpu.comm import fec_qc
    from opticommpy_tpu.comm.fec import encode_ldpc, standard_ldpc

    n, R, k = 64800, "4/5", 51840
    _, edges = standard_ldpc("DVBS2", n, R)
    rng = np.random.default_rng(7)
    sigma = np.sqrt(0.5 * 10 ** (-2.7 / 10))
    bits = rng.integers(0, 2, size=(k, 8)).astype(np.int8)
    cw = np.asarray(encode_ldpc(jnp.asarray(bits), edges=edges))
    y = (1 - 2.0 * cw) + sigma * rng.normal(size=cw.shape)
    llr = jnp.asarray((2 * y / sigma**2).astype(np.float32))

    fixed = fec_qc.make_qc_decoder(n, R, 12, "NMSA", "bf16")
    ee = fec_qc.make_qc_decoder(n, R, 12, "NMSA", "bf16", early_exit=True)
    o1, i1, f1 = fixed(llr)
    o2, i2, f2 = ee(llr)
    assert np.array_equal(np.asarray(i1), np.asarray(i2))
    assert 3 < int(np.asarray(i1).max()) < 12  # the exit actually fired
    assert np.array_equal(np.asarray(f1), np.asarray(f2))
    assert np.array_equal(np.asarray(o1, np.float32),
                          np.asarray(o2, np.float32))
    assert ((np.asarray(o1, np.float32) < 0).astype(np.int8) == cw).all()


def test_qc_decoder_columns_are_independent():
    """Any batch size decodes, and each codeword's result does not depend
    on its neighbours: a batch of 3 == each column decoded alone."""
    from opticommpy_tpu.comm import fec_qc

    n, R = 64800, "9/10"
    rng = np.random.default_rng(5)
    llrs = jnp.asarray((1.8 + rng.normal(scale=1.2, size=(n, 3))
                        ).astype(np.float32))
    dec = fec_qc.make_qc_decoder(n, R, 4, "MSA", "f32")
    out, iters, fail = dec(llrs)
    for c in range(3):
        o1, i1, f1 = dec(llrs[:, c:c + 1])
        assert np.array_equal(np.asarray(iters[c:c + 1]), np.asarray(i1))
        assert np.array_equal(np.asarray(fail[c:c + 1]), np.asarray(f1))
        assert np.array_equal(np.asarray(out[:, c:c + 1]) < 0,
                              np.asarray(o1) < 0)


@pytest.mark.slow
def test_dvbs2_fer_waterfall_pinned():
    """Coded-performance regression: the DVB-S2 R4/5 64800b FER waterfall
    (NMSA-20, bf16 messages, BPSK/AWGN) is pinned at three Es/N0 points.

    Measured with this exact seed (2026-08, 192 codewords/point):
    FER(1.7 dB) = 0.995, FER(1.9 dB) = 0.073, FER(2.1 dB) = 0.000.
    The slope is ~1 decade / 0.1 dB here, so a 0.2 dB decoder regression
    (e.g. in the bf16 message path or the QC staircase masking) pushes the
    1.9 dB point to FER ~1 and fails the bounds; a silent *improvement*
    (changed algorithm) trips the 1.7 dB lower bound and must be re-pinned
    deliberately. Curve position cross-check: the DVB-S2 standard's ideal
    QPSK R4/5 threshold is Es/N0 = 4.68 dB (EN 302 307-1 Table 13), i.e.
    1.67 dB per-dimension — our 50%-FER point of ~1.8 dB is the expected
    ~0.15 dB off ideal for 20-iteration normalized min-sum without the
    outer BCH. (The reference package's own decoder is waterfall-validated
    the same way in examples/test_fec.ipynb; its numba kernels are not
    installable here, reference optic/comm/fec.py:684.)
    """
    from opticommpy_tpu.comm import fec_qc
    from opticommpy_tpu.comm.fec import standard_ldpc

    n, R, k = 64800, "4/5", 51840
    _, edges = standard_ldpc("DVBS2", n, R)
    dec = fec_qc.make_qc_decoder(n, R, 20, "NMSA", "bf16", early_exit=True)
    rng = np.random.default_rng(42)
    B, n_chunks = 64, 3

    def fer_at(snr_db):
        sigma = np.sqrt(0.5 * 10 ** (-snr_db / 10))
        fails = 0
        for _ in range(n_chunks):
            bits = rng.integers(0, 2, size=(k, B)).astype(np.int8)
            cw = np.asarray(encode_ldpc(jnp.asarray(bits), edges=edges))
            y = (1 - 2.0 * cw) + sigma * rng.normal(size=cw.shape)
            llr = jnp.asarray((2 * y / sigma**2).astype(np.float32))
            out, _, _ = dec(llr)
            decoded = (np.asarray(out, np.float32) < 0).astype(np.int8)
            fails += int((decoded != cw).any(axis=0).sum())
        return fails / (B * n_chunks)

    # NOTE: fer_at consumes rng state sequentially — keep the point order
    # (1.7, 1.9, 2.1) or the pinned values move.
    f17 = fer_at(1.7)
    f19 = fer_at(1.9)
    f21 = fer_at(2.1)
    assert f17 >= 0.9, f"FER(1.7 dB) = {f17}: curve moved left (re-pin?)"
    assert 0.01 <= f19 <= 0.3, f"FER(1.9 dB) = {f19}: waterfall shifted"
    assert f21 <= 0.02, f"FER(2.1 dB) = {f21}: error floor appeared"

def _lift_fer_at(graph, n, snr_db, rng, B=64, n_chunks=3):
    """FER of the all-zeros codeword over BPSK/AWGN at Es/N0 ``snr_db``.

    For a linear code under a symmetric channel with sign-symmetric
    decoding (MSA/NMSA), the FER is codeword-independent, so the
    all-zeros word measures the true waterfall while exercising the full
    standard graph — a sign/shift error in a base-matrix entry changes
    the code and moves the curve. Punctured tails (AR4JA) get zero LLRs
    (codes.py:135)."""
    from opticommpy_tpu.comm.fec import LDPCConfig, decode_ldpc

    ntot = graph["n"]
    cfg = LDPCConfig(maxIter=20, alg="NMSA", msgDtype="bf16")
    sigma = np.sqrt(0.5 * 10 ** (-snr_db / 10))
    fails = 0
    for _ in range(n_chunks):
        y = 1.0 + sigma * rng.normal(size=(n, B))
        llr = 2 * y / sigma**2
        if ntot > n:
            llr = np.concatenate([llr, np.zeros((ntot - n, B))])
        dec, _, _ = decode_ldpc(jnp.asarray(llr.astype(np.float32)),
                                graph=graph, config=cfg)
        fails += int(np.asarray(dec).astype(bool).any(axis=0).sum())
    return fails / (B * n_chunks)


@pytest.mark.slow
def test_80211n_fer_waterfall_pinned():
    """Coded-performance regression for the IEEE 802.11n lift decoder
    (VERDICT r3 item 4): the 1944b R1/2 FER waterfall (NMSA-20, bf16,
    BPSK/AWGN) pinned at three Es/N0 points.

    Measured with this exact seed (2026-08, 192 codewords/point):
    FER(-2.0 dB) = 0.896, FER(-1.25 dB) = 0.120, FER(-0.5 dB) = 0.000.
    Cross-check against the standard: the 50%-FER point sits at
    Es/N0 ~ -1.6 dB = Eb/N0 ~ +1.4 dB (R=1/2 BPSK), the expected
    ~0.2-0.3 dB off published 50-iteration BP performance for this code
    (~1.1-1.3 dB) at 20 normalized-min-sum iterations. The lift decoder
    was previously only differentially tested against the gather path —
    a shared base-matrix error was invisible. Reference decode entry:
    /root/reference/optic/comm/fec.py:684."""
    from opticommpy_tpu.comm.fec import standard_ldpc

    graph, _ = standard_ldpc("IEEE_802.11nD2", 1944, "1/2")
    rng = np.random.default_rng(42)
    # sequential rng: keep the point order or the pinned values move
    f_low = _lift_fer_at(graph, 1944, -2.0, rng)
    f_mid = _lift_fer_at(graph, 1944, -1.25, rng)
    f_hi = _lift_fer_at(graph, 1944, -0.5, rng)
    assert f_low >= 0.75, f"FER(-2.0) = {f_low}: curve moved left (re-pin?)"
    assert 0.03 <= f_mid <= 0.3, f"FER(-1.25) = {f_mid}: waterfall shifted"
    assert f_hi <= 0.02, f"FER(-0.5) = {f_hi}: error floor appeared"


@pytest.mark.slow
def test_ar4ja_fer_waterfall_pinned():
    """Coded-performance regression for the AR4JA lift decoder (VERDICT r3
    item 4): the CCSDS k=1024 R1/2 (n=2048 transmitted, 512-column
    punctured tail) FER waterfall (NMSA-20, bf16, BPSK/AWGN) pinned at
    three Es/N0 points.

    Measured with this exact seed (2026-08, 192 codewords/point):
    FER(-1.5 dB) = 0.661, FER(-1.0 dB) = 0.052, FER(-0.25 dB) = 0.000.
    Cross-check: the waterfall knee at Es/N0 ~ -1.0 dB = Eb/N0 ~ +2.0 dB
    is consistent with CCSDS 130.1-G AR4JA k=1024 R1/2 performance
    (~1.9-2.5 dB Eb/N0 at low FER) for 20-iteration min-sum. Exercises
    the quarter-plane permutation rolls AND the punctured-tail zero-LLR
    path. Reference decode entry: /root/reference/optic/comm/fec.py:684."""
    from opticommpy_tpu.comm.fec import standard_ldpc

    graph, _ = standard_ldpc("AR4JA", 2048, "1/2")
    rng = np.random.default_rng(42)
    f_low = _lift_fer_at(graph, 2048, -1.5, rng)
    f_mid = _lift_fer_at(graph, 2048, -1.0, rng)
    f_hi = _lift_fer_at(graph, 2048, -0.25, rng)
    assert f_low >= 0.45, f"FER(-1.5) = {f_low}: curve moved left (re-pin?)"
    assert 0.01 <= f_mid <= 0.2, f"FER(-1.0) = {f_mid}: waterfall shifted"
    assert f_hi <= 0.02, f"FER(-0.25) = {f_hi}: error floor appeared"


def test_lift_decoder_matches_bucketed():
    """The lifted-circulant roll decoder (fec_lift.py) reproduces the
    degree-bucketed gather decoder on 802.11n and AR4JA: identical totals,
    iteration counts and failure flags."""
    import jax.numpy as jnp

    from opticommpy_tpu.comm import fec_lift
    from opticommpy_tpu.comm.fec import _bp_decode_bucketed_batch, standard_ldpc

    rng = np.random.default_rng(2)
    for mode, n, R in (("IEEE_802.11nD2", 1944, "1/2"),
                       ("AR4JA", 2048, "1/2"),
                       ("IEEE_802.11nD2", 648, "5/6")):
        graph, _ = standard_ldpc(mode, n, R)
        llrs = jnp.asarray(
            (1.0 + rng.normal(scale=1.5, size=(graph["n"], 4))).astype(
                np.float32))
        bk = graph["bk"]
        out_b, it_b, fail_b = _bp_decode_bucketed_batch(
            llrs,
            tuple(jnp.asarray(a) for a in bk["cn_var"]),
            tuple(jnp.asarray(a) for a in bk["vn_edge"]),
            tuple(jnp.asarray(a) for a in bk["vn_var"]),
            jnp.asarray(bk["var_pos"]), 5, "MSA", jnp.float32)
        dec = fec_lift.make_lift_decoder(mode, n, R, 5, "MSA", "f32")
        out_l, it_l, fail_l = dec(llrs)
        assert np.array_equal(np.asarray(it_b), np.asarray(it_l)), (mode, n)
        assert np.array_equal(np.asarray(fail_b), np.asarray(fail_l))
        scale = float(jnp.max(jnp.abs(out_b)))
        assert float(jnp.max(jnp.abs(out_b - out_l))) / scale < 1e-5

def test_lift_decoder_corrects_errors_and_early_exit():
    """decode_ldpc routes 802.11n/AR4JA through the lift decoder: corrects
    AWGN errors on real codewords (AR4JA punctured-tail handling included)
    and earlyExit returns identical outputs."""
    import jax.numpy as jnp

    from opticommpy_tpu.comm.fec import standard_ldpc

    graph, edges = standard_ldpc("IEEE_802.11nD2", 1296, "1/2")
    H = np.zeros((graph["m"], graph["n"]), np.uint8)
    H[edges[2], edges[3]] = 1
    G, _, Hs = par2gen(H)
    k = G.shape[0]
    rng = np.random.default_rng(9)
    bits = rng.integers(0, 2, size=(k, 4)).astype(np.int8)
    cw = np.asarray(encode_ldpc(jnp.asarray(bits), H=Hs,
                                config=LDPCConfig(mode="G"), G=jnp.asarray(G)))
    # NOTE: par2gen column-permutes H; decode against the permuted graph
    from opticommpy_tpu.comm.fec import ldpc_graph
    gperm = ldpc_graph(Hs)
    sigma = np.sqrt(0.5 * 10 ** (-2.0 / 10))
    y = (1 - 2.0 * cw) + sigma * rng.normal(size=cw.shape)
    llr = jnp.asarray((2 * y / sigma**2).astype(np.float32))
    a = decode_ldpc(llr, graph=gperm, config=LDPCConfig(maxIter=20,
                                                        alg="MSA"))
    assert np.array_equal(np.asarray(a[0]), cw)

    # routed lift path on the standard graph with earlyExit
    cw2 = np.zeros((graph["n"], 3), np.int8)  # all-zeros codeword
    y2 = (1 - 2.0 * cw2) + sigma * rng.normal(size=cw2.shape)
    llr2 = jnp.asarray((2 * y2 / sigma**2).astype(np.float32))
    b1 = decode_ldpc(llr2, graph=graph, config=LDPCConfig(maxIter=20,
                                                          alg="NMSA"))
    b2 = decode_ldpc(llr2, graph=graph,
                     config=LDPCConfig(maxIter=20, alg="NMSA",
                                       earlyExit=True))
    assert np.array_equal(np.asarray(b1[0]), cw2)
    for u, v in zip(b1, b2):
        assert np.array_equal(np.asarray(u), np.asarray(v))
