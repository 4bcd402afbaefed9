"""Tests for the Pallas (Triton route) MIMO equalizer kernel, in the
Pallas interpreter on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np

from opticommpy_tpu.comm import modulate_gray
from opticommpy_tpu.comm.modulation import gray_mapping
from opticommpy_tpu.dsp import MIMOEqualizerConfig, mimo_adapt_equalizer
from opticommpy_tpu.kernels.mimo_pallas import mimo_eq_pallas
from opticommpy_tpu.ops import fir_filter, pnorm, pulse_shape, upsample


def _qam_polmux(key, n_sym, sps=2):
    symb = pnorm(modulate_gray(
        jax.random.randint(key, (n_sym * 4 * 2,), 0, 2), 16, "qam"
    ).reshape(n_sym, 2))
    pulse = jnp.asarray(pulse_shape("rrc", sps, 256, 0.1))
    sig = pnorm(fir_filter(pulse, upsample(symb, sps)))
    return sig, symb


def _norm_const():
    c = gray_mapping(16, "qam")
    return (c / np.sqrt(np.mean(np.abs(c) ** 2))).astype(np.complex64)


def test_pallas_lms_matches_scan_ddlms():
    """n_train=0 (pure decision-directed) must equal the scan dd-lms rule."""
    key = jax.random.PRNGKey(0)
    sig, symb = _qam_polmux(key, 3000)
    const = _norm_const()
    y_pl, H_pl = mimo_eq_pallas(sig, symb, const, alg="lms", n_taps=7,
                                sps=2, mu=1e-3, n_train=0, interpret=True)
    cfg = MIMOEqualizerConfig(nTaps=7, mu=(1e-3,), SpS=2, alg=("dd-lms",), M=16)
    y_sc, H_sc, _, _, _ = mimo_adapt_equalizer(sig, cfg, symb_ref=symb,
                                               return_results=True)
    n = min(y_pl.shape[0], y_sc.shape[0])
    assert np.allclose(np.asarray(y_pl)[:n], np.asarray(y_sc)[:n], atol=2e-4)
    assert np.allclose(np.asarray(H_pl), np.asarray(H_sc), atol=1e-3)


def test_pallas_lms_converges_with_training():
    key = jax.random.PRNGKey(1)
    sig, symb = _qam_polmux(key, 6000)
    theta = 0.35
    J = jnp.array([[np.cos(theta), np.sin(theta)],
                   [-np.sin(theta), np.cos(theta)]], dtype=jnp.complex64)
    mixed = pnorm(sig @ J.T)
    const = _norm_const()
    y, H = mimo_eq_pallas(mixed, symb, const, alg="lms", n_taps=7, sps=2,
                          mu=2e-3, n_train=4000, interpret=True)
    tail_err = np.mean(np.abs(np.asarray(y)[-1500:] - np.asarray(symb)[-1500:]) ** 2)
    head_err = np.mean(np.abs(np.asarray(y)[100:600] - np.asarray(symb)[100:600]) ** 2)
    assert tail_err < 0.03
    assert tail_err < 0.5 * head_err


def test_pallas_cma_matches_scan():
    key = jax.random.PRNGKey(2)
    sig, symb = _qam_polmux(key, 3000)
    const = _norm_const()
    from opticommpy_tpu.kernels.mimo_pallas import mimo_eq_pallas

    y_pl, H_pl = mimo_eq_pallas(sig, None, const, alg="cma", n_taps=7, sps=2,
                                mu=1e-3, interpret=True)
    cfg = MIMOEqualizerConfig(nTaps=7, mu=(1e-3,), SpS=2, alg=("cma",), M=16)
    y_sc, H_sc, _, _, _ = mimo_adapt_equalizer(sig, cfg, symb_ref=symb,
                                               return_results=True)
    n = min(y_pl.shape[0], y_sc.shape[0])
    assert np.allclose(np.asarray(y_pl)[:n], np.asarray(y_sc)[:n], atol=2e-4)
    assert np.allclose(np.asarray(H_pl), np.asarray(H_sc), atol=1e-3)


def test_pallas_rde_matches_scan():
    key = jax.random.PRNGKey(3)
    sig, symb = _qam_polmux(key, 3000)
    const = _norm_const()
    from opticommpy_tpu.kernels.mimo_pallas import mimo_eq_pallas

    y_pl, H_pl = mimo_eq_pallas(sig, None, const, alg="rde", n_taps=7, sps=2,
                                mu=1e-3, interpret=True)
    cfg = MIMOEqualizerConfig(nTaps=7, mu=(1e-3,), SpS=2, alg=("rde",), M=16)
    y_sc, H_sc, _, _, _ = mimo_adapt_equalizer(sig, cfg, symb_ref=symb,
                                               return_results=True)
    n = min(y_pl.shape[0], y_sc.shape[0])
    assert np.allclose(np.asarray(y_pl)[:n], np.asarray(y_sc)[:n], atol=2e-4)
    assert np.allclose(np.asarray(H_pl), np.asarray(H_sc), atol=1e-3)


def test_pallas_nlms_matches_scan():
    key = jax.random.PRNGKey(4)
    sig, symb = _qam_polmux(key, 3000)
    const = _norm_const()
    from opticommpy_tpu.kernels.mimo_pallas import mimo_eq_pallas

    y_pl, H_pl = mimo_eq_pallas(sig, symb, const, alg="nlms", n_taps=7, sps=2,
                                mu=1e-3, n_train=10**9,
                                interpret=True)
    cfg = MIMOEqualizerConfig(nTaps=7, mu=(1e-3,), SpS=2, alg=("nlms",), M=16)
    y_sc, H_sc, _, _, _ = mimo_adapt_equalizer(sig, cfg, symb_ref=symb,
                                               return_results=True)
    n = min(y_pl.shape[0], y_sc.shape[0])
    assert np.allclose(np.asarray(y_pl)[:n], np.asarray(y_sc)[:n], atol=2e-4)
    assert np.allclose(np.asarray(H_pl), np.asarray(H_sc), atol=1e-3)


def test_pallas_rde_qpsk_single_radius():
    """QPSK has one radius: rde reduces to cma with R=1 (pnorm'd ring)."""
    key = jax.random.PRNGKey(5)
    n_sym = 2000
    symb = pnorm(modulate_gray(
        jax.random.randint(key, (n_sym * 2 * 2,), 0, 2), 4, "qam"
    ).reshape(n_sym, 2))
    pulse = jnp.asarray(pulse_shape("rrc", 2, 256, 0.1))
    sig = pnorm(fir_filter(pulse, upsample(symb, 2)))
    c4 = gray_mapping(4, "qam")
    c4 = (c4 / np.sqrt(np.mean(np.abs(c4) ** 2))).astype(np.complex64)
    from opticommpy_tpu.kernels.mimo_pallas import mimo_eq_pallas

    y_rde, _ = mimo_eq_pallas(sig, None, c4, alg="rde", n_taps=7, sps=2,
                              mu=2e-3, interpret=True)
    y_cma, _ = mimo_eq_pallas(sig, None, c4, alg="cma", n_taps=7, sps=2,
                              mu=2e-3, interpret=True)
    # R_cma = E|c|^4 / E|c|^2 = 1 = single radius^2 -> identical recursions
    assert np.allclose(np.asarray(y_rde), np.asarray(y_cma), atol=1e-5)


def test_pallas_lms_sps1():
    key = jax.random.PRNGKey(6)
    n_sym = 2000
    symb = pnorm(modulate_gray(
        jax.random.randint(key, (n_sym * 4 * 2,), 0, 2), 16, "qam"
    ).reshape(n_sym, 2))
    const = _norm_const()
    from opticommpy_tpu.kernels.mimo_pallas import mimo_eq_pallas

    y, H = mimo_eq_pallas(symb, symb, const, alg="lms", n_taps=5, sps=1,
                          mu=2e-3, n_train=n_sym, interpret=True)
    err = np.mean(np.abs(np.asarray(y)[-500:] - np.asarray(symb)[-500:]) ** 2)
    assert err < 0.01


def test_batched_kernel_matches_per_signal_all_algs():
    """mimo_eq_pallas_batch == mimo_eq_pallas per signal (bit-identical:
    one program per signal and output mode runs the same code)."""
    import numpy as np
    from opticommpy_tpu.comm.modulation import gray_mapping
    from opticommpy_tpu.kernels.mimo_pallas import (
        mimo_eq_pallas, mimo_eq_pallas_batch,
    )

    const = gray_mapping(16, "qam")
    const = (const / np.sqrt(np.mean(np.abs(const) ** 2))).astype(np.complex64)
    rng = np.random.default_rng(0)
    b, n_sym, sps = 3, 900, 2
    sig = (0.5 * (rng.normal(size=(b, n_sym * sps, 2))
                  + 1j * rng.normal(size=(b, n_sym * sps, 2)))
           ).astype(np.complex64)
    ref = const[rng.integers(0, 16, size=(b, n_sym, 2))]
    for alg in ["lms", "nlms", "cma", "rde"]:
        data_aided = alg in ("lms", "nlms")
        yb, hb = mimo_eq_pallas_batch(
            sig, ref if data_aided else None, const, alg=alg, n_taps=15,
            sps=sps, mu=1e-3, n_train=300, interpret=True)
        for i in range(b):
            y1, h1 = mimo_eq_pallas(
                sig[i], ref[i] if data_aided else None, const, alg=alg,
                n_taps=15, sps=sps, mu=1e-3, n_train=300,
                interpret=True)
            np.testing.assert_array_equal(np.asarray(yb[i]), np.asarray(y1))
            np.testing.assert_array_equal(np.asarray(hb[i]), np.asarray(h1))


def test_batched_kernel_custom_h0_and_odd_length():
    import numpy as np
    from opticommpy_tpu.comm.modulation import gray_mapping
    from opticommpy_tpu.kernels.mimo_pallas import mimo_eq_pallas_batch

    const = gray_mapping(4, "qam")
    const = (const / np.sqrt(np.mean(np.abs(const) ** 2))).astype(np.complex64)
    rng = np.random.default_rng(1)
    b, n_sym, sps, n_taps = 2, 333, 2, 7  # not a multiple of block
    sig = (0.5 * (rng.normal(size=(b, n_sym * sps, 2))
                  + 1j * rng.normal(size=(b, n_sym * sps, 2)))
           ).astype(np.complex64)
    ref = const[rng.integers(0, 4, size=(b, n_sym, 2))]
    h0 = np.zeros((b, 2, 2, n_taps), np.complex64)
    h0[:, 0, 0, 3] = 0.9
    h0[:, 1, 1, 3] = 1.1
    y, h = mimo_eq_pallas_batch(sig, ref, const, alg="lms", n_taps=n_taps,
                                sps=sps, mu=1e-3, n_train=100,
                                H0=h0, interpret=True)
    assert y.shape == (b, n_sym, 2)
    assert h.shape == (b, 2, 2, n_taps)
    assert np.isfinite(np.asarray(y)).all()


def _qam_modes(key, n_sym, n_modes, sps=2):
    """n_modes-mode 16QAM signal (SDM shape) + symbols."""
    symb = pnorm(modulate_gray(
        jax.random.randint(key, (n_sym * 4 * n_modes,), 0, 2), 16, "qam"
    ).reshape(n_sym, n_modes))
    pulse = jnp.asarray(pulse_shape("rrc", sps, 256, 0.1))
    sig = pnorm(fir_filter(pulse, upsample(symb, sps)))
    return sig, symb


def test_pallas_4x4_matches_scan_ddlms():
    """NxN generalization: 4x4 must equal the scan."""
    from opticommpy_tpu.kernels.mimo_pallas import mimo_eq_pallas

    key = jax.random.PRNGKey(11)
    sig, symb = _qam_modes(key, 2000, n_modes=4)
    const = _norm_const()
    y_pl, H_pl = mimo_eq_pallas(sig, symb, const, alg="lms", n_taps=7, sps=2,
                                mu=1e-3, n_train=0, interpret=True)
    assert y_pl.shape == (2000, 4) and H_pl.shape == (4, 4, 7)
    cfg = MIMOEqualizerConfig(nTaps=7, mu=(1e-3,), SpS=2, alg=("dd-lms",),
                              M=16)
    y_sc, H_sc, _, _, _ = mimo_adapt_equalizer(sig, cfg, symb_ref=symb,
                                               return_results=True)
    n = min(y_pl.shape[0], y_sc.shape[0])
    assert np.allclose(np.asarray(y_pl)[:n], np.asarray(y_sc)[:n], atol=2e-4)
    assert np.allclose(np.asarray(H_pl), np.asarray(H_sc), atol=1e-3)


def test_pallas_4x4_cma_and_nlms_match_scan():
    from opticommpy_tpu.kernels.mimo_pallas import mimo_eq_pallas

    key = jax.random.PRNGKey(12)
    sig, symb = _qam_modes(key, 1500, n_modes=4)
    const = _norm_const()
    for alg, scan_alg in [("cma", "cma"), ("nlms", "nlms")]:
        y_pl, _ = mimo_eq_pallas(sig, symb, const, alg=alg, n_taps=5, sps=2,
                                 mu=5e-4, n_train=10**9,
                                 interpret=True)
        cfg = MIMOEqualizerConfig(nTaps=5, mu=(5e-4,), SpS=2, alg=(scan_alg,),
                                  M=16)
        y_sc, _, _, _, _ = mimo_adapt_equalizer(sig, cfg, symb_ref=symb,
                                                return_results=True)
        n = min(y_pl.shape[0], y_sc.shape[0])
        assert np.allclose(np.asarray(y_pl)[:n], np.asarray(y_sc)[:n],
                           atol=5e-4), alg


def test_pallas_batch_3mode():
    """Batched kernel at n_modes=3 (odd mode count) matches per-signal."""
    from opticommpy_tpu.kernels.mimo_pallas import (mimo_eq_pallas,
                                                    mimo_eq_pallas_batch)

    key = jax.random.PRNGKey(13)
    sigs, symbs = [], []
    for b in range(3):
        sig, symb = _qam_modes(jax.random.fold_in(key, b), 800, n_modes=3)
        sigs.append(sig)
        symbs.append(symb)
    sig_b = jnp.stack(sigs)
    symb_b = jnp.stack(symbs)
    const = _norm_const()
    y_b, h_b = mimo_eq_pallas_batch(sig_b, symb_b, const, alg="lms",
                                    n_taps=5, sps=2, mu=1e-3, n_train=400,
                                  interpret=True)
    assert y_b.shape == (3, 800, 3) and h_b.shape == (3, 3, 3, 5)
    for b in range(3):
        y_s, h_s = mimo_eq_pallas(sigs[b], symbs[b], const, alg="lms",
                                  n_taps=5, sps=2, mu=1e-3, n_train=400,
                                  interpret=True)
        assert np.allclose(np.asarray(y_b[b]), np.asarray(y_s), atol=1e-5), b
        assert np.allclose(np.asarray(h_b[b]), np.asarray(h_s), atol=1e-5), b


def test_multistage_pallas_backend_matches_scan():
    """mimo_adapt_equalizer(backend='pallas'): the full multi-stage training
    schedule — per-stage algorithms, numIter pre-convergence passes, H
    chained across stages (rls stages run the scan) — on the kernel
    matches the scan path to ~1e-5 for every alg pair."""
    from opticommpy_tpu.comm.modulation import gray_mapping

    rng = np.random.default_rng(0)
    n_sym, M = 2500, 16
    const = gray_mapping(M, "qam")
    const = const / np.sqrt(np.mean(np.abs(const) ** 2))
    sym = const[rng.integers(0, M, size=(n_sym, 2))]
    x = np.zeros((n_sym * 2, 2), complex)
    x[::2] = sym
    h = np.array([[0.9, 0.15 + 0.05j], [-0.1 + 0.08j, 0.95]])
    sig = (x @ h.T + 0.01 * (rng.normal(size=(n_sym * 2, 2))
                             + 1j * rng.normal(size=(n_sym * 2, 2))))
    sig = jnp.asarray(sig.astype(np.complex64))
    sym = jnp.asarray(sym.astype(np.complex64))

    for algs, mus in ((("nlms", "dd-lms"), (2e-3, 1e-3)),
                      (("da-rde", "dd-lms"), (5e-3, 1e-3)),
                      (("cma", "rde"), (1e-3, 1e-3)),
                      (("rls", "dd-rls"), (1e-3, 1e-3)),
                      (("rls", "dd-lms"), (1e-3, 1e-3))):
        out = {}
        for be in ("scan", "pallas"):
            cfg = MIMOEqualizerConfig(nTaps=15, SpS=2, mu=mus, alg=algs,
                                      L=(800, n_sym - 800), M=M, numIter=2,
                                      backend=be, interpret=True)
            y, H, _, es, _ = mimo_adapt_equalizer(sig, cfg, symb_ref=sym,
                                                  return_results=True)
            out[be] = (np.asarray(y), np.asarray(H), np.asarray(es))
        tol = 3e-4 if "rls" in algs[0] else 1e-4
        assert np.abs(out["scan"][0] - out["pallas"][0]).max() < tol, algs
        assert np.abs(out["scan"][1] - out["pallas"][1]).max() < tol, algs
        assert np.abs(out["scan"][2] - out["pallas"][2]).max() < tol, algs


def test_multistage_batch_matches_per_signal():
    """mimo_adapt_equalizer_batch: B signals' full multi-stage schedules in
    one program are BIT-EXACT vs per-signal mimo_adapt_equalizer runs, for
    batched-kernel stages (gradient rules and rls/dd-rls), the vmapped
    scan backend, and the blockUpdate fallback."""
    from opticommpy_tpu.comm.modulation import gray_mapping
    from opticommpy_tpu.dsp.equalization import mimo_adapt_equalizer_batch

    rng = np.random.default_rng(7)
    n_sym, M, B = 1500, 16, 3
    const = gray_mapping(M, "qam")
    const = const / np.sqrt(np.mean(np.abs(const) ** 2))
    sigs, syms = [], []
    for _ in range(B):
        sym = const[rng.integers(0, M, size=(n_sym, 2))]
        x = np.zeros((n_sym * 2, 2), complex)
        x[::2] = sym
        h = np.eye(2) + 0.1 * (rng.normal(size=(2, 2))
                               + 1j * rng.normal(size=(2, 2)))
        sigs.append(x @ h.T + 0.01 * (rng.normal(size=x.shape)
                                      + 1j * rng.normal(size=x.shape)))
        syms.append(sym)
    sig_b = jnp.asarray(np.stack(sigs).astype(np.complex64))
    sym_b = jnp.asarray(np.stack(syms).astype(np.complex64))

    cases = [
        (("nlms", "dd-lms"), (2e-3, 1e-3), "pallas", 1),
        (("rls", "dd-rls"), (1e-3, 1e-3), "pallas", 1),
        (("da-rde", "dd-lms"), (5e-3, 1e-3), "scan", 1),
        (("dd-lms",), (2e-3,), "pallas", 64),  # blocked fallback
    ]
    for algs, mus, be, k_blk in cases:
        L = (700, n_sym - 700) if len(algs) == 2 else None
        cfg = MIMOEqualizerConfig(nTaps=9, SpS=2, mu=mus, alg=algs, L=L,
                                  M=M, numIter=2, blockUpdate=k_blk,
                                  backend=be, interpret=True)
        yb, Hb, eb = mimo_adapt_equalizer_batch(
            sig_b, cfg, symb_ref=sym_b, return_results=True)
        for b in range(B):
            y, H, _, es, _ = mimo_adapt_equalizer(
                sig_b[b], cfg, symb_ref=sym_b[b], return_results=True)
            assert np.array_equal(np.asarray(yb[b]), np.asarray(y)), (algs, b)
            assert np.array_equal(np.asarray(Hb[b]), np.asarray(H)), (algs, b)
            assert np.array_equal(np.asarray(eb[b]), np.asarray(es)), (algs, b)


def test_multistage_batch_4x4_matches_per_signal():
    """The batched trainer at 4 modes (SDM shape, modes padded to a power
    of two inside the kernel) vs per-signal runs: kernel stages are
    bit-exact; rls stages (vmapped scan vs single scan) match to f32
    accumulation-order tolerance."""
    from opticommpy_tpu.dsp.equalization import mimo_adapt_equalizer_batch

    B, n_sym = 2, 1200
    sigs, syms = [], []
    for b in range(B):
        sig, symb = _qam_modes(jax.random.PRNGKey(30 + b), n_sym, n_modes=4)
        sigs.append(np.asarray(sig))
        syms.append(np.asarray(symb))
    sig_b = jnp.asarray(np.stack(sigs))
    sym_b = jnp.asarray(np.stack(syms))
    for algs, tol in ((("nlms", "dd-lms"), 0.0), (("rls", "dd-lms"), 1e-4)):
        cfg = MIMOEqualizerConfig(nTaps=7, SpS=2, mu=(1e-3, 1e-3),
                                  alg=algs, L=(500, n_sym - 500),
                                  M=16, backend="pallas", interpret=True)
        yb = mimo_adapt_equalizer_batch(sig_b, cfg, symb_ref=sym_b)
        for b in range(B):
            y = mimo_adapt_equalizer(sig_b[b], cfg, symb_ref=sym_b[b])
            d = float(jnp.abs(yb[b] - y).max())
            assert d <= tol, (algs, b, d)


def test_multistage_pallas_unsupported_stage_falls_back():
    """Inside a backend='pallas' schedule the rls stage (no kernel rule)
    runs the scan, and the dd-lms stage after it runs the kernel over a
    NON-square constellation (8-PSK: the nearest-point search instead of
    the square-grid slicer); H chains through the mixed path and the
    output equals the all-scan run."""
    from opticommpy_tpu.comm.modulation import gray_mapping

    rng = np.random.default_rng(1)
    n_sym, M = 1200, 8
    const = gray_mapping(M, "psk")
    const = const / np.sqrt(np.mean(np.abs(const) ** 2))
    sym = const[rng.integers(0, M, size=(n_sym, 2))]
    x = np.zeros((n_sym * 2, 2), complex)
    x[::2] = sym
    sig = jnp.asarray((x + 0.01 * (rng.normal(size=x.shape)
                                   + 1j * rng.normal(size=x.shape))
                       ).astype(np.complex64))
    sym = jnp.asarray(sym.astype(np.complex64))
    for be in ("scan", "pallas"):
        cfg = MIMOEqualizerConfig(nTaps=7, SpS=2, mu=(2e-3, 1e-3),
                                  alg=("rls", "dd-lms"), L=(400, n_sym - 400),
                                  M=M, constType="psk", backend=be,
                                  interpret=True)
        y = mimo_adapt_equalizer(sig, cfg, symb_ref=sym)
        if be == "scan":
            y_ref = np.asarray(y)
    assert np.abs(np.asarray(y) - y_ref).max() < 3e-4
