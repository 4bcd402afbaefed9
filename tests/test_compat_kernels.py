"""Tests for the reference-internal kernel shims in compat (update rules,
coreAdaptEq, FFE/DFE/Volterra cores, FEC encoder/decoder kernels).

These are host-side NumPy forms of the reference's Numba kernels
(equalization.py:354-973, fec.py:254-683); the tests check the same
physics-invariant properties the reference's own suite relies on, plus
cross-consistency with the jitted device-path implementations.
"""

import numpy as np
import pytest

import opticommpy_tpu.compat as C
from opticommpy_tpu.comm.fec import hamming_parity_check_matrix, par2gen
from opticommpy_tpu.comm.modulation import gray_mapping


def _qpsk_mix(n=3000, seed=0, theta=0.35):
    """2x2 instantaneously mixed QPSK streams (SpS=1), unit power."""
    rng = np.random.default_rng(seed)
    const = gray_mapping(4, "qam")
    const = const / np.sqrt(np.mean(np.abs(const) ** 2))
    tx = const[rng.integers(0, 4, size=(n, 2))]
    U = np.array([[np.cos(theta), np.sin(theta)],
                  [-np.sin(theta), np.cos(theta)]], dtype=complex)
    rx = tx @ U.T
    return rx.astype(np.complex64), tx.astype(np.complex64), const


class TestUpdateRules:
    def _setup(self):
        rx, tx, const = _qpsk_mix()
        nTaps, nModes = 5, 2
        H = np.zeros((nModes**2, nTaps), dtype=np.complex64)
        H[::nModes + 1, nTaps // 2] = 1.0  # center-spike init
        H_ = np.zeros_like(H)
        win = rx[:nTaps]
        outEq = np.array([[win[nTaps // 2, 0]], [win[nTaps // 2, 1]]],
                         dtype=np.complex64)
        return rx, tx, const, H, H_, win, outEq

    def test_nlms_moves_taps_toward_error(self):
        rx, tx, const, H, H_, win, outEq = self._setup()
        H0 = H.copy()
        Hn, _, errSq = C.nlmsUp(win, tx[2], outEq, 0.1, H, H_, 2, False)
        # update is mu * err x conj(x)/||x||^2 on each input-mode block
        err = tx[2] - outEq[:, 0]
        x0 = win[:, 0] / np.sum(np.abs(win[:, 0]) ** 2)
        expect = H0[0] + 0.1 * err[0] * np.conj(x0)
        np.testing.assert_allclose(Hn[0], expect, rtol=1e-5)
        np.testing.assert_allclose(errSq, np.abs(err) ** 2, rtol=1e-5)

    def test_cma_fixed_point_on_constant_modulus(self):
        # if |out|^2 == Rcma the CMA error is zero and taps do not move
        _, _, const, H, H_, win, _ = self._setup()
        R = np.full(2, np.mean(np.abs(const) ** 4) / np.mean(np.abs(const) ** 2))
        out = np.sqrt(R[0]) * np.exp(1j * np.array([[0.3], [1.1]]))
        H0 = H.copy()
        Hn, _, errSq = C.cmaUp(win, R, out.astype(np.complex64), 0.1, H, H_,
                               2, False)
        np.testing.assert_allclose(Hn, H0, atol=1e-6)
        np.testing.assert_allclose(errSq, 0.0, atol=1e-10)

    def test_rde_decides_nearest_radius(self):
        _, _, _, H, H_, win, _ = self._setup()
        R = np.array([0.5, 1.0, 1.5], dtype=np.complex64)
        out = np.array([[0.52], [1.46]], dtype=np.complex64)
        _, _, errSq = C.rdeUp(win, R, out, 0.0, H, H_, 2, False)
        np.testing.assert_allclose(
            errSq, [abs(0.25 - 0.52**2) ** 2, abs(2.25 - 1.46**2) ** 2],
            rtol=1e-4)

    def test_rls_converges_single_tap(self):
        # scalar channel y = a*x: RLS should drive H toward 1/a rapidly
        rng = np.random.default_rng(1)
        a = 0.7 + 0.2j
        const = gray_mapping(4, "qam")
        const = (const / np.sqrt(np.mean(np.abs(const) ** 2))).astype(complex)
        H = np.zeros((1, 1), dtype=np.complex64)
        Sd = np.eye(1, dtype=np.complex64)
        for _ in range(200):
            s = const[rng.integers(0, 4)]
            x = np.array([[a * s]], dtype=np.complex64)
            out = (H[0, 0] * x[0, 0]).reshape(1, 1)
            H, Sd, _ = C.rlsUp(x, np.array([s]), out, 0.99, H, Sd, 1)
        assert abs(H[0, 0] - 1 / a) < 0.05

    def test_ddlms_uses_decisions(self):
        _, _, const, H, H_, win, _ = self._setup()
        out = (const[1] * 1.001 * np.ones((2, 1))).astype(np.complex64)
        _, _, errSq = C.ddlmsUp(win, const, out, 0.0, H, H_, 2, False)
        assert np.all(errSq < 1e-4)  # decision == const[1], tiny error


class TestCoreAdaptEq:
    def test_2x2_nlms_unmixes(self):
        rx, tx, const, *_ = _qpsk_mix(4000)
        nTaps, nModes = 5, 2
        H = np.zeros((nModes**2, nTaps), dtype=np.complex64)
        H[::nModes + 1, nTaps // 2] = 1.0
        H_ = np.zeros_like(H)
        L = 3500
        pad = np.pad(rx, ((nTaps // 2, nTaps // 2), (0, 0)))
        y, Hf, _, errSq, _ = C.coreAdaptEq(
            pad, tx, 1, H, H_, L, 5e-3, 0.99, nTaps, False, False, "nlms",
            const)
        # post-convergence symbols should decide correctly
        tail = slice(2000, L)
        d = np.argmin(np.abs(y[tail][:, :, None] - const[None, None, :]),
                      axis=2)
        d_ref = np.argmin(np.abs(tx[tail][:, :, None] - const[None, None, :]),
                          axis=2)
        assert np.mean(d != d_ref) < 1e-3
        assert np.mean(errSq[:, 2000:]) < np.mean(errSq[:, :200])

    def test_static_keeps_taps(self):
        rx, tx, const, *_ = _qpsk_mix(200)
        nTaps = 5
        H = np.zeros((4, nTaps), dtype=np.complex64)
        H[::3, nTaps // 2] = 1.0
        pad = np.pad(rx, ((nTaps // 2, nTaps // 2), (0, 0)))
        _, Hf, _, _, _ = C.coreAdaptEq(
            pad, tx, 1, H, np.zeros_like(H), 150, 1e-3, 0.99, nTaps, False,
            False, "static", const)
        np.testing.assert_array_equal(Hf, H)

    def test_store_coeff_history(self):
        rx, tx, const, *_ = _qpsk_mix(100)
        nTaps, L = 5, 80
        H = np.zeros((4, nTaps), dtype=np.complex64)
        H[::3, nTaps // 2] = 1.0
        pad = np.pad(rx, ((nTaps // 2, nTaps // 2), (0, 0)))
        _, _, _, _, Hiter = C.coreAdaptEq(
            pad, tx, 1, H, np.zeros_like(H), L, 1e-3, 0.99, nTaps, True,
            False, "nlms", const)
        assert Hiter.shape == (4, nTaps, L)
        assert not np.allclose(Hiter[..., 0], Hiter[..., -1])


class TestSISOCores:
    def _isi(self, n=4000, seed=3, complex_=True):
        rng = np.random.default_rng(seed)
        const = gray_mapping(4, "qam" if complex_ else "pam")
        const = const / np.sqrt(np.mean(np.abs(const) ** 2))
        tx = const[rng.integers(0, 4, n)]
        h = np.array([0.1, 1.0, 0.25])
        rx = np.convolve(tx, h, mode="same")
        if not complex_:
            tx, rx = tx.real, rx.real
        return rx, tx, (const if complex_ else const.real)

    def test_complex_ffe_reduces_isi(self):
        rx, tx, const = self._isi()
        # pre-pad so the center tap aligns with tx[k] (the reference cores
        # index windows from sample 0; callers pre-pad, equalization.py:1611)
        rx_pad = np.pad(rx, (3, 3))
        y, f, mse = C.complexValuedFFECore(rx_pad, tx, nTaps=7, mu=5e-3,
                                           nTrain=2000, constSymb=const)
        assert np.mean(mse[2500:3500]) < 0.3 * np.mean(mse[:50])

    def test_real_dfe_reduces_isi(self):
        rx, tx, const = self._isi(complex_=False)
        y, f, b, mse = C.realValuedDFECore(rx, tx, nTapsFF=7, nTapsFB=3,
                                           mu=5e-3, nTrain=2000,
                                           constSymb=const)
        assert np.mean(mse[2500:3500]) < np.mean(mse[:100])

    def test_volterra_core_runs_and_converges(self):
        rx, tx, const = self._isi(complex_=False)
        rx = rx + 0.05 * rx**2  # mild nonlinearity
        y, hs, mse = C.volterraCore(rx, tx, order=2, mu=2e-3, nTrain=2000,
                                    h1=np.zeros(7, np.float32),
                                    constSymb=const)
        assert len(hs) == 3
        assert np.mean(mse[2500:3500]) < np.mean(mse[:100])


class TestFECKernels:
    def test_encoder_systematic_valid_codewords(self):
        H = hamming_parity_check_matrix(3)
        G, _, Hs = par2gen(H)
        rng = np.random.default_rng(0)
        bits = rng.integers(0, 2, size=(G.shape[0], 10)).astype(np.uint8)
        cw = C.encoder(np.asarray(G), bits)
        assert cw.shape == (7, 10)
        # parity check against the column-permuted H returned by par2gen
        assert np.all((np.asarray(Hs, dtype=np.int64) @ cw) % 2 == 0)
        np.testing.assert_array_equal(cw[:4], bits)  # systematic prefix

    def test_encode_dvbs2_recursion(self):
        rng = np.random.default_rng(1)
        k, m, N = 8, 6, 5
        A = rng.integers(0, 2, size=(m, k)).astype(np.uint8)
        bits = rng.integers(0, 2, size=(k, N)).astype(np.uint8)
        cw = C.encodeDVBS2(bits, A)
        assert cw.shape == (k + m, N)
        a = (A.astype(np.int64) @ bits) % 2
        np.testing.assert_array_equal(cw[k], a[0])
        for i in range(1, m):
            np.testing.assert_array_equal(cw[k + i], (a[i] + cw[k + i - 1]) % 2)

    def test_encode_triang_sections(self):
        rng = np.random.default_rng(2)
        k, m1, m2, N = 6, 3, 4, 4
        P1 = rng.integers(0, 2, size=(m1, k)).astype(np.uint8)
        P2 = rng.integers(0, 2, size=(m2, k)).astype(np.uint8)
        bits = rng.integers(0, 2, size=(k, N)).astype(np.uint8)
        cw = C.encodeTriang(bits, P1, P2)
        assert cw.shape == (k + m1 + m2, N)
        np.testing.assert_array_equal(cw[k:k + m1],
                                      (P1.astype(np.int64) @ bits) % 2)

    @pytest.mark.parametrize("algo", ["spa", "msa"])
    def test_bp_corrects_single_error(self, algo):
        H = np.asarray(hamming_parity_check_matrix(3), dtype=np.uint8)
        checkNodes = [np.nonzero(H[i])[0] for i in range(H.shape[0])]
        varNodes = [np.nonzero(H[:, j])[0] for j in range(H.shape[1])]
        llr = 4.0 * np.ones((7, 2), dtype=np.float32)  # all-zero codewords
        llr[2, 0] = -3.0  # one flipped bit in the first codeword
        fn = C.sumProductAlgorithm if algo == "spa" else C.minSumAlgorithm
        out, n_iter, fail = fn(llr, checkNodes, varNodes, 10)
        assert np.all(out > 0)  # corrected back to the all-zero word
        assert np.all(fail == 0)


class TestMiscShims:
    def test_minR(self):
        assert C.minR(np.array([0.5, 1.0, 1.5]), 1.1) == 1

    def test_dot(self):
        assert C.dotNumba(np.array([1.0, 2.0]), np.array([3.0, 4.0])) == 11.0

    def test_checkGPU_bool(self):
        assert isinstance(C.checkGPU(), bool)

    def test_bpsGPU_matches_bps(self):
        rng = np.random.default_rng(0)
        const = gray_mapping(4, "qam")
        const = const / np.sqrt(np.mean(np.abs(const) ** 2))
        sig = const[rng.integers(0, 4, 256)] * np.exp(1j * 0.1)
        a = np.asarray(C.bpsGPU(sig, 8, const, 32))
        b = np.asarray(C.bps(sig, 8, const, 32))
        np.testing.assert_allclose(a, b)

    def test_randomCmap(self):
        cmap = C.randomCmap(nColors=7, seed=0)
        assert cmap.N == 7

    def test_condEntropy_finite(self):
        const = gray_mapping(4, "qam")
        const = const / np.sqrt(np.mean(np.abs(const) ** 2))
        pX = np.full(4, 0.25)
        v = C.condEntropy(0.3, 0.2, np.asarray(const), pX, 0, 0.3)
        assert np.isfinite(float(np.asarray(v)))

    def test_edfa_internals_roundtrip(self):
        # minimal spectral-Giles properties dict (the layout edfa_sm builds)
        n = 16
        freq = np.linspace(190e12, 196e12, n)
        props = {
            "algo": "Giles_spectrum",
            "freq": freq,
            "ASE": np.zeros(n),
            "uk": np.ones(n),
            "absCoef": np.full(n, 0.5),
            "gainCoef": np.full(n, 0.6),
            "lossS": 0.0,
            "noiseBand": 12.5e9,
            "b": 1.56e-6,
            "rho": 0.955e25,
            "tal": 10e-3,
        }
        props = C.updtCnst(props)
        P = np.full(n, 1e-4)
        n2 = np.asarray(C.getN2Pop(P, props))
        assert np.all((0 <= n2) & (n2 <= 1))
        rhs = np.asarray(C.gilesSpectrum(0.0, P, props))
        assert rhs.shape == P.shape and np.all(np.isfinite(rhs))
