"""Native C++ host-side loaders (opticommpy_tpu.native).

The ALIST loader replaces the reference's pure-Python parser
(fec.py:811 readAlist) with a one-pass C++ tokenizer; these tests pin
native-vs-Python agreement and the fallback path.
"""

import os

import numpy as np
import pytest

from opticommpy_tpu import native
from opticommpy_tpu.comm import fec

ALIST_DIR = "/root/reference/optic/comm/ALIST"
SMALL = os.path.join(ALIST_DIR, "LDPC_IEEE_802.11nD2_648b_R12.txt")

needs_alist = pytest.mark.skipif(
    not os.path.exists(SMALL), reason="reference ALIST assets not mounted"
)


def _python_edges(path):
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    n, m = map(int, lines[0].split())
    rows, cols = [], []
    for j, line in enumerate(lines[4 : 4 + n]):
        for entry in map(int, line.split()):
            if entry > 0:
                rows.append(entry - 1)
                cols.append(j)
    return n, m, np.asarray(rows, np.int32), np.asarray(cols, np.int32)


@needs_alist
def test_native_matches_python_parser():
    if not native.native_available():
        pytest.skip("native toolchain unavailable")
    n, m, rows, cols = native.alist_edges(SMALL)
    n2, m2, rows2, cols2 = _python_edges(SMALL)
    assert (n, m) == (n2, m2)
    # same edge set (orderings may differ in principle; sort pairs)
    got = np.lexsort((rows, cols))
    want = np.lexsort((rows2, cols2))
    np.testing.assert_array_equal(rows[got], rows2[want])
    np.testing.assert_array_equal(cols[got], cols2[want])


@needs_alist
def test_read_alist_dense_roundtrip_native():
    H = fec.read_alist(SMALL)
    assert H.shape == (324, 648)
    info = fec.parse_alist(SMALL)
    assert info["n"] == 648 and info["m"] == 324
    assert info["max_col_w"] == int(H.sum(axis=0).max())
    assert info["max_row_w"] == int(H.sum(axis=1).max())


@needs_alist
def test_python_fallback_env_gate(monkeypatch, tmp_path):
    # force the fallback and check identical output
    H_native = fec.read_alist(SMALL)
    monkeypatch.setenv("OPTICOMMPY_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_TRIED", False)
    H_py = fec.read_alist(SMALL)
    np.testing.assert_array_equal(H_native, H_py)


def test_native_rejects_garbage(tmp_path):
    if not native.native_available():
        pytest.skip("native toolchain unavailable")
    bad = tmp_path / "bad.txt"
    bad.write_text("not an alist\n1 2 x\n")
    assert native.alist_edges(str(bad)) is None
    missing = tmp_path / "missing.txt"
    assert native.alist_edges(str(missing)) is None


def test_native_roundtrip_written_alist(tmp_path):
    rng = np.random.default_rng(3)
    H = (rng.random((24, 48)) < 0.15).astype(np.uint8)
    H[:, H.sum(axis=0) == 0] = 1  # no empty columns (valid alist)
    path = tmp_path / "h.alist"
    fec.write_alist(H, str(path))
    H2 = fec.read_alist(str(path))
    np.testing.assert_array_equal(H, H2)


def test_gf2_rref_matches_numpy():
    """Native bit-packed rref == the NumPy elimination, incl. rank-deficient."""
    if not native.native_available():
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(5)
    for _ in range(10):
        m = int(rng.integers(1, 80))
        n = int(rng.integers(1, 200))
        M = (rng.random((m, n)) < float(rng.uniform(0.05, 0.5))).astype(np.uint8)
        if m > 3:
            M[m // 2] = M[0] ^ M[-1]  # force linear dependence
        got = native.gf2_rref(M)
        # reference: the pure-NumPy path (force it via the env gate)
        want = _numpy_rref(M)
        np.testing.assert_array_equal(got, want)


def _numpy_rref(M):
    M = np.array(M, dtype=np.uint8) % 2
    rows, cols = M.shape
    lead = 0
    for r in range(rows):
        if lead >= cols:
            break
        pr = np.nonzero(M[r:, lead])[0]
        while pr.size == 0:
            lead += 1
            if lead == cols:
                return M
            pr = np.nonzero(M[r:, lead])[0]
        i = r + pr[0]
        if i != r:
            M[[r, i]] = M[[i, r]]
        mask = M[:, lead].copy()
        mask[r] = 0
        M[mask == 1] ^= M[r]
        lead += 1
    return M


def test_gauss_elim_gf2_native_path_via_par2gen():
    """A matrix above the native-dispatch threshold still yields G ⟂ Hm."""
    from opticommpy_tpu.comm.fec import gallager_ldpc, par2gen

    H = gallager_ldpc(504, 3, 6, seed=2)  # 252x504 elements > 2^16 threshold
    G, _, Hm = par2gen(H)
    prod = (G.astype(np.int64) @ Hm.T.astype(np.int64)) % 2
    assert not prod.any()
