"""The plain XLA recurrences against independent NumPy oracles.

Blind phase search, the decision-directed PLL, the FFE/DFE/Volterra
equalizers, the min-sum check update, Gardner clock recovery and the RLS
equalizer stages run as XLA scans and loops on every platform. Each test
below drives the public function and compares it with a straightforward
NumPy loop written from the reference's semantics (carrierRecovery.py,
equalization.py, clockRecovery.py, fec.py), in float32/complex64 so the
two differ only in rounding order.
"""

import jax
import jax.numpy as jnp
import numpy as np

from opticommpy_tpu.comm import modulate_gray
from opticommpy_tpu.comm.modulation import gray_mapping
from opticommpy_tpu.dsp import bps, ddpll
from opticommpy_tpu.ops import gaussian_complex_noise, phase_noise, pnorm


def _norm(c):
    c = np.asarray(c)
    return (c / np.sqrt(np.mean(np.abs(c) ** 2))).astype(np.complex64)


def _test_signal(n=3000, M=16, snr_db=22.0, lw_ts=2e-6, seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=n * int(np.log2(M)))
    tx = pnorm(modulate_gray(jnp.asarray(bits), M, "qam"))
    phi = phase_noise(k1, lw_ts, n, 1.0)
    noise = gaussian_complex_noise(k2, (n,), 10 ** (-snr_db / 10))
    return tx * jnp.exp(1j * phi) + noise, phi


# ---------------------------------------------------------------------------
# NumPy oracles
# ---------------------------------------------------------------------------


def _bps_np(sig, n_half, const, n_phases):
    """Blind phase search: min distance per test phase, windowed sum,
    argmin (carrierRecovery.py:172), window sums in float64."""
    sig = np.asarray(sig)
    squeeze = sig.ndim == 1
    sig = sig.reshape(sig.shape[0], -1)
    phases = (np.arange(n_phases) * (np.pi / 2) / n_phases).astype(np.float32)
    z = sig[:, :, None] * np.exp(1j * phases)[None, None, :]
    d = np.min(np.abs(z[..., None] - np.asarray(const)) ** 2, axis=-1)
    pad = np.pad(d.astype(np.float64), ((n_half + 1, n_half), (0, 0), (0, 0)))
    c = np.cumsum(pad, axis=0)
    sums = c[2 * n_half + 1:] - c[:-(2 * n_half + 1)]
    est = phases[np.argmin(sums, axis=-1)]
    return est[:, 0] if squeeze else est


def _ddpll_np(sig, ts, kv, tau1, tau2, const, symb_tx=None, pilot_ind=()):
    """Decision-directed PLL with the 2nd-order loop filter
    (carrierRecovery.py:226), one Python loop per mode."""
    sig = np.asarray(sig, np.complex64)
    squeeze = sig.ndim == 1
    sig = sig.reshape(sig.shape[0], -1)
    ref = (np.zeros_like(sig) if symb_tx is None
           else np.asarray(symb_tx, np.complex64).reshape(sig.shape[0], -1))
    pilot = np.zeros(sig.shape[0], bool)
    pilot[np.asarray(pilot_ind, int)] = True
    a1 = ts / (2 * tau1) * (1 - 1 / np.tan(ts / (2 * tau2)))
    a2 = ts / (2 * tau1) * (1 + 1 / np.tan(ts / (2 * tau2)))
    const = np.asarray(const)
    est = np.zeros(sig.shape, np.float32)
    for m in range(sig.shape[1]):
        phi = u_f = u_d = 0.0
        for k in range(sig.shape[0]):
            est[k, m] = phi
            eo = sig[k, m] * np.exp(1j * phi)
            dec = const[np.argmin(np.abs(eo - const))]
            target = ref[k, m] if pilot[k] else dec
            u_d1 = u_d
            u_d = float(np.imag(eo * np.conj(target)))
            u_f = u_f + a1 * u_d1 + a2 * u_d
            phi = phi - kv * u_f
    return est[:, 0] if squeeze else est


def _siso_np(sig, ref, n_ff, n_fb, mu, n_train, const, fulltime, sps=1,
             is_complex=True):
    """LMS FFE (n_fb=0) / DFE over pnorm'd inputs (equalization.py:1176,
    1545): data-aided for n_train symbols, then decision-directed."""
    sig = np.asarray(sig, np.complex64).reshape(-1)
    sig = sig / np.sqrt(np.mean(np.abs(sig) ** 2))
    ref = np.asarray(ref, np.complex64).reshape(-1)
    ref = ref / np.sqrt(np.mean(np.abs(ref) ** 2))
    xp = np.pad(sig, (n_ff // 2, n_ff // 2))
    n_out = (xp.shape[0] - n_ff + n_ff % 2) // sps
    f = np.zeros(n_ff, np.complex64)
    f[n_ff // 2] = 1.0
    b = np.zeros(n_fb, np.complex64)
    dbuf = np.zeros(n_fb, np.complex64)
    y = np.zeros(n_out, np.complex64)
    mse = np.zeros(n_out, np.float32)
    for k in range(n_out):
        win = xp[k * sps:k * sps + n_ff]
        yk = np.sum(f * win) + np.sum(b * dbuf)
        dec = const[np.argmin(np.abs(yk - const))]
        r = (ref[k] if k < ref.shape[0] else 0) if k < n_train else dec
        e = r - yk
        if fulltime or k < n_train:
            f = f + mu * e * (np.conj(win) if is_complex else win)
            b = b + mu * e * (np.conj(dbuf) if is_complex else dbuf)
        if n_fb:
            dbuf = np.roll(dbuf, 1)
            dbuf[0] = r
        y[k], mse[k] = yk, abs(e) ** 2
    return y, f, b, mse


def _check_msa_np(x):
    """Min-sum leave-one-out over axis 0: each slot gets the smallest
    magnitude and the sign parity of the OTHER slots."""
    x = np.asarray(x, np.float32)
    mag = np.abs(x)
    out = np.empty_like(x)
    neg = x < 0
    for i in range(x.shape[0]):
        others = np.delete(np.arange(x.shape[0]), i)
        sgn = (np.sum(neg[others], axis=0) % 2) == 1
        m = np.min(mag[others], axis=0)
        out[i] = np.where(sgn, -m, m)
    return out


def _flooding_bp_np(rows, cols, llr, max_iter, alpha=None):
    """Flooding min-sum BP on a sparse parity-check graph, with the
    decoders' freeze-on-convergence bookkeeping (fec.py:505-561)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    n_chk = int(rows.max()) + 1
    starts = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]])
    n, B = llr.shape
    E = rows.size
    eid = np.arange(E)[:, None]
    v2c = llr[cols].astype(np.float32)
    fT = llr.astype(np.float32).copy()
    done = np.zeros(B, bool)
    n_it = np.zeros(B, np.int32)
    for _ in range(max_iter):
        mag = np.abs(v2c)
        min1 = np.minimum.reduceat(mag, starts, axis=0)[rows]
        first = np.minimum.reduceat(np.where(mag == min1, eid, E), starts,
                                    axis=0)[rows]
        mag2 = np.where(eid == first, np.inf, mag)
        min2 = np.minimum.reduceat(mag2, starts, axis=0)[rows]
        om = np.where(eid == first, min2, min1)
        if alpha is not None:
            om = np.float32(alpha) * om
        neg = v2c < 0
        par = np.add.reduceat(neg.astype(np.int64), starts, axis=0)[rows] % 2
        c2v = np.where((par ^ neg) == 1, -om, om).astype(np.float32)
        T = llr.astype(np.float32).copy()
        np.add.at(T, cols, c2v)
        syn = np.add.reduceat((T[cols] < 0).astype(np.int64), starts,
                              axis=0) % 2
        ok = np.all(syn == 0, axis=0)
        assert syn.shape[0] == n_chk
        fT = np.where(done, fT, T)
        n_it = np.where(done, n_it, n_it + 1)
        done = done | ok
        v2c = T[cols] - c2v
    return fT, n_it, ~done


def _gardner_np(col, kp, ki, nyquist, n_out):
    """Gardner TED + cubic Farrow interpolator + PI loop + NCO skip/stuff
    (clockRecovery.py:85-171), complex64/float32."""
    col = np.asarray(col, np.complex64)
    n_in = col.shape[0]
    eo = np.zeros(n_out, np.complex64)
    tv = np.zeros(n_out, np.float32)
    n, m = 2, 2
    int_part = np.float32(0.0)
    t = np.float32(0.0)
    while n < n_out - 1 and m < n_in - 2:
        x = col[m - 2:m + 2]
        eo[n] = (x[0] * (-t**3 / 6 + t / 6) + x[1] * (t**3 / 2 + t**2 / 2 - t)
                 + x[2] * (-t**3 / 2 - t**2 + t / 2 + 1)
                 + x[3] * (t**3 / 6 + t**2 / 2 + t / 3))
        if n % 2 == 0:
            s = eo[n - 2:n + 1]
            if nyquist:
                ted = abs(s[1]) ** 2 * (abs(s[0]) ** 2 - abs(s[2]) ** 2)
            else:
                ted = np.real(np.conj(s[1]) * (s[2] - s[0]))
            int_part = np.float32(ki * ted + int_part)
            t = np.float32(t - (kp * ted + int_part))
        if t > 1:
            t, dn, dm = np.float32(t - 1), -1, 0
        elif t < -1:
            t, dn, dm = np.float32(t + 1), 2, 1
        else:
            dn, dm = 1, 1
        n, m = n + dn, m + dm
        tv[min(max(n, 0), n_out - 1)] = t
    return eo[:n], tv[:n]


# ---------------------------------------------------------------------------
# blind phase search (XLA broadcast formulation)
# ---------------------------------------------------------------------------


def test_bps_matches_numpy_oracle():
    sig, _ = _test_signal()
    const = _norm(gray_mapping(16, "qam"))
    est = np.asarray(bps(sig, 16, jnp.asarray(const), 64))
    ref = _bps_np(sig, 16, const, 64)
    # identical argmin decisions except f32 near-ties
    assert np.mean(np.abs(est - ref) > 1e-6) < 0.01


def test_bps_tracks_phase():
    sig, phi = _test_signal(seed=1)
    const = _norm(gray_mapping(16, "qam"))
    est = np.asarray(bps(sig, 16, jnp.asarray(const), 64))
    err = np.angle(np.exp(1j * 4 * (est + np.asarray(phi)))) / 4
    assert np.std(err[200:-200]) < 0.05
    assert np.mean(np.abs(est - _bps_np(sig, 16, const, 64)) > 1e-6) < 0.01


def test_bps_two_modes_odd_length_matches_numpy():
    s1, _ = _test_signal(n=1111, seed=2)
    s2, _ = _test_signal(n=1111, seed=3)
    sig = jnp.stack([s1, s2], axis=1)
    const = _norm(gray_mapping(16, "qam"))
    est = np.asarray(bps(sig, 8, jnp.asarray(const), 32))
    assert est.shape == (1111, 2)
    assert np.mean(np.abs(est - _bps_np(sig, 8, const, 32)) > 1e-6) < 0.02


def test_bps_nonsquare_constellation_matches_numpy():
    """8-PSK: distances are pi/4-periodic in phase, so test phases pi/4
    apart tie exactly; compare modulo that symmetry."""
    rng = np.random.default_rng(4)
    n = 1500
    tx = pnorm(modulate_gray(jnp.asarray(rng.integers(0, 2, size=n * 3)), 8,
                             "psk"))
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    phi = phase_noise(k1, 1e-6, n, 1.0)
    sig = tx * jnp.exp(1j * phi) + gaussian_complex_noise(k2, (n,), 10 ** -2.2)
    const = _norm(gray_mapping(8, "psk"))
    est = np.asarray(bps(sig, 12, jnp.asarray(const), 64))
    ref = _bps_np(sig, 12, const, 64)
    d = np.angle(np.exp(1j * 8 * (est - ref))) / 8
    assert np.mean(np.abs(d) > 1e-4) < 0.02


def test_bps_three_modes_matches_numpy():
    sig = jnp.stack([_test_signal(n=900, seed=s)[0] for s in (5, 6, 7)],
                    axis=1)
    const = _norm(gray_mapping(16, "qam"))
    est = np.asarray(bps(sig, 10, jnp.asarray(const), 64))
    assert est.shape == (900, 3)
    assert np.mean(np.abs(est - _bps_np(sig, 10, const, 64)) > 1e-6) < 0.02


# ---------------------------------------------------------------------------
# decision-directed PLL
# ---------------------------------------------------------------------------


def test_ddpll_matches_numpy_oracle():
    sig, _ = _test_signal(n=2000, M=4, snr_db=25.0, lw_ts=1e-7, seed=4)
    sig2 = jnp.stack([sig, sig * jnp.exp(1j * 0.1)], axis=1)
    const = _norm(gray_mapping(4, "qam"))
    ts = 1 / 32e9
    t1 = t2 = 1 / (2 * np.pi * 10e6)
    est = np.asarray(ddpll(sig2, ts, 0.1, t1, t2, jnp.asarray(const)))
    ref = _ddpll_np(sig2, ts, 0.1, t1, t2, const)
    assert np.allclose(est, ref, atol=2e-4)


def test_ddpll_with_pilots_matches_numpy():
    sig, phi = _test_signal(n=3000, M=16, snr_db=25.0, lw_ts=1e-7, seed=5)
    const = _norm(gray_mapping(16, "qam"))
    tx = sig * jnp.exp(-1j * jnp.asarray(phi))
    ts = 1 / 32e9
    t1 = t2 = 1 / (2 * np.pi * 10e6)
    pil = np.arange(0, 3000, 20)
    est = np.asarray(ddpll(sig, ts, 0.1, t1, t2, jnp.asarray(const),
                           symb_tx=tx, pilot_ind=jnp.asarray(pil)))
    ref = _ddpll_np(sig, ts, 0.1, t1, t2, const, np.asarray(tx), pil)
    assert np.allclose(est, ref, atol=2e-4)
    err = np.angle(np.exp(1j * 4 * (est + np.asarray(phi)))) / 4
    assert np.std(err[1000:]) < 0.08


def test_ddpll_columns_are_independent():
    """B polmux signals side by side on the mode axis == each run alone."""
    const = _norm(gray_mapping(4, "qam"))
    rng = np.random.default_rng(0)
    b, n = 4, 700
    sym = const[rng.integers(0, 4, size=(n, 2 * b))]
    phase = np.cumsum(rng.normal(0, 0.01, size=(n, 1)), axis=0)
    sig = (sym * np.exp(1j * phase)).astype(np.complex64)
    ts, kv, tau1, tau2 = 1 / 32e9, 0.1, 1 / (2 * np.pi * 1e6), 1e-9
    est = np.asarray(ddpll(jnp.asarray(sig), ts, kv, tau1, tau2,
                           jnp.asarray(const)))
    assert est.shape == (n, 2 * b)
    for i in range(b):
        est_i = np.asarray(ddpll(jnp.asarray(sig[:, 2 * i:2 * i + 2]), ts,
                                 kv, tau1, tau2, jnp.asarray(const)))
        np.testing.assert_allclose(est[:, 2 * i:2 * i + 2], est_i,
                                   rtol=1e-5, atol=1e-7)
    ref = _ddpll_np(sig[:, :2], ts, kv, tau1, tau2, const)
    np.testing.assert_allclose(est[:, :2], ref, atol=2e-4)


# ---------------------------------------------------------------------------
# FFE / DFE / Volterra (XLA scans; vmapped at batch in imdd_dsp_chain_batch)
# ---------------------------------------------------------------------------


def test_dfe_matches_numpy_oracle_and_vmaps():
    from opticommpy_tpu.dsp.equalization import DFEConfig, dfe

    rng = np.random.default_rng(0)
    const = gray_mapping(4, "pam").real
    sym = const[rng.integers(0, 4, size=3000)].astype(np.complex64)
    h = np.array([0.15, 1.0, 0.3, -0.1], np.complex64)
    x = np.convolve(sym, h, "same") + 0.02 * rng.normal(size=sym.shape)
    cfg = DFEConfig(nTapsFF=7, nTapsFB=5, SpS=1, mu=2e-3, nTrain=1200, M=4,
                    constType="pam")
    y, f, b, mse = dfe(jnp.asarray(x), jnp.asarray(sym), cfg)
    y_np, f_np, b_np, _ = _siso_np(x, sym, 7, 5, 2e-3, 1200,
                                   _norm(gray_mapping(4, "pam")), False,
                                   is_complex=False)
    assert np.linalg.norm(np.asarray(y) - y_np.real) / np.linalg.norm(
        y_np) < 1e-4
    assert np.linalg.norm(np.asarray(f) - f_np) / np.linalg.norm(f_np) < 1e-4
    sym_n = np.asarray(pnorm(jnp.asarray(sym)))
    assert np.mean(np.abs(np.asarray(y)[1500:] - sym_n[1500:]) ** 2) < 0.05

    # a batch of two different signals == per-signal runs
    x2 = np.convolve(sym[::-1], h, "same") + 0.02 * rng.normal(size=sym.shape)
    yb = jax.vmap(lambda s, r: dfe(s, r, cfg)[0])(
        jnp.asarray(np.stack([x, x2])), jnp.asarray(np.stack([sym, sym[::-1]])))
    y2, _, _, _ = dfe(jnp.asarray(x2), jnp.asarray(sym[::-1]), cfg)
    np.testing.assert_allclose(np.asarray(yb[1]), np.asarray(y2),
                               rtol=1e-5, atol=1e-6)


def test_dfe_fulltime_qam_matches_numpy():
    from opticommpy_tpu.dsp.equalization import DFEConfig, dfe

    rng = np.random.default_rng(1)
    const = _norm(gray_mapping(4, "qam"))
    sym = const[rng.integers(0, 4, size=2000)]
    h = np.array([0.1 + 0.05j, 1.0, 0.2 - 0.1j], np.complex64)
    x = np.convolve(sym, h, "same") + 0.02 * (
        rng.normal(size=sym.shape) + 1j * rng.normal(size=sym.shape))
    cfg = DFEConfig(nTapsFF=7, nTapsFB=3, SpS=1, mu=2e-3, nTrain=800, M=4,
                    constType="qam", trainingMode="fulltime")
    y, f, _, _ = dfe(jnp.asarray(x), jnp.asarray(sym), cfg)
    y_np, f_np, _, _ = _siso_np(x, sym, 7, 3, 2e-3, 800, const, True)
    assert np.linalg.norm(np.asarray(y) - y_np) / np.linalg.norm(y_np) < 1e-4
    assert np.linalg.norm(np.asarray(f) - f_np) / np.linalg.norm(f_np) < 1e-4


def test_ffe_matches_numpy_oracle_and_vmaps():
    from opticommpy_tpu.dsp.equalization import FFEConfig, ffe

    rng = np.random.default_rng(2)
    const = gray_mapping(4, "pam").real
    sym = const[rng.integers(0, 4, size=2500)].astype(np.complex64)
    h = np.array([0.2, 1.0, 0.25], np.complex64)
    x = np.convolve(sym, h, "same") + 0.02 * rng.normal(size=sym.shape)
    cfg = FFEConfig(nTaps=9, SpS=1, mu=2e-3, nTrain=1000, M=4,
                    constType="pam")
    y, f, _ = ffe(jnp.asarray(x), jnp.asarray(sym), cfg)
    y_np, f_np, _, _ = _siso_np(x, sym, 9, 0, 2e-3, 1000,
                                _norm(gray_mapping(4, "pam")), False,
                                is_complex=False)
    assert np.linalg.norm(np.asarray(y) - y_np.real) / np.linalg.norm(
        y_np) < 1e-4
    assert np.linalg.norm(np.asarray(f) - f_np) / np.linalg.norm(f_np) < 1e-4
    yb = jax.vmap(lambda s, r: ffe(s, r, cfg)[0])(
        jnp.asarray(np.stack([x, x])), jnp.asarray(np.stack([sym, sym])))
    np.testing.assert_allclose(np.asarray(yb[0]), np.asarray(y),
                               rtol=1e-5, atol=1e-6)


def test_volterra_matches_numpy_oracle_and_vmaps():
    from opticommpy_tpu.dsp.equalization import VolterraConfig, volterra

    rng = np.random.default_rng(4)
    n_sym, sps = 1200, 2
    sym = (2 * rng.integers(0, 4, size=n_sym) - 3).astype(np.float32)
    sig = np.repeat(sym, sps) + 0.1 * rng.normal(size=n_sym * sps)
    sig = (sig + 0.05 * sig**2).astype(np.float32)
    cfg = VolterraConfig(n1Taps=13, n2Taps=7, n3Taps=5, SpS=sps, mu=1e-3,
                         nTrain=500, order=3, M=4, constType="pam")
    y, hs, mse = volterra(jnp.asarray(sig), jnp.asarray(sym), cfg)

    # NumPy oracle (equalization.py:1868): 3rd-order kernels on the
    # centred sub-windows, data-aided then decision-directed
    x = sig / np.sqrt(np.mean(sig**2))
    x = (x / np.max(np.abs(x))).astype(np.float32)
    r = (sym / np.sqrt(np.mean(sym**2))).astype(np.float32)
    const = np.real(_norm(gray_mapping(4, "pam"))).astype(np.float32)
    xp = np.pad(x, (6, 6))
    n_out = (xp.shape[0] - 13 + 1) // sps
    h1 = np.zeros(13, np.float32)
    h1[6] = 1.0
    h2 = np.zeros((7, 7), np.float32)
    h3 = np.zeros((5, 5, 5), np.float32)
    y_np = np.zeros(n_out, np.float32)
    for k in range(n_out):
        win = xp[k * sps:k * sps + 13]
        x2, x3 = win[3:10], win[4:9]
        o2 = np.outer(x2, x2)
        o3 = x3[:, None, None] * x3[None, :, None] * x3[None, None, :]
        yk = np.sum(h1 * win) + np.sum(h2 * o2) + np.sum(h3 * o3)
        dec = const[np.argmin(np.abs(yk - const))]
        e = (r[k] if k < r.shape[0] else 0.0) if k < 500 else dec
        e = e - yk
        if k < 500:
            h1 = h1 + 1e-3 * e * win
            h2 = h2 + 1e-3 / 2 * e * o2
            h3 = h3 + 1e-3 / 7 * e * o3
        y_np[k] = yk
    y_np = y_np / np.sqrt(np.mean(y_np**2))
    assert np.allclose(np.asarray(y), y_np, atol=1e-4)
    assert np.allclose(np.asarray(hs[0]), h1, atol=1e-4)
    assert np.allclose(np.asarray(hs[2]), h3, atol=1e-4)

    sig2 = (sig + 0.05 * rng.normal(size=sig.shape)).astype(np.float32)
    yb = jax.vmap(lambda s, r: volterra(s, r, cfg)[0])(
        jnp.asarray(np.stack([sig, sig2])), jnp.asarray(np.stack([sym, sym])))
    assert np.allclose(np.asarray(yb[0]), np.asarray(y), atol=1e-6)
    assert not np.allclose(np.asarray(yb[1]), np.asarray(y))


# ---------------------------------------------------------------------------
# LDPC check update and flooding decoders
# ---------------------------------------------------------------------------


def test_check_msa_slots_matches_numpy_oracle():
    """The XLA min-sum check update (fec_qc._check_msa_slots) equals the
    NumPy leave-one-out bit for bit: f32 and bf16, plain and normalized,
    with the masked (+inf) staircase slot."""
    from opticommpy_tpu.comm import fec_qc

    rng = np.random.default_rng(0)
    x = rng.normal(size=(18, 2, 36, 16)).astype(np.float32)
    for dt in (jnp.float32, jnp.bfloat16):
        xj = jnp.asarray(x).astype(dt).at[17, 0, 0].set(jnp.inf)
        ref = _check_msa_np(np.asarray(xj.astype(jnp.float32)))
        for alpha in (None, 0.75):
            out = fec_qc._check_msa_slots(xj)
            want = ref
            if alpha is not None:
                out = (alpha * out.astype(jnp.float32)).astype(dt)
                want = np.asarray(jnp.asarray(alpha * ref).astype(dt)
                                  .astype(jnp.float32))
            else:
                want = np.asarray(jnp.asarray(ref).astype(dt)
                                  .astype(jnp.float32))
            assert out.dtype == dt
            np.testing.assert_array_equal(
                np.asarray(out.astype(jnp.float32)), want)


def test_qc_decoder_matches_numpy_flooding_oracle():
    """The XLA DVB-S2 QC decoder == a plain NumPy flooding NMSA decoder on
    the sparse graph: iteration counts, failure flags, totals (f32)."""
    from opticommpy_tpu.comm import fec_qc
    from opticommpy_tpu.comm.fec import standard_ldpc

    n, R = 64800, "4/5"
    _, edges = standard_ldpc("DVBS2", n, R)
    rng = np.random.default_rng(31)
    llrs = (1.4 + rng.normal(scale=1.5, size=(n, 3))).astype(np.float32)
    dec = fec_qc.make_qc_decoder(n, R, 3, "NMSA", "f32")
    out, iters, fail = dec(jnp.asarray(llrs))
    out_o, iters_o, fail_o = _flooding_bp_np(edges[2], edges[3], llrs, 3,
                                             alpha=0.75)
    assert np.array_equal(np.asarray(iters), iters_o)
    assert np.array_equal(np.asarray(fail), fail_o)
    got = np.asarray(out, np.float32)
    assert np.abs(got - out_o).max() / np.abs(out_o).max() < 1e-5


def test_lift_decoder_matches_numpy_flooding_oracle():
    """The XLA AR4JA lift decoder, fixed and early-exit, == the NumPy
    flooding oracle (f32 MSA): decisions, iteration counts, fail flags."""
    from opticommpy_tpu.comm import fec_lift
    from opticommpy_tpu.comm.fec import standard_ldpc

    graph, edges = standard_ldpc("AR4JA", 2048, "1/2")
    n_cols = graph["n"]
    rng = np.random.default_rng(13)
    llrs = (rng.normal(size=(n_cols, 6)) * 2 + 1.5).astype(np.float32)
    out_o, iters_o, fail_o = _flooding_bp_np(edges[2], edges[3], llrs, 12)
    for ee in (False, True):
        dec = fec_lift.make_lift_decoder("AR4JA", 2048, "1/2", 12, "MSA",
                                         "f32", ee)
        out, iters, fail = dec(jnp.asarray(llrs))
        assert np.array_equal(np.asarray(iters), iters_o), ee
        assert np.array_equal(np.asarray(fail), fail_o), ee
        assert np.array_equal(np.asarray(out) < 0, out_o < 0), ee
        rel = np.abs(np.asarray(out) - out_o).max() / np.abs(out_o).max()
        assert rel < 1e-5, (ee, rel)


# ---------------------------------------------------------------------------
# Gardner clock recovery (while_loop)
# ---------------------------------------------------------------------------


def _offset_qpsk(n_sym, ppm, seed, modes=1):
    from opticommpy_tpu.ops import (clock_sampling_interp, fir_filter,
                                    pulse_shape, upsample)

    rng = np.random.default_rng(seed)
    cols = []
    for _ in range(modes):
        symb = pnorm(modulate_gray(
            jnp.asarray(rng.integers(0, 2, size=2 * n_sym)), 4, "qam"))
        cols.append(fir_filter(jnp.asarray(pulse_shape("rrc", 2, 512, 0.2)),
                               upsample(symb, 2)))
    sig = cols[0] if modes == 1 else jnp.stack(cols, axis=1)
    return clock_sampling_interp(sig, 1.0, 1.0 / (1 + ppm * 1e-6))


def test_gardner_matches_numpy_oracle():
    from opticommpy_tpu.dsp import ClockRecoveryConfig, gardner_clock_recovery

    sig_off = _offset_qpsk(5000, 300, 7)
    cfg = ClockRecoveryConfig(kp=2e-3, ki=1e-5, isNyquist=False)
    rec, tv = gardner_clock_recovery(sig_off, cfg, return_timing=True)
    x = np.pad(np.asarray(sig_off), (0, cfg.lpad))
    n_out = int((1 - cfg.maxPPM / 1e6) * x.shape[0])
    rec_np, tv_np = _gardner_np(x, cfg.kp, cfg.ki, False, n_out)
    assert abs(rec.shape[0] - rec_np.shape[0]) <= 2
    nl = min(rec.shape[0], rec_np.shape[0])
    assert np.max(np.abs(np.asarray(rec)[:nl] - rec_np[:nl])) < 1e-4
    assert np.max(np.abs(np.asarray(tv)[:nl] - tv_np[:nl])) < 1e-4


def test_gardner_two_modes_nyquist_matches_numpy():
    from opticommpy_tpu.dsp import ClockRecoveryConfig, gardner_clock_recovery

    sig_off = _offset_qpsk(3001, -150, 8, modes=2)
    cfg = ClockRecoveryConfig()  # isNyquist=True default
    rec = gardner_clock_recovery(sig_off, cfg)
    assert rec.ndim == 2 and rec.shape[1] == 2
    x = np.pad(np.asarray(sig_off), ((0, cfg.lpad), (0, 0)))
    n_out = int((1 - cfg.maxPPM / 1e6) * x.shape[0])
    for m in range(2):
        rec_np, _ = _gardner_np(x[:, m], cfg.kp, cfg.ki, True, n_out)
        nl = min(rec.shape[0], rec_np.shape[0])
        assert np.max(np.abs(np.asarray(rec)[:nl, m] - rec_np[:nl])) < 1e-4


# ---------------------------------------------------------------------------
# RLS / DD-RLS equalizer stages (lax.scan) against the reference loop
# ---------------------------------------------------------------------------


def _qam_modes(key, n_sym, n_modes, sps=2):
    from opticommpy_tpu.ops import fir_filter, pulse_shape, upsample

    symb = pnorm(modulate_gray(
        jax.random.randint(key, (n_sym * 4 * n_modes,), 0, 2), 16, "qam"
    ).reshape(n_sym, n_modes))
    pulse = jnp.asarray(pulse_shape("rrc", sps, 256, 0.1))
    return pnorm(fir_filter(pulse, upsample(symb, sps))), symb


def _core_adapt_eq(sig, ref, alg, n_taps, lam, n_modes, M=16):
    """compat.coreAdaptEq (the reference's NumPy loop) from the central
    spike, on the same padding as mimo_adapt_equalizer."""
    from opticommpy_tpu import compat

    H = np.zeros((n_modes * n_modes, n_taps), np.complex64)
    H[::n_modes + 1, n_taps // 2] = 1.0
    pad = np.pad(np.asarray(sig), ((n_taps // 2, n_taps // 2 + 2 + n_taps),
                                   (0, 0)))
    L = int(np.fix((sig.shape[0] + 2 * (n_taps // 2) - n_taps) / 2 + 1))
    y, Hf, _, _, _ = compat.coreAdaptEq(
        pad, np.asarray(ref), 2, H, np.zeros_like(H), L, 1e-3, lam, n_taps,
        False, False, alg, _norm(gray_mapping(M, "qam")))
    return y, Hf.reshape(n_modes, n_modes, n_taps).transpose(1, 0, 2)


def test_rls_scan_matches_reference_loop():
    from opticommpy_tpu.dsp import MIMOEqualizerConfig, mimo_adapt_equalizer

    sig, symb = _qam_modes(jax.random.PRNGKey(21), 2000, 2)
    for alg in ("rls", "dd-rls"):
        cfg = MIMOEqualizerConfig(nTaps=7, lambdaRLS=0.999, SpS=2,
                                  alg=(alg,), M=16)
        y, H, _, _, _ = mimo_adapt_equalizer(sig, cfg, symb_ref=symb,
                                             return_results=True)
        y_np, H_np = _core_adapt_eq(sig, symb, alg, 7, 0.999, 2)
        n = min(y.shape[0], y_np.shape[0])
        assert np.allclose(np.asarray(y)[:n], y_np[:n], atol=2e-4), alg
        assert np.allclose(np.asarray(H), H_np, atol=2e-4), alg


def test_rls_batch_matches_reference_loop():
    from opticommpy_tpu.dsp import MIMOEqualizerConfig
    from opticommpy_tpu.dsp.equalization import mimo_adapt_equalizer_batch

    sigs, symbs = zip(*[_qam_modes(jax.random.PRNGKey(30 + b), 400, 2)
                        for b in range(3)])
    cfg = MIMOEqualizerConfig(nTaps=7, lambdaRLS=0.999, SpS=2,
                              alg=("dd-rls",), M=16)
    yb = mimo_adapt_equalizer_batch(jnp.stack(sigs), cfg,
                                    symb_ref=jnp.stack(symbs))
    for b in range(3):
        y_np, _ = _core_adapt_eq(sigs[b], symbs[b], "dd-rls", 7, 0.999, 2)
        n = min(yb.shape[1], y_np.shape[0])
        assert np.allclose(np.asarray(yb[b])[:n], y_np[:n], atol=2e-4), b


def test_rls_4x4_matches_reference_loop():
    from opticommpy_tpu.dsp import MIMOEqualizerConfig, mimo_adapt_equalizer

    sig, symb = _qam_modes(jax.random.PRNGKey(22), 1200, 4)
    cfg = MIMOEqualizerConfig(nTaps=5, lambdaRLS=0.999, SpS=2, alg=("rls",),
                              M=16)
    y, H, _, _, _ = mimo_adapt_equalizer(sig, cfg, symb_ref=symb,
                                         return_results=True)
    y_np, H_np = _core_adapt_eq(sig, symb, "rls", 5, 0.999, 4)
    n = min(y.shape[0], y_np.shape[0])
    assert np.allclose(np.asarray(y)[:n], y_np[:n], atol=2e-4)
    assert np.allclose(np.asarray(H), H_np, atol=2e-4)
