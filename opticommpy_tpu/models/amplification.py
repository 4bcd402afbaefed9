"""Physical EDFA model: Giles rate/propagation equations with AGC/APC control.

Counterpart of reference ``optic/models/amplification.py``.
This subsystem is *host-side by design* (SURVEY.md §7): it is a two-point
boundary-value ODE (forward signal/ASE/pump vs backward pump/ASE) solved with
``scipy.integrate.solve_ivp`` relaxation plus a PID gain/power-control loop —
offline amplifier characterization, not a per-sample hot path. The signal
enters/leaves in the frequency domain via (jittable) FFTs.

Differences from the reference:
- the PID controller is implemented inline (no ``simple_pid`` dependency),
- EDF cross-section data loads from any Giles-format text file (two or three
  columns: wavelength, absorption, gain), from the built-in MP980-class
  Gaussian-band model fitted to the reference's measured Giles file
  (``file="MP980"``, :func:`mp980_edf_data`, ~1% of peak), or from a coarser
  analytic stand-in (:func:`synthetic_edf_data`) — the model runs without
  external data assets either way.

Reference citations: gilesSpectrum (amplification.py:139), gilesSpatial
(:163), getN2Pop (:197), getOverlapInt (:229), get_mode_radius (:255),
edfParams (:285), edfaArgs (:359), edfaSM (:420), OSA/get_spectrum (:59,:96).
"""

from dataclasses import dataclass

import numpy as np
from scipy.constants import Planck, c
from scipy.integrate import solve_ivp
from scipy.special import jv, kv

__all__ = [
    "EDFASMConfig",
    "synthetic_edf_data",
    "mp980_edf_data",
    "get_mode_radius",
    "edf_params",
    "edfa_sm",
    "get_spectrum",
]


@dataclass(frozen=True)
class EDFASMConfig:
    """Physical EDFA parameters (reference edfaArgs defaults, :359-397)."""

    type: str = "AGC"  # 'AGC' | 'APC' | 'none'
    value: float = 20.0  # dB (AGC) or dBm (APC)
    kp: float = 1e-2
    ki: float = 1e-2
    kd: float = 5e-2
    file: str = ""  # Giles data file; empty -> synthetic EDF data
    fileunit: str = "nm"
    a: float = 1.56e-6  # core radius [m]
    b: float = 1.56e-6  # doping radius [m]
    rho: float = 0.955e25  # Er density [1/m^3]
    na: float = 0.22
    gmtc: str = "LP01"
    algo: str = "Giles_spectrum"  # | 'Giles_spatial'
    lngth: float = 8.0  # EDF length [m]
    tal: float = 10e-3  # metastable lifetime [s]
    lossS: float = 2.08e-4 * np.log10(10)
    lossP: float = 2.08e-4 * np.log10(10)
    forPumpW: tuple = (100e-3,)
    forPumpLambda: tuple = (980e-9,)
    bckPumpW: tuple = (100e-3,)
    bckPumpLambda: tuple = (980e-9,)
    longSteps: int = 100
    tol: float = 2e-2
    tolCtrl: float = 0.5  # dB
    noiseBand: float = 125e9


def synthetic_edf_data(n_points=200):
    """Analytic stand-in for an MP980-style Giles data file.

    Returns (wavelength [m], absorption coef [1/m], gain coef [1/m]) built
    from Gaussian approximations of the erbium C-band absorption/emission
    peaks (plus the 980 nm pump absorption band). Values are representative,
    not measurements of a specific fiber.
    """
    lam = np.concatenate(
        [np.linspace(960e-9, 1000e-9, 40), np.linspace(1440e-9, 1620e-9, n_points)]
    )
    lam_nm = lam * 1e9

    def g(x, mu, sig, amp):
        return amp * np.exp(-((x - mu) ** 2) / (2 * sig**2))

    # absorption: 980 pump band + 1530 peak + 1490 shoulder
    alpha = (
        g(lam_nm, 980, 10, 2.7)
        + g(lam_nm, 1530, 9, 3.4)
        + g(lam_nm, 1545, 25, 1.1)
        + g(lam_nm, 1490, 30, 0.7)
    )
    # emission: shifted toward 1535-1560
    gstar = (
        g(lam_nm, 1531, 8, 3.3)
        + g(lam_nm, 1550, 22, 1.6)
        + g(lam_nm, 1560, 35, 0.7)
    )
    # convert dB/m-like magnitudes to 1/m
    to_lin = 0.1 * np.log(10)
    return lam, to_lin * alpha, to_lin * gstar


def mp980_edf_data(n_points=600):
    """MP980-class erbium fiber Giles spectra from a Gaussian-band model.

    Returns (wavelength [m], absorption [dB/m], gain [dB/m]) over
    875-1650 nm, matching the measured MP980 Giles parameter file the
    reference ships (`optic/models/ampParams/giles_MP980.dat`, consumed at
    amplification.py:289) to ~1% of peak. The measured asset itself is not
    redistributed; the curves are reconstructed from fitted Gaussian band
    coefficients (Stark-manifold decomposition, tools/fit_edf_gaussians.py)
    stored in :mod:`opticommpy_tpu.models._edf_mp980`.

    Select with ``EDFASMConfig(file="MP980")``.
    """
    from opticommpy_tpu.models import _edf_mp980 as t

    lam_nm = np.linspace(t.LAMBDA_NM[0], t.LAMBDA_NM[1], n_points)

    def gsum(params):
        out = np.zeros_like(lam_nm)
        for a, c0, s in params:
            out += a * np.exp(-0.5 * ((lam_nm - c0) / s) ** 2)
        return out

    return (lam_nm * 1e-9, gsum(t.ABSORPTION_DB_M), gsum(t.GAIN_DB_M))


def get_mode_radius(model, radius, V, v, u):
    """Gaussian mode radius approximations (reference amplification.py:255)."""
    if model == "Bessel":
        return radius * V / u * kv(1, v) / kv(0, v) * jv(0, u)
    coefs = {
        "Marcuse": (0.650, 1.619, 2.879),
        "Whitley": (0.616, 1.660, 0.987),
        "Desurvire": (0.759, 1.289, 1.041),
        "Myslinski": (0.761, 1.237, 1.429),
    }
    if model not in coefs:
        raise TypeError(
            "model invalid argument - [LP01 - Marcuse - Whitley - Desurvire - "
            "Myslinski - Bessel]."
        )
    c0, c1, c2 = coefs[model]
    return radius * (c0 + c1 / V**1.5 + c2 / V**6)


def edf_params(cfg: EDFASMConfig):
    """EDF cross-sections, coefficients, and mode geometry (reference :285).

    Returns a dict with lbFl, absCoef, gainCoef, absCross, emiCross, gamma(lb),
    r, dr, i_k(r, lb).
    """
    if cfg.file and cfg.file.upper() == "MP980":
        lb, col1, col2 = mp980_edf_data()
    elif cfg.file:
        data = np.loadtxt(cfg.file)
        if cfg.fileunit == "nm":
            lb = data[:, 0] * 1e-9
        elif cfg.fileunit == "m":
            lb = data[:, 0]
        elif cfg.fileunit == "Hz":
            lb = c / data[:, 0]
        elif cfg.fileunit == "THz":
            lb = c / (data[:, 0] * 1e12)
        else:
            raise TypeError("fileunit invalid argument - [nm - m - Hz - THz].")
        col1, col2 = data[:, 1], data[:, 2]
    else:
        lb, col1, col2 = synthetic_edf_data()

    dr = cfg.a / cfg.longSteps
    r = np.arange(0, cfg.a, dr)
    V = (2 * np.pi / lb) * cfg.a * cfg.na
    u = ((1 + np.sqrt(2)) * V) / (1 + (4 + V**4) ** 0.25)
    v = np.sqrt(np.maximum(V**2 - u**2, 1e-12))

    if cfg.gmtc == "LP01":
        gamma = (((v * cfg.b) / (cfg.a * V * jv(1, u))) ** 2) * (
            jv(0, u * cfg.b / cfg.a) ** 2 + jv(1, u * cfg.b / cfg.a) ** 2
        )
        i_k = (
            (1 / np.pi)
            * ((v / (cfg.a * V))[None, :] * jv(0, np.outer(r, u / cfg.a))
               / jv(1, u)[None, :]) ** 2
        )  # (r, lb)
    else:
        w_g = get_mode_radius(cfg.gmtc, cfg.a, V, v, u)
        gamma = 1 - np.exp(-2 * (cfg.b / w_g) ** 2)
        i_k = (2 / (np.pi * w_g**2))[None, :] * np.exp(
            -2 * (r[:, None] / w_g[None, :]) ** 2
        )

    if np.sum(col1) > 1:
        # file holds absorption/gain coefficients -> derive cross sections
        abs_coef = 0.1 * np.log(10) * col1 if cfg.file else col1
        gain_coef = 0.1 * np.log(10) * col2 if cfg.file else col2
        abs_cross = abs_coef / cfg.rho / gamma
        emi_cross = gain_coef / cfg.rho / gamma
    else:
        abs_cross, emi_cross = col1, col2
        abs_coef = abs_cross * cfg.rho * gamma
        gain_coef = emi_cross * cfg.rho * gamma

    return {
        "lbFl": lb,
        "absCoef": abs_coef,
        "gainCoef": gain_coef,
        "absCross": abs_cross,
        "emiCross": emi_cross,
        "gamma": gamma,
        "r": r,
        "dr": dr,
        "i_k": i_k,
    }


class _PID:
    """Minimal PID controller (replaces the simple_pid dependency)."""

    def __init__(self, kp, ki, kd, setpoint, output_limits):
        self.kp, self.ki, self.kd = kp, ki, kd
        self.setpoint = setpoint
        self.lo, self.hi = output_limits
        self.integral = 0.0
        self.last_err = None

    def __call__(self, measurement):
        err = self.setpoint - measurement
        self.integral += self.ki * err
        d = 0.0 if self.last_err is None else self.kd * (err - self.last_err)
        self.last_err = err
        out = self.kp * err + self.integral + d
        return np.clip(out, self.lo, self.hi)


def _n2_pop(P, props):
    """Normalized metastable population (reference getN2Pop, :197)."""
    if props["algo"] == "Giles_spectrum":
        t1 = P @ props["const1"]
        t2 = P @ props["const2"] + 1
        return t1 / t2
    # Giles_spatial: radial population profile (r,)
    t1 = (props["tal"] / Planck) * (
        props["i_k"] @ (P * props["absCross"] / props["freq"])
    )
    t2 = (props["tal"] / Planck) * (
        props["i_k"] @ (P * (props["absCross"] + props["emiCross"]) / props["freq"])
    ) + 1
    return t1 / t2


def _giles_rhs(z, P, props):
    """d P_k / dz for all spectral components (reference :139/:163)."""
    n2 = _n2_pop(P, props)
    if props["algo"] == "Giles_spectrum":
        xi = n2 * props["const3"] - props["const4"]
        tau_ase = n2 * props["const5"]
    else:
        dop = (2 * np.pi * props["r"] * n2) * props["dr"]  # (r,)
        overlap = np.trapezoid(props["i_k"] * dop[:, None], axis=0)  # (k,)
        xi = overlap * (props["absCoef"] + props["gainCoef"]) / props["gamma"] - (
            props["absCoef"] + props["lossS"]
        )
        tau_ase = (
            overlap
            * (props["gainCoef"] / props["gamma"])
            * Planck
            * props["freq"]
            * props["noiseBand"]
        )
    return props["uk"] * (P * xi + props["ASE"] * tau_ase)


def _make_consts(props):
    xi = np.pi * props["b"] ** 2 * props["rho"] / props["tal"]
    props["const1"] = (1 / (Planck * xi)) * (props["absCoef"] / props["freq"])
    props["const2"] = (
        (1 / (Planck * xi)) * (props["absCoef"] + props["gainCoef"]) / props["freq"]
    )
    props["const3"] = props["absCoef"] + props["gainCoef"]
    props["const4"] = props["absCoef"] + props["lossS"]
    props["const5"] = props["gainCoef"] * Planck * props["freq"] * props["noiseBand"]
    return props


def edfa_sm(e_in, fs, fc, cfg: EDFASMConfig = EDFASMConfig(), rng=None,
            report=None):
    """Stateful (physical) EDFA model (reference edfaSM, amplification.py:420).

    Solves the Giles rate/propagation equations for signal + fwd/bck ASE +
    fwd/bck pumps with two-point relaxation, runs the AGC/APC PID loop on the
    forward pump, and returns (Eout, PpumpF, PpumpB, noise_profile).

    ``e_in`` is an (N, 1) or (N, 2) complex field array (host numpy).

    ``report``: optional callable; where the reference logs loop progress
    (amplification.py:601-639), this hook receives one dict per iteration:
    ``{"stage": "relax", "loop": i, "err": mean |1 - P/P_boundary|}`` for
    the two-point relaxation, ``{"stage": "control", "loop": i, "err_dB":
    e, "pump_f_mW": p}`` for the AGC/APC PID loop, and ``{"stage": ...,
    "failed": True, ...}`` if a loop hits its iteration cap.
    """
    if cfg.type not in ("AGC", "APC", "none"):
        raise TypeError("edfa_sm type invalid argument - [AGC, APC, none].")
    if cfg.algo not in ("Giles_spectrum", "Giles_spatial"):
        raise TypeError("edfa_sm algo invalid - [Giles_spectrum, Giles_spatial].")
    if rng is None:
        rng = np.random.default_rng(0)

    e_in = np.asarray(e_in)
    if e_in.ndim == 1:
        e_in = e_in[:, None]
    n_samp, n_pol = e_in.shape
    if n_pol == 1:
        e_in = np.concatenate([e_in, np.zeros_like(e_in)], axis=1)
        n_pol = 2

    power_in = np.sum(np.mean(np.abs(e_in) ** 2, axis=0))

    edf = edf_params(cfg)
    freq_pmp_f = c / np.asarray(cfg.forPumpLambda)
    freq_pmp_b = c / np.asarray(cfg.bckPumpLambda)
    pump_f = np.asarray(cfg.forPumpW, dtype=float)
    pump_b = np.asarray(cfg.bckPumpW, dtype=float)

    freq_sgn = fs * np.fft.fftfreq(n_samp) + fc
    band = freq_sgn.max() - freq_sgn.min()
    freq_ase = np.arange(-band / 2, band / 2, cfg.noiseBand) + fc
    n_ase = freq_ase.size

    def interp_lb(vals, freqs):
        return np.interp(c / freqs, edf["lbFl"], vals)

    # component layout: SIGX+SIGY | FASEX+FASEY | FORPUMP | BCKPUMP | BASEX+BASEY
    freq_all = np.concatenate(
        [freq_sgn, freq_sgn, freq_ase, freq_ase, freq_pmp_f, freq_pmp_b,
         freq_ase, freq_ase]
    )
    ase_flag = np.concatenate(
        [np.zeros(2 * n_samp), np.ones(2 * n_ase), np.zeros(pump_f.size),
         np.zeros(pump_b.size), np.ones(2 * n_ase)]
    )
    uk = np.concatenate(
        [np.ones(2 * n_samp + 2 * n_ase + pump_f.size),
         -np.ones(pump_b.size + 2 * n_ase)]
    )

    i0 = 2 * n_samp
    idx_sig = np.arange(0, i0)
    idx_ase_f = np.arange(i0, i0 + 2 * n_ase)
    idx_pmp_f = np.arange(idx_ase_f[-1] + 1, idx_ase_f[-1] + 1 + pump_f.size)
    idx_pmp_b = np.arange(idx_pmp_f[-1] + 1, idx_pmp_f[-1] + 1 + pump_b.size)
    idx_ase_b = np.arange(idx_pmp_b[-1] + 1, idx_pmp_b[-1] + 1 + 2 * n_ase)

    props = {
        "algo": cfg.algo,
        "freq": freq_all,
        "ASE": ase_flag,
        "uk": uk,
        "absCoef": interp_lb(edf["absCoef"], freq_all),
        "gainCoef": interp_lb(edf["gainCoef"], freq_all),
        "lossS": cfg.lossS,
        "noiseBand": cfg.noiseBand,
        "b": cfg.b,
        "rho": cfg.rho,
        "tal": cfg.tal,
    }
    if cfg.algo == "Giles_spatial":
        props["absCross"] = interp_lb(edf["absCross"], freq_all)
        props["emiCross"] = interp_lb(edf["emiCross"], freq_all)
        props["gamma"] = np.maximum(interp_lb(edf["gamma"], freq_all), 1e-12)
        props["r"] = edf["r"]
        props["dr"] = edf["dr"]
        # i_k interpolated over wavelength for every component
        i_k = np.empty((edf["r"].size, freq_all.size))
        for ir in range(edf["r"].size):
            i_k[ir] = np.interp(c / freq_all, edf["lbFl"], edf["i_k"][ir])
        props["i_k"] = i_k
    else:
        props = _make_consts(props)

    e_ft = np.fft.fft(e_in, axis=0)
    p_sgl = np.reshape(np.abs(e_ft / n_samp) ** 2, 2 * n_samp, order="F")

    def solve(p0, z0, z1):
        sol = solve_ivp(
            _giles_rhs, (z0, z1), p0, method="DOP853", rtol=5e-4, atol=5e-7,
            args=(props,),
        )
        return sol.y[:, -1]

    n_total = freq_all.size
    max_try = 15
    err_ctrl = np.inf
    try_ctrl = 0

    p_out = None
    while abs(np.mean(err_ctrl)) > cfg.tolCtrl and try_ctrl < max_try:
        # forward-only warm start
        p = np.zeros(n_total)
        p[idx_sig] = p_sgl
        p[idx_pmp_f] = pump_f
        p = solve(p, 0, cfg.lngth)

        err_cvg = np.inf
        try_loop = 0
        while np.mean(np.abs(err_cvg)) > cfg.tol and try_loop < max_try:
            # backward pass L -> 0 (backward components get their boundary at L)
            p[idx_ase_b] = 0
            p[idx_pmp_b] = pump_b
            p_in = solve(p, cfg.lngth, 0)
            # forward pass 0 -> L with forward boundaries reset
            p = p_in.copy()
            p[idx_sig] = p_sgl
            p[idx_ase_f] = 0
            p[idx_pmp_f] = pump_f
            p_out = solve(p, 0, cfg.lngth)
            p = p_out.copy()

            # convergence on pump powers, skipping zero-power boundaries
            # (0/0 would freeze the loop with NaN; reference :593-599 has
            # the same criterion but never drives a pump to exactly zero)
            ratios = []
            if np.any(pump_b > 0):
                ratios.append(p_out[idx_pmp_b][pump_b > 0] / pump_b[pump_b > 0])
            if np.any(pump_f > 0):
                ratios.append(p_in[idx_pmp_f][pump_f > 0] / pump_f[pump_f > 0])
            err_cvg = (1 - np.concatenate(ratios)) if ratios else np.zeros(1)
            try_loop += 1
            if report is not None:
                report({"stage": "relax", "loop": try_loop,
                        "err": float(np.mean(np.abs(err_cvg)))})
        if report is not None and np.mean(np.abs(err_cvg)) > cfg.tol:
            report({"stage": "relax", "loop": try_loop, "failed": True,
                    "err": float(np.mean(np.abs(err_cvg)))})

        if cfg.type == "none":
            err_ctrl = 0.0
            break
        power_out = np.sum(p_out[np.concatenate([idx_sig, idx_ase_f])])
        if cfg.type == "AGC":
            measured = 10 * np.log10(power_out / power_in)
        else:  # APC
            measured = 10 * np.log10(1e3 * power_out)
        # fresh PID per control step with limits from the CURRENT pump
        # (reference :622-630): each update is a bounded relative step, so
        # the pump can neither overshoot wildly nor collapse to zero
        pid = _PID(cfg.kp, cfg.ki, cfg.kd, setpoint=cfg.value,
                   output_limits=(-pump_f / 2, pump_f / 2))
        pump_f = np.maximum(pump_f + pid(measured), 1e-6)
        err_ctrl = measured - cfg.value
        try_ctrl += 1
        if report is not None:
            report({"stage": "control", "loop": try_ctrl,
                    "err_dB": float(np.mean(err_ctrl)),
                    "pump_f_mW": float(1e3 * np.mean(pump_f))})
    if report is not None and cfg.type != "none" and try_ctrl >= max_try \
            and abs(np.mean(err_ctrl)) > cfg.tolCtrl:
        report({"stage": "control", "loop": try_ctrl, "failed": True,
                "err_dB": float(np.mean(err_ctrl))})

    p_pump_f = p_out[idx_pmp_f]
    p_pump_b = p_out[idx_pmp_b]

    # ASE -> per-bin noise amplitude
    freq_step = fs / n_samp
    res_offset = cfg.noiseBand / freq_step
    noise_f = p_out[idx_ase_f] / res_offset

    def interp_ext(x, xp, fp):
        y = np.interp(x, xp, fp)
        if len(xp) > 1:
            lo = fp[0] + (fp[1] - fp[0]) / (xp[1] - xp[0]) * (x - xp[0])
            hi = fp[-1] + (fp[-1] - fp[-2]) / (xp[-1] - xp[-2]) * (x - xp[-1])
            y = np.where(x < xp[0], lo, y)
            y = np.where(x > xp[-1], hi, y)
        return np.maximum(y, 0)

    noise_amp = np.stack(
        [
            np.sqrt(interp_ext(freq_sgn, freq_ase, noise_f[:n_ase])),
            np.sqrt(interp_ext(freq_sgn, freq_ase, noise_f[n_ase:])),
        ],
        axis=1,
    )
    noise = noise_amp * (
        rng.standard_normal((n_samp, 2)) + 1j * rng.standard_normal((n_samp, 2))
    ) / np.sqrt(2)

    e_out_ft = np.reshape(
        np.sqrt(p_out[idx_sig].astype(complex)), (n_samp, 2), order="F"
    )
    e_out_ft = e_out_ft * np.exp(1j * np.angle(e_ft)) + noise
    e_out = np.fft.ifft(e_out_ft * n_samp, axis=0)
    return e_out, p_pump_f, p_pump_b, noise_amp


def get_spectrum(x, fs, fc, xunits="m", yunits="dBm"):
    """Optical magnitude spectrum of a signal (reference get_spectrum, :96).

    Returns (frequency_or_wavelength, spectrum).
    """
    x = np.asarray(x)
    n = len(x)
    X = np.fft.fftshift(np.fft.fft(x)) / n
    spectrum = np.abs(X) ** 2
    freq = np.fft.fftshift(np.fft.fftfreq(n, 1 / fs))
    axis = c / (freq + fc) if xunits == "m" else freq + fc
    if yunits == "dBm":
        spectrum = 10 * np.log10(np.maximum(1e3 * spectrum, 1e-30))
    return axis, spectrum
