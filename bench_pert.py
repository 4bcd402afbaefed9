"""Auxiliary benchmark: perturbation NLIN throughput (symbols/s).

The reference calls `calcNLINperturbation` its heaviest data-parallel kernel
(perturbation.py:200: a (2L+1)^2 window triple-product contraction per
symbol, prange over symbols). Here the contraction runs as chunked batched
elementwise+reduction blocks (models/perturbation.py:154); this bench
measures it on the live backend and reports achieved FLOP/s against an
analytic per-symbol count.

Per symbol (one polarization pair, window half-width L, indL = 2L+1):
- IFWM triple products: indL^2 cells x (2 complex mul + add) x 2 pols
  ~ 2 * indL^2 * 14 real FLOPs, plus the shared x[t+n]x*[t+n+m] term
  (indL^2 * 6) and the C-weighted reduction (indL^2 * 8).
- IXPM/ISPM: O(indL) — negligible.

The contraction is elementwise work feeding a C-matrix reduction (XLA
fuses the window tensor into the reduce, so it is compute-bound, not
bandwidth-bound); 'AMR' prunes coefficient cells below coeffTol.

Prints one JSON line per configuration. Run: ``python bench_pert.py``
(``JAX_PLATFORMS=cpu`` for a CPU run).
"""

import json
import time

import numpy as np

import jax
import jax.numpy as jnp

from opticommpy_tpu.models.perturbation import (
    PerturbationConfig,
    calc_nlin_perturbation,
    calc_nlin_perturbation_simplified,
    calc_pert_coeff_matrix,
)

N_SYM = 1 << 16


def main():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=N_SYM) + 1j * rng.normal(size=N_SYM)).astype(
        np.complex64)
    y = (rng.normal(size=N_SYM) + 1j * rng.normal(size=N_SYM)).astype(
        np.complex64)
    xr, xi = np.float32(x.real), np.float32(x.imag)
    yr, yi = np.float32(y.real), np.float32(y.imag)

    for order, mode in [(25, "AM"), (25, "AM-chunk"), (25, "AMR"),
                        (50, "AM")]:
        method = "chunk" if mode == "AM-chunk" else "fft"
        cfg = PerturbationConfig(matrixOrder=order,
                                 mode="AM" if mode.startswith("AM") else mode)
        _, c_ifwm, c_ixpm, c_ispm = calc_pert_coeff_matrix(cfg)

        if mode == "AMR":
            fn0 = calc_nlin_perturbation_simplified
            tol = cfg.coeffTol
            kept = int(np.sum(20 * np.log10(
                np.abs(c_ifwm) / np.abs(c_ifwm).max() + 1e-30) > tol))

            def run(ar, ai, br, bi):
                dx, dy, px, py, _, _ = fn0(c_ifwm, c_ixpm, c_ispm,
                                           ar + 1j * ai, br + 1j * bi,
                                           coeff_tol=tol)
                return (jnp.mean(jnp.abs(dx)) + jnp.mean(jnp.abs(dy))
                        + jnp.mean(px) + jnp.mean(py))
        else:
            kept = c_ifwm.size

            def run(ar, ai, br, bi):
                dx, dy, px, py = calc_nlin_perturbation(
                    c_ifwm, c_ixpm, c_ispm, ar + 1j * ai, br + 1j * bi,
                    method=method)
                return (jnp.mean(jnp.abs(dx)) + jnp.mean(jnp.abs(dy))
                        + jnp.mean(px) + jnp.mean(py))

        jrun = jax.jit(run)
        args = tuple(jnp.asarray(a) for a in (xr, xi, yr, yi))
        float(jrun(*args))  # compile
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            float(jrun(*args))
            ts.append(time.perf_counter() - t0)
        sym_s = N_SYM / min(ts)
        if mode == "AM" and order == 25:
            # serving shape: B signals' NLIN in one program (the single
            # call is dispatch-bound after the round-5 slice fix)
            B = 8
            bargs = tuple(jnp.broadcast_to(a, (B,) + a.shape) for a in args)
            jb = jax.jit(jax.vmap(run))

            def runb():
                return float(jnp.sum(jb(*bargs)))

            runb()
            tb = []
            for _ in range(3):
                t0 = time.perf_counter()
                runb()
                tb.append(time.perf_counter() - t0)
            print(json.dumps({
                "metric": f"NLIN perturbation (L={order}, AM, vmapped "
                          f"batch {B})",
                "value": round(B * N_SYM / min(tb) / 1e6, 3),
                "unit": "Msym/s"}), flush=True)
        ind_l = 2 * order + 1
        flops_sym = 28 * ind_l**2  # see module docstring accounting
        if mode == "AMR":
            flops_sym = 28 * kept
        print(json.dumps({
            "metric": f"NLIN perturbation (L={order}, {mode}, "
                      f"{kept} coeff cells)",
            "value": round(sym_s / 1e6, 3),
            "unit": "Msym/s",
            "flops_per_s": round(sym_s * flops_sym / 1e9, 1) * 1e9,
        }))


if __name__ == "__main__":
    main()
