"""Pallas (Triton route) kernel for the NxN MIMO adaptive equalizer recurrence.

The adaptive equalizer is a true per-symbol recurrence (the taps updated at
symbol k filter symbol k+1), so neither vmap nor a matrix unit parallelizes
it across time. The ``lax.scan`` formulation pays XLA's loop overhead on
every symbol: on a GPU, at least one kernel launch per symbol. This kernel
runs a whole training stage inside one Triton program per (signal, output
mode):

- the output mode's tap row ``H[o]`` (input modes x taps, real and imaginary
  planes) is the loop carry of an in-kernel ``fori_loop``, so it lives in
  registers for the whole stage;
- each iteration reads the symbol's window straight out of the padded
  signal at offset ``(n_start + k) * sps``: no pre-gathered window tensor;
- the batch and the output modes spread across programs. Each output mode's
  row update depends only on its own output and error, so the programs are
  independent.

Block shapes are powers of two (Triton's rule): input modes pad to
``next_pow2(modes)`` with zero rows and the tap window to
``next_pow2(taps)`` with a lane mask, so 2x2 at 15 taps runs on (2, 16)
tiles.

Update rules (static ``alg``, each compiles to its own kernel; reference
per-rule kernels equalization.py:519-973):

- ``'lms'``    data-aided for the first ``n_train`` symbols, then
  decision-directed (the reference's da/dd-lms schedule; ``n_train=0`` is
  the scan path's ``'dd-lms'``).
- ``'nlms'``   same error, window normalized by its per-input-mode power.
- ``'cma'``    blind constant modulus: e = (R - |y|^2) y.
- ``'rde'``    blind radius directed: e = (R_dec^2 - |y|^2) y.
- ``'da-rde'`` data-aided radius: R from the reference symbol.

The arithmetic is float32 throughout. ``interpret=True`` runs the kernel in
the Pallas interpreter (CPU tests); the compiled kernel needs a CUDA GPU.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

__all__ = ["mimo_eq_pallas", "mimo_eq_pallas_batch", "mimo_eq_stage",
           "square_qam_levels", "KERNEL_ALGS"]

KERNEL_ALGS = ("lms", "nlms", "cma", "rde", "da-rde")

# Far-away padding for the constellation / radius vectors: a padded entry
# never wins the nearest-point search.
_FAR = 1e30


def _next_pow2(n):
    return 1 << max(0, int(n - 1).bit_length())


def square_qam_levels(c_re, c_im, tol=1e-5):
    """(lo, step, levels) if the constellation is a uniform square grid,
    else None.

    On such a grid the nearest point factorizes per axis, so the slicer is
    a clipped rounding to a level index instead of a search over all M
    points. ``levels`` are the constellation's own float32 real parts, one
    per index, so a decision equals the constellation point bit for bit.
    """
    c_re = np.asarray(c_re, np.float32)
    c_im = np.asarray(c_im, np.float32)
    re = np.unique(np.round(c_re / tol) * tol)
    im = np.unique(np.round(c_im / tol) * tol)
    if len(re) != len(im) or len(re) < 2:
        return None
    if len(re) * len(im) != len(c_re):
        return None
    steps = np.diff(re)
    if not (np.allclose(re, im, atol=tol)
            and np.allclose(steps, steps[0], atol=tol)):
        return None
    pts = {(round(float(a) / tol), round(float(b) / tol))
           for a, b in zip(c_re, c_im)}
    if len(pts) != len(re) * len(im):
        return None
    # exact level of each index: the float32 real part nearest to it
    levels = tuple(float(c_re[np.argmin(np.abs(c_re - r))]) for r in re)
    step = (levels[-1] - levels[0]) / (len(levels) - 1)
    return levels[0], step, levels


def _nearest(d2, vals):
    """Entry of ``vals`` at the first minimum of ``d2`` (1-D, same shape)."""
    idx = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 0)
    first = jnp.min(jnp.where(d2 == jnp.min(d2), idx, d2.shape[0]))
    return jnp.sum(jnp.where(idx == first, vals, 0.0))


def _stage_kernel(xr_ref, xi_ref, rr_ref, ri_ref, hr0_ref, hi0_ref, cr_ref,
                  ci_ref, aux_ref, yr_ref, yi_ref, hr_ref, hi_ref, *,
                  n_start, length, sps, n_taps, n_modes, mu, n_train, alg,
                  qam_grid):
    b = pl.program_id(0)
    o = pl.program_id(1)
    mp, tp = hr0_ref.shape[2], hr0_ref.shape[3]
    rows = jax.lax.broadcasted_iota(jnp.int32, (mp, tp), 0)
    lanes = jax.lax.broadcasted_iota(jnp.int32, (mp, tp), 1)
    live = ((rows < n_modes) & (lanes < n_taps)).astype(jnp.float32)
    const_re = cr_ref[...]
    const_im = ci_ref[...]
    aux = aux_ref[...]

    def quantize(x):
        lo, step, levels = qam_grid
        k = jnp.clip(jnp.floor((x - lo) / step + 0.5), 0.0,
                     len(levels) - 1.0)
        out = jnp.float32(levels[0])
        for j, level in enumerate(levels[1:], 1):
            out = jnp.where(k == j, jnp.float32(level), out)
        return out

    def body(k, carry):
        hr, hi = carry
        start = (n_start + k) * sps
        wr = xr_ref[b, :, pl.ds(start, tp)] * live
        wi = xi_ref[b, :, pl.ds(start, tp)] * live
        # y = sum_(i,t) H[o, i, t] * w[i, t]  (complex, no conjugate)
        y_re = jnp.sum(jnp.sum(hr * wr - hi * wi, axis=1))
        y_im = jnp.sum(jnp.sum(hr * wi + hi * wr, axis=1))
        p2 = y_re * y_re + y_im * y_im
        if alg in ("lms", "nlms"):
            if qam_grid is not None:
                dec_re, dec_im = quantize(y_re), quantize(y_im)
            else:
                d2 = (const_re - y_re) ** 2 + (const_im - y_im) ** 2
                dec_re, dec_im = _nearest(d2, const_re), _nearest(d2, const_im)
            use_ref = k < n_train
            e_re = jnp.where(use_ref, rr_ref[b, o, n_start + k], dec_re) - y_re
            e_im = jnp.where(use_ref, ri_ref[b, o, n_start + k], dec_im) - y_im
        elif alg == "cma":
            err = aux_ref[0] - p2
            e_re, e_im = err * y_re, err * y_im
        elif alg == "rde":
            r = jnp.sqrt(p2)
            r_dec = _nearest((aux - r) ** 2, aux)
            err = r_dec * r_dec - p2
            e_re, e_im = err * y_re, err * y_im
        elif alg == "da-rde":
            t_re = rr_ref[b, o, n_start + k]
            t_im = ri_ref[b, o, n_start + k]
            err = (t_re * t_re + t_im * t_im) - p2
            e_re, e_im = err * y_re, err * y_im
        else:
            raise ValueError(f"unknown alg {alg!r}")
        if alg == "nlms":
            # per-input-mode window power (reference nlmsUp,
            # equalization.py:519); zero rows are padding, guard them
            pw = jnp.sum(wr * wr + wi * wi, axis=1, keepdims=True)
            inv = 1.0 / jnp.maximum(pw, 1e-12)
            gr, gi = wr * inv, wi * inv
        else:
            gr, gi = wr, wi
        # H[o] += mu * e * conj(g)
        hr = hr + mu * (e_re * gr + e_im * gi)
        hi = hi + mu * (e_im * gr - e_re * gi)
        yr_ref[b, o, k] = y_re
        yi_ref[b, o, k] = y_im
        return hr, hi

    hr, hi = jax.lax.fori_loop(0, length, body, (hr0_ref[b, o], hi0_ref[b, o]))
    hr_ref[b, o] = hr
    hi_ref[b, o] = hi


@partial(jax.jit, static_argnames=(
    "n_start", "length", "sps", "n_taps", "mu", "n_train", "alg", "qam_grid",
    "interpret"))
def _stage_call(xr, xi, rr, ri, hr, hi, cr, ci, aux, *, n_start, length, sps,
                n_taps, mu, n_train, alg, qam_grid, interpret):
    n_batch, n_modes = rr.shape[0], rr.shape[1]
    kernel = partial(_stage_kernel, n_start=n_start, length=length, sps=sps,
                     n_taps=n_taps, n_modes=n_modes, mu=mu, n_train=n_train,
                     alg=alg, qam_grid=qam_grid)
    f32 = jnp.float32
    return pl.pallas_call(
        kernel,
        grid=(n_batch, n_modes),
        out_shape=[
            jax.ShapeDtypeStruct((n_batch, n_modes, length), f32),
            jax.ShapeDtypeStruct((n_batch, n_modes, length), f32),
            jax.ShapeDtypeStruct(hr.shape, f32),
            jax.ShapeDtypeStruct(hi.shape, f32),
        ],
        backend="triton",
        # one warp holds a (2, 16) tap tile at one element per thread; the
        # recurrence is latency-bound, so more warps only add barriers
        compiler_params=pltriton.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="mimo_eq_stage",
    )(xr, xi, rr, ri, hr, hi, cr, ci, aux)


def _aux_vector(alg, const):
    """Rule constant: CMA radius^2 (reference cmaUp:788) or RDE radii."""
    if alg == "cma":
        return np.array([np.mean(np.abs(const) ** 4)
                         / np.mean(np.abs(const) ** 2)], np.float32)
    if alg == "rde":
        return np.unique(np.round(np.abs(const), 6)).astype(np.float32)
    return np.zeros(1, np.float32)


def _padded(v, fill):
    v = np.asarray(v, np.float32)
    return np.concatenate([v, np.full(_next_pow2(v.size) - v.size, fill,
                                      np.float32)])


def mimo_eq_stage(sig_pad, symb_ref, H, const, mu, alg, sps, n_taps, n_start,
                  length, n_train=0, interpret=False):
    """One adaptive-equalizer stage for B signals in one kernel launch.

    Parameters
    ----------
    sig_pad : (B, Npad, modes) complex signals, already padded the way
        :func:`opticommpy_tpu.dsp.mimo_adapt_equalizer` pads them: the
        window of output symbol ``n`` starts at sample ``n * sps``.
    symb_ref : (B, nSym, modes) references (zeros for the blind rules).
    H : (B, modes_out, modes_in, n_taps) complex taps ``H[o, i, t]``.
    alg : one of :data:`KERNEL_ALGS`.
    n_start, length : the stage covers output symbols
        ``n_start .. n_start + length - 1``.
    n_train : symbols (counted from ``n_start``) that use the reference
        before ``'lms'``/``'nlms'`` switch to decisions.
    interpret : run in the Pallas interpreter (for tests on the CPU).

    Returns
    -------
    (y (B, length, modes) complex64, H (B, modes, modes, n_taps) complex64).
    """
    if alg not in KERNEL_ALGS:
        raise ValueError(f"kernel alg must be one of {KERNEL_ALGS}, got {alg!r}")
    const = np.asarray(const).astype(np.complex64)
    n_batch, n_samp, n_modes = sig_pad.shape
    mp, tp = _next_pow2(n_modes), _next_pow2(n_taps)
    # every window read, including the tap padding, stays inside the array
    n_need = (n_start + length - 1) * sps + tp
    x = jnp.moveaxis(jnp.asarray(sig_pad, jnp.complex64), 2, 1)
    x = jnp.pad(x, ((0, 0), (0, mp - n_modes), (0, max(0, n_need - n_samp))))
    ref = jnp.moveaxis(jnp.asarray(symb_ref, jnp.complex64), 2, 1)
    h = jnp.pad(jnp.asarray(H, jnp.complex64),
                ((0, 0), (0, 0), (0, mp - n_modes), (0, tp - n_taps)))
    qam_grid = square_qam_levels(const.real, const.imag)
    aux = _aux_vector(alg, const)
    yr, yi, hr, hi = _stage_call(
        jnp.real(x), jnp.imag(x), jnp.real(ref), jnp.imag(ref),
        jnp.real(h), jnp.imag(h),
        jnp.asarray(_padded(const.real, _FAR)),
        jnp.asarray(_padded(const.imag, _FAR)),
        jnp.asarray(_padded(aux, _FAR)),
        n_start=int(n_start), length=int(length), sps=int(sps),
        n_taps=int(n_taps), mu=float(mu), n_train=int(n_train), alg=str(alg),
        qam_grid=qam_grid, interpret=bool(interpret))
    y = jnp.moveaxis(jax.lax.complex(yr, yi), 1, 2)
    H_new = jax.lax.complex(hr, hi)[:, :, :n_modes, :n_taps]
    return y, H_new


def _center_spike(n_batch, n_modes, n_taps):
    h0 = np.zeros((n_batch, n_modes, n_modes, n_taps), np.complex64)
    h0[:, np.arange(n_modes), np.arange(n_modes), n_taps // 2] = 1.0
    return h0


def mimo_eq_pallas_batch(sig, symb_ref, const, alg="lms", n_taps=15, sps=2,
                         mu=2e-3, n_train=10000, H0=None, interpret=False):
    """Adaptive NxN equalizer for B signals in one kernel launch.

    ``alg``: 'lms' (data-aided for ``n_train`` symbols, then
    decision-directed), 'nlms', 'cma', 'rde', 'da-rde'. The blind rules
    accept ``symb_ref=None``.

    Parameters
    ----------
    sig : (B, N, modes) complex signals at ``sps`` samples/symbol.
    symb_ref : (B, nSym, modes) reference symbols.
    H0 : optional (B, modes, modes, n_taps) initial taps (central spike).

    Returns
    -------
    (y (B, nSym, modes) complex, H (B, modes, modes, n_taps)).
    """
    sig = jnp.asarray(sig, jnp.complex64)
    n_batch, n_samp, n_modes = sig.shape
    if symb_ref is None:
        if alg in ("lms", "nlms", "da-rde"):
            raise ValueError(
                "symb_ref is required for alg='lms'/'nlms'/'da-rde'")
        symb_ref = jnp.zeros((n_batch, n_samp // sps, n_modes), jnp.complex64)
    symb_ref = jnp.asarray(symb_ref, jnp.complex64)
    h0 = _center_spike(n_batch, n_modes, n_taps) if H0 is None else H0
    l_pad = n_taps // 2
    sig_pad = jnp.pad(sig, ((0, 0), (l_pad, 0), (0, 0)))
    return mimo_eq_stage(sig_pad, symb_ref, h0, const, mu, alg, sps, n_taps,
                         0, symb_ref.shape[1], n_train, interpret)


def mimo_eq_pallas(sig, symb_ref, const, alg="lms", n_taps=15, sps=2, mu=2e-3,
                   n_train=10000, H0=None, interpret=False):
    """Single-signal form of :func:`mimo_eq_pallas_batch`.

    ``sig`` is (N, modes); returns (y (nSym, modes), H (modes, modes,
    n_taps)). The mode count is taken from ``sig.shape[1]`` (2 = polmux,
    4+ = SDM; the reference equalizer is NxN, equalization.py:125).
    """
    y, h = mimo_eq_pallas_batch(
        jnp.asarray(sig)[None], None if symb_ref is None
        else jnp.asarray(symb_ref)[None], const, alg, n_taps, sps, mu,
        n_train, None if H0 is None else np.asarray(H0)[None], interpret)
    return y[0], h[0]
