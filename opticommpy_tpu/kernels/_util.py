"""Shared array helpers for the sliding-window recurrences."""

import jax
import jax.numpy as jnp

__all__ = ["sliding_windows"]


def sliding_windows(xp, n_out, sps, n_taps, axis=0, taps_first=False):
    """Tap windows ``w[.., k, t, ..] = xp[.., k*sps + t, ..]`` along ``axis``.

    Returns xp's shape with dim ``axis`` replaced by ``(n_out, n_taps)``
    (or ``(n_taps, n_out)`` with ``taps_first=True`` — the shifted-copy
    layout the NLIN lag products use). Built as ``n_taps`` strided slices
    + stack (pure streaming copies) rather than the equivalent ``xp[idx]``
    index gather, which produces the identical array through a gather.
    Requires ``xp.shape[axis] >= (n_out - 1) * sps + n_taps`` (same as the
    gather form).
    """
    axis = axis % xp.ndim  # a negative axis would silently stack at 0
    lim0 = (n_out - 1) * sps + 1
    strides = [1] * xp.ndim
    strides[axis] = sps
    cols = []
    for t in range(n_taps):
        starts = [0] * xp.ndim
        limits = list(xp.shape)
        starts[axis] = t
        limits[axis] = t + lim0
        cols.append(jax.lax.slice(xp, starts, limits, strides))
    return jnp.stack(cols, axis=axis if taps_first else axis + 1)
