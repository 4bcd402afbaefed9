"""Smoke tests for visualization helpers (headless Agg backend)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("matplotlib")  # plot.py's one dependency beyond JAX

from opticommpy_tpu.comm import modulate_gray  # noqa: E402
from opticommpy_tpu.ops import pnorm  # noqa: E402
from opticommpy_tpu.plot import (  # noqa: E402
    animate_const_gif,
    const_hist,
    eyediagram,
    pconst,
    plot_colored_const,
    plot_decision_boundaries,
    plot_psd,
)


def _symbols(n=2000, M=16):
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, size=n * 4)
    s = pnorm(modulate_gray(jnp.asarray(bits), M, "qam"))
    return np.asarray(s) + 0.05 * (
        rng.normal(size=n) + 1j * rng.normal(size=n)
    )


def test_pconst_and_density():
    s = _symbols()
    ax = pconst(s)
    assert ax is not None
    ax2 = pconst([s, 0.5 * s], density=True)
    assert ax2 is not None


def test_const_hist():
    assert const_hist(_symbols()) is not None


def test_colored_const_and_boundaries():
    assert plot_colored_const(_symbols(), 16, "qam") is not None
    assert plot_decision_boundaries(16, "qam", grid=60) is not None


def test_eyediagram_styles():
    rng = np.random.default_rng(1)
    sig = np.repeat(rng.choice([-1.0, 1.0], size=500), 4)
    assert eyediagram(sig, sps=4, style="fast") is not None
    assert eyediagram(sig, sps=4, style="fancy") is not None


def test_plot_psd():
    rng = np.random.default_rng(2)
    sig = rng.normal(size=4096) + 1j * rng.normal(size=4096)
    assert plot_psd(sig, fs=10e9) is not None


def test_animate_const_gif(tmp_path):
    frames = [_symbols(300) for _ in range(3)]
    out = animate_const_gif(frames, str(tmp_path / "c.gif"), fps=2)
    assert os.path.exists(out) and os.path.getsize(out) > 0
