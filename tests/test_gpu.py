"""Compiled-kernel tests that need a CUDA GPU.

They skip where JAX has no GPU (the ``gpu`` fixture decides) and run on the
card with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``;
``chip_smoke.py`` runs them after the main path. The same kernel's
arithmetic is tested on the CPU in the Pallas interpreter
(tests/test_mimo_pallas.py); these pin the compiled Triton lowering.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from opticommpy_tpu.comm.modulation import gray_mapping

pytestmark = pytest.mark.gpu


def _signal(n_sym, seed=0, n_modes=2):
    rng = np.random.default_rng(seed)
    const = gray_mapping(16, "qam")
    const = (const / np.sqrt(np.mean(np.abs(const) ** 2))).astype(
        np.complex64)
    sym = const[rng.integers(0, 16, size=(n_sym, n_modes))]
    x = np.zeros((2 * n_sym, n_modes), complex)
    x[::2] = sym
    mix = np.eye(n_modes) + 0.1 * (rng.normal(size=(n_modes, n_modes))
                                   + 1j * rng.normal(size=(n_modes, n_modes)))
    sig = x @ mix.T + 0.03 * (rng.normal(size=x.shape)
                              + 1j * rng.normal(size=x.shape))
    return (jnp.asarray(sig.astype(np.complex64)),
            jnp.asarray(sym.astype(np.complex64)), const)


@pytest.mark.parametrize("alg, scan_alg, n_train", [
    ("lms", "dd-lms", 0), ("nlms", "nlms", 10**9), ("cma", "cma", 0),
    ("rde", "rde", 0), ("da-rde", "da-rde", 0)])
def test_compiled_kernel_matches_scan(gpu, alg, scan_alg, n_train):
    """Every rule, compiled for the GPU, against the lax.scan on the same
    GPU at 2^14 symbols, 2x2, 15 taps (float32 both; atol 2e-4 covers the
    different order of sums over 16k recursive updates)."""
    from opticommpy_tpu.dsp import MIMOEqualizerConfig, mimo_adapt_equalizer
    from opticommpy_tpu.kernels.mimo_pallas import mimo_eq_pallas

    sig, sym, const = _signal(2**14)
    y, H = mimo_eq_pallas(sig, sym, const, alg=alg, n_taps=15, sps=2,
                          mu=1e-3, n_train=n_train)
    assert y.devices() == {gpu}
    cfg = MIMOEqualizerConfig(nTaps=15, mu=(1e-3,), SpS=2, alg=(scan_alg,),
                              M=16, backend="scan")
    ys, Hs, _, _, _ = mimo_adapt_equalizer(sig, cfg, symb_ref=sym,
                                           return_results=True)
    n = min(y.shape[0], ys.shape[0])
    assert np.allclose(np.asarray(y)[:n], np.asarray(ys)[:n], atol=2e-4)
    assert np.allclose(np.asarray(H), np.asarray(Hs), atol=1e-3)


def test_compiled_batch_equals_single(gpu):
    """One launch for 3 signals == 3 single-signal launches, bit for bit
    (each program runs the same code on its own signal), at 4 modes (padded
    to a power of two inside the kernel)."""
    from opticommpy_tpu.kernels.mimo_pallas import (mimo_eq_pallas,
                                                    mimo_eq_pallas_batch)

    sigs, syms = zip(*[_signal(4096, seed=s, n_modes=4)[:2]
                       for s in range(3)])
    const = _signal(8)[2]
    yb, hb = mimo_eq_pallas_batch(jnp.stack(sigs), jnp.stack(syms), const,
                                  alg="lms", n_taps=9, mu=1e-3, n_train=500)
    for b in range(3):
        y1, h1 = mimo_eq_pallas(sigs[b], syms[b], const, alg="lms",
                                n_taps=9, mu=1e-3, n_train=500)
        np.testing.assert_array_equal(np.asarray(yb[b]), np.asarray(y1))
        np.testing.assert_array_equal(np.asarray(hb[b]), np.asarray(h1))


def test_auto_backend_launches_kernel_on_gpu(gpu):
    """backend='auto' (the default) on a GPU runs every kernel stage on the
    compiled kernel: 2 + 1 launches for da-rde x numIter 2 -> dd-lms."""
    import opticommpy_tpu.kernels.mimo_pallas as mimo_pallas
    from opticommpy_tpu.dsp import MIMOEqualizerConfig, mimo_adapt_equalizer

    sig, sym, _ = _signal(2048, seed=3)
    cfg = MIMOEqualizerConfig(nTaps=15, SpS=2, mu=(5e-3, 1e-3),
                              alg=("da-rde", "dd-lms"), L=(1024, 1024),
                              M=16, numIter=2)
    with mock.patch.object(mimo_pallas, "_stage_call",
                           wraps=mimo_pallas._stage_call) as spy:
        y = mimo_adapt_equalizer(sig, cfg, symb_ref=sym)
        assert spy.call_count == 3
        assert all(not c.kwargs["interpret"] for c in spy.call_args_list)
    assert np.isfinite(np.asarray(y)).all()


def test_tf32_sites_pinned_to_highest(gpu):
    """The small f32 matmuls that feed fields and LLRs ask for HIGHEST:
    the PBS/hybrid front end matches float64 NumPy to 1e-6 on the GPU."""
    from opticommpy_tpu.models.devices import optical_hybrid_2x4

    rng = np.random.default_rng(0)
    es = (rng.normal(size=4096) + 1j * rng.normal(size=4096)).astype(
        np.complex64)
    lo = (rng.normal(size=4096) + 1j * rng.normal(size=4096)).astype(
        np.complex64)
    out = np.asarray(jax.jit(optical_hybrid_2x4)(es, lo))
    T = np.array([[0.5, 0.5j, 0.5j, -0.5], [0.5j, -0.5, 0.5, 0.5j],
                  [0.5j, 0.5, -0.5j, -0.5], [-0.5, 0.5j, -0.5, 0.5j]])
    ref = T[:, [0]] * es[None].astype(complex) + T[:, [3]] * lo[None]
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-6
