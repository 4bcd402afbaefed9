"""Primary-path execution audit.

Every backend with a fallback gets one test asserting that the PRIMARY path
actually executes for its intended configuration — not just that outputs
match. A comparison of two paths passes tautologically when a silent
fallback routes both to the same code.

Mechanism: patch the primary entry point with a wrapping mock (the call
passes through; only the count is recorded) and drive the public API.
"""

from unittest import mock

import numpy as np

import jax.numpy as jnp


def _training_signal(n_sym=1024, sps=2, seed=23):
    from opticommpy_tpu.comm.modulation import gray_mapping

    rng = np.random.default_rng(seed)
    const = gray_mapping(16, "qam")
    const = const / np.sqrt(np.mean(np.abs(const) ** 2))
    sym = const[rng.integers(0, 16, size=(n_sym, 2))]
    x = np.zeros((n_sym * sps, 2), complex)
    x[::sps] = sym
    sig = jnp.asarray((x + 0.01 * (rng.normal(size=x.shape)
                                   + 1j * rng.normal(size=x.shape))
                       ).astype(np.complex64))
    return sig, jnp.asarray(sym.astype(np.complex64))


def test_pallas_training_stages_run_on_kernels():
    """mimo_adapt_equalizer(backend='pallas') launches the Triton-route
    kernel once per kernel stage and pass — da-rde x numIter then dd-lms —
    and never silently drops to the scan; an rls stage (no kernel rule)
    launches nothing."""
    import opticommpy_tpu.kernels.mimo_pallas as mimo_pallas
    from opticommpy_tpu.dsp.equalization import (MIMOEqualizerConfig,
                                                 mimo_adapt_equalizer)

    sig, ref = _training_signal()
    cfg = MIMOEqualizerConfig(nTaps=7, SpS=2, mu=(5e-3, 1e-3),
                              alg=("da-rde", "dd-lms"), L=(512, 512),
                              M=16, numIter=2, backend="pallas",
                              interpret=True)
    with mock.patch.object(mimo_pallas, "_stage_call",
                           wraps=mimo_pallas._stage_call) as spy:
        y = mimo_adapt_equalizer(sig, cfg, symb_ref=ref)
        assert spy.call_count == 3, (
            f"{spy.call_count} kernel launches, expected 3 (2 + 1 passes)")
        assert {c.kwargs["alg"] for c in spy.call_args_list} == {
            "da-rde", "lms"}
    assert np.isfinite(np.asarray(y)).all()

    cfg_rls = MIMOEqualizerConfig(nTaps=7, SpS=2, mu=(1e-3,), alg=("rls",),
                                  M=16, backend="pallas", interpret=True)
    with mock.patch.object(mimo_pallas, "_stage_call",
                           wraps=mimo_pallas._stage_call) as spy:
        mimo_adapt_equalizer(sig, cfg_rls, symb_ref=ref)
        assert spy.call_count == 0


def test_batch_trainer_runs_one_launch_per_stage():
    """mimo_adapt_equalizer_batch puts all B signals of a kernel stage into
    ONE launch (grid over signals x output modes), not B launches."""
    import opticommpy_tpu.kernels.mimo_pallas as mimo_pallas
    from opticommpy_tpu.dsp.equalization import (MIMOEqualizerConfig,
                                                 mimo_adapt_equalizer_batch)

    sig, ref = _training_signal(n_sym=600, seed=24)
    cfg = MIMOEqualizerConfig(nTaps=7, SpS=2, mu=(5e-3, 1e-3),
                              alg=("da-rde", "dd-lms"), L=(300, 300),
                              M=16, numIter=1, backend="pallas",
                              interpret=True)
    with mock.patch.object(mimo_pallas, "_stage_call",
                           wraps=mimo_pallas._stage_call) as spy:
        y = mimo_adapt_equalizer_batch(jnp.stack([sig] * 3), cfg,
                                       symb_ref=jnp.stack([ref] * 3))
        assert spy.call_count == 2
        assert all(c.args[2].shape[0] == 3 for c in spy.call_args_list)
    assert y.shape == (3, 600, 2)


def test_auto_backend_routes_by_platform(monkeypatch):
    """backend='auto' takes the kernel exactly where the platform table
    says 'kernel' (a GPU) and the scan elsewhere; stages without a kernel
    rule always take the scan."""
    from opticommpy_tpu import backend
    from opticommpy_tpu.dsp import equalization as eq

    auto = eq.MIMOEqualizerConfig(backend="auto")
    assert not eq._use_kernel(auto, "dd-lms")  # this suite runs on the CPU
    monkeypatch.setattr(backend, "implementation", lambda platform=None:
                        backend.IMPLEMENTATIONS["gpu"])
    assert eq._use_kernel(auto, "dd-lms")
    assert eq._use_kernel(auto, "da-rde")
    assert not eq._use_kernel(auto, "rls")
    assert not eq._use_kernel(eq.MIMOEqualizerConfig(backend="auto",
                                                     blockUpdate=8), "nlms")
    assert not eq._use_kernel(eq.MIMOEqualizerConfig(backend="scan"),
                              "dd-lms")
