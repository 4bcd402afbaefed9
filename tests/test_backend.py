"""The platform table (opticommpy_tpu.backend) and what consults it."""

import jax
import pytest

from opticommpy_tpu import backend


@pytest.mark.parametrize("platform, impl", [("gpu", "kernel"),
                                            ("cpu", "xla")])
def test_table_maps_platforms(platform, impl):
    assert backend.implementation(platform) == impl


@pytest.mark.parametrize("platform", ["neuron", "rocm", "METAL", ""])
def test_unknown_platform_raises(platform):
    with pytest.raises(NotImplementedError, match="no implementation"):
        backend.implementation(platform)


def test_default_platform_is_jax_backend():
    assert jax.default_backend() == "cpu"
    assert backend.implementation() == "xla"


def test_compat_checkgpu_and_ldpc_early_exit_follow_table(monkeypatch):
    """compat.checkGPU and decodeLDPC's earlyExit default read the table,
    not 'platform != cpu'."""
    from opticommpy_tpu import compat

    assert compat.checkGPU() is False
    monkeypatch.setattr(compat, "implementation", lambda: "kernel")
    assert compat.checkGPU() is True
    monkeypatch.setattr(compat, "implementation", lambda: "no-such")
    assert compat.checkGPU() is False


def test_explicit_kernel_needs_interpret_on_cpu():
    """A user call never drops into interpret mode by itself: asking for
    the kernel on the CPU without interpret=True is an error, not a
    silent interpreter run or a silent scan."""
    import numpy as np

    from opticommpy_tpu.dsp import MIMOEqualizerConfig, mimo_adapt_equalizer

    sig = jax.numpy.asarray(
        np.random.default_rng(0).normal(size=(64, 2)).astype(np.complex64))
    cfg = MIMOEqualizerConfig(nTaps=5, alg=("cma",), M=4, backend="pallas")
    with pytest.raises(ValueError, match="interpret"):
        jax.block_until_ready(mimo_adapt_equalizer(sig, cfg))


def test_unknown_equalizer_backend_raises():
    from opticommpy_tpu.dsp import MIMOEqualizerConfig, mimo_adapt_equalizer

    cfg = MIMOEqualizerConfig(nTaps=5, alg=("cma",), M=4, backend="cuda")
    with pytest.raises(ValueError, match="unknown MIMO equalizer backend"):
        mimo_adapt_equalizer(jax.numpy.ones((64, 2), "complex64"), cfg)
