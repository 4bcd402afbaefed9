"""Tests for auxiliary subsystems: profiling, checkpoint/resume."""

import jax
import jax.numpy as jnp
import numpy as np

from opticommpy_tpu.utils.checkpoint import load_state, save_state
from opticommpy_tpu.utils.profiling import StageTimer


def test_stage_timer_accumulates():
    timer = StageTimer()
    with timer("a"):
        x = timer.sync(jnp.fft.fft(jnp.ones(4096, jnp.complex64)))
    with timer("b"):
        y = timer.sync(jnp.sum(x))
    assert set(timer.times) == {"a", "b"}
    assert all(t >= 0 for t in timer.times.values())
    assert "total" in timer.table()


def test_checkpoint_roundtrip_complex_pytree(tmp_path):
    state = {
        "H": jnp.asarray(np.random.default_rng(0).normal(size=(2, 2, 15))
                         + 1j * np.random.default_rng(1).normal(size=(2, 2, 15))
                         ).astype(jnp.complex64),
        "field": jnp.ones((128, 2), jnp.complex64),
        "key": jax.random.PRNGKey(7),
        "step": jnp.asarray(42),
    }
    path = str(tmp_path / "ckpt.npz")
    save_state(path, state)
    loaded = load_state(path, like=state)
    for k in state:
        assert np.array_equal(np.asarray(loaded[k]), np.asarray(state[k])), k


def test_checkpoint_resume_equalizer_taps(tmp_path):
    """Save trained taps, reload, and keep filtering — the reference's
    H/H_/Hiter carry-over (equalization.py:191-195) with real serialization."""
    from opticommpy_tpu.dsp import MIMOEqualizerConfig, mimo_adapt_equalizer
    from opticommpy_tpu.dsp.equalization import mimo_apply
    from opticommpy_tpu.comm import modulate_gray
    from opticommpy_tpu.ops import fir_filter, pnorm, pulse_shape, upsample

    key = jax.random.PRNGKey(0)
    symb = pnorm(modulate_gray(
        jax.random.randint(key, (4000 * 4 * 2,), 0, 2), 16, "qam"
    ).reshape(4000, 2))
    pulse = jnp.asarray(pulse_shape("rrc", 2, 256, 0.1))
    sig = pnorm(fir_filter(pulse, upsample(symb, 2)))

    _, H, _, _, _ = mimo_adapt_equalizer(
        sig, MIMOEqualizerConfig(nTaps=7, mu=(2e-3,), SpS=2, alg=("nlms",), M=16),
        symb_ref=symb, return_results=True,
    )
    path = save_state(str(tmp_path / "taps.npz"), {"H": H})
    H2 = load_state(path, like={"H": H})["H"]
    y1 = mimo_apply(H, sig, 2)
    y2 = mimo_apply(H2, sig, 2)
    assert np.array_equal(np.asarray(y1), np.asarray(y2))


def test_enable_persistent_cache(tmp_path, monkeypatch):
    import jax
    from opticommpy_tpu.utils import enable_persistent_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    p = enable_persistent_cache(str(tmp_path / "xla"), min_compile_secs=0.0)
    try:
        assert p == str(tmp_path / "xla")
        import os
        assert os.path.isdir(p)
        # a compile should populate the cache directory
        import jax.numpy as jnp
        jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(512)).block_until_ready()
        assert len(os.listdir(p)) >= 1
    finally:
        # FULL teardown: resetting only the dir leaves the initialized
        # cache object live with min_compile_time=0 — every later big
        # compile in the suite then cache-writes into the deleted
        # tmp_path and jax's put_executable_and_time SEGFAULTS the run
        # (observed at test_fec's early-exit while_loop compile)
        jax.config.update("jax_compilation_cache_dir", None)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          1.0)
        try:
            from jax._src import compilation_cache as _cc

            _cc.reset_cache()
        except Exception:
            pass


def test_cache_dir_follows_env_var(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins; without it the fixed checkout path
    (never a home directory, temporary name, PID or time)."""
    import os

    from opticommpy_tpu.utils import compile_cache as cc

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/cache")
    assert cc.cache_dir() == "/somewhere/cache"
    assert cc.cache_dir("/explicit") == "/somewhere/cache"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cc.cache_dir() == os.path.join(root, ".jax_cache")
    assert cc.cache_dir() == cc.DEFAULT_CACHE_DIR
    assert cc.cache_dir("/explicit") == "/explicit"


def test_enable_persistent_cache_sets_no_dir_under_env(monkeypatch):
    import jax

    from opticommpy_tpu.utils import enable_persistent_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/from/env")
    try:
        assert enable_persistent_cache(min_compile_secs=7.0) == "/from/env"
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def test_device_time_by_scope_attributes_a_cpu_trace(tmp_path):
    """The trace reduction the smoke script uses, on a small recorded XLA:CPU
    trace: every named scope's kernels are found and the shares add up."""
    import jax
    import jax.numpy as jnp

    from opticommpy_tpu.utils.profiling import device_time_by_scope, trace

    def f(x):
        with jax.named_scope("first"):
            y = jnp.sin(x) * 2.0
        with jax.named_scope("second"):
            return jnp.cumsum(y) * 3.0

    x = jnp.ones(1 << 18)
    compiled = jax.jit(f).lower(x).compile()
    compiled(x).block_until_ready()
    with trace(str(tmp_path)):
        compiled(x).block_until_ready()
    r = device_time_by_scope(str(tmp_path), [compiled.as_text()],
                             {"first": "/first/", "second": "/second/"})
    assert r["by_scope"]["first"] > 0 and r["by_scope"]["second"] > 0
    assert 0.0 <= r["idle_share"] < 1.0
    assert r["busy_s"] <= r["window_s"] + 1e-12
    assert sum(r["by_scope"].values()) >= r["busy_s"] * 0.999
    assert r["top"] and r["top"][0][1] > 0


def test_hlo_op_scopes_follows_fusion_calls():
    from opticommpy_tpu.utils.profiling import hlo_op_scopes

    text = """HloModule m

%fused_computation.1 (param_0: f32[4]) -> f32[4] {
  %param_0 = f32[4]{0} parameter(0)
  ROOT %sine.1 = f32[4]{0} sine(%param_0), metadata={op_name="jit(f)/bps/sin"}
}

ENTRY %main.2 (x: f32[4]) -> f32[4] {
  %x = f32[4]{0} parameter(0)
  ROOT %fusion.1 = f32[4]{0} fusion(%x), kind=kLoop, calls=%fused_computation.1, metadata={op_name="jit(f)/bps/sin"}
}
"""
    sc = hlo_op_scopes(text)
    assert "jit(f)/bps/sin" in sc["fusion.1"]
    assert sc["x"] == set()
