"""Sharded compute paths: data-parallel SSFM, time-sharded filtering.

Scaling of the two structures the reference already exposes
(SURVEY.md §2.3):

- **Data parallelism** (``shard_batch``/:func:`manakov_ssf_dp`): the SSFM
  batch axis (WDM channels / launch powers / MC seeds) is sharded over the
  mesh ``data`` axis. No collectives are needed during propagation — each
  chip integrates its own fields; XLA inserts any gathers only at the edges.
- **Sequence (time) parallelism** (:func:`sharded_fir` /
  :func:`sharded_edc`): the time axis is sharded over the mesh ``time``
  axis; each chip filters its chunk after receiving K-1 halo samples from
  its neighbors via ``lax.ppermute``. This is the distributed form of
  the reference's overlap-save decomposition (core.py:973).

Both compose in one mesh: ``Mesh((data, time))``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from opticommpy_tpu.models.channels import manakov_ssf
from opticommpy_tpu.ops.filtering import _fft_conv_same

__all__ = [
    "sharded_fir",
    "sharded_edc",
    "manakov_ssf_dp",
    "manakov_ssf_pp",
    "manakov_ssf_sp",
    "shard_batch",
]


def _halo_exchange(x_local, halo_left, halo_right, axis_name, axis=0,
                   circular=False):
    """Gather halo samples from both neighbors along ``axis_name``.

    With ``circular=False`` devices at the chain ends receive zeros (ppermute
    drops edge links), matching the zero-padded boundary semantics of
    overlap-save filtering. With ``circular=True`` the chain wraps around,
    matching the periodic boundary of a full-length FFT.
    ``axis`` selects the sharded array axis the halos are taken along.
    """
    n_dev = jax.lax.axis_size(axis_name)
    take = lambda lo, hi: jax.lax.slice_in_dim(x_local, lo, hi, axis=axis)
    nloc = x_local.shape[axis]
    # send my tail to my right neighbor (their left halo)
    perm_r = [(i, (i + 1) % n_dev) for i in range(n_dev - (not circular))]
    left = jax.lax.ppermute(take(nloc - halo_left, nloc), axis_name, perm_r)
    # send my head to my left neighbor (their right halo)
    perm_l = [((i + 1) % n_dev, i) for i in range(n_dev - (not circular))]
    right = jax.lax.ppermute(take(0, halo_right), axis_name, perm_l)
    return jnp.concatenate([left, x_local, right], axis=axis)


def sharded_fir(x, h, mesh, time_axis="time", mode_axis=None):
    """'same'-mode FIR filtering with the time axis sharded across chips.

    Each chip receives (K-1)//2 halo samples from each neighbor and
    filters its local chunk — the distributed overlap-save of core.py:973.

    Parameters
    ----------
    x : (N, modes) array — N must be divisible by the mesh's time-axis size.
    h : (K,) filter taps.
    mesh : jax.sharding.Mesh with a ``time_axis`` axis.
    mode_axis : optional mesh axis sharding the mode/signal column axis as
        well (keeps a batch-sharded upstream stage's layout, so entering the
        time-sharded stage is a local slice instead of an all-gather).
    """
    x = jnp.asarray(x)
    h = jnp.asarray(h)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    k = h.shape[0]
    # 'same' output at position i uses x[i - k//2 .. i + (k-1)//2]
    halo_l = k // 2
    halo_r = (k - 1) // 2
    out_dtype = (
        jnp.complex64
        if (jnp.issubdtype(x.dtype, jnp.complexfloating)
            or jnp.issubdtype(h.dtype, jnp.complexfloating))
        else jnp.float32
    )

    def local_filter(x_local, h_):
        xx = _halo_exchange(x_local, halo_l, halo_r, time_axis)
        y = _fft_conv_same(h_, xx, out_dtype)
        return y[halo_l : xx.shape[0] - halo_r]

    spec_in = P(time_axis, mode_axis)
    fn = jax.shard_map(
        local_filter,
        mesh=mesh,
        in_specs=(spec_in, P()),
        out_specs=spec_in,
    )
    y = fn(x, h)
    return y[:, 0] if squeeze else y


def sharded_edc(sig, config, mesh, time_axis="time", mode_axis=None):
    """Chromatic-dispersion compensation with a sharded time axis.

    Same filter as :func:`opticommpy_tpu.dsp.equalization.edc`, applied with
    :func:`sharded_fir` halos (the CD impulse response is converted from its
    frequency-domain definition once, host-side).
    """
    from opticommpy_tpu.models.channels import fiber_coefficients

    _, beta2 = fiber_coefficients(0.0, config.D, config.Fc)
    n_coeffs = config.NfilterCoeffs
    if n_coeffs is None:
        n_coeffs = int(
            2 * np.ceil(6.67 * abs(beta2) * config.L * config.Rs**2
                        * (config.Fs / config.Rs))
        )
    w = 2 * np.pi * config.Fs * np.fft.fftfreq(n_coeffs)
    H = np.exp(-1j * (beta2 / 2) * (w**2) * config.L)
    h_t = np.fft.fftshift(np.fft.ifft(H)).astype(np.complex64)
    if n_coeffs % 2 == 0:
        # fftshift centers an even-length impulse at k//2; shift one sample so
        # the zero-delay tap sits at (k-1)//2, the 'same'-convolution center
        h_t = np.concatenate([h_t[1:], [0.0]]).astype(np.complex64)
    return sharded_fir(sig, jnp.asarray(h_t), mesh, time_axis, mode_axis)


def shard_batch(mesh, data_axis="data"):
    """Sharding for the (N, 2k) interleaved-polarization signal layout.

    Shards the column axis: contiguous blocks of even size keep each signal's
    x/y polarization pair on the same chip.
    """
    return NamedSharding(mesh, P(None, data_axis))


def manakov_ssf_pp(e_in, config, key, mesh, stage_axis="stage",
                   n_microbatches=None):
    """Pipeline-parallel Manakov SSFM: spans staged across chips.

    The link's spans are split into ``S`` contiguous stages (one per device
    along ``stage_axis``); the signal batch is split into ``M`` microbatches
    that flow stage -> stage (``lax.ppermute``), GPipe-style. This is
    the pipeline decomposition SURVEY.md §2.3 derives from the reference's
    per-span loop (channels.py:380-456): stage = group of spans, field tensor
    flows chip -> chip.

    Schedule: ``M + S - 1`` ticks; at tick ``t`` stage ``s`` integrates
    microbatch ``t - s`` through its spans, then hands the field to stage
    ``s + 1``. Pipeline efficiency is ``M / (M + S - 1)`` — use
    ``n_microbatches`` well above the stage count. Devices idle in the
    fill/drain bubble compute throwaway zeros (no control flow divergence —
    one compiled program for all stages).

    Parameters
    ----------
    e_in : (N, 2*k) interleaved-polarization batch; ``k`` must be divisible
        by ``n_microbatches``.
    config : SSFMConfig — ``Ltotal/Lspan`` must give a span count divisible
        by the stage count. Adaptive stepping (``nlprMethod``) is supported:
        each microbatch is independent, so per-stage ``while_loop`` trip
        counts need no cross-chip reduction.
    key : PRNG key for ASE noise; folded per (global span, microbatch), so
        statistics match the single-device path (bit-exact equality with
        :func:`manakov_ssf` holds for ``amp='ideal'``/``None``; for
        ``amp='edfa'`` the key streams necessarily differ).
    n_microbatches : default = stage count.

    Returns
    -------
    (N, 2*k) output field, microbatches re-assembled in input order.
    """
    from opticommpy_tpu.models.channels import (
        EDFAConfig, _manakov_span, edfa, fiber_coefficients,
    )

    if config.Fs is None:
        raise ValueError("Simulation sampling frequency (Fs) not provided.")
    n_stages = mesh.shape[stage_axis]
    m = n_stages if n_microbatches is None else int(n_microbatches)

    e_in = jnp.asarray(e_in, dtype=jnp.complex64)
    n = e_in.shape[0]
    k = e_in.shape[1] // 2
    if k % m:
        raise ValueError(f"batch size {k} not divisible by {m} microbatches")
    n_spans = int(np.floor(config.Ltotal / config.Lspan))
    if n_spans % n_stages:
        raise ValueError(
            f"{n_spans} spans not divisible by {n_stages} pipeline stages"
        )
    spans_per_stage = n_spans // n_stages

    # (M, 2, B_mb, N): microbatch axis leading; contiguous column blocks of
    # size 2*(k/m) keep each signal's x/y pair in one microbatch
    b_mb = k // m
    ex = e_in[:, 0::2].T.reshape(m, b_mb, n)
    ey = e_in[:, 1::2].T.reshape(m, b_mb, n)
    e_mb = jnp.stack([ex, ey], axis=1)  # (M, 2, B_mb, N)

    alpha, beta2 = fiber_coefficients(config.alpha, config.D, config.Fc)
    w = 2 * jnp.pi * config.Fs * jnp.fft.fftfreq(n)
    lin_arg = (-(alpha / 2) + 1j * (beta2 / 2) * w**2).astype(jnp.complex64)
    amp_cfg = EDFAConfig(G=config.alpha * config.Lspan, NF=config.NF,
                         Fc=config.Fc, Fs=config.Fs)
    if key is None:
        key = jax.random.PRNGKey(0)
    n_ticks = m + n_stages - 1
    perm_fwd = [(i, i + 1) for i in range(n_stages - 1)]

    def stage_spans(e, stage, mb_idx):
        """Integrate (2, B_mb, N) through this stage's spans."""
        def span(e, local_idx):
            e = _manakov_span(e, lin_arg, config.Lspan, config)
            if config.amp == "edfa":
                span_key = jax.random.fold_in(
                    jax.random.fold_in(key, stage * spans_per_stage + local_idx),
                    mb_idx,
                )
                e = edfa(e, amp_cfg, span_key)
            elif config.amp == "ideal":
                e = e * float(np.exp(alpha / 2 * config.Lspan))
            return e, None

        e, _ = jax.lax.scan(span, e, jnp.arange(spans_per_stage))
        return e

    def pipelined(e_all):
        stage = jax.lax.axis_index(stage_axis)

        def tick(carry, t):
            mb_idx = t - stage
            feed = e_all[jnp.clip(mb_idx, 0, m - 1)]
            cur = jnp.where(stage == 0, feed, carry)
            done = stage_spans(cur, stage, mb_idx)
            nxt = jax.lax.ppermute(done, stage_axis, perm_fwd)
            return nxt, done

        # the carry is device-varying from tick 0 (it crosses ppermute)
        zeros = jax.lax.pcast(jnp.zeros_like(e_all[0]), stage_axis, to="varying")
        _, outs = jax.lax.scan(tick, zeros, jnp.arange(n_ticks))
        return outs  # (n_ticks, 2, B_mb, N); last stage's tail is the result

    fn = jax.jit(jax.shard_map(
        pipelined, mesh=mesh,
        in_specs=P(), out_specs=P(stage_axis),
    ))
    outs = fn(e_mb)  # (S * n_ticks, 2, B_mb, N), stage-major
    # last stage finishes microbatch t-(S-1) at tick t: its final M entries
    final = outs[(n_stages - 1) * n_ticks + (n_stages - 1):]
    ex = final[:, 0].reshape(k, n)
    ey = final[:, 1].reshape(k, n)
    out = jnp.zeros((n, 2 * k), dtype=jnp.complex64)
    out = out.at[:, 0::2].set(ex.T)
    out = out.at[:, 1::2].set(ey.T)
    return out


def _next_smooth(n):
    """Smallest 2/3/5-smooth integer >= n (FFT-friendly length)."""
    best = 1 << max(0, n - 1).bit_length()  # next power of two qualifies
    p3 = 1
    while p3 <= best:
        p35 = p3
        while p35 <= best:
            q = -(-n // p35)  # ceil(n / p35): power-of-two factor needed
            m = p35 * (1 << max(0, q - 1).bit_length())
            if n <= m < best:
                best = m
            p35 *= 5
        p3 *= 3
    return best


def default_sp_halo(config, spans_per_sync=1, safety=4.0):
    """Halo width (samples) for :func:`manakov_ssf_sp`.

    The linear operator of one sync group spreads energy by at most the
    band-edge group delay ``|beta2| * pi * Fs^2 * Lspan * spans_per_sync``
    samples (the nonlinear rotation is pointwise and spreads nothing).
    ``safety``x that, rounded up to a lane-aligned multiple of 128, puts the
    truncation error of the overlapped-block propagation near float32
    round-off.
    """
    from opticommpy_tpu.models.channels import fiber_coefficients

    _, beta2 = fiber_coefficients(config.alpha, config.D, config.Fc)
    tau = abs(beta2) * np.pi * config.Fs**2 * config.Lspan * spans_per_sync
    return int(max(128, 128 * np.ceil(safety * tau / 128)))


def manakov_ssf_sp(e_in, config, key=None, mesh=None, time_axis="time",
                   data_axis=None, halo=None, spans_per_sync=1):
    """Sequence-parallel Manakov SSFM: ONE signal's time axis sharded.

    The per-step split-step operator is almost local in time — one ``hz`` of
    chromatic dispersion moves energy by well under a sample at typical
    parameters — so a chip can propagate its time chunk independently given a
    halo of neighbor samples wide enough to cover the dispersion spread of a
    sync group. Each group of ``spans_per_sync`` spans runs entirely on-chip
    on the halo-padded block (local batched FFTs of length
    ``N/T + 2*halo``); between groups the halos are refreshed from the
    neighbors' exact interiors (``lax.ppermute``, cyclic so the
    global periodic boundary of the reference's full-length FFT is
    preserved). This is the time-axis analog of :func:`sharded_fir`'s
    overlap-save decomposition applied to the propagation itself — the
    framework's long-signal scaling story for a single WDM channel (SURVEY.md
    §5), complementing :func:`manakov_ssf_dp` (batch) and
    :func:`manakov_ssf_pp` (spans).

    Accuracy: the halo must exceed the group's band-edge group delay
    (:func:`default_sp_halo`; the default is 4x the physical spread). With
    that default the output matches the unsharded :func:`manakov_ssf` to
    float32 round-off. Fixed-step configs (``nlprMethod=False``) match the
    single-chip step schedule exactly; with the adaptive rule each shard
    derives its step from its local max phase rotation (a per-step global
    all-reduce would serialize the devices for no accuracy gain — documented
    delta).

    Parameters
    ----------
    e_in : (N, 2*k) interleaved-polarization field; N divisible by the mesh
        time-axis size (and by it times 2*halo granularity).
    config : SSFMConfig.
    key : PRNG key for ASE noise; folded per (span, time-shard) so shards
        draw independent noise (statistics match; streams differ from the
        single-chip path, as with ``manakov_ssf_pp``).
    mesh : Mesh with ``time_axis`` (and optionally ``data_axis`` to also
        shard the signal batch).
    halo : samples of neighbor context per side (default
        :func:`default_sp_halo`).
    spans_per_sync : spans propagated per halo refresh; larger values
        amortize the halo exchange at the cost of a wider halo.

    Returns
    -------
    (N, 2*k) output field.
    """
    from opticommpy_tpu.models.channels import (
        EDFAConfig, _manakov_span, edfa, fiber_coefficients,
    )

    if config.Fs is None:
        raise ValueError("Simulation sampling frequency (Fs) not provided.")
    if mesh is None:
        raise ValueError("manakov_ssf_sp requires a mesh")
    n_time = mesh.shape[time_axis]
    e_in = jnp.asarray(e_in, dtype=jnp.complex64)
    n = e_in.shape[0]
    if n % n_time:
        raise ValueError(f"time length {n} not divisible by {n_time} shards")
    n_spans = int(np.floor(config.Ltotal / config.Lspan))
    if n_spans % spans_per_sync:
        raise ValueError(
            f"{n_spans} spans not divisible by spans_per_sync={spans_per_sync}"
        )
    n_groups = n_spans // spans_per_sync
    if halo is None:
        halo = default_sp_halo(config, spans_per_sync)
    if 2 * halo > n // n_time:
        raise ValueError(
            f"halo {halo} too wide for local chunk {n // n_time}"
        )

    alpha, beta2 = fiber_coefficients(config.alpha, config.D, config.Fc)
    n_loc = n // n_time
    # zero-pad the local block to a 2/3/5-smooth FFT length: the pad region
    # sits beyond the halos, so the contamination front still has to cross a
    # full halo before reaching the interior (same error bound), and the
    # per-step local FFT avoids Bluestein-sized prime factors
    n_pad = _next_smooth(n_loc + 2 * halo)
    w = 2 * jnp.pi * config.Fs * jnp.fft.fftfreq(n_pad)
    lin_arg = (-(alpha / 2) + 1j * (beta2 / 2) * w**2).astype(jnp.complex64)
    amp_cfg = EDFAConfig(G=config.alpha * config.Lspan, NF=config.NF,
                         Fc=config.Fc, Fs=config.Fs)
    if key is None:
        key = jax.random.PRNGKey(0)

    def local(e_loc):  # (2, B_loc, N_loc)
        shard = jax.lax.axis_index(time_axis)

        def sync_group(e_loc, group_idx):
            e_pad = _halo_exchange(e_loc, halo, halo, time_axis, axis=-1,
                                   circular=True)
            extra = n_pad - e_pad.shape[-1]
            if extra:
                e_pad = jnp.pad(e_pad, [(0, 0)] * (e_pad.ndim - 1) + [(0, extra)])

            def span(e_pad, local_idx):
                e_pad = _manakov_span(e_pad, lin_arg, config.Lspan, config)
                if config.amp == "edfa":
                    span_key = jax.random.fold_in(
                        jax.random.fold_in(
                            key, group_idx * spans_per_sync + local_idx),
                        shard,
                    )
                    e_pad = edfa(e_pad, amp_cfg, span_key)
                elif config.amp == "ideal":
                    e_pad = e_pad * float(np.exp(alpha / 2 * config.Lspan))
                return e_pad, None

            e_pad, _ = jax.lax.scan(span, e_pad, jnp.arange(spans_per_sync))
            return e_pad[..., halo:halo + e_loc.shape[-1]], None

        e_loc, _ = jax.lax.scan(sync_group, e_loc, jnp.arange(n_groups))
        return e_loc

    # (2, B, N): pol leading, batch, time on lanes (sharded)
    ex = e_in[:, 0::2].T
    ey = e_in[:, 1::2].T
    e = jnp.stack([ex, ey])
    spec = P(None, data_axis, time_axis)
    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=spec,
                               out_specs=spec))
    e = fn(e)
    k = e.shape[1]
    out = jnp.zeros((n, 2 * k), dtype=jnp.complex64)
    out = out.at[:, 0::2].set(e[0].T)
    out = out.at[:, 1::2].set(e[1].T)
    return out


def manakov_ssf_dp(e_in, config, key, mesh, data_axis="data"):
    """Data-parallel Manakov SSFM: batch signals sharded over chips.

    ``e_in`` is (N, 2k) with k signals; k must be divisible by the mesh's
    data-axis size. With ``nlprMethod=False`` (fixed step) propagation needs
    no inter-chip communication; with the adaptive step-size rule the global
    ``max(phi_rot)`` becomes one scalar all-reduce per z-step (all chips take
    lockstep steps, matching the single-device semantics exactly).
    """
    sharding, fn = _dp_program(config, mesh, data_axis)
    return fn(jax.device_put(jnp.asarray(e_in), sharding), key)


@functools.lru_cache(maxsize=32)
def _dp_program(config, mesh, data_axis):
    """The jitted data-parallel SSFM, built once per (config, mesh, axis):
    a new ``jax.jit`` of a new lambda on every call would trace and compile
    again every time.

    With a fixed step and no ASE every signal propagates alone, so each
    device runs the solver on its own signals (``shard_map``). Otherwise
    (the adaptive step's batch-wide max, the ASE draw over the whole batch)
    the global program keeps the single-device semantics exactly; XLA's
    partitioner then replicates the solver's compute over the batch.
    """
    sharding = shard_batch(mesh, data_axis)

    def run(e, k):
        return manakov_ssf(e, config, k)

    if not config.nlprMethod and config.amp != "edfa":
        run = jax.shard_map(run, mesh=mesh, in_specs=(P(None, data_axis), P()),
                            out_specs=P(None, data_axis))
    return sharding, jax.jit(run, in_shardings=(sharding, None),
                             out_shardings=sharding)
