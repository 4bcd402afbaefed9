"""DSP primitives (counterpart of reference ``optic/dsp/core.py``).

Everything streaming runs as JAX/XLA ops (one code path for every platform,
replacing the reference's Numba/CuPy dual stack); filter *design* (tap
generation) is host-side NumPy since it is offline setup producing constants.
"""

from opticommpy_tpu.ops.filtering import (
    fir_filter,
    lowpass_fir,
    overlap_save,
    pulse_shape,
    rc_taps,
    rrc_taps,
)
from opticommpy_tpu.ops.noise import (
    gaussian_complex_noise,
    gaussian_noise,
    phase_noise,
)
from opticommpy_tpu.ops.signal import (
    anorm,
    clock_sampling_interp,
    decimate,
    delay_signal,
    finddelay,
    freq_shift,
    iq_mixing,
    moving_average,
    pnorm,
    quantizer,
    resample,
    sig_pow,
    signal_power,
    symbol_sync,
    upsample,
)
from opticommpy_tpu.ops.modulator import calc_mzm, calc_pm
from opticommpy_tpu.ops.whitening import (
    autocorr,
    estimate_whitening_filter,
    levinson,
)

__all__ = [
    "fir_filter",
    "lowpass_fir",
    "overlap_save",
    "pulse_shape",
    "rc_taps",
    "rrc_taps",
    "gaussian_complex_noise",
    "gaussian_noise",
    "phase_noise",
    "anorm",
    "clock_sampling_interp",
    "decimate",
    "delay_signal",
    "finddelay",
    "freq_shift",
    "iq_mixing",
    "moving_average",
    "pnorm",
    "quantizer",
    "resample",
    "sig_pow",
    "signal_power",
    "symbol_sync",
    "upsample",
    "calc_mzm",
    "calc_pm",
    "autocorr",
    "estimate_whitening_filter",
    "levinson",
]
