"""Hand-written kernels for the serial hot loops.

- :mod:`mimo_pallas` — NxN adaptive equalizer recurrence (lms/nlms/cma/rde/
  da-rde rules) as a Pallas kernel on the Triton route: one program per
  (signal, output mode), taps held in registers across the whole stage.
"""

from opticommpy_tpu.kernels.mimo_pallas import (  # noqa: F401
    mimo_eq_pallas,
    mimo_eq_pallas_batch,
)
