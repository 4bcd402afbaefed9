"""Receiver DSP chain: equalization, carrier/clock recovery, synchronization.

Counterpart of the reference ``optic/dsp`` package (minus core,
which lives in opticommpy_tpu.ops).
"""

from opticommpy_tpu.dsp.carrier_recovery import (  # noqa: F401
    CPRConfig,
    bps,
    cpr,
    ddpll,
    fourth_power_foe,
    residual_linewidth,
    viterbi,
)
from opticommpy_tpu.dsp.clock_recovery import (  # noqa: F401
    FFWClockRecoveryConfig,
    ffw_clock_recovery,
    ClockRecoveryConfig,
    calc_clock_drift,
    gardner_clock_recovery,
)
from opticommpy_tpu.dsp.equalization import (  # noqa: F401
    DFEConfig,
    EDCConfig,
    FFEConfig,
    MIMOEqualizerConfig,
    VolterraConfig,
    dfe,
    edc,
    ffe,
    manakov_dbp,
    mimo_adapt_equalizer,
    mimo_adapt_equalizer_batch,
    mimo_apply,
    mimo_apply_fused,
    volterra,
)
from opticommpy_tpu.dsp.synchronization import (  # noqa: F401
    SyncConfig,
    sync_data_sequences,
)

# Pallas kernel for the adaptive-equalizer recurrence (Triton route)
from opticommpy_tpu.kernels.mimo_pallas import (  # noqa: F401
    mimo_eq_pallas,
    mimo_eq_pallas_batch,
)
