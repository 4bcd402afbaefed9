"""Multi-chip scaling: device meshes, data-parallel SSFM, time-sharded filtering.

See SURVEY.md §2.3 — the reference has no distributed layer; this package is
its replacement (jax.sharding + shard_map + collectives between devices).
"""

from opticommpy_tpu.parallel.mesh import (  # noqa: F401
    NamedSharding,
    P,
    data_sharding,
    make_mesh,
)
from opticommpy_tpu.parallel.distributed import (  # noqa: F401
    init_distributed,
    is_multihost,
    local_device_count,
)
from opticommpy_tpu.parallel.sharded import (  # noqa: F401
    default_sp_halo,
    manakov_ssf_dp,
    manakov_ssf_pp,
    manakov_ssf_sp,
    shard_batch,
    sharded_edc,
    sharded_fir,
)
