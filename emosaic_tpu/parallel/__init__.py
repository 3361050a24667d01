"""Multi-chip parallel layer: mesh construction + sharded match/composite
+ multi-controller (multi-host) support."""

from emosaic_tpu.parallel.distributed import (  # noqa: F401
    fetch,
    init_distributed,
    is_multiprocess,
)
from emosaic_tpu.parallel.lut import sharded_build_l1_lut  # noqa: F401
from emosaic_tpu.parallel.mesh import make_mesh  # noqa: F401
from emosaic_tpu.parallel.sharded import (  # noqa: F401
    sharded_l1_argmin,
    sharded_l1_argmin_ring,
    sharded_l1_topk,
    sharded_l1_topk_adaptive,
    sharded_mosaic_step,
)
