"""Data-parallel scale-out over ``torch.distributed`` (port of
``seed_rl_tpu/parallel``)."""

from seed_rl_torch.parallel.dp import DistributedLearner  # noqa: F401
from seed_rl_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    init_multi_host,
    make_mesh,
    spawn,
)
