"""Tensor, expert, data and sequence parallelism over ranks.

The JAX package's ``parallel`` builds a ``jax.sharding.Mesh`` and leaves
placement and collectives to XLA; the port runs one process per rank, each
holding its slice of the params and pages (mesh.py) and calling the
collectives over ``torch.distributed`` (distributed.py).
"""

from .distributed import (  # noqa: F401
    AxisGroup,
    MultiHostConfig,
    ParallelState,
    init_multihost,
    shutdown_multihost,
)
from .mesh import (  # noqa: F401
    Mesh,
    MeshConfig,
    make_mesh,
    pages_pspec,
    param_pspecs,
    shard_params,
)
