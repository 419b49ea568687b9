"""Stream parallelism (JAX ``parallel/``): one process per card, a 1-D
``"stream"`` mesh over the default process group, the batched force
forward, and the whole-limb fusion heads as ``torch.distributed``
collectives (BASELINE configs 4-5)."""

from vistaf_torch.parallel.distributed import (  # noqa: F401
    global_stream_count,
    initialize_multihost,
    is_multihost_env,
)
from vistaf_torch.parallel.mesh import (  # noqa: F401
    BatchedForce,
    make_stream_mesh,
    motion_gate,
    shard_batch,
    shard_local_batch,
    whole_limb_step,
    whole_limb_step_aux,
)
