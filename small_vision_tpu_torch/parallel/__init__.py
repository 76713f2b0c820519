"""The parallel layer: the process mesh, sharding strategies, collectives,
the explicit ZeRO-3 step and the GPipe pipeline."""

from small_vision_tpu_torch.parallel.collectives import (  # noqa: F401
    broadcast_one_to_all,
    fetch_global,
    gather_metrics,
    process_allgather,
)
from small_vision_tpu_torch.parallel.mesh import (  # noqa: F401
    init_distributed,
    make_mesh,
)
from small_vision_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply,
    stage_params,
    unstage_params,
)
from small_vision_tpu_torch.parallel.sharding import (  # noqa: F401
    infer_sharding,
    reshard,
)
