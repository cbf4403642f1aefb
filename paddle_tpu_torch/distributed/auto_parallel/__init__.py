"""The auto-parallel namespace (Paddle's
``python/paddle/distributed/auto_parallel/``), over
``torch.distributed.tensor``. Counterpart of
``paddle_tpu/distributed/auto_parallel/__init__.py``."""
from .placement import (  # noqa: F401
    Partial, Placement, ProcessMesh, Replicate, Shard, auto_mesh,
    dp_mp_mesh_candidates, get_current_mesh)
from .api import (  # noqa: F401
    DistParameter, ShardDataloader, ShardingStage0, ShardingStage1,
    ShardingStage2, ShardingStage3, dtensor_from_fn, reshard,
    shard_dataloader, shard_layer, shard_optimizer, shard_tensor,
    unshard_dtensor)
from .dist_model import DistModel, to_static  # noqa: F401
from .engine import Engine  # noqa: F401
from .strategy import Strategy  # noqa: F401
from . import spmd_rules  # noqa: F401
from .spmd_rules import (DistTensorSpec, get_spmd_rule,  # noqa: F401
                         register_spmd_rule)
from . import completion  # noqa: F401
from .completion import (  # noqa: F401
    PlanSearchResult, ScoredPlan, complete_placements, derive_shard_plan,
    search_shard_plans)
