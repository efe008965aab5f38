from .group_sharded import (GroupShardedScaler,  # noqa: F401
                            GroupShardedStage2, GroupShardedStage3,
                            group_sharded_parallel, save_group_sharded_model)
