from .mesh import Mesh, initialize_multihost, make_mesh  # noqa: F401
from .train import (make_sharded_multi_step, make_sharded_train_step,  # noqa: F401
                    shard_batch, sync_replicas)
