from .batch import (TrajectoryBatch, BatchResults, stack_trajectories,  # noqa: F401
                    bucket_trajectories, pad_batch_rows, sample_batch)
from .dataset import DatasetResults, sample_dataset  # noqa: F401
from .sharded import sample_dataset_sharded  # noqa: F401
from ..infer.adaptive import sample_batch_adaptive  # noqa: F401
from .mesh import (make_mesh, shard_batch, initialize_distributed,  # noqa: F401
                   is_multiprocess, fetch_to_host, broadcast_from_process0,
                   feed_process_local)
