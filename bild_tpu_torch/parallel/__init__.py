from .batch import (TrajectoryBatch, BatchResults, stack_trajectories,  # noqa: F401
                    bucket_trajectories, pad_batch_rows, sample_batch)
from .dataset import DatasetResults, sample_dataset  # noqa: F401
