"""Data parallelism over cards (``parallel/mesh.py``): the counterpart of
``handnet_tpu/parallel``."""

from handnet_tpu_torch.parallel.mesh import (DataMesh, all_reduce_sum, barrier, create_mesh,
                                             dp_scale, init_data_parallel, rank_zero_first,
                                             reduce_mean, replicate, shard_batch, torchrun_mesh)

__all__ = ["DataMesh", "all_reduce_sum", "barrier", "create_mesh", "dp_scale",
           "init_data_parallel", "rank_zero_first", "reduce_mean", "replicate", "shard_batch", "torchrun_mesh"]
