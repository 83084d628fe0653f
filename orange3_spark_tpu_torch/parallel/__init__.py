from orange3_spark_tpu_torch.parallel.collectives import (
    data_parallel_sum,
    distributed_gramian,
    tree_aggregate,
)
from orange3_spark_tpu_torch.parallel.partitioner import (
    BasePartitioner,
    DataParallelPartitioner,
    SPMDPartitioner,
)

__all__ = [
    "data_parallel_sum",
    "distributed_gramian",
    "tree_aggregate",
    "BasePartitioner",
    "DataParallelPartitioner",
    "SPMDPartitioner",
]
