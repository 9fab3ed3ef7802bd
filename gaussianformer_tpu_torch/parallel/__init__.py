"""Multi-process training (gaussianformer_tpu/parallel/): the process group
and host-level reductions; the model is wrapped in torch's
DistributedDataParallel by the runner."""
from .distributed import (all_reduce_sum_host, barrier, init_distributed,
                          is_main_process, local_rank, shutdown_distributed)

__all__ = ["all_reduce_sum_host", "barrier", "init_distributed",
           "is_main_process", "local_rank", "shutdown_distributed"]
