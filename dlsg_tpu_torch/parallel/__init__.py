"""Data parallelism: one process per card over `torch.distributed`
(counterpart of `dlsg_tpu/parallel`, whose mesh helpers have no meaning
here)."""

from dlsg_tpu_torch.parallel.dist import (  # noqa: F401
    all_reduce_grads,
    barrier,
    broadcast_module,
    gather_eval,
    global_sum,
    init_distributed,
    is_distributed,
    is_leader,
    rank,
    world_size,
)
