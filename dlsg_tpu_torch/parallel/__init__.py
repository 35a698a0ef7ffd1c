"""Data and tensor parallelism: one process per card over
`torch.distributed`, laid out as a (data, model) mesh of ranks
(counterpart of `dlsg_tpu/parallel`; its XLA placement helpers
`batch_sharding`, `replicated` and `shard_batch` have no meaning under
explicit collectives)."""

from dlsg_tpu_torch.parallel.dist import (  # noqa: F401
    all_reduce_grads,
    barrier,
    broadcast_module,
    copy_to_model,
    current_mesh,
    data_rank,
    data_size,
    gather_eval,
    gather_from_model,
    global_sum,
    init_distributed,
    is_distributed,
    is_leader,
    rank,
    world_size,
)
from dlsg_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    TP_RULES,
    Mesh,
    make_mesh,
    param_sharding_specs,
    shard_params,
    shard_train_state,
    whole_optimizer_state,
    whole_state_dict,
)
