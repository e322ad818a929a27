"""The ``(data, model)`` mesh of ranks, shardings and collectives."""

from .mesh import (
    Mesh,
    activation_block,
    all_reduce,
    barrier,
    batch_sharding,
    gather_batch,
    gather_params,
    make_mesh,
    make_multislice_mesh,
    make_stager,
    mlp_tp_spec,
    one_rank,
    pmean_grads,
    pmean_metrics,
    replicated,
    run_ranks,
    shard_batch,
    shard_params,
    spatial_sharding,
)
