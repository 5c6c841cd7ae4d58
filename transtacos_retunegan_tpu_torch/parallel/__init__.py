from .mesh import (Shard, all_reduce_grads, all_reduce_stats, any_rank,  # noqa: F401
                   barrier, check_model_parallel, column_matmul, copy_to_model,
                   current_shard, data_shards, describe, free_port, gather_from_model,
                   gather_params_tp, gather_tp, global_mean, is_primary, join_group, join_mesh,
                   local_device, make_mesh, maybe_initialize_distributed, mean_over_ranks,
                   process_shard, rank, reduce_from_model, replicate, shard_draw,
                   shard_params_tp, single_host, slice_moments, start_workers, tp_local,
                   tp_param_specs, tp_sharded, world_size)
