from .mesh import (Shard, all_reduce_grads, all_reduce_stats, any_rank,  # noqa: F401
                   barrier, current_shard, free_port, global_mean, is_primary, join_group,
                   local_device, maybe_initialize_distributed, mean_over_ranks,
                   process_shard, rank, replicate, shard_draw, single_host,
                   start_workers, world_size)
