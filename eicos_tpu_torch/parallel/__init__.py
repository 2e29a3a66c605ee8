from .sharding import make_mesh, shard_batch, solve_batch_sharded, solve_shards

__all__ = ["make_mesh", "shard_batch", "solve_batch_sharded", "solve_shards"]
