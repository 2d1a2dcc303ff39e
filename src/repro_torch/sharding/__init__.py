from repro_torch.sharding.partitioning import (  # noqa: F401
    NamedSharding, batch_axes, cache_leaf_spec, cache_spec,
    distribute_specs, distribute_tree, logits_constrainer, param_spec, shard_cache_for_model,
    shard_params, spec_placements, token_spec, with_sharding)
