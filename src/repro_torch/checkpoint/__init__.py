from repro_torch.checkpoint.io import (flatten_with_paths, load_pytree,  # noqa: F401
                                       params_from_numpy, params_to_numpy,
                                       save_pytree, tree_map,
                                       unflatten_paths)
