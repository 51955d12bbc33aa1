from repro_torch.checkpoint.checkpoint import (key_paths, load_pytree,  # noqa: F401
                                               save_pytree)
