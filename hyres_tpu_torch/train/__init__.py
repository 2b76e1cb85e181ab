from .checkpoint import (extract_variables, load_checkpoint, save_checkpoint,
                         unwrap_params)

__all__ = ["extract_variables", "load_checkpoint", "save_checkpoint",
           "unwrap_params"]
