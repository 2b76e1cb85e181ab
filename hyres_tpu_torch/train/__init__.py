from .checkpoint import (delete_by_prefix, extract_variables, load_checkpoint,
                         restore_into, restore_train_state, save_checkpoint,
                         train_checkpoint, unwrap_params)
from .data import DataLoader, ImageFolder, load_image, save_image
from .engine import (TrainState, create_train_state, make_eval_step, make_train_step,
                     run_eval)
from .optimizers import (Plateau, configure_optimizers, get_main_lr, set_main_lr,
                         split_parameters)

__all__ = ["DataLoader", "ImageFolder", "Plateau", "TrainState", "configure_optimizers",
           "create_train_state", "delete_by_prefix", "extract_variables", "get_main_lr",
           "load_checkpoint", "load_image", "make_eval_step", "make_train_step",
           "restore_into", "restore_train_state", "run_eval", "save_checkpoint",
           "save_image", "set_main_lr", "split_parameters", "train_checkpoint",
           "unwrap_params"]
