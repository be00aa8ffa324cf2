from .checkpoint import (flax_from_params, load_run_params, params_from_flax, read_msgpack,
                         save_run_params, write_msgpack)
from .optim import AdamSchedule, exponential_decay_gamma, make_optimizer
from .state import TrainState, count_parameters
from .trainer import Trainer

__all__ = ["AdamSchedule", "TrainState", "Trainer", "count_parameters", "exponential_decay_gamma",
           "flax_from_params", "load_run_params", "make_optimizer", "params_from_flax",
           "read_msgpack", "save_run_params", "write_msgpack"]
