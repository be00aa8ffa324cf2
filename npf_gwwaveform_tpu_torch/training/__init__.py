from .adapt import adapt_batch_stats
from .checkpoint import (flax_from_params, load_run_params, params_from_flax, read_msgpack,
                         save_run_params, write_msgpack)
from .optim import AdamSchedule, exponential_decay_gamma, make_optimizer
from .state import TrainState, count_parameters
from .evaluate import eval_loglike
from .trainer import Trainer
from .train import has_checkpoint, train_models, write_history, write_model_summary

__all__ = ["adapt_batch_stats", "AdamSchedule", "TrainState", "Trainer", "count_parameters", "exponential_decay_gamma",
           "flax_from_params", "load_run_params", "make_optimizer", "params_from_flax",
           "read_msgpack", "save_run_params", "write_msgpack", "eval_loglike", "train_models",
           "write_history", "write_model_summary", "has_checkpoint"]
