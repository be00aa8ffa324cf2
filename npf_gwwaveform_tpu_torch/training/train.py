"""`train_models`, the counterpart of `npf_gwwaveform_tpu/training/train.py`:
every model on every dataset for a number of runs, each run in
`{root}/{data}/{model}/run_{i}`, Adam with the staircase decay, the
best-valid parameters kept (and written) each epoch and restored before the
eval, then `eval.csv` from `eval_loglike` (seed 123).

A run directory holds the JAX package's run files that flax can read:
`params.msgpack` and `extra_vars.msgpack` (the best parameters and BatchNorm
statistics, written after every epoch whose valid loss is the best so far,
or every epoch without a valid set), `model_summary.txt`, `history.json`
(one entry an epoch: epoch, train_loss, dur and valid_loss) and `eval.csv`.
Where the JAX harness writes `state.msgpack` (its optax state, step and
running key, beside the parameters), the port writes `train_state.pt`
(`checkpoint.save_train_state`: Adam's moments, the update count, the
step and the trainer's generator), torch only. A run that finds a
checkpoint resumes from both where JAX loads its state: without
`is_retrain` (it returns at once) and with `is_continue_train` (it trains
on, Adam, the schedule and the draws where they stopped; a run directory
without `train_state.pt` restarts them). The steps run eagerly (the GP
harness `train_gp` replays CUDA graphs).

With `mesh=` (`parallel.make_mesh`) every rank makes the same call: the
models train on the mesh's devices through `Trainer(mesh=...)`, one
process's training; the valid and test losses cover the global batch.
Rank 0 alone writes the run files, and every rank waits at a barrier
before it reads them back (at resume and at the best epoch's reload).
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.datasplit import CntxtTrgtSplitter, GetRandomIndcs, get_all_indcs
from ..losses import CNPFLoss
from ..utils.init import init_module
from .checkpoint import (
    load_run_params, load_train_state, params_from_flax, save_run_params, save_train_state,
)
from .evaluate import eval_loglike
from .optim import make_optimizer
from .state import count_parameters
from .trainer import Trainer

__all__ = ["train_models", "write_model_summary", "write_history", "has_checkpoint"]


def write_model_summary(run_dir: str, model: torch.nn.Module) -> None:
    """`model_summary.txt`: the module tree and the parameter count."""
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "model_summary.txt"), "w") as f:
        f.write(f"{model!r}\nn_params: {count_parameters(model)}\n")


def write_history(run_dir: str, history: list) -> None:
    """`history.json`: the list of per-epoch dicts."""
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "history.json"), "w") as f:
        json.dump(history, f)


def has_checkpoint(run_dir: str) -> bool:
    return os.path.exists(os.path.join(run_dir, "params.msgpack"))


def _writes(trainer: Trainer) -> bool:
    """Whether this process writes the run files: rank 0 of a mesh, or the
    one process."""
    return trainer.mesh is None or dist.get_rank() == 0


def _checkpointed(trainer: Trainer, run_dir: str) -> bool:
    """`has_checkpoint`, on a mesh once every rank (rank 0, the writer,
    among them) has reached this point."""
    if trainer.mesh is not None:
        dist.barrier()
    return has_checkpoint(run_dir)


def _load(trainer: Trainer, run_dir: str) -> None:
    """The checkpoint's parameters and statistics, and its train state where
    the run directory has one."""
    trainer.model.load_state_dict(params_from_flax(*load_run_params(run_dir)), strict=True)
    load_train_state(run_dir, trainer)


def _save(trainer: Trainer, run_dir: str) -> None:
    if _writes(trainer):
        save_run_params(run_dir, trainer.model)
        save_train_state(run_dir, trainer)


def train_models(datasets: Dict[str, object], models: Dict[str, object], criterion=None,
                 test_datasets: Optional[Dict[str, object]] = None,
                 valid_datasets: Optional[Dict[str, object]] = None,
                 splitter: Optional[Callable] = None, chckpnt_dirname: str = "runs_torch/",
                 max_epochs: int = 100, batch_size: int = 32, lr: float = 1e-3,
                 decay_lr: Optional[float] = 10.0, grad_clip_norm: Optional[float] = None,
                 runs: int = 1, starting_run: int = 0, seed: int = 123,
                 patience: Optional[int] = None, is_retrain: bool = True,
                 is_continue_train: bool = False, models_kwargs: Optional[Dict] = None,
                 datasets_kwargs: Optional[Dict] = None, callbacks=(), verbose: int = 1,
                 device="cuda", mesh=None) -> dict:
    """Train every model (a module, copied and drawn anew from its init
    schemes with seed `seed + run` for each run, or a factory called with
    the overrides) on every dataset (`data.gp.GPDataset`-like:
    `epoch_batches`, `len`) for `runs` runs -> {"{data}/{model}/run_{i}":
    trainer}. Per-dataset and per-model overrides of `criterion`,
    `splitter`, `batch_size`, `grad_clip_norm`, `max_epochs` and `lr` come
    from `datasets_kwargs` / `models_kwargs`; other keys go to a factory.
    On a `mesh` the models train on its device (`device` is not read)."""
    criterion = CNPFLoss() if criterion is None else criterion
    if splitter is None:
        splitter = CntxtTrgtSplitter(contexts_getter=GetRandomIndcs(a=0.0, b=50),
                                     targets_getter=get_all_indcs)
    models_kwargs, datasets_kwargs = models_kwargs or {}, datasets_kwargs or {}
    device = device if mesh is None else mesh.device
    results = {}
    for data_name, data_train in datasets.items():
        for model_name, model in models.items():
            over = {**datasets_kwargs.get(data_name, {}), **models_kwargs.get(model_name, {})}
            opts = dict(criterion=over.pop("criterion", criterion),
                        splitter=over.pop("splitter", splitter),
                        batch_size=over.pop("batch_size", batch_size),
                        grad_clip_norm=over.pop("grad_clip_norm", grad_clip_norm),
                        max_epochs=over.pop("max_epochs", max_epochs), lr=over.pop("lr", lr))
            if over and isinstance(model, torch.nn.Module):
                raise ValueError(f"overrides {sorted(over)} need a model factory, not a module")
            for run in range(starting_run, starting_run + runs):
                run_dir = os.path.join(chckpnt_dirname, data_name, model_name, f"run_{run}")
                tag = f"{data_name}/{model_name}/run_{run}"
                this = copy.deepcopy(model) if isinstance(model, torch.nn.Module) else model(**over)
                init_module(this, torch.Generator().manual_seed(seed + run))
                trainer = _train_single(
                    this.to(device), data_train=data_train,
                    data_valid=(valid_datasets or {}).get(data_name), run_dir=run_dir,
                    decay_lr=decay_lr, seed=seed + run, patience=patience, is_retrain=is_retrain,
                    is_continue_train=is_continue_train, callbacks=callbacks, verbose=verbose,
                    mesh=mesh, **opts)
                results[tag] = trainer
                data_test = (test_datasets or {}).get(data_name)
                if data_test is not None:
                    lls = eval_loglike(trainer, data_test, batch_size=opts["batch_size"], seed=123)
                    if _writes(trainer):
                        np.savetxt(os.path.join(run_dir, "eval.csv"), lls, delimiter=",")
                    if verbose and _writes(trainer):
                        print(f"{tag} | test log-likelihood {lls.mean():.2f}")
    return results


def _train_single(model, criterion, splitter, data_train, data_valid, run_dir, max_epochs,
                  batch_size, lr, decay_lr, grad_clip_norm, seed, patience, is_retrain,
                  is_continue_train, callbacks, verbose, mesh=None) -> Trainer:
    device = next(model.parameters()).device
    steps_per_epoch = max(1, len(data_train) // batch_size)
    optimizer = make_optimizer(model.parameters(), lr=lr, decay_lr=decay_lr,
                               max_epochs=max_epochs, steps_per_epoch=steps_per_epoch,
                               grad_clip_norm=grad_clip_norm)
    trainer = Trainer(model, criterion, optimizer, splitter,
                      generator=torch.Generator(device=device).manual_seed(seed), mesh=mesh)
    if _writes(trainer):
        write_model_summary(run_dir, model)
    if (not is_retrain or is_continue_train) and _checkpointed(trainer, run_dir):
        _load(trainer, run_dir)
        if not is_retrain:
            return trainer

    history, best_valid, bad_epochs = [], np.inf, 0
    for epoch in range(max_epochs):
        t0 = time.time()
        losses = [trainer.train_step(x.to(device), y.to(device))["loss"]
                  for x, y in data_train.epoch_batches(batch_size)]
        record = {"epoch": epoch + 1, "train_loss": torch.stack(losses).mean().item(),
                  "dur": time.time() - t0}
        if data_valid is not None:
            g = torch.Generator(device=device).manual_seed(12345 + epoch)
            v = torch.cat([trainer.eval_step(x.to(device), y.to(device), g)
                           for x, y in data_valid.epoch_batches(batch_size)]).mean().item()
            record["valid_loss"] = v
            if v < best_valid:
                best_valid, bad_epochs = v, 0
                _save(trainer, run_dir)
            else:
                bad_epochs += 1
        else:
            _save(trainer, run_dir)
        history.append(record)
        if _writes(trainer):
            write_history(run_dir, history)
        for cb in callbacks:
            cb(epoch=epoch, history=history, trainer=trainer)
        if verbose and _writes(trainer):
            msg = f"  epoch {epoch + 1}/{max_epochs} train {record['train_loss']:.3f}"
            if "valid_loss" in record:
                msg += f" valid {record['valid_loss']:.3f}"
            print(msg + f" ({record['dur']:.1f}s)")
        if patience is not None and bad_epochs >= patience:
            break
    if _checkpointed(trainer, run_dir):  # the best epoch's state, before the eval
        _load(trainer, run_dir)
    return trainer
