"""Train and eval steps, the counterpart of
`npf_gwwaveform_tpu/training/trainer.py` (`Trainer._step_impl`,
`_eval_step`).

A train step splits the batch into contexts and targets, runs the model in
train mode (BatchNorm on batch statistics, its running statistics updated),
computes the criterion's train loss, backpropagates and takes one optimizer
step. Every random draw comes from the state's `torch.Generator`, on the
batch's device. Nothing in a step reads a value back to the host: the
metrics are 0-d device tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..losses import BaseLossNPF
from .optim import AdamSchedule
from .state import TrainState

__all__ = ["Trainer"]


class Trainer:
    """(model, criterion, optimizer, splitter): splitter(generator, x, y,
    condition=None) -> batch dict (`data.CntxtTrgtSplitter`)."""

    def __init__(self, model: torch.nn.Module, criterion: BaseLossNPF, optimizer: AdamSchedule,
                 splitter: Callable, generator: Optional[torch.Generator] = None):
        self.criterion = criterion
        self.eval_criterion = dataclasses.replace(criterion, reduction=None)
        self.splitter = splitter
        if generator is None:
            generator = torch.Generator(device=next(model.parameters()).device).manual_seed(0)
        self.state = TrainState(model, optimizer, generator)

    @property
    def model(self) -> torch.nn.Module:
        return self.state.model

    def _forward(self, batch: dict):
        return self.model(batch["X_cntxt"], batch["Y_cntxt"], batch["X_trgt"],
                          mask_cntxt=batch["mask_cntxt"], mask_trgt=batch["mask_trgt"],
                          condition=batch.get("condition"))

    def loss_and_grads(self, batch: dict) -> torch.Tensor:
        """Forward in train mode on a split batch and backward: the loss, with
        every parameter's `.grad` set. Takes no optimizer step."""
        self.model.train()
        self.state.optimizer.zero_grad()
        loss = self.criterion(self._forward(batch), batch["Y_trgt"], batch["mask_trgt"],
                              train=True)
        loss.backward()
        return loss.detach()

    def _step(self, x, y, cond) -> dict:
        batch = self.splitter(self.state.generator, x, y, condition=cond)
        loss = self.loss_and_grads(batch)
        grad_norm = self.state.optimizer.step()
        self.state.step += 1
        return {"loss": loss, "grad_norm": grad_norm}

    def train_step(self, x, y) -> dict:
        """One update on raw (x [B,N,1], y [B,N,y_dim]) -> {loss, grad_norm}."""
        return self._step(x, y, None)

    def train_step_cond(self, x, y, cond) -> dict:
        """As `train_step`, conditioned on cond [B, cond_dim]."""
        return self._step(x, y, cond)

    @torch.no_grad()
    def eval_step(self, x, y, generator: torch.Generator, cond=None) -> torch.Tensor:
        """Per-function eval loss [B] (NPML forced) in eval mode, split with
        the given generator."""
        self.model.eval()
        batch = self.splitter(generator, x, y, condition=cond)
        return self.eval_criterion(self._forward(batch), batch["Y_trgt"], batch["mask_trgt"],
                                   train=False)
