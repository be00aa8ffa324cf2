"""What a training run carries from step to step, the counterpart of
`npf_gwwaveform_tpu/training/state.py`: the model (its parameters and
BatchNorm running statistics), the optimizer with its schedule, the step
count and the generator every random draw of the run comes from.

`step` is the host's count of steps taken; `count`, the optimizer's update
count, is the same number held on the device, where the learning rate is
computed from it (a step replayed from a CUDA graph advances the device
count, and the trainer advances `step` after each replay)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .optim import AdamSchedule

__all__ = ["TrainState", "count_parameters"]


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: AdamSchedule
    generator: torch.Generator
    step: int = 0

    @property
    def count(self) -> torch.Tensor:
        """The update count, a 0-d int64 tensor on the parameters' device."""
        return self.optimizer.count


def count_parameters(model: torch.nn.Module) -> int:
    """Trainable parameters (BatchNorm's running statistics excluded)."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
