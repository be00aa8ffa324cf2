"""What a training run carries from step to step, the counterpart of
`npf_gwwaveform_tpu/training/state.py`: the model (its parameters and
BatchNorm running statistics), the optimizer with its schedule, the step
count and the generator every random draw of the run comes from."""

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


def count_parameters(model: torch.nn.Module) -> int:
    """Trainable parameters (BatchNorm's running statistics excluded)."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
