"""Adam with a staircase per-epoch learning-rate decay and optional global
grad-norm clipping; the counterpart of `npf_gwwaveform_tpu/training/optim.py`.

The learning rate of update k (counting from 0) is
lr * gamma ** floor(k / steps_per_epoch), optax's staircase
`exponential_decay`, with gamma = (1 / decay_lr) ** (1 / max_epochs). Adam's
update is optax's: bias-corrected moments, eps outside the square root
(`torch.optim.Adam` computes the same). Clipping is optax's
`clip_by_global_norm`: g * c / ||g|| where ||g|| >= c, g elsewhere
(`torch.nn.utils.clip_grad_norm_` adds 1e-6 to the norm, so it is not used).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import torch

__all__ = ["exponential_decay_gamma", "make_optimizer", "global_norm", "AdamSchedule"]


def exponential_decay_gamma(decay_factor: Optional[float], max_epochs: int) -> float:
    """gamma with gamma ** max_epochs == 1 / decay_factor."""
    if decay_factor is None or decay_factor <= 1:
        return 1.0
    return (1.0 / decay_factor) ** (1.0 / max_epochs)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, a 0-d tensor (no host sync)."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


@dataclass
class AdamSchedule:
    """The optimizer, its learning-rate schedule and the clip norm."""

    adam: torch.optim.Adam
    schedule: torch.optim.lr_scheduler.LambdaLR
    grad_clip_norm: Optional[float] = None

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """One update from the parameters' `.grad`; returns the global norm of
        the gradients before clipping, as a 0-d tensor on their device."""
        grads = [p.grad for group in self.adam.param_groups for p in group["params"]
                 if p.grad is not None]
        norm = global_norm(grads)
        if self.grad_clip_norm is not None:
            scale = torch.where(norm < self.grad_clip_norm, torch.ones_like(norm),
                                self.grad_clip_norm / norm)
            torch._foreach_mul_(grads, scale)
        self.adam.step()
        self.schedule.step()
        return norm

    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.adam.param_groups[0]["lr"]


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 1e-3,
                   decay_lr: Optional[float] = 10.0, max_epochs: int = 100,
                   steps_per_epoch: int = 1,
                   grad_clip_norm: Optional[float] = None) -> AdamSchedule:
    gamma = exponential_decay_gamma(decay_lr, max_epochs)
    adam = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    schedule = torch.optim.lr_scheduler.LambdaLR(
        adam, lambda k: gamma ** (k // steps_per_epoch))
    return AdamSchedule(adam, schedule, grad_clip_norm)
