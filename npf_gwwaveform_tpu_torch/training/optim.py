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
    """The optimizer, its learning-rate schedule and the clip norm.

    `count` is the number of updates taken, a 0-d int64 tensor on the
    parameters' device. Each update first computes its learning rate there,
    `lr0 * gamma ** floor(count / steps_per_epoch)` in float32 (optax's
    staircase `exponential_decay`), into the 0-d tensor Adam holds as `lr`, and
    ends with `count += 1`: a step reads nothing from the host, so it replays
    from a CUDA graph with the schedule moving. On CUDA, Adam is capturable
    (its step counts on the device too) and uses its foreach kernels, in the
    eager step as in the graph; on the CPU it runs tensor by tensor, the one
    way PyTorch's Adam takes a tensor learning rate there."""

    adam: torch.optim.Adam
    lr0: float
    gamma: float
    steps_per_epoch: int
    count: torch.Tensor
    grad_clip_norm: Optional[float] = None

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def schedule(self, count: torch.Tensor) -> torch.Tensor:
        """The learning rate of update `count`, a 0-d float32 tensor."""
        epochs = torch.floor(count.float() / self.steps_per_epoch)
        return self.lr0 * torch.pow(self.gamma, epochs)

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
        lr = self.schedule(self.count)
        for group in self.adam.param_groups:
            group["lr"].copy_(lr)
        self.adam.step()
        self.count += 1
        return norm

    def lr(self) -> float:
        """The learning rate of the next update (reads it from the device)."""
        return self.schedule(self.count).item()

    def save_state(self):
        """Copies of the update count and of Adam's state -> a function that
        puts them back. State Adam makes after this call (at its first
        update) is put back to zero, as Adam makes it."""
        saved = {p: {k: v.clone() for k, v in s.items()} for p, s in self.adam.state.items()}
        count = self.count.clone()

        def restore() -> None:
            with torch.no_grad():
                self.count.copy_(count)
                for p, s in self.adam.state.items():
                    for k, v in s.items():
                        if p in saved:
                            v.copy_(saved[p][k])
                        else:
                            v.zero_()
        return restore


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 1e-3,
                   decay_lr: Optional[float] = 10.0, max_epochs: int = 100,
                   steps_per_epoch: int = 1,
                   grad_clip_norm: Optional[float] = None) -> AdamSchedule:
    """Adam over `params` (on one device) with the staircase schedule."""
    params = list(params)
    device = params[0].device
    cuda = device.type == "cuda"
    adam = torch.optim.Adam(params, lr=torch.full((), lr, dtype=torch.float32, device=device),
                            betas=(0.9, 0.999), eps=1e-8, capturable=cuda, foreach=cuda)
    return AdamSchedule(adam, lr, exponential_decay_gamma(decay_lr, max_epochs), steps_per_epoch,
                        torch.zeros((), dtype=torch.int64, device=device), grad_clip_norm)
