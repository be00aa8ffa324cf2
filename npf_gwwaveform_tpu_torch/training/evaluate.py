"""Held-out log-likelihood, the counterpart of
`npf_gwwaveform_tpu/training/evaluate.py`: the negative eval loss (NPML
forced, per function summed over its target points) of every function of a
dataset's epoch, split (and a latent model's z drawn) from one generator
seeded 123."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["eval_loglike"]


def eval_loglike(trainer, dataset, batch_size: int = 64, seed: int = 123) -> np.ndarray:
    """Per-function summed log-likelihoods [n] of `dataset.epoch_batches`,
    from `trainer.eval_step` with a generator seeded `seed` on the model's
    device."""
    device = next(trainer.model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    out = [-trainer.eval_step(x.to(device), y.to(device), generator)
           for x, y in dataset.epoch_batches(batch_size)]
    return torch.cat(out).cpu().numpy() if out else np.zeros((0,), np.float32)
