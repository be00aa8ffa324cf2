"""Test-time re-estimation of the BatchNorm running statistics (AdaBN), the
counterpart of `npf_gwwaveform_tpu/training/adapt.py::adapt_batch_stats`.

`adapt_batch_stats` runs the model in train mode on `n_passes` batches of
unlabelled target-domain images, each drawn with replacement and split by
the eval splitter (the statistics depend on the masked context the CNN
sees), without gradients and without an optimizer: only BatchNorm's running
buffers move (momentum 0.9: after 50 passes about 0.5% of the old estimate
remains). It changes the model in place; the parameters are untouched.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["adapt_batch_stats"]


@torch.no_grad()
def adapt_batch_stats(model: torch.nn.Module, splitter: Callable, images: torch.Tensor,
                      generator: torch.Generator, n_passes: int = 50,
                      batch_size: int = 32) -> torch.nn.Module:
    """Re-estimate `model`'s BatchNorm statistics on `images` [N, *grid,
    y_dim] (on the model's device): each pass draws `batch_size` indices,
    then the split, then (a latent model) z, from `generator`, and applies
    the model in train mode. Returns the model, back in eval mode; a model
    without buffers is returned unchanged."""
    if not any(True for _ in model.buffers()):
        return model
    n = images.shape[0]
    model.train()
    for _ in range(n_passes):
        idx = torch.randint(0, n, (batch_size,), generator=generator, device=images.device)
        y = images[idx]
        b = splitter(generator, y, y)
        model(b["X_cntxt"], b["Y_cntxt"], b["X_trgt"], mask_cntxt=b["mask_cntxt"],
              mask_trgt=b["mask_trgt"], y_trgt=b["Y_trgt"], generator=generator)
    return model.eval()
