"""Prediction wrapper, the counterpart of `npf_gwwaveform_tpu/utils/predict.py`:
the model in eval mode on a split batch, returning its predictive
distribution or the predictive mean."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["SamplePredictor"]


class SamplePredictor:
    """predictor = SamplePredictor(model); predictor(batch) -> NormalDiag
    (`is_dist`) or its loc [n_z, B, Nt, y_dim]. A latent model's z draws
    come from `generator` (default: one on the model's device seeded
    `seed`), which each call advances."""

    def __init__(self, model: torch.nn.Module, is_dist: bool = False, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        self.model, self.is_dist = model, is_dist
        if generator is None:
            device = next(model.parameters()).device
            generator = torch.Generator(device=device).manual_seed(seed)
        self.generator = generator

    @torch.no_grad()
    def __call__(self, batch: dict):
        self.model.eval()
        out = self.model(batch["X_cntxt"], batch["Y_cntxt"], batch["X_trgt"],
                         mask_cntxt=batch.get("mask_cntxt"), mask_trgt=batch.get("mask_trgt"),
                         condition=batch.get("condition"), generator=self.generator)
        return out.p_yCc if self.is_dist else out.p_yCc.loc
