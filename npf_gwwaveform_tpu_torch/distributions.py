"""Diagonal Gaussian predictive, the counterpart of
`npf_gwwaveform_tpu/distributions.py::NormalDiag`. Log-probs are float32."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


class NormalDiag(NamedTuple):
    """Diagonal Gaussian whose event dimension is the last axis."""

    loc: torch.Tensor
    scale: torch.Tensor

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """Log density summed over the last axis; returns the batch shape."""
        loc = self.loc.float()
        scale = self.scale.float()
        z = (x.float() - loc) / scale
        per_dim = -0.5 * z * z - torch.log(scale) - _HALF_LOG_2PI
        return per_dim.sum(dim=-1)
