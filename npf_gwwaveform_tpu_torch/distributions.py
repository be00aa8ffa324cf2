"""Diagonal Gaussian for predictives and latents, the counterpart of
`npf_gwwaveform_tpu/distributions.py` (`NormalDiag`, `kl_normal_diag`).
Log-probs and KLs are float32.

A reparameterised draw is `loc + scale * eps` in float32, as JAX draws it.
`eps` comes from an explicit `torch.Generator` on the distribution's device
(on CUDA the generator a CUDA graph registers, so that a replay draws anew),
or is given: Philox cannot reproduce JAX's threefry draws, so a test hands
JAX's own noise to the port."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)

__all__ = ["NormalDiag", "kl_normal_diag"]


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

    def sample(self, generator: Optional[torch.Generator], sample_shape: tuple = (),
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Reparameterised draw [*sample_shape, *loc.shape]: loc + scale *
        eps, eps standard normal from `generator` in float32, or the given
        `eps` of that shape; gradients flow to loc and scale."""
        shape = tuple(sample_shape) + tuple(self.loc.shape)
        if eps is None:
            eps = torch.randn(shape, generator=generator, dtype=torch.float32,
                              device=self.loc.device)
        elif tuple(eps.shape) != shape:
            raise ValueError(f"eps of shape {tuple(eps.shape)}, not {shape}")
        return self.loc + self.scale * eps.to(self.loc.dtype)

    rsample = sample


def kl_normal_diag(q: NormalDiag, p: NormalDiag) -> torch.Tensor:
    """KL[q || p] of diagonal Gaussians, summed over the last axis, in float32."""
    q_loc, q_scale, p_loc, p_scale = (t.float() for t in (q.loc, q.scale, p.loc, p.scale))
    var_ratio = (q_scale / p_scale).square()
    t1 = ((q_loc - p_loc) / p_scale).square()
    return (0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))).sum(dim=-1)
