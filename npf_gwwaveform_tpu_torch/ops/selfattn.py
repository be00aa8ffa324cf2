"""Stacked self-attention, the counterpart of
`npf_gwwaveform_tpu/ops/selfattn.py::SelfAttention`: `n_attn_layers`
attenders (`attn_0`, `attn_1`, ...; transformer blocks by default) of the
set onto itself, with optional positional encodings (`positional`
"absolute": sinusoidal features of the positions added to x; "relative":
`RelativeSinusoidalEncodings` of every pair of positions added to the keys
of each attender, which then has no query bias: "multihead" only, as in
JAX), then a linear `resize` to
`out_dim` (xavier, switchable). Mask-aware: a padded point is attended by
no point. `dtype` is JAX's: every attender's and `resize`'s compute
dtype (the positional encodings stay float32, as in JAX)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils import init as winit
from .attention import get_attender
from .mlp import dense
from .encoders import RelativeSinusoidalEncodings, SinusoidalEncodings

__all__ = ["SelfAttention"]


class SelfAttention(nn.Module):
    def __init__(self, x_dim: int, out_dim: Optional[int] = None, n_attn_layers: int = 2,
                 attention: str = "transformer", positional: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        if positional not in (None, "absolute", "relative"):
            raise ValueError(f"Unknown positional={positional}")
        self.positional = positional
        kwargs = {}
        if positional == "absolute":
            self.pos_encoder = SinusoidalEncodings(x_dim)
        elif positional == "relative":
            self.rel_pos_encoder = RelativeSinusoidalEncodings(x_dim)
            kwargs["is_relative_pos"] = True
        self.n_attn_layers = n_attn_layers
        for i in range(n_attn_layers):
            self.add_module(f"attn_{i}", get_attender(attention, x_dim, x_dim, x_dim,
                                                               dtype=dtype, **kwargs))
        if out_dim is not None:
            self.resize = nn.Linear(x_dim, out_dim)
            self.init_params()

    def init_params(self, generator=None) -> None:
        if hasattr(self, "resize"):
            winit.init_dense(self.resize, winit.switchable(winit.xavier_uniform), generator)

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, N, x_dim], positions [B, N, pos_dim] (with `positional`),
        mask [B, N] bool or None -> [B, N, out_dim or x_dim]."""
        extra = {}
        if self.positional == "absolute":
            x = x + self.pos_encoder(positions)
        elif self.positional == "relative":
            extra["rel_pos_enc"] = self.rel_pos_encoder(positions, positions)
        out = x
        for i in range(self.n_attn_layers):
            out = getattr(self, f"attn_{i}")(out, out, out, mask_keys=mask, **extra)
        return dense(self.resize, out, self.dtype) if hasattr(self, "resize") else out
