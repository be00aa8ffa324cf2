"""Positional encodings and module combinators, the counterpart of
`npf_gwwaveform_tpu/ops/encoders.py`."""

from __future__ import annotations

import torch
from torch import nn


class SinusoidalEncodings(nn.Module):
    """Map x in [-1,1]^x_dim to sin/cos features of size out_dim, with the
    reference's `(x+1)*25 + 1` rescale and c = 10000*(sub_dim/512)^2."""

    def __init__(self, out_dim: int):
        super().__init__()
        self.out_dim = out_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_dim = x.shape[-1]
        if self.out_dim % x_dim != 0:
            raise ValueError(f"out_dim={self.out_dim} not divisible by x_dim={x_dim}")
        sub_dim = self.out_dim // x_dim
        if sub_dim % 2 != 0:
            raise ValueError(f"out_dim/x_dim={sub_dim} must be even")
        c = 10000.0 * (sub_dim / 512.0) ** 2
        two_i_d = torch.arange(0, sub_dim, 2, dtype=torch.float32, device=x.device) / sub_dim
        denom = torch.pow(c, two_i_d).repeat_interleave(2)  # [sub_dim]
        pos = (x[..., None] + 1.0) * 25.0 + 1.0  # [..., x_dim, 1], ~[1, 51]
        ang = pos / denom
        out = torch.stack([torch.sin(ang[..., 0::2]), torch.cos(ang[..., 1::2])], dim=-1)
        return out.reshape(*x.shape[:-1], self.out_dim)


class DiscardIthArg(nn.Module):
    """Call `module` with every positional argument but the i-th; makes the
    ConvCNP decoder independent of x (translation equivariance)."""

    def __init__(self, module: nn.Module, i: int = 0):
        super().__init__()
        self.module = module
        self.i = i

    def forward(self, *args):
        return self.module(*(a for j, a in enumerate(args) if j != self.i))
