"""Positional encodings and module combinators, the counterpart of
`npf_gwwaveform_tpu/ops/encoders.py`: `SinusoidalEncodings`,
`RelativeSinusoidalEncodings`, `MergeFlatInputs` (JAX's `merge_flat_input`
builds one) and `DiscardIthArg`."""

from __future__ import annotations

import torch
from torch import nn

from ..utils import init as winit
from .mlp import MLP


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


class RelativeSinusoidalEncodings(nn.Module):
    """Sinusoidal encodings of |key - query| rescaled from [0, window_size]
    to [-1, 1], through a bias-free linear layer (xavier, switchable), and
    zero where a coordinate's distance reaches `window_size`: keys_pos [B,
    K, x_dim], queries_pos [B, Q, x_dim] -> [B, Q, K, out_dim]. The layer
    is `module`, as flax names it `Dense_0`."""

    def __init__(self, out_dim: int, window_size: float = 2.0):
        super().__init__()
        self.window_size = window_size
        self.sin = SinusoidalEncodings(out_dim)
        self.module = nn.Linear(out_dim, out_dim, bias=False)
        self.init_params()

    def init_params(self, generator=None) -> None:
        winit.init_dense(self.module, winit.switchable(winit.xavier_uniform), generator)

    def forward(self, keys_pos: torch.Tensor, queries_pos: torch.Tensor) -> torch.Tensor:
        diff = (keys_pos[:, None, :, :] - queries_pos[:, :, None, :]).abs()
        out = self.module(self.sin(diff * 2.0 / self.window_size - 1.0))
        in_window = (diff < self.window_size).all(dim=-1, keepdim=True)
        return out * in_window.to(out.dtype)


def _compact(t: torch.Tensor) -> torch.Tensor:
    """t with every broadcast axis but the last (stride 0, an `expand`)
    narrowed to size 1: a row-wise map of the result broadcasts back to
    t's shape, computed once a distinct row."""
    for d in range(t.dim() - 1):
        if t.stride(d) == 0 and t.shape[d] > 1:
            t = t.narrow(d, 0, 1)
    return t


class MergeFlatInputs(nn.Module):
    """Feed two flat inputs to `module`: with `is_sum_merge`, x2 resized to
    x1's width by the MLP `resizer` (one hidden layer of 32, clamped) and
    relu(x1 + x2), broadcast over leading axes (a z axis on x2; the resizer
    runs on x2's distinct rows only, `_compact`); else the two
    concatenated, the one with fewer axes broadcast to the other's leading
    shape. `module` stands for flax's inner `MLP_0` (or `SelfAttention_0`)."""

    def __init__(self, module: nn.Module, x1_dim: int, x2_dim: int, is_sum_merge: bool = False):
        super().__init__()
        self.is_sum_merge = is_sum_merge
        if is_sum_merge:
            self.resizer = MLP(x2_dim, x1_dim)
        self.module = module

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, **kwargs) -> torch.Tensor:
        if self.is_sum_merge:
            out = torch.relu(x1 + self.resizer(_compact(x2)))
        else:
            if x1.dim() < x2.dim():
                x1 = x1.expand(x2.shape[:-1] + x1.shape[-1:])
            elif x2.dim() < x1.dim():
                x2 = x2.expand(x1.shape[:-1] + x2.shape[-1:])
            out = torch.cat([x1, x2], dim=-1)
        return self.module(out, **kwargs)
