"""Depthwise-separable residual CNN over the induced grid; the counterpart of
`npf_gwwaveform_tpu/ops/cnn.py` (`ResConvBlock`, `CNN`, flax `BatchNorm`).

The JAX package is channel-last; `CNN` keeps that at its interface and runs
its blocks channel-first, the layout of `torch.nn.functional.conv1d`. The
convolutions are stock PyTorch, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils import init as winit


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=eps)` over channel-first
    [B, C, L], in flax's order: (x - mean) * (scale * rsqrt(var + eps)) + bias.

    Train mode (`module.train()`) normalises with the batch mean and the
    biased variance E[x^2] - E[x]^2 clamped at 0 (flax's fast variance) over
    (B, L), with gradients through both, and moves the running buffers
    `mean` and `var` as running = momentum * running + (1 - momentum) * batch,
    the biased variance included. Eval mode uses the running buffers.
    """

    def __init__(self, n_chan: int, eps: float = 1e-3, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(n_chan))
        self.bias = nn.Parameter(torch.zeros(n_chan))
        self.register_buffer("mean", torch.zeros(n_chan))
        self.register_buffer("var", torch.ones(n_chan))

    def init_params(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(dim=(0, 2))
            var = ((x * x).mean(dim=(0, 2)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(mean.detach(), alpha=1.0 - self.momentum)
                self.var.mul_(self.momentum).add_(var.detach(), alpha=1.0 - self.momentum)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean[:, None]) * mul[:, None] + self.bias[:, None]


def _norm(norm: Optional[str], n_chan: int, eps: float) -> nn.Module:
    if norm in (None, "identity"):
        return nn.Identity()
    if norm == "batch":
        return BatchNorm(n_chan, eps)
    raise ValueError(f"Unknown norm={norm}")


def _depthwise(n_chan: int, kernel_size: int) -> nn.Conv1d:
    return nn.Conv1d(n_chan, n_chan, kernel_size, padding=kernel_size // 2, groups=n_chan)


class DepthSepConv(nn.Module):
    """Depthwise conv (SAME padding) then pointwise 1x1, channel-first."""

    def __init__(self, in_chan: int, out_chan: int, kernel_size: int):
        super().__init__()
        self.depthwise = _depthwise(in_chan, kernel_size)
        self.pointwise = nn.Conv1d(in_chan, out_chan, 1)
        self.init_params()

    def init_params(self, generator=None) -> None:
        winit.init_conv(self.depthwise, winit.kaiming_normal_fanout, generator)
        winit.init_conv(self.pointwise, winit.kaiming_normal_fanout, generator)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class ResConvBlock(nn.Module):
    """Pre-activation residual depthwise-separable block, channel-first
    [B,C,L]; the residual joins before the last pointwise conv."""

    def __init__(self, in_chan: int, out_chan: int, kernel_size: int = 5,
                 norm: Optional[str] = None, n_conv_layers: int = 1, norm_eps: float = 1e-3):
        super().__init__()
        if n_conv_layers not in (1, 2):
            raise ValueError("n_conv_layers must be 1 or 2")
        if kernel_size % 2 == 0:
            raise ValueError(f"kernel_size={kernel_size} must be odd")
        self.n_conv_layers = n_conv_layers
        if n_conv_layers == 2:
            self.norm1 = _norm(norm, in_chan, norm_eps)
            self.conv1 = DepthSepConv(in_chan, in_chan, kernel_size)
        self.norm2 = _norm(norm, in_chan, norm_eps)
        self.conv2_depthwise = _depthwise(in_chan, kernel_size)
        self.conv2_pointwise = nn.Conv1d(in_chan, out_chan, 1)
        self.init_params()

    def init_params(self, generator=None) -> None:
        winit.init_conv(self.conv2_depthwise, winit.kaiming_normal_fanout, generator)
        winit.init_conv(self.conv2_pointwise, winit.kaiming_normal_fanout, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        if self.n_conv_layers == 2:
            out = self.conv1(torch.relu(self.norm1(out)))
        out = self.conv2_depthwise(torch.relu(self.norm2(out)))
        return self.conv2_pointwise(out + x)


class CNN(nn.Module):
    """Stack of `ResConvBlock`s named block_0..block_{n-1}; takes and returns
    channel-last [B, L, C]."""

    def __init__(self, n_channels: int, n_blocks: int = 3, kernel_size: int = 5,
                 norm: Optional[str] = None, n_conv_layers: int = 1, norm_eps: float = 1e-3):
        super().__init__()
        self.n_blocks = n_blocks
        for i in range(n_blocks):
            self.add_module(f"block_{i}", ResConvBlock(
                n_channels, n_channels, kernel_size, norm, n_conv_layers, norm_eps))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x)
        return x.transpose(1, 2)
