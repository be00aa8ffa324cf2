"""Depthwise-separable residual CNNs over the induced grid; the counterpart of
`npf_gwwaveform_tpu/ops/cnn.py` (`ResConvBlock`, `CNN` with per-block
dilations, `UnetCNN`, flax `BatchNorm`).

The JAX package is channel-last; `CNN` and `UnetCNN` keep that at their
interface and run their blocks channel-first, the layout of
`torch.nn.functional.conv1d`. The convolutions and the max-pool are stock
PyTorch, as the JAX package leaves them to XLA; the linear upsampling is
written out in elementwise ops (`upsample2_linear`).

`dtype` is the JAX modules' compute dtype: with bfloat16 every convolution
runs as flax's `nn.Conv(dtype=bfloat16)` (`conv`), while `BatchNorm`, which
has no dtype in JAX, normalises in float32 and returns float32, the dtype
flax promotes a bf16 input and float32 parameters to.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import init as winit


def conv(layer: nn.Conv1d, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """`layer(x)` as flax's `nn.Conv(dtype=dtype)` computes it. None: the
    float32 layer as it is. Otherwise x, the kernel and the bias are cast to
    `dtype`, the convolution is rounded to it and the bias added in it, two
    roundings as in flax."""
    if dtype is None:
        return layer(x)
    y = F.conv1d(x.to(dtype), layer.weight.to(dtype), None, layer.stride, layer.padding,
                 layer.dilation, layer.groups)
    return y if layer.bias is None else y + layer.bias.to(dtype)[:, None]


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
        x = x.float()
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


def _depthwise(n_chan: int, kernel_size: int, dilation: int = 1) -> nn.Conv1d:
    """SAME padding for an odd kernel: dilation * (k // 2) on each side."""
    return nn.Conv1d(n_chan, n_chan, kernel_size, padding=dilation * (kernel_size // 2),
                     dilation=dilation, groups=n_chan)


class DepthSepConv(nn.Module):
    """Depthwise conv (SAME padding, dilated by `dilation`) then pointwise
    1x1, channel-first."""

    def __init__(self, in_chan: int, out_chan: int, kernel_size: int,
                 dtype: Optional[torch.dtype] = None, dilation: int = 1):
        super().__init__()
        self.dtype = dtype
        self.depthwise = _depthwise(in_chan, kernel_size, dilation)
        self.pointwise = nn.Conv1d(in_chan, out_chan, 1)
        self.init_params()

    def init_params(self, generator=None) -> None:
        winit.init_conv(self.depthwise, winit.kaiming_normal_fanout, generator)
        winit.init_conv(self.pointwise, winit.kaiming_normal_fanout, generator)

    def forward(self, x):
        return conv(self.pointwise, conv(self.depthwise, x, self.dtype), self.dtype)


class ResConvBlock(nn.Module):
    """Pre-activation residual depthwise-separable block, channel-first
    [B,C,L]; the residual joins before the last pointwise conv, so the block
    can change the channel count. Its depthwise convs are dilated by
    `dilation`."""

    def __init__(self, in_chan: int, out_chan: int, kernel_size: int = 5,
                 norm: Optional[str] = None, n_conv_layers: int = 1, norm_eps: float = 1e-3,
                 dtype: Optional[torch.dtype] = None, dilation: int = 1):
        super().__init__()
        if n_conv_layers not in (1, 2):
            raise ValueError("n_conv_layers must be 1 or 2")
        if kernel_size % 2 == 0:
            raise ValueError(f"kernel_size={kernel_size} must be odd")
        self.n_conv_layers = n_conv_layers
        self.dtype = dtype
        if n_conv_layers == 2:
            self.norm1 = _norm(norm, in_chan, norm_eps)
            self.conv1 = DepthSepConv(in_chan, in_chan, kernel_size, dtype, dilation)
        self.norm2 = _norm(norm, in_chan, norm_eps)
        self.conv2_depthwise = _depthwise(in_chan, kernel_size, dilation)
        self.conv2_pointwise = nn.Conv1d(in_chan, out_chan, 1)
        self.init_params()

    def init_params(self, generator=None) -> None:
        winit.init_conv(self.conv2_depthwise, winit.kaiming_normal_fanout, generator)
        winit.init_conv(self.conv2_pointwise, winit.kaiming_normal_fanout, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        if self.n_conv_layers == 2:
            out = self.conv1(torch.relu(self.norm1(out)))
        out = conv(self.conv2_depthwise, torch.relu(self.norm2(out)), self.dtype)
        return conv(self.conv2_pointwise, out + x, self.dtype)


class CNN(nn.Module):
    """Stack of `ResConvBlock`s named block_0..block_{n-1}; takes and returns
    channel-last [B, L, C]. `dilations` gives each block's dilation (None:
    all 1), one per block."""

    def __init__(self, n_channels: int, n_blocks: int = 3, kernel_size: int = 5,
                 norm: Optional[str] = None, n_conv_layers: int = 1, norm_eps: float = 1e-3,
                 dtype: Optional[torch.dtype] = None, dilations: Optional[Sequence[int]] = None):
        super().__init__()
        if dilations is not None and len(dilations) != n_blocks:
            raise ValueError(f"dilations {tuple(dilations)} must have n_blocks={n_blocks} entries")
        self.n_blocks = n_blocks
        for i in range(n_blocks):
            self.add_module(f"block_{i}", ResConvBlock(
                n_channels, n_channels, kernel_size, norm, n_conv_layers, norm_eps, dtype,
                1 if dilations is None else int(dilations[i])))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x)
        return x.transpose(1, 2)


def upsample2_linear(x: torch.Tensor) -> torch.Tensor:
    """[..., L] -> [..., 2L]: `jax.image.resize(method="linear")` to twice
    the length, which is `F.interpolate(mode="linear", align_corners=False)`:
    output 2i is 0.25 x[i-1] + 0.75 x[i], output 2i+1 is 0.75 x[i] + 0.25
    x[i+1], and each edge output is its edge input (JAX renormalises the
    triangle kernel there). The sums run in float32 and round once to x's
    dtype, as JAX's resize does in bf16 (it casts the weights, 0.25 and 0.75
    exactly, to the array's dtype and contracts with an f32-accumulating
    einsum). Unlike `F.interpolate`, whose CUDA backward accumulates with
    atomic adds in no fixed order, these slices and sums have a
    deterministic backward, so a captured train step replays the eager one
    bit for bit."""
    xf = x.float()
    lo, hi = xf[..., :-1], xf[..., 1:]
    even = torch.cat([xf[..., :1], 0.25 * lo + 0.75 * hi], dim=-1)
    odd = torch.cat([0.75 * lo + 0.25 * hi, xf[..., -1:]], dim=-1)
    return torch.stack([even, odd], dim=-1).flatten(-2).to(x.dtype)


class UnetCNN(nn.Module):
    """U-Net of `ResConvBlock`s named block_0..block_{n-1} over a 1-D grid
    (`npf_gwwaveform_tpu/ops/cnn.py::UnetCNN`); takes and returns
    channel-last [B, L, C].

    The n // 2 down blocks each double the channels, capped at
    `max_nchannels`, and are followed by a max-pool of window and stride
    `pooling_size` (VALID); a bottleneck block; then each up block takes
    the input upsampled linearly to `pooling_size` times its length,
    concatenated with the output of its down block, the last up block
    pairing with the first down block. The upsampling is
    `jax.image.resize(method="linear")`'s (`upsample2_linear`), so the
    pooling size is 2, the JAX factory's.
    """

    def __init__(self, n_channels: int, n_blocks: int = 5, kernel_size: int = 5,
                 norm: Optional[str] = None, n_conv_layers: int = 1, norm_eps: float = 1e-3,
                 max_nchannels: int = 256, pooling_size: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if n_blocks % 2 != 1:
            raise ValueError(f"n_blocks={n_blocks} must be odd")
        if pooling_size != 2:
            raise ValueError(f"pooling_size={pooling_size}: the port upsamples by 2 only")
        self.n_blocks, self.n_down, self.pooling_size = n_blocks, n_blocks // 2, pooling_size
        chans = [2 ** i * n_channels for i in range(self.n_down + 1)]
        chans = chans + chans[::-1]
        chans = chans[:1] + [min(c, max_nchannels) for c in chans[1:-1]] + chans[-1:]
        for i, (c_in, c_out) in enumerate(zip(chans, chans[1:])):
            if i > self.n_down:  # an up block also takes its down block's output
                c_in += chans[2 * self.n_down - i + 1]
            self.add_module(f"block_{i}", ResConvBlock(
                c_in, c_out, kernel_size, norm, n_conv_layers, norm_eps, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)
        block = lambda i, h: getattr(self, f"block_{i}")(h)  # noqa: E731
        residuals = []
        for i in range(self.n_down):
            x = block(i, x)
            residuals.append(x)
            x = F.max_pool1d(x, self.pooling_size, self.pooling_size)
        x = block(self.n_down, x)
        for i in range(self.n_down + 1, self.n_blocks):
            x = block(i, torch.cat([upsample2_linear(x), residuals[self.n_down - i]], dim=1))
        return x.transpose(1, 2)
