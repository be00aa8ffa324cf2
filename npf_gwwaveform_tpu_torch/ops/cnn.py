"""Depthwise-separable residual CNNs over the induced grid; the counterpart of
`npf_gwwaveform_tpu/ops/cnn.py` (`ResConvBlock`, `DepthSepConv`, `CNN` with
per-block dilations, `UnetCNN`, flax `BatchNorm`, `AbsConv`,
`GaussianConv2d`, `ResNormalizedConvBlock`).

The JAX package is channel-last; `CNN`, `UnetCNN`, `AbsConv` and
`GaussianConv2d` keep that at their interface and run channel-first inside,
the layout of `torch.nn.functional.conv1d` and `conv2d`: the blocks
(`ResConvBlock`, `DepthSepConv`, `ResNormalizedConvBlock`) take and return
[B, C, *spatial]. `n_spatial` (1 or 2) is the grid's rank, which flax reads
from the input and a torch module fixes when it is built. `padding` is
flax's "SAME" (zeros, k // 2 on each side of an odd kernel) or "CIRCULAR"
(the grid wrapped around, `padding_mode="circular"`). The convolutions and
the max-pool are stock PyTorch, as the JAX package leaves them to XLA; the
linear upsampling is written out in elementwise ops (`upsample2_linear`).

`dtype` is the JAX modules' compute dtype: with bfloat16 every convolution
runs as flax's `nn.Conv(dtype=bfloat16)` (`conv`), while `BatchNorm`, which
has no dtype in JAX, normalises in float32 and returns float32, the dtype
flax promotes a bf16 input and float32 parameters to.

A 2-D grid goes into its blocks (and the AbsConv) as a contiguous NCHW
tensor, not as the channels-last view the transpose gives: for a
depthwise conv in float32 PyTorch then takes its own depthwise kernel,
where a channels-last input goes to cuDNN, 6-15 times slower forward and
backward at the image shapes (`profile_conv.py`, PERF.md section 6). The
1-D grid keeps its layout.

`CNN(remat=True)` recomputes each block in the backward pass
(`torch.utils.checkpoint`, JAX's `nn.remat`); BatchNorm moves its running
statistics in the forward pass only, not again in the recomputation. The
recomputation runs under the mesh the forward ran under: on CUDA it runs on
the autograd engine's device thread, whose context holds no mesh, and a
BatchNorm there would otherwise normalise with this rank's statistics.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import data_mean
from ..parallel.mesh import active_mesh, use_mesh
from ..utils import init as winit

_CONVS = {1: nn.Conv1d, 2: nn.Conv2d}
_CONV_FNS = {1: F.conv1d, 2: F.conv2d}
_PADDING_MODES = {"SAME": "zeros", "CIRCULAR": "circular"}
_recomputing = False  # inside a remat block's recomputation


@contextlib.contextmanager
def _recomputation(mesh):
    """A remat block's recomputation, under the `mesh` its forward ran under."""
    global _recomputing
    saved, _recomputing = _recomputing, True
    try:
        with use_mesh(mesh):
            yield
    finally:
        _recomputing = saved


def _conv_cls(n_spatial: int):
    if n_spatial not in _CONVS:
        raise ValueError(f"n_spatial={n_spatial}: 1 or 2")
    return _CONVS[n_spatial]


def _padding_mode(padding: str) -> str:
    if padding not in _PADDING_MODES:
        raise ValueError(f"padding={padding!r}: 'SAME' or 'CIRCULAR'")
    return _PADDING_MODES[padding]


def _channel_shape(x: torch.Tensor) -> tuple:
    """The shape that broadcasts a per-channel vector over channel-first x."""
    return (-1,) + (1,) * (x.dim() - 2)


def _channel_first(x: torch.Tensor, n_spatial: int) -> torch.Tensor:
    """Channel-last [B, *spatial, C] -> channel-first [B, C, *spatial]:
    the transposed view on a 1-D grid, a contiguous copy on a 2-D one (see
    the module docstring)."""
    x = x.movedim(-1, 1)
    return x.contiguous() if n_spatial == 2 else x


def conv(layer: nn.Module, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """`layer(x)` (a Conv1d or Conv2d) as flax's `nn.Conv(dtype=dtype)`
    computes it. None: the float32 layer as it is. Otherwise x, the kernel
    and the bias are cast to `dtype`, the convolution is rounded to it and
    the bias added in it, two roundings as in flax."""
    if dtype is None:
        return layer(x)
    y = layer._conv_forward(x.to(dtype), layer.weight.to(dtype), None)
    return y if layer.bias is None else y + layer.bias.to(dtype).view(_channel_shape(y))


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=eps)` over channel-first
    [B, C, *spatial], in flax's order: (x - mean) * (scale * rsqrt(var +
    eps)) + bias.

    Train mode (`module.train()`) normalises with the batch mean and the
    biased variance E[x^2] - E[x]^2 clamped at 0 (flax's fast variance) over
    every axis but the channel's (under a mesh step, `parallel.use_mesh`,
    over the data axis' global batch: the ranks' means averaged, so that
    every rank normalises and moves its buffers alike), with gradients
    through both, and moves the running buffers `mean` and `var` as
    running = momentum * running + (1 - momentum) * batch, the biased
    variance included. Eval mode uses the running buffers.
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
            dims = (0,) + tuple(range(2, x.dim()))
            mean, sq = x.mean(dim=dims), (x * x).mean(dim=dims)
            mesh = active_mesh()
            if mesh is not None:  # the statistics of the data axis' global batch
                mean, sq = data_mean(mean, sq, mesh=mesh)
            var = (sq - mean * mean).clamp_min(0.0)
            if not _recomputing:
                with torch.no_grad():
                    self.mean.mul_(self.momentum).add_(mean.detach(), alpha=1.0 - self.momentum)
                    self.var.mul_(self.momentum).add_(var.detach(), alpha=1.0 - self.momentum)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        shape = _channel_shape(x)
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


def _norm(norm: Optional[str], n_chan: int, eps: float) -> nn.Module:
    if norm in (None, "identity"):
        return nn.Identity()
    if norm == "batch":
        return BatchNorm(n_chan, eps)
    raise ValueError(f"Unknown norm={norm}")


def _depthwise(n_chan: int, kernel_size: int, dilation: int = 1, n_spatial: int = 1,
               padding: str = "SAME") -> nn.Module:
    """An odd kernel padded by dilation * (k // 2) on each side of each
    spatial axis, with zeros ("SAME") or the wrapped grid ("CIRCULAR")."""
    return _conv_cls(n_spatial)(n_chan, n_chan, kernel_size,
                                padding=dilation * (kernel_size // 2), dilation=dilation,
                                groups=n_chan, padding_mode=_padding_mode(padding))


class DepthSepConv(nn.Module):
    """Depthwise conv (`padding`, dilated by `dilation`) then pointwise
    1x1, channel-first."""

    def __init__(self, in_chan: int, out_chan: int, kernel_size: int,
                 dtype: Optional[torch.dtype] = None, dilation: int = 1, n_spatial: int = 1,
                 padding: str = "SAME"):
        super().__init__()
        self.dtype = dtype
        self.depthwise = _depthwise(in_chan, kernel_size, dilation, n_spatial, padding)
        self.pointwise = _conv_cls(n_spatial)(in_chan, out_chan, 1)
        self.init_params()

    def init_params(self, generator=None) -> None:
        winit.init_conv(self.depthwise, winit.kaiming_normal_fanout, generator)
        winit.init_conv(self.pointwise, winit.kaiming_normal_fanout, generator)

    def forward(self, x):
        return conv(self.pointwise, conv(self.depthwise, x, self.dtype), self.dtype)


class ResConvBlock(nn.Module):
    """Pre-activation residual depthwise-separable block, channel-first
    [B, C, *spatial]; the residual joins before the last pointwise conv, so
    the block can change the channel count. Its depthwise convs are dilated
    by `dilation` and padded as `padding` says."""

    def __init__(self, in_chan: int, out_chan: int, kernel_size: int = 5,
                 norm: Optional[str] = None, n_conv_layers: int = 1, norm_eps: float = 1e-3,
                 dtype: Optional[torch.dtype] = None, dilation: int = 1, n_spatial: int = 1,
                 padding: str = "SAME"):
        super().__init__()
        if n_conv_layers not in (1, 2):
            raise ValueError("n_conv_layers must be 1 or 2")
        if kernel_size % 2 == 0:
            raise ValueError(f"kernel_size={kernel_size} must be odd")
        self.n_conv_layers = n_conv_layers
        self.dtype = dtype
        if n_conv_layers == 2:
            self.norm1 = _norm(norm, in_chan, norm_eps)
            self.conv1 = DepthSepConv(in_chan, in_chan, kernel_size, dtype, dilation, n_spatial,
                                      padding)
        self.norm2 = _norm(norm, in_chan, norm_eps)
        self.conv2_depthwise = _depthwise(in_chan, kernel_size, dilation, n_spatial, padding)
        self.conv2_pointwise = _conv_cls(n_spatial)(in_chan, out_chan, 1)
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
    channel-last [B, *spatial, C] of `n_spatial` spatial axes. `dilations`
    gives each block's dilation (None: all 1), one per block; `remat`
    recomputes each block in the backward pass of a train-mode call."""

    def __init__(self, n_channels: int, n_blocks: int = 3, kernel_size: int = 5,
                 norm: Optional[str] = None, n_conv_layers: int = 1, norm_eps: float = 1e-3,
                 dtype: Optional[torch.dtype] = None, dilations: Optional[Sequence[int]] = None,
                 n_spatial: int = 1, padding: str = "SAME", remat: bool = False):
        super().__init__()
        if dilations is not None and len(dilations) != n_blocks:
            raise ValueError(f"dilations {tuple(dilations)} must have n_blocks={n_blocks} entries")
        self.n_blocks = n_blocks
        self.remat = remat
        self.n_spatial = n_spatial
        for i in range(n_blocks):
            self.add_module(f"block_{i}", ResConvBlock(
                n_channels, n_channels, kernel_size, norm, n_conv_layers, norm_eps, dtype,
                1 if dilations is None else int(dilations[i]), n_spatial, padding))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _channel_first(x, self.n_spatial)
        remat = self.remat and self.training and torch.is_grad_enabled()
        mesh = active_mesh()
        for i in range(self.n_blocks):
            block = getattr(self, f"block_{i}")
            if remat:
                x = checkpoint(block, x, use_reentrant=False,
                               context_fn=lambda: (contextlib.nullcontext(), _recomputation(mesh)))
            else:
                x = block(x)
        return x.movedim(1, -1)


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


class AbsConv(nn.Module):
    """Depthwise conv with |weights| and no bias, a nonnegative smoothing
    kernel used as a density estimator (GridConvCNP's context embedding);
    channel-last [B, *spatial, C] in and out. `weight` [C, 1, *k] stands for
    flax's kernel [*k, 1, C]. "CIRCULAR" wraps the grid by k // 2 on each
    side and convolves VALID (`jnp.pad(mode="wrap")` in JAX), "SAME" pads
    with zeros."""

    def __init__(self, in_chan: int, kernel_size: int = 11, padding: str = "SAME",
                 n_spatial: int = 2):
        super().__init__()
        _conv_cls(n_spatial)
        _padding_mode(padding)
        self.kernel_size, self.padding, self.n_spatial = kernel_size, padding, n_spatial
        self.weight = nn.Parameter(torch.empty((in_chan, 1) + (kernel_size,) * n_spatial))
        self.init_params()

    def init_params(self, generator=None) -> None:
        winit.init_conv(self, winit.kaiming_normal_fanout, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _channel_first(x, self.n_spatial)
        p = self.kernel_size // 2
        if self.padding == "CIRCULAR":
            x, p = F.pad(x, (p, p) * self.n_spatial, mode="circular"), 0
        y = _CONV_FNS[self.n_spatial](x, self.weight.abs().to(x.dtype), None, 1, p, 1,
                                      x.shape[1])
        return y.movedim(1, -1)


class GaussianConv2d(nn.Module):
    """A learned separable Gaussian blur, depthwise over channel-last [B, H,
    W, C] with zero padding: the outer product of softmax(-(i - k//2)^2 *
    weights_x) and the same with weights_y (both start at one)."""

    def __init__(self, kernel_size: int = 5):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f"kernel_size={kernel_size} must be odd")
        self.kernel_size = kernel_size
        self.weights_x = nn.Parameter(torch.ones(1))
        self.weights_y = nn.Parameter(torch.ones(1))

    def init_params(self, generator=None) -> None:
        with torch.no_grad():
            self.weights_x.fill_(1.0)
            self.weights_y.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = self.kernel_size // 2
        i = torch.arange(self.kernel_size, dtype=torch.float32, device=x.device)
        exponent = -((i - half) ** 2)
        mx = torch.softmax(exponent * self.weights_x, dim=0)
        my = torch.softmax(exponent * self.weights_y, dim=0)
        c = x.shape[-1]
        kernel = torch.outer(mx, my)[None, None].expand(c, 1, -1, -1)
        y = F.conv2d(x.movedim(-1, 1), kernel, None, 1, half, 1, c)
        return y.movedim(1, -1)


class ResNormalizedConvBlock(nn.Module):
    """Residual block of normalized convolutions (Knutsson & Westin 1993),
    channel-first [B, 2C, *spatial]: the first C channels are a signal, the
    last C its confidence, clipped to [0, 1]. The signal times the
    confidence goes through relu, `conv1` (depthwise-separable), relu and
    `conv2_depthwise`; the confidence through `conv1` and `conv2_depthwise`
    alone gives the density, by which the signal is divided (at least
    1e-5). The confidence grows by sigmoid(density * softplus(temperature)
    + bias), at most to 1; the signal (plus the masked input) and the
    confidence each go through `conv2_pointwise` -> [B, 2 out_chan, ...].
    No normalization layers, as in JAX."""

    def __init__(self, in_chan: int, out_chan: int, kernel_size: int = 5, n_spatial: int = 1,
                 padding: str = "SAME"):
        super().__init__()
        if kernel_size % 2 == 0:
            raise ValueError(f"kernel_size={kernel_size} must be odd")
        self.conv1 = DepthSepConv(in_chan, in_chan, kernel_size, n_spatial=n_spatial,
                                  padding=padding)
        self.conv2_depthwise = _depthwise(in_chan, kernel_size, 1, n_spatial, padding)
        self.conv2_pointwise = _conv_cls(n_spatial)(in_chan, out_chan, 1)
        self.temperature = nn.Parameter(torch.zeros(1))
        self.bias = nn.Parameter(torch.zeros(1))
        self.init_params()

    def init_params(self, generator=None) -> None:
        winit.init_conv(self.conv2_depthwise, winit.kaiming_normal_fanout, generator)
        winit.init_conv(self.conv2_pointwise, winit.kaiming_normal_fanout, generator)
        with torch.no_grad():
            self.temperature.uniform_(-0.05, 0.05, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        signal, conf_1 = x.chunk(2, dim=1)
        conf_1 = conf_1.clamp(0.0, 1.0)
        x_s = signal * conf_1
        numerator = self.conv2_depthwise(torch.relu(self.conv1(torch.relu(x_s))))
        density = self.conv2_depthwise(self.conv1(conf_1))
        out = numerator / density.clamp_min(1e-5)
        conf_2 = conf_1 + torch.sigmoid(density * F.softplus(self.temperature) + self.bias)
        conf_2 = conf_2.clamp_max(1.0)
        out = self.conv2_pointwise(out + x_s)
        return torch.cat([out, self.conv2_pointwise(conf_2)], dim=1)
