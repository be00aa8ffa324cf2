"""Argument checks shared by the kernel wrappers: the kernels take float32,
contiguous tensors on the current CUDA device and nothing else, and are
reached where a gradient is needed only through their autograd Functions."""

from __future__ import annotations

import torch


def require_cuda_f32(name: str, **tensors) -> None:
    device = torch.device("cuda", torch.cuda.current_device())
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, the kernel runs on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def require_no_grad(name: str, **tensors) -> None:
    """A kernel's output has no grad_fn: refuse a call that needs one. Inside
    an autograd Function's forward and backward grad mode is off."""
    if not torch.is_grad_enabled():
        return
    needy = [arg for arg, t in tensors.items() if t is not None and t.requires_grad]
    if needy:
        raise RuntimeError(f"{name}: {', '.join(needy)} require grad; call the kernel through "
                           "its autograd Function, or under torch.no_grad()")


def require_shape(name: str, arg: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def ptr(t):
    return None if t is None else t.data_ptr()
