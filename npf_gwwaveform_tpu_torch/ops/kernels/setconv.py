"""K1: the fused ExpRBF SetConv forward (`csrc/setconv_fwd.cu`) and its plain
PyTorch version.

Counterpart of `npf_gwwaveform_tpu/ops/pallas/setconv_kernel.py`
(`setconv_exprbf_pallas`): distances are `|k - q|` as in the Pallas kernel, a
masked max-subtracted softmax weights the values, and the density channel is
the raw exp sum. An empty context gives zero signal and zero density.
"""

from __future__ import annotations

import torch

from ... import _build
from ._checks import ptr, require_cuda_f32, require_shape

NEG = -1e30  # logit of a masked key, as in the Pallas kernel
MAX_CHANNELS = 512  # (64 + 32) * C floats of shared memory per block


def setconv_exprbf_plain(keys, queries, values, mask, sigma, p: int = 2):
    """keys [B,K], queries [B,Q], values [B,K,C], mask [B,K] (1.0 = real key),
    sigma [1] -> (signal [B,Q,C], density [B,Q]); materialises [B,Q,K]."""
    dist = (keys[:, None, :] - queries[:, :, None]).abs()
    inp = -((dist / sigma) ** p)
    msk = mask[:, None, :] > 0.5
    neg = torch.where(msk, inp, torch.full_like(inp, NEG))
    m = neg.amax(dim=-1, keepdim=True)
    unnorm = torch.exp(neg - m) * msk
    w = unnorm / unnorm.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    signal = torch.bmm(w, values)
    density = (torch.exp(inp) * msk).sum(dim=-1)
    return signal, density


def setconv_exprbf_fwd(keys, queries, values, mask, sigma, p: int = 2):
    """Same contract as `setconv_exprbf_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel (float32, contiguous, C <= 512,
    any K) or raise."""
    if keys.device.type == "cpu":
        return setconv_exprbf_plain(keys, queries, values, mask, sigma, p)
    name = "setconv_exprbf_fwd"
    require_cuda_f32(name, keys=keys, queries=queries, values=values, mask=mask, sigma=sigma)
    B, K = keys.shape
    Q, C = queries.shape[1], values.shape[-1]
    require_shape(name, "queries", queries, (B, Q))
    require_shape(name, "values", values, (B, K, C))
    require_shape(name, "mask", mask, (B, K))
    require_shape(name, "sigma", sigma, (1,))
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"{name}: {C} value channels, the kernel takes 1..{MAX_CHANNELS}")
    signal = torch.empty((B, Q, C), device=keys.device, dtype=torch.float32)
    density = torch.empty((B, Q), device=keys.device, dtype=torch.float32)
    if B == 0 or Q == 0:
        return signal, density
    if K == 0:
        return signal.zero_(), density.zero_()
    stream = torch.cuda.current_stream().cuda_stream
    err = _build.lib().npf_setconv_fwd(
        ptr(keys), ptr(queries), ptr(values), ptr(mask), ptr(sigma),
        B, K, Q, C, int(p), ptr(signal), ptr(density), stream,
    )
    _build.check(err, name)
    setconv_exprbf_fwd.launches += 1
    return signal, density


setconv_exprbf_fwd.launches = 0
