"""K1: the fused ExpRBF SetConv forward (`csrc/setconv_fwd.cu`) and its plain
PyTorch version.

Counterpart of `npf_gwwaveform_tpu/ops/pallas/setconv_kernel.py`
(`setconv_exprbf_pallas`): distances are `|k - q|` as in the Pallas kernel, a
masked max-subtracted softmax weights the values, and the density channel is
the raw exp sum. An empty context gives zero signal and zero density.

`SetConvExpRBFFn` is the only way the model reaches K1 where a gradient is
needed: its forward is K1, its backward `setconv_exprbf_bwd`. That backward
is the counterpart of the JAX package's `_core_bwd` (`setconv_kernel.py`), an
XLA recompute per query tile and not a Pallas kernel, so here it is stock
PyTorch: per tile of min(512, Q) queries it recomputes `_xla_tile`'s math and
differentiates it with `torch.autograd.grad`.
"""

from __future__ import annotations

import torch

from ... import _build
from ._checks import ptr, require_cuda_f32, require_no_grad, require_shape

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
    any K) or raise, also when a gradient is needed outside
    `SetConvExpRBFFn`."""
    if keys.device.type == "cpu":
        return setconv_exprbf_plain(keys, queries, values, mask, sigma, p)
    name = "setconv_exprbf_fwd"
    require_no_grad(name, keys=keys, queries=queries, values=values, sigma=sigma)
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


def _tile(keys, values, mask, sigma, p, queries):
    """`_xla_tile`'s math for one query tile: (signal [B,TQ,C], density [B,TQ])."""
    d = keys[:, None, :] - queries[:, :, None]
    # |d| whose derivative is +1 at d == 0, as JAX's abs (torch's abs gives 0)
    dist = d * torch.where(d >= 0, 1.0, -1.0)
    inp = -((dist / sigma) ** p)
    msk = mask[:, None, :] > 0.5
    neg = torch.where(msk, inp, NEG)
    m = neg.amax(dim=-1, keepdim=True).detach()  # JAX's stop_gradient
    unnorm = torch.exp(neg - m) * msk
    w = unnorm / unnorm.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.bmm(w, values), (torch.exp(inp) * msk).sum(dim=-1)


def setconv_exprbf_bwd(keys, queries, values, mask, sigma, g_signal, g_density, p: int = 2):
    """Gradients (keys, queries, values, sigma) of `setconv_exprbf_plain`'s
    two outputs against cotangents g_signal [B,Q,C] and g_density [B,Q],
    recomputed per tile of min(512, Q) queries so [B,Q,K] is never whole."""
    B, K = keys.shape
    Q = queries.shape[1]
    d_keys, d_queries = torch.zeros_like(keys), torch.zeros_like(queries)
    d_values, d_sigma = torch.zeros_like(values), torch.zeros_like(sigma)
    if B == 0 or K == 0 or Q == 0:
        return d_keys, d_queries, d_values, d_sigma
    tq = min(512, Q)
    # a named range, so a profile can attribute this stock-op backward
    with torch.profiler.record_function("setconv_exprbf_bwd"), torch.enable_grad():
        k, v, s = (t.detach().requires_grad_() for t in (keys, values, sigma))
        for q0 in range(0, Q, tq):
            q = queries[:, q0:q0 + tq].detach().requires_grad_()
            outs = _tile(k, v, mask, s, p, q)
            gk, gq, gv, gs = torch.autograd.grad(
                outs, (k, q, v, s), (g_signal[:, q0:q0 + tq], g_density[:, q0:q0 + tq]))
            d_keys += gk
            d_values += gv
            d_sigma += gs
            d_queries[:, q0:q0 + tq] = gq
    return d_keys, d_queries, d_values, d_sigma


class SetConvExpRBFFn(torch.autograd.Function):
    """(keys, queries, values, mask, sigma, p) -> (signal, density) through K1
    (its plain version on CPU tensors); backward `setconv_exprbf_bwd`. The
    mask gets no gradient."""

    @staticmethod
    def forward(ctx, keys, queries, values, mask, sigma, p):
        ctx.save_for_backward(keys, queries, values, mask, sigma)
        ctx.p = p
        return setconv_exprbf_fwd(keys, queries, values, mask, sigma, p)

    @staticmethod
    def backward(ctx, g_signal, g_density):
        keys, queries, values, mask, sigma = ctx.saved_tensors
        d_keys, d_queries, d_values, d_sigma = setconv_exprbf_bwd(
            keys, queries, values, mask, sigma, g_signal.contiguous(), g_density.contiguous(),
            ctx.p)
        return d_keys, d_queries, d_values, None, d_sigma, None
