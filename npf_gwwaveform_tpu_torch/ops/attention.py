"""Attention with masked padded sets, the counterpart of
`npf_gwwaveform_tpu/ops/attention.py`: `DotAttender` (3-D keys, or 4-D
keys [B, Q, K, D], one key set a query, for relative positions),
`MultiplicativeAttender`, `AdditiveAttender`, `CosineAttender`,
`DistanceAttender` (p 1, 2 or general, optionally on weighted differences),
`MultiheadAttender`, `TransformerAttender` and `get_attender` with JAX's
ten names.

Every attender maps (keys [B, K, kq_size], queries [B, Q, kq_size], values
[B, K, value_size], mask_keys [B, K] bool or None) to [B, Q, out_size].
The weights are `masked_softmax` of float32 logits, with no gradient
through the subtracted max (JAX's `masked_softmax`), followed by a
product with the values: a padded key gets zero weight, and a query with
no key at all (an empty context) gets the zero representation and zero
gradients, as in JAX. `F.scaled_dot_product_attention` would give NaN on
such a row, so none is used. Where the values' width is not `out_size`
the result passes a linear `resizer` (xavier, switchable).

`dtype` is the JAX attender's compute dtype: with bfloat16 every linear
layer (`linear`, `weighter`, `resizer`, the multihead transforms and
`post_processor`) is flax's `Dense(dtype=bfloat16)` (`dense`), the logits
are cast to float32 for the masked softmax and the weights back to the
values' dtype, as in JAX. The additive attender's tanh MLP and the
transformer block's ReLU MLP and LayerNorms have no dtype in JAX: they
compute in the dtype flax promotes their input to with their float32
parameters, float32, and the transformer block returns float32.

The modules carry flax's parameter names: `linear`, `mlp`, `weighter`,
`resizer`, `key_transform`, `query_transform`, `value_transform`,
`post_processor`, `multihead`, `layer_norm1`, `layer_norm2`. Their
initial values follow JAX's: the multihead transforms N(0, sqrt(2 / (size
+ head size))) in either init scheme, the query bias zero; the others
switchable kaiming-relu (`linear`, `weighter`) or xavier (`resizer`,
`post_processor`); LayerNorm scale one and bias zero.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..utils import init as winit
from ..utils.helpers import masked_softmax
from .mlp import MLP, dense

__all__ = ["LayerNorm", "DotAttender", "MultiplicativeAttender", "AdditiveAttender",
           "CosineAttender", "DistanceAttender", "MultiheadAttender", "TransformerAttender",
           "get_attender", "ATTENDERS"]

# the names `get_attender` takes
ATTENDERS = ("multiplicative", "additive", "dot", "scaledot", "cosine", "manhattan", "euclidean",
             "weighted_dist", "multihead", "transformer")


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`jnp.einsum` of two operands in the dtype JAX promotes them to (a
    bf16 query against float32 relative-position keys: float32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _linear(in_f: int, out_f: int, init, bias: bool = True) -> nn.Linear:
    layer = nn.Linear(in_f, out_f, bias=bias)
    layer.kernel_init = init
    return layer


class _Attender(nn.Module):
    """Holds the linear layers of an attender with their init schemes
    (`kernel_init` on each) and the optional `resizer`."""

    def __init__(self, value_size: int, out_size: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        if value_size != out_size:
            self.resizer = _linear(value_size, out_size, winit.switchable(winit.xavier_uniform))

    def init_params(self, generator=None) -> None:
        for layer in self.children():
            if isinstance(layer, nn.Linear):
                winit.init_dense(layer, layer.kernel_init, generator)

    def _attend(self, logits, values, mask_keys, is_normalize=True):
        """logits [B, Q, K] x values [B, K, V] -> [B, Q, out_size]."""
        if mask_keys is None:
            mask_keys = torch.ones((logits.shape[0], logits.shape[2]), dtype=torch.bool,
                                   device=logits.device)
        mask = mask_keys[:, None, :]
        if is_normalize:
            attn = masked_softmax(logits.float(), mask.expand_as(logits), dim=-1,
                                  stop_max_grad=True)
        else:
            attn = torch.where(mask, logits, torch.zeros_like(logits))
        ctx = torch.einsum("bqk,bkv->bqv", attn.to(values.dtype), values)
        return dense(self.resizer, ctx, self.dtype) if hasattr(self, "resizer") else ctx


class DotAttender(_Attender):
    """(Scaled) dot-product attention; 4-D keys [B, Q, K, D] give each query
    its own keys."""

    def __init__(self, value_size: int, out_size: int, is_scale: bool = True,
                 is_normalize: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__(value_size, out_size, dtype)
        self.is_scale, self.is_normalize = is_scale, is_normalize

    def forward(self, keys, queries, values, mask_keys=None):
        if keys.dim() == 4:
            logits = _einsum("bqkd,bqd->bqk", keys, queries)
        else:
            logits = _einsum("bkd,bqd->bqk", keys, queries)
        if self.is_scale:
            logits = logits / math.sqrt(queries.shape[-1])
        return self._attend(logits, values, mask_keys, self.is_normalize)


class MultiplicativeAttender(_Attender):
    """Luong attention: keys against a bias-free linear map of the queries."""

    def __init__(self, kq_size: int, value_size: int, out_size: int, is_normalize: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(value_size, out_size, dtype)
        self.is_normalize = is_normalize
        self.linear = _linear(kq_size, kq_size, winit.switchable(winit.kaiming_uniform_relu),
                              bias=False)
        self.init_params()

    def forward(self, keys, queries, values, mask_keys=None):
        logits = torch.einsum("bkd,bqd->bqk", keys, dense(self.linear, queries, self.dtype))
        return self._attend(logits, values, mask_keys, self.is_normalize)


class AdditiveAttender(_Attender):
    """Bahdanau attention: a tanh MLP (one hidden layer of kq_size) of each
    (key, query) pair's concatenation."""

    def __init__(self, kq_size: int, value_size: int, out_size: int, is_normalize: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(value_size, out_size, dtype)
        self.is_normalize = is_normalize
        self.mlp = MLP(2 * kq_size, 1, hidden_size=kq_size, activation="tanh")
        self.init_params()

    def forward(self, keys, queries, values, mask_keys=None):
        B, Q, D = queries.shape
        K = keys.shape[1]
        pairs = torch.cat([keys[:, None, :, :].expand(B, Q, K, D),
                           queries[:, :, None, :].expand(B, Q, K, D)], dim=-1)
        return self._attend(self.mlp(pairs)[..., 0], values, mask_keys, self.is_normalize)


class CosineAttender(_Attender):
    """Cosine similarity of keys and queries (norms floored at 1e-8)."""

    def __init__(self, value_size: int, out_size: int, is_normalize: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(value_size, out_size, dtype)
        self.is_normalize = is_normalize

    def forward(self, keys, queries, values, mask_keys=None):
        k = keys / keys.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        q = queries / queries.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        return self._attend(torch.einsum("bkd,bqd->bqk", k, q), values, mask_keys,
                            self.is_normalize)


class DistanceAttender(_Attender):
    """Logits -||key - query||_p^2; with `is_weight` the differences first
    pass a linear `weighter`."""

    def __init__(self, kq_size: int, value_size: int, out_size: int, p: float = 1.0,
                 is_weight: bool = False, is_normalize: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(value_size, out_size, dtype)
        self.p, self.is_weight, self.is_normalize = p, is_weight, is_normalize
        if is_weight:
            self.weighter = _linear(kq_size, kq_size,
                                    winit.switchable(winit.kaiming_uniform_relu))
        self.init_params()

    def forward(self, keys, queries, values, mask_keys=None):
        diff = keys[:, None, :, :] - queries[:, :, None, :]
        if self.is_weight:
            diff = dense(self.weighter, diff, self.dtype)
        if self.p == 1:
            norm = diff.abs().sum(dim=-1)
        elif self.p == 2:
            norm = torch.sqrt(diff.square().sum(dim=-1) + 1e-12)
        else:
            norm = (diff.abs() ** self.p).sum(dim=-1) ** (1.0 / self.p)
        return self._attend(-(norm ** 2), values, mask_keys, self.is_normalize)


class MultiheadAttender(_Attender):
    """Multi-head scaled dot-product attention: bias-free key and value
    transforms, a query transform with a zero-initialised bias (none with
    `is_relative_pos`, where `rel_pos_enc` [B, Q, K, kq_size] is added to
    the keys), `n_heads` heads, then `post_processor` (xavier) with
    `is_post_process` or where value_size != out_size."""

    def __init__(self, kq_size: int, value_size: int, out_size: int, n_heads: int = 8,
                 is_post_process: bool = True, is_relative_pos: bool = False,
                 dtype: Optional[torch.dtype] = None):
        nn.Module.__init__(self)
        self.dtype = dtype
        if kq_size % n_heads or value_size % n_heads:
            raise ValueError(f"kq_size {kq_size} and value_size {value_size} must divide into "
                             f"{n_heads} heads")
        self.kq_size, self.value_size, self.out_size = kq_size, value_size, out_size
        self.n_heads, self.is_relative_pos = n_heads, is_relative_pos
        kq_std = math.sqrt(2.0 / (kq_size + kq_size // n_heads))
        v_std = math.sqrt(2.0 / (value_size + value_size // n_heads))
        self.key_transform = _linear(kq_size, kq_size, winit.normal_std(kq_std), bias=False)
        self.query_transform = _linear(kq_size, kq_size, winit.normal_std(kq_std),
                                       bias=not is_relative_pos)
        self.value_transform = _linear(value_size, value_size, winit.normal_std(v_std),
                                       bias=False)
        if is_post_process or value_size != out_size:
            self.post_processor = _linear(value_size, out_size,
                                          winit.switchable(winit.xavier_uniform))
        self.init_params()

    def forward(self, keys, queries, values, mask_keys=None, rel_pos_enc=None):
        h = self.n_heads
        k = dense(self.key_transform, keys, self.dtype)
        q = dense(self.query_transform, queries, self.dtype)
        v = dense(self.value_transform, values, self.dtype)
        B, K, Q = k.shape[0], k.shape[1], q.shape[1]
        q = q.reshape(B, Q, h, -1)
        v = v.reshape(B, K, h, -1)
        if self.is_relative_pos:
            k = (k[:, None, :, :] + rel_pos_enc).reshape(B, Q, K, h, -1)
            logits = _einsum("bqkhd,bqhd->bhqk", k, q)
        else:
            logits = torch.einsum("bkhd,bqhd->bhqk", k.reshape(B, K, h, -1), q)
        logits = logits / math.sqrt(self.kq_size // h)
        if mask_keys is None:
            mask = torch.ones((B, 1, 1, K), dtype=torch.bool, device=logits.device)
        else:
            mask = mask_keys[:, None, None, :]
        attn = masked_softmax(logits.float(), mask.expand_as(logits), dim=-1, stop_max_grad=True)
        ctx = torch.einsum("bhqk,bkhd->bqhd", attn.to(v.dtype), v).reshape(B, Q, self.value_size)
        if hasattr(self, "post_processor"):
            return dense(self.post_processor, ctx, self.dtype)
        return ctx


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm()` over the last axis: epsilon 1e-6, the variance
    E[x^2] - E[x]^2 clamped at 0 (flax's fast variance), then in flax's
    order (x - mean) * (rsqrt(var + eps) * scale) + bias. It has no dtype,
    as in JAX: a bf16 x is promoted to float32 with the parameters, and the
    result is float32. Its parameters keep flax's names, `scale` and
    `bias`."""

    def __init__(self, n_features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(n_features))
        self.bias = nn.Parameter(torch.zeros(n_features))

    def init_params(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, self.scale.dtype))
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp_min(x.square().mean(dim=-1, keepdim=True) - mean.square(), 0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


class TransformerAttender(nn.Module):
    """The image-transformer block: `multihead` (no post-processing),
    LayerNorm of it plus the queries, a ReLU MLP (one hidden layer of
    out_size), LayerNorm of the sum. Needs kq_size == out_size. As in JAX,
    its multihead attender takes no relative positions (`rel_pos_enc` is
    passed on and ignored), so relative self-attention takes "multihead".
    `dtype` reaches the multihead attender only (module docstring)."""

    def __init__(self, kq_size: int, value_size: int, out_size: int, n_heads: int = 8,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if kq_size != out_size:
            raise ValueError(f"TransformerAttender needs kq_size == out_size ({kq_size}, "
                             f"{out_size})")
        self.multihead = MultiheadAttender(kq_size, value_size, out_size, n_heads,
                                           is_post_process=False, dtype=dtype)
        self.layer_norm1 = LayerNorm(out_size)
        self.mlp = MLP(out_size, out_size, hidden_size=out_size)
        self.layer_norm2 = LayerNorm(out_size)

    def forward(self, keys, queries, values, mask_keys=None, rel_pos_enc=None):
        ctx = self.multihead(keys, queries, values, mask_keys=mask_keys, rel_pos_enc=rel_pos_enc)
        ctx = self.layer_norm1(ctx + queries)
        return self.layer_norm2(ctx + self.mlp(ctx))


def get_attender(attention: str, kq_size: int, value_size: int, out_size: int,
                 **kwargs) -> nn.Module:
    """The attender of one of JAX's ten names (`ATTENDERS`), for keys and
    queries of kq_size features and values of value_size."""
    name = attention.lower()
    if name == "multiplicative":
        return MultiplicativeAttender(kq_size, value_size, out_size, **kwargs)
    if name == "additive":
        return AdditiveAttender(kq_size, value_size, out_size, **kwargs)
    if name in ("dot", "scaledot"):
        return DotAttender(value_size, out_size, is_scale=name == "scaledot", **kwargs)
    if name == "cosine":
        return CosineAttender(value_size, out_size, **kwargs)
    if name in ("manhattan", "euclidean", "weighted_dist"):
        return DistanceAttender(kq_size, value_size, out_size, p=2 if name == "euclidean" else 1,
                                is_weight=name == "weighted_dist", **kwargs)
    if name == "multihead":
        return MultiheadAttender(kq_size, value_size, out_size, **kwargs)
    if name == "transformer":
        return TransformerAttender(kq_size, value_size, out_size, **kwargs)
    raise ValueError(f"Unknown attention method {attention}")
