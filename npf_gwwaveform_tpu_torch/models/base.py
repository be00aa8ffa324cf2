"""Forward skeleton of the neural-process family, the counterpart of
`npf_gwwaveform_tpu/models/base.py::NeuralProcessFamily`.

x-encode -> `encode_globally` -> (with `cond_mode="add"`, the condition
embedding added to every position of R) -> with a latent path
(`encoded_path` "latent" or "both") `latent_path` -> `trgt_dependent_representation`
-> `decode` into a diagonal Gaussian with scale `min_sigma_pred + (1 -
min_sigma_pred) * softplus`. Point sets are padded and carry boolean masks.

The latent path infers q(z|C) from R (`infer_latent_dist`: the latent
encoder MLP, then loc and a scale `min_lat_sigma + max_lat_sigma_ratio *
sigmoid`, or with `lat_scale_transform="softplus"` `min_lat_sigma + (1 -
min_lat_sigma) * softplus`), with `is_q_zCct` and targets given also
q(z|C,T) from the targets encoded the same way, and draws n_z samples from
q(z|C,T) where there is one, else from q(z|C): n_z_samples_train in train
mode, n_z_samples_test in eval mode. The noise comes from the `generator`
passed to `forward` (the state's or the scorer's), or is given as `eps`.
The deterministic family (n_z = 1) draws nothing.

`dtype` is the JAX model's compute dtype: None computes in float32;
bfloat16 runs every module in bf16 compute, as the JAX package's modules
with `dtype=jnp.bfloat16` do, while parameters, BatchNorm statistics,
log-probs and the loss stay float32. `decode` and `infer_latent_dist` then
apply their scale transforms to the bf16 raw scale in bf16 as JAX's ops
round it: softplus as `jax.nn.softplus` computes it (`logaddexp(x, 0)`,
each op rounded), sigmoid as XLA expands `jax.nn.sigmoid` (1 / (1 +
exp(-x)), each op rounded), the constants rounded to bf16 as JAX's
weak-typed scalars are; loc and scale are cast to float32 afterwards
(`npf_gwwaveform_tpu/models/base.py:266-312`). The draw `loc + scale * eps`
is float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..distributions import NormalDiag
from ..losses import NPFOutput
from ..ops.mlp import MLP


def _softplus_jax(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`'s ops, max(x, 0) + log1p(exp(-|x|)), each rounded in
    x's dtype (`F.softplus` computes log1p(exp(x)) and rounds once, which
    differs from JAX's in bf16 in about one element of eight)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _sigmoid_jax(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.sigmoid` in x's (reduced) dtype as XLA computes it on the
    CPU, 1 / (1 + exp(-x)) with each op rounded (`torch.sigmoid` rounds once
    and differs in about a third of bf16 elements); the gradient is
    `torch.sigmoid`'s, which stays finite where exp(-x) overflows."""
    s = torch.sigmoid(x)
    with torch.no_grad():
        ops = 1.0 / (1.0 + torch.exp(-x))
    return s + (ops - s).detach()


def _weak(values, dtype: torch.dtype):
    """Python scalars as JAX's weak-typed scalars meet an array of `dtype`:
    rounded to it."""
    if dtype == torch.float32:
        return tuple(values)
    return tuple(torch.tensor(v, dtype=dtype).item() for v in values)


class NeuralProcessFamily(nn.Module):
    """Subclasses set `self.decoder` and implement `encode_globally` and
    `trgt_dependent_representation`."""

    def __init__(self, x_dim: int = 1, y_dim: int = 1, r_dim: int = 128,
                 min_sigma_pred: float = 0.01, cond_dim: int = 0, use_kernels: bool = True,
                 dtype: Optional[torch.dtype] = None, cond_mode: str = "film",
                 encoded_path: str = "deterministic", is_q_zCct: bool = False,
                 n_z_samples_train: int = 32, n_z_samples_test: int = 32,
                 z_dim: Optional[int] = None, min_lat_sigma: float = 0.1,
                 max_lat_sigma_ratio: float = 0.9, lat_scale_transform: str = "sigmoid"):
        super().__init__()
        if encoded_path not in ("deterministic", "latent", "both"):
            raise ValueError(f"Unknown encoded_path={encoded_path}")
        if lat_scale_transform not in ("sigmoid", "softplus"):
            raise ValueError(f"lat_scale_transform={lat_scale_transform!r}: 'sigmoid' or "
                             "'softplus'")
        self.x_dim, self.y_dim, self.r_dim = x_dim, y_dim, r_dim
        self.min_sigma_pred = min_sigma_pred
        self.cond_dim = cond_dim
        self.cond_mode = cond_mode
        self.use_kernels = use_kernels
        self.dtype = dtype
        self.encoded_path = encoded_path
        self.is_q_zCct = is_q_zCct
        self.n_z_samples_train, self.n_z_samples_test = n_z_samples_train, n_z_samples_test
        self.z_dim = r_dim if z_dim is None else z_dim
        self.min_lat_sigma, self.max_lat_sigma_ratio = min_lat_sigma, max_lat_sigma_ratio
        self.lat_scale_transform = lat_scale_transform
        if cond_dim > 0:
            self.cond_encoder = MLP(cond_dim, r_dim, n_hidden_layers=1, hidden_size=r_dim,
                                    dtype=dtype)
        if self.has_latent:
            self.latent_encoder = MLP(r_dim, 2 * self.z_dim, n_hidden_layers=1,
                                      hidden_size=r_dim, dtype=dtype)

    @property
    def has_latent(self) -> bool:
        return self.encoded_path in ("latent", "both")

    def _sub_decoder(self, n_out: int) -> MLP:
        """The default decoder MLP: 4 hidden layers of width r_dim (kernel K2
        when `use_kernels`)."""
        return MLP(self.r_dim, n_out, n_hidden_layers=4, hidden_size=self.r_dim,
                   fused=self.use_kernels, dtype=self.dtype)

    def x_encoder(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def forward(self, x_cntxt, y_cntxt, x_trgt, mask_cntxt: Optional[torch.Tensor] = None,
                mask_trgt: Optional[torch.Tensor] = None,
                condition: Optional[torch.Tensor] = None,
                y_trgt: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None) -> NPFOutput:
        """x_* [B, N*, x_dim], y_cntxt [B, Nc, y_dim], masks [B, N*] bool,
        condition [B, cond_dim], y_trgt [B, Nt, y_dim] (read by a latent
        model with `is_q_zCct` only) -> NPFOutput with loc/scale [n_z, B, Nt,
        y_dim]. A latent model draws its noise from `generator` (on the
        inputs' device), or takes `eps` [n_z, B, *n_lat, z_dim]."""
        if mask_cntxt is None:
            mask_cntxt = torch.ones(x_cntxt.shape[:2], dtype=torch.bool, device=x_cntxt.device)
        if mask_trgt is None:
            mask_trgt = torch.ones(x_trgt.shape[:2], dtype=torch.bool, device=x_trgt.device)
        x_c, x_t = self.x_encoder(x_cntxt), self.x_encoder(x_trgt)
        cond_emb = None
        if self.cond_dim > 0:
            if condition is None:
                raise ValueError("cond_dim > 0 requires a `condition` input")
            cond_emb = self.cond_encoder(condition)
        R = self.encode_globally(x_c, y_cntxt, mask_cntxt, cond_emb=cond_emb)
        if cond_emb is not None and self.cond_mode == "add":  # broadcast over R's positions
            R = R + cond_emb.reshape(cond_emb.shape[0], *([1] * (R.dim() - 2)), cond_emb.shape[-1])
        z_samples = q_zCc = q_zCct = None
        if self.has_latent:
            z_samples, q_zCc, q_zCct = self.latent_path(x_t, R, y_trgt, mask_cntxt, mask_trgt,
                                                        cond_emb, generator, eps)
        if self.encoded_path == "latent":
            R = None
        R_trgt = self.trgt_dependent_representation(x_c, z_samples, R, x_t, mask_cntxt)
        return NPFOutput(self.decode(x_t, R_trgt), z_samples, q_zCc, q_zCct)

    def latent_path(self, x_t, R, y_trgt, mask_cntxt, mask_trgt, cond_emb, generator, eps):
        """-> (z_samples [n_z, B, *n_lat, z_dim] float32, q(z|C), q(z|C,T) or
        None). q(z|C,T) encodes the targets with `encode_globally` (its
        BatchNorm statistics move a second time in train mode, after the
        context's), without the additive conditioning."""
        q_zCc = self.infer_latent_dist(R, mask_cntxt)
        q_zCct = None
        if self.is_q_zCct and y_trgt is not None:
            R_from_trgt = self.encode_globally(x_t, y_trgt, mask_trgt, cond_emb=cond_emb)
            q_zCct = self.infer_latent_dist(R_from_trgt, mask_trgt)
        sampling = q_zCc if q_zCct is None else q_zCct
        n_z = self.n_z_samples_train if self.training else self.n_z_samples_test
        z_samples = sampling.sample(generator, (n_z,), eps=eps)
        return z_samples, q_zCc, q_zCct

    def infer_latent_dist(self, R, mask) -> NormalDiag:
        suffstat = self.latent_encoder(self.rep_to_lat_input(R, mask))
        loc, raw_scale = suffstat.split(self.z_dim, dim=-1)
        if self.lat_scale_transform == "softplus":
            lo, span = _weak((self.min_lat_sigma, 1.0 - self.min_lat_sigma), raw_scale.dtype)
            scale = lo + span * (F.softplus(raw_scale) if raw_scale.dtype == torch.float32
                                 else _softplus_jax(raw_scale))
        else:
            lo, span = _weak((self.min_lat_sigma, self.max_lat_sigma_ratio), raw_scale.dtype)
            scale = lo + span * (torch.sigmoid(raw_scale) if raw_scale.dtype == torch.float32
                                 else _sigmoid_jax(raw_scale))
        return NormalDiag(loc.float(), scale.float())

    def rep_to_lat_input(self, R, mask):
        """The latent encoder's input from R: R itself (one latent per
        representation)."""
        return R

    def decode(self, x_t, R_trgt) -> NormalDiag:
        suffstat = self.decoder(x_t, R_trgt)  # [n_z, B, Nt, 2*y_dim]
        loc, raw_scale = suffstat.split(self.y_dim, dim=-1)
        lo, span = _weak((self.min_sigma_pred, 1.0 - self.min_sigma_pred), raw_scale.dtype)
        if raw_scale.dtype == torch.float32:
            scale = lo + span * F.softplus(raw_scale)
        else:
            scale = lo + span * _softplus_jax(raw_scale)
        return NormalDiag(loc.float(), scale.float())

    def encode_globally(self, x_c, y_c, mask_cntxt, cond_emb=None):
        raise NotImplementedError

    def trgt_dependent_representation(self, x_c, z_samples, R, x_t, mask_cntxt):
        raise NotImplementedError
