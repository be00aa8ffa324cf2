"""Attentive conditional and latent neural processes, the counterparts of
`npf_gwwaveform_tpu/models/attnnp.py::AttnCNP` and `::AttnLNP`.

AttnCNP keeps one representation per context point (the xy-encoder's,
zeroed at padding; with `is_self_attn` the xy-encoder's inner module is a
`SelfAttention` stack instead of the MLP) and gives each target the
cross-attention of its encoded x (queries) over the encoded context x
(keys) and those representations (values): `attender`, one of
`get_attender`'s names (`attention`, with `attention_kwargs`). Padded
context points get zero weight; a target with an empty context gets the
zero representation. AttnLNP forces `encoded_path="both"`: its latent
input is the masked mean of the per-point representations, and each
target's representation is `merge_r_z` of its cross-attention and a z
draw, so the decoder runs on n_z * B * n_trgt rows. `dtype` reaches the
self-attention xy-encoder and the attender too (the transformer block
returns float32, as JAX's LayerNorm does).
"""

from __future__ import annotations

from typing import Optional

from ..ops.attention import get_attender
from ..ops.encoders import MergeFlatInputs
from ..ops.selfattn import SelfAttention
from ..utils.helpers import masked_mean
from .np import CNP

__all__ = ["AttnCNP", "AttnLNP"]


class AttnCNP(CNP):
    def __init__(self, *args, attention: str = "scaledot", attention_kwargs: Optional[dict] = None,
                 is_self_attn: bool = False, self_attention_kwargs: Optional[dict] = None,
                 **kwargs):
        self.is_self_attn = is_self_attn
        self.self_attention_kwargs = self_attention_kwargs or {}
        super().__init__(*args, **kwargs)
        self.attender = get_attender(attention, self.x_transf_dim, self.r_dim, self.r_dim,
                                     dtype=self.dtype, **(attention_kwargs or {}))

    def _make_xy_encoder(self, hidden_size):
        if not self.is_self_attn:
            return super()._make_xy_encoder(hidden_size)
        attn = SelfAttention(self.x_transf_dim, out_dim=self.r_dim, dtype=self.dtype,
                             **self.self_attention_kwargs)
        return MergeFlatInputs(attn, self.x_transf_dim, self.y_dim, is_sum_merge=True)

    def encode_globally(self, x_c, y_c, mask_cntxt, cond_emb=None):
        """-> [B, Nc, r_dim], zero at the padded points."""
        R_cntxt = self.xy_encoder(x_c, y_c)
        return R_cntxt * mask_cntxt[..., None].to(R_cntxt.dtype)

    def trgt_dependent_representation(self, x_c, z_samples, R, x_t, mask_cntxt):
        return self.attender(x_c, x_t, R, mask_keys=mask_cntxt)[None]


class AttnLNP(AttnCNP):
    def __init__(self, *args, **kwargs):
        if kwargs.setdefault("encoded_path", "both") != "both":
            raise ValueError("AttnLNP's encoded_path is 'both'")
        super().__init__(*args, **kwargs)
        self._make_latent_merger()

    def rep_to_lat_input(self, R, mask):
        """The masked mean of the per-point representations, [B, 1, r_dim]."""
        return masked_mean(R, mask, dim=-2)[:, None, :]

    def trgt_dependent_representation(self, x_c, z_samples, R, x_t, mask_cntxt):
        B, n_trgt = x_t.shape[:2]
        z = z_samples.expand(z_samples.shape[0], B, n_trgt, self.z_dim)
        return self.merge_r_z(self.attender(x_c, x_t, R, mask_keys=mask_cntxt), z)
