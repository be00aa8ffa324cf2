"""Neural-process objectives, the counterpart of `npf_gwwaveform_tpu/losses.py`:
`CNPFLoss` trains the deterministic family with the exact NLL; the latent
family trains with NPML (`NLLLossLNPF`, importance-weighted by q(z|C) /
q(z|C,T) when z was drawn from q(z|C,T)), the ELBO (`ELBOLossLNPF`, which
needs q(z|C,T)) or SUMO (`SUMOLossLNPF`). Every loss evaluates with NPML
without importance weights (`is_force_mle_eval`)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .distributions import NormalDiag, kl_normal_diag
from .utils.helpers import logcumsumexp, sum_from_nth_dim

__all__ = ["NPFOutput", "BaseLossNPF", "CNPFLoss", "NLLLossLNPF", "ELBOLossLNPF", "SUMOLossLNPF",
           "sum_log_prob_masked", "cnpf_loss", "npml_loss", "elbo_loss", "sumo_loss",
           "light_tail_pareto_inv_weights"]


class NPFOutput(NamedTuple):
    """p_yCc: predictive with loc/scale [n_z, B, n_trgt, y_dim]; for the
    latent family also the draws z_samples [n_z, B, *n_lat, z_dim], q(z|C)
    and, where it was inferred, q(z|C,T) (batch [B, *n_lat]). The latent
    fields stay None for the deterministic family."""

    p_yCc: NormalDiag
    z_samples: Optional[torch.Tensor] = None
    q_zCc: Optional[NormalDiag] = None
    q_zCct: Optional[NormalDiag] = None


def sum_log_prob_masked(p: NormalDiag, y: torch.Tensor, mask: Optional[torch.Tensor]):
    """Per-point log-prob summed past (n_z, B), padded points masked out -> [n_z, B]."""
    log_p = p.log_prob(y)
    if mask is not None:
        log_p = log_p * mask.to(log_p.dtype)
    return sum_from_nth_dim(log_p, 2)


def _sum_log_prob_latent(q: NormalDiag, z: torch.Tensor) -> torch.Tensor:
    """log q(z) summed over the latents: z [n_z, B, *n_lat, z_dim] -> [n_z, B]."""
    return sum_from_nth_dim(q.log_prob(z), 2)


def _log_weights(out: NPFOutput, y_trgt, mask_trgt, use_iw: bool) -> torch.Tensor:
    """sum_t log p, plus log q(z|C) - log q(z|C,T) when z came from q(z|C,T)
    and `use_iw` -> [n_z, B]."""
    sum_log_p = sum_log_prob_masked(out.p_yCc, y_trgt, mask_trgt)
    if use_iw and out.q_zCct is not None:
        return (sum_log_p + _sum_log_prob_latent(out.q_zCc, out.z_samples)
                - _sum_log_prob_latent(out.q_zCct, out.z_samples))
    return sum_log_p


def cnpf_loss(out: NPFOutput, y_trgt, mask_trgt=None) -> torch.Tensor:
    """Exact NLL of the conditional family -> [B]."""
    return -sum_log_prob_masked(out.p_yCc, y_trgt, mask_trgt)[0]


def elbo_loss(out: NPFOutput, y_trgt, mask_trgt=None) -> torch.Tensor:
    """Negative ELBO: -(mean_z sum_t log p - KL[q(z|C,T) || q(z|C)]) -> [B]."""
    if out.q_zCct is None:
        raise ValueError("the ELBO needs q(z|C,T): a model with is_q_zCct and y_trgt")
    e_z_sum_log_p = sum_log_prob_masked(out.p_yCc, y_trgt, mask_trgt).mean(dim=0)
    kl = sum_from_nth_dim(kl_normal_diag(out.q_zCct, out.q_zCc), 1)
    return -(e_z_sum_log_p - kl)


def npml_loss(out: NPFOutput, y_trgt, mask_trgt=None, use_iw: bool = True) -> torch.Tensor:
    """NPML negative log-marginal -(logsumexp_z log w - log n_z) -> [B], w
    importance-weighted as `_log_weights` says."""
    n_z = out.p_yCc.loc.shape[0]
    sum_log_w = _log_weights(out, y_trgt, mask_trgt, use_iw)
    return -(torch.logsumexp(sum_log_w, dim=0) - math.log(n_z))


def light_tail_pareto_inv_weights(max_n: int, m: int = 5, alpha: int = 85) -> np.ndarray:
    """P(K >= k), k = 1..max_n, of SUMO's sample-count law: with kk =
    max(k - m, 1) and alpha' = alpha - m, 1/kk for kk < alpha', else
    (1/alpha') 0.9^(kk - alpha')."""
    ks = np.arange(1, max_n + 1, dtype=np.float64)
    kk = np.clip(ks - m, 1.0, None)
    ap = float(alpha - m)
    return np.where(kk < ap, 1.0 / kk, (1.0 / ap) * 0.9 ** (kk - ap))


def sumo_loss(out: NPFOutput, y_trgt, mask_trgt=None, m: int = 5, alpha: int = 85):
    """SUMO's unbiased log-marginal estimate, the IWAE sequence telescoped
    from its m-th term with the weights `light_tail_pareto_inv_weights`;
    needs n_z > m -> [B]."""
    n_z = out.p_yCc.loc.shape[0]
    if n_z <= m:
        raise ValueError(f"SUMO needs n_z > m ({n_z} <= {m})")
    sum_log_w = _log_weights(out, y_trgt, mask_trgt, use_iw=True)
    dev = sum_log_w.device
    log_ks = torch.log(torch.arange(1, n_z + 1, dtype=torch.float32, device=dev))[:, None]
    cum_iwae = logcumsumexp(sum_log_w, dim=0) - log_ks
    inv_w = torch.from_numpy(light_tail_pareto_inv_weights(n_z, m, alpha).astype(np.float32))
    inv_w = inv_w.to(dev)[:, None]
    sumo = cum_iwae[m - 1] + (inv_w[m:] * (cum_iwae[m:] - cum_iwae[m - 1:-1])).sum(dim=0)
    return -sumo


def _reduce(loss: torch.Tensor, reduction: Optional[str]) -> torch.Tensor:
    if reduction is None:
        return loss
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    raise ValueError(f"Unknown reduction {reduction}")


@dataclass(frozen=True)
class BaseLossNPF:
    """Train-loss vs eval-loss dispatch: eval is NPML, without importance
    weights when `is_force_mle_eval`."""

    reduction: Optional[str] = "mean"
    is_force_mle_eval: bool = True

    def __call__(self, out: NPFOutput, y_trgt, mask_trgt=None, train: bool = True):
        if train:
            loss = self.get_loss(out, y_trgt, mask_trgt)
        else:
            loss = npml_loss(out, y_trgt, mask_trgt, use_iw=not self.is_force_mle_eval)
        return _reduce(loss, self.reduction)

    def get_loss(self, out, y_trgt, mask_trgt):
        raise NotImplementedError


@dataclass(frozen=True)
class CNPFLoss(BaseLossNPF):
    def get_loss(self, out, y_trgt, mask_trgt):
        if out.q_zCc is not None:
            raise ValueError("CNPFLoss takes the deterministic family only")
        return cnpf_loss(out, y_trgt, mask_trgt)


@dataclass(frozen=True)
class ELBOLossLNPF(BaseLossNPF):
    def get_loss(self, out, y_trgt, mask_trgt):
        return elbo_loss(out, y_trgt, mask_trgt)


@dataclass(frozen=True)
class NLLLossLNPF(BaseLossNPF):
    def get_loss(self, out, y_trgt, mask_trgt):
        return npml_loss(out, y_trgt, mask_trgt)


@dataclass(frozen=True)
class SUMOLossLNPF(BaseLossNPF):
    """m: the fewest samples of the count law; alpha: its tail shape."""

    m: int = 5
    alpha: int = 85

    def get_loss(self, out, y_trgt, mask_trgt):
        return sumo_loss(out, y_trgt, mask_trgt, self.m, self.alpha)
