"""Neural-process objectives for the deterministic (conditional) family, the
counterpart of `npf_gwwaveform_tpu/losses.py`: `CNPFLoss` trains with the
exact NLL, and every loss evaluates with NPML (`is_force_mle_eval`)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from .distributions import NormalDiag
from .utils.helpers import sum_from_nth_dim

__all__ = ["NPFOutput", "CNPFLoss", "sum_log_prob_masked", "cnpf_loss", "npml_loss"]


class NPFOutput(NamedTuple):
    """p_yCc: predictive with loc/scale [n_z, B, n_trgt, y_dim]. The latent
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


def cnpf_loss(out: NPFOutput, y_trgt, mask_trgt=None) -> torch.Tensor:
    """Exact NLL of the conditional family -> [B]."""
    return -sum_log_prob_masked(out.p_yCc, y_trgt, mask_trgt)[0]


def npml_loss(out: NPFOutput, y_trgt, mask_trgt=None) -> torch.Tensor:
    """NPML negative log-marginal -(logsumexp_z sum_t log p - log n_z) -> [B]."""
    n_z = out.p_yCc.loc.shape[0]
    sum_log_p = sum_log_prob_masked(out.p_yCc, y_trgt, mask_trgt)
    return -(torch.logsumexp(sum_log_p, dim=0) - math.log(n_z))


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
    """Train-loss vs eval-loss dispatch: eval always uses NPML."""

    reduction: Optional[str] = "mean"

    def __call__(self, out: NPFOutput, y_trgt, mask_trgt=None, train: bool = True):
        loss = self.get_loss(out, y_trgt, mask_trgt) if train else npml_loss(out, y_trgt, mask_trgt)
        return _reduce(loss, self.reduction)

    def get_loss(self, out, y_trgt, mask_trgt):
        raise NotImplementedError


@dataclass(frozen=True)
class CNPFLoss(BaseLossNPF):
    def get_loss(self, out, y_trgt, mask_trgt):
        if out.q_zCc is not None:
            raise ValueError("CNPFLoss takes the deterministic family only")
        return cnpf_loss(out, y_trgt, mask_trgt)
