"""GW model configurations for the slices the port covers: ConvCNP and
ConvLNP with time-domain targets (`mode` "time", one channel) or frequency-domain
amplitude and phase targets (`mode` "freq_ap", two channels), the flat CNN
(`_cnn_factory(5)`: five ResConvBlocks of two depthwise-separable convs,
BatchNorm eps 1e-3), dilated per block or not, or the `UnetCNN`
(`_unet_factory(5)`), and FiLM, additive or no parameter conditioning.
ConvLNP is the notebook's: four such blocks in both grid CNNs, a global
latent (`is_global`), 16 z draws in training and 32 in eval, NPML; the
summary's `no_lat_lb` selects the unbounded q(z) scale (`1e-4 + softplus`)
and `train_loss_objective="elbo"` q(z|C,T) with one draw in training and
the ELBO (`criterion_from_summary`).

`gw_model_from_summary` rebuilds a run's model from its `summary.json`, the
counterpart of `npf_gwwaveform_tpu/configs.py::gw_model_from_summary`, in
float32 or bfloat16 compute; `gw_train_summary` states a training run's
settings the way `experiments/reproduce_gw.py` records them (the flagship's
by default), and `run_tag` names its directory as that script does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .losses import BaseLossNPF, CNPFLoss, ELBOLossLNPF, NLLLossLNPF
from .models.convnp import ConvCNP, ConvLNP

R_DIM = 128

__all__ = ["gw_model_from_summary", "gw_train_summary", "run_tag", "train_config", "CONFIG_KEYS",
           "R_DIM", "STEPS_PER_EPOCH", "MODELS", "gp_criterion", "criterion_from_summary",
           "default_clip"]

# the model families the port builds
MODELS = ("ConvCNP", "ConvLNP")

# experiments/reproduce_gw.py decays the learning rate once per 1562 steps
STEPS_PER_EPOCH = 1562
# the fields of a `reproduce_gw.py` summary that its flags set (`:472-498`),
# as against the run's length, throughput, scores and provenance
CONFIG_KEYS = ("model", "mode", "conditioned", "cond_mode", "n_context", "density_induced",
               "cnn_kernel_size", "cnn_dilations", "cnn_arch", "cnn_banded", "no_lat_lb",
               "train_loss_objective", "duration", "n_points", "use_pallas_setconv", "lr",
               "decay_lr", "grad_clip_norm")


def gw_model_from_summary(summary: dict, use_kernels: bool = True,
                          dtype: Optional[torch.dtype] = None) -> ConvCNP:
    """The run's architecture in compute `dtype` (None: float32; bfloat16 as
    `reproduce_gw.py --bf16` builds it, for every family); raises
    NotImplementedError on a knob the port does not cover, and ValueError
    where JAX refuses too (`cnn_arch="unet"` with `cnn_dilations`). A run
    directory records no dtype: its parameters are float32 either way.

    The CNN kernel size is the summary's `cnn_kernel_size`, 19 when absent
    (the CNN factory's, not ConvCNP's class default of 11). `cnn_banded` and
    `use_pallas_setconv` select lowerings of the same function in JAX and are
    ignored here. A ConvLNP run (`model` "ConvLNP") has four blocks in each
    grid CNN, `is_global`, 16 z draws in training and 32 in eval; with
    `no_lat_lb` the q(z) scale is `1e-4 + softplus`, else `0.1 + 0.9 *
    sigmoid`; with `train_loss_objective="elbo"` it samples from q(z|C,T)
    where targets are given, one draw in training.
    """
    arch = summary.get("cnn_arch", "cnn")
    dilations = summary.get("cnn_dilations") or None
    cond = bool(summary.get("conditioned"))
    mode = summary.get("mode", "time")
    unsupported = {
        "model": summary.get("model") not in MODELS,
        "cnn_arch": arch not in ("cnn", "unet"),
        "mode": mode not in ("time", "freq_ap"),
    }
    bad = [f"{k}={summary.get(k)!r}" for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")
    common = dict(
        x_dim=1, y_dim=1 if mode == "time" else 2, r_dim=R_DIM,
        density_induced=summary.get("density_induced") or 64,
        cnn_kernel_size=summary.get("cnn_kernel_size") or 19,
        cnn_norm="batch", cnn_n_conv_layers=2, cnn_norm_eps=1e-3,
        cnn_arch=arch, cnn_dilations=dilations,
        cond_dim=4 if cond else 0, cond_mode=summary.get("cond_mode") or "film",
        use_kernels=use_kernels, dtype=dtype,
    )
    if summary["model"] == "ConvCNP":
        return ConvCNP(cnn_n_blocks=5, **common)
    elbo = summary.get("train_loss_objective") == "elbo"
    scale = (dict(lat_scale_transform="softplus", min_lat_sigma=1e-4)
             if summary.get("no_lat_lb") else {})
    return ConvLNP(cnn_n_blocks=4, is_global=True, is_q_zCct=elbo,
                   n_z_samples_train=1 if elbo else 16, n_z_samples_test=32, **scale, **common)


def gp_criterion(name: str) -> BaseLossNPF:
    """The training objective of a model family (eval always forces NPML):
    the exact NLL for ConvCNP, NPML for ConvLNP."""
    if name == "ConvCNP":
        return CNPFLoss()
    if name == "ConvLNP":
        return NLLLossLNPF()
    raise NotImplementedError(f"model={name!r} not ported yet")


def criterion_from_summary(summary: dict) -> BaseLossNPF:
    """A run's training objective, as `reproduce_gw.py:212-217` picks it:
    the family's (`gp_criterion`), or the ELBO for `train_loss_objective`
    "elbo"."""
    if summary.get("train_loss_objective") == "elbo":
        return ELBOLossLNPF()
    return gp_criterion(summary["model"])


def default_clip(summary: dict) -> Optional[float]:
    """The gradient clip a run trained with: its `grad_clip_norm`, else
    `reproduce_gw.py`'s default (`:232-238`), 1.0 for ConvLNP and none for
    ConvCNP; that script records no `grad_clip_norm` for its default."""
    if summary.get("grad_clip_norm") is not None:
        return summary["grad_clip_norm"]
    return 1.0 if summary["model"] == "ConvLNP" else None


def gw_train_summary(model: str = "ConvCNP", mode: str = "time", cond: bool = True,
                     cond_mode: str = "film", n_context: int = 192,
                     density: Optional[int] = 128, cnn_kernel: Optional[int] = None,
                     cnn_dilations: Optional[Sequence[int]] = None, cnn_arch: str = "cnn",
                     duration: float = 1.0, n_points: int = 256, pallas: bool = False,
                     lr: float = 1e-3, decay_lr: float = 10.0, clip: Optional[float] = None,
                     banded: bool = False, remat: bool = False, no_lat_lb: bool = False,
                     loss: Optional[str] = None) -> dict:
    """The settings of a `reproduce_gw.py` training run as its `summary.json`
    records them (`:472-498`): each optional field only where that script
    writes it (`density_induced` when a density is given, `cnn_kernel_size`,
    `cnn_dilations` and `cnn_arch` when set, `duration` and `n_points` when
    the duration is not 1 s, `use_pallas_setconv` with `pallas`, `lr` and
    `decay_lr` off their defaults, `grad_clip_norm` when a clip is given).
    The defaults are the flagship run `GW_time_cond_film_ctx192_d128`
    (`--cond --cond-mode film --n-context 192 --density 128`), not the
    script's. `pallas` names the tag and the field only: the port runs both
    SetConvs through K1 on CUDA either way.

    `mode` is "time" or "freq_ap" (amplitude and standardised phase on
    `n_points` frequencies, two output channels). `model` "ConvLNP" with
    `no_lat_lb` (the field `no_lat_lb`) and `loss="elbo"` (the field
    `train_loss_objective`), each written where set, as that script does;
    its default clip of 1.0 is not written (`default_clip`). Raises
    ValueError where JAX refuses (`cnn_arch="unet"` with dilations, another
    mode, another loss) and NotImplementedError for what is not ported:
    another model than ConvCNP or ConvLNP, `banded`, `remat`."""
    if mode not in ("time", "freq_ap"):
        raise ValueError(f"mode={mode!r}: 'time' or 'freq_ap'")
    if loss not in (None, "elbo"):
        raise ValueError(f"loss={loss!r}: None or 'elbo'")
    if loss == "elbo" and model != "ConvLNP":
        # JAX's ELBO needs q(z|C,T), which only the latent family infers
        raise ValueError(f"loss='elbo' trains a latent model, not {model}")
    unported = {"model": model not in MODELS, "banded": banded, "remat": remat}
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"training not ported yet: {', '.join(bad)}")
    if cnn_arch == "unet" and cnn_dilations:
        raise ValueError("cnn_dilations are not supported with cnn_arch='unet'")
    if n_points != 256 and duration == 1.0:
        # reproduce_gw.py tags such a run `_np{n}` but records no n_points,
        # so neither its scorer nor the port's could rebuild its data
        raise NotImplementedError(f"n_points={n_points} at duration 1.0")
    summary = {"model": model, "mode": mode, "conditioned": bool(cond),
               "cond_mode": cond_mode if cond else None, "n_context": n_context}
    optional = {
        "density_induced": density or None,
        "cnn_kernel_size": cnn_kernel or None,
        "cnn_dilations": [int(d) for d in cnn_dilations] if cnn_dilations else None,
        "cnn_arch": cnn_arch if cnn_arch != "cnn" else None,
        "duration": duration if duration != 1.0 else None,
        "n_points": n_points if duration != 1.0 else None,
        "no_lat_lb": True if no_lat_lb else None,
        "train_loss_objective": loss,
        "use_pallas_setconv": True if pallas else None,
        "lr": lr if lr != 1e-3 else None,
        "decay_lr": decay_lr if decay_lr != 10.0 else None,
        "grad_clip_norm": clip,
    }
    summary.update({k: v for k, v in optional.items() if v is not None})
    gw_model_from_summary(summary)  # refuses what is not ported
    criterion_from_summary(summary)
    return summary


def run_tag(summary: dict) -> str:
    """The run directory's data tag, as `reproduce_gw.py:274-298` names it:
    `GW_{mode}`, `_cond` (additive) or `_cond_film` when conditioned,
    `_ctx{n}`, then `_d`, `_k`, `_dil`, `_{arch}`, `_banded`, `_latlbF`,
    `_elbo`, `_T{duration}s`, `_np` and `_pallas`, each only where the run
    set it. Summaries written before the script recorded `n_context` (and
    `cond_mode`, then always additive) have no `_ctx` (and tag `_cond`)."""
    tag = f"GW_{summary['mode']}"
    if summary["conditioned"]:
        tag += "_cond_film" if summary.get("cond_mode", "add") == "film" else "_cond"
    if "n_context" in summary:
        tag += f"_ctx{summary['n_context']}"
    if summary.get("density_induced"):
        tag += f"_d{summary['density_induced']}"
    if summary.get("cnn_kernel_size"):
        tag += f"_k{summary['cnn_kernel_size']}"
    if summary.get("cnn_dilations"):
        tag += "_dil" + "-".join(str(d) for d in summary["cnn_dilations"])
    if summary.get("cnn_arch", "cnn") != "cnn":
        tag += f"_{summary['cnn_arch']}"
    if summary.get("cnn_banded"):
        tag += "_banded"
    if summary.get("no_lat_lb"):
        tag += "_latlbF"
    if summary.get("train_loss_objective") == "elbo":
        tag += "_elbo"
    if summary.get("duration", 1.0) != 1.0:
        tag += f"_T{summary['duration']:g}s"
    if summary.get("n_points", 256) != 256:
        tag += f"_np{summary['n_points']}"
    if summary.get("use_pallas_setconv"):
        tag += "_pallas"
    return tag


def train_config(summary: dict) -> dict:
    """A run summary's configuration fields (`CONFIG_KEYS`): what a run
    trained with the same flags records, whatever its length and scores."""
    return {k: v for k, v in summary.items() if k in CONFIG_KEYS}
