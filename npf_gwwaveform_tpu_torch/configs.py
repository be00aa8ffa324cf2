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

The 1-D GP benchmark's models (`experiments/reproduce_gp.py`) come from
`gp_model_1d` (the notebooks' CNP, LNP, AttnCNP, AttnLNP, ConvCNP and
ConvLNP; the conv family on a 64-a-unit grid, so 192 points on [-1.5,
1.5], five and four BatchNorm blocks, no conditioning) and
`gp_model_variant` (the objective-ablation grid's LNP, AttnLNP and ConvLNP,
`variant_name` naming its directory); `gp_model_from_summary` rebuilds a GP
run from its summary as `experiments/reeval.py` does, with the run's own
BatchNorm eps.
A GW loader refuses a GP run's summary (it has a `kernel` field) and the GP
loader a GW run's.

The image benchmark's models (`experiments/reproduce_img.py`) come from
`img_model` (that script's `build_model`): GridConvCNP (five 2-D
ResConvBlocks of two layers, k = 9, BatchNorm, the AbsConv at k = 11),
GridConvLNP (four blocks in both grid CNNs, `is_global`, 16 z draws in
training and 32 in eval), GridConvCNPXL (twelve blocks), each with
circular padding and BatchNorm eps 1e-2 on `zsmms`; and the set and
attention family at `gp_model_1d`'s widths with x_dim = 2, the attention
models with the self-attention xy-encoder. `img_model_from_summary`
rebuilds an image run (`is_img_summary`: its summary names a `dataset`),
which the GW and GP loaders refuse, as the image loader refuses theirs.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from torch import nn

from .losses import BaseLossNPF, CNPFLoss, ELBOLossLNPF, NLLLossLNPF, SUMOLossLNPF
from .models.attnnp import AttnCNP, AttnLNP
from .models.convnp import ConvCNP, ConvLNP
from .models.gridconvnp import GridConvCNP, GridConvLNP
from .models.np import CNP, LNP

R_DIM = 128

__all__ = ["gw_model_from_summary", "gw_train_summary", "run_tag", "train_config", "CONFIG_KEYS",
           "R_DIM", "STEPS_PER_EPOCH", "MODELS", "GP_MODELS", "SET_MODELS", "LATENT_MODELS",
           "gp_criterion", "criterion_from_summary",
           "default_clip", "gp_model_1d", "gp_model_variant", "variant_name", "parse_variant",
           "gp_model_from_summary", "gp_criterion_from_summary", "is_gp_summary",
           "IMG_MODELS", "GRID_MODELS", "img_model", "img_model_from_summary", "img_criterion",
           "is_img_summary"]

# the GW model families the port builds
MODELS = ("ConvCNP", "ConvLNP")
# the GP benchmark's families: the set and attention family, then the conv family
SET_MODELS = ("CNP", "LNP", "AttnCNP", "AttnLNP")
GP_MODELS = SET_MODELS + MODELS
# the latent families, which have objective-ablation variants and SUMO runs
LATENT_MODELS = ("LNP", "AttnLNP", "ConvLNP")

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
    if is_gp_summary(summary):
        raise ValueError(f"a GP run's summary (kernel={summary['kernel']!r}): rebuild it with "
                         "configs.gp_model_from_summary (score_gp.load_model)")
    if is_img_summary(summary):
        raise ValueError(f"an image run's summary (dataset={summary['dataset']!r}): rebuild it "
                         "with configs.img_model_from_summary (score_img.load_model)")
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


def is_gp_summary(summary: dict) -> bool:
    """Whether a summary is a GP run's (`reproduce_gp.py` records its kernel)."""
    return "kernel" in summary


# the set and attention family's GP configurations (the JAX package's
# `gp_model_1d`): the xy-encoder's hidden width in units of r_dim, the
# attender, and the latent path (NPVI: q(z|C,T) with one draw in training)
_SET_CONFIGS = {
    "CNP": (CNP, 2, {}),
    "LNP": (LNP, 2, dict(is_q_zCct=True, n_z_samples_train=1, n_z_samples_test=32)),
    "AttnCNP": (AttnCNP, 1, dict(attention="transformer")),
    "AttnLNP": (AttnLNP, 1, dict(attention="transformer", is_q_zCct=True, n_z_samples_train=1,
                                 n_z_samples_test=8)),
}
# the NPML ablation variants' and SUMO's z draws in training (and in eval)
_NPML_DRAWS = {"LNP": 32, "AttnLNP": 8, "ConvLNP": 16}


def _set_model(name: str, r_dim: int, dtype: Optional[torch.dtype], use_kernels: bool,
               x_dim: int = 1, y_dim: int = 1, **overrides) -> nn.Module:
    cls, hidden, kwargs = _SET_CONFIGS[name]
    return cls(x_dim=x_dim, y_dim=y_dim, r_dim=r_dim, xy_hidden_size=hidden * r_dim,
               use_kernels=use_kernels, dtype=dtype, **{**kwargs, **overrides})


def gp_model_1d(name: str, r_dim: int = R_DIM, dtype: Optional[torch.dtype] = None,
                cnn_kernel_size: int = 19, cnn_norm_eps: float = 1e-3,
                use_kernels: bool = True,
                induced_range: Tuple[float, float] = (-1.5, 1.5)) -> nn.Module:
    """The 1-D GP benchmark's model, as the JAX package's `gp_model_1d`
    builds it: CNP and LNP (the xy-encoder's MLP at 2 * r_dim), AttnCNP and
    AttnLNP (at r_dim, a transformer attender of 8 heads), LNP and AttnLNP
    trained with NPVI (q(z|C,T), one draw) and scored at 32 and 8 draws;
    ConvCNP (five blocks, the MLP decoder through K2) or ConvLNP (four
    blocks in both grid CNNs, `is_global`, NPML with 16 z draws in training
    and 32 in eval, a linear decoder), each on a grid of 64 points a unit,
    BatchNorm eps `cnn_norm_eps`, the grid over `induced_range` (JAX's
    `clone(induced_range=...)` builds the same modules; the parameters do
    not depend on it). The set family's decoder is the MLP chain (K2 and
    K3) too."""
    if name in _SET_CONFIGS:
        return _set_model(name, r_dim, dtype, use_kernels)
    common = dict(x_dim=1, y_dim=1, r_dim=r_dim, density_induced=64,
                  cnn_kernel_size=cnn_kernel_size, cnn_norm="batch", cnn_n_conv_layers=2,
                  cnn_norm_eps=cnn_norm_eps, use_kernels=use_kernels, dtype=dtype,
                  induced_range=tuple(induced_range))
    if name == "ConvCNP":
        return ConvCNP(cnn_n_blocks=5, **common)
    if name == "ConvLNP":
        return ConvLNP(cnn_n_blocks=4, is_global=True, is_q_zCct=False, n_z_samples_train=16,
                       n_z_samples_test=32, **common)
    raise ValueError(name)


def gp_model_variant(name: str, is_elbo: bool, is_lat_lb: bool, is_sig_lb: bool,
                     r_dim: int = R_DIM, dtype: Optional[torch.dtype] = None,
                     cnn_norm_eps: float = 1e-3, headline_arch: bool = False,
                     use_kernels: bool = True) -> nn.Module:
    """The objective-ablation grid's LNP, AttnLNP or ConvLNP, as the JAX
    package's `gp_model_variant` builds it: the ELBO from q(z|C,T) with one
    draw in training (`is_elbo`) or NPML with 32 (LNP), 8 (AttnLNP) or 16
    (ConvLNP), as many in eval; `min_sigma_pred` 0.01 (`is_sig_lb`) or
    1e-4; the q(z) scale 0.1 + 0.9 sigmoid (`is_lat_lb`) or 1e-4 +
    softplus. LNP and AttnLNP keep `gp_model_1d`'s architecture. The
    ConvLNP "notebook" architecture has z_dim 16 (`reshaper_z` maps it to
    r_dim) and no global latent; the headline one (`headline_arch`) keeps
    z_dim = r_dim and the global latent. Both decode linearly, the notebook
    one in float32 whatever `dtype` (its JAX Dense has no dtype)."""
    if name not in LATENT_MODELS:
        raise ValueError(f"{name} has no objective-ablation variant")
    scale = {} if is_lat_lb else dict(lat_scale_transform="softplus", min_lat_sigma=1e-4)
    if name != "ConvLNP":
        draws = _NPML_DRAWS[name]
        return _set_model(name, r_dim, dtype, use_kernels, is_q_zCct=is_elbo,
                          n_z_samples_train=1 if is_elbo else draws, n_z_samples_test=draws,
                          min_sigma_pred=0.01 if is_sig_lb else 1e-4, **scale)
    arch = {} if headline_arch else dict(z_dim=16, is_global=False)
    model = ConvLNP(x_dim=1, y_dim=1, r_dim=r_dim, density_induced=64, cnn_kernel_size=19,
                   cnn_norm="batch", cnn_n_conv_layers=2, cnn_norm_eps=cnn_norm_eps,
                   cnn_n_blocks=4, use_kernels=use_kernels, dtype=dtype,
                   **{"is_global": True, **arch}, is_q_zCct=is_elbo,
                   n_z_samples_train=1 if is_elbo else _NPML_DRAWS[name],
                   n_z_samples_test=_NPML_DRAWS[name],
                   min_sigma_pred=0.01 if is_sig_lb else 1e-4, **scale)
    if not headline_arch:  # JAX's notebook decoder is a Dense with no dtype
        model.decoder.module.dtype = None
    return model


def variant_name(name: str, is_elbo: bool, is_lat_lb: bool, is_sig_lb: bool) -> str:
    """The ablation run's directory name (Losses.ipynb's `get_name`)."""
    return f"{name}_ELBO{is_elbo}_LatLB{is_lat_lb}_SigLB{is_sig_lb}"


def parse_variant(run_name: str) -> tuple:
    """`variant_name`'s inverse: "ConvLNP_ELBOTrue_LatLBFalse_SigLBTrue" ->
    ("ConvLNP", {"ELBO": True, "LatLB": False, "SigLB": True})."""
    base, *parts = run_name.split("_")
    flags = {}
    for part in parts:
        val = part.endswith("True")
        flags[part[: -len("True" if val else "False")]] = val
    if set(flags) != {"ELBO", "LatLB", "SigLB"}:
        raise ValueError(f"not an ablation variant's name: {run_name!r}")
    return base, flags


def gp_model_from_summary(summary: dict, use_kernels: bool = True,
                          dtype: Optional[torch.dtype] = None) -> nn.Module:
    """A GP run's model as `experiments/reeval.py` rebuilds it: the ablation
    variant its name encodes (`{model}_ELBO*_LatLB*_SigLB*`, for ConvLNP the
    architecture its `ablation_arch` records, "notebook" when absent), the
    SUMO run's NPML variant (`{model}_SUMO`: headline scale bounds, for
    ConvLNP the notebook architecture), or the family's `gp_model_1d`;
    BatchNorm eps the summary's `norm_eps` (1e-3 when absent). A GW run's
    summary is refused."""
    if not is_gp_summary(summary):
        raise ValueError("not a GP run's summary (no `kernel`): rebuild a GW run with "
                         "configs.gw_model_from_summary (score.load_model), an image run with "
                         "configs.img_model_from_summary (score_img.load_model)")
    name, eps = summary["model"], summary.get("norm_eps", 1e-3)
    kw = dict(cnn_norm_eps=eps, use_kernels=use_kernels, dtype=dtype)
    if "_ELBO" in name:
        base, flags = parse_variant(name)
        return gp_model_variant(base, flags["ELBO"], flags["LatLB"], flags["SigLB"],
                                headline_arch=summary.get("ablation_arch") == "headline", **kw)
    if name.endswith("_SUMO"):
        return gp_model_variant(name[: -len("_SUMO")], False, True, True, **kw)
    return gp_model_1d(name, **kw)


def gp_criterion_from_summary(summary: dict) -> BaseLossNPF:
    """A GP run's training objective, as `reproduce_gp.py` picks it: the
    ELBO or NPML of an ablation variant, SUMO for `{model}_SUMO`, else the
    family's (`gp_criterion`)."""
    name = summary["model"]
    if "_ELBO" in name:
        return ELBOLossLNPF() if parse_variant(name)[1]["ELBO"] else NLLLossLNPF()
    if name.endswith("_SUMO"):
        return SUMOLossLNPF()
    return gp_criterion(name)


def gp_criterion(name: str) -> BaseLossNPF:
    """The training objective of a model family (eval always forces NPML):
    the exact NLL for CNP, AttnCNP and ConvCNP, the ELBO (NPVI) for LNP and
    AttnLNP, NPML for ConvLNP."""
    if name in ("CNP", "AttnCNP", "ConvCNP"):
        return CNPFLoss()
    if name in ("LNP", "AttnLNP"):
        return ELBOLossLNPF()
    if name == "ConvLNP":
        return NLLLossLNPF()
    raise ValueError(name)


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


# the image benchmark's families (experiments/reproduce_img.py)
GRID_MODELS = ("GridConvCNP", "GridConvLNP", "GridConvCNPXL")
IMG_MODELS = GRID_MODELS + SET_MODELS
# GridConvCNP's, GridConvLNP's and GridConvCNPXL's blocks in each grid CNN
_GRID_BLOCKS = {"GridConvCNP": 5, "GridConvLNP": 4, "GridConvCNPXL": 12}


def is_img_summary(summary: dict) -> bool:
    """Whether a summary is an image run's (`reproduce_img.py` records its
    dataset)."""
    return "dataset" in summary


def img_model(name: str, dataset: str = "digits", y_dim: int = 1, use_kernels: bool = True,
              remat: bool = False, n_conv_layers: int = 2,
              dtype: Optional[torch.dtype] = None) -> nn.Module:
    """An image model as `reproduce_img.py`'s `build_model` makes it for
    `dataset`: the grid family at r_dim 128 with 2-D ResConvBlocks of
    `n_conv_layers` (two in that script; one in an earlier build), k = 9,
    BatchNorm, the AbsConv at k = 11, on `zsmms` circular padding and
    BatchNorm eps 1e-2 (else zeros and 1e-3); GridConvLNP with `is_global`,
    16 z draws in training and 32 in eval; `remat` each CNN block's
    recomputation in the backward pass. The point models are
    `gp_model_1d`'s at x_dim = 2 and `y_dim`, AttnCNP and AttnLNP with the
    self-attention xy-encoder. Every model computes in `dtype` (None:
    float32), as `build_model(name, dtype=...)` builds it."""
    if name in SET_MODELS:
        extra = dict(is_self_attn=True) if name.startswith("Attn") else {}
        return _set_model(name, R_DIM, dtype, use_kernels, x_dim=2, y_dim=y_dim, **extra)
    if name not in GRID_MODELS:
        raise ValueError(f"model={name!r}: one of {', '.join(IMG_MODELS)}")
    zsmms = dataset == "zsmms"
    common = dict(x_dim=1, y_dim=y_dim, r_dim=R_DIM, cnn_n_blocks=_GRID_BLOCKS[name],
                  cnn_kernel_size=9, cnn_norm="batch", cnn_n_conv_layers=n_conv_layers,
                  cnn_norm_eps=1e-2 if zsmms else 1e-3, conv_kernel_size=11,
                  conv_padding="CIRCULAR" if zsmms else "SAME", cnn_remat=remat,
                  use_kernels=use_kernels, dtype=dtype)
    if name == "GridConvLNP":
        return GridConvLNP(is_global=True, n_z_samples_train=16, n_z_samples_test=32, **common)
    return GridConvCNP(**common)


def img_model_from_summary(summary: dict, use_kernels: bool = True, remat: bool = False,
                           n_conv_layers: int = 2,
                           dtype: Optional[torch.dtype] = None) -> nn.Module:
    """An image run's model (`img_model` of its `model` and `dataset`, y_dim
    the summary's, 1 where an older summary has none) in compute `dtype`.
    A GW or GP run's summary is refused."""
    if not is_img_summary(summary):
        raise ValueError("not an image run's summary (no `dataset`): rebuild a GW run with "
                         "configs.gw_model_from_summary, a GP run with "
                         "configs.gp_model_from_summary")
    return img_model(summary["model"], summary["dataset"], summary.get("y_dim", 1),
                     use_kernels, remat, n_conv_layers, dtype)


def img_criterion(name: str) -> BaseLossNPF:
    """An image model's training objective, as `reproduce_img.py` picks it:
    NPML (`NLLLossLNPF`) for the names holding "LNP", the exact NLL
    otherwise."""
    return NLLLossLNPF() if "LNP" in name else CNPFLoss()
