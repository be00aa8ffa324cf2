"""GW model configurations for the slices the port covers: ConvCNP with
time-domain targets, the flat CNN (`_cnn_factory(5)`: five ResConvBlocks of
two depthwise-separable convs, BatchNorm eps 1e-3), dilated per block or
not, or the `UnetCNN` (`_unet_factory(5)`), and FiLM or additive parameter
conditioning.

`gw_model_from_summary` rebuilds a run's model from its `summary.json`, the
counterpart of `npf_gwwaveform_tpu/configs.py::gw_model_from_summary`;
`gw_train_summary` states a training run's settings the way
`experiments/reproduce_gw.py` records them, the flagship's by default.
"""

from __future__ import annotations

from typing import Optional

import torch

from .models.convnp import ConvCNP

R_DIM = 128

__all__ = ["gw_model_from_summary", "gw_train_summary", "run_tag", "R_DIM", "STEPS_PER_EPOCH"]

# experiments/reproduce_gw.py decays the learning rate once per 1562 steps
STEPS_PER_EPOCH = 1562


def gw_model_from_summary(summary: dict, use_kernels: bool = True,
                          dtype: Optional[torch.dtype] = None) -> ConvCNP:
    """The run's architecture in compute `dtype` (None: float32; bfloat16 as
    `reproduce_gw.py --bf16` builds it); raises NotImplementedError on a knob
    the port does not cover (bfloat16 compute is ported for the flat
    undilated CNN with FiLM only), and ValueError where JAX refuses too
    (`cnn_arch="unet"` with `cnn_dilations`). A run directory records no
    dtype: its parameters are float32 either way.

    The CNN kernel size is the summary's `cnn_kernel_size`, 19 when absent
    (the CNN factory's, not ConvCNP's class default of 11). `cnn_banded` and
    `use_pallas_setconv` select lowerings of the same function in JAX and are
    ignored here.
    """
    arch = summary.get("cnn_arch", "cnn")
    dilations = summary.get("cnn_dilations") or None
    cond = bool(summary.get("conditioned"))
    cond_mode = summary.get("cond_mode") or "film"
    unsupported = {
        "model": summary.get("model") != "ConvCNP",
        "cnn_arch": arch not in ("cnn", "unet"),
        "mode": summary.get("mode", "time") != "time",
    }
    bad = [f"{k}={summary.get(k)!r}" for k, v in unsupported.items() if v]
    if dtype is not None and (arch != "cnn" or dilations or (cond and cond_mode != "film")):
        bad.append(f"dtype={dtype} with cnn_arch={arch!r}, cnn_dilations={dilations}, "
                   f"cond_mode={cond_mode!r}")
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")
    return ConvCNP(
        x_dim=1, y_dim=1, r_dim=R_DIM,
        density_induced=summary.get("density_induced") or 64,
        cnn_n_blocks=5, cnn_kernel_size=summary.get("cnn_kernel_size") or 19,
        cnn_norm="batch", cnn_n_conv_layers=2, cnn_norm_eps=1e-3,
        cnn_arch=arch, cnn_dilations=dilations,
        cond_dim=4 if cond else 0, cond_mode=cond_mode,
        use_kernels=use_kernels, dtype=dtype,
    )


def gw_train_summary(model: str = "ConvCNP", mode: str = "time", cond: bool = True,
                     cond_mode: str = "film", n_context: int = 192, density: int = 128,
                     cnn_arch: str = "cnn") -> dict:
    """The settings of a `reproduce_gw.py` training run as its `summary.json`
    records them. The defaults are the flagship run `GW_time_cond_film_ctx192_d128`
    (`--cond --cond-mode film --n-context 192 --density 128`). Training is
    ported for the flat CNN with FiLM conditioning: any other setting raises
    NotImplementedError."""
    if cnn_arch != "cnn" or (cond and cond_mode != "film"):
        raise NotImplementedError(f"training not ported yet: cnn_arch={cnn_arch!r}, "
                                  f"cond_mode={cond_mode!r}")
    summary = {"model": model, "mode": mode, "conditioned": bool(cond),
               "cond_mode": cond_mode if cond else None, "n_context": n_context,
               "density_induced": density}
    gw_model_from_summary(summary)  # refuses what is not ported
    return summary


def run_tag(summary: dict) -> str:
    """The run directory's data tag, as `reproduce_gw.py` names it."""
    tag = f"GW_{summary['mode']}"
    if summary["conditioned"]:
        tag += "_cond" if summary["cond_mode"] == "add" else "_cond_film"
    return tag + f"_ctx{summary['n_context']}_d{summary['density_induced']}"
