"""GW model configurations for the slices the port covers: ConvCNP with the
flat CNN (`_cnn_factory(5)`: five ResConvBlocks of two depthwise-separable
convs, BatchNorm eps 1e-3), time-domain targets, FiLM parameter conditioning.

`gw_model_from_summary` rebuilds a run's model from its `summary.json`, the
counterpart of `npf_gwwaveform_tpu/configs.py::gw_model_from_summary`;
`gw_train_summary` states a training run's settings the way
`experiments/reproduce_gw.py` records them, the flagship's by default.
"""

from __future__ import annotations

from .models.convnp import ConvCNP

R_DIM = 128

__all__ = ["gw_model_from_summary", "gw_train_summary", "run_tag", "R_DIM", "STEPS_PER_EPOCH"]

# experiments/reproduce_gw.py decays the learning rate once per 1562 steps
STEPS_PER_EPOCH = 1562


def gw_model_from_summary(summary: dict, use_kernels: bool = True) -> ConvCNP:
    """The run's architecture; raises on a knob the port does not cover.

    The CNN kernel size is the summary's `cnn_kernel_size`, 19 when absent
    (the CNN factory's, not ConvCNP's class default of 11). `cnn_banded` and
    `use_pallas_setconv` select lowerings of the same function in JAX and are
    ignored here.
    """
    unsupported = {
        "model": summary.get("model") != "ConvCNP",
        "cnn_arch": summary.get("cnn_arch", "cnn") != "cnn",
        "cnn_dilations": bool(summary.get("cnn_dilations")),
        "mode": summary.get("mode", "time") != "time",
        "cond_mode": bool(summary.get("conditioned"))
        and (summary.get("cond_mode") or "film") != "film",
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(f'{k}={summary.get(k)!r}' for k in bad)}")
    return ConvCNP(
        x_dim=1, y_dim=1, r_dim=R_DIM,
        density_induced=summary.get("density_induced") or 64,
        cnn_n_blocks=5, cnn_kernel_size=summary.get("cnn_kernel_size") or 19,
        cnn_norm="batch", cnn_n_conv_layers=2, cnn_norm_eps=1e-3,
        cond_dim=4 if summary.get("conditioned") else 0, cond_mode="film",
        use_kernels=use_kernels,
    )


def gw_train_summary(model: str = "ConvCNP", mode: str = "time", cond: bool = True,
                     cond_mode: str = "film", n_context: int = 192, density: int = 128,
                     cnn_arch: str = "cnn") -> dict:
    """The settings of a `reproduce_gw.py` training run as its `summary.json`
    records them. The defaults are the flagship run `GW_time_cond_film_ctx192_d128`
    (`--cond --cond-mode film --n-context 192 --density 128`); a setting the
    port has not ported raises NotImplementedError."""
    summary = {"model": model, "mode": mode, "conditioned": bool(cond),
               "cond_mode": cond_mode if cond else None, "n_context": n_context,
               "density_induced": density}
    if cnn_arch != "cnn":
        summary["cnn_arch"] = cnn_arch
    gw_model_from_summary(summary)  # refuses what is not ported
    return summary


def run_tag(summary: dict) -> str:
    """The run directory's data tag, as `reproduce_gw.py` names it."""
    tag = f"GW_{summary['mode']}"
    if summary["conditioned"]:
        tag += "_cond" if summary["cond_mode"] == "add" else "_cond_film"
    return tag + f"_ctx{summary['n_context']}_d{summary['density_induced']}"
