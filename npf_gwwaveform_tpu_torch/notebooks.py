"""Notebook helpers, the counterpart of `npf_gwwaveform_tpu/notebooks.py`
(the reference's `utils/ntbks_helpers.py`): the GP dataset builders,
fixed-context splitters, models at each dataset's y_dim, display names, and
the aggregation of every `eval.csv` under a results tree
(`load_all_results`, which imports pandas inside).
"""

from __future__ import annotations

import glob
import os
from typing import Callable, Dict

import numpy as np

from .data.datasplit import (
    CntxtTrgtSplitter, GetRandomIndcs, GridCntxtTrgtSplitter, RandomMasker, get_all_indcs,
)
from .data.gp import DatasetMerger, get_gp_datasets

__all__ = [
    "get_all_gp_datasets",
    "get_datasets_single_gp",
    "get_datasets_variable_hyp_gp",
    "get_datasets_variable_kernel_gp",
    "get_n_cntxt",
    "add_y_dim",
    "load_all_results",
    "PRETTY_RENAMER",
]

# display names (ref ntbks_helpers.py:217-258)
PRETTY_RENAMER = {
    "RBF_Kernel": "RBF Kernel",
    "Periodic_Kernel": "Periodic Kernel",
    "Noisy_Matern_Kernel": "Noisy Matern Kernel",
    "Matern_Kernel": "Matern Kernel",
    "Variable_Matern_Kernel": "Variable Matern Kernel",
    "All_Kernels": "All Kernels",
    "CNP": "CNP",
    "LNP": "LNP",
    "AttnCNP": "AttnCNP",
    "AttnLNP": "AttnLNP",
    "ConvCNP": "ConvCNP",
    "ConvLNP": "ConvLNP",
    "GridConvCNP": "GridConvCNP",
    "GridConvLNP": "GridConvLNP",
    "NllLNPF": "NPML",
    "ElboLNPF": "NPVI",
    "SUMOLNPF": "SUMO",
}


def get_datasets_single_gp(**kwargs):
    """(train, test, valid) of the RBF, Periodic and Noisy Matern GPs
    (`data.gp.get_gp_datasets`'s keywords, `device` among them)."""
    return get_gp_datasets(names=("RBF_Kernel", "Periodic_Kernel", "Noisy_Matern_Kernel"),
                           **kwargs)


def get_datasets_variable_hyp_gp(**kwargs):
    """The Matern GP with a length scale drawn per function."""
    return get_gp_datasets(names=("Variable_Matern_Kernel",), **kwargs)


def get_all_gp_datasets(**kwargs):
    """The single GPs and the variable-hyperparameter Matern."""
    return get_gp_datasets(names=("RBF_Kernel", "Periodic_Kernel", "Noisy_Matern_Kernel",
                                  "Variable_Matern_Kernel"), **kwargs)


def get_datasets_variable_kernel_gp(**kwargs):
    """All_Kernels: each split one `DatasetMerger` of the single GPs'."""
    train, test, valid = get_datasets_single_gp(**kwargs)
    return ({"All_Kernels": DatasetMerger(list(train.values()))},
            {"All_Kernels": DatasetMerger(list(test.values()))},
            {"All_Kernels": DatasetMerger(list(valid.values()))})


def get_n_cntxt(n_cntxt: int, is_1d: bool = True, upscale_factor: float = 1.0):
    """A splitter with exactly `n_cntxt` contexts, for plots: 1-D, every
    point a target; or a grid splitter (`RandomMasker(n, n)`)."""
    if is_1d:
        return CntxtTrgtSplitter(contexts_getter=GetRandomIndcs(a=n_cntxt, b=n_cntxt),
                                 targets_getter=get_all_indcs)
    return GridCntxtTrgtSplitter(context_masker=RandomMasker(a=n_cntxt, b=n_cntxt),
                                 upscale_factor=upscale_factor)


def add_y_dim(models: Dict[str, Callable], datasets: Dict[str, object]) -> dict:
    """{dataset name: {model name: model}}, each model built for the
    dataset's `y_dim` (1 where it has none). JAX clones a flax template
    with `.clone(y_dim=...)`; a torch module holds its parameters from its
    construction, so here a template is a callable taking `y_dim` (a model
    class or a `functools.partial` of one, e.g. `partial(CNP, x_dim=1,
    r_dim=128)`), called anew for each dataset."""
    return {
        data_name: {name: make(y_dim=getattr(dataset, "y_dim", 1))
                    for name, make in models.items()}
        for data_name, dataset in datasets.items()
    }


def load_all_results(root: str = "results/", pattern: str = "**/eval.csv"):
    """A pandas DataFrame of every `eval.csv` under `root`: columns data,
    model, run (the three directories above the file), mean_ll and n, in
    `glob`'s order; paths fewer than four parts deep are skipped."""
    import pandas as pd

    rows = []
    for path in glob.glob(os.path.join(root, pattern), recursive=True):
        parts = os.path.relpath(path, root).split(os.sep)
        if len(parts) < 4:
            continue
        lls = np.loadtxt(path, delimiter=",")
        rows.append(dict(data=parts[-4], model=parts[-3], run=parts[-2],
                         mean_ll=float(np.mean(lls)), n=int(np.size(lls))))
    return pd.DataFrame(rows)
