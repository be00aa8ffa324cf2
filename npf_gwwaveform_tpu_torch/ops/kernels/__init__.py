"""Wrappers of the hand-written CUDA kernels, each beside its plain PyTorch
version, and the autograd Functions through which the model reaches them. A
wrapper launches its kernel for CUDA tensors and uses the plain version for
CPU tensors; `launches` on each wrapper counts kernel launches.

`KERNELS` is the one map from each kernel's id (K1, K2, K3, K2-bf16,
K3-bf16) to its wrapper, the wrapper's counter and the `__global__`
functions of `csrc/*.cu` that one wrapper call runs: exactly one of its
`marks`, and maybe some of its `helpers`. A profiler trace counts a
wrapper's launches by its marks (`traced_launches` in `kernel_measure`).
A launch counter advances where the wrapper launches its kernel: inside a
CUDA-graph capture it counts the capture, and a replay advances no counter.
"""

import re
from typing import NamedTuple, Optional

from .mlp_chain import (
    FusedReluMLPFn, fused_relu_mlp, fused_relu_mlp_bwd, fused_relu_mlp_bwd_plain,
    fused_relu_mlp_plain,
)
from .setconv import SetConvExpRBFFn, setconv_exprbf_bwd, setconv_exprbf_fwd, setconv_exprbf_plain

__all__ = [
    "KERNELS",
    "FusedReluMLPFn",
    "SetConvExpRBFFn",
    "counts",
    "fused_relu_mlp",
    "fused_relu_mlp_bwd",
    "fused_relu_mlp_bwd_plain",
    "fused_relu_mlp_plain",
    "hand_kernel_id",
    "reset_counts",
    "setconv_exprbf_bwd",
    "setconv_exprbf_fwd",
    "setconv_exprbf_plain",
]


class Kernel(NamedTuple):
    wrapper: object
    counter: str  # the wrapper's attribute that counts this kernel's launches
    marks: tuple  # one of these runs at each launch
    helpers: tuple = ()  # kernels a launch may run besides


KERNELS = {
    "K1": Kernel(setconv_exprbf_fwd, "launches", ("setconv_fwd_wide", "setconv_fwd_narrow")),
    "K2": Kernel(fused_relu_mlp, "launches", ("mlp_chain_fwd_fast", "mlp_chain_fwd_wide")),
    "K3": Kernel(fused_relu_mlp_bwd, "launches", ("mlp_chain_bwd_rows",),
                 ("mlp_chain_bwd_transpose", "mlp_chain_bwd_wgrad", "mlp_chain_bwd_reduce")),
    "K2-bf16": Kernel(fused_relu_mlp, "launches_bf16",
                      ("mlp_chain_fwd_bf16_tc", "mlp_chain_fwd_bf16_fma")),
    "K3-bf16": Kernel(fused_relu_mlp_bwd, "launches_bf16",
                      ("mlp_chain_bwd_bf16_rows_tc", "mlp_chain_bwd_bf16_rows_fma"),
                      ("mlp_chain_bwd_bf16_wgrad", "mlp_chain_bwd_bf16_reduce")),
}


def _named(trace_name: str, fn: str) -> bool:
    """Whether a trace's kernel name (demangled: `void f<...>(...)`) is `fn`."""
    return re.search(rf"(?<!\w){fn}(?!\w)", trace_name) is not None


def hand_kernel_id(trace_name: str, marks_only: bool = False) -> Optional[str]:
    """The id of the wrapper whose kernel a trace's kernel name is (only its
    marks with `marks_only`), or None for a kernel that is not ours."""
    for kid, k in KERNELS.items():
        if any(_named(trace_name, fn) for fn in k.marks + (() if marks_only else k.helpers)):
            return kid
    return None


def reset_counts() -> None:
    for k in KERNELS.values():
        setattr(k.wrapper, k.counter, 0)


def counts() -> tuple:
    """Each wrapper's launches since `reset_counts`, in `KERNELS`' order."""
    return tuple(getattr(k.wrapper, k.counter) for k in KERNELS.values())
