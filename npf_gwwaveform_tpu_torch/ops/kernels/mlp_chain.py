"""K2: the fused ReLU MLP chain forward (`csrc/mlp_chain_fwd.cu`) and its
plain PyTorch version.

Counterpart of `npf_gwwaveform_tpu/ops/pallas/mlp_chain_kernel.py`
(`fused_relu_mlp`), forward only, float32. Weights use PyTorch's Linear layout
`[out, in]` (the transpose of the flax kernels the Pallas entry takes).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import _build
from ._checks import ptr, require_cuda_f32, require_shape

_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def fused_relu_mlp_plain(x, w0, b0, wh, bh, wout, bout, is_res: bool = False):
    """x [M,C], w0 [H,C], b0 [H], wh [L1,H,H], bh [L1,H], wout [O,H], bout [O]
    -> [M,O]: relu(x w0^T + b0), then L1 times relu(a wh^T + bh) (+ a when
    is_res), then a wout^T + bout. Any bias may be None."""
    a = torch.relu(F.linear(x, w0, b0))
    for i in range(wh.shape[0]):
        r = torch.relu(F.linear(a, wh[i], None if bh is None else bh[i]))
        a = r + a if is_res else r
    return F.linear(a, wout, bout)


def fused_relu_mlp(x, w0, b0, wh, bh, wout, bout, is_res: bool = False):
    """Same contract as `fused_relu_mlp_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel (float32, contiguous) or raise."""
    if x.device.type == "cpu":
        return fused_relu_mlp_plain(x, w0, b0, wh, bh, wout, bout, is_res)
    name = "fused_relu_mlp"
    require_cuda_f32(name, x=x, w0=w0, b0=b0, wh=wh, bh=bh, wout=wout, bout=bout)
    M, C = x.shape
    H, L1, O = w0.shape[0], wh.shape[0], wout.shape[0]
    require_shape(name, "w0", w0, (H, C))
    require_shape(name, "wh", wh, (L1, H, H))
    require_shape(name, "wout", wout, (O, H))
    for arg, bias, shape in (("b0", b0, (H,)), ("bh", bh, (L1, H)), ("bout", bout, (O,))):
        if bias is not None:
            require_shape(name, arg, bias, shape)
    # the smallest row tile (16 rows) keeps two activation buffers and one
    # weight chunk in shared memory (csrc/mlp_chain_fwd.cu, smem_bytes)
    if (2 * 16 * (max(C, H) + 1) + 32 * 129) * 4 > _SMEM_LIMIT:
        raise ValueError(f"{name}: widths C={C}, H={H} exceed the kernel's shared memory")
    out = torch.empty((M, O), device=x.device, dtype=torch.float32)
    if M == 0 or O == 0:
        return out
    stream = torch.cuda.current_stream().cuda_stream
    err = _build.lib().npf_mlp_chain_fwd(
        ptr(x), M, C, ptr(w0), ptr(b0), ptr(wh), ptr(bh), L1, H,
        ptr(wout), ptr(bout), O, int(is_res), ptr(out), stream,
    )
    _build.check(err, name)
    fused_relu_mlp.launches += 1
    return out


fused_relu_mlp.launches = 0
