"""K2 and K3: the fused ReLU MLP chain forward (`csrc/mlp_chain_fwd.cu`) and
backward (`csrc/mlp_chain_bwd.cu`), each beside its plain PyTorch version.

Counterpart of `npf_gwwaveform_tpu/ops/pallas/mlp_chain_kernel.py`
(`fused_relu_mlp` and its custom_vjp), float32. Weights use PyTorch's Linear
layout `[out, in]` (the transpose of the flax kernels the Pallas entry takes).
`FusedReluMLPFn` is the only way the model reaches the kernels where a
gradient is needed: forward K2, backward K3.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import _build
from ._checks import ptr, require_cuda_f32, require_no_grad, require_shape

def _check_chain(name: str, tensors: dict):
    """Device, type, layout and shape checks of a chain's tensors -> (M, C, H, L1, O)."""
    require_cuda_f32(name, **tensors)
    x, w0, wh, wout = tensors["x"], tensors["w0"], tensors["wh"], tensors["wout"]
    M, C = x.shape
    H, L1, O = w0.shape[0], wh.shape[0], wout.shape[0]
    require_shape(name, "w0", w0, (H, C))
    require_shape(name, "wh", wh, (L1, H, H))
    require_shape(name, "wout", wout, (O, H))
    for arg, shape in (("b0", (H,)), ("bh", (L1, H)), ("bout", (O,)), ("g", (M, O))):
        if tensors.get(arg) is not None:
            require_shape(name, arg, tensors[arg], shape)
    return M, C, H, L1, O


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
    version; CUDA tensors launch the kernel (float32, contiguous) or raise,
    also when a gradient is needed outside `FusedReluMLPFn`."""
    if x.device.type == "cpu":
        return fused_relu_mlp_plain(x, w0, b0, wh, bh, wout, bout, is_res)
    name = "fused_relu_mlp"
    tensors = dict(x=x, w0=w0, b0=b0, wh=wh, bh=bh, wout=wout, bout=bout)
    require_no_grad(name, **tensors)
    M, C, H, L1, O = _check_chain(name, tensors)
    lib = _build.lib()
    # the launcher's own plan (csrc/mlp_chain_fwd.cu), asked before any launch
    if lib.npf_mlp_chain_fwd_smem(M, C, H, O) < 0:
        raise ValueError(f"{name}: widths C={C}, H={H} exceed the kernel's shared memory")
    out = torch.empty((M, O), device=x.device, dtype=torch.float32)
    if M == 0 or O == 0:
        return out
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.npf_mlp_chain_fwd(
        ptr(x), M, C, ptr(w0), ptr(b0), ptr(wh), ptr(bh), L1, H,
        ptr(wout), ptr(bout), O, int(is_res), ptr(out), stream,
    )
    _build.check(err, name)
    fused_relu_mlp.launches += 1
    return out


fused_relu_mlp.launches = 0


def fused_relu_mlp_bwd_plain(x, g, w0, b0, wh, bh, wout, is_res: bool = False):
    """The chain's backward as `_bwd_kernel` computes it: recompute the
    forward keeping each layer's input and ReLU mask, then backpropagate
    g [M,O]. -> (dx [M,C], dw0 [H,C], db0 [H], dwh [L1,H,H], dbh [L1,H],
    dwout [O,H], dbout [O]), the weight gradients summed over rows."""
    h = F.linear(x, w0, b0)
    masks = [h > 0]
    acts = [torch.relu(h)]
    for i in range(wh.shape[0]):
        h = F.linear(acts[-1], wh[i], None if bh is None else bh[i])
        masks.append(h > 0)
        r = torch.relu(h)
        acts.append(r + acts[-1] if is_res else r)
    dwout, dbout = g.t() @ acts[-1], g.sum(dim=0)
    g = g @ wout
    dwh, dbh = [], []
    for i in range(wh.shape[0] - 1, -1, -1):
        gpre = g * masks[i + 1]
        dwh.append(gpre.t() @ acts[i])
        dbh.append(gpre.sum(dim=0))
        g = gpre @ wh[i] + g if is_res else gpre @ wh[i]
    gpre = g * masks[0]
    dw0, db0, dx = gpre.t() @ x, gpre.sum(dim=0), gpre @ w0
    H = w0.shape[0]
    dwh = torch.stack(dwh[::-1]) if dwh else x.new_zeros((0, H, H))
    dbh = torch.stack(dbh[::-1]) if dbh else x.new_zeros((0, H))
    return dx, dw0, db0, dwh, dbh, dwout, dbout


def fused_relu_mlp_bwd(x, g, w0, b0, wh, bh, wout, is_res: bool = False):
    """Same contract as `fused_relu_mlp_bwd_plain`. CPU tensors take the plain
    version; CUDA tensors launch K3 and its reduction (float32, contiguous,
    L1 >= 0, null biases) or raise. Two launches on the same inputs give the
    same bits."""
    if x.device.type == "cpu":
        return fused_relu_mlp_bwd_plain(x, g, w0, b0, wh, bh, wout, is_res)
    name = "fused_relu_mlp_bwd"
    tensors = dict(x=x, g=g, w0=w0, b0=b0, wh=wh, bh=bh, wout=wout)
    require_no_grad(name, **tensors)
    M, C, H, L1, O = _check_chain(name, tensors)
    n_grads = H * C + H + L1 * H * H + L1 * H + O * H + O
    dx = torch.empty((M, C), device=x.device, dtype=torch.float32)
    # the reduction writes every entry; with no rows the sums are zero
    grads = (torch.empty if M > 0 else torch.zeros)((n_grads,), device=x.device,
                                                     dtype=torch.float32)
    if M > 0:
        lib = _build.lib()
        n_scratch = lib.npf_mlp_chain_bwd_scratch(M, C, H, L1, O)
        if n_scratch < 0:
            raise ValueError(f"{name}: widths C={C}, H={H}, L1={L1}, O={O} exceed the kernel's "
                             "shared memory")
        scratch = torch.empty((n_scratch,), device=x.device, dtype=torch.float32)
        err = lib.npf_mlp_chain_bwd(
            ptr(x), ptr(g), M, C, ptr(w0), ptr(b0), ptr(wh), ptr(bh), L1, H, ptr(wout), O,
            int(is_res), ptr(dx), ptr(grads), ptr(scratch),
            torch.cuda.current_stream().cuda_stream,
        )
        _build.check(err, name)
        fused_relu_mlp_bwd.launches += 1
    sizes = (H * C, H, L1 * H * H, L1 * H, O * H, O)
    shapes = ((H, C), (H,), (L1, H, H), (L1, H), (O, H), (O,))
    return (dx, *(t.view(s) for t, s in zip(grads.split(sizes), shapes)))


fused_relu_mlp_bwd.launches = 0


class FusedReluMLPFn(torch.autograd.Function):
    """(x, w0, b0, wh, bh, wout, bout, is_res) -> [M,O] through K2 (its plain
    version on CPU tensors); backward through K3. Biases may be None and then
    get no gradient."""

    @staticmethod
    def forward(ctx, x, w0, b0, wh, bh, wout, bout, is_res):
        ctx.save_for_backward(x, w0, b0, wh, bh, wout)
        ctx.is_res = is_res
        ctx.has_bout = bout is not None
        return fused_relu_mlp(x, w0, b0, wh, bh, wout, bout, is_res)

    @staticmethod
    def backward(ctx, g):
        x, w0, b0, wh, bh, wout = ctx.saved_tensors
        # g arrives strided when the caller split the output (loc / raw scale)
        dx, dw0, db0, dwh, dbh, dwout, dbout = fused_relu_mlp_bwd(
            x, g.contiguous(), w0, b0, wh, bh, wout, ctx.is_res)
        return (dx, dw0, None if b0 is None else db0, dwh, None if bh is None else dbh, dwout,
                dbout if ctx.has_bout else None, None)
