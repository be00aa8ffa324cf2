"""K2 and K3: the fused ReLU MLP chain forward and backward, each beside its
plain PyTorch version, in two compute dtypes: float32 (`csrc/mlp_chain_fwd.cu`,
`csrc/mlp_chain_bwd.cu`) and bfloat16 (`csrc/mlp_chain_fwd_bf16.cu`,
`csrc/mlp_chain_bwd_bf16.cu`).

Counterpart of `npf_gwwaveform_tpu/ops/pallas/mlp_chain_kernel.py`
(`fused_relu_mlp(..., compute_dtype)` and its custom_vjp). Weights use
PyTorch's Linear layout `[out, in]` (the transpose of the flax kernels the
Pallas entry takes). `FusedReluMLPFn` is the only way the model reaches the
kernels where a gradient is needed: forward K2, backward K3.

bfloat16 compute rounds where the Pallas kernel does (`mlp_chain_kernel.py`):
x, every weight and every bias are rounded to bf16 (`:184-185`, `:239-240`);
each layer sums its bf16 products in f32, adds the bias in f32, applies the
ReLU in f32 and rounds to bf16 (`:73-77`); the residual adds two bf16 values
and rounds (`:78`); the output `h + bout` is rounded to bf16 (`:80`). The
backward takes its ReLU masks from the f32 pre-activations (`:100-111`),
rounds g to bf16 (`:239`), sums each `g W` product in f32 and rounds it to
bf16 (`:121-123`, `:131-133`), adds the residual gradient in bf16 (`:134`),
returns dx in bf16 (`:140-142`) and sums dW/db in f32 (`:117-139`). The
weights and biases stay float32 parameters; the kernels round them as they
read them. The plain bf16 versions sum every product feature by feature in
order (`_matmul_seq`); the bf16 kernels sum on the tensor cores in k-groups of
16, another order, and sum again in the plain order only the outputs whose
rounding their sum leaves undecided (csrc/mlp_chain_bf16.cuh). A kernel is
held to its plain version by the bars of `kernel_measure.py`, which admit any
order of the sums (tests/test_torch_bf16_order.py): K2-bf16's output within
2^-6 of each element's absolute product sum, at most 1% of the elements
differing; K3-bf16's dx within two bf16 ulps of its row's largest magnitude,
at most 2% differing, and dW/db within 1e-2 of each one's max magnitude. Two
launches of a kernel on the same inputs give the same bits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import _build
from ._checks import ptr, require_cuda, require_no_grad, require_shape

BF16 = torch.bfloat16
COMPUTE_DTYPES = (torch.float32, BF16)


def _compute_dtype(name: str, compute_dtype) -> torch.dtype:
    if compute_dtype not in COMPUTE_DTYPES:
        raise TypeError(f"{name}: compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    return compute_dtype


def _check_chain(name: str, tensors: dict, compute_dtype=torch.float32):
    """Device, type, layout and shape checks of a chain's tensors -> (M, C, H,
    L1, O). x and g are in the compute dtype; weights and biases float32."""
    rows = ("x", "g")
    require_cuda(name, compute_dtype, **{k: v for k, v in tensors.items() if k in rows})
    require_cuda(name, torch.float32, **{k: v for k, v in tensors.items() if k not in rows})
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


def _matmul_seq(a, b):
    """a [M,K] @ b [K,N] in f32 from bf16-valued operands, summed over k in
    order 0..K-1: each product of two bf16 values is exact in f32, so every
    step is one f32 FMA, the order the bf16 kernels fall back to where their
    tensor-core sums leave a rounding undecided."""
    a, b = a.float(), b.float()
    acc = a.new_zeros((a.shape[0], b.shape[1]))
    for k in range(b.shape[0]):
        acc += a[:, k, None] * b[None, k, :]
    return acc


def _bf16_forward(x, w0, b0, wh, bh, wout, bout, is_res):
    """The bf16 chain at the Pallas kernel's rounding points -> (out [M,O]
    bf16, layer inputs [a_0 .. a_L1] bf16, masks of the f32 pre-activations)."""
    def pre(a, w, b):  # f32 sum of bf16 products, plus the bf16-rounded bias in f32
        h = _matmul_seq(a, w.to(BF16).t())
        return h if b is None else h + b.to(BF16).float()

    h = pre(x.to(BF16), w0, b0)
    masks, acts = [h > 0], [torch.relu(h).to(BF16)]
    for i in range(wh.shape[0]):
        h = pre(acts[-1], wh[i], None if bh is None else bh[i])
        masks.append(h > 0)
        r = torch.relu(h).to(BF16)
        acts.append(r + acts[-1] if is_res else r)
    return pre(acts[-1], wout, bout).to(BF16), acts, masks


def fused_relu_mlp_plain(x, w0, b0, wh, bh, wout, bout, is_res: bool = False,
                         compute_dtype=torch.float32):
    """x [M,C], w0 [H,C], b0 [H], wh [L1,H,H], bh [L1,H], wout [O,H], bout [O]
    -> [M,O] in `compute_dtype`: relu(x w0^T + b0), then L1 times
    relu(a wh^T + bh) (+ a when is_res), then a wout^T + bout. Any bias may
    be None. bfloat16 rounds at the Pallas kernel's points (module doc)."""
    if _compute_dtype("fused_relu_mlp_plain", compute_dtype) == BF16:
        return _bf16_forward(x, w0, b0, wh, bh, wout, bout, is_res)[0]
    a = torch.relu(F.linear(x, w0, b0))
    for i in range(wh.shape[0]):
        r = torch.relu(F.linear(a, wh[i], None if bh is None else bh[i]))
        a = r + a if is_res else r
    return F.linear(a, wout, bout)


def fused_relu_mlp(x, w0, b0, wh, bh, wout, bout, is_res: bool = False,
                   compute_dtype=torch.float32):
    """Same contract as `fused_relu_mlp_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel of `compute_dtype` (x in it,
    weights and biases float32, all contiguous) or raise, also when a
    gradient is needed outside `FusedReluMLPFn`."""
    name = "fused_relu_mlp"
    compute_dtype = _compute_dtype(name, compute_dtype)
    if x.device.type == "cpu":
        return fused_relu_mlp_plain(x, w0, b0, wh, bh, wout, bout, is_res, compute_dtype)
    tensors = dict(x=x, w0=w0, b0=b0, wh=wh, bh=bh, wout=wout, bout=bout)
    require_no_grad(name, **tensors)
    M, C, H, L1, O = _check_chain(name, tensors, compute_dtype)
    bf16 = compute_dtype == BF16
    lib = _build.lib()
    # the launcher's own plan, asked before any launch
    smem = lib.npf_mlp_chain_fwd_bf16_smem if bf16 else lib.npf_mlp_chain_fwd_smem
    if smem(M, C, H, O) < 0:
        raise ValueError(f"{name}: widths C={C}, H={H} exceed the {compute_dtype} kernel's "
                         "shared memory")
    out = torch.empty((M, O), device=x.device, dtype=compute_dtype)
    if M == 0 or O == 0:
        return out
    launch = lib.npf_mlp_chain_fwd_bf16 if bf16 else lib.npf_mlp_chain_fwd
    err = launch(
        ptr(x), M, C, ptr(w0), ptr(b0), ptr(wh), ptr(bh), L1, H,
        ptr(wout), ptr(bout), O, int(is_res), ptr(out), torch.cuda.current_stream().cuda_stream,
    )
    _build.check(err, name)
    if bf16:
        fused_relu_mlp.launches_bf16 += 1
    else:
        fused_relu_mlp.launches += 1
    return out


fused_relu_mlp.launches = 0  # float32 kernel (K2)
fused_relu_mlp.launches_bf16 = 0  # bfloat16 kernel (K2-bf16)


def _row_sums(g, a):
    """(g^T a, sum of g's rows) in f32: a weight and a bias gradient."""
    return g.float().t() @ a.float(), g.float().sum(dim=0)


def _bf16_backward(x, g, w0, b0, wh, bh, wout, is_res):
    _, acts, masks = _bf16_forward(x, w0, b0, wh, bh, wout, None, is_res)
    g = g.to(BF16)
    dwout, dbout = _row_sums(g, acts[-1])
    g = _matmul_seq(g, wout.to(BF16)).to(BF16)
    dwh, dbh = [], []
    for i in range(wh.shape[0] - 1, -1, -1):
        gpre = g * masks[i + 1]
        dw, db = _row_sums(gpre, acts[i])
        dwh.append(dw)
        dbh.append(db)
        gnext = _matmul_seq(gpre, wh[i].to(BF16)).to(BF16)
        g = gnext + g if is_res else gnext
    gpre = g * masks[0]
    dw0, db0 = _row_sums(gpre, x.to(BF16))
    dx = _matmul_seq(gpre, w0.to(BF16)).to(BF16)
    return dx, dw0, db0, dwh, dbh, dwout, dbout


def _f32_backward(x, g, w0, b0, wh, bh, wout, is_res):
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
    return dx, dw0, db0, dwh, dbh, dwout, dbout


def fused_relu_mlp_bwd_plain(x, g, w0, b0, wh, bh, wout, is_res: bool = False,
                             compute_dtype=torch.float32):
    """The chain's backward as `_bwd_kernel` computes it: recompute the
    forward keeping each layer's input and ReLU mask, then backpropagate
    g [M,O]. -> (dx [M,C], dw0 [H,C], db0 [H], dwh [L1,H,H], dbh [L1,H],
    dwout [O,H], dbout [O]), the weight gradients summed over rows in f32;
    dx in `compute_dtype`."""
    bwd = (_bf16_backward if _compute_dtype("fused_relu_mlp_bwd_plain", compute_dtype) == BF16
           else _f32_backward)
    dx, dw0, db0, dwh, dbh, dwout, dbout = bwd(x, g, w0, b0, wh, bh, wout, is_res)
    H = w0.shape[0]
    dwh = torch.stack(dwh[::-1]) if dwh else dw0.new_zeros((0, H, H))
    dbh = torch.stack(dbh[::-1]) if dbh else dw0.new_zeros((0, H))
    return dx, dw0, db0, dwh, dbh, dwout, dbout


def fused_relu_mlp_bwd(x, g, w0, b0, wh, bh, wout, is_res: bool = False,
                       compute_dtype=torch.float32):
    """Same contract as `fused_relu_mlp_bwd_plain`. CPU tensors take the plain
    version; CUDA tensors launch K3 of `compute_dtype` and its reduction (x
    and g in it, weights and biases float32, all contiguous, L1 >= 0, null
    biases) or raise. Two launches on the same inputs give the same bits."""
    name = "fused_relu_mlp_bwd"
    compute_dtype = _compute_dtype(name, compute_dtype)
    if x.device.type == "cpu":
        return fused_relu_mlp_bwd_plain(x, g, w0, b0, wh, bh, wout, is_res, compute_dtype)
    tensors = dict(x=x, g=g, w0=w0, b0=b0, wh=wh, bh=bh, wout=wout)
    require_no_grad(name, **tensors)
    M, C, H, L1, O = _check_chain(name, tensors, compute_dtype)
    bf16 = compute_dtype == BF16
    n_grads = H * C + H + L1 * H * H + L1 * H + O * H + O
    dx = torch.empty((M, C), device=x.device, dtype=compute_dtype)
    # the reduction writes every entry; with no rows the sums are zero
    grads = (torch.empty if M > 0 else torch.zeros)((n_grads,), device=x.device,
                                                     dtype=torch.float32)
    if M > 0:
        lib = _build.lib()
        # scratch: floats (float32 kernel) or bytes (bfloat16 kernel)
        size = (lib.npf_mlp_chain_bwd_bf16_scratch if bf16
                else lib.npf_mlp_chain_bwd_scratch)(M, C, H, L1, O)
        if size < 0:
            raise ValueError(f"{name}: widths C={C}, H={H}, L1={L1}, O={O} exceed the "
                             f"{compute_dtype} kernel's shared memory")
        scratch = torch.empty((size,), device=x.device,
                              dtype=torch.uint8 if bf16 else torch.float32)
        launch = lib.npf_mlp_chain_bwd_bf16 if bf16 else lib.npf_mlp_chain_bwd
        err = launch(
            ptr(x), ptr(g), M, C, ptr(w0), ptr(b0), ptr(wh), ptr(bh), L1, H, ptr(wout), O,
            int(is_res), ptr(dx), ptr(grads), ptr(scratch),
            torch.cuda.current_stream().cuda_stream,
        )
        _build.check(err, name)
        if bf16:
            fused_relu_mlp_bwd.launches_bf16 += 1
        else:
            fused_relu_mlp_bwd.launches += 1
    sizes = (H * C, H, L1 * H * H, L1 * H, O * H, O)
    shapes = ((H, C), (H,), (L1, H, H), (L1, H), (O, H), (O,))
    return (dx, *(t.view(s) for t, s in zip(grads.split(sizes), shapes)))


fused_relu_mlp_bwd.launches = 0  # float32 kernel (K3)
fused_relu_mlp_bwd.launches_bf16 = 0  # bfloat16 kernel (K3-bf16)


class FusedReluMLPFn(torch.autograd.Function):
    """(x, w0, b0, wh, bh, wout, bout, is_res, compute_dtype) -> [M,O] in
    `compute_dtype` through K2 (its plain version on CPU tensors); backward
    through K3. x is in `compute_dtype`, the weights and biases float32
    parameters whose gradients are float32. Biases may be None and then get
    no gradient."""

    @staticmethod
    def forward(ctx, x, w0, b0, wh, bh, wout, bout, is_res, compute_dtype=torch.float32):
        ctx.save_for_backward(x, w0, b0, wh, bh, wout)
        ctx.is_res = is_res
        ctx.compute_dtype = compute_dtype
        ctx.has_bout = bout is not None
        return fused_relu_mlp(x, w0, b0, wh, bh, wout, bout, is_res, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w0, b0, wh, bh, wout = ctx.saved_tensors
        # g arrives strided when the caller split the output (loc / raw scale)
        dx, dw0, db0, dwh, dbh, dwout, dbout = fused_relu_mlp_bwd(
            x, g.contiguous(), w0, b0, wh, bh, wout, ctx.is_res, ctx.compute_dtype)
        return (dx, dw0, None if b0 is None else db0, dwh, None if bh is None else dbh, dwout,
                dbout if ctx.has_bout else None, None, None)
