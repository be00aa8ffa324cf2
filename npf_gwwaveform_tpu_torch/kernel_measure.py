"""What `chip_smoke.py` and `kernel_ab` share to measure the port's kernels on
the card: device time, the least time a kernel's work could take, and the
inputs of the kernels' cases.

The bars of the bfloat16 kernels against their plain versions
(`k2_bf16_report`, `k3_bf16_report`) and the bf16 cuBLAS layer chain, a
yardstick of speed that the port never calls (`cublas_chain_ms`), are here
too, so that `chip_smoke.py`, `kernel_ab` and the CPU tests hold the kernels
to the same numbers.

The profilers and `chip_smoke.py` trace a step with the same helpers:
`measure_step` (host-clock wall times and one `torch.profiler` trace),
`event_ms`, `top_kernels`, and `traced_launches`, which counts each hand
kernel's wrapper launches in a trace by the kernels `ops.kernels.KERNELS`
names.

`bound` is the larger of two times: the bytes that the function must move
(each input read once, each output written once) over the card's memory
rate, and the operations that it does over the card's peak rate for their
type (the H100 SXM's published dense peaks): float32 outside tensor cores,
or for the bfloat16 chain the bf16 tensor cores' rate, the least time the
card could take for bf16 products summed in f32. `k1_bound`, `k2_bound` and
`k3_bound` count both for one call of a kernel on its inputs, in the dtype
of its rows (x and g): 2 bytes an element in bfloat16, 4 in float32; the
weights and biases are read, and dW/db written, as float32 parameters.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .ops.kernels import KERNELS, hand_kernel_id
from .ops.kernels.mlp_chain import _bf16_forward
from .utils.helpers import linspace

__all__ = ["PEAK_BYTES_PER_S", "PEAK_F32_FLOP_PER_S", "PEAK_BF16_TC_FLOP_PER_S", "time_ms", "bound",
           "k1_bound", "k2_bound", "k3_bound", "k1_inputs", "k2_inputs", "k3_inputs", "K2_CASES",
           "K2_BF16_SUM_TOL", "K2_BF16_MAX_SHARE", "K3_BF16_DX_ULPS", "K3_BF16_DX_SHARE",
           "K3_BF16_DW_RTOL", "bf16_ulp", "ulp_report", "k2_bf16_sum_scale", "k2_bf16_compare",
           "k2_bf16_report", "k2_bf16_ok", "k3_bf16_report", "k3_bf16_ok", "cublas_chain_ms",
           "measure_step", "event_ms", "top_kernels", "hand_kernels", "traced_launches"]

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_TC_FLOP_PER_S = 989e12


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one fn() call: reps calls captured in one CUDA
    graph and replayed between CUDA events, so that the host's launch
    overhead (tens of microseconds a wrapper call, more than some kernels
    take) is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_ops: float, flop_per_s: float = PEAK_F32_FLOP_PER_S):
    """The least time (ms) for the work, and what sets it: "bytes" or
    "operations"."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(keys, queries, values, mask):
    """The SetConv forward: reads keys, mask, queries and values, writes the
    signal and the density; 2C + 10 operations per (query, real key) pair
    (the distance, the logit, its exponential, the weight sum and C
    multiply-adds), counted on this mask."""
    B, K = keys.shape
    Q, C = queries.shape[1], values.shape[-1]
    n_bytes = 4 * (2 * B * K + B * Q + B * K * C + B * Q * C + B * Q)
    return bound(n_bytes, mask.sum().item() * Q * (2 * C + 10))


def _rate(x):
    """(bytes an element of x, peak operations a second) of x's dtype."""
    return (2, PEAK_BF16_TC_FLOP_PER_S) if x.dtype == torch.bfloat16 else (4, PEAK_F32_FLOP_PER_S)


def k2_bound(x, w0, b0, wh, bh, wout, bout):
    """The MLP chain forward: reads x and the weights, writes the output;
    two operations per multiply-add."""
    M, C = x.shape
    H, L1, O = w0.shape[0], wh.shape[0], wout.shape[0]
    n_in = sum(t.numel() for t in (w0, b0, wh, bh, wout, bout) if t is not None)
    row_bytes, flops = _rate(x)
    return bound(row_bytes * (M * C + M * O) + 4 * n_in,
                 2 * M * (C * H + L1 * H * H + H * O), flops)


def k3_bound(x, g, w0, b0, wh, bh, wout):
    """The MLP chain backward: reads x, g and the weights, writes dx and every
    gradient; the forward recompute of the hidden chain, then the input and
    the weight gradient of every layer, two operations per multiply-add."""
    M, C = x.shape
    H, L1, O = w0.shape[0], wh.shape[0], wout.shape[0]
    n_w = H * C + L1 * H * H + O * H
    n_params = n_w + H + L1 * H + O
    row_bytes, flops = _rate(x)
    n_bytes = (row_bytes * (2 * M * C + M * O)
               + 4 * (n_w + H * (b0 is not None) + L1 * H * (bh is not None) + n_params))
    return bound(n_bytes, 2 * M * (C * H + L1 * H * H) + 4 * M * n_w, flops)


def k1_inputs(B, K, Q, C, sigma, gen, empty_rows=(), path=True, max_real=None,
              n_points=256):
    """(keys, queries, values, mask, sigma) of one SetConv forward on the card:
    keys and queries on a scoring path's grids when `path` (`n_points`
    context points on [-1, 1]: 256 on the flagship path, 2048 on the long
    waveforms'; any other size is the induced grid on [-1.5, 1.5]), else
    sorted random keys and random queries; U{0..max_real} real keys per row
    (default K; "all": every key, as the grid->targets SetConv's mask); the
    given rows empty."""
    dev = "cuda"
    if path:
        def grid(n):
            half = 1.0 if n == n_points else 1.5
            return linspace(-half, half, n, device=dev)[None].expand(B, n).contiguous()
        keys, queries = grid(K), grid(Q)
    else:
        keys = torch.sort(torch.rand((B, K), generator=gen, device=dev) * 2 - 1, dim=-1).values
        queries = torch.rand((B, Q), generator=gen, device=dev) * 3 - 1.5
    values = torch.randn((B, K, C), generator=gen, device=dev)
    if max_real == "all":
        mask = torch.ones((B, K), device=dev)
    else:
        n_real = torch.randint(0, (max_real or K) + 1, (B, 1), generator=gen, device=dev)
        scores = torch.rand((B, K), generator=gen, device=dev)
        mask = (scores.argsort(dim=-1).argsort(dim=-1) < n_real).float()
    mask[list(empty_rows)] = 0.0
    return keys, queries, values, mask, torch.full((1,), sigma, device=dev)


def _random_weights(C, H, L1, O, biases, gen, with_bout=True):
    """(w0, b0, wh, bh, wout[, bout]) scaled by their fan in, on the card;
    biases None unless `biases`."""
    def w(*shape):
        return torch.randn(shape, generator=gen, device="cuda") / shape[-1] ** 0.5
    ws = (w(H, C), w(H) if biases else None, w(L1, H, H), w(L1, H) if biases else None, w(O, H))
    return (*ws, w(O) if biases else None) if with_bout else ws


# K2's cases off the flagship paths, with random weights: (name, M, C, H,
# L1, O, is_res, biases). Past the first two, the edges of the kernel's
# design (csrc/mlp_chain_fwd.cu): each block kind, one and two activation
# buffers, O on each side of the small-O output, and the wide kernel.
K2_CASES = (
    ("residual", 4099, 37, 64, 2, 5, True, False),
    ("no-hidden", 1000, 128, 128, 0, 3, False, True),
    ("C > H no-bias", 1500, 200, 96, 1, 2, False, False),
    ("wide", 3001, 200, 256, 2, 3, False, True),
    ("wide residual", 3001, 200, 320, 2, 3, True, True),
    ("small-O edge", 2049, 128, 128, 1, 8, False, True),
    ("tiled-O edge", 2049, 128, 128, 1, 9, True, True),
    ("128-row tiles, two-pass O", 20001, 64, 96, 2, 130, True, True),
    ("128-row tiles, two buffers", 20001, 96, 144, 2, 3, True, True),
    ("wide kernel, 32 rows", 300, 800, 700, 1, 2, False, True),
    ("wide kernel, 16 rows", 300, 1600, 1600, 1, 2, True, True),
)


def k2_inputs(M, C, H, L1, O, biases, gen, weights=None, dtype=torch.float32):
    """(x, w0, b0, wh, bh, wout, bout) of one MLP chain forward on the card:
    random x in `dtype`, and the given weights or random ones scaled by their
    fan in (biases None unless `biases`)."""
    x = torch.randn((M, C), generator=gen, device="cuda").to(dtype)
    return (x, *(weights if weights is not None else _random_weights(C, H, L1, O, biases, gen)))


def k3_inputs(M, C, H, L1, O, biases, gen, weights=None, dtype=torch.float32):
    """(x, g, w0, b0, wh, bh, wout) of one MLP chain backward on the card:
    random x and g in `dtype`, and the given weights or random ones scaled by
    their fan in (biases None unless `biases`)."""
    x = torch.randn((M, C), generator=gen, device="cuda").to(dtype)
    g = torch.randn((M, O), generator=gen, device="cuda").to(dtype)
    if weights is None:
        weights = _random_weights(C, H, L1, O, biases, gen, with_bout=False)
    return (x, g, *weights)


# The bfloat16 kernels against their plain versions. The tensor cores add
# the same exact bf16 products as the plain version (`_matmul_seq`, feature
# by feature), in another order (csrc/mlp_chain_bf16.cuh), so a sum that lies
# at a bf16 rounding boundary rounds one ulp the other way, and a hidden
# unit that moves carries the move to the later layers.
#
# K2-bf16: every output element within 2^-6 s of the plain version's, s its
# absolute product sum |a_L1| |wout|^T + |bout| from the plain version's last
# activations (bf16 weights): two bf16 ulps of the largest sum the element
# could round from, room for a one-ulp move in the hidden units and one in
# the final rounding. At most 1% of the elements may differ. A scale of the
# element's own magnitude or of its row's largest would be loose for the
# small `loc` beside a large raw scale in the same row, or tight where the
# output cancels to near zero; the absolute sum is neither.
K2_BF16_SUM_TOL, K2_BF16_MAX_SHARE = 2.0 ** -6, 0.01
# K3-bf16: dx within two bf16 ulps of its row's largest magnitude, at most
# 2% of its elements differing (a moved rounding in a g feeds every element
# of the row, and an element whose sum cancels moves by many of its own
# ulps); dW/db within 1e-2 of each gradient's max magnitude (f32 row sums of
# rounded activations and masked gradients, each of which may sit one ulp,
# 2^-8 of itself, apart). The bars the plain version meets against the JAX
# package's Pallas kernel (tests/test_torch_bf16_kernels.py).
K3_BF16_DX_ULPS, K3_BF16_DX_SHARE, K3_BF16_DW_RTOL = 2, 0.02, 1e-2
_K3_NAMES = ("dx", "dw0", "db0", "dwh", "dbh", "dwout", "dbout")


def bf16_ulp(v):
    """One bf16 ulp at |v|: 2^(e - 7) for |v| in [2^e, 2^(e+1))."""
    e = torch.floor(torch.log2(v.abs().clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.exp2(e - 7)


def ulp_report(a, b, per_row=False):
    """(largest |a - b| in bf16 ulps of the larger magnitude, or of the row's
    largest with `per_row`; share of elements that differ)."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    if not diff.numel():
        return 0.0, 0.0
    scale = torch.maximum(a.abs(), b.abs())
    if per_row:
        scale = scale.amax(dim=-1, keepdim=True)
    return (diff / bf16_ulp(scale)).max().item(), (diff > 0).float().mean().item()


def k2_bf16_sum_scale(a_last, wout, bout):
    """s = |a_L1| |wout|^T + |bout|, each element's absolute product sum,
    with the weights rounded to bf16 as the kernel uses them."""
    s = a_last.float().abs() @ wout.to(torch.bfloat16).float().abs().t()
    return s if bout is None else s + bout.to(torch.bfloat16).float().abs()


def k2_bf16_compare(out, ref, s):
    """(largest |out - ref| / s, the share of elements that differ)."""
    diff = (out.float() - ref.float()).abs()
    if not diff.numel():
        return 0.0, 0.0
    rel = torch.where(diff > 0, diff / s.to(diff.device).clamp_min(torch.finfo(torch.float32).tiny),
                      torch.zeros_like(diff))
    return rel.max().item(), (diff > 0).float().mean().item()


def k2_bf16_report(out, x, w0, b0, wh, bh, wout, bout, is_res=False):
    """K2-bf16's output against the plain version on the same inputs:
    `k2_bf16_compare` with s from the plain version's last activations."""
    ref, acts, _ = _bf16_forward(x, w0, b0, wh, bh, wout, bout, is_res)
    return k2_bf16_compare(out, ref, k2_bf16_sum_scale(acts[-1], wout, bout))


def k2_bf16_ok(report) -> bool:
    rel, share = report
    return rel <= K2_BF16_SUM_TOL and share <= K2_BF16_MAX_SHARE


def k3_bf16_report(out, ref):
    """K3-bf16's (dx, dw0, db0, dwh, dbh, dwout, dbout) against the plain
    version's -> dict: dx_ulps (of its row's largest magnitude), dx_share
    (differing), dw_rel (the worst dW/db error over its max magnitude) and
    dw_worst (its name)."""
    ulps, share = ulp_report(out[0], ref[0], per_row=True)
    rel = {n: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
           for n, a, b in zip(_K3_NAMES[1:], out[1:], ref[1:]) if b.numel()}
    worst = max(rel, key=rel.get)
    return dict(dx_ulps=ulps, dx_share=share, dw_rel=rel[worst], dw_worst=worst)


def k3_bf16_ok(report) -> bool:
    return (report["dx_ulps"] <= K3_BF16_DX_ULPS and report["dx_share"] <= K3_BF16_DX_SHARE
            and report["dw_rel"] <= K3_BF16_DW_RTOL)


def _chain(x, w0, b0, whs, bhs, wout, bout, is_res):
    a = torch.relu(F.linear(x, w0, b0))
    for w, b in zip(whs, bhs):
        r = torch.relu(F.linear(a, w, b))
        a = r + a if is_res else r
    return F.linear(a, wout, bout)


def cublas_chain_ms(x, w0, b0, wh, bh, wout, bout=None, is_res=False, g=None, reps=20):
    """Device ms of the bf16 layer chain on cuBLAS, the yardstick of the bf16
    kernels (the port never calls it): `F.linear` in bf16 with the ReLU and
    the residual, each layer's weights pre-cast to separate bf16 tensors
    (not timed); with the cotangent `g`, the forward and its autograd
    backward to dx and every weight and bias gradient (K3-bf16's work),
    else the forward alone (K2-bf16's). `time_ms`'s CUDA-graph replay."""
    def cast(t):
        return None if t is None else t.detach().to(torch.bfloat16).clone()

    with torch.inference_mode(False), torch.enable_grad():
        x, w0, b0, wout, bout = (cast(t) for t in (x, w0, b0, wout, bout))
        whs = [cast(w) for w in wh]
        bhs = [None] * len(whs) if bh is None else [cast(b) for b in bh]
        if g is None:
            with torch.no_grad():
                return time_ms(lambda: _chain(x, w0, b0, whs, bhs, wout, bout, is_res), reps)
        leaves = [t for t in (x, w0, b0, *whs, *bhs, wout) if t is not None]
        for t in leaves:
            t.requires_grad_()
        g = cast(g)
        return time_ms(lambda: torch.autograd.grad(
            _chain(x, w0, b0, whs, bhs, wout, bout, is_res), leaves, g), reps)


def measure_step(fn, reps: int) -> dict:
    """fn() (ending in a synchronise) timed `reps` times on the host clock,
    then once traced: wall times, the traced kernels and their device time."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        traced_wall = time.perf_counter() - t0
    # the profiler mirrors each record_function range (ours and the
    # optimizer's) as a device-side annotation spanning its kernels: not a kernel
    ranges = {e.key for e in prof.key_averages() if e.device_type == DeviceType.CPU}
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0 and e.key not in ranges]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    wall_ms = 1e3 * float(np.median(walls))
    return dict(wall_ms=wall_ms, reps=reps, traced_wall_ms=1e3 * traced_wall,
                device_ms=device_ms, busy_share=device_ms / (1e3 * traced_wall),
                busy_share_untraced=device_ms / wall_ms, n_launches=sum(e.count for e in kernels),
                n_kernels=len(kernels), kernels=kernels, events=prof.events())


def event_ms(fn) -> float:
    """Device time from one CUDA event to the next around fn()."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def top_kernels(kernels, device_ms: float, n: int) -> list:
    """The first `n` of a trace's kernels (`measure_step`'s, sorted): name,
    device ms, calls and share of `device_ms`."""
    return [dict(name=e.key[:120], device_ms=e.self_device_time_total / 1e3, calls=e.count,
                 share=e.self_device_time_total / 1e3 / device_ms if device_ms else 0.0)
            for e in kernels[:n]]


def hand_kernels(kernels) -> list:
    """The hand kernels among a trace's kernels: name, device ms, calls."""
    return [dict(name=e.key[:120], device_ms=e.self_device_time_total / 1e3, calls=e.count)
            for e in kernels if hand_kernel_id(e.key) is not None]


def traced_launches(prof) -> tuple:
    """Each wrapper's launches among a `torch.profiler` trace's kernels, in
    `KERNELS`' order: the calls of the kernels that mark its launches."""
    n = dict.fromkeys(KERNELS, 0)
    for e in prof.key_averages():
        kid = hand_kernel_id(e.key, marks_only=True) if e.device_type == DeviceType.CUDA else None
        if kid is not None:
            n[kid] += e.count
    return tuple(n.values())
