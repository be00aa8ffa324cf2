"""What `chip_smoke.py` and `kernel_ab` share to measure the port's kernels on
the card: device time, the least time a kernel's work could take, and the
inputs of the kernels' cases.

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

import torch

from .utils.helpers import linspace

__all__ = ["PEAK_BYTES_PER_S", "PEAK_F32_FLOP_PER_S", "PEAK_BF16_TC_FLOP_PER_S", "time_ms", "bound", "k1_bound",
           "k2_bound", "k3_bound", "k1_inputs", "k2_inputs", "k3_inputs", "K2_CASES"]

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


def k1_inputs(B, K, Q, C, sigma, gen, empty_rows=(), path=True, max_real=None):
    """(keys, queries, values, mask, sigma) of one SetConv forward on the card:
    keys and queries on the flagship paths' grids when `path` (256 context
    points on [-1, 1], 384 grid points on [-1.5, 1.5]), else sorted random
    keys and random queries; U{0..max_real} real keys per row (default K;
    "all": every key, as the grid->targets SetConv's mask); the given rows
    empty."""
    dev = "cuda"
    if path:
        def grid(n):
            half = 1.0 if n == 256 else 1.5
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
