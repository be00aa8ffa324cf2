#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`npf_gwwaveform_tpu_torch`) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each announced with the seconds elapsed:
  1. device: the card's name and power limit, torch and nvcc versions;
  2. build: the kernels with one nvcc call (ptxas resource report);
  3. K1 (SetConv forward) against its plain version at the two path shapes of
     the scoring batch and of the train step, with the paths' own masks
     (U{0..192} of 256 context points real, every grid point real), and at
     three other cases: random masks at the grid->targets shape, K = 5000
     keys, and the long-waveform width C = 512 (K = 2048, Q = 1536); two
     launches must give the same bits;
  4. K2 (fused MLP chain forward) against its plain version at the scoring
     and training decoder shapes, and at the edges of its design: L1=0, a
     ragged residual chain with C != H and no biases, C > H, widths over 128
     (H = 256, and 320 with the residual), O on each side of the small-O
     output (8 and 9), 128-row tiles with a two-pass output and with two
     activation buffers, and widths served by the wide kernel; two launches
     must give the same bits;
  5. K3 (fused MLP chain backward) against its plain version at the training
     and scoring shapes, with L1=0 and no biases, at a ragged row count, and
     at widths over 128 (H = 256 and 320, L1 = 2, with and without the
     residual); two launches must give the same bits;
  6. autograd through the kernels against the plain modules at the training
     shapes: a SetConv through K1 and the decoder MLP through K2 and K3;
  7. the scoring path: score the 2048 thetas recorded in the flagship run
     `results/GW_time_cond_film_ctx192_d128/ConvCNP/run_1` through K1 and K2,
     check the launch counts and the quality bands, then compare one batch
     with the plain path;
  8. the training path: train the flagship configuration from the port's
     init for 500 steps at batch 32 (`train_gw.run`, into a temporary
     directory), check the launch counts, that the loss falls, a kernel-path
     train step against a plain-path one, and that the written run reloads;
  9. K2-bf16 (the chain forward in bfloat16 compute) against its plain
     version at the scoring and training decoder shapes with the run's
     weights and at K2's edge cases (the two widths past its shared memory
     must be refused before any launch), and K3-bf16 against its plain
     version at K3's cases, each case with the kernel its plan takes (the
     decoder shapes must take the tensor cores) and the bf16 cuBLAS layer
     chain's time beside the kernel's at the decoder shapes; each pair must
     meet the bars of `kernel_measure.py`, and two launches must give the
     same bits;
 10. the bf16 scoring path: score the same 2048 thetas in bfloat16 compute
     with the same context draws, check the launch counts (no float32 K2 or
     K3), the quality bands and the gap to the float32 score, then one batch
     of the kernel path against the same path with every kernel replaced by
     its plain version;
 11. the bf16 training path: 500 steps at batch 32 from seed 0 in bfloat16
     compute, the launch counts, that the loss falls, and one step of the
     kernel path against the plain-kernel path.
It ends with a JSON line of per-kernel numbers and the JSON result line.
Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from npf_gwwaveform_tpu_torch import _build
from npf_gwwaveform_tpu_torch import train_gw
from npf_gwwaveform_tpu_torch.configs import gw_train_summary
from npf_gwwaveform_tpu_torch.data.gw import GWParameterSpace
from npf_gwwaveform_tpu_torch.kernel_measure import (
    K2_BF16_SUM_TOL, K2_CASES, cublas_chain_ms, k1_bound, k1_inputs, k2_bf16_ok, k2_bf16_report,
    k2_bound, k2_inputs, k3_bf16_ok, k3_bf16_report, k3_bound, k3_inputs, time_ms,
)
from npf_gwwaveform_tpu_torch.ops.kernels import mlp_chain, setconv
from npf_gwwaveform_tpu_torch.ops.kernels.mlp_chain import (
    fused_relu_mlp, fused_relu_mlp_bwd, fused_relu_mlp_bwd_plain, fused_relu_mlp_plain,
)
from npf_gwwaveform_tpu_torch.ops.kernels.setconv import setconv_exprbf_fwd, setconv_exprbf_plain
from npf_gwwaveform_tpu_torch.score import (
    eval_splitter, load_model, make_eval_batch, read_run_thetas, run_generator, score_batch,
    score_run,
)
from npf_gwwaveform_tpu_torch.utils.helpers import linspace, set_numerics

RUN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results", "GW_time_cond_film_ctx192_d128", "ConvCNP", "run_1")
N_TEST = 2048
# the recorded run scored mean LL 895.10 and median mismatch 0.00218 on these
# thetas; bootstrap 99% intervals at 1024 waveforms are [887.6, 901.8] and
# [0.00169, 0.00267], and only the context draws differ from that run
LL_BAND = (885.0, 905.0)
MISMATCH_BAND = (0.0016, 0.0030)
PATH_TOL = 5e-4  # loc/scale, kernel path vs plain path
K1_SIGNAL_ATOL = 1e-5
K1_DENSITY_RTOL = 1e-5
K2_RTOL = 1e-4  # of the output's max magnitude
# K3: each output (dx and every dW/db) against its max magnitude; f32 sums
# over up to 65,536 rows in another order than the plain version's
K3_RTOL = 1e-4
# autograd through the kernels vs the plain modules, per gradient against its
# max magnitude: the kernels sum in other orders and K1 uses |d| where the
# plain SetConv uses sqrt(d^2 + 1e-12)
GRAD_RTOL = 1e-4
# one train step, kernel path vs plain path on identical parameters and batch:
# loss relative, each parameter's gradient against its max magnitude (cuDNN's
# conv backward sums in no fixed order by default; the kernels sum in other
# orders than the plain path; train-mode BatchNorm magnifies both in its
# biases' gradients)
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_RTOL = 1e-3
TRAIN_STEPS, TRAIN_BATCH = 500, 32
# the loss must fall: the median per-step loss over steps 251-500 at least 300
# nats below the median over steps 1-50. Whether it is also below 0 (as in the
# recorded JAX run, whose 50-step means over steps 251-500 are -53 to -257) is
# printed, not required: that depends on the initial draw, in the JAX package
# as in the port (PERF.md: of three JAX initial draws and of ten port draws on
# the H100, only some get there by step 500; the port's train step equals the
# JAX step to float32 rounding on identical batches).
LOSS_FALL_NATS = 300.0

BF16 = torch.bfloat16
# K2-bf16 and K3-bf16 against their plain versions: the bars of
# kernel_measure.py (K2_BF16_*, K3_BF16_*), which admit any order of the sums
# (tests/test_torch_bf16_order.py). K2-bf16: every output within 2^-6 of its
# absolute product sum, at most 1% differing. K3-bf16: dx within two bf16
# ulps of its row's largest magnitude, at most 2% differing; dW/db within
# 1e-2 of each one's max magnitude. The kernels sum on the tensor cores and
# again in the plain order where their sum leaves a rounding undecided, so
# they are expected to round as the plain version does (dW/db excepted: f32
# row sums in the tensor cores' order); the differences are printed.
PATH_NAMES = {1: "tensor cores", 2: "f32 FMA", -1: "refused"}
# bf16 scoring of the 2048 thetas against the float32 scoring with the same
# context draws, from the JAX package on the CPU (tests/jax_bf16_score_gap.py,
# op-by-op bf16, fused decoder): JAX's bf16 mean LL sits 0.576 nats below its
# float32 one, per-waveform differences with a standard deviation of 2.38
# (0.053 for a mean of 2048); its median mismatch moved by 1.4e-5. The port's
# gap must lie within 0.3 nats (5.7 of those standard errors) of JAX's, and
# its median mismatch move within 2e-4 (9% of the median, three times the
# largest move seen: 6.9e-5, the port's own bf16 against float32 on the CPU)
BF16_D_MEAN_LL, BF16_D_MEAN_LL_TOL = -0.576, 0.3
BF16_D_MEDIAN_MISMATCH = 2e-4
# the bf16 kernel path against the same path with every kernel replaced by
# its plain version, measured against the bf16-vs-float32 gap of the same
# batch, the bars of tests/test_torch_bf16_slice.py: the RMS distance of loc
# at most half the gap's RMS, the largest at most 3/4 of the gap's largest.
# K2-bf16 rounds as its plain version does (it sums again in the plain order
# where its tensor-core sums leave a rounding undecided); K1 and its plain
# version differ at float32 rounding, which moves a few bf16 roundings after
# it
BF16_PATH_RMS, BF16_PATH_MAX = 0.5, 0.75
# one bf16 train step, kernel path against the plain-kernel path: the bars
# of tests/test_torch_bf16_train.py (loss 1e-3 relative; each gradient 1e-1
# of its max magnitude)
BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_RTOL = 1e-3, 1e-1

_T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (t={time.perf_counter() - _T0:.1f}s)", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def check_k1(cases):
    rows = []
    for name, args in cases:
        keys, queries, values, mask, sig = args
        B, K = keys.shape
        Q, C = queries.shape[1], values.shape[-1]
        s_k, d_k = setconv_exprbf_fwd(*args)
        s_k2, d_k2 = setconv_exprbf_fwd(*args)
        s_p, d_p = setconv_exprbf_plain(*args)
        torch.cuda.synchronize()
        same = torch.equal(s_k, s_k2) and torch.equal(d_k, d_k2)
        sig_err = (s_k - s_p).abs().max().item()
        den_rel = ((d_k - d_p).abs() / (d_p.abs() + 1e-30)).max().item()
        empty = mask.sum(-1) == 0
        empty_ok = bool((s_k[empty] == 0).all() and (d_k[empty] == 0).all()) if empty.any() else True
        finite = bool(torch.isfinite(s_k).all() and torch.isfinite(d_k).all())
        print(f"K1 {name}: B={B} K={K} Q={Q} C={C} signal max abs err {sig_err:.3e}, "
              f"density max rel err {den_rel:.3e}, empty rows zero {empty_ok}; repeat "
              f"bit-identical {same}")
        if not (finite and empty_ok and sig_err <= K1_SIGNAL_ATOL and den_rel <= K1_DENSITY_RTOL):
            raise AssertionError(f"K1 {name} disagrees with its plain version")
        if not same:
            raise AssertionError(f"K1 {name}: two launches on the same inputs differ")
        ms = time_ms(lambda: setconv_exprbf_fwd(*args))
        plain_ms = time_ms(lambda: setconv_exprbf_plain(*args), reps=5)
        bms, by = k1_bound(keys, queries, values, mask)
        rows.append(dict(shape=name, B=B, K=K, Q=Q, C=C, max_abs_err=sig_err,
                         density_max_rel_err=den_rel, ms=ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by))
        print(f"   kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return rows


def check_k2(cases):
    rows = []
    for name, args, is_res in cases:
        x, w0, _, wh, _, wout, _ = args
        M, C = x.shape
        H, L1, O = w0.shape[0], wh.shape[0], wout.shape[0]
        o_k = fused_relu_mlp(*args, is_res=is_res)
        o_k2 = fused_relu_mlp(*args, is_res=is_res)
        o_p = fused_relu_mlp_plain(*args, is_res=is_res)
        torch.cuda.synchronize()
        same = torch.equal(o_k, o_k2)
        err = (o_k - o_p).abs().max().item()
        scale = o_p.abs().max().item()
        finite = bool(torch.isfinite(o_k).all())
        print(f"K2 {name}: M={M} C={C} H={H} L1={L1} O={O} res={is_res} "
              f"max abs err {err:.3e} (output max {scale:.3e}); repeat bit-identical {same}")
        if not (finite and err <= K2_RTOL * scale):
            raise AssertionError(f"K2 {name} disagrees with its plain version")
        if not same:
            raise AssertionError(f"K2 {name}: two launches on the same inputs differ")
        ms = time_ms(lambda: fused_relu_mlp(*args, is_res=is_res))
        plain_ms = time_ms(lambda: fused_relu_mlp_plain(*args, is_res=is_res))
        bms, by = k2_bound(*args)
        rows.append(dict(shape=name, M=M, C=C, H=H, L1=L1, O=O, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by))
        print(f"   kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return rows


def check_k3(cases):
    rows = []
    names = ("dx", "dw0", "db0", "dwh", "dbh", "dwout", "dbout")
    for name, args, is_res in cases:
        x, g, w0, b0, wh, bh, wout = args
        M, C = x.shape
        H, L1, O = w0.shape[0], wh.shape[0], wout.shape[0]
        out_k = fused_relu_mlp_bwd(*args, is_res=is_res)
        out_k2 = fused_relu_mlp_bwd(*args, is_res=is_res)
        out_p = fused_relu_mlp_bwd_plain(*args, is_res=is_res)
        torch.cuda.synchronize()
        rel = {}
        for n, a, b in zip(names, out_k, out_p):
            if b.numel():
                rel[n] = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        same = all(torch.equal(a, b) for a, b in zip(out_k, out_k2))
        finite = all(bool(torch.isfinite(t).all()) for t in out_k)
        worst = max(rel, key=rel.get)
        print(f"K3 {name}: M={M} C={C} H={H} L1={L1} O={O} res={is_res} biases={b0 is not None} "
              f"max err / max magnitude {rel[worst]:.3e} ({worst}); repeat bit-identical {same}")
        if not (finite and same and rel[worst] <= K3_RTOL):
            raise AssertionError(f"K3 {name} disagrees with its plain version or is not repeatable")
        ms = time_ms(lambda: fused_relu_mlp_bwd(*args, is_res=is_res))
        plain_ms = time_ms(lambda: fused_relu_mlp_bwd_plain(*args, is_res=is_res))
        bms, by = k3_bound(*args)
        rows.append(dict(shape=name, M=M, C=C, H=H, L1=L1, O=O, max_abs_err=rel[worst], ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by))
        print(f"   kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return rows


@contextlib.contextmanager
def plain_kernels():
    """Inside, the autograd Functions reach each kernel's plain version in
    place of its wrapper (on CUDA tensors too): the reference path of the
    kernel-path checks, at the kernels' own rounding points."""
    saved = (setconv.setconv_exprbf_fwd, mlp_chain.fused_relu_mlp, mlp_chain.fused_relu_mlp_bwd)
    setconv.setconv_exprbf_fwd = setconv.setconv_exprbf_plain
    mlp_chain.fused_relu_mlp = mlp_chain.fused_relu_mlp_plain
    mlp_chain.fused_relu_mlp_bwd = mlp_chain.fused_relu_mlp_bwd_plain
    try:
        yield
    finally:
        setconv.setconv_exprbf_fwd, mlp_chain.fused_relu_mlp, mlp_chain.fused_relu_mlp_bwd = saved


def reset_counts():
    setconv_exprbf_fwd.launches = 0
    for fn in (fused_relu_mlp, fused_relu_mlp_bwd):
        fn.launches = fn.launches_bf16 = 0


def counts():
    """(K1, K2, K3, K2-bf16, K3-bf16) launches since `reset_counts`."""
    return (setconv_exprbf_fwd.launches, fused_relu_mlp.launches, fused_relu_mlp_bwd.launches,
            fused_relu_mlp.launches_bf16, fused_relu_mlp_bwd.launches_bf16)


def check_k2_bf16(cases):
    rows = []
    for name, args, is_res in cases:
        x, w0, _, wh, _, wout, _ = args
        M, C = x.shape
        H, L1, O = w0.shape[0], wh.shape[0], wout.shape[0]
        call = lambda: fused_relu_mlp(*args, is_res=is_res, compute_dtype=BF16)  # noqa: E731
        path = _build.lib().npf_mlp_chain_fwd_bf16_path(M, C, H, L1, O)
        if name.startswith("decoder") and path != 1:
            raise AssertionError(f"K2-bf16 {name}: the decoder's shape takes the "
                                 f"{PATH_NAMES[path]} path, not the tensor cores")
        if path < 0:
            before = fused_relu_mlp.launches_bf16
            try:
                call()
            except ValueError as e:
                print(f"K2-bf16 {name}: M={M} C={C} H={H}: refused before any launch ({e})")
            else:
                raise AssertionError(f"K2-bf16 {name}: widths past its shared memory not refused")
            if fused_relu_mlp.launches_bf16 != before:
                raise AssertionError(f"K2-bf16 {name}: a refused call launched")
            continue
        o_k, o_k2 = call(), call()
        torch.cuda.synchronize()
        same = torch.equal(o_k, o_k2)
        rel, share = k2_bf16_report(o_k, *args, is_res=is_res)
        o_p = fused_relu_mlp_plain(*args, is_res=is_res, compute_dtype=BF16)
        err = (o_k.float() - o_p.float()).abs().max().item()
        finite = bool(torch.isfinite(o_k.float()).all()) and o_k.dtype == BF16
        print(f"K2-bf16 {name}: M={M} C={C} H={H} L1={L1} O={O} res={is_res} path "
              f"{PATH_NAMES[path]}: max |err| / s {rel:.3e} (bar {K2_BF16_SUM_TOL:.3e}), "
              f"{share:.2e} of elements differ; repeat bit-identical {same}")
        if not (finite and k2_bf16_ok((rel, share))):
            raise AssertionError(f"K2-bf16 {name} disagrees with its plain version")
        if not same:
            raise AssertionError(f"K2-bf16 {name}: two launches on the same inputs differ")
        ms = time_ms(call)
        plain_ms = time_ms(lambda: fused_relu_mlp_plain(*args, is_res=is_res, compute_dtype=BF16),
                           reps=2, warmup=1)
        cublas_ms = cublas_chain_ms(*args, is_res=is_res) if name.startswith("decoder") else None
        bms, by = k2_bound(*args)
        rows.append(dict(shape=name, M=M, C=C, H=H, L1=L1, O=O, path=PATH_NAMES[path],
                         max_abs_err=err, max_rel_sum=rel, share_differing=share, ms=ms,
                         plain_ms=plain_ms, cublas_chain_ms=cublas_ms, bound_ms=bms,
                         bound_by=by))
        print(f"   kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})"
              + (f", bf16 cuBLAS chain {cublas_ms:.4f} ms" if cublas_ms is not None else ""))
    return rows


def check_k3_bf16(cases):
    rows = []
    for name, args, is_res in cases:
        x, g, w0, b0, wh, bh, wout = args
        M, C = x.shape
        H, L1, O = w0.shape[0], wh.shape[0], wout.shape[0]
        call = lambda: fused_relu_mlp_bwd(*args, is_res=is_res, compute_dtype=BF16)  # noqa: E731
        path = _build.lib().npf_mlp_chain_bwd_bf16_path(M, C, H, L1, O)
        if name.startswith("decoder") and path != 1:
            raise AssertionError(f"K3-bf16 {name}: the decoder's shape takes the "
                                 f"{PATH_NAMES[path]} path, not the tensor cores")
        out_k, out_k2 = call(), call()
        out_p = fused_relu_mlp_bwd_plain(*args, is_res=is_res, compute_dtype=BF16)
        torch.cuda.synchronize()
        rep = k3_bf16_report(out_k, out_p)
        same = all(torch.equal(a, b) for a, b in zip(out_k, out_k2))
        finite = all(bool(torch.isfinite(t.float()).all()) for t in out_k)
        print(f"K3-bf16 {name}: M={M} C={C} H={H} L1={L1} O={O} res={is_res} biases="
              f"{b0 is not None} path {PATH_NAMES[path]}: dx max {rep['dx_ulps']:.2f} ulps of "
              f"its row's max, {rep['dx_share']:.2e} of elements differ; dW/db worst "
              f"{rep['dw_rel']:.3e} ({rep['dw_worst']}); repeat bit-identical {same}")
        if not (finite and same and out_k[0].dtype == BF16 and k3_bf16_ok(rep)):
            raise AssertionError(f"K3-bf16 {name} disagrees with its plain version or is not "
                                 "repeatable")
        ms = time_ms(call)
        plain_ms = time_ms(lambda: fused_relu_mlp_bwd_plain(*args, is_res=is_res,
                                                            compute_dtype=BF16),
                           reps=2, warmup=1)
        cublas_ms = (cublas_chain_ms(x, w0, b0, wh, bh, wout, None, is_res, g=g)
                     if name.startswith("decoder") else None)
        bms, by = k3_bound(*args)
        rows.append(dict(shape=name, M=M, C=C, H=H, L1=L1, O=O, path=PATH_NAMES[path],
                         max_abs_err=rep["dw_rel"], dx_max_ulps=rep["dx_ulps"],
                         dx_share_differing=rep["dx_share"], ms=ms, plain_ms=plain_ms,
                         cublas_chain_ms=cublas_ms, bound_ms=bms, bound_by=by))
        print(f"   kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})"
              + (f", bf16 cuBLAS chain {cublas_ms:.4f} ms" if cublas_ms is not None else ""))
    return rows


def _grad_errs(pairs):
    """{name: max |a - b| / max |b|} over pairs of gradients."""
    return {n: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
            for n, a, b in pairs}


def check_autograd(model, gen):
    """A SetConv through K1 and the decoder MLP through K2 and K3 against the
    plain modules, same weights and inputs, at the training shapes."""
    B, n_trgt = TRAIN_BATCH, 256
    n_ind = model.n_induced
    errs = {}
    for name, src in (("ctx->grid", model.cntxt_to_induced), ("grid->trgt", model.induced_to_trgt)):
        c_in = src.resizer.in_features - 1
        kern = copy.deepcopy(src).train()
        plain = copy.deepcopy(src).train()
        kern.use_kernel, plain.use_kernel = True, False
        grid = linspace(-1.5, 1.5, n_ind, device="cuda")[None, :, None].expand(B, n_ind, 1)
        trgt = linspace(-1.0, 1.0, n_trgt, device="cuda")[None, :, None].expand(B, n_trgt, 1)
        keys, queries = (trgt, grid) if name == "ctx->grid" else (grid, trgt)
        K = keys.shape[1]
        mask = torch.ones((B, K), dtype=torch.bool, device="cuda")
        if name == "ctx->grid":  # about half the points, and an empty context
            mask = torch.rand((B, K), generator=gen, device="cuda") < 0.5
            mask[0] = False
        values = torch.randn((B, K, c_in), generator=gen, device="cuda")
        g_out = torch.randn((B, queries.shape[1], src.resizer.out_features), generator=gen,
                            device="cuda")
        grads = []
        for m in (kern, plain):
            v = values.clone().requires_grad_()
            (m(keys, queries, v, mask) * g_out).sum().backward()
            grads.append({"values": v.grad, "length_scale": m.rbf.length_scale_param.grad,
                          "resizer.weight": m.resizer.weight.grad,
                          "resizer.bias": m.resizer.bias.grad})
        errs.update({f"SetConv {name} d{k}": v for k, v in _grad_errs(
            (k, grads[0][k], grads[1][k]) for k in grads[0]).items()})
    dec = model.decoder.module
    kern, plain = copy.deepcopy(dec), copy.deepcopy(dec)
    kern.fused, plain.fused = True, False
    r = torch.randn((1, B, n_trgt, dec.to_hidden.in_features), generator=gen, device="cuda")
    g_loc, g_scale = (torch.randn((1, B, n_trgt, 1), generator=gen, device="cuda")
                      for _ in range(2))
    grads = []
    for m in (kern, plain):
        x = r.clone().requires_grad_()
        loc, raw = m(x).split(1, dim=-1)  # strided cotangents, as in decode()
        ((loc * g_loc).sum() + (torch.nn.functional.softplus(raw) * g_scale).sum()).backward()
        grads.append({"input": x.grad, **{n: p.grad for n, p in m.named_parameters()}})
    errs.update({f"decoder d{k}": v for k, v in _grad_errs(
        (k, grads[0][k], grads[1][k]) for k in grads[0]).items()})
    torch.cuda.synchronize()
    worst = max(errs, key=errs.get)
    print(f"autograd, kernels vs plain: {len(errs)} gradients, worst {errs[worst]:.3e} ({worst})")
    for k, v in errs.items():
        print(f"   {k}: {v:.3e}")
    if errs[worst] > GRAD_RTOL:
        raise AssertionError(f"autograd through the kernels disagrees with the plain path: {worst}")
    return errs


def _bn_cancelled(name):
    """conv1's biases in a BatchNorm block add a per-channel constant that the
    next train-mode BatchNorm subtracts: their gradient is zero in exact
    arithmetic, rounding noise in practice."""
    return ".conv1." in name and name.endswith(".bias")


def check_train_step(model, summary, gen, dtype=None):
    """One train step on the kernel path against one on the plain path, on
    copies with identical parameters and one identical split batch. Each
    parameter's gradient is held to the step's gradient bar of its max
    magnitude; the conv1 biases of the BatchNorm blocks, whose gradient is
    zero in exact arithmetic, are held on both paths below that bar of the
    max magnitude of their block's conv1.pointwise weight gradient. In
    float32 the plain path is the model without kernels (`use_kernels=False`);
    in bf16 (`dtype`) it is the kernel path with every kernel replaced by its
    plain version, since the Dense decoder rounds elsewhere than the chain."""
    bf16 = dtype is not None
    loss_rtol, grad_rtol = ((BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_RTOL) if bf16
                            else (STEP_LOSS_RTOL, STEP_GRAD_RTOL))
    space, wave = GWParameterSpace(), run_generator(summary)
    theta = space.sample(TRAIN_BATCH, gen)
    x, y, cond = make_eval_batch(theta, wave, space)
    batch = None
    res = {}
    for label in ("kernel", "plain"):
        trainer = train_gw.build_trainer(summary, 1, "cuda", use_kernels=label == "kernel" or bf16,
                                         dtype=dtype)
        trainer.model.load_state_dict(model.state_dict())
        if batch is None:
            batch = trainer.splitter(gen, x, y, condition=cond)
        with plain_kernels() if bf16 and label == "plain" else contextlib.nullcontext():
            loss = trainer.loss_and_grads(batch)
        res[label] = (loss, {n: p.grad for n, p in trainer.model.named_parameters()})
    torch.cuda.synchronize()
    (loss_k, grads_k), (loss_p, grads_p) = res["kernel"], res["plain"]
    loss_rel = (abs(loss_k - loss_p) / abs(loss_p)).item()
    errs = _grad_errs((n, grads_k[n], grads_p[n]) for n in grads_p if not _bn_cancelled(n))
    zero = {}
    for n in filter(_bn_cancelled, grads_p):
        scale = grads_p[n.rsplit(".", 2)[0] + ".pointwise.weight"].abs().max()
        zero[n] = (max(grads_k[n].abs().max(), grads_p[n].abs().max()) / scale).item()
    worst, worst_zero = max(errs, key=errs.get), max(zero, key=zero.get)
    print(f"train step{' (bf16)' if bf16 else ''}, kernel vs plain path: loss "
          f"{loss_k.item():.4f} vs {loss_p.item():.4f} "
          f"(rel {loss_rel:.3e}); {len(errs)} parameter gradients, worst {errs[worst]:.3e} of "
          f"its max magnitude ({worst}); {len(zero)} BatchNorm-cancelled biases, largest "
          f"{zero[worst_zero]:.3e} of their weight's gradient ({worst_zero})")
    if not (loss_rel <= loss_rtol and errs[worst] <= grad_rtol and zero[worst_zero] <= grad_rtol):
        raise AssertionError("the kernel-path train step disagrees with the plain path")
    return loss_rel, errs[worst]


def kernel_entry(name, source, replaces, launches, rows, path_shapes, launches_by_path):
    """One kernel's line entry: times summed over the shapes one train step
    runs, the largest error over every shape checked; `launches` is the
    training path's count."""
    on_path = [r for r in rows if r["shape"] in path_shapes]
    total = lambda key: sum(r[key] for r in on_path)  # noqa: E731
    entry = dict(
        name=name, route="cuda", source=source, replaces=replaces, launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
        bound_by="operations" if all(r["bound_by"] == "operations" for r in on_path) else "bytes",
        library_ms=None, launches_by_path=launches_by_path, shapes=rows,
    )
    if all(r.get("cublas_chain_ms") is not None for r in on_path):
        # the bf16 kernels' yardstick: several cuBLAS calls, so not "library_ms"
        entry["cublas_chain_ms"] = total("cublas_chain_ms")
    return entry


def main() -> int:
    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(smi)
    nvcc_version = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                                  text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); {nvcc_version}")
    set_numerics()
    # cuDNN's deterministic algorithms, so that the run is reproducible: with
    # its default backward, each run's 500 steps reach another model, and the
    # float32 one-step check above measured 3e-5 to 1.2e-3 (one model in
    # eight over its bar) on the models they reached (PERF.md, section 6)
    torch.backends.cudnn.deterministic = True

    phase("build")
    res = _build.build(verbose=True)
    print(f"nvcc built {os.path.basename(res.path)} in {res.seconds:.1f}s")
    for line in res.log.splitlines():
        if any(s in line for s in ("Compiling entry", "registers", "spill")):
            print("  " + line.strip())

    model = load_model(RUN_DIR, "cuda")
    with open(os.path.join(RUN_DIR, "summary.json")) as f:
        summary = json.load(f)
    model_ctx = summary["n_context"]  # the path's contexts hold U{0..n_context} points
    sig_ctx = model.cntxt_to_induced.rbf.sigma().item()
    sig_trgt = model.induced_to_trgt.rbf.sigma().item()
    gen = torch.Generator(device="cuda").manual_seed(0)

    phase("K1 setconv_fwd vs plain")
    k1_rows = check_k1([
        # the paths' shapes and masks: the scoring batch, then the train step
        ("ctx->grid", k1_inputs(256, 256, 384, 1, sig_ctx, gen, [0, 7], max_real=model_ctx)),
        ("grid->trgt", k1_inputs(256, 384, 256, 128, sig_trgt, gen, max_real="all")),
        ("ctx->grid train", k1_inputs(TRAIN_BATCH, 256, 384, 1, sig_ctx, gen, [0],
                                      max_real=model_ctx)),
        ("grid->trgt train", k1_inputs(TRAIN_BATCH, 384, 256, 128, sig_trgt, gen,
                                       max_real="all")),
        # off the paths: random masks with an empty row, many keys, the
        # long-waveform runs' width (ROADMAP queue 1, item 3)
        ("grid->trgt random mask", k1_inputs(256, 384, 256, 128, sig_trgt, gen, [3])),
        ("large-K", k1_inputs(4, 5000, 512, 8, 0.05, gen, [2], path=False)),
        ("large-C", k1_inputs(4, 2048, 1536, 512, 0.02, gen, [1], path=False)),
    ])

    phase("K2 mlp_chain_fwd vs plain")
    dec = model.decoder.module
    dec_w = (dec.to_hidden.weight, dec.to_hidden.bias,
             torch.stack([dec.linear_0.weight, dec.linear_1.weight, dec.linear_2.weight]),
             torch.stack([dec.linear_0.bias, dec.linear_1.bias, dec.linear_2.bias]),
             dec.out.weight, dec.out.bias)
    with torch.inference_mode():
        dec_w = tuple(t.detach().contiguous() for t in dec_w)
        k2_rows = check_k2([
            ("decoder", k2_inputs(65536, 128, 128, 3, 2, True, gen, dec_w), False),
            ("decoder train", k2_inputs(TRAIN_BATCH * 256, 128, 128, 3, 2, True, gen, dec_w),
             False),
            *((name, k2_inputs(M, C, H, L1, O, biases, gen), is_res)
              for name, M, C, H, L1, O, is_res, biases in K2_CASES),
        ])

        phase("K3 mlp_chain_bwd vs plain")
        k3_rows = check_k3([
            ("decoder train", k3_inputs(TRAIN_BATCH * 256, 128, 128, 3, 2, True, gen, dec_w[:5]),
             False),
            ("decoder score shape", k3_inputs(65536, 128, 128, 3, 2, True, gen, dec_w[:5]), False),
            ("no-hidden residual no-bias", k3_inputs(1000, 128, 128, 0, 3, False, gen), True),
            ("ragged residual", k3_inputs(4099, 37, 64, 2, 5, True, gen), True),
            # widths past one 128-column pass of the kernel's products
            ("wide", k3_inputs(3001, 200, 256, 2, 3, True, gen), False),
            ("wide residual", k3_inputs(3001, 200, 320, 2, 3, True, gen), True),
        ])

    phase("autograd through K1, K2, K3 vs the plain modules")
    check_autograd(model, gen)

    phase("scoring path: score run_1 through K1 and K2")
    reset_counts()
    out = score_run(RUN_DIR, N_TEST, thetas_from=RUN_DIR, device="cuda")
    score_launches = counts()
    n_batches = -(-N_TEST // 256)
    print(f"scored {out['n']} waveforms in {out['seconds']:.2f}s: mean LL {out['mean_ll']:.3f}, "
          f"median mismatch {out['median_mismatch']:.6f}, p90 {out['mismatch_p90']:.4f}, "
          f"frac < 0.1 {out['frac_below_0.1']:.4f}; launches K1 {score_launches[0]}, "
          f"K2 {score_launches[1]}, K3 {score_launches[2]}")
    if score_launches != (2 * n_batches, n_batches, 0, 0, 0):
        raise AssertionError(f"expected {2 * n_batches} K1, {n_batches} K2 and no other launches")
    if not (np.isfinite(out["ll"]).all() and np.isfinite(out["mismatch"]).all()
            and out["n"] == N_TEST):
        raise AssertionError("non-finite or missing per-waveform results")
    if not LL_BAND[0] <= out["mean_ll"] <= LL_BAND[1]:
        raise AssertionError(f"mean LL {out['mean_ll']} outside {LL_BAND}")
    if not MISMATCH_BAND[0] <= out["median_mismatch"] <= MISMATCH_BAND[1]:
        raise AssertionError(f"median mismatch {out['median_mismatch']} outside {MISMATCH_BAND}")

    phase("scoring path: one batch, kernel path vs plain path")
    plain_model = load_model(RUN_DIR, "cuda", use_kernels=False)
    gw_gen, space = run_generator(summary), GWParameterSpace()
    theta = torch.from_numpy(read_run_thetas(RUN_DIR)[:256]).cuda()
    splitter = eval_splitter(summary["n_context"])
    outs = {}
    with torch.inference_mode():
        for label, m in (("kernel", model), ("plain", plain_model)):
            g = torch.Generator(device="cuda").manual_seed(1)
            ll, _, _, o = score_batch(m, splitter, g, theta, gw_gen, space)
            outs[label] = (o.p_yCc.loc, o.p_yCc.scale, ll)
            torch.cuda.synchronize()
            t = []
            for _ in range(5):
                g = torch.Generator(device="cuda").manual_seed(1)
                t0 = time.perf_counter()
                score_batch(m, splitter, g, theta, gw_gen, space)
                torch.cuda.synchronize()
                t.append(time.perf_counter() - t0)
            print(f"{label} path: one 256-waveform batch {1e3 * float(np.median(t)):.3f} ms "
                  f"(median of 5, host clock)")
    loc_err = (outs["kernel"][0] - outs["plain"][0]).abs().max().item()
    scale_err = (outs["kernel"][1] - outs["plain"][1]).abs().max().item()
    ll_err = (outs["kernel"][2] - outs["plain"][2]).abs().max().item()
    print(f"kernel vs plain path: loc {loc_err:.3e}, scale {scale_err:.3e}, LL {ll_err:.3e}")
    if not (loc_err <= PATH_TOL and scale_err <= PATH_TOL):
        raise AssertionError("kernel path disagrees with the plain path")

    phase(f"training path: {TRAIN_STEPS} steps of the flagship configuration at batch "
          f"{TRAIN_BATCH} from the port's init")
    train_summary = gw_train_summary()
    trainer = train_gw.build_trainer(train_summary, TRAIN_STEPS, "cuda", seed=0)
    reset_counts()
    history, losses, seconds, step_seconds = train_gw.train(
        trainer, train_summary, TRAIN_STEPS, TRAIN_BATCH, time_steps=True)
    train_launches = counts()
    losses = losses.cpu().numpy()
    early, late = float(np.median(losses[:50])), float(np.median(losses[250:500]))
    step_ms = 1e3 * float(np.median(step_seconds))
    print(f"trained {TRAIN_STEPS} steps in {seconds:.2f}s; launches K1 {train_launches[0]}, "
          f"K2 {train_launches[1]}, K3 {train_launches[2]}")
    print("50-step mean losses: " + ", ".join(f"{h['step']}: {h['train_loss']:.1f}"
                                              for h in history))
    print(f"median loss over steps 1-50 {early:.2f}, over steps 251-500 {late:.2f} "
          f"(fell {early - late:.2f} nats; below 0: {late < 0.0})")
    print(f"train step {step_ms:.3f} ms (median of {TRAIN_STEPS}, host clock, synchronised): "
          f"{1e3 * TRAIN_BATCH / step_ms:.0f} wf/s on {smi}")
    if train_launches != (2 * TRAIN_STEPS, TRAIN_STEPS, TRAIN_STEPS, 0, 0):
        raise AssertionError(f"expected {2 * TRAIN_STEPS} K1, {TRAIN_STEPS} K2 and {TRAIN_STEPS} "
                             "K3 launches and no bf16 ones")
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite training loss")
    if not late <= early - LOSS_FALL_NATS:
        raise AssertionError(f"the loss did not fall: median {early:.2f} over steps 1-50, "
                             f"{late:.2f} over steps 251-500")

    phase("training path: one step, kernel path vs plain path")
    trained = trainer.model
    check_train_step(trained, train_summary, gen)

    phase("training path: the written run reloads")
    with tempfile.TemporaryDirectory() as tmp:
        train_summary.update(steps=TRAIN_STEPS, batch=TRAIN_BATCH)
        run_dir = os.path.join(tmp, "run_0")
        train_gw.write_run(run_dir, trained, train_summary, history)
        reloaded = load_model(run_dir, "cuda")
        trained.eval()
        theta = space.sample(256, gen)
        preds = []
        with torch.inference_mode():
            for m in (trained, reloaded):
                g = torch.Generator(device="cuda").manual_seed(2)
                *_, o = score_batch(m, splitter, g, theta, gw_gen, space)
                preds.append((o.p_yCc.loc, o.p_yCc.scale))
        same = all(torch.equal(a, b) for a, b in zip(*preds))
        scored = score_run(run_dir, 256, device="cuda")
        print(f"reloaded run: eval forward equal to the in-memory model's {same}; scored 256 "
              f"waveforms: mean LL {scored['mean_ll']:.3f}, median mismatch "
              f"{scored['median_mismatch']:.4f}")
        if not (same and np.isfinite(scored["ll"]).all()):
            raise AssertionError("the written run does not reload to the trained model")

    phase("K2-bf16 mlp_chain_fwd_bf16 vs plain")
    with torch.inference_mode():
        k2b_rows = check_k2_bf16([
            ("decoder", k2_inputs(65536, 128, 128, 3, 2, True, gen, dec_w, BF16), False),
            ("decoder train", k2_inputs(TRAIN_BATCH * 256, 128, 128, 3, 2, True, gen, dec_w, BF16),
             False),
            *((name, k2_inputs(M, C, H, L1, O, biases, gen, dtype=BF16), is_res)
              for name, M, C, H, L1, O, is_res, biases in K2_CASES),
        ])

        phase("K3-bf16 mlp_chain_bwd_bf16 vs plain")
        k3b_rows = check_k3_bf16([
            ("decoder train", k3_inputs(TRAIN_BATCH * 256, 128, 128, 3, 2, True, gen, dec_w[:5],
                                        BF16), False),
            ("decoder score shape", k3_inputs(65536, 128, 128, 3, 2, True, gen, dec_w[:5], BF16),
             False),
            ("no-hidden residual no-bias", k3_inputs(1000, 128, 128, 0, 3, False, gen, dtype=BF16),
             True),
            ("ragged residual", k3_inputs(4099, 37, 64, 2, 5, True, gen, dtype=BF16), True),
            ("wide", k3_inputs(3001, 200, 256, 2, 3, True, gen, dtype=BF16), False),
            ("wide residual", k3_inputs(3001, 200, 320, 2, 3, True, gen, dtype=BF16), True),
        ])

    phase("bf16 scoring path: score run_1 in bfloat16 compute through K1 and K2-bf16")
    reset_counts()
    out16 = score_run(RUN_DIR, N_TEST, thetas_from=RUN_DIR, device="cuda", dtype=BF16)
    score16_launches = counts()
    d_ll = out16["mean_ll"] - out["mean_ll"]
    d_mm = out16["median_mismatch"] - out["median_mismatch"]
    d_wf = out16["ll"] - out["ll"]
    print(f"scored {out16['n']} waveforms in bf16 in {out16['seconds']:.2f}s: mean LL "
          f"{out16['mean_ll']:.3f}, median mismatch {out16['median_mismatch']:.6f}; against "
          f"float32 with the same context draws: mean LL {d_ll:+.4f} (JAX {BF16_D_MEAN_LL:+.3f}), "
          f"median mismatch {d_mm:+.3e}, per-waveform LL differences sd {d_wf.std():.3f}, largest "
          f"{np.abs(d_wf).max():.2f}; launches K1 {score16_launches[0]}, K2 {score16_launches[1]}, "
          f"K3 {score16_launches[2]}, K2-bf16 {score16_launches[3]}, K3-bf16 "
          f"{score16_launches[4]}")
    if score16_launches != (2 * n_batches, 0, 0, n_batches, 0):
        raise AssertionError(f"expected {2 * n_batches} K1, {n_batches} K2-bf16 and no other "
                             "launches")
    if not (np.isfinite(out16["ll"]).all() and np.isfinite(out16["mismatch"]).all()
            and out16["n"] == N_TEST):
        raise AssertionError("non-finite or missing per-waveform results in bf16")
    if not LL_BAND[0] <= out16["mean_ll"] <= LL_BAND[1]:
        raise AssertionError(f"bf16 mean LL {out16['mean_ll']} outside {LL_BAND}")
    if not MISMATCH_BAND[0] <= out16["median_mismatch"] <= MISMATCH_BAND[1]:
        raise AssertionError(f"bf16 median mismatch {out16['median_mismatch']} outside "
                             f"{MISMATCH_BAND}")
    if not (abs(d_ll - BF16_D_MEAN_LL) <= BF16_D_MEAN_LL_TOL
            and abs(d_mm) <= BF16_D_MEDIAN_MISMATCH):
        raise AssertionError("the bf16 score's gap to the float32 score is not JAX's")

    phase("bf16 scoring path: one batch, kernel path vs plain-kernel path")
    model16 = load_model(RUN_DIR, "cuda", dtype=BF16)
    theta = torch.from_numpy(read_run_thetas(RUN_DIR)[:256]).cuda()
    outs = {}
    with torch.inference_mode():
        for label, m, ctx in (("kernel", model16, contextlib.nullcontext),
                              ("plain-kernel", model16, plain_kernels),
                              ("float32", model, contextlib.nullcontext)):
            with ctx():
                g = torch.Generator(device="cuda").manual_seed(1)
                ll, _, _, o = score_batch(m, splitter, g, theta, gw_gen, space)
                outs[label] = (o.p_yCc.loc, o.p_yCc.scale, ll)
                torch.cuda.synchronize()
                t = []
                for _ in range(3):
                    g = torch.Generator(device="cuda").manual_seed(1)
                    t0 = time.perf_counter()
                    score_batch(m, splitter, g, theta, gw_gen, space)
                    torch.cuda.synchronize()
                    t.append(time.perf_counter() - t0)
            print(f"{label} path: one 256-waveform batch {1e3 * float(np.median(t)):.3f} ms "
                  f"(median of 3, host clock)")
    rms = lambda a: a.float().square().mean().sqrt().item()  # noqa: E731
    loc_k, loc_p, loc_32 = outs["kernel"][0], outs["plain-kernel"][0], outs["float32"][0]
    near, gap = rms(loc_k - loc_p), rms(loc_k - loc_32)
    near_max, gap_max = ((loc_k - loc_p).abs().max().item(), (loc_k - loc_32).abs().max().item())
    print(f"bf16 kernel vs plain-kernel path: loc RMS {near:.3e}, largest {near_max:.3e}; the "
          f"bf16-float32 gap of the same batch: RMS {gap:.3e}, largest {gap_max:.3e}; scale "
          f"{(outs['kernel'][1] - outs['plain-kernel'][1]).abs().max().item():.3e}, LL "
          f"{(outs['kernel'][2] - outs['plain-kernel'][2]).abs().max().item():.3e}")
    if not (near <= BF16_PATH_RMS * gap and near_max <= BF16_PATH_MAX * gap_max):
        raise AssertionError("the bf16 kernel path disagrees with its plain-kernel path")

    phase(f"bf16 training path: {TRAIN_STEPS} steps at batch {TRAIN_BATCH} from seed 0")
    trainer16 = train_gw.build_trainer(train_summary, TRAIN_STEPS, "cuda", seed=0, dtype=BF16)
    reset_counts()
    history16, losses16, seconds16, step_seconds16 = train_gw.train(
        trainer16, train_summary, TRAIN_STEPS, TRAIN_BATCH, time_steps=True)
    train16_launches = counts()
    losses16 = losses16.cpu().numpy()
    early16, late16 = float(np.median(losses16[:50])), float(np.median(losses16[250:500]))
    step16_ms = 1e3 * float(np.median(step_seconds16))
    print(f"trained {TRAIN_STEPS} bf16 steps in {seconds16:.2f}s; launches K1 "
          f"{train16_launches[0]}, K2 {train16_launches[1]}, K3 {train16_launches[2]}, K2-bf16 "
          f"{train16_launches[3]}, K3-bf16 {train16_launches[4]}")
    print("50-step mean losses: " + ", ".join(f"{h['step']}: {h['train_loss']:.1f}"
                                              for h in history16))
    print(f"median loss over steps 1-50 {early16:.2f}, over steps 251-500 {late16:.2f} "
          f"(fell {early16 - late16:.2f} nats; below 0: {late16 < 0.0})")
    print(f"bf16 train step {step16_ms:.3f} ms (median of {TRAIN_STEPS}, host clock, "
          f"synchronised): {1e3 * TRAIN_BATCH / step16_ms:.0f} wf/s on {smi}")
    if train16_launches != (2 * TRAIN_STEPS, 0, 0, TRAIN_STEPS, TRAIN_STEPS):
        raise AssertionError(f"expected {2 * TRAIN_STEPS} K1, {TRAIN_STEPS} K2-bf16 and "
                             f"{TRAIN_STEPS} K3-bf16 launches and no float32 K2 or K3")
    if not np.isfinite(losses16).all():
        raise AssertionError("non-finite bf16 training loss")
    if not late16 <= early16 - LOSS_FALL_NATS:
        raise AssertionError(f"the bf16 loss did not fall: median {early16:.2f} over steps "
                             f"1-50, {late16:.2f} over steps 251-500")

    phase("bf16 training path: one step, kernel path vs plain-kernel path")
    check_train_step(trainer16.model, train_summary, gen, BF16)

    def launches_by_path(i):
        return {"score": score_launches[i], "train": train_launches[i],
                "score_bf16": score16_launches[i], "train_bf16": train16_launches[i]}

    mlp = "npf_gwwaveform_tpu/ops/pallas/mlp_chain_kernel.py"
    kernels = [
        kernel_entry("K1 setconv_fwd", "npf_gwwaveform_tpu_torch/csrc/setconv_fwd.cu",
                     "npf_gwwaveform_tpu/ops/pallas/setconv_kernel.py:45", train_launches[0],
                     k1_rows, ("ctx->grid train", "grid->trgt train"), launches_by_path(0)),
        kernel_entry("K2 mlp_chain_fwd", "npf_gwwaveform_tpu_torch/csrc/mlp_chain_fwd.cu",
                     f"{mlp}:63", train_launches[1], k2_rows, ("decoder train",),
                     launches_by_path(1)),
        kernel_entry("K3 mlp_chain_bwd", "npf_gwwaveform_tpu_torch/csrc/mlp_chain_bwd.cu",
                     f"{mlp}:83", train_launches[2], k3_rows, ("decoder train",),
                     launches_by_path(2)),
        kernel_entry("K2-bf16 mlp_chain_fwd_bf16",
                     "npf_gwwaveform_tpu_torch/csrc/mlp_chain_fwd_bf16.cu", f"{mlp}:63",
                     train16_launches[3], k2b_rows, ("decoder train",), launches_by_path(3)),
        kernel_entry("K3-bf16 mlp_chain_bwd_bf16",
                     "npf_gwwaveform_tpu_torch/csrc/mlp_chain_bwd_bf16.cu", f"{mlp}:83",
                     train16_launches[4], k3b_rows, ("decoder train",), launches_by_path(4)),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
