#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`npf_gwwaveform_tpu_torch`) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each announced with the seconds elapsed:
  1. device: the card's name and power limit, torch and nvcc versions;
  2. build: both CUDA kernels with one nvcc call (ptxas resource report);
  3. K1 (SetConv forward) against its plain version at the two path shapes
     and one K > 2048 shape;
  4. K2 (fused MLP chain forward) against its plain version at the decoder
     shape and two other cases;
  5. K3 (fused MLP chain backward) against its plain version at the training
     and scoring shapes, with L1=0 and no biases, and at a ragged row count;
     two launches must give the same bits;
  6. autograd through the kernels against the plain modules at the training
     shapes: a SetConv through K1 and the decoder MLP through K2 and K3;
  7. the scoring path: score the 2048 thetas recorded in the flagship run
     `results/GW_time_cond_film_ctx192_d128/ConvCNP/run_1` through K1 and K2,
     check the launch counts and the quality bands, then compare one batch
     with the plain path;
  8. the training path: train the flagship configuration from the port's
     init for 500 steps at batch 32 (`train_gw.run`, into a temporary
     directory), check the launch counts, that the loss falls, a kernel-path
     train step against a plain-path one, and that the written run reloads.
It ends with a JSON line of per-kernel numbers and the JSON result line.
Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

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
from npf_gwwaveform_tpu_torch.ops.kernels.mlp_chain import (
    fused_relu_mlp, fused_relu_mlp_bwd, fused_relu_mlp_bwd_plain, fused_relu_mlp_plain,
)
from npf_gwwaveform_tpu_torch.ops.kernels.setconv import setconv_exprbf_fwd, setconv_exprbf_plain
from npf_gwwaveform_tpu_torch.score import (
    eval_splitter, load_model, make_eval_batch, read_run_thetas, run_generator, score_batch,
    score_run,
)
from npf_gwwaveform_tpu_torch.utils.helpers import linspace

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
# conv backward sums in no fixed order)
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

# H100 SXM published peaks (dense): HBM bytes/s and float32 outside tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

_T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (t={time.perf_counter() - _T0:.1f}s)", flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over reps launches, with CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_ops: float):
    """The least time (ms) for the work, and what sets it."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def k1_case(name, B, K, Q, C, sigma, gen, empty_rows, path, max_real=None):
    """Inputs of one K1 shape: keys/queries on the path's grids when `path`,
    U{0..max_real} real keys per row (default K), the given rows empty."""
    dev = "cuda"
    if path:
        keys = linspace(-1.0, 1.0, K, device=dev) if K == 256 else linspace(-1.5, 1.5, K, device=dev)
        queries = linspace(-1.5, 1.5, Q, device=dev) if Q == 384 else linspace(-1.0, 1.0, Q, device=dev)
        keys = keys[None].expand(B, K).contiguous()
        queries = queries[None].expand(B, Q).contiguous()
    else:
        keys = torch.sort(torch.rand((B, K), generator=gen, device=dev) * 2 - 1, dim=-1).values
        queries = torch.rand((B, Q), generator=gen, device=dev) * 3 - 1.5
    values = torch.randn((B, K, C), generator=gen, device=dev)
    n_real = torch.randint(0, (max_real or K) + 1, (B, 1), generator=gen, device=dev)
    scores = torch.rand((B, K), generator=gen, device=dev)
    mask = (scores.argsort(dim=-1).argsort(dim=-1) < n_real).float()
    mask[empty_rows] = 0.0
    sig = torch.full((1,), sigma, device=dev)
    return name, (keys, queries, values, mask, sig)


def check_k1(cases):
    rows = []
    for name, args in cases:
        keys, queries, values, mask, sig = args
        B, K = keys.shape
        Q, C = queries.shape[1], values.shape[-1]
        s_k, d_k = setconv_exprbf_fwd(*args)
        s_p, d_p = setconv_exprbf_plain(*args)
        torch.cuda.synchronize()
        sig_err = (s_k - s_p).abs().max().item()
        den_rel = ((d_k - d_p).abs() / (d_p.abs() + 1e-30)).max().item()
        empty = mask.sum(-1) == 0
        empty_ok = bool((s_k[empty] == 0).all() and (d_k[empty] == 0).all()) if empty.any() else True
        finite = bool(torch.isfinite(s_k).all() and torch.isfinite(d_k).all())
        print(f"K1 {name}: B={B} K={K} Q={Q} C={C} signal max abs err {sig_err:.3e}, "
              f"density max rel err {den_rel:.3e}, empty rows zero {empty_ok}")
        if not (finite and empty_ok and sig_err <= K1_SIGNAL_ATOL and den_rel <= K1_DENSITY_RTOL):
            raise AssertionError(f"K1 {name} disagrees with its plain version")
        ms = time_ms(lambda: setconv_exprbf_fwd(*args))
        plain_ms = time_ms(lambda: setconv_exprbf_plain(*args), reps=5)
        n_real_keys = mask.sum().item()
        n_bytes = 4 * (2 * B * K + B * Q + B * K * C + B * Q * C + B * Q)
        bms, by = bound(n_bytes, n_real_keys * Q * (2 * C + 10))
        rows.append(dict(shape=name, B=B, K=K, Q=Q, C=C, max_abs_err=sig_err,
                         density_max_rel_err=den_rel, ms=ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by))
        print(f"   kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return rows


def k2_case(name, M, C, H, L1, O, is_res, biases, gen, weights=None):
    dev = "cuda"
    x = torch.randn((M, C), generator=gen, device=dev)
    if weights is None:
        def w(*shape):
            return torch.randn(shape, generator=gen, device=dev) / shape[-1] ** 0.5
        weights = (w(H, C), w(H) if biases else None, w(L1, H, H),
                   w(L1, H) if biases else None, w(O, H), w(O) if biases else None)
    return name, (x, *weights), is_res


def check_k2(cases):
    rows = []
    for name, args, is_res in cases:
        x, w0, _, wh, _, wout, _ = args
        M, C = x.shape
        H, L1, O = w0.shape[0], wh.shape[0], wout.shape[0]
        o_k = fused_relu_mlp(*args, is_res=is_res)
        o_p = fused_relu_mlp_plain(*args, is_res=is_res)
        torch.cuda.synchronize()
        err = (o_k - o_p).abs().max().item()
        scale = o_p.abs().max().item()
        finite = bool(torch.isfinite(o_k).all())
        print(f"K2 {name}: M={M} C={C} H={H} L1={L1} O={O} res={is_res} "
              f"max abs err {err:.3e} (output max {scale:.3e})")
        if not (finite and err <= K2_RTOL * scale):
            raise AssertionError(f"K2 {name} disagrees with its plain version")
        ms = time_ms(lambda: fused_relu_mlp(*args, is_res=is_res))
        plain_ms = time_ms(lambda: fused_relu_mlp_plain(*args, is_res=is_res))
        n_bytes = 4 * (M * C + M * O + sum(t.numel() for t in args[1:] if t is not None))
        bms, by = bound(n_bytes, 2 * M * (C * H + L1 * H * H + H * O))
        rows.append(dict(shape=name, M=M, C=C, H=H, L1=L1, O=O, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by))
        print(f"   kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return rows


def k3_case(name, M, C, H, L1, O, is_res, biases, gen, weights=None):
    dev = "cuda"
    x = torch.randn((M, C), generator=gen, device=dev)
    g = torch.randn((M, O), generator=gen, device=dev)
    if weights is None:
        def w(*shape):
            return torch.randn(shape, generator=gen, device=dev) / shape[-1] ** 0.5
        weights = (w(H, C), w(H) if biases else None, w(L1, H, H),
                   w(L1, H) if biases else None, w(O, H))
    return name, (x, g, *weights), is_res


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
        n_w = H * C + L1 * H * H + O * H
        n_params = n_w + H + L1 * H + O
        # reads x, g and the weights, writes dx and every gradient
        n_bytes = 4 * (2 * M * C + M * O + (n_w + H * (b0 is not None) + L1 * H * (bh is not None))
                       + n_params)
        # forward recompute of the hidden chain, then the input and the weight
        # gradient of every layer
        n_ops = 2 * M * (C * H + L1 * H * H) + 4 * M * n_w
        bms, by = bound(n_bytes, n_ops)
        rows.append(dict(shape=name, M=M, C=C, H=H, L1=L1, O=O, max_abs_err=rel[worst], ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by))
        print(f"   kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})")
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


def check_train_step(model, summary, gen):
    """One train step on the kernel path against one on the plain path, on
    copies with identical parameters and one identical split batch. Each
    parameter's gradient is held to STEP_GRAD_RTOL of its max magnitude; the
    conv1 biases of the BatchNorm blocks, whose gradient is zero in exact
    arithmetic, are held on both paths below STEP_GRAD_RTOL of the max
    magnitude of their block's conv1.pointwise weight gradient."""
    space, wave = GWParameterSpace(), run_generator(summary)
    theta = space.sample(TRAIN_BATCH, gen)
    x, y, cond = make_eval_batch(theta, wave, space)
    batch = None
    res = {}
    for label, use in (("kernel", True), ("plain", False)):
        trainer = train_gw.build_trainer(summary, 1, "cuda", use_kernels=use)
        trainer.model.load_state_dict(model.state_dict())
        if batch is None:
            batch = trainer.splitter(gen, x, y, condition=cond)
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
    print(f"train step, kernel vs plain path: loss {loss_k.item():.4f} vs {loss_p.item():.4f} "
          f"(rel {loss_rel:.3e}); {len(errs)} parameter gradients, worst {errs[worst]:.3e} of "
          f"its max magnitude ({worst}); {len(zero)} BatchNorm-cancelled biases, largest "
          f"{zero[worst_zero]:.3e} of their weight's gradient ({worst_zero})")
    if not (loss_rel <= STEP_LOSS_RTOL and errs[worst] <= STEP_GRAD_RTOL
            and zero[worst_zero] <= STEP_GRAD_RTOL):
        raise AssertionError("the kernel-path train step disagrees with the plain path")
    return loss_rel, errs[worst]


def kernel_entry(name, source, replaces, launches, rows, path_shapes, launches_by_path):
    """One kernel's line entry: times summed over the shapes one train step
    runs, the largest error over every shape checked; `launches` is the
    training path's count."""
    on_path = [r for r in rows if r["shape"] in path_shapes]
    total = lambda key: sum(r[key] for r in on_path)  # noqa: E731
    return dict(
        name=name, route="cuda", source=source, replaces=replaces, launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
        bound_by="operations" if all(r["bound_by"] == "operations" for r in on_path) else "bytes",
        library_ms=None, launches_by_path=launches_by_path, shapes=rows,
    )


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
        k1_case("ctx->grid", 256, 256, 384, 1, sig_ctx, gen, [0, 7], path=True,
                max_real=model_ctx),
        k1_case("grid->trgt", 256, 384, 256, 128, sig_trgt, gen, [3], path=True),
        k1_case("ctx->grid train", TRAIN_BATCH, 256, 384, 1, sig_ctx, gen, [0], path=True,
                max_real=model_ctx),
        k1_case("grid->trgt train", TRAIN_BATCH, 384, 256, 128, sig_trgt, gen, [], path=True),
        k1_case("large-K", 4, 5000, 512, 8, 0.05, gen, [2], path=False),
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
            k2_case("decoder", 65536, 128, 128, 3, 2, False, True, gen, weights=dec_w),
            k2_case("decoder train", TRAIN_BATCH * 256, 128, 128, 3, 2, False, True, gen,
                    weights=dec_w),
            k2_case("residual", 4099, 37, 64, 2, 5, True, False, gen),
            k2_case("no-hidden", 1000, 128, 128, 0, 3, False, True, gen),
        ])

        phase("K3 mlp_chain_bwd vs plain")
        k3_rows = check_k3([
            k3_case("decoder train", TRAIN_BATCH * 256, 128, 128, 3, 2, False, True, gen,
                    weights=dec_w[:5]),
            k3_case("decoder score shape", 65536, 128, 128, 3, 2, False, True, gen,
                    weights=dec_w[:5]),
            k3_case("no-hidden residual no-bias", 1000, 128, 128, 0, 3, True, False, gen),
            k3_case("ragged residual", 4099, 37, 64, 2, 5, True, True, gen),
        ])

    phase("autograd through K1, K2, K3 vs the plain modules")
    check_autograd(model, gen)

    phase("scoring path: score run_1 through K1 and K2")
    setconv_exprbf_fwd.launches = 0
    fused_relu_mlp.launches = 0
    fused_relu_mlp_bwd.launches = 0
    out = score_run(RUN_DIR, N_TEST, thetas_from_run=True, device="cuda")
    score_launches = (setconv_exprbf_fwd.launches, fused_relu_mlp.launches,
                      fused_relu_mlp_bwd.launches)
    n_batches = -(-N_TEST // 256)
    print(f"scored {out['n']} waveforms in {out['seconds']:.2f}s: mean LL {out['mean_ll']:.3f}, "
          f"median mismatch {out['median_mismatch']:.6f}, p90 {out['mismatch_p90']:.4f}, "
          f"frac < 0.1 {out['frac_below_0.1']:.4f}; launches K1 {score_launches[0]}, "
          f"K2 {score_launches[1]}, K3 {score_launches[2]}")
    if score_launches != (2 * n_batches, n_batches, 0):
        raise AssertionError(f"expected {2 * n_batches} K1, {n_batches} K2 and no K3 launches")
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
            ll, mm, o = score_batch(m, splitter, g, theta, gw_gen, space)
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
    setconv_exprbf_fwd.launches = 0
    fused_relu_mlp.launches = 0
    fused_relu_mlp_bwd.launches = 0
    history, losses, seconds, step_seconds = train_gw.train(
        trainer, train_summary, TRAIN_STEPS, TRAIN_BATCH, time_steps=True)
    train_launches = (setconv_exprbf_fwd.launches, fused_relu_mlp.launches,
                      fused_relu_mlp_bwd.launches)
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
    if train_launches != (2 * TRAIN_STEPS, TRAIN_STEPS, TRAIN_STEPS):
        raise AssertionError(f"expected {2 * TRAIN_STEPS} K1, {TRAIN_STEPS} K2 and {TRAIN_STEPS} "
                             "K3 launches")
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
                _, _, o = score_batch(m, splitter, g, theta, gw_gen, space)
                preds.append((o.p_yCc.loc, o.p_yCc.scale))
        same = all(torch.equal(a, b) for a, b in zip(*preds))
        scored = score_run(run_dir, 256, device="cuda")
        print(f"reloaded run: eval forward equal to the in-memory model's {same}; scored 256 "
              f"waveforms: mean LL {scored['mean_ll']:.3f}, median mismatch "
              f"{scored['median_mismatch']:.4f}")
        if not (same and np.isfinite(scored["ll"]).all()):
            raise AssertionError("the written run does not reload to the trained model")

    launches_by_path = lambda i: {"score": score_launches[i], "train": train_launches[i]}  # noqa
    kernels = [
        kernel_entry("K1 setconv_fwd", "npf_gwwaveform_tpu_torch/csrc/setconv_fwd.cu",
                     "npf_gwwaveform_tpu/ops/pallas/setconv_kernel.py:45", train_launches[0],
                     k1_rows, ("ctx->grid train", "grid->trgt train"), launches_by_path(0)),
        kernel_entry("K2 mlp_chain_fwd", "npf_gwwaveform_tpu_torch/csrc/mlp_chain_fwd.cu",
                     "npf_gwwaveform_tpu/ops/pallas/mlp_chain_kernel.py:63", train_launches[1],
                     k2_rows, ("decoder train",), launches_by_path(1)),
        kernel_entry("K3 mlp_chain_bwd", "npf_gwwaveform_tpu_torch/csrc/mlp_chain_bwd.cu",
                     "npf_gwwaveform_tpu/ops/pallas/mlp_chain_kernel.py:83", train_launches[2],
                     k3_rows, ("decoder train",), launches_by_path(2)),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
