"""Score frozen GP runs on functions over twice their training range: the
port's counterpart of `experiments/eval_extrapolation.py`.

    python -m npf_gwwaveform_tpu_torch.eval_extrapolation --kernel RBF_Kernel --out DIR
        [--models oracle,CNP,LNP,AttnCNP,AttnLNP,ConvCNP,ConvLNP] [--n-test 2560]
        [--n-points 256] [--max-cntxt 50] [--device cuda]

From the repo's root (it reads `results/` below the working directory),
each model's `results/<kernel>/<model>/run_0` is scored on `n_test // 256`
batches of 256 functions (below 256 one batch of exactly `n_test`, as the
port's scorers count: `score.n_scored`) of `n_points` points drawn over
twice the sampler's range (x in [-2, 2] in training units), with a context of n ~
U{0..max_cntxt} points drawn only among the inner |x| <= 1 points
(`make_ctx_mask`). One forward over all the targets is scored twice with
the family's eval criterion (NPML without importance weights, at the
model's own eval draws: 32 for LNP and ConvLNP, 8 for AttnLNP): the
per-function log-likelihood summed over the interpolation targets (|x| <=
1) and over the extrapolation targets (|x| > 1). ConvCNP and ConvLNP are
rebuilt on a grid over twice their own induced range (384 points at their
density of 64 a unit), their frozen weights unchanged. Every model is built
as `reproduce_gp.build_model` builds it, with the default BatchNorm eps
1e-3 whatever the run recorded, as the JAX script does. The `oracle` row
(RBF only: the JAX script's docstring finds the periodic covariance too
ill-conditioned for the float32 solve, and the record has no such row) is
the exact GP posterior under the same masks (`oracle_lls`, float32).

It prints one JSON line a row and writes the rows, with the JAX script's
keys, to `DIR/extrapolation_{kernel}.json`; `DIR` may not lie under
`results/` (`score_gp.check_out_dir`), where the JAX script writes by
default. Every batch runs eagerly: ten batches a model are fewer than the
`score.GRAPH_MIN_REPLAYS` that pay for a CUDA graph's capture. The draws
(functions, counts, scores, z) come from one generator on the device,
seeded 123 (`EVAL_SEED`) for each model: Philox cannot replay JAX's threefry
stream, so they are the port's own.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import torch

from . import score as gw_score
from .configs import gp_criterion, gp_model_1d
from .data.gp import KERNEL_CONFIGS, GPSampler
from .score_gp import check_out_dir
from .training.checkpoint import load_run_params, params_from_flax
from .utils.helpers import set_numerics

EVAL_BATCH = 256
EVAL_SEED = 123
MAX_CNTXT = 50
RESULTS = "results"  # the runs and the records, below the working directory
MODELS = ("oracle", "CNP", "LNP", "AttnCNP", "AttnLNP", "ConvCNP", "ConvLNP")
BIG = 1e8  # the oracle's noise on the non-context diagonal

__all__ = ["MODELS", "wide_range", "draw_ctx", "make_ctx_mask", "oracle_lls", "load_model",
           "eval_criterion", "score_batch", "model_scorer", "oracle_scorer", "score_model",
           "row_of", "main"]


def wide_range(sampler: GPSampler) -> tuple:
    """Twice the sampler's range: the functions' x in [-2, 2] in training
    units."""
    lo, hi = sampler.min_max
    return (2.0 * lo, 2.0 * hi)


def draw_ctx(generator: torch.Generator, batch: int, n_points: int,
             max_cntxt: int = MAX_CNTXT) -> tuple:
    """The context draws of a batch: counts n ~ U{0..max_cntxt} [B, 1] and
    uniform scores [B, n_points], from `generator` on its device."""
    device = generator.device
    n = torch.randint(0, max_cntxt + 1, (batch, 1), generator=generator, device=device)
    return n, torch.rand((batch, n_points), generator=generator, device=device)


def make_ctx_mask(x: torch.Tensor, n: torch.Tensor, u: torch.Tensor,
                  max_cntxt: int = MAX_CNTXT) -> torch.Tensor:
    """The JAX script's context mask from its draws: of the `max_cntxt`
    points with the lowest scores `u` (+inf on the outer points, ties to
    the lower index, as `lax.top_k` orders them) the first n, keeping only
    inner points (|x| <= 1). A function with fewer inner points than n gets
    fewer contexts than n, as in JAX. x [B, N, 1], n [B, 1], u [B, N] ->
    bool [B, N]."""
    inner = x[..., 0].abs() <= 1.0
    scores = u + torch.where(inner, 0.0, math.inf)
    idx = torch.sort(scores, dim=-1, stable=True)[1][:, :max_cntxt]
    sel = torch.arange(max_cntxt, device=x.device)[None, :] < n
    sel = sel & inner.gather(1, idx)
    return torch.zeros_like(inner).scatter(1, idx, sel)


def oracle_lls(sampler: GPSampler, x: torch.Tensor, y: torch.Tensor, mask_c: torch.Tensor,
               mask_t: torch.Tensor) -> torch.Tensor:
    """The exact GP's per-function log-likelihood summed over the targets
    `mask_t`, conditioned on the contexts `mask_c`, as the JAX script's
    `oracle_lls`: the sampler's covariance in its own units (no jitter),
    `sample_jitter` on the context diagonal and `BIG` on every other
    (solving the full system reproduces the context-only one to
    O(1 / BIG) without ragged shapes), one float32 solve for the mean and
    the variances, each variance at least 1e-8 before the jitter is added
    back. x, y [B, N, 1], masks [B, N] -> [B]."""
    lo, hi = sampler.min_max
    xn = (x + 1.0) * 0.5 * (hi - lo) + lo
    K = sampler._cov(xn, sampler.length_scale, jitter=0.0)
    jit = sampler.sample_jitter
    A = K + torch.diag_embed(torch.where(mask_c, jit, BIG))
    yc = torch.where(mask_c[..., None], y, 0.0)
    sol = torch.linalg.solve(A, torch.cat([yc, K], dim=-1))
    mean = (K @ sol[..., :1])[..., 0]
    var = torch.clamp(torch.diagonal(K, dim1=-2, dim2=-1)
                      - torch.sum(K * sol[..., 1:].transpose(-1, -2), dim=-1), min=1e-8) + jit
    ll = -0.5 * ((y[..., 0] - mean) ** 2 / var + torch.log(2 * math.pi * var))
    return torch.where(mask_t, ll, 0.0).sum(dim=-1)


def load_model(kernel: str, name: str, device="cuda", use_kernels: bool = True,
               results: str = RESULTS) -> torch.nn.Module:
    """`results/<kernel>/<name>/run_0`'s weights in `gp_model_1d(name)` (the
    default BatchNorm eps, as the JAX script builds it), a conv model on a
    grid over twice its own induced range; loaded strictly, in eval mode on
    `device`."""
    model = gp_model_1d(name, use_kernels=use_kernels)
    if hasattr(model, "induced_range"):
        model = gp_model_1d(name, use_kernels=use_kernels,
                            induced_range=tuple(2.0 * v for v in model.induced_range))
    run_dir = os.path.join(results, kernel, name, "run_0")
    model.load_state_dict(params_from_flax(*load_run_params(run_dir)), strict=True)
    return model.to(device).eval()


def eval_criterion(name: str):
    """The family's eval criterion as the JAX script's trainer holds it:
    `gp_criterion(name)` (its eval forces NPML) summed per function."""
    return dataclasses.replace(gp_criterion(name), reduction=None)


def score_batch(model: torch.nn.Module, criterion, x: torch.Tensor, y: torch.Tensor,
                mask_c: torch.Tensor, generator: torch.Generator = None, eps=None) -> tuple:
    """One forward over every target, scored twice: (interpolation LLs [B],
    extrapolation LLs [B]) under `criterion` (`eval_criterion`). A latent
    model draws from `generator`, or takes its z noise `eps`."""
    inner = x[..., 0].abs() <= 1.0
    out = model(x, y, x, mask_cntxt=mask_c, mask_trgt=torch.ones_like(inner), y_trgt=y,
                generator=generator, eps=eps)
    return tuple(-criterion(out, y, m, train=False) for m in (inner, ~inner))


def model_scorer(model: torch.nn.Module, name: str):
    """`score_model`'s scorer of a model (`score_batch` under the family's
    `eval_criterion`), the model in eval mode."""
    criterion = eval_criterion(name)
    model.eval()
    return lambda sampler, x, y, mask_c, generator: score_batch(model, criterion, x, y, mask_c,
                                                                generator)


def oracle_scorer(sampler: GPSampler, x: torch.Tensor, y: torch.Tensor, mask_c: torch.Tensor,
                  generator: torch.Generator = None) -> tuple:
    """`score_model`'s scorer of the exact GP (`oracle_lls` under both
    masks)."""
    inner = x[..., 0].abs() <= 1.0
    return tuple(oracle_lls(sampler, x, y, mask_c, m) for m in (inner, ~inner))


def _sizes(n_test: int) -> list:
    """The batches' sizes: `score.n_scored(n_test)` functions in batches of
    256 (whole batches from 256 on, as the JAX script scores
    `n_test // 256`; below 256 one batch of exactly `n_test`)."""
    n = gw_score.n_scored(n_test)
    return [min(EVAL_BATCH, n - i) for i in range(0, n, EVAL_BATCH)]


def score_model(scorer, kernel: str, n_test: int = 2560, n_points: int = 256,
                max_cntxt: int = MAX_CNTXT, device="cuda", seed: int = EVAL_SEED) -> dict:
    """{interp, extrap: per-function LLs [n], seconds} of `scorer`
    (`model_scorer` or `oracle_scorer`) over the batches of
    `_sizes(n_test)`, drawn (functions, then counts and scores, then z)
    from one generator seeded `seed`."""
    sampler = GPSampler(n_points=n_points, **KERNEL_CONFIGS[kernel])
    wide = wide_range(sampler)
    generator = torch.Generator(device=device).manual_seed(seed)
    li, le = [], []
    t0 = time.perf_counter()
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for size in _sizes(n_test):
            x, y = sampler.sample(generator, size, min_max=wide)
            mask_c = make_ctx_mask(x, *draw_ctx(generator, size, n_points, max_cntxt), max_cntxt)
            a, b = scorer(sampler, x, y, mask_c, generator)
            li.append(a)
            le.append(b)
        li, le = (torch.cat(t).cpu().numpy() for t in (li, le))
    return dict(interp=li, extrap=le, seconds=time.perf_counter() - t0)


def row_of(name: str, kernel: str, res: dict) -> dict:
    """The JAX script's row of per-function LLs."""
    li, le = res["interp"], res["extrap"]
    return {"model": "oracle_gp" if name == "oracle" else name, "kernel": kernel,
            "interp_ll_per_fn": float(li.mean()), "extrap_ll_per_fn": float(le.mean()),
            "interp_std": float(li.std()), "extrap_std": float(le.std()),
            "n_test": int(li.shape[0])}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default=",".join(MODELS))
    ap.add_argument("--kernel", default="RBF_Kernel", choices=tuple(KERNEL_CONFIGS))
    ap.add_argument("--n-test", type=int, default=2560)
    ap.add_argument("--n-points", type=int, default=256)
    ap.add_argument("--max-cntxt", type=int, default=MAX_CNTXT)
    ap.add_argument("--out", required=True, metavar="DIR",
                    help="writes DIR/extrapolation_{kernel}.json (not under results/)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        check_out_dir(args.out, os.path.join(RESULTS, args.kernel), RESULTS)
    except ValueError as e:
        ap.error(str(e))
    set_numerics()
    rows = []
    for name in args.models.split(","):
        if name == "oracle":
            scorer = oracle_scorer
        else:
            run_dir = os.path.join(RESULTS, args.kernel, name, "run_0")
            if not os.path.exists(os.path.join(run_dir, "params.msgpack")):
                print(json.dumps({"model": name, "skipped": "no checkpoint"}))
                continue
            scorer = model_scorer(load_model(args.kernel, name, args.device), name)
        res = score_model(scorer, args.kernel, args.n_test, args.n_points, args.max_cntxt,
                          args.device)
        row = row_of(name, args.kernel, res)
        rows.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"extrapolation_{args.kernel}.json"), "w") as f:
        json.dump(rows, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
