"""Score an image run under the eval protocol of
`experiments/reproduce_img.py`, the port's counterpart of its eval and of
`experiments/zsmms_diag.py`.

    python -m npf_gwwaveform_tpu_torch.score_img --run-dir DIR [--n-test N]
        [--seed 123] [--device cuda] [--out DIR] [--diag] [--bf16]

The run's test images (`n_test // 32` batches of 32; all of them by
default: 160 for `digits` and `rgb_digits`, 256 for `rgb_digits128`, 1,024
for `zsmms`, on its 32x32 two-digit canvas) are in-painted from a context
of U{0..30%} of the pixels, the count drawn per image (`RandomMasker(0,
0.3, is_indep_n=True)`), every pixel a target; each image's score is the
log-likelihood summed over its pixels (NPML over the z draws without
importance weights: GridConvLNP 32 draws, LNP 32, AttnLNP 8; LNP and
AttnLNP, trained with q(z|C,T), sample from it, as JAX's eval forward sees
the targets). The grid models take the masks; the point models padded
point sets of the pixels (`PointsFromGridSplitter`), at coordinates scaled
by the corpus's `test_upscale_factor` (1.6 on `zsmms`). The masks and z
draws come from one generator seeded `seed` (`EVAL_SEED`, the seed of
`reproduce_img.py`'s eval key; Philox cannot replay that threefry stream,
so the draws are the port's own). On CUDA the first batch runs eagerly and
every later one is a replay of one CUDA graph that holds all of it, the
masks and draws included.

`--diag` scores a zsmms grid run four ways, as `zsmms_diag.py` does:
`test_canvas` (the protocol above), `train_canvas` (the first 1,024 train
images, on the 20x20 canvas), `test_canvas_batchstats` (BatchNorm on each
batch's statistics, a latent model at its eval draws, the running
statistics left as they were) and `test_canvas_adapted` (the running
statistics re-estimated on the test images first,
`training.adapt.adapt_batch_stats`, 50 passes from a generator seeded 7).

`--bf16` (with `--diag` too) scores in bfloat16 compute: the run's float32
parameters and statistics, every module in bf16 as
`reproduce_img.build_model(name, dtype=jnp.bfloat16)` builds it, the
log-likelihoods float32. A run directory records no dtype.

It prints one JSON line. With `--out` it also writes `eval.csv` and the
run's summary with the new scores into that directory (`score_gp`'s
`write_scores` and `check_out_dir`: never the run directory, never under
`results/`).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from .configs import GRID_MODELS, img_model_from_summary
from .data.datasplit import GridCntxtTrgtSplitter, PointsFromGridSplitter, RandomMasker, no_masker
from .data.images import get_train_test_img_dataset
from .losses import npml_loss
from .score_gp import check_out_dir, write_scores
from .training.adapt import adapt_batch_stats
from .training.checkpoint import load_run_params, params_from_flax
from .utils.cuda_graph import StepGraph
from .utils.helpers import set_numerics

EVAL_BATCH = 32
EVAL_SEED = 123
CONTEXT_RATIO = 0.3  # contexts of U{0..30%} of the pixels, training and eval
ADAPT_SEED, ADAPT_PASSES = 7, 50

__all__ = ["EVAL_BATCH", "EVAL_SEED", "CONTEXT_RATIO", "read_summary", "n_conv_layers",
           "load_model", "test_upscale", "splitter_for", "score_batch", "score_images",
           "score_run", "diag", "main"]


def read_summary(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "summary.json")) as f:
        return json.load(f)


def n_conv_layers(params: dict) -> int:
    """A grid run's conv layers a block: 2, or 1 where its first block has
    no `conv1` (an earlier build)."""
    block = params.get("induced_to_induced", {}).get("block_0", {})
    return 2 if "conv1" in block or not block else 1


def load_model(run_dir: str, device="cuda", use_kernels: bool = True,
               dtype: Optional[torch.dtype] = None) -> torch.nn.Module:
    """The image run's model (`configs.img_model_from_summary`, compute
    `dtype`) with its trained weights, loaded strictly, in eval mode on
    `device`. A run
    without `extra_vars.msgpack` keeps the initial BatchNorm statistics
    (mean 0, variance 1), as the JAX package's loader does."""
    params, extra = load_run_params(run_dir)
    model = img_model_from_summary(read_summary(run_dir), use_kernels,
                                   n_conv_layers=n_conv_layers(params), dtype=dtype)
    state = params_from_flax(params, extra)
    if not extra:
        buffers = dict(model.named_buffers())
        state.update({k: v.clone() for k, v in buffers.items() if k not in state})
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()


def test_upscale(dataset) -> float:
    """The coordinate scale of a corpus's test canvas (1 but on `zsmms`)."""
    return getattr(dataset, "test_upscale_factor", 1.0)


def splitter_for(model_name: str, upscale_factor: float = 1.0, indep_n: bool = True):
    """The image splitter of a model: grid masks for the grid family, point
    sets at `upscale_factor` for the point models; contexts of U{0..30%}
    pixels, the count per image (`indep_n`, eval) or per batch (training)."""
    masker = RandomMasker(a=0.0, b=CONTEXT_RATIO, is_indep_n=indep_n)
    if model_name in GRID_MODELS:
        return GridCntxtTrgtSplitter(context_masker=masker, target_masker=no_masker)
    return PointsFromGridSplitter(context_masker=masker, upscale_factor=upscale_factor)


def score_batch(model, splitter, generator, y) -> tuple:
    """(per-image log-likelihood [B], NPFOutput) of images y [B, H, W, C]
    split (and a latent model's z drawn) from `generator`."""
    b = splitter(generator, y, y)
    out = model(b["X_cntxt"], b["Y_cntxt"], b["X_trgt"], mask_cntxt=b["mask_cntxt"],
                mask_trgt=b["mask_trgt"], y_trgt=b["Y_trgt"], generator=generator)
    return -npml_loss(out, b["Y_trgt"], b["mask_trgt"], use_iw=False), out


def score_images(model, splitter, images: torch.Tensor, device="cuda", seed: int = EVAL_SEED,
                 batch: int = EVAL_BATCH, graphed: Optional[bool] = None) -> dict:
    """Score `images` [N, H, W, C] in `N // batch` batches (one batch of N
    below `batch`; the first eager, the others replayed from its CUDA graph
    when `graphed`, by default on CUDA) -> {ll [n], graph (or None),
    seconds}. The model runs in the mode it is in."""
    device = torch.device(device)
    batch = min(batch, images.shape[0])
    n_batches = images.shape[0] // batch
    imgs = images[:n_batches * batch].to(device)
    graphed = device.type == "cuda" if graphed is None else graphed
    g = torch.Generator(device=device).manual_seed(seed)
    lls, graph = [], None
    t0 = time.perf_counter()
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for i in range(n_batches):
            y = imgs[i * batch:(i + 1) * batch]
            if graph is not None:
                lls.append(graph.replay(y).clone())
                continue
            lls.append(score_batch(model, splitter, g, y)[0])
            if graphed and n_batches > 1:  # after the eager batch above
                graph = StepGraph(lambda yb: score_batch(model, splitter, g, yb)[0],
                                  [y.clone()], model, [g], warmup_calls=0)
        ll = torch.cat(lls).cpu().numpy() if lls else np.zeros((0,), np.float32)
    return dict(ll=ll, graph=graph, seconds=time.perf_counter() - t0)


def score_run(run_dir: str, n_test: Optional[int] = None, device="cuda", seed: int = EVAL_SEED,
              use_kernels: bool = True, graphed: Optional[bool] = None,
              dtype: Optional[torch.dtype] = None) -> dict:
    """Score an image run directory on its test images (the first
    `n_test`, all by default) in compute `dtype` -> {run_dir, dataset,
    model, device, n, mean_ll, std_ll, seconds, ll, graph}."""
    summary = read_summary(run_dir)
    model = load_model(run_dir, device, use_kernels, dtype)
    _, test = get_train_test_img_dataset(summary["dataset"])
    images = test.images if n_test is None else test.images[:n_test]
    res = score_images(model, splitter_for(summary["model"], test_upscale(test)), images,
                       device, seed, graphed=graphed)
    ll = res["ll"]
    return dict(run_dir=run_dir, dataset=summary["dataset"], model=summary["model"],
                device=str(torch.device(device)), n=int(ll.shape[0]),
                mean_ll=float(ll.mean()), std_ll=float(ll.std()), seconds=res["seconds"],
                ll=ll, graph=res["graph"])


def diag(run_dir: str, device="cuda", seed: int = EVAL_SEED, n_test: Optional[int] = None,
         graphed: Optional[bool] = None, adapt_passes: int = ADAPT_PASSES,
         dtype: Optional[torch.dtype] = None) -> dict:
    """`zsmms_diag.py`'s four mean LLs of a zsmms grid run (module
    docstring) on the first `n_test` images of each canvas (1,024), each
    from a generator seeded `seed`; the adaptation takes `adapt_passes`
    passes over all the test images; the model computes in `dtype`."""
    summary = read_summary(run_dir)
    if summary["dataset"] != "zsmms" or summary["model"] not in GRID_MODELS:
        raise ValueError(f"--diag diagnoses a zsmms grid run, not {summary['model']} on "
                         f"{summary['dataset']}")
    model = load_model(run_dir, device, dtype=dtype)
    train, test = get_train_test_img_dataset("zsmms")
    n = 1024 if n_test is None else n_test
    splitter = splitter_for(summary["model"])
    test_imgs, train_imgs = test.images[:n], train.images[:n]

    def mean(m, imgs):
        return float(score_images(m, splitter, imgs, device, seed, graphed=graphed)["ll"].mean())

    out = {"model": summary["model"], "run": os.path.basename(os.path.normpath(run_dir)),
           "test_canvas": mean(model, test_imgs), "train_canvas": mean(model, train_imgs)}
    stats_mode = copy.deepcopy(model).train()  # its running statistics move, then are dropped
    stats_mode.n_z_samples_train = stats_mode.n_z_samples_test
    out["test_canvas_batchstats"] = mean(stats_mode, test_imgs)
    adapted = copy.deepcopy(model)
    adapt_batch_stats(adapted, splitter, test.images.to(device),
                      torch.Generator(device=torch.device(device)).manual_seed(ADAPT_SEED),
                      adapt_passes, EVAL_BATCH)
    out["test_canvas_adapted"] = mean(adapted, test_imgs)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--n-test", type=int, default=None, help="the first N test images (all)")
    ap.add_argument("--seed", type=int, default=EVAL_SEED)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="write eval.csv and summary.json here (not the run, not results/)")
    ap.add_argument("--diag", action="store_true", help="zsmms_diag.py's four rows")
    ap.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    args = ap.parse_args(argv)
    dtype = torch.bfloat16 if args.bf16 else None
    try:
        check_out_dir(args.out, args.run_dir)
    except ValueError as e:
        ap.error(str(e))
    set_numerics()
    if args.diag:
        line = diag(args.run_dir, args.device, args.seed, args.n_test, dtype=dtype)
        if args.out is not None:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "zsmms_diag.json"), "w") as f:
                json.dump(line, f, indent=2)
        print(json.dumps(line))
        return line
    res = score_run(args.run_dir, args.n_test, args.device, args.seed, dtype=dtype)
    if args.out is not None:
        write_scores(args.out, read_summary(args.run_dir), res["ll"],
                     rescored_from=args.run_dir, rescored_device=res["device"])
    line = {k: v for k, v in res.items() if k not in ("ll", "graph")}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
