"""Score a GP run: the port's counterpart of `experiments/reeval.py`, under
the eval protocol of `experiments/reproduce_gp.py`.

    python -m npf_gwwaveform_tpu_torch.score_gp --run-dir DIR [--n-test 10000]
        [--seed 123] [--device cuda] [--out DIR] [--bf16]

Each of the run's kernels (one, or RBF, Periodic and Noisy Matern for
`All_Kernels`, their rows concatenated) draws `n_test // 256` batches of 256
fresh functions of 128 points (from 256 on; below, exactly `n_test`), splits
each into a context of U{0..50} points drawn per function (`is_indep_n`) and
all 128 points as targets, and records per function the NPML
log-likelihood (NPML over the z draws without importance weights; a
deterministic model has one draw) at the model's own eval draws (ConvLNP
32 or 16, LNP 32, AttnLNP 8). A run trained with q(z|C,T) (an ELBO-trained
ablation run, and LNP and AttnLNP, trained with NPVI) samples z from
q(z|C,T), since the eval forward sees the targets, as JAX's `_eval_step`
does. Every family's model comes from `configs.gp_model_from_summary`:
the conv family (K1, and K2 for ConvCNP), and the set and attention family
(CNP, LNP, AttnCNP, AttnLNP: K2, its decoder, on n_z x 256 x 128 rows). Kernel c's draws (functions, splits, z) come from one generator seeded
`seed + c`; `seed` is `EVAL_SEED` (123, the seed `reproduce_gp.py`'s eval
key is made from; Philox cannot replay that threefry stream, so the draws
are the port's own). On CUDA, where enough batches follow to pay for its
capture, a kernel's first batch runs eagerly and every later one is a replay
of one CUDA graph that holds all of it, the sampling included. `--bf16`
scores in bfloat16 compute (the run's float32 parameters, every module in
bf16 as `reproduce_gp.py --bf16` builds it, the log-likelihoods float32):
a run directory records no dtype, so a run trained in bf16 is rescored
with `--bf16`.

It prints one JSON line. With `--out` it also writes `eval.csv` (one
log-likelihood per function) and the run's summary with the new scores
(`mean_test_ll`, `std_test_ll`, `n_test`, `eval_protocol`) and
`rescored_from` into that directory, which may be neither the run
directory nor under `results/` (`check_out_dir`; `score_img` shares both).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from . import score as gw_score
from .configs import gp_model_from_summary
from .data.datasplit import CntxtTrgtSplitter, GetRandomIndcs, get_all_indcs
from .data.gp import KERNEL_CONFIGS, GPSampler, MixtureGPSampler
from .losses import npml_loss
from .training.checkpoint import load_run_params, params_from_flax
from .utils.cuda_graph import StepGraph
from .utils.helpers import set_numerics

EVAL_BATCH = 256
EVAL_SEED = 123
N_POINTS = 128
N_CONTEXT = 50  # contexts of U{0..50} points, training and eval
ALL_KERNELS = ("RBF_Kernel", "Periodic_Kernel", "Noisy_Matern_Kernel")
KERNELS = tuple(KERNEL_CONFIGS) + ("All_Kernels",)

__all__ = ["EVAL_BATCH", "EVAL_SEED", "N_CONTEXT", "ALL_KERNELS", "KERNELS", "samplers",
           "load_model", "eval_splitter", "score_batch", "batch_graph", "score_model",
           "score_run", "check_out_dir", "write_scores", "main"]


def samplers(kernel: str) -> tuple:
    """(training sampler, eval samplers) of a kernel name: `All_Kernels`
    trains on the uniform mixture of RBF, Periodic and Noisy Matern and
    evaluates each component's functions in turn."""
    if kernel == "All_Kernels":
        comps = tuple(GPSampler(n_points=N_POINTS, **KERNEL_CONFIGS[k]) for k in ALL_KERNELS)
        return MixtureGPSampler(comps), comps
    if kernel not in KERNEL_CONFIGS:
        raise ValueError(f"kernel={kernel!r}: one of {', '.join(KERNELS)}")
    s = GPSampler(n_points=N_POINTS, **KERNEL_CONFIGS[kernel])
    return s, (s,)


def load_model(run_dir: str, device="cuda", use_kernels: bool = True,
               dtype: Optional[torch.dtype] = None) -> torch.nn.Module:
    """The GP run's model (`configs.gp_model_from_summary`) with its trained
    weights, loaded strictly, in eval mode on `device`."""
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    model = gp_model_from_summary(summary, use_kernels=use_kernels, dtype=dtype)
    model.load_state_dict(params_from_flax(*load_run_params(run_dir)), strict=True)
    return model.to(device).eval()


def eval_splitter() -> CntxtTrgtSplitter:
    """Contexts of U{0..50} points drawn per function, every point a target."""
    return CntxtTrgtSplitter(contexts_getter=GetRandomIndcs(a=0.0, b=N_CONTEXT, is_indep_n=True),
                             targets_getter=get_all_indcs)


def score_batch(model, splitter, generator, sampler, batch: int = EVAL_BATCH) -> tuple:
    """(per-function log-likelihood [batch], NPFOutput) of `batch` fresh
    functions drawn, split and (for a latent model) given z draws from
    `generator`, in that order."""
    x, y = sampler.sample(generator, batch)
    b = splitter(generator, x, y)
    out = model(b["X_cntxt"], b["Y_cntxt"], b["X_trgt"], mask_cntxt=b["mask_cntxt"],
                mask_trgt=b["mask_trgt"], y_trgt=b["Y_trgt"], generator=generator)
    return -npml_loss(out, b["Y_trgt"], b["mask_trgt"], use_iw=False), out


def batch_graph(model, splitter, generator, sampler, batch: int = EVAL_BATCH) -> StepGraph:
    """`score_batch`'s log-likelihoods as a CUDA graph with `generator`
    registered: each replay draws what the next eager batch would. Make it
    after an eager `score_batch` of the same model and sampler (no warm-up
    calls), under `torch.inference_mode`."""
    return StepGraph(lambda: score_batch(model, splitter, generator, sampler, batch)[0], [],
                     model, [generator], warmup_calls=0)


def score_model(model, kernel: str, n_test: int = 10_000, device="cuda",
                seed: int = EVAL_SEED) -> dict:
    """Score `model` on `score.n_scored(n_test)` functions (whole batches of
    256 from 256 on, as `reproduce_gp.py` scores `n_test // 256`; below 256
    exactly `n_test`) of each of the kernel's
    eval samplers (kernel c's draws from a generator seeded `seed + c`) ->
    {ll [n] concatenated, graphs: the batch graphs made, seconds}. On CUDA a
    kernel's first batch runs eagerly; when at least
    `score.GRAPH_MIN_REPLAYS` batches follow, they replay its graph."""
    device = torch.device(device)
    splitter = eval_splitter()
    n = gw_score.n_scored(n_test)
    lls, graphs = [], []
    t0 = time.perf_counter()
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for c, sampler in enumerate(samplers(kernel)[1]):
            generator = torch.Generator(device=device).manual_seed(seed + c)
            sizes = [min(EVAL_BATCH, n - i) for i in range(0, n, EVAL_BATCH)]
            graphed = device.type == "cuda" and len(sizes) - 1 >= gw_score.GRAPH_MIN_REPLAYS
            graph = None
            for size in sizes:
                if graph is not None and size == EVAL_BATCH:
                    lls.append(graph.replay().clone())
                    continue
                lls.append(score_batch(model, splitter, generator, sampler, size)[0])
                if graphed and graph is None:  # after the eager batch above
                    graph = batch_graph(model, splitter, generator, sampler)
                    graphs.append(graph)
        ll = torch.cat(lls).cpu().numpy() if lls else np.zeros((0,), np.float32)
    return dict(ll=ll, graphs=graphs, seconds=time.perf_counter() - t0)


def score_run(run_dir: str, n_test: int = 10_000, device="cuda", seed: int = EVAL_SEED,
              use_kernels: bool = True, dtype: Optional[torch.dtype] = None) -> dict:
    """Score a GP run directory (`score_model` on its loaded model) ->
    {run_dir, kernel, model, device, n, mean_ll, std_ll, seconds, ll,
    graphs}."""
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    model = load_model(run_dir, device, use_kernels, dtype)
    res = score_model(model, summary["kernel"], n_test, device, seed)
    ll = res["ll"]
    return dict(run_dir=run_dir, kernel=summary["kernel"], model=summary["model"],
                device=str(torch.device(device)), n=int(ll.shape[0]),
                mean_ll=float(ll.mean()), std_ll=float(ll.std()), seconds=res["seconds"],
                ll=ll, graphs=res["graphs"])


def check_out_dir(out: Optional[str], run_dir: str, results: str = "results") -> None:
    """Refuse an output directory that is the run's or lies under `results`."""
    if out is None:
        return
    path = os.path.realpath(out)
    if path == os.path.realpath(run_dir):
        raise ValueError("--out is the run directory; the scorer never writes into it")
    root = os.path.realpath(results)
    if path == root or path.startswith(root + os.sep):
        raise ValueError(f"--out {out} lies under {results}/; the scorer never writes there")


def write_scores(out_dir: str, summary: dict, ll: np.ndarray, **extra) -> dict:
    """Write `eval.csv` and `summary.json` (the given summary with the
    scores `reproduce_gp.py` records, `eval_protocol` "indep_n", and
    `extra`) into `out_dir`. Returns the summary written."""
    os.makedirs(out_dir, exist_ok=True)
    np.savetxt(os.path.join(out_dir, "eval.csv"), ll, delimiter=",")
    summary = dict(summary, mean_test_ll=float(ll.mean()), std_test_ll=float(ll.std()),
                   n_test=int(ll.size), eval_protocol="indep_n", **extra)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--n-test", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=EVAL_SEED)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="write eval.csv and summary.json here (not the run, not results/)")
    ap.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    args = ap.parse_args(argv)
    try:
        check_out_dir(args.out, args.run_dir)
    except ValueError as e:
        ap.error(str(e))
    set_numerics()
    res = score_run(args.run_dir, args.n_test, args.device, args.seed,
                    dtype=torch.bfloat16 if args.bf16 else None)
    if args.out is not None:
        with open(os.path.join(args.run_dir, "summary.json")) as f:
            summary = json.load(f)
        write_scores(args.out, summary, res["ll"], rescored_from=args.run_dir,
                     rescored_device=res["device"])
    line = {k: v for k, v in res.items() if k not in ("ll", "graphs")}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
