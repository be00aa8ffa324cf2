"""Score a frozen GW ConvCNP or ConvLNP run: the port's counterpart of the
eval block of `experiments/reproduce_gw.py` (`--eval-only`).

It scores any ConvCNP run `reproduce_gw.py` wrote (the flat CNN, dilated or
not, or the UnetCNN; FiLM, additive or no conditioning; time-domain data, 1 s
or the 2 s long waveforms, or frequency-domain data), and its ConvLNP runs
(NPML at 32 z draws a waveform, the draws from the scoring's generator
after the split; the ELBO run samples from q(z|C,T), since the eval
forward sees the targets, as `reproduce_gw.py`'s does). Each eval batch (256
waveforms) generates waveforms at 1024 Hz over the run's `duration` (1 s
unless the summary says otherwise). In the time domain (`mode` "time") it
keeps `n_points` evenly strided samples of them (256 unless the summary says
otherwise: every 4th of 1024; the long runs keep all 2048); in the
frequency domain (`mode` "freq_ap") it takes amplitude and standardised
phase on `n_points` frequencies from 20 to 1024 Hz, two channels. On x in
[-1, 1] it splits them into a context of U{0..n_context} points per
waveform and all points as targets, conditions on the normalised
parameters where the run was conditioned, and records per waveform the NPML
log-likelihood (NPML over the z draws, without importance weights) and
the mismatch of the predictive mean (the mixture's, over the draws): white-noise and in
the time domain for "time"; for "freq_ap" the aLIGO-weighted
frequency-domain match of h(f) = A exp(-i psi sigma), prediction and truth
both rebuilt with the waveform's true phase std sigma. On
CUDA, where enough batches follow to pay for its capture, the first batch
runs eagerly and every later batch of 256 is one replay of a CUDA graph
that holds all of it, the waveforms and the split included (`batch_graph`).

    python -m npf_gwwaveform_tpu_torch.score --run-dir DIR [--n-test N]
        [--thetas-from-run | --thetas-from RUN_DIR] [--device cuda] [--bf16]

prints one JSON line and writes nothing. Its draws (drawn thetas, context
splits) come from `--seed`, `EVAL_SEED` by default; from `--n-test` 256 on
it scores whole batches of 256, as `reproduce_gw.py` does. `--bf16` scores in bfloat16 compute
(the run's float32 parameters, every module in bf16 as `reproduce_gw.py
--bf16` builds it; log-likelihoods and mismatches stay float32). `--thetas-from-run` scores the
parameters recorded in the run's `mismatch_theta.csv`, in order;
`--thetas-from RUN_DIR` those recorded in another run's, so that a retrained
model is scored on the waveforms a recorded run was scored on.
`write_scores` writes a scoring into a run directory as `reproduce_gw.py`
does: `eval.csv`, `mismatch_theta.csv` and the summary's metric fields.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from .configs import gw_model_from_summary
from .data.datasplit import CntxtTrgtSplitter, GetRandomIndcs, get_all_indcs
from .data.gw import (
    GWParameterSpace, GWWaveformGenerator, make_batch, mismatch, mismatch_fd, polar_conj,
    psd_aligo,
)
from .losses import npml_loss
from .models.convnp import ConvCNP
from .training.checkpoint import load_run_params, params_from_flax
from .utils.cuda_graph import StepGraph
from .utils.helpers import set_numerics

EVAL_BATCH = 256
# the fewest replays of the batch graph that pay for its capture: on an H100
# a capture took 33-113 ms and a replay saved 5.5-6.8 ms against an eager
# batch, 6-18 replays' worth, in float32 and bf16 (`profile_score` prints
# both and their ratio); at 2048 waveforms (seven replays) a graphed
# `score_run` was no faster than the eager one
GRAPH_MIN_REPLAYS = 20
SAMPLE_RATE = 1024.0  # experiments/reproduce_gw.py builds its generator at 1024 Hz
# the seed of every scoring's draws (drawn thetas and context splits), whatever
# seed a run was trained from, so that two runs of a configuration are scored
# on the same waveforms, as `reproduce_gw.py` scores every run from
# fold_in(PRNGKey(123), i); Philox cannot reproduce that threefry stream, so
# the value is the port's own
EVAL_SEED = 0

__all__ = ["EVAL_SEED", "n_scored", "load_model", "read_run_thetas", "run_generator",
           "make_eval_batch", "eval_splitter",
           "score_batch", "batch_graph", "score_run", "summary_metrics", "write_scores"]


def load_model(run_dir: str, device="cuda", use_kernels: bool = True,
               dtype: Optional[torch.dtype] = None) -> ConvCNP:
    """The run's model (a ConvCNP or a ConvLNP) with its trained weights, in
    eval mode on `device`, computing in `dtype` (None: float32)."""
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    model = gw_model_from_summary(summary, use_kernels=use_kernels, dtype=dtype)
    model.load_state_dict(params_from_flax(*load_run_params(run_dir)), strict=True)
    return model.to(device).eval()


def read_run_thetas(run_dir: str) -> np.ndarray:
    """[n, 4] (m1, m2, chi1, chi2) from the run's `mismatch_theta.csv`."""
    table = np.loadtxt(os.path.join(run_dir, "mismatch_theta.csv"), delimiter=",", ndmin=2)
    return table[:, 1:5].astype(np.float32)


def run_generator(summary: dict) -> GWWaveformGenerator:
    """The waveform generator the run was trained and scored with."""
    return GWWaveformGenerator(duration=summary.get("duration", 1.0), sample_rate=SAMPLE_RATE)


def make_eval_batch(theta: torch.Tensor, gen: GWWaveformGenerator, space: GWParameterSpace,
                    n_points: int = 256, mode: str = "time", return_aux: bool = False):
    """theta [B,4] -> (x [B,n_points,1], y [B,n_points,y_dim], condition
    [B,4]) of the run's data (`data.gw.make_batch`), and with `return_aux`
    the per-waveform phase std [B] of "freq_ap" data (None for "time")."""
    batch = make_batch(theta, gen, space, n_points, mode)
    return batch if return_aux else batch[:3]


def _recon(ap: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """(amplitude, standardised phase) [..., 2] and the true phase std
    [B, 1] -> h(f) = A exp(-i psi sigma), complex64: float32 whatever the
    model's compute dtype, as JAX promotes bf16 x f32."""
    ap = ap.float()
    return polar_conj(ap[..., 0], ap[..., 1] * sigma)


def score_batch(model, splitter, generator, theta, gen, space, n_points: int = 256,
                mode: str = "time"):
    """Per-waveform (log-likelihood [B], mismatch [B], per-draw mismatch [B],
    NPFOutput) of one batch. The mismatch is the predictive mixture mean's;
    the per-draw mismatch averages each z draw's mismatch, as
    `reproduce_gw.py`'s `mm_zdraw` (equal for one draw). "time": the
    white-noise time-domain mismatch of the first channel; "freq_ap": the
    aLIGO-weighted `mismatch_fd` of the rebuilt h(f), as `reproduce_gw.py`'s
    `eval_batch` scores that mode. A latent model draws its z from
    `generator` after the split, at [n_z * B, ...] through its post-sampling
    CNN and grid->targets SetConv."""
    x, y, cond, sigma = make_eval_batch(theta, gen, space, n_points, mode, return_aux=True)
    # an unconditioned run is scored with no condition, as reproduce_gw.py does
    batch = splitter(generator, x, y, condition=cond if model.cond_dim > 0 else None)
    out = model(batch["X_cntxt"], batch["Y_cntxt"], batch["X_trgt"],
                 mask_cntxt=batch["mask_cntxt"], mask_trgt=batch["mask_trgt"],
                 condition=batch.get("condition"), y_trgt=batch["Y_trgt"], generator=generator)
    # every loss's eval: NPML without importance weights
    ll = -npml_loss(out, batch["Y_trgt"], batch["mask_trgt"], use_iw=False)
    loc = out.p_yCc.loc
    if mode == "time":
        def mm_of(pred):
            return mismatch(pred[..., 0], y[..., 0])
    else:
        psd = psd_aligo(gen.freqs(n_points, device=theta.device))
        sigma = sigma[:, None]
        h_true = _recon(y, sigma)

        def mm_of(pred):
            return mismatch_fd(_recon(pred, sigma), h_true, psd=psd)
    mm = mm_of(loc.mean(dim=0))
    # one draw (every CNPF model): exactly the mixture's, as reproduce_gw.py records it
    mm_zdraw = mm if loc.shape[0] == 1 else torch.stack([mm_of(l) for l in loc]).mean(dim=0)
    return ll, mm, mm_zdraw, out


def batch_graph(model, splitter, generator, theta, gen, space, n_points: int = 256,
                mode: str = "time") -> StepGraph:
    """`score_batch`'s (log-likelihood, mismatch, per-draw mismatch) for
    thetas shaped as `theta`, as a CUDA graph with `generator` registered: a
    replay takes a batch's thetas and draws its split as the next eager
    batch would. It takes no warm-up calls: make it after an eager
    `score_batch` of the same model and shapes, which made what the capture
    needs (under `torch.inference_mode` a batch moves no state but the
    generator). Run it under `torch.inference_mode`."""
    return StepGraph(
        lambda t: score_batch(model, splitter, generator, t, gen, space, n_points, mode)[:3],
        [theta.clone()], model, [generator], warmup_calls=0)


def eval_splitter(n_context: int, fixed: bool = False) -> CntxtTrgtSplitter:
    """The eval split: per-waveform context counts U{0..n_context}, or with
    `fixed` exactly `n_context` contexts a waveform (`gw_eval_ctx --fixed`);
    every point a target."""
    return CntxtTrgtSplitter(
        contexts_getter=GetRandomIndcs(a=float(n_context) if fixed else 0.0, b=n_context,
                                       is_indep_n=not fixed),
        targets_getter=get_all_indcs,
    )


def n_scored(n_test: int) -> int:
    """How many waveforms `score_run` scores for `n_test`: whole batches of
    256 from 256 on, as `reproduce_gw.py` scores `n_test // 256` of them;
    below 256 exactly `n_test` (`reproduce_gw.py` scores one batch of 256
    there: the port's remaining deviation, which keeps scoring a few
    waveforms cheap)."""
    return n_test if n_test < EVAL_BATCH else n_test // EVAL_BATCH * EVAL_BATCH


def summary_metrics(ll: np.ndarray, mm: np.ndarray, mm_zdraw: np.ndarray) -> dict:
    """The metric fields `reproduce_gw.py` records in a run's summary, from
    per-waveform log-likelihoods and mismatches."""
    return {
        "test_nll_per_wf": float(-ll.mean()),
        "test_ll_per_wf": float(ll.mean()),
        "mismatch_median": float(np.median(mm)),
        "mismatch_mean": float(mm.mean()),
        "mismatch_p90": float(np.percentile(mm, 90)),
        "mismatch_p99": float(np.percentile(mm, 99)),
        "frac_below_0.03": float((mm < 0.03).mean()),
        "frac_below_0.1": float((mm < 0.1).mean()),
        "mismatch_zdraw_median": float(np.median(mm_zdraw)),
        "mismatch_zdraw_p90": float(np.percentile(mm_zdraw, 90)),
        "zdraw_frac_below_0.03": float((mm_zdraw < 0.03).mean()),
    }


def score_run(run_dir: str, n_test: int = 2048, thetas_from: Optional[str] = None,
              device="cuda", seed: int = EVAL_SEED, use_kernels: bool = True,
              dtype: Optional[torch.dtype] = None) -> dict:
    """Score `n_scored(n_test)` waveforms of the run (whole batches of 256
    from 256 on), on thetas drawn from `seed`, or on the first of those
    recorded in the `mismatch_theta.csv` of the run directory `thetas_from`
    (`run_dir` itself included), in compute `dtype`; the context splits are
    drawn from `seed` too. On CUDA,
    when at least `GRAPH_MIN_REPLAYS` batches of 256 follow the first, the
    first runs eagerly and warms up `batch_graph`, and the rest replay it;
    every other batch (the CPU's, a last one short of 256, too few to pay
    for a capture) runs eagerly. Returns `summary_metrics`, the short names
    `mean_ll` and `median_mismatch`, the per-waveform arrays `ll`,
    `mismatch`, `mismatch_zdraw` and `theta` [n, 4], and `graph`: the batch
    graph, or None."""
    device = torch.device(device)
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    model = load_model(run_dir, device, use_kernels, dtype)
    gen, space = run_generator(summary), GWParameterSpace()
    n_points, mode = summary.get("n_points", 256), summary.get("mode", "time")
    splitter = eval_splitter(summary["n_context"])
    generator = torch.Generator(device=device).manual_seed(seed)
    n = n_scored(n_test)
    if thetas_from is not None:
        thetas = torch.from_numpy(read_run_thetas(thetas_from)[:n]).to(device)
    else:
        thetas = space.sample(n, generator)
    graphed = device.type == "cuda" and thetas.shape[0] // EVAL_BATCH - 1 >= GRAPH_MIN_REPLAYS
    graph = None

    lls, mms, mzs = [], [], []
    t0 = time.perf_counter()
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for i in range(0, thetas.shape[0], EVAL_BATCH):
            theta = thetas[i:i + EVAL_BATCH]
            if graph is not None and theta.shape[0] == EVAL_BATCH:
                ll, mm, mz = (t.clone() for t in graph.replay(theta))
            else:
                ll, mm, mz = score_batch(model, splitter, generator, theta, gen, space,
                                         n_points, mode)[:3]
            if graphed and graph is None:  # after the eager batch above
                graph = batch_graph(model, splitter, generator, theta, gen, space, n_points,
                                    mode)
            lls.append(ll)
            mms.append(mm)
            mzs.append(mz)
        ll, mm, mz = (torch.cat(t).cpu().numpy() for t in (lls, mms, mzs))
    seconds = time.perf_counter() - t0
    metrics = summary_metrics(ll, mm, mz)
    return {
        "run_dir": run_dir,
        "thetas_from": thetas_from,
        "device": str(device),
        "n": int(ll.shape[0]),
        "mean_ll": metrics["test_ll_per_wf"],
        "median_mismatch": metrics["mismatch_median"],
        **metrics,
        "seconds": seconds,
        "ll": ll,
        "mismatch": mm,
        "mismatch_zdraw": mz,
        "theta": thetas.cpu().numpy(),
        "graph": graph,
    }


def write_scores(run_dir: str, scores: dict) -> dict:
    """Write a `score_run` result into the run directory as `reproduce_gw.py`
    does: `eval.csv` (one log-likelihood per waveform), `mismatch_theta.csv`
    (each waveform's mismatch and raw theta) and the metric fields merged
    into `summary.json`. Returns the updated summary."""
    np.savetxt(os.path.join(run_dir, "eval.csv"), scores["ll"], delimiter=",")
    np.savetxt(os.path.join(run_dir, "mismatch_theta.csv"),
               np.concatenate([scores["mismatch"][:, None], scores["theta"]], axis=1),
               delimiter=",", header="mismatch,m1,m2,chi1,chi2")
    path = os.path.join(run_dir, "summary.json")
    with open(path) as f:
        summary = json.load(f)
    summary.update(summary_metrics(scores["ll"], scores["mismatch"], scores["mismatch_zdraw"]))
    with open(path, "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--n-test", type=int, default=2048)
    thetas = ap.add_mutually_exclusive_group()
    thetas.add_argument("--thetas-from-run", action="store_true")
    thetas.add_argument("--thetas-from", default=None, metavar="RUN_DIR")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=EVAL_SEED)
    ap.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    args = ap.parse_args(argv)
    set_numerics()
    res = score_run(args.run_dir, args.n_test,
                    args.run_dir if args.thetas_from_run else args.thetas_from, args.device,
                    args.seed, dtype=torch.bfloat16 if args.bf16 else None)
    res = {k: v for k, v in res.items() if k != "graph" and not isinstance(v, np.ndarray)}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
