"""Score a frozen GW ConvCNP run: the port's counterpart of the eval block of
`experiments/reproduce_gw.py` (`--eval-only`).

Each eval batch (256 waveforms) generates time-domain waveforms at 1024 Hz
over the run's `duration` (1 s unless the summary says otherwise), keeps
`n_points` evenly strided samples of them (256 unless the summary says
otherwise: every 4th of 1024) on x in [-1, 1], splits them into
a context of U{0..n_context} points per waveform and all points as targets,
conditions on the normalised parameters, and records per waveform the NPML
log-likelihood and the white-noise mismatch of the predictive mean.

    python -m npf_gwwaveform_tpu_torch.score --run-dir DIR [--n-test N]
        [--thetas-from-run] [--device cuda]

prints one JSON line and writes nothing. `--thetas-from-run` scores the
parameters recorded in the run's `mismatch_theta.csv`, in order.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .configs import gw_model_from_summary
from .data.datasplit import CntxtTrgtSplitter, GetRandomIndcs, get_all_indcs
from .data.gw import GWParameterSpace, GWWaveformGenerator, mismatch
from .losses import CNPFLoss
from .models.convnp import ConvCNP
from .training.checkpoint import load_run_params, params_from_flax
from .utils.helpers import linspace

EVAL_BATCH = 256
SAMPLE_RATE = 1024.0  # experiments/reproduce_gw.py builds its generator at 1024 Hz

__all__ = ["load_model", "read_run_thetas", "run_generator", "make_eval_batch", "eval_splitter",
           "score_batch", "score_run"]


def load_model(run_dir: str, device="cuda", use_kernels: bool = True) -> ConvCNP:
    """The run's model with its trained weights, in eval mode on `device`."""
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    model = gw_model_from_summary(summary, use_kernels=use_kernels)
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
                    n_points: int = 256):
    """theta [B,4] -> (x [B,n_points,1], y [B,n_points,1], condition [B,4])."""
    stride = gen.n_time // n_points
    _, h = gen.time_domain(theta)
    h = h[:, gen.n_time - n_points * stride::stride][:, :n_points]
    x = linspace(-1.0, 1.0, n_points, device=theta.device)
    x = x[None, :, None].expand(theta.shape[0], n_points, 1)
    return x, h[..., None], space.normalize(theta)


def score_batch(model, splitter, generator, theta, gen, space, n_points: int = 256):
    """Per-waveform (log-likelihood [B], mismatch [B], NPFOutput) of one batch."""
    x, y, cond = make_eval_batch(theta, gen, space, n_points)
    batch = splitter(generator, x, y, condition=cond)
    out = model(batch["X_cntxt"], batch["Y_cntxt"], batch["X_trgt"],
                 mask_cntxt=batch["mask_cntxt"], mask_trgt=batch["mask_trgt"],
                 condition=batch["condition"])
    ll = -CNPFLoss(reduction=None)(out, batch["Y_trgt"], batch["mask_trgt"], train=False)
    pred = out.p_yCc.loc.mean(dim=0)
    return ll, mismatch(pred[..., 0], y[..., 0]), out


def eval_splitter(n_context: int) -> CntxtTrgtSplitter:
    """The eval split: per-waveform context counts U{0..n_context}."""
    return CntxtTrgtSplitter(
        contexts_getter=GetRandomIndcs(a=0.0, b=n_context, is_indep_n=True),
        targets_getter=get_all_indcs,
    )


def score_run(run_dir: str, n_test: int = 2048, thetas_from_run: bool = False,
              device="cuda", seed: int = 0, use_kernels: bool = True) -> dict:
    """Score `n_test` waveforms of the run; returns the summary metrics plus
    the per-waveform arrays under `ll` and `mismatch`."""
    device = torch.device(device)
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    model = load_model(run_dir, device, use_kernels)
    gen, space = run_generator(summary), GWParameterSpace()
    n_points = summary.get("n_points", 256)
    splitter = eval_splitter(summary["n_context"])
    generator = torch.Generator(device=device).manual_seed(seed)
    if thetas_from_run:
        thetas = torch.from_numpy(read_run_thetas(run_dir)[:n_test]).to(device)
    else:
        thetas = space.sample(n_test, generator)
    lls, mms = [], []
    t0 = time.perf_counter()
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for i in range(0, thetas.shape[0], EVAL_BATCH):
            ll, mm, _ = score_batch(model, splitter, generator, thetas[i:i + EVAL_BATCH], gen,
                                    space, n_points)
            lls.append(ll)
            mms.append(mm)
        ll = torch.cat(lls).cpu().numpy()
        mm = torch.cat(mms).cpu().numpy()
    seconds = time.perf_counter() - t0
    return {
        "run_dir": run_dir,
        "device": str(device),
        "n": int(ll.shape[0]),
        "mean_ll": float(ll.mean()),
        "median_mismatch": float(np.median(mm)),
        "mismatch_p90": float(np.percentile(mm, 90)),
        "frac_below_0.1": float((mm < 0.1).mean()),
        "seconds": seconds,
        "ll": ll,
        "mismatch": mm,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--n-test", type=int, default=2048)
    ap.add_argument("--thetas-from-run", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    res = score_run(args.run_dir, args.n_test, args.thetas_from_run, args.device, args.seed)
    print(json.dumps({k: v for k, v in res.items() if k not in ("ll", "mismatch")}))


if __name__ == "__main__":
    main()
