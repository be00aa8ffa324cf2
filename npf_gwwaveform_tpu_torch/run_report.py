"""Read what a run directory records: the quality bands a rescoring of the
run must land in, and a run's training history beside another's.

    python -m npf_gwwaveform_tpu_torch.run_report bands [--results results/]
    python -m npf_gwwaveform_tpu_torch.run_report history --run RUN_DIR --ref RUN_DIR

`bands` prints a markdown table of every GW ConvCNP run under `--results`
that holds parameters (time-domain and frequency-domain), then every GW
ConvLNP run: its recorded mean LL and median mismatch
(from `eval.csv` and `mismatch_theta.csv`) and the band around each
(`score_bands`). A rescoring on the run's own recorded thetas differs from
the record only in its context draws, so the bands come from the recorded
per-waveform values: the 99% interval of the statistic over 10,000
bootstrap resamples of 1024 of them (drawn from seed 0) (half the 2048, which widens the
interval by about sqrt(2)), widened again by half its half-width on each
side. For the flagship run this gives [883.9, 905.5] and [0.00143, 0.00300];
`chip_smoke.py` holds that run to the rounder [885, 905] and [0.0016,
0.0030] it has used since the run was first scored.

`history` prints, at steps 10,000, 50,000, 100,000, 150,000 and 200,000,
the 50-step train loss that ends there and the mean over the 1,000 steps
that end there, for both runs.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

__all__ = ["recorded_scores", "bands_of", "score_bands", "scored_runs", "history_at", "main"]

N_BOOT, N_RESAMPLE, QUANTILE, WIDEN, BOOT_SEED = 10_000, 1024, 0.99, 0.5, 0
HISTORY_STEPS, HISTORY_WINDOW = (10_000, 50_000, 100_000, 150_000, 200_000), 1000


def recorded_scores(run_dir: str) -> tuple:
    """(per-waveform log-likelihoods, per-waveform mismatches) as the run
    recorded them."""
    ll = np.loadtxt(os.path.join(run_dir, "eval.csv"), delimiter=",", ndmin=1)
    mm = np.loadtxt(os.path.join(run_dir, "mismatch_theta.csv"), delimiter=",", ndmin=2)[:, 0]
    return ll, mm


def bands_of(ll: np.ndarray, mm: np.ndarray) -> dict:
    """{"mean_ll": (lo, hi), "median_mismatch": (lo, hi)}: each statistic's
    99% bootstrap interval at 1024 of the per-waveform values, widened by
    half its half-width on each side."""
    idx = np.random.default_rng(BOOT_SEED).integers(0, ll.shape[0], (N_BOOT, N_RESAMPLE))
    out = {}
    for name, stat in (("mean_ll", ll[idx].mean(axis=1)),
                       ("median_mismatch", np.median(mm[idx], axis=1))):
        lo, hi = np.quantile(stat, [(1 - QUANTILE) / 2, (1 + QUANTILE) / 2])
        half = (hi - lo) / 2
        out[name] = (float(lo - WIDEN * half), float(hi + WIDEN * half))
    return out


def score_bands(run_dir: str) -> dict:
    """`bands_of` the run's recorded scores."""
    return bands_of(*recorded_scores(run_dir))


def scored_runs(results: str = "results", model: str = "ConvCNP") -> list:
    """The GW run directories of `model` ("ConvCNP": time-domain and
    frequency-domain; "ConvLNP": the four latent runs) under `results` that
    hold parameters, sorted."""
    return sorted(os.path.dirname(p) for p in glob.glob(
        os.path.join(results, "GW_*", model, "run_*", "params.msgpack")))


def history_at(history: list, step: int) -> tuple:
    """(the history entry's 50-step loss at `step`, the mean of the entries
    over the HISTORY_WINDOW steps that end there), or (None, None) if the run
    did not reach `step`."""
    by_step = {h["step"]: h["train_loss"] for h in history}
    if step not in by_step:
        return None, None
    inside = [v for s, v in by_step.items() if step - HISTORY_WINDOW < s <= step]
    return by_step[step], float(np.mean(inside))


def _fmt(x, digits):
    return "n/a" if x is None else f"{x:.{digits}f}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("bands")
    b.add_argument("--results", default="results")
    h = sub.add_parser("history")
    h.add_argument("--run", required=True)
    h.add_argument("--ref", required=True)
    args = ap.parse_args(argv)
    if args.cmd == "bands":
        print("| Run | Recorded mean LL | LL band | Recorded median mismatch | Mismatch band |")
        print("| --- | --- | --- | --- | --- |")
        for run_dir in scored_runs(args.results) + scored_runs(args.results, "ConvLNP"):
            ll, mm = recorded_scores(run_dir)
            bands = score_bands(run_dir)
            (l0, l1), (m0, m1) = bands["mean_ll"], bands["median_mismatch"]
            print(f"| `{os.path.relpath(run_dir, args.results)}` | {ll.mean():.2f} | "
                  f"[{l0:.2f}, {l1:.2f}] | {np.median(mm):.5f} | [{m0:.5f}, {m1:.5f}] |")
        return
    hist = {}
    for key in ("run", "ref"):
        with open(os.path.join(getattr(args, key), "history.json")) as f:
            hist[key] = json.load(f)
    print("| Step | Run, 50-step loss | Run, 1,000-step mean | Ref, 50-step loss | "
          "Ref, 1,000-step mean |")
    print("| --- | --- | --- | --- | --- |")
    for step in HISTORY_STEPS:
        run, ref = history_at(hist["run"], step), history_at(hist["ref"], step)
        print(f"| {step} | {_fmt(run[0], 1)} | {_fmt(run[1], 1)} | {_fmt(ref[0], 1)} | "
              f"{_fmt(ref[1], 1)} |")


if __name__ == "__main__":
    main()
