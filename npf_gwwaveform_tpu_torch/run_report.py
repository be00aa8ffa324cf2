"""Read what a run directory records: the quality bands a rescoring of the
run must land in, and a run's training history beside another's.

    python -m npf_gwwaveform_tpu_torch.run_report bands [--results results/] [--set | --img | --gp]
        [--bf16]
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
0.0030] it has used since the run was first scored. After a blank line it
prints every conv-family GP run (`gp_runs`): its recorded mean LL over its
`eval.csv` and the band by the same rule at half their count (9,984 ->
4,992 resampled), LL only (`gp_band`). With `--set` it prints instead the
57 set and attention GP runs (`gp_set_runs`) the same way, and with `--img`
the 21 image runs (`img_runs`: per-image log-likelihoods, 160, 256 or
1,024 a run), each run's band by the GP runs' rule (`gp_band`); the one
grid run without BatchNorm statistics (no `extra_vars.msgpack`,
`img_rescorable`) is marked as not rescored.

With `--bf16` (and `--gp` or `--img`) it prints instead the bf16 bars of
the GP bar runs (`gp_bf16_bar_runs`) or the image bar runs
(`img_bf16_bar_runs`) from `tests/jax_bf16_family_gaps.json`: the JAX
package's float32 band (`f32_bands`, the port's float32 rescoring's bar),
JAX's own bf16-float32 mean-LL gap with the fused MLP-chain decoder (what
the port's kernel path computes) and with the Dense decoder (the plain
path), each with its count, and the bar a port bf16 rescoring's gap is held
to (`bf16_gap_bar`) before the port's own standard error joins it: the
fused gap within the larger of `BF16_GAP_TOL` nats and `BF16_GAP_SES`
standard errors of it.

`history` prints, at steps 10,000, 50,000, 100,000, 150,000 and 200,000,
the 50-step train loss that ends there and the mean over the 1,000 steps
that end there, for both runs.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional

import numpy as np

from .configs import GRID_MODELS, SET_MODELS

__all__ = ["recorded_scores", "bands_of", "score_bands", "gp_band", "gp_runs", "gp_set_runs",
           "IMG_DATASETS", "img_rescorable", "img_runs", "scored_runs", "history_at",
           "GP_BF16_BARS", "IMG_BF16_BARS", "BF16_GAP_TOL", "BF16_GAP_SES", "gp_bf16_bar_runs",
           "img_bf16_bar_runs", "bf16_gap_bar", "main"]


# the image corpora with runs under results/
IMG_DATASETS = ("digits", "rgb_digits", "rgb_digits128", "zsmms")
N_BOOT, N_RESAMPLE, QUANTILE, WIDEN, BOOT_SEED = 10_000, 1024, 0.99, 0.5, 0
HISTORY_STEPS, HISTORY_WINDOW = (10_000, 50_000, 100_000, 150_000, 200_000), 1000
# the runs scored in bf16 against the JAX package's own bf16 gap: each GP
# family's RBF and Matern run_0 and the ELBO ConvLNP ablation run (three K1
# launches), and the image families' digits runs, a circular zsmms grid run
# and the XL
GP_BF16_BARS = tuple(os.path.join(k, m, "run_0") for k in ("RBF_Kernel", "Matern_Kernel")
                     for m in ("ConvCNP", "ConvLNP", "CNP", "LNP", "AttnCNP", "AttnLNP")) + (
    os.path.join("RBF_Kernel", "ConvLNP_ELBOTrue_LatLBFalse_SigLBFalse", "run_0"),)
IMG_BF16_BARS = tuple(os.path.join("digits", m, "run_0") for m in (
    "GridConvCNP", "GridConvLNP", "CNP", "LNP", "AttnCNP", "AttnLNP")) + (
    os.path.join("zsmms", "GridConvCNP", "run_1"),
    os.path.join("rgb_digits128", "GridConvCNPXL", "run_0"))
# a bf16 rescoring's bf16-float32 mean-LL gap must lie within the larger of
# 0.3 nats and 3 standard errors of its difference from the JAX package's
# own gap
BF16_GAP_TOL, BF16_GAP_SES = 0.3, 3.0
# the JAX package's bf16 gaps and float32 bands (tests/jax_bf16_family_gaps.py)
GAPS_JSON = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests",
                         "jax_bf16_family_gaps.json")


def recorded_scores(run_dir: str) -> tuple:
    """(per-waveform log-likelihoods, per-waveform mismatches) as the run
    recorded them."""
    ll = np.loadtxt(os.path.join(run_dir, "eval.csv"), delimiter=",", ndmin=1)
    mm = np.loadtxt(os.path.join(run_dir, "mismatch_theta.csv"), delimiter=",", ndmin=2)[:, 0]
    return ll, mm


def bands_of(ll: np.ndarray, mm: Optional[np.ndarray] = None,
             n_resample: int = N_RESAMPLE) -> dict:
    """{"mean_ll": (lo, hi), "median_mismatch": (lo, hi)}: each statistic's
    99% bootstrap interval at `n_resample` of the per-waveform values (1024,
    half a GW run's 2048), widened by half its half-width on each side;
    without `mm` (a GP run) the LL's only."""
    idx = np.random.default_rng(BOOT_SEED).integers(0, ll.shape[0], (N_BOOT, n_resample))
    stats = [("mean_ll", ll[idx].mean(axis=1))]
    if mm is not None:
        stats.append(("median_mismatch", np.median(mm[idx], axis=1)))
    out = {}
    for name, stat in stats:
        lo, hi = np.quantile(stat, [(1 - QUANTILE) / 2, (1 + QUANTILE) / 2])
        half = (hi - lo) / 2
        out[name] = (float(lo - WIDEN * half), float(hi + WIDEN * half))
    return out


def score_bands(run_dir: str) -> dict:
    """`bands_of` the run's recorded scores."""
    return bands_of(*recorded_scores(run_dir))


def gp_band(run_dir: str) -> tuple:
    """A GP run's mean-LL band: `bands_of` its recorded per-function
    log-likelihoods at half their count (9,984 -> 4,992)."""
    ll = np.loadtxt(os.path.join(run_dir, "eval.csv"), delimiter=",", ndmin=1)
    return bands_of(ll, n_resample=ll.shape[0] // 2)["mean_ll"]


def gp_runs(results: str = "results") -> list:
    """The conv-family GP run directories under `results` that hold
    parameters (the five kernels and `All_Kernels`; ConvCNP, ConvLNP and
    the ConvLNP ablation grid), sorted."""
    return sorted(os.path.dirname(p) for p in glob.glob(
        os.path.join(results, "*_Kernel*", "Conv*", "run_*", "params.msgpack")))


def gp_set_runs(results: str = "results") -> list:
    """The set and attention family's GP run directories under `results`
    that hold parameters (CNP, LNP, AttnCNP and AttnLNP of the five kernels
    and `All_Kernels`, the LNP and AttnLNP objective-ablation grids and
    `LNP_SUMO`), sorted."""
    return sorted(os.path.dirname(p) for p in glob.glob(
        os.path.join(results, "*_Kernel*", "*", "run_*", "params.msgpack"))
        if p.split(os.sep)[-3].split("_")[0] in SET_MODELS)


def img_rescorable(run_dir: str) -> bool:
    """Whether an image run can be rescored: a grid model's BatchNorm needs
    the running statistics of its `extra_vars.msgpack`, without which it
    would score at its init statistics (`reproduce_img.py`)."""
    return (os.path.basename(os.path.dirname(os.path.normpath(run_dir))) not in GRID_MODELS
            or os.path.exists(os.path.join(run_dir, "extra_vars.msgpack")))


def img_runs(results: str = "results", scored: bool = False) -> list:
    """The image run directories under `results` that hold parameters
    (`IMG_DATASETS`), sorted; with `scored` those `img_rescorable`."""
    runs = sorted(os.path.dirname(p) for d in IMG_DATASETS for p in glob.glob(
        os.path.join(results, d, "*", "run_*", "params.msgpack")))
    return [r for r in runs if img_rescorable(r)] if scored else runs


def gp_bf16_bar_runs(results: str = "results") -> list:
    """The GP bar runs' directories (`GP_BF16_BARS`)."""
    return [os.path.join(results, r) for r in GP_BF16_BARS]


def img_bf16_bar_runs(results: str = "results") -> list:
    """The image bar runs' directories (`IMG_BF16_BARS`)."""
    return [os.path.join(results, r) for r in IMG_BF16_BARS]


def bf16_gap_bar(gap: dict, port_se: float = 0.0) -> tuple:
    """(centre, half-width) of the bar on a port bf16 rescoring's mean-LL
    gap, from a run's `bf16_gap` entry of tests/jax_bf16_family_gaps.json:
    JAX's fused-decoder gap, within the larger of BF16_GAP_TOL and
    BF16_GAP_SES standard errors of the difference of the two gaps: JAX's
    (its per-function differences' sd over the square root of its count)
    and the port's own, `port_se`, since the port scores other draws."""
    fused = gap["fused"]
    se = float(np.hypot(fused["d_ll_std"] / np.sqrt(gap["n"]), port_se))
    return fused["d_mean_ll"], max(BF16_GAP_TOL, BF16_GAP_SES * se)


def _bf16_table(runs: list, results: str, gaps: dict) -> None:
    """A markdown table of bar runs: JAX's float32 band, its fused and Dense
    bf16 gaps with their count, and `bf16_gap_bar`."""
    print("| Bar run | JAX f32 band | n | JAX fused gap | JAX Dense gap | Port gap bar |")
    print("| --- | --- | --- | --- | --- | --- |")
    for run_dir in runs:
        name = os.path.relpath(run_dir, results)
        entry = gaps.get(name, {})
        band = entry.get("f32_bands", {}).get("mean_ll")
        band = "n/a" if band is None else f"[{band[0]:.2f}, {band[1]:.2f}]"
        gap = entry.get("bf16_gap")
        if gap is None:
            print(f"| `{name}` | {band} | not taken | | | |")
            continue
        c, h = bf16_gap_bar(gap)
        f, d = gap["fused"], gap["dense"]
        print(f"| `{name}` | {band} | {gap['n']} | {f['d_mean_ll']:+.3f} (sd {f['d_ll_std']:.3f}) "
              f"| {d['d_mean_ll']:+.3f} (sd {d['d_ll_std']:.3f}) | [{c - h:+.3f}, {c + h:+.3f}] |")


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


def _gp_table(runs: list, results: str, kind: str = "GP run", unit: str = "Functions") -> None:
    """A markdown table of GP (or image) runs: functions (images), recorded
    mean LL, `gp_band`."""
    print(f"| {kind} | {unit} | Recorded mean LL | LL band |")
    print("| --- | --- | --- | --- |")
    for run_dir in runs:
        name = os.path.relpath(run_dir, results)
        ll = np.loadtxt(os.path.join(run_dir, "eval.csv"), delimiter=",", ndmin=1)
        l0, l1 = gp_band(run_dir)
        band = f"[{l0:.2f}, {l1:.2f}]" if img_rescorable(run_dir) else "not rescored"
        print(f"| `{name}` | {ll.shape[0]} | {ll.mean():.2f} | {band} |")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("bands")
    b.add_argument("--results", default="results")
    kind = b.add_mutually_exclusive_group()
    kind.add_argument("--set", action="store_true",
                      help="the set and attention family's GP runs instead")
    kind.add_argument("--img", action="store_true", help="the image runs instead")
    kind.add_argument("--gp", action="store_true", help="with --bf16: the GP bar runs")
    b.add_argument("--bf16", action="store_true",
                   help="the bf16 gap bars of the GP (--gp) or image (--img) bar runs")
    h = sub.add_parser("history")
    h.add_argument("--run", required=True)
    h.add_argument("--ref", required=True)
    args = ap.parse_args(argv)
    if args.cmd == "bands" and args.bf16:
        if not (args.gp or args.img):
            ap.error("--bf16 takes --gp or --img")
        with open(GAPS_JSON) as f:
            gaps = json.load(f)
        runs = (gp_bf16_bar_runs if args.gp else img_bf16_bar_runs)(args.results)
        _bf16_table(runs, args.results, gaps)
        return
    if args.cmd == "bands" and args.gp:
        ap.error("--gp takes --bf16 (the conv-family GP runs' bands print by default)")
    if args.cmd == "bands" and args.img:
        _gp_table(img_runs(args.results), args.results, "Image run", "Images")
        return
    if args.cmd == "bands" and args.set:
        _gp_table(gp_set_runs(args.results), args.results)
        return
    if args.cmd == "bands":
        print("| Run | Recorded mean LL | LL band | Recorded median mismatch | Mismatch band |")
        print("| --- | --- | --- | --- | --- |")
        for run_dir in scored_runs(args.results) + scored_runs(args.results, "ConvLNP"):
            ll, mm = recorded_scores(run_dir)
            bands = score_bands(run_dir)
            (l0, l1), (m0, m1) = bands["mean_ll"], bands["median_mismatch"]
            print(f"| `{os.path.relpath(run_dir, args.results)}` | {ll.mean():.2f} | "
                  f"[{l0:.2f}, {l1:.2f}] | {np.median(mm):.5f} | [{m0:.5f}, {m1:.5f}] |")
        print()
        _gp_table(gp_runs(args.results), args.results)
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
