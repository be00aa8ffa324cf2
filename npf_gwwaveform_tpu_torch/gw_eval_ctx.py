"""Context-budget sweep of a frozen GW run: mismatch quantiles against the
eval-time context count. The port's counterpart of
`experiments/gw_eval_ctx.py`.

    python -m npf_gwwaveform_tpu_torch.gw_eval_ctx RUN_DIR --out DIR
        [--ctx 16,32,64,128,192] [--fixed] [--n-test 1024] [--n-points N]
        [--device cuda]
    python -m npf_gwwaveform_tpu_torch.gw_eval_ctx --plot RUN_OR_OUT_DIR ... --out DIR [--fixed]

For each count n of `--ctx` it scores `n_test // 256` batches of 256
waveforms (below 256 exactly `n_test`: `score.n_scored`) of the run's
time-domain task (`score.make_eval_batch`: 1024 Hz over the run's
duration, `--n-points` evenly strided samples, the run's own count by
default) with the run's eval protocol at n
(`score.eval_splitter`: U{0..n} contexts drawn per waveform, or exactly n
with `--fixed`; every point a target), conditioned where the run was, and
records each waveform's mismatch of the mean of its predictive locs over
the z draws (`score.score_batch`) and its chirp mass. A row holds p50, p90
and p99 of the mismatch, p50 and p90 over the waveforms at or below the
33.3rd percentile of chirp mass, and the fraction below 0.03
(`sweep_row`). It prints one JSON line a count and writes the rows to
`DIR/<run tag>/ctx_sweep.json` (`ctx_sweep_fixed.json` with `--fixed`),
the run tag being the last three parts of the run's path (e.g.
`GW_time_cond_film_ctx64/ConvCNP/run_0` below `results/`). `DIR` may not
lie in the tree of runs that holds the run (`runs_root`: `results/` for a
record), where the JAX script writes, and so the sweep never lands in the
run directory (`check_out`). Each count's draws (thetas, then each
batch's split) come from one generator seeded 0 (`SEED`); Philox cannot
replay JAX's threefry stream, so they are the port's own. Every batch
runs eagerly (a sweep scores four batches a count by default, fewer than
the `score.GRAPH_MIN_REPLAYS` that pay for a CUDA graph).

`--plot` overlays the saved sweeps of the given directories (each a run
directory or a directory this script wrote into) into
`DIR/gw_ctx_sweep.png` (`_fixed.png` with `--fixed`) as the JAX script
draws them; matplotlib is imported there. `DIR` may be none of the given
directories nor lie in a run's tree of runs.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import score as gw_score
from .data.gw import GWParameterSpace
from .score_gp import check_out_dir
from .utils.helpers import set_numerics

COUNTS = (16, 32, 64, 128, 192)
SEED = 0
PALETTE = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100"]  # fixed categorical order

__all__ = ["COUNTS", "chirp_mass", "sweep_row", "sweep_name", "runs_root", "run_tag",
           "check_out", "sweep", "plot", "main"]


def chirp_mass(theta: np.ndarray) -> np.ndarray:
    """(m1 m2)^(3/5) / (m1 + m2)^(1/5) of thetas [n, 4], in their dtype (the
    JAX script computes it in float32)."""
    return (theta[:, 0] * theta[:, 1]) ** 0.6 / (theta[:, 0] + theta[:, 1]) ** 0.2


def sweep_row(n_context: int, mm: np.ndarray, mc: np.ndarray) -> dict:
    """The JAX script's row of one count from the per-waveform mismatches
    and chirp masses."""
    lo = mc <= np.percentile(mc, 33.3)
    return {"n_context": int(n_context), "p50": float(np.median(mm)),
            "p90": float(np.percentile(mm, 90)), "p99": float(np.percentile(mm, 99)),
            "low_mc_tercile_p50": float(np.median(mm[lo])),
            "low_mc_tercile_p90": float(np.percentile(mm[lo], 90)),
            "frac_below_0.03": float((mm < 0.03).mean())}


def sweep_name(fixed: bool) -> str:
    return "ctx_sweep_fixed.json" if fixed else "ctx_sweep.json"


def runs_root(run_dir: str) -> str:
    """The tree of runs that holds `run_dir` (<root>/<config>/<model>/run_N):
    its directory three levels up, `results/` for a record."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.realpath(run_dir))))


def run_tag(run_dir: str) -> str:
    """The run's path below its tree of runs (e.g.
    `GW_time_cond_film_ctx64/ConvCNP/run_0`)."""
    return os.path.relpath(os.path.realpath(run_dir), runs_root(run_dir))


def check_out(out: str, run_dir: str, final: str) -> None:
    """Refuse an `out` in the tree of runs that holds `run_dir`, and a
    `final` directory (where the file lands) that is the run's, whatever
    the working directory (`score_gp.check_out_dir`)."""
    check_out_dir(out, run_dir, runs_root(run_dir))
    if os.path.realpath(final) == os.path.realpath(run_dir):
        raise ValueError("--out would put the file into the run directory")


def sweep(run_dir: str, counts=COUNTS, fixed: bool = False, n_test: int = 1024,
          n_points=None, device="cuda") -> dict:
    """{rows, mismatch {n: [n_wf]}, theta {n: [n_wf, 4]}, seconds} of the
    sweep. Refuses a frequency-domain run: the JAX script feeds it
    time-domain waveforms, which the port does not reproduce."""
    device = torch.device(device)
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    if summary.get("mode", "time") != "time":
        raise NotImplementedError(f"mode={summary.get('mode')!r}: the sweep scores time-domain "
                                  "runs")
    model = gw_score.load_model(run_dir, device)
    gen, space = gw_score.run_generator(summary), GWParameterSpace()
    n_points = int(summary.get("n_points", 256) if n_points is None else n_points)
    n_wf = gw_score.n_scored(n_test)
    rows, mms, thetas = [], {}, {}
    t0 = time.perf_counter()
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for n_ctx in counts:
            splitter = gw_score.eval_splitter(n_ctx, fixed)
            generator = torch.Generator(device=device).manual_seed(SEED)
            theta = space.sample(n_wf, generator)
            mm = torch.cat([gw_score.score_batch(model, splitter, generator, t, gen, space,
                                                 n_points)[1]
                            for t in theta.split(gw_score.EVAL_BATCH)]).cpu().numpy()
            th = theta.cpu().numpy()
            rows.append(sweep_row(n_ctx, mm, chirp_mass(th)))
            mms[n_ctx], thetas[n_ctx] = mm, th
    return dict(rows=rows, mismatch=mms, theta=thetas, seconds=time.perf_counter() - t0)


def plot(dirs, out_dir: str, fixed: bool = False) -> str:
    """Overlay the saved sweeps of `dirs` (p50 and p90 against the count, log
    scale, the 0.03 and 0.1 bars) into `out_dir/gw_ctx_sweep.png`
    (`_fixed.png` with `fixed`), as the JAX script's `plot` draws them."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = os.path.join(out_dir, "gw_ctx_sweep_fixed.png" if fixed else "gw_ctx_sweep.png")
    fig, axes = plt.subplots(1, 2, figsize=(9.5, 3.6), sharex=True)
    for rd, color in zip(dirs, PALETTE):
        with open(os.path.join(rd, sweep_name(fixed))) as f:
            rows = json.load(f)
        label = os.path.basename(os.path.dirname(os.path.dirname(rd.rstrip("/"))))
        label = label.replace("GW_time_cond_film_", "")
        ctx = [r["n_context"] for r in rows]
        for ax, key in zip(axes, ("p50", "p90")):
            ax.plot(ctx, [r[key] for r in rows], color=color, lw=2, marker="o", ms=5,
                    label=label)
    for ax, (key, bar, barlabel) in zip(
            axes, [("p50", 0.03, "matched-filter bar (0.03)"), ("p90", 0.1, "tail target (0.1)")]):
        ax.axhline(bar, color="#8a8a85", lw=1, ls="--")
        ax.text(17, bar * 1.08, barlabel, fontsize=8, color="#6a6a66")
        ax.set_yscale("log")
        ax.set_xlabel("eval context budget (points of 256)")
        ax.set_title(f"mismatch {key}", fontsize=10)
        ax.grid(True, which="both", color="#ebebe6", lw=0.6)
        ax.set_axisbelow(True)
        for s in ("top", "right"):
            ax.spines[s].set_visible(False)
    axes[0].set_ylabel("mismatch")
    axes[0].legend(fontsize=8, frameon=False, loc="lower left")
    fig.suptitle("Frozen-checkpoint context sweeps: the fine grid absorbs observations, "
                 "the coarse one saturates", fontsize=10)
    fig.tight_layout()
    os.makedirs(out_dir, exist_ok=True)
    fig.savefig(out, dpi=130)
    plt.close(fig)
    print(json.dumps({"figure": out}))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run_dir", nargs="+")
    ap.add_argument("--ctx", default=",".join(str(c) for c in COUNTS))
    ap.add_argument("--fixed", action="store_true",
                    help="exactly n contexts a waveform instead of U{0..n}")
    ap.add_argument("--n-test", type=int, default=1024)
    ap.add_argument("--n-points", type=int, default=None,
                    help="eval waveform length (default: the run's n_points)")
    ap.add_argument("--plot", action="store_true",
                    help="overlay saved ctx_sweep files into one figure")
    ap.add_argument("--out", required=True, metavar="DIR",
                    help="the sweep goes to DIR/<run tag>/ (not in the run's tree of runs)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        for rd in args.run_dir:
            check_out(args.out, rd, args.out if args.plot else os.path.join(args.out, run_tag(rd)))
    except ValueError as e:
        ap.error(str(e))
    if args.plot:
        return plot(args.run_dir, args.out, args.fixed)
    if len(args.run_dir) != 1:
        ap.error("one RUN_DIR a sweep")
    run_dir = args.run_dir[0]
    set_numerics()
    res = sweep(run_dir, [int(c) for c in args.ctx.split(",")], args.fixed, args.n_test,
                args.n_points, args.device)
    for row in res["rows"]:
        print(json.dumps(row), flush=True)
    out_dir = os.path.join(args.out, run_tag(run_dir))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, sweep_name(args.fixed)), "w") as f:
        json.dump(res["rows"], f, indent=2)
    return res["rows"]


if __name__ == "__main__":
    main()
