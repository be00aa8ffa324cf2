"""How the early training loss of a configuration depends on the initial
draw.

    python -m npf_gwwaveform_tpu_torch.loss_by_seed [--seeds 10] [--steps 500]
        [--batch 32] [--device cuda] [--run-dir RUN_DIR] [--first-seed 0] [--bf16]

For each seed first-seed..first-seed+seeds-1, draws the model from the port's init with that seed
and trains it as `chip_smoke.py` does (`train_gw.build_trainer`, `train`),
then prints the median per-step loss over steps 1-50, 51-100, 251-500 and
the last 50, and the 50-step means and medians, one line per seed, then one JSON line
with the same numbers. The configuration is the flagship's, or with
`--run-dir` the one that run recorded (`configs.train_config`: its
architecture, data, learning rate, decay and clip), in float32 or with
`--bf16` in bfloat16 compute. Writes nothing.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .configs import gw_train_summary, train_config
from .train_gw import build_trainer, train
from .utils.helpers import set_numerics


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--first-seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--run-dir", default=None, help="train that run's configuration")
    ap.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    args = ap.parse_args(argv)
    set_numerics()
    if args.run_dir is None:
        summary = gw_train_summary()
    else:
        with open(os.path.join(args.run_dir, "summary.json")) as f:
            summary = train_config(json.load(f))
    rows = []
    for seed in range(args.first_seed, args.first_seed + args.seeds):
        trainer = build_trainer(summary, args.steps, args.device, seed=seed,
                                dtype=torch.bfloat16 if args.bf16 else None)
        history, losses, seconds, _ = train(trainer, summary, args.steps, args.batch)
        losses = losses.cpu().numpy()
        row = dict(seed=seed, seconds=seconds,
                   median_1_50=float(np.median(losses[:50])),
                   median_51_100=float(np.median(losses[50:100])),
                   median_251_500=float(np.median(losses[250:500])),
                   median_last_50=float(np.median(losses[-50:])),
                   means_50=[h["train_loss"] for h in history],
                   medians_50=[float(np.median(losses[i:i + 50]))
                               for i in range(0, len(losses), 50)])
        rows.append(row)
        print(f"seed {seed}: median loss over steps 1-50 {row['median_1_50']:.2f}, 51-100 "
              f"{row['median_51_100']:.2f}, 251-500 {row['median_251_500']:.2f}, the last 50 "
              f"{row['median_last_50']:.2f}; {args.steps} steps in {seconds:.1f}s", flush=True)
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
