"""How the early training loss of the flagship configuration depends on the
initial draw.

    python -m npf_gwwaveform_tpu_torch.loss_by_seed [--seeds 10] [--steps 500]
        [--batch 32] [--device cuda]

For each seed 0..seeds-1, draws the model from the port's init with that seed
and trains it as `chip_smoke.py` does (`train_gw.build_trainer`, `train`),
then prints the median per-step loss over steps 1-50, 51-100 and 251-500 and
the 50-step means, one line per seed, then one JSON line with the same
numbers. Writes nothing.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .configs import gw_train_summary
from .train_gw import build_trainer, train


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    summary = gw_train_summary()
    rows = []
    for seed in range(args.seeds):
        trainer = build_trainer(summary, args.steps, args.device, seed=seed)
        history, losses, seconds, _ = train(trainer, summary, args.steps, args.batch)
        losses = losses.cpu().numpy()
        row = dict(seed=seed, seconds=seconds,
                   median_1_50=float(np.median(losses[:50])),
                   median_51_100=float(np.median(losses[50:100])),
                   median_251_500=float(np.median(losses[250:500])),
                   means_50=[h["train_loss"] for h in history])
        rows.append(row)
        print(f"seed {seed}: median loss over steps 1-50 {row['median_1_50']:.2f}, 51-100 "
              f"{row['median_51_100']:.2f}, 251-500 {row['median_251_500']:.2f}; "
              f"{args.steps} steps in {seconds:.1f}s", flush=True)
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
