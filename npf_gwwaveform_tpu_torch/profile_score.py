"""Where the time of one scoring batch goes on the card.

    python -m npf_gwwaveform_tpu_torch.profile_score --run-dir DIR [--reps 5]

Scores one 256-waveform batch of the run's recorded thetas a few times to
warm up, then once under `torch.profiler` (CPU and CUDA activity). Prints the
batch's wall time, the device time summed over kernels, their ratio (the
device's busy share of the batch) and the kernels with the most device time,
then one JSON line with the same numbers. Writes nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .data.gw import GWParameterSpace
from .score import eval_splitter, load_model, read_run_thetas, run_generator, score_batch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_score: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(args.run_dir, "summary.json")) as f:
        summary = json.load(f)
    model = load_model(args.run_dir, "cuda")
    gen, space = run_generator(summary), GWParameterSpace()
    splitter = eval_splitter(summary["n_context"])
    theta = torch.from_numpy(read_run_thetas(args.run_dir)[:256]).cuda()

    def one_batch():
        g = torch.Generator(device="cuda").manual_seed(0)
        score_batch(model, splitter, g, theta, gen, space)
        torch.cuda.synchronize()

    with torch.inference_mode():
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            one_batch()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one_batch()
            traced_wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_us = sum(e.self_device_time_total for e in kernels)
    wall_ms = 1e3 * float(np.median(walls))
    print(f"{torch.cuda.get_device_name(0)}: one batch {wall_ms:.3f} ms wall (median of "
          f"{args.reps}, untraced); traced {1e3 * traced_wall:.3f} ms wall, "
          f"{device_us / 1e3:.3f} ms device time, busy share "
          f"{device_us / 1e3 / (1e3 * traced_wall):.3f}")
    top = []
    for e in kernels[:args.top]:
        share = e.self_device_time_total / device_us if device_us else 0.0
        print(f"  {e.self_device_time_total / 1e3:9.4f} ms  {share:6.1%}  x{e.count:<4d} {e.key[:90]}")
        top.append(dict(name=e.key[:120], device_ms=e.self_device_time_total / 1e3, calls=e.count))
    print(json.dumps(dict(wall_ms=wall_ms, traced_wall_ms=1e3 * traced_wall,
                          device_ms=device_us / 1e3, n_kernels=len(kernels), top=top)))


if __name__ == "__main__":
    main()
