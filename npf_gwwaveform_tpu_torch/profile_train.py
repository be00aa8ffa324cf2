"""Where the time of one train step of the flagship configuration goes on the
card.

    python -m npf_gwwaveform_tpu_torch.profile_train [--batch 32] [--reps 10] [--bf16]

Builds the flagship model from the port's init (seed 0) and takes `--reps`
train steps to warm up, timing each on the host clock (each ends in a device
synchronise), then traces one more under `torch.profiler` (CPU and CUDA
activity). Each step is annotated data (waveforms and split), forward (model
and loss, train mode), backward, optimizer (Adam): the device time of the
kernels launched inside each range is attributed to it, and backward is the
rest, since autograd launches its kernels from its own thread; the part of
it in the two SetConv backwards (stock PyTorch ops, a named range) is
reported too. Prints the
step's wall time, the device time, the busy share (device time over the
traced step's wall time, and over the untraced median), the split by phase
and the kernels with the most device time, then one JSON line with the same
numbers. `--bf16` trains in bfloat16 compute. Writes nothing.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from .configs import gw_train_summary
from .data.gw import GWParameterSpace
from .score import make_eval_batch, run_generator
from .train_gw import build_trainer
from .utils.helpers import set_numerics

PHASES = ("data", "forward", "optimizer")
SETCONV_BWD = "setconv_exprbf_bwd"  # the named range of the stock-op SetConv backward


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    set_numerics()
    dtype = torch.bfloat16 if args.bf16 else None
    summary = gw_train_summary()
    trainer = build_trainer(summary, 200_000, "cuda", dtype=dtype)
    gen, space = run_generator(summary), GWParameterSpace()
    g = trainer.state.generator

    def one_step():
        with record_function("data"):
            theta = space.sample(args.batch, g)
            x, y, cond = make_eval_batch(theta, gen, space)
            batch = trainer.splitter(g, x, y, condition=cond)
        with record_function("forward"):
            trainer.model.train()
            trainer.state.optimizer.zero_grad()
            loss = trainer.criterion(trainer._forward(batch), batch["Y_trgt"], batch["mask_trgt"],
                                     train=True)
        with record_function("backward"):
            loss.backward()
        with record_function("optimizer"):
            trainer.state.optimizer.step()
        torch.cuda.synchronize()

    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        one_step()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_step()
        traced_wall = time.perf_counter() - t0
    # the profiler mirrors each record_function range (ours and the
    # optimizer's) as a device-side annotation spanning its kernels: not a kernel
    ranges = {e.key for e in prof.key_averages() if e.device_type == DeviceType.CPU}
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0 and e.key not in ranges]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    phases = {p: sum(e.device_time_total for e in prof.events()
                     if e.name == p and e.device_type == DeviceType.CPU) / 1e3
              for p in PHASES}
    phases["backward"] = device_ms - sum(phases.values())
    phases["of which setconv backward"] = sum(
        e.device_time_total for e in prof.events()
        if e.name == SETCONV_BWD and e.device_type == DeviceType.CPU) / 1e3
    wall_ms = 1e3 * float(np.median(walls))
    print(f"{torch.cuda.get_device_name(0)}: one train step at batch {args.batch}: "
          f"{wall_ms:.3f} ms wall (median of {args.reps}, untraced, "
          f"{1e3 * args.batch / wall_ms:.0f} wf/s); traced {1e3 * traced_wall:.3f} ms wall, "
          f"{device_ms:.3f} ms device time; busy share {device_ms / (1e3 * traced_wall):.3f} "
          f"of the traced step, "
          f"{device_ms / wall_ms:.3f} of the untraced one")
    print("  device ms by phase: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
    top = []
    for e in kernels[:args.top]:
        share = e.self_device_time_total / 1e3 / device_ms if device_ms else 0.0
        print(f"  {e.self_device_time_total / 1e3:9.4f} ms  {share:6.1%}  x{e.count:<4d} "
              f"{e.key[:90]}")
        top.append(dict(name=e.key[:120], device_ms=e.self_device_time_total / 1e3, calls=e.count))
    res = dict(bf16=args.bf16, batch=args.batch, wall_ms=wall_ms, traced_wall_ms=1e3 * traced_wall,
               device_ms=device_ms, busy_share=device_ms / (1e3 * traced_wall),
               busy_share_untraced=device_ms / wall_ms,
               phases_device_ms=phases, n_kernels=len(kernels), top=top)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
