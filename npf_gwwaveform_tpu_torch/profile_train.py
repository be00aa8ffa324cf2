"""Where the time of one train step of a configuration goes on the card, for
the eager step and for the step replayed from its CUDA graph.

    python -m npf_gwwaveform_tpu_torch.profile_train [--batch 32] [--reps 10] [--bf16]
        [--run-dir RUN_DIR]

Builds the flagship model, or with `--run-dir` the configuration that run
recorded (`configs.train_config`: its architecture, data, learning rate and
clip; a ConvLNP run's latent model, criterion and default clip of 1.0
included), from the port's init (seed 0). First the eager
step: `--reps` steps timed on the host clock (each ends in a device
synchronise), then one more traced under `torch.profiler` (CPU and CUDA
activity). Each eager step is annotated data (waveforms and split), forward
(model and loss, train mode), backward, optimizer (Adam): the device time of
the kernels launched inside each range is attributed to it, and backward is
the rest, since autograd launches its kernels from its own thread; the part
of it in the two SetConv backwards (stock PyTorch ops, a named range) is
reported too. Then the same step captured in a CUDA graph
(`Trainer.generated_graph`, as `train_gw` runs it): `--reps` replays timed
the same way, one traced, and one timed between CUDA events. For each it
prints the step's wall time, the device time (the traced kernels' sum), the
busy share (device time over the traced step's wall time, and over the
untraced median) and the kernels with the most device time; for the graph
also how many kernels one replay launched and the hand kernels among them.
Then one JSON line with both. `--bf16` trains in bfloat16 compute. A GP
run's `--run-dir` (its summary has a `kernel`) profiles its `train_gp`
configuration: `--batch` fresh functions of its kernel a step, sampled
inside the step, in either dtype. Writes nothing.
"""

from __future__ import annotations

import argparse
import json
import os

import torch
from torch.autograd import DeviceType
from torch.profiler import record_function

from . import score_gp, train_gp
from .configs import gw_train_summary, is_gp_summary, train_config
from .kernel_measure import event_ms, hand_kernels, measure_step, top_kernels
from .train_gw import batch_sampler, build_trainer
from .utils.helpers import set_numerics

PHASES = ("data", "forward", "optimizer")
SETCONV_BWD = "setconv_exprbf_bwd"  # the named range of the stock-op SetConv backward


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    ap.add_argument("--run-dir", default=None, help="profile that run's configuration")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    set_numerics()
    dtype = torch.bfloat16 if args.bf16 else None
    record = {}
    if args.run_dir is not None:
        with open(os.path.join(args.run_dir, "summary.json")) as f:
            record = json.load(f)
    if is_gp_summary(record):
        summary = {k: record[k] for k in ("model", "kernel", "epochs", "norm_eps", "init",
                                          "ablation_arch") if k in record}
        trainer = train_gp.build_trainer(summary, 100, 1562, "cuda", dtype=dtype)
        sampler = score_gp.samplers(summary["kernel"])[0]

        def sample(g):
            return (*sampler.sample(g, args.batch), None)
    else:
        summary = train_config(record) if record else gw_train_summary()
        trainer = build_trainer(summary, 200_000, "cuda", dtype=dtype)
        sample = batch_sampler(summary, args.batch)
    g = trainer.state.generator

    def one_step():
        with record_function("data"):
            x, y, cond = sample(g)
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

    eager = measure_step(one_step, args.reps)
    kernels, device_ms = eager.pop("kernels"), eager["device_ms"]
    phases = {p: sum(e.device_time_total for e in eager["events"]
                     if e.name == p and e.device_type == DeviceType.CPU) / 1e3
              for p in PHASES}
    phases["backward"] = device_ms - sum(phases.values())
    phases["of which setconv backward"] = sum(
        e.device_time_total for e in eager.pop("events")
        if e.name == SETCONV_BWD and e.device_type == DeviceType.CPU) / 1e3
    eager["phases_device_ms"] = phases
    eager["top"] = top_kernels(kernels, device_ms, args.top)
    _print(f"eager train step at batch {args.batch}", eager, args)
    print("  device ms by phase: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))

    graph = trainer.generated_graph(sample)
    graph.replay()  # the capture

    def replay():
        graph.replay()
        torch.cuda.synchronize()

    graphed = measure_step(replay, args.reps)
    kernels = graphed.pop("kernels")
    del graphed["events"]
    graphed["event_ms"] = event_ms(graph.replay)
    graphed["top"] = top_kernels(kernels, graphed["device_ms"], args.top)
    graphed["hand_kernels"] = hand_kernels(kernels)
    _print(f"graphed train step at batch {args.batch}", graphed, args)
    res = dict(run_dir=args.run_dir, bf16=args.bf16, batch=args.batch,
               device=torch.cuda.get_device_name(0),
               eager=eager, graphed=graphed)
    print(json.dumps(res))
    return res


def _print(label: str, r: dict, args) -> None:
    print(f"{torch.cuda.get_device_name(0)}: {label}: {r['wall_ms']:.3f} ms wall (median of "
          f"{r['reps']}, untraced, {1e3 * args.batch / r['wall_ms']:.0f} wf/s); traced "
          f"{r['traced_wall_ms']:.3f} ms wall, {r['device_ms']:.3f} ms device time in "
          f"{r['n_launches']} kernel launches; busy share {r['busy_share']:.3f} of the traced "
          f"step, {r['busy_share_untraced']:.3f} of the untraced one"
          + (f"; {r['event_ms']:.3f} ms between CUDA events" if "event_ms" in r else ""))
    for e in r["top"]:
        print(f"  {e['device_ms']:9.4f} ms  {e['share']:6.1%}  x{e['calls']:<4d} {e['name'][:90]}")
    for e in r.get("hand_kernels", []):
        print(f"  hand kernel x{e['calls']}: {e['device_ms']:.4f} ms  {e['name'][:90]}")


if __name__ == "__main__":
    main()
