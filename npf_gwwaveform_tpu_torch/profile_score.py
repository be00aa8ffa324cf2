"""Where the time of one scoring batch goes on the card, for the eager batch
and for the batch replayed from its CUDA graph.

    python -m npf_gwwaveform_tpu_torch.profile_score --run-dir DIR [--reps 5] [--bf16]

Scores one 256-waveform batch of the run's recorded thetas (a ConvLNP run
at its 32 z draws a waveform, [8192, ...] through its post-sampling CNN and
the grid->targets K1): first eagerly,
`--reps` times on the host clock (each ends in a device synchronise) and
once under `torch.profiler` (CPU and CUDA activity); then as `score_run`
does on CUDA, the batch's CUDA graph (`score.batch_graph`) captured after
the eager batches (the capture timed on the host clock) and replayed,
timed and traced the same way and once between CUDA events. For each it
prints the batch's wall time, the device time summed over kernels, the
busy share (device time over the traced batch's wall time, and over the
untraced median) and the kernels with the most device time; for the graph
also how many kernels one replay launched and the hand kernels among them,
and how many replays pay for the capture (`score.GRAPH_MIN_REPLAYS`). Then
one JSON line with both. `--bf16` scores in bfloat16 compute. Writes
nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .data.gw import GWParameterSpace
from .kernel_measure import event_ms, hand_kernels, measure_step, top_kernels
from .score import (
    batch_graph, eval_splitter, load_model, read_run_thetas, run_generator, score_batch,
)
from .utils.helpers import set_numerics


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_score: no CUDA device")
    set_numerics()
    dtype = torch.bfloat16 if args.bf16 else None
    with open(os.path.join(args.run_dir, "summary.json")) as f:
        summary = json.load(f)
    model = load_model(args.run_dir, "cuda", dtype=dtype)
    gen, space = run_generator(summary), GWParameterSpace()
    splitter, n_points = eval_splitter(summary["n_context"]), summary.get("n_points", 256)
    mode = summary.get("mode", "time")
    theta = torch.from_numpy(read_run_thetas(args.run_dir)[:256]).cuda()

    g = torch.Generator(device="cuda")

    def one_batch():
        score_batch(model, splitter, g.manual_seed(0), theta, gen, space, n_points, mode)
        torch.cuda.synchronize()

    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        eager = measure_step(one_batch, args.reps)
        # after eager batches, as `score_run` makes it
        graph = batch_graph(model, splitter, g.manual_seed(0), theta, gen, space, n_points, mode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.capture()
        torch.cuda.synchronize()
        capture_ms = 1e3 * (time.perf_counter() - t0)

        def replay():
            graph.replay(theta)
            torch.cuda.synchronize()

        graphed = measure_step(replay, args.reps)
        graphed["event_ms"] = event_ms(lambda: graph.replay(theta))
    graphed["capture_ms"] = capture_ms
    # score_run's choice: a graph pays when its replays save more than its capture costs
    graphed["replays_to_pay"] = capture_ms / (eager["wall_ms"] - graphed["wall_ms"])
    res = dict(bf16=args.bf16, device=torch.cuda.get_device_name(0))
    for label, r in (("eager", eager), ("graphed", graphed)):
        kernels = r.pop("kernels")
        del r["events"]
        r["top"] = top_kernels(kernels, r["device_ms"], args.top)
        r["hand_kernels"] = hand_kernels(kernels)
        print(f"{res['device']}: {label} batch {r['wall_ms']:.3f} ms wall (median of "
              f"{args.reps}, untraced); traced {r['traced_wall_ms']:.3f} ms wall, "
              f"{r['device_ms']:.3f} ms device time in {r['n_launches']} kernel launches, busy "
              f"share {r['busy_share']:.3f} of the traced batch, {r['busy_share_untraced']:.3f} "
              f"of the untraced one"
              + (f"; {r['event_ms']:.3f} ms between CUDA events" if "event_ms" in r else ""))
        for e in r["top"]:
            print(f"  {e['device_ms']:9.4f} ms  {e['share']:6.1%}  x{e['calls']:<4d} "
                  f"{e['name'][:90]}")
        for e in r["hand_kernels"]:
            print(f"  hand kernel x{e['calls']}: {e['device_ms']:.4f} ms  {e['name'][:90]}")
        res[label] = r
    print(f"the capture {capture_ms:.3f} ms (host clock), paid for by "
          f"{graphed['replays_to_pay']:.2f} replays in place of eager batches")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
