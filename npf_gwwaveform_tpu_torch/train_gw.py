"""Train a GW ConvCNP and score it: the port's counterpart of the training and
eval blocks of `experiments/reproduce_gw.py`, for the flagship configuration
(`--cond --cond-mode film --n-context 192 --density 128`, time domain, the
flat CNN).

    python -m npf_gwwaveform_tpu_torch.train_gw [--steps N] [--batch 32]
        [--lr 1e-3] [--decay-lr 10] [--seed 0] [--device cuda]
        [--out runs_torch/] [--run 0] [--n-test 2048]

Each step draws `--batch` waveforms on the device (the scorer's generator
and stride: 1024 Hz over 1 s, every 4th sample), splits them with one context
count U{0..192} for the whole batch (the JAX training splitter), and takes one
Adam step on the CNPF loss, the learning rate decaying x`--decay-lr` over
`steps // 1562` epochs of 1562 steps. The run directory
`<out>/GW_time_cond_film_ctx192_d128/ConvCNP/run_<run>` gets `history.json`
(step, seconds since the first step, mean train loss of the last 50 steps),
`params.msgpack` and `extra_vars.msgpack` in flax's layout, and
`summary.json`; then `score.score_run` scores `--n-test` waveforms of it and
the scores join the summary, which is printed as one JSON line. Float32
throughout: TF32 is off for matmuls and cuDNN convolutions.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .configs import STEPS_PER_EPOCH, gw_model_from_summary, gw_train_summary, run_tag
from .data.datasplit import CntxtTrgtSplitter, GetRandomIndcs, get_all_indcs
from .data.gw import GWParameterSpace
from .losses import CNPFLoss
from .score import make_eval_batch, run_generator, score_run
from .training.checkpoint import save_run_params
from .training.optim import make_optimizer
from .training.trainer import Trainer
from .utils.init import init_module

HISTORY_EVERY = 50  # steps per history entry, as reproduce_gw.py's chunks

__all__ = ["build_trainer", "train", "write_run", "run", "main"]


def build_trainer(summary: dict, steps: int, device, lr: float = 1e-3, decay_lr: float = 10.0,
                  seed: int = 0, use_kernels: bool = True) -> Trainer:
    """The run's model drawn from the JAX init schemes with a generator
    seeded `seed`, on `device`, with its optimizer and the training
    splitter; the trainer's own generator is seeded `seed` too."""
    device = torch.device(device)
    model = gw_model_from_summary(summary, use_kernels=use_kernels)
    init_module(model, torch.Generator().manual_seed(seed))
    model.to(device)
    optimizer = make_optimizer(model.parameters(), lr=lr, decay_lr=decay_lr,
                               max_epochs=max(1, steps // STEPS_PER_EPOCH),
                               steps_per_epoch=STEPS_PER_EPOCH)
    splitter = CntxtTrgtSplitter(
        contexts_getter=GetRandomIndcs(a=0.0, b=summary["n_context"]),
        targets_getter=get_all_indcs,
    )
    return Trainer(model, CNPFLoss(), optimizer, splitter,
                   generator=torch.Generator(device=device).manual_seed(seed))


def train(trainer: Trainer, summary: dict, steps: int, batch: int,
          time_steps: bool = False) -> tuple:
    """`steps` train steps on fresh waveforms -> (history, per-step losses
    [steps] on the device, seconds, per-step seconds). With `time_steps` each
    step ends in a device synchronise and its host-clock time is recorded;
    otherwise the host runs ahead and the list is empty."""
    gen, space = run_generator(summary), GWParameterSpace()
    n_points = summary.get("n_points", 256)
    device = trainer.state.generator.device
    losses = torch.empty((steps,), device=device)
    history, step_seconds = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        t_step = time.perf_counter()
        theta = space.sample(batch, trainer.state.generator)
        x, y, cond = make_eval_batch(theta, gen, space, n_points)
        losses[i] = trainer.train_step_cond(x, y, cond)["loss"]
        if time_steps:
            if device.type == "cuda":
                torch.cuda.synchronize()
            step_seconds.append(time.perf_counter() - t_step)
        if (i + 1) % HISTORY_EVERY == 0 or i + 1 == steps:
            mean = losses[i + 1 - min(HISTORY_EVERY, i + 1):i + 1].mean().item()
            history.append({"step": i + 1, "dur": time.perf_counter() - t0, "train_loss": mean})
    if device.type == "cuda":
        torch.cuda.synchronize()
    return history, losses, time.perf_counter() - t0, step_seconds


def write_run(run_dir: str, model: torch.nn.Module, summary: dict, history: list) -> None:
    """The run directory in the JAX package's layout: params.msgpack,
    extra_vars.msgpack, history.json and summary.json."""
    save_run_params(run_dir, model)
    with open(os.path.join(run_dir, "history.json"), "w") as f:
        json.dump(history, f)
    with open(os.path.join(run_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)


def run(steps: int, batch: int = 32, lr: float = 1e-3, decay_lr: float = 10.0, seed: int = 0,
        device="cuda", out: str = "runs_torch/", run_index: int = 0,
        n_test: int = 2048) -> tuple:
    """Train the flagship configuration, write its run directory and score
    it. -> (run_dir, summary with the scores)."""
    summary = gw_train_summary()
    trainer = build_trainer(summary, steps, device, lr, decay_lr, seed)
    history, _, seconds, _ = train(trainer, summary, steps, batch)
    summary.update(steps=steps, batch=batch, train_wf_per_sec=steps * batch / seconds)
    if lr != 1e-3:
        summary["lr"] = lr
    if decay_lr != 10.0:
        summary["decay_lr"] = decay_lr

    run_dir = os.path.join(out, run_tag(summary), summary["model"], f"run_{run_index}")
    write_run(run_dir, trainer.model, summary, history)
    scores = score_run(run_dir, n_test, device=device, seed=seed)
    summary.update(test_ll_per_wf=scores["mean_ll"], test_nll_per_wf=-scores["mean_ll"],
                   mismatch_median=scores["median_mismatch"],
                   mismatch_p90=scores["mismatch_p90"],
                   **{"frac_below_0.1": scores["frac_below_0.1"]})
    with open(os.path.join(run_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return run_dir, summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20_000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--decay-lr", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="runs_torch/")
    ap.add_argument("--run", type=int, default=0)
    ap.add_argument("--n-test", type=int, default=2048)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run_dir, summary = run(args.steps, args.batch, args.lr, args.decay_lr, args.seed, args.device,
                           args.out, args.run, args.n_test)
    print(json.dumps({"run_dir": run_dir, **summary}))
    return summary


if __name__ == "__main__":
    main()
