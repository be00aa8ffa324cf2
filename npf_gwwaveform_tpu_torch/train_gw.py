"""Train a GW ConvCNP or ConvLNP and score it: the port's counterpart of the
training and eval blocks of `experiments/reproduce_gw.py`, for every ConvCNP
configuration that script trains, on time-domain or frequency-domain data,
and for its ConvLNP configurations.

    python -m npf_gwwaveform_tpu_torch.train_gw [--steps N] [--batch 32]
        [--model ConvCNP|ConvLNP] [--no-lat-lb] [--loss elbo]
        [--lr 1e-3] [--decay-lr 10] [--clip NORM] [--seed 0] [--device cuda]
        [--mode time|freq_ap] [--no-cond] [--cond-mode film|add] [--n-context 192] [--density 128]
        [--cnn-kernel K] [--cnn-dilations 1,1,2,4,8] [--cnn-arch cnn|unet]
        [--duration 1.0] [--n-points 256] [--pallas]
        [--out runs_torch/] [--run 0] [--n-test 2048] [--thetas-from RUN_DIR]
        [--resume-from RUN_DIR] [--bf16]

The configuration flags have `reproduce_gw.py`'s names and meanings
(`:31-149`), and the summary and the run directory's tag follow from them
as in that script (`configs.gw_train_summary`, `configs.run_tag`). The one
difference is the defaults: they are the flagship's
(`--cond --cond-mode film --n-context 192 --density 128`), where
`reproduce_gw.py` defaults to no conditioning, additive conditioning when
asked, 64 context points and no density; `--no-cond` drops the
conditioning and `--density 0` gives no density (the model's 64 points a
unit, and no `_d` in the tag). `--pallas` only names the tag and the
summary field: both SetConvs run through K1 on CUDA either way. `--clip`
clips the gradients' global norm (by default none for ConvCNP and 1.0 for
ConvLNP, as `reproduce_gw.py`, which records only a clip given).
`--model ConvLNP` trains the latent family with NPML (16 z draws a
waveform); `--no-lat-lb` gives it the unbounded q(z) scale (`1e-4 +
softplus`) and `--loss elbo` trains it with the ELBO from q(z|C,T) (one
draw), as that script's flags do.

Each step draws `--batch` waveforms on the device (the run's generator at
1024 Hz over `--duration` seconds; `--mode time`: `--n-points` evenly
strided samples of them, every 4th of 1024 for 1 s, all 2048 for the 2 s
long waveforms; `--mode freq_ap`: amplitude and standardised phase on
`--n-points` frequencies from 20 to 1024 Hz, two channels), splits them with one context count U{0..n_context} for the whole batch (the
JAX training splitter), and takes one Adam step on the run's loss (the CNPF
loss, NPML or the ELBO; conditioned on the normalised parameters, or with
no condition under `--no-cond`, as `reproduce_gw.py`'s `one_step`), the
learning rate decaying
x`--decay-lr` over `steps // 1562` epochs of 1562 steps. On CUDA the whole
step is captured once in a CUDA graph and replayed, in chunks of 50 steps
as `reproduce_gw.py` scans them; on the CPU it runs eagerly. The run
directory `<out>/<tag>/<model>/run_<run>` gets the files `reproduce_gw.py`
writes. Every tenth of the run, at the chunks where `reproduce_gw.py`
writes them (`checkpoint_chunks`), `params.msgpack` and
`extra_vars.msgpack` in flax's layout, so that a lost run can go on from
its last tenth; after the last step those two again, `history.json` (step,
seconds since the first step, mean train loss of the last 50 steps),
`model_summary.txt` and `summary.json`; then `score.score_run` scores
`--n-test` waveforms of it (drawn from `score.EVAL_SEED`, whatever `--seed`
is, or those recorded in `--thetas-from`'s `mismatch_theta.csv`, so that a
run's recorded scores are on the waveforms a run it is compared with was
scored on) and `score.write_scores` adds `eval.csv`,
`mismatch_theta.csv` and the scores to the summary, which is printed as one
JSON line. Float32 by default, with TF32 off for matmuls and cuDNN
convolutions; `--bf16` trains and scores in bfloat16 compute, as
`reproduce_gw.py --bf16` does (every module in bf16; the parameters, the
BatchNorm statistics, Adam's state, the loss and the run files stay float32,
and the summary has the same keys).

`--resume-from RUN_DIR` warm-starts from another run directory's parameters
and BatchNorm statistics (a JAX run of the same configuration or a port
run), as `reproduce_gw.py --resume-from` does: Adam's state and the
learning-rate schedule restart, so the run re-peaks at `--lr` and decays over
`--steps`; the summary records `resumed_from` as given, and a RUN_DIR that is
the run's own output directory is refused.

Unlike `reproduce_gw.py`, which trains `steps // 50` whole chunks and drops
the remainder, the port trains every step asked for.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import torch

from .configs import (
    MODELS, STEPS_PER_EPOCH, criterion_from_summary, default_clip, gw_model_from_summary,
    gw_train_summary, run_tag,
)
from .data.datasplit import CntxtTrgtSplitter, GetRandomIndcs, get_all_indcs
from .data.gw import GWParameterSpace
from .score import EVAL_SEED, make_eval_batch, run_generator, score_run, write_scores
from .training.checkpoint import load_run_params, params_from_flax, save_run_params
from .training.state import count_parameters
from .training.optim import make_optimizer
from .training.trainer import Trainer
from .utils.helpers import set_numerics
from .utils.init import init_module

HISTORY_EVERY = 50  # steps per history entry, as reproduce_gw.py's chunks

__all__ = ["build_trainer", "batch_sampler", "checkpoint_chunks", "load_params_into", "train",
           "write_run", "output_dir", "refuse_own_dir", "run", "parser", "summary_from_args", "main"]


def build_trainer(summary: dict, steps: int, device, seed: int = 0, use_kernels: bool = True,
                  dtype: Optional[torch.dtype] = None, mesh=None) -> Trainer:
    """The run's model in compute `dtype` (None: float32) drawn from the JAX
    init schemes with a generator seeded `seed`, on `device`, with its
    optimizer (the summary's `lr`, `decay_lr` and `grad_clip_norm`, each at
    `reproduce_gw.py`'s default when absent: the clip 1.0 for ConvLNP,
    `configs.default_clip`), its criterion (`configs.criterion_from_summary`)
    and the training splitter; the trainer's own generator is seeded `seed`
    too. With `mesh` (`parallel.make_mesh`) the trainer trains on it."""
    device = torch.device(device)
    model = gw_model_from_summary(summary, use_kernels=use_kernels, dtype=dtype)
    init_module(model, torch.Generator().manual_seed(seed))
    model.to(device)
    optimizer = make_optimizer(model.parameters(), lr=summary.get("lr", 1e-3),
                               decay_lr=summary.get("decay_lr", 10.0),
                               max_epochs=max(1, steps // STEPS_PER_EPOCH),
                               steps_per_epoch=STEPS_PER_EPOCH,
                               grad_clip_norm=default_clip(summary))
    splitter = CntxtTrgtSplitter(
        contexts_getter=GetRandomIndcs(a=0.0, b=summary["n_context"]),
        targets_getter=get_all_indcs,
    )
    return Trainer(model, criterion_from_summary(summary), optimizer, splitter,
                   generator=torch.Generator(device=device).manual_seed(seed), mesh=mesh)


def checkpoint_chunks(steps: int) -> list:
    """The chunks (numbered from 0, each of min(50, steps) steps) after which
    `reproduce_gw.py` writes its mid-run checkpoint: chunk i from 1 on with
    i % max(1, n_chunks // 10) == 0, of its n_chunks = max(1, steps // chunk)
    whole chunks."""
    n_chunks = max(1, steps // min(HISTORY_EVERY, steps))
    every = max(1, n_chunks // 10)
    return [i for i in range(1, n_chunks) if i % every == 0]


def load_params_into(model: torch.nn.Module, run_dir: str) -> None:
    """Copy a run directory's parameters and BatchNorm statistics into the
    model's own tensors (`load_state_dict` copies in place, strict), so that
    a CUDA graph captured on them later, or already, reads them."""
    model.load_state_dict(params_from_flax(*load_run_params(run_dir)), strict=True)


def batch_sampler(summary: dict, batch: int):
    """sample(generator) -> (x, y, condition) of `batch` fresh training
    waveforms of the run's data (its generator, `n_points`, `mode`), drawn on the
    generator's device; the condition is None for an unconditioned run, as
    `reproduce_gw.py`'s `one_step` passes none."""
    gen, space = run_generator(summary), GWParameterSpace()
    n_points, mode = summary.get("n_points", 256), summary.get("mode", "time")
    conditioned = bool(summary["conditioned"])

    def sample(generator):
        x, y, cond = make_eval_batch(space.sample(batch, generator), gen, space, n_points, mode)
        return x, y, cond if conditioned else None
    return sample


def train(trainer: Trainer, summary: dict, steps: int, batch: int,
          time_steps: bool = False, checkpoint_dir: Optional[str] = None) -> tuple:
    """`steps` train steps on fresh waveforms -> (history, per-step losses
    [steps] on the device, seconds, per-step seconds). Each step draws its
    waveforms on the device (`Trainer.train_steps_generated`: on CUDA the
    whole step, sampling included, is one CUDA-graph replay), in chunks of
    min(50, steps) steps as `reproduce_gw.py` scans them; the host reads the
    losses once a chunk, for the history, and after each of
    `checkpoint_chunks(steps)` writes the model's parameters and statistics
    into `checkpoint_dir` (when given). With `time_steps` each step ends in
    a device synchronise and its host-clock time is recorded; otherwise the
    host runs ahead within a chunk and the list is empty."""
    sample = batch_sampler(summary, batch)
    device = trainer.state.generator.device
    sync = torch.cuda.synchronize if device.type == "cuda" else lambda: None
    losses = torch.empty((steps,), device=device)
    history, step_seconds = [], []
    chunk = min(HISTORY_EVERY, steps)
    checkpoints = set(checkpoint_chunks(steps)) if checkpoint_dir is not None else set()
    t0 = time.perf_counter()
    for start in range(0, steps, chunk):
        end = min(start + chunk, steps)
        if time_steps:
            for i in range(start, end):
                t_step = time.perf_counter()
                losses[i:i + 1] = trainer.train_steps_generated(sample, 1)
                sync()
                step_seconds.append(time.perf_counter() - t_step)
        else:
            losses[start:end] = trainer.train_steps_generated(sample, end - start)
        mean = losses[end - min(HISTORY_EVERY, end):end].mean().item()
        history.append({"step": end, "dur": time.perf_counter() - t0, "train_loss": mean})
        if start // chunk in checkpoints:  # between replays: the chunk's losses are read
            save_run_params(checkpoint_dir, trainer.model)
            print(f"checkpoint at step {end} in {checkpoint_dir}: loss {mean:.2f}, "
                  f"{history[-1]['dur']:.0f} s", flush=True)
    sync()
    return history, losses, time.perf_counter() - t0, step_seconds


def write_run(run_dir: str, model: torch.nn.Module, summary: dict, history: list) -> None:
    """The run directory in the JAX package's layout before scoring:
    params.msgpack, extra_vars.msgpack, model_summary.txt (the module tree
    and the parameter count), history.json and summary.json."""
    save_run_params(run_dir, model)
    with open(os.path.join(run_dir, "model_summary.txt"), "w") as f:
        f.write(f"{model!r}\nn_params: {count_parameters(model)}\n")
    with open(os.path.join(run_dir, "history.json"), "w") as f:
        json.dump(history, f)
    with open(os.path.join(run_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)


def output_dir(summary: dict, out: str, run_index: int) -> str:
    """The directory `run` writes the run of `summary`'s configuration into
    under `out`: `<out>/<run_tag>/<model>/run_<run_index>`."""
    return os.path.join(out, run_tag(summary), summary["model"], f"run_{run_index}")


def refuse_own_dir(resume_from: Optional[str], run_dir: str) -> None:
    """Raise ValueError if `resume_from` resolves to `run_dir`."""
    if resume_from is not None and os.path.abspath(resume_from) == os.path.abspath(run_dir):
        raise ValueError(f"--resume-from resolves to this run's own output dir ({run_dir}); "
                         "pass a different --run for the continuation")


def run(steps: int, batch: int = 32, seed: int = 0, device="cuda", out: str = "runs_torch/",
        run_index: int = 0, n_test: int = 2048, thetas_from: Optional[str] = None,
        dtype: Optional[torch.dtype] = None, resume_from: Optional[str] = None,
        summary: Optional[dict] = None) -> tuple:
    """Train the configuration `summary` states (`configs.gw_train_summary`;
    None: the flagship's) in compute `dtype` (from `resume_from`'s parameters
    when given, else from the init drawn from `seed`), with the decile
    checkpoints, write its run directory and score it in that dtype on
    `score.EVAL_SEED`'s draws (on `thetas_from`'s recorded thetas when
    given). -> (run_dir, summary with the scores)."""
    summary = dict(summary if summary is not None else gw_train_summary())
    run_dir = output_dir(summary, out, run_index)
    refuse_own_dir(resume_from, run_dir)
    trainer = build_trainer(summary, steps, device, seed, dtype=dtype)
    if resume_from is not None:
        load_params_into(trainer.model, resume_from)
    history, _, seconds, _ = train(trainer, summary, steps, batch, checkpoint_dir=run_dir)
    summary.update(steps=steps, batch=batch, train_wf_per_sec=steps * batch / seconds)
    if resume_from is not None:
        summary["resumed_from"] = resume_from

    write_run(run_dir, trainer.model, summary, history)
    scores = score_run(run_dir, n_test, device=device, seed=EVAL_SEED, thetas_from=thetas_from,
                       dtype=dtype)
    return run_dir, write_scores(run_dir, scores)


def parser() -> argparse.ArgumentParser:
    """The command line of `main`."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20_000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--decay-lr", type=float, default=10.0)
    ap.add_argument("--clip", type=float, default=None,
                    help="clip the gradients' global norm (default: none for ConvCNP, 1.0 for "
                         "ConvLNP)")
    ap.add_argument("--model", default="ConvCNP", choices=list(MODELS))
    ap.add_argument("--no-lat-lb", action="store_true",
                    help="ConvLNP: the unbounded q(z) scale 1e-4 + softplus")
    ap.add_argument("--loss", default=None, choices=["elbo"],
                    help="ConvLNP: train with the ELBO from q(z|C,T), one z draw")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mode", default="time", choices=["time", "freq_ap"],
                    help="time-domain waveforms, or amplitude and phase in frequency")
    ap.add_argument("--no-cond", action="store_true",
                    help="no conditioning on the parameters")
    ap.add_argument("--cond-mode", default="film", choices=["add", "film"])
    ap.add_argument("--n-context", type=int, default=192)
    ap.add_argument("--density", type=int, default=128,
                    help="induced-grid points a unit (0: not given, the model's 64)")
    ap.add_argument("--cnn-kernel", type=int, default=None)
    ap.add_argument("--cnn-dilations", default=None, help="per-block dilations, e.g. 1,1,2,4,8")
    ap.add_argument("--cnn-arch", default="cnn", choices=["cnn", "unet"])
    ap.add_argument("--duration", type=float, default=1.0)
    ap.add_argument("--n-points", type=int, default=256)
    ap.add_argument("--pallas", action="store_true",
                    help="tag and record the run as reproduce_gw.py --pallas does")
    ap.add_argument("--out", default="runs_torch/")
    ap.add_argument("--run", type=int, default=0)
    ap.add_argument("--n-test", type=int, default=2048)
    ap.add_argument("--thetas-from", default=None, metavar="RUN_DIR")
    ap.add_argument("--resume-from", default=None, metavar="RUN_DIR",
                    help="warm-start from that run's parameters and BatchNorm statistics")
    ap.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    return ap


def summary_from_args(args: argparse.Namespace) -> dict:
    """The run's settings from `parser()`'s arguments (`gw_train_summary`)."""
    dilations = [int(d) for d in args.cnn_dilations.split(",")] if args.cnn_dilations else None
    return gw_train_summary(
        model=args.model, no_lat_lb=args.no_lat_lb, loss=args.loss, mode=args.mode,
        cond=not args.no_cond, cond_mode=args.cond_mode, n_context=args.n_context,
        density=args.density or None, cnn_kernel=args.cnn_kernel, cnn_dilations=dilations,
        cnn_arch=args.cnn_arch, duration=args.duration, n_points=args.n_points,
        pallas=args.pallas, lr=args.lr, decay_lr=args.decay_lr, clip=args.clip)


def main(argv=None) -> dict:
    ap = parser()
    args = ap.parse_args(argv)
    try:
        summary = summary_from_args(args)
        refuse_own_dir(args.resume_from, output_dir(summary, args.out, args.run))
    except (ValueError, NotImplementedError) as e:
        ap.error(str(e))
    set_numerics()
    run_dir, summary = run(args.steps, args.batch, args.seed, args.device, args.out, args.run,
                           args.n_test, args.thetas_from, torch.bfloat16 if args.bf16 else None,
                           args.resume_from, summary)
    print(json.dumps({"run_dir": run_dir, **summary}))
    return summary


if __name__ == "__main__":
    main()
