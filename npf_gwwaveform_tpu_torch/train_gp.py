"""Train a GP model and score it: the port's counterpart of
`experiments/reproduce_gp.py`, in float32 or (`--bf16`) bfloat16 compute.

    python -m npf_gwwaveform_tpu_torch.train_gp
        [--model CNP|LNP|AttnCNP|AttnLNP|ConvCNP|ConvLNP]
        [--kernel RBF_Kernel] [--epochs 100] [--fns-per-epoch 50000] [--batch 32]
        [--n-test 10000] [--seed 123] [--decay-lr 10] [--per-super 80]
        [--init intended|realized] [--norm-eps 1e-3] [--ablation ELBO{T|F}_LatLB{T|F}_SigLB{T|F}]
        [--ablation-arch notebook|headline] [--loss default|sumo] [--run 0]
        [--resume-from RUN_DIR] [--lr 1e-3] [--out runs_torch/] [--device cuda] [--bf16]

The flags have `reproduce_gp.py`'s names, defaults and meanings (`--model`
CNP by default). The model is `configs.gp_model_1d`'s (`--model`), an
objective-ablation variant (`--ablation`, LNP, AttnLNP or ConvLNP:
`configs.gp_model_variant`, for ConvLNP at `--ablation-arch`, trained with
the ELBO or NPML, the directory `configs.variant_name`) or SUMO on the NPML
variant (`--loss sumo`, the same three, the directory `{model}_SUMO`);
`--norm-eps` is the conv family's BatchNorm eps and `--init` the
weight-init scheme. Adam at `--lr` decays x`--decay-lr` over `--epochs`
epochs of `fns_per_epoch // batch` steps (a staircase per epoch); ConvLNP
(and its variants) clips the gradients' global norm at 1.0. Each step samples `--batch` fresh
functions of 128 points on the device (`--kernel`; `All_Kernels` the
uniform mixture of RBF, Periodic and Noisy Matern), splits them into one
context count U{0..50} for the batch and every point as targets, and takes
one step (`Trainer.train_steps_generated`: on CUDA one replay of a CUDA
graph that holds the sampling too; on the CPU the eager step). The steps
run in chunks of min(50, steps) and supers of `--per-super` chunks, as
`reproduce_gp.py` scans them (so it trains whole supers: 160,000 steps for
100 epochs of 1,562); after each super the model's mean eval loss on a fixed
valid set of 1,024 functions (drawn and split from seed 777) is checked and
the best parameters so far are kept; they are restored over the final
BatchNorm statistics before the eval, as `reproduce_gp.py` restores them.
The eval is `score_gp.score_model`'s (`--n-test` functions a kernel, whole
batches of 256). The run directory `<out>/<kernel>/<model>/run_<run>` gets
`reproduce_gp.py`'s files: `eval.csv`, `history.json` (one entry a super:
epoch, seconds, mean train loss, valid loss), `model_summary.txt`,
`params.msgpack` and `extra_vars.msgpack` (flax's layout) and
`summary.json` with that script's fields; the summary is printed as one
JSON line, with one field `reproduce_gp.py` lacks:
`mean_test_ll_best_check_stats`, the eval's mean LL with the BatchNorm
statistics of the best check in place of the final ones. `--resume-from
RUN_DIR` warm-starts from a run directory's parameters (its own output
directory is refused). `--bf16` trains, checks and scores in bfloat16
compute, as `reproduce_gp.py --bf16` builds every model: every module in
bf16, the parameters, Adam's moments, the BatchNorm statistics and the
losses float32; the step is graphed as the float32 one is. The run
directory and its summary are a float32 run's (that script records no
dtype), so `score_gp --bf16` rescores it.

Unlike `reproduce_gp.py`, whose chunks are always 50 steps, a run of fewer
than 50 steps trains exactly its steps (one chunk), so that the CPU can
take two.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Optional

import torch

from . import score_gp
from .configs import (
    GP_MODELS, LATENT_MODELS, gp_criterion_from_summary, gp_model_from_summary, parse_variant,
    variant_name,
)
from .data.datasplit import CntxtTrgtSplitter, GetRandomIndcs, get_all_indcs
from .training.checkpoint import save_run_params
from .training.optim import make_optimizer
from .training.train import write_history, write_model_summary
from .training.trainer import Trainer
from .train_gw import load_params_into, refuse_own_dir
from .utils import init as winit
from .utils.helpers import set_numerics

CHUNK = 50  # steps a chunk, as reproduce_gp.py scans them
N_VALID, VALID_SEED = 1024, 777

__all__ = ["run_name", "train_summary", "build_trainer", "schedule", "valid_loss", "copy_into",
           "train", "write_run", "output_dir", "run", "parser", "main"]


def run_name(model: str, ablation: Optional[str] = None, loss: str = "default") -> str:
    """The run directory's model name: `variant_name` of an ablation
    ("ELBOFalse_LatLBTrue_SigLBFalse"), `{model}_SUMO`, or the model."""
    if ablation:
        _, flags = parse_variant(f"{model}_{ablation}")
        return variant_name(model, flags["ELBO"], flags["LatLB"], flags["SigLB"])
    return f"{model}_SUMO" if loss == "sumo" else model


def train_summary(model: str = "CNP", kernel: str = "RBF_Kernel", epochs: int = 100,
                  norm_eps: float = 1e-3, init: str = "intended", ablation: Optional[str] = None,
                  ablation_arch: str = "notebook", loss: str = "default",
                  lr: float = 1e-3, decay_lr: float = 10.0) -> dict:
    """The configuration fields of the run's `summary.json`, as
    `reproduce_gp.py` records them (`ablation_arch` with an ablation, `loss`
    when not the default, `lr` and `decay_lr` off their defaults). Raises
    ValueError on what that script refuses and NotImplementedError on a
    model not ported."""
    if model not in GP_MODELS:
        raise ValueError(f"model={model!r}: one of {', '.join(GP_MODELS)}")
    if kernel not in score_gp.KERNELS:
        raise ValueError(f"kernel={kernel!r}: one of {', '.join(score_gp.KERNELS)}")
    if (ablation or loss == "sumo") and model not in LATENT_MODELS:
        raise ValueError(f"--ablation and --loss sumo train a latent model, not {model}")
    summary = {"model": run_name(model, ablation, loss), "kernel": kernel, "epochs": epochs,
               "eval_protocol": "indep_n", "norm_eps": norm_eps, "init": init}
    if ablation:
        summary["ablation_arch"] = ablation_arch
    if loss != "default":
        summary["loss"] = loss
    if lr != 1e-3:
        summary["lr"] = lr
    if decay_lr != 10.0:
        summary["decay_lr"] = decay_lr
    gp_model_from_summary(summary)  # refuses what is not ported
    return summary


def schedule(epochs: int, fns_per_epoch: int, batch: int, per_super: int) -> dict:
    """reproduce_gp.py's loop: steps_per_epoch, the chunk (min(50, steps)),
    the supers and the steps trained (whole supers)."""
    steps_per_epoch = fns_per_epoch // batch
    total = steps_per_epoch * epochs
    if total < 1:
        raise ValueError("fewer functions an epoch than a batch")
    chunk = min(CHUNK, total)
    n_chunks = max(1, total // chunk)
    per = max(1, min(per_super, n_chunks))
    n_super = -(-n_chunks // per)
    return dict(steps_per_epoch=steps_per_epoch, chunk=chunk, per_super=per, n_super=n_super,
                steps=n_super * per * chunk)


def build_trainer(summary: dict, epochs: int, steps_per_epoch: int, device, seed: int = 123,
                  lr: float = 1e-3, decay_lr: float = 10.0, use_kernels: bool = True,
                  dtype: Optional[torch.dtype] = None) -> Trainer:
    """The run's model in compute `dtype` (None: float32) drawn from its
    init scheme (`summary["init"]`) with a generator seeded `seed`, on
    `device`, its criterion, Adam with the
    staircase decay, the clip of 1.0 for ConvLNP, and the training splitter
    (one context count U{0..50} a batch); the trainer's generator seeded
    `seed` too."""
    device = torch.device(device)
    winit.set_realized_init(summary.get("init") == "realized")
    model = gp_model_from_summary(summary, use_kernels=use_kernels, dtype=dtype)
    winit.init_module(model, torch.Generator().manual_seed(seed))
    model.to(device)
    optimizer = make_optimizer(model.parameters(), lr=lr, decay_lr=decay_lr, max_epochs=epochs,
                               steps_per_epoch=steps_per_epoch,
                               grad_clip_norm=1.0 if summary["model"].startswith("ConvLNP")
                               else None)
    splitter = CntxtTrgtSplitter(contexts_getter=GetRandomIndcs(a=0.0, b=score_gp.N_CONTEXT),
                                 targets_getter=get_all_indcs)
    return Trainer(model, gp_criterion_from_summary(summary), optimizer, splitter,
                   generator=torch.Generator(device=device).manual_seed(seed))


def valid_loss(trainer: Trainer, xv: torch.Tensor, yv: torch.Tensor) -> float:
    """The mean eval loss (NPML) over the fixed valid functions, split (and
    z drawn) from a generator seeded `VALID_SEED` at every check, so that
    the checks are comparable; in batches of 256."""
    g = torch.Generator(device=xv.device).manual_seed(VALID_SEED)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        losses = [trainer.eval_step(xv[i:i + score_gp.EVAL_BATCH], yv[i:i + score_gp.EVAL_BATCH], g)
                  for i in range(0, xv.shape[0], score_gp.EVAL_BATCH)]
    return torch.cat(losses).mean().item()


def copy_into(dst: dict, src: dict) -> None:
    """Copy each tensor of `src` into the tensor of `dst` of its name, in place."""
    with torch.no_grad():
        for k, t in dst.items():
            t.copy_(src[k])


def train(trainer: Trainer, kernel: str, epochs: int, fns_per_epoch: int, batch: int,
          per_super: int = 80, verbose: bool = True) -> tuple:
    """reproduce_gp.py's training loop (`schedule`): whole supers of chunks
    of graphed steps on fresh functions, the valid loss after each super,
    the best parameters restored at the end over the final BatchNorm
    statistics -> (history, seconds, best valid loss, the buffers at the
    best check)."""
    sampler = score_gp.samplers(kernel)[0]
    device = trainer.state.generator.device
    sched = schedule(epochs, fns_per_epoch, batch, per_super)
    xv, yv = sampler.sample(torch.Generator(device=device).manual_seed(VALID_SEED), N_VALID)

    def sample(g):
        return (*sampler.sample(g, batch), None)

    params = dict(trainer.model.named_parameters())
    best_v, best = math.inf, {k: p.detach().clone() for k, p in params.items()}
    best_stats = {k: b.detach().clone() for k, b in trainer.model.named_buffers()}
    history = []
    t0 = time.perf_counter()
    for s in range(sched["n_super"]):
        chunk_means = torch.stack([trainer.train_steps_generated(sample, sched["chunk"]).mean()
                                   for _ in range(sched["per_super"])])
        v = valid_loss(trainer, xv, yv)
        if v < best_v:  # the best parameters so far, on the device
            best_v = v
            copy_into(best, params)
            copy_into(best_stats, dict(trainer.model.named_buffers()))
        train_loss = chunk_means.mean().item()
        history.append({"epoch": round((s + 1) * sched["per_super"] * sched["chunk"]
                                       / sched["steps_per_epoch"], 2),
                        "dur": time.perf_counter() - t0, "train_loss": train_loss,
                        "valid_loss": v})
        if verbose:
            done = (s + 1) * sched["per_super"] * sched["chunk"] * batch
            print(f"  super {s + 1}/{sched['n_super']} loss {train_loss:.2f} valid {v:.2f} "
                  f"({done / (time.perf_counter() - t0):.0f} fns/s)", flush=True)
    seconds = time.perf_counter() - t0
    copy_into(params, best)  # over the final BatchNorm statistics, as reproduce_gp.py does
    return history, seconds, best_v, best_stats


def write_run(run_dir: str, model: torch.nn.Module, summary: dict, history: list,
              ll) -> dict:
    """The run directory in the JAX package's layout: eval.csv,
    model_summary.txt, history.json, params.msgpack, extra_vars.msgpack and
    summary.json (returned, with the scores)."""
    write_model_summary(run_dir, model)
    write_history(run_dir, history)
    save_run_params(run_dir, model)
    return score_gp.write_scores(run_dir, summary, ll)


def output_dir(summary: dict, out: str, run_index: int) -> str:
    return os.path.join(out, summary["kernel"], summary["model"], f"run_{run_index}")


def run(summary: dict, epochs: int = 100, fns_per_epoch: int = 50_000, batch: int = 32,
        n_test: int = 10_000, seed: int = 123, decay_lr: float = 10.0, per_super: int = 80,
        lr: float = 1e-3, device="cuda", out: str = "runs_torch/", run_index: int = 0,
        resume_from: Optional[str] = None, verbose: bool = True,
        dtype: Optional[torch.dtype] = None) -> tuple:
    """Train the configuration `summary` states (`train_summary`) in compute
    `dtype` (None: float32), restore
    its best-valid parameters, score it (`score_gp.score_model`, from
    `score_gp.EVAL_SEED`) and write its run directory -> (run_dir, summary
    with the scores)."""
    run_dir = output_dir(summary, out, run_index)
    refuse_own_dir(resume_from, run_dir)
    sched = schedule(epochs, fns_per_epoch, batch, per_super)
    trainer = build_trainer(summary, epochs, sched["steps_per_epoch"], device, seed, lr, decay_lr,
                            dtype=dtype)
    if resume_from is not None:
        load_params_into(trainer.model, resume_from)
    if verbose:
        print(f"{summary['model']} on {summary['kernel']}: {sched['steps']} steps "
              f"({sched['n_super']} supers x {sched['per_super']} chunks x {sched['chunk']})",
              flush=True)
    history, seconds, best_v, best_stats = train(trainer, summary["kernel"], epochs,
                                                 fns_per_epoch, batch, per_super, verbose)
    model = trainer.model.eval()
    scores = score_gp.score_model(model, summary["kernel"], n_test, device)
    buffers = dict(model.named_buffers())
    final_stats = {k: b.clone() for k, b in buffers.items()}
    copy_into(buffers, best_stats)
    ll_best_stats = score_gp.score_model(model, summary["kernel"], n_test, device)["ll"]
    copy_into(buffers, final_stats)
    summary = dict(summary, train_seconds=seconds, fns_per_sec=epochs * fns_per_epoch / seconds,
                   steps=sched["steps"], best_valid_loss=best_v,
                   mean_test_ll_best_check_stats=float(ll_best_stats.mean()))
    if resume_from is not None:
        summary["resumed_from"] = resume_from
    return run_dir, write_run(run_dir, trainer.model, summary, history, scores["ll"])


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="CNP", choices=list(GP_MODELS))
    ap.add_argument("--kernel", default="RBF_Kernel", choices=list(score_gp.KERNELS))
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--fns-per-epoch", type=int, default=50_000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--n-test", type=int, default=10_000)
    ap.add_argument("--out", default="runs_torch/")
    ap.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--decay-lr", type=float, default=10.0)
    ap.add_argument("--per-super", type=int, default=80)
    ap.add_argument("--init", choices=["intended", "realized"], default="intended")
    ap.add_argument("--norm-eps", type=float, default=1e-3)
    ap.add_argument("--ablation", default=None,
                    help="ELBO{True|False}_LatLB{True|False}_SigLB{True|False} "
                         "(LNP, AttnLNP, ConvLNP)")
    ap.add_argument("--ablation-arch", default="notebook", choices=("notebook", "headline"))
    ap.add_argument("--loss", default="default", choices=("default", "sumo"))
    ap.add_argument("--run", type=int, default=0)
    ap.add_argument("--resume-from", default=None, metavar="RUN_DIR")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    ap = parser()
    args = ap.parse_args(argv)
    try:
        summary = train_summary(args.model, args.kernel, args.epochs, args.norm_eps, args.init,
                                args.ablation, args.ablation_arch, args.loss, args.lr,
                                args.decay_lr)
        refuse_own_dir(args.resume_from, output_dir(summary, args.out, args.run))
    except ValueError as e:
        ap.error(str(e))
    set_numerics()
    run_dir, summary = run(summary, args.epochs, args.fns_per_epoch, args.batch, args.n_test,
                           args.seed, args.decay_lr, args.per_super, args.lr, args.device,
                           args.out, args.run, args.resume_from,
                           dtype=torch.bfloat16 if args.bf16 else None)
    print(json.dumps({"run_dir": run_dir, **summary}))
    return summary


if __name__ == "__main__":
    main()
