"""Train an image model and score it: the port's counterpart of
`experiments/reproduce_img.py`, in float32 or (`--bf16`) bfloat16 compute.

    python -m npf_gwwaveform_tpu_torch.train_img
        [--model GridConvCNP|GridConvLNP|GridConvCNPXL|CNP|LNP|AttnCNP|AttnLNP]
        [--dataset digits|rgb_digits|rgb_digits128|zsmms] [--epochs 50] [--batch 32]
        [--run 0] [--out runs_torch/] [--remat] [--seed 0] [--steps N] [--n-test N]
        [--device cuda] [--bf16]

The flags have `reproduce_img.py`'s names, defaults and meanings. The model
is `configs.img_model` for the dataset (circular padding and BatchNorm eps
1e-2 on `zsmms`; `--remat` recomputes each CNN block in the backward pass,
the lever for GridConvCNPXL's memory), y_dim the corpus's channels; the
objective NPML for the LNP names, the exact NLL otherwise. Adam at 1e-3
decays x10 over `--epochs` epochs of `len(train) // batch` steps (a
staircase per epoch), the gradients' global norm clipped at 1.0. The
training images live on the device; each step draws `--batch` indices with
replacement, then the context (U{0..30%} of the pixels, one count for the
batch; the grid models take the masks, the point models padded point sets),
then a latent model's z, all from the trainer's generator seeded `--seed`,
inside the step: on CUDA chunks of min(100, steps) replays of one CUDA graph
(`Trainer.train_steps_generated`), on the CPU the eager step. The run
trains `epochs * steps_per_epoch // chunk` whole chunks, or `--steps`
(the port's own flag, for short runs: min(100, steps) a chunk).

The eval is `score_img.score_images` on the test images (`--n-test`, all
by default) from `score_img.EVAL_SEED`. The run directory
`<out>/<dataset>/<model>/run_<run>` gets `reproduce_img.py`'s files:
`eval.csv`, `model_summary.txt`, `history.json` (one entry a chunk: epoch,
seconds, mean train loss), `params.msgpack` and `extra_vars.msgpack`
(flax's layout) and `summary.json` with that script's fields, plus
`train_state.pt` (Adam's state, the update count and the generator,
`training.checkpoint.save_train_state`); the summary is printed as one JSON
line. `--bf16` trains and scores in bfloat16 compute, the model built as
`reproduce_img.build_model(name, dtype=jnp.bfloat16)` builds it (that
script has no flag for it): every module in bf16, the parameters, Adam's
moments, the BatchNorm statistics and the losses float32. The run
directory and summary are a float32 run's; `score_img --bf16` rescores it.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import torch

from . import score_gp, score_img
from .configs import IMG_MODELS, img_criterion, img_model
from .data.images import get_train_test_img_dataset
from .training.checkpoint import save_run_params, save_train_state
from .training.optim import make_optimizer
from .training.train import write_history, write_model_summary
from .training.trainer import Trainer
from .utils import init as winit
from .utils.helpers import set_numerics

CHUNK = 100  # steps a chunk, as reproduce_img.py scans them
DATASETS = ("digits", "rgb_digits", "rgb_digits128", "zsmms")

__all__ = ["CHUNK", "DATASETS", "schedule", "build_trainer", "image_sampler", "train",
           "write_run", "output_dir", "run", "parser", "main"]


def schedule(n_train: int, epochs: int, batch: int, steps: Optional[int] = None) -> dict:
    """reproduce_img.py's loop: steps_per_epoch = len(train) // batch, the
    chunk min(100, total) and the whole chunks trained (of `steps` when
    given, else of epochs * steps_per_epoch)."""
    steps_per_epoch = max(1, n_train // batch)
    total = steps_per_epoch * epochs if steps is None else steps
    if total < 1:
        raise ValueError("no step to take")
    chunk = min(CHUNK, total)
    n_chunks = max(1, total // chunk)
    return dict(steps_per_epoch=steps_per_epoch, chunk=chunk, n_chunks=n_chunks,
                steps=n_chunks * chunk)


def build_trainer(model_name: str, dataset: str, y_dim: int, epochs: int, steps_per_epoch: int,
                  device, seed: int = 0, remat: bool = False,
                  use_kernels: bool = True, dtype: Optional[torch.dtype] = None,
                  mesh=None) -> Trainer:
    """The model in compute `dtype` (None: float32) drawn with a generator
    seeded `seed` on `device`, its
    criterion, Adam with the staircase decay and the clip of 1.0, the
    training splitter (one context count a batch), the trainer's generator
    seeded `seed` too. With `mesh` (`parallel.make_mesh`) the trainer trains
    on it."""
    device = torch.device(device)
    winit.set_realized_init(False)
    model = img_model(model_name, dataset, y_dim, use_kernels, remat, dtype=dtype)
    winit.init_module(model, torch.Generator().manual_seed(seed))
    model.to(device)
    optimizer = make_optimizer(model.parameters(), lr=1e-3, decay_lr=10.0, max_epochs=epochs,
                               steps_per_epoch=steps_per_epoch, grad_clip_norm=1.0)
    return Trainer(model, img_criterion(model_name), optimizer,
                   score_img.splitter_for(model_name, indep_n=False),
                   generator=torch.Generator(device=device).manual_seed(seed), mesh=mesh)


def image_sampler(images: torch.Tensor, batch: int):
    """sample(generator) -> (y, y, None): `batch` images of `images` (on the
    generator's device) drawn with replacement."""

    def sample(g):
        idx = torch.randint(0, images.shape[0], (batch,), generator=g, device=images.device)
        y = images[idx]
        return y, y, None
    return sample


def train(trainer: Trainer, images: torch.Tensor, batch: int, sched: dict,
          verbose: bool = True) -> tuple:
    """`sched["n_chunks"]` chunks of `sched["chunk"]` steps on `images` (on
    the trainer's device) -> (history, per-step losses [steps] on the
    device, seconds)."""
    sample = image_sampler(images, batch)
    history, losses = [], []
    t0 = time.perf_counter()
    for i in range(sched["n_chunks"]):
        chunk = trainer.train_steps_generated(sample, sched["chunk"])
        losses.append(chunk)
        history.append({"epoch": round((i + 1) * sched["chunk"] / sched["steps_per_epoch"], 2),
                        "dur": time.perf_counter() - t0, "train_loss": chunk.mean().item()})
        if verbose and i % max(1, sched["n_chunks"] // 10) == 0:
            print(f"chunk {i}/{sched['n_chunks']} loss {history[-1]['train_loss']:.2f} "
                  f"({(i + 1) * sched['chunk'] / (time.perf_counter() - t0):.0f} steps/s)",
                  flush=True)
    return history, torch.cat(losses), time.perf_counter() - t0


def write_run(run_dir: str, trainer: Trainer, summary: dict, history: list, ll) -> dict:
    """The run directory in the JAX package's layout (eval.csv,
    model_summary.txt, history.json, params.msgpack, extra_vars.msgpack,
    summary.json), plus train_state.pt. Returns the summary written."""
    write_model_summary(run_dir, trainer.model)
    write_history(run_dir, history)
    save_run_params(run_dir, trainer.model)
    save_train_state(run_dir, trainer)
    return score_gp.write_scores(run_dir, summary, ll)


def output_dir(out: str, dataset: str, model: str, run_index: int) -> str:
    return os.path.join(out, dataset, model, f"run_{run_index}")


def run(model_name: str = "GridConvCNP", dataset: str = "digits", epochs: int = 50,
        batch: int = 32, seed: int = 0, device="cuda", out: str = "runs_torch/",
        run_index: int = 0, remat: bool = False, steps: Optional[int] = None,
        n_test: Optional[int] = None, verbose: bool = True,
        dtype: Optional[torch.dtype] = None) -> tuple:
    """Train, score and write one image configuration in compute `dtype`
    -> (run_dir, summary with the scores)."""
    train_ds, test_ds = get_train_test_img_dataset(dataset)
    y_dim = int(train_ds.shape[-1])
    sched = schedule(len(train_ds), epochs, batch, steps)
    trainer = build_trainer(model_name, dataset, y_dim, epochs, sched["steps_per_epoch"], device,
                            seed, remat, dtype=dtype)
    if verbose:
        print(f"{model_name} on {dataset}: {sched['steps']} steps ({sched['n_chunks']} chunks "
              f"x {sched['chunk']})", flush=True)
    history, _, seconds = train(trainer, train_ds.images.to(device), batch, sched, verbose)
    model = trainer.model.eval()
    images = test_ds.images if n_test is None else test_ds.images[:n_test]
    res = score_img.score_images(
        model, score_img.splitter_for(model_name, score_img.test_upscale(test_ds)), images,
        device)
    summary = dict(model=model_name, dataset=dataset, train_seconds=seconds,
                   imgs_per_sec=sched["steps"] * batch / seconds, epochs=epochs,
                   eval_protocol="indep_n", y_dim=y_dim, steps=sched["steps"], seed=seed)
    run_dir = output_dir(out, dataset, model_name, run_index)
    return run_dir, write_run(run_dir, trainer, summary, history, res["ll"])


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="GridConvCNP", choices=list(IMG_MODELS))
    ap.add_argument("--dataset", default="digits", choices=list(DATASETS))
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--out", default="runs_torch/")
    ap.add_argument("--run", type=int, default=0)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=None,
                    help="train this many steps instead of the epochs' (chunks of up to 100)")
    ap.add_argument("--n-test", type=int, default=None, help="score the first N test images")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    return ap


def main(argv=None) -> dict:
    ap = parser()
    args = ap.parse_args(argv)
    try:
        score_gp.check_out_dir(args.out, output_dir(args.out, args.dataset, args.model,
                                                     args.run))
    except ValueError as e:
        ap.error(str(e))
    set_numerics()
    run_dir, summary = run(args.model, args.dataset, args.epochs, args.batch, args.seed,
                           args.device, args.out, args.run, args.remat, args.steps, args.n_test,
                           dtype=torch.bfloat16 if args.bf16 else None)
    print(json.dumps({"run_dir": run_dir, **summary}))
    return summary


if __name__ == "__main__":
    main()
