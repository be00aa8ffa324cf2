"""Training on a device mesh (`parallel`): the n-rank dry run, the
counterpart of `__graft_entry__.dryrun_multichip`, and a GW configuration's
train steps on a mesh, as a function of one rank and as a command.

    python -m torch.distributed.run --nproc-per-node N \\
        -m npf_gwwaveform_tpu_torch.multichip [--axes data=N] [--steps 5] [--batch 256] \\
        [--run-dir RUN_DIR] [--device cuda|cpu]
    python -m npf_gwwaveform_tpu_torch.multichip --dryrun N [--device cuda|cpu]

The first trains `--steps` steps of `bench.py`'s flagship workload
(`experiments/_flagship.py`: ConvCNP, r_dim 128, five k=19 blocks without
normalisation, density 64, U{0..64} contexts of 256 points, the CNPF loss,
fresh waveforms every step), or of the configuration `--run-dir` recorded
(a GW run's, or an image run's on its training images), from seed 0 in
float32, through `Trainer(mesh=...)` on `--axes` (e.g. `data=2,seq=2`; `-1`
takes the ranks left), one rank a process (`torch.distributed.run` sets each
rank's environment; NCCL on CUDA, gloo with `--device cpu`), and prints rank
0's per-step losses as one JSON line: the losses one process would print. On
an NCCL mesh the steps replay a CUDA graph, collectives included; on a gloo
mesh they run eagerly. `--dryrun N` starts N ranks itself and runs one full
train step of JAX's tiny flagship on a `data` mesh, and for even N another
on a `data` x `seq` (N/2 x 2) mesh.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch
import torch.distributed as dist

from . import train_img
from .configs import gw_train_summary, is_img_summary, train_config
from .data.datasplit import CntxtTrgtSplitter, GetRandomIndcs, get_all_indcs
from .data.images import get_train_test_img_dataset
from .losses import CNPFLoss
from .models.convnp import ConvCNP
from .ops.kernels import counts, reset_counts
from .parallel.launch import run_ranks
from .parallel.mesh import make_mesh
from .train_gw import batch_sampler, build_trainer
from .training.optim import make_optimizer
from .training.trainer import Trainer
from .utils.helpers import set_numerics
from .utils.init import init_module

__all__ = ["FLAGSHIP_DATA", "tiny_flagship", "flagship_trainer", "run_trainer", "train_on_mesh",
           "mesh_rank", "dryrun_multichip", "main"]

# bench.py's data: unconditioned time-domain waveforms, 256 points, U{0..64} contexts
FLAGSHIP_DATA = gw_train_summary(cond=False, n_context=64, density=64)


def tiny_flagship() -> ConvCNP:
    """`__graft_entry__._flagship(tiny=True)`: r_dim 16, density 8, two k=5
    blocks of one conv layer, no normalisation (JAX's ConvCNP defaults)."""
    return ConvCNP(r_dim=16, density_induced=8, cnn_n_blocks=2, cnn_kernel_size=5, cnn_norm=None,
                   cnn_n_conv_layers=1)


def flagship_trainer(device, dtype: Optional[torch.dtype] = None, mesh=None) -> Trainer:
    """`bench.py`'s model and optimizer (`experiments/_flagship.py:32-62`):
    ConvCNP r_dim 128, five k=19 blocks of one conv layer without
    normalisation, density 64, K2/K3 decoder; Adam at 1e-3 without decay;
    the CNPF loss; contexts U{0..64}, every point a target. Drawn from the
    JAX init schemes with a generator seeded 0, which seeds the trainer's
    generator too."""
    model = ConvCNP(r_dim=128, density_induced=64, cnn_n_blocks=5, cnn_kernel_size=19,
                    cnn_norm=None, cnn_n_conv_layers=1, dtype=dtype)
    init_module(model, torch.Generator().manual_seed(0))
    model.to(device)
    splitter = CntxtTrgtSplitter(contexts_getter=GetRandomIndcs(a=0.0, b=64),
                                 targets_getter=get_all_indcs)
    return Trainer(model, CNPFLoss(), make_optimizer(model.parameters(), lr=1e-3, decay_lr=None),
                   splitter, generator=torch.Generator(device=device).manual_seed(0), mesh=mesh)


def run_trainer(run_dir: Optional[str], steps: int, batch: int, device, mesh=None,
                remat: bool = False) -> tuple:
    """(trainer, sample) for `steps` steps of `batch` examples, in float32
    from seed 0 (the model's init and the trainer's generator): the
    flagship workload (`run_dir` None); a GW run's recorded configuration
    (`configs.train_config`, `train_gw.build_trainer`) on fresh waveforms;
    or an image run's (`train_img.build_trainer`; `remat` recomputes its
    CNN blocks in the backward pass) on its training images drawn with
    replacement. sample(generator) -> (x, y, condition or None)."""
    summary = None
    if run_dir is not None:
        with open(os.path.join(run_dir, "summary.json")) as f:
            summary = json.load(f)
    image = summary is not None and is_img_summary(summary)
    if remat and not image:
        raise ValueError("remat recomputes an image model's blocks: a GW model has no remat")
    if summary is None:
        return flagship_trainer(device, mesh=mesh), batch_sampler(FLAGSHIP_DATA, batch)
    if not image:
        data = train_config(summary)
        return build_trainer(data, steps, device, mesh=mesh), batch_sampler(data, batch)
    train_ds, _ = get_train_test_img_dataset(summary["dataset"])
    sched = train_img.schedule(len(train_ds), summary["epochs"], batch, steps)
    trainer = train_img.build_trainer(summary["model"], summary["dataset"],
                                      int(train_ds.shape[-1]), summary["epochs"],
                                      sched["steps_per_epoch"], device, remat=remat, mesh=mesh)
    return trainer, train_img.image_sampler(train_ds.images.to(device), batch)


def train_on_mesh(run_dir: Optional[str], axes: Optional[dict], steps: int, batch: int,
                  device="cuda", grads_out: Optional[str] = None, remat: bool = False) -> dict:
    """This rank's part of `steps` train steps of `run_trainer(run_dir,
    steps, batch, remat=remat)` on a mesh of `axes` (None: `data` over
    every rank): one process's init and draws. On an NCCL mesh the steps
    replay a CUDA graph; on another they run eagerly, and `grads_out` has
    rank 0 save the first step's gradients there (after the all-reduce and
    the clip). Float32 products without TF32 (`utils.helpers.set_numerics`),
    as every entry point of the port. -> the global losses, this rank's
    kernel launches (`ops.kernels.counts`), its coordinates, and on a mesh
    the graphs cannot capture the refusal's message."""
    set_numerics()
    mesh = make_mesh(axes, device)
    trainer, sample = run_trainer(run_dir, steps, batch, mesh.device, mesh, remat)
    reset_counts()
    if mesh.backend == "nccl":
        losses = trainer.train_steps_generated(sample, steps)
    else:
        losses = []
        for i in range(steps):
            x, y, cond = sample(trainer.state.generator)
            m = trainer.train_step(x, y) if cond is None else trainer.train_step_cond(x, y, cond)
            losses.append(m["loss"])
            if i == 0 and grads_out is not None and dist.get_rank() == 0:
                torch.save({n: p.grad.cpu() for n, p in trainer.model.named_parameters()},
                           grads_out)
        losses = torch.stack(losses)
    launched = counts()
    refused = None
    if mesh.backend != "nccl":
        try:
            trainer.generated_graph(sample)
        except ValueError as e:
            refused = str(e)
    return dict(losses=losses.tolist(), counts=list(launched), coords=list(mesh.coords),
                refused=refused)


def mesh_rank(rank: int, world: int, runs: list) -> list:
    """`train_on_mesh(**kwargs)` for each kwargs of `runs`, as a
    `parallel.launch.run_ranks` target."""
    return [train_on_mesh(**kwargs) for kwargs in runs]


def _dryrun_rank(rank: int, world: int, device: str) -> dict:
    """One train step of the tiny flagship at batch 2 * world, 16 points, on
    a `data` mesh, and for an even world on `data` x `seq`."""
    set_numerics()
    losses = {}
    meshes = {"data": {"data": world}}
    if world % 2 == 0:
        meshes["data_seq"] = {"data": world // 2, "seq": 2}
    for name, axes in meshes.items():
        mesh = make_mesh(axes, device)
        model = tiny_flagship()
        init_module(model, torch.Generator().manual_seed(0))
        model.to(mesh.device)
        splitter = CntxtTrgtSplitter(contexts_getter=GetRandomIndcs(a=2, b=6),
                                     targets_getter=get_all_indcs)
        trainer = Trainer(model, CNPFLoss(), make_optimizer(model.parameters(), decay_lr=None),
                          splitter, torch.Generator(device=mesh.device).manual_seed(0), mesh)
        g = torch.Generator(device=mesh.device).manual_seed(0)
        x = torch.rand((2 * world, 16, 1), generator=g, device=mesh.device) * 2 - 1
        y = torch.randn((2 * world, 16, 1), generator=g, device=mesh.device)
        loss = trainer.train_step(x, y)["loss"].item()
        if not torch.isfinite(torch.tensor(loss)):
            raise AssertionError(f"non-finite loss in the {name} dry run")
        losses[name] = loss
    return losses


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 600.0) -> dict:
    """Start `n_devices` ranks (NCCL, one GPU each; `device="cpu"`: gloo on
    the CPU) and run one full train step of the tiny flagship on an
    n-rank `data` mesh, and for even n on a (n/2 x 2) `data` x `seq` mesh
    -> rank 0's losses by mesh. Raises where fewer GPUs than `n_devices`
    exist (no fallback to the CPU), where a rank fails, or after `timeout`
    seconds."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}): {torch.cuda.device_count()} GPUs")
    cpu = torch.device(device).type == "cpu"
    return run_ranks("npf_gwwaveform_tpu_torch.multichip:_dryrun_rank", n_devices, (str(device),),
                     backend="gloo" if cpu else "nccl", timeout=timeout,
                     threads=1 if cpu else None)[0]


def _axes(text: str) -> dict:
    return {k: int(v) for k, v in (kv.split("=") for kv in text.split(","))}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--axes", type=_axes, default=None, help="e.g. data=2,seq=2")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--run-dir", default=None,
                   help="a GW or image run whose configuration to train")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dryrun", type=int, default=None, metavar="N")
    args = p.parse_args(argv)
    if args.dryrun is not None:
        out = dryrun_multichip(args.dryrun, args.device)
    else:
        out = train_on_mesh(args.run_dir, args.axes, args.steps, args.batch, args.device)
        rank = dist.get_rank()
        dist.destroy_process_group()
        if rank != 0:
            return out
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
