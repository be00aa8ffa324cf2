"""The ranks of `tests/test_torch_parallel.py` and of the mesh run in
`tests/test_torch_isolation.py`: functions that `parallel.launch.run_ranks`
starts in processes of their own, one a rank, over gloo on the CPU. The
module imports numpy and torch only (the port inside its functions), so a
rank loads neither JAX nor pytest; the same functions give the test its
one-process references when called with no mesh.

Not a test module: pytest collects `test_*.py` only."""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

STEPS = 6
BATCH, N_POINTS = 8, 24

# name -> (model factory arguments, criterion, target count): each case a
# small model of a family the mesh must keep exact
CASES = {
    "cnp": ("CNP", dict(r_dim=16), "CNPFLoss", N_POINTS),
    "cnp_pooled": ("CNP", dict(r_dim=16, is_heteroskedastic=False), "CNPFLoss", N_POINTS),
    "convcnp_bn": ("ConvCNP", dict(r_dim=8, density_induced=8, cnn_n_blocks=2,
                                   cnn_kernel_size=5), "CNPFLoss", N_POINTS),
    "lnp_npml": ("LNP", dict(r_dim=16, n_z_samples_train=4, n_z_samples_test=4), "NLLLossLNPF",
                 N_POINTS),
    "convlnp_elbo": ("ConvLNP", dict(r_dim=8, density_induced=8, cnn_n_blocks=2,
                                     cnn_kernel_size=5, is_q_zCct=True, n_z_samples_train=1,
                                     n_z_samples_test=4), "ELBOLossLNPF", N_POINTS),
    "convcnp_seq25": ("ConvCNP", dict(r_dim=8, density_induced=8, cnn_n_blocks=2,
                                      cnn_kernel_size=5), "CNPFLoss", 25),
}


def case_data(n_points: int, seed: int = 7):
    """xs [STEPS, BATCH, n, 1] on [-1, 1], ys smooth functions of them."""
    rng = np.random.default_rng(seed)
    xs = np.sort(rng.uniform(-1, 1, (STEPS, BATCH, n_points, 1)), axis=2).astype(np.float32)
    ys = (np.sin(4 * xs + rng.uniform(0, 6, (STEPS, BATCH, 1, 1)))
          + 0.1 * rng.standard_normal(xs.shape)).astype(np.float32)
    return torch.from_numpy(xs), torch.from_numpy(ys)


def train_case(name: str, axes=None) -> dict:
    """The eval step's per-function losses on the first batch, then STEPS
    train steps, of the case from the init of seed 0 (one process with
    `axes` None, else on a CPU mesh of `axes`) -> both. (The eval comes
    first: after a step, the biases that a train-mode BatchNorm cancels have
    taken Adam steps of +-lr on gradients that are rounding noise, in any
    order of the sums, and the eval-mode forward sees them.)"""
    from npf_gwwaveform_tpu_torch import losses, models
    from npf_gwwaveform_tpu_torch.data.datasplit import (
        CntxtTrgtSplitter, GetRandomIndcs, get_all_indcs)
    from npf_gwwaveform_tpu_torch.parallel import make_mesh
    from npf_gwwaveform_tpu_torch.training import Trainer, make_optimizer
    from npf_gwwaveform_tpu_torch.utils.init import init_module

    cls, kwargs, criterion, n_points = CASES[name]
    model = getattr(models, cls)(**kwargs)
    init_module(model, torch.Generator().manual_seed(0))
    splitter = CntxtTrgtSplitter(contexts_getter=GetRandomIndcs(a=3, b=12),
                                 targets_getter=get_all_indcs)
    mesh = None if axes is None else make_mesh(axes, "cpu")
    trainer = Trainer(model, getattr(losses, criterion)(),
                      make_optimizer(model.parameters(), decay_lr=None), splitter,
                      torch.Generator().manual_seed(0), mesh)
    xs, ys = case_data(n_points)
    ev = trainer.eval_step(xs[0], ys[0], torch.Generator().manual_seed(1))
    out = [trainer.train_step(xs[i], ys[i])["loss"].item() for i in range(STEPS)]
    return dict(losses=out, eval=ev.tolist())


def grid_remat_case(axes=None) -> dict:
    """STEPS train steps of a GridConvCNP with BatchNorm whose CNN blocks are
    recomputed in the backward pass (`cnn_remat`), on 8 x 8 images with the
    image training splitter, from the init of seed 0 (one process with
    `axes` None, else on a CPU mesh of `axes`), each backward run on a
    thread of its own. A new thread starts with an empty context, as the
    autograd engine's device thread does on CUDA, where a remat block's
    recomputation runs. -> the losses and the first step's gradients."""
    from npf_gwwaveform_tpu_torch.losses import CNPFLoss
    from npf_gwwaveform_tpu_torch.models import GridConvCNP
    from npf_gwwaveform_tpu_torch.parallel import make_mesh
    from npf_gwwaveform_tpu_torch.score_img import splitter_for
    from npf_gwwaveform_tpu_torch.training import Trainer, make_optimizer
    from npf_gwwaveform_tpu_torch.utils.init import init_module

    model = GridConvCNP(r_dim=8, cnn_n_blocks=2, cnn_kernel_size=3, conv_kernel_size=3,
                        cnn_remat=True)
    init_module(model, torch.Generator().manual_seed(0))
    mesh = None if axes is None else make_mesh(axes, "cpu")
    trainer = Trainer(model, CNPFLoss(), make_optimizer(model.parameters(), decay_lr=None),
                      splitter_for("GridConvCNP", indep_n=False), torch.Generator().manual_seed(0),
                      mesh)
    rng = np.random.default_rng(5)
    imgs = torch.from_numpy(rng.uniform(0, 1, (STEPS, BATCH, 8, 8, 1)).astype(np.float32))
    backward = torch.Tensor.backward

    def on_own_thread(self, *args, **kwargs):
        with ThreadPoolExecutor(max_workers=1) as pool:
            pool.submit(backward, self, *args, **kwargs).result()

    torch.Tensor.backward = on_own_thread
    try:
        losses, grads = [], None
        for i in range(STEPS):
            losses.append(trainer.train_step(imgs[i], imgs[i])["loss"].item())
            if i == 0:
                grads = torch.cat([p.grad.reshape(-1) for p in model.parameters()]).tolist()
    finally:
        torch.Tensor.backward = backward
    return dict(losses=losses, grads=grads)


def cases_rank(rank: int, world: int, runs: list, train_models_dir=None) -> dict:
    """Each (name, axes) of `runs` on this rank -> {name: train_case}, and
    `grid_remat_case` on a `data` mesh of every rank (-> "grid_remat");
    then, given a directory, `train_models_rank` into it (-> "train_models")."""
    torch.set_num_threads(1)
    out = {name: train_case(name, axes) for name, axes in runs}
    out["grid_remat"] = grid_remat_case({"data": world})
    if train_models_dir is not None:
        out["train_models"] = train_models_rank(rank, world, train_models_dir)
    return out


def layout_rank(rank: int, world: int, layouts: list) -> dict:
    """For each axes of `layouts`: this rank's coordinates, its rows of a
    [8, 8, 1] batch (`shard_batch`) and its slice of the targets
    (`constrain_targets_seq`)."""
    from npf_gwwaveform_tpu_torch.parallel import constrain_targets_seq, make_mesh, shard_batch

    torch.set_num_threads(1)
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8, 1)
    out = {}
    for axes in layouts:
        mesh = make_mesh(axes, "cpu")
        batch = shard_batch(dict(X_cntxt=x, X_trgt=x, Y_trgt=-x, mask_trgt=x[..., 0] > 9), mesh)
        trgt = constrain_targets_seq(batch, mesh)
        out[",".join(f"{k}={v}" for k, v in axes.items())] = dict(
            coords=list(mesh.coords), rows=batch["X_cntxt"].tolist(),
            y_trgt=trgt["Y_trgt"].tolist(), mask_trgt=trgt["mask_trgt"].tolist(),
            contiguous=all(t.is_contiguous() for t in trgt.values()))
    return out


def fixed_split(generator, x, y, condition=None) -> dict:
    """Contexts where y > 0.5, every point a target: no draw."""
    ones = torch.ones(x.shape[:2], dtype=torch.bool)
    return dict(X_cntxt=x, Y_cntxt=y, mask_cntxt=y[..., 0] > 0.5, X_trgt=x, Y_trgt=y,
                mask_trgt=ones)


def jax_twin_rank(rank: int, world: int, state: str, axes: dict) -> list:
    """The ConvCNP of the JAX comparison (r_dim 16, density 16, two k=5
    BatchNorm blocks) from the state dict at `state`, STEPS steps on a mesh
    of `axes` with `fixed_split`, Adam at 1e-3 -> the losses."""
    from npf_gwwaveform_tpu_torch.losses import CNPFLoss
    from npf_gwwaveform_tpu_torch.models import ConvCNP
    from npf_gwwaveform_tpu_torch.parallel import make_mesh
    from npf_gwwaveform_tpu_torch.training import Trainer, make_optimizer

    torch.set_num_threads(1)
    model = ConvCNP(r_dim=16, density_induced=16, cnn_n_blocks=2, cnn_kernel_size=5)
    model.load_state_dict(torch.load(state), strict=True)
    trainer = Trainer(model, CNPFLoss(), make_optimizer(model.parameters(), decay_lr=None),
                      fixed_split, torch.Generator().manual_seed(0), make_mesh(axes, "cpu"))
    xs, ys = case_data(N_POINTS, seed=11)
    return [trainer.train_step(xs[i], ys[i])["loss"].item() for i in range(STEPS)]


def eight_rank(rank: int, world: int, layouts: list, state: str, axes: dict) -> dict:
    """`layout_rank` and `jax_twin_rank` in one launch."""
    return dict(layouts=layout_rank(rank, world, layouts),
                twin=jax_twin_rank(rank, world, state, axes))


def train_models_run(out_dir: str, mesh=None) -> dict:
    """`train_models` of a CNP on 32 RBF functions, 2 epochs at batch 8,
    valid and test sets of 16 -> the run directory."""
    from npf_gwwaveform_tpu_torch.data.datasplit import (
        CntxtTrgtSplitter, GetRandomIndcs, get_all_indcs)
    from npf_gwwaveform_tpu_torch.data.gp import GPDataset, GPSampler
    from npf_gwwaveform_tpu_torch.losses import CNPFLoss
    from npf_gwwaveform_tpu_torch.models import CNP
    from npf_gwwaveform_tpu_torch.training import train_models

    sampler = GPSampler(kernel="rbf", n_points=16)
    data = {k: GPDataset(sampler, n, seed=s, device="cpu") for k, n, s in
            (("train", 32, 0), ("valid", 16, 1), ("test", 16, 2))}
    train_models(datasets={"RBF": data["train"]}, models={"CNP": CNP(r_dim=16)},
                 criterion=CNPFLoss(), test_datasets={"RBF": data["test"]},
                 valid_datasets={"RBF": data["valid"]},
                 splitter=CntxtTrgtSplitter(contexts_getter=GetRandomIndcs(a=2, b=8),
                                            targets_getter=get_all_indcs),
                 chckpnt_dirname=out_dir, max_epochs=2, batch_size=8, verbose=0, device="cpu",
                 mesh=mesh)
    return os.path.join(out_dir, "RBF", "CNP", "run_0")


def train_models_rank(rank: int, world: int, out_dir: str) -> dict:
    """`train_models_run` on a `data` mesh of every rank, counting the run
    files this rank writes (every writer `training.train` calls, and
    numpy's `savetxt` of eval.csv)."""
    from npf_gwwaveform_tpu_torch.parallel import make_mesh
    from npf_gwwaveform_tpu_torch.training import train as train_mod

    torch.set_num_threads(1)
    writes = []

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            writes.append(name)
            return fn(*args, **kwargs)
        return wrapper

    for name in ("save_run_params", "save_train_state", "write_history", "write_model_summary"):
        setattr(train_mod, name, counted(name, getattr(train_mod, name)))
    np.savetxt = counted("savetxt", np.savetxt)
    run_dir = train_models_run(out_dir, make_mesh(device="cpu"))
    return dict(writes=writes, run_dir=run_dir)


def isolated_mesh_step(rank: int, world: int) -> dict:
    """With JAX, flax and the JAX package made unimportable: one train step
    of the tiny flagship on a `data` mesh of every rank -> the loss and
    whatever of those got loaded."""
    import sys

    blocked = ("jax", "jaxlib", "flax", "npf_gwwaveform_tpu")
    for name in blocked:
        sys.modules[name] = None
    torch.set_num_threads(1)
    from npf_gwwaveform_tpu_torch import multichip

    losses = multichip._dryrun_rank(rank, world, "cpu")
    loaded = [m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in blocked]
    return dict(losses=losses, loaded=loaded)
