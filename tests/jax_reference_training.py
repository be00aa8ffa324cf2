"""The JAX package's own training of the flagship configuration, for
comparing the port's early training loss with the reference's. Not a test:
run it by hand on the CPU.

    JAX_PLATFORMS=cpu python tests/jax_reference_training.py [--seed 0] [--steps 500]
        [--bf16 [--fused-mlp]]

It builds what `experiments/reproduce_gw.py --cond --cond-mode film
--n-context 192 --density 128` trains (model, splitter, optimizer and
`make_batch`, batch 32, state from `create_train_state(seed=...)`), takes one
jitted train step at a time with data keys split from PRNGKey(0), and prints
the median loss of every 10 steps, then the medians over steps 1-50 and
251-500 as one JSON line. `--bf16` builds every module in bfloat16 compute,
as `reproduce_gw.py --bf16` does; `--fused-mlp` adds the decoder's fused
MLP-chain kernel (Pallas, interpret mode on the CPU), the model the port's
kernel path matches. Run bf16 with
`XLA_FLAGS=--xla_allow_excess_precision=false` for the op-by-op rounding the
port follows (tests/test_torch_bf16_slice.py).

    JAX_PLATFORMS=cpu python tests/jax_reference_training.py --gp cnp|npml|notebook|SET_NAME
        [--seed 0] [--steps 1000] [--banded] [--losses-out FILE]

trains instead a GP configuration of `experiments/reproduce_gp.py` on RBF
functions, as that script builds it with its defaults (BatchNorm eps 1e-3,
the intended init, Adam 1e-3 decaying x10 over 100 epochs of 1,562 steps,
clip 1.0 for ConvLNP, contexts of U{0..50} of 128 points, batch 32, the
functions sampled inside the jitted step): `cnp` the ConvCNP, `npml` the
headline ConvLNP (NPML, 16 draws), `notebook` the ablation's
`ConvLNP_ELBOFalse_LatLBFalse_SigLBFalse`; a set or attention family run
name (`SET_NAMES`: CNP, LNP and AttnLNP trained with NPVI, AttnCNP, the
NPML ablation variant `AttnLNP_ELBOFalse_LatLBFalse_SigLBFalse`, and
`LNP_SUMO`, SUMO on LNP's NPML variant) that configuration, unclipped, as
`reproduce_gp.py --model M [--ablation A | --loss sumo]` builds it. It
prints the 50-step means and
then the medians over the first and the last 50 steps as one JSON line: the
fall bars `chip_smoke.py` holds the port's 1,000 graphed steps to.
`--banded` lowers the depthwise convolutions to the JAX package's banded
matmuls (`cnn_banded`: the same parameters and linear map), which XLA runs
several times faster on the CPU than its grouped convolutions; the ConvLNP
bars come from such runs (about 6-8 s a step on four cores).
`--losses-out FILE` appends each step's loss to FILE as it comes (a ConvLNP
step takes seconds here, so a long run is read while it goes).

    JAX_PLATFORMS=cpu python tests/jax_reference_training.py --img NAME [--dataset digits]
        [--seed 0] [--steps 300] [--losses-out FILE]

trains instead an image configuration of `experiments/reproduce_img.py` as
that script builds and steps it (its `build_model`, circular padding and
BatchNorm eps 1e-2 on `zsmms`, Adam 1e-3 decaying x10 over its default 50
epochs of len(train) // 32 steps, clip 1.0, contexts of U{0..30%} of the
pixels, batch 32 drawn from the training images with replacement inside the
jitted step, the keys of chunk i split from PRNGKey(5 + i) in chunks of
100, the state from `create_train_state(seed=...)`), and prints the
50-step means and the medians over the first and the last 50 steps as one
JSON line: the bars `chip_smoke.py` holds the port's graphed steps to.
"""

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from npf_gwwaveform_tpu.configs import gp_criterion, gp_model_1d  # noqa: E402
from npf_gwwaveform_tpu.data import (  # noqa: E402
    CntxtTrgtSplitter, GetRandomIndcs, GWParameterSpace, GWWaveformGenerator, get_all_indcs,
)
from npf_gwwaveform_tpu.training import Trainer, create_train_state, make_optimizer  # noqa: E402


# the set and attention family's configurations `--gp` takes by run name
SET_NAMES = ("CNP", "LNP", "AttnCNP", "AttnLNP", "AttnLNP_ELBOFalse_LatLBFalse_SigLBFalse",
             "LNP_SUMO")


def gp_model_and_loss(gp: str):
    """(model, criterion, clip) of a `--gp` choice, as reproduce_gp.py builds it."""
    from npf_gwwaveform_tpu.configs import gp_model_variant
    from npf_gwwaveform_tpu.losses import ELBOLossLNPF, NLLLossLNPF, SUMOLossLNPF

    if gp == "notebook":
        return gp_model_variant("ConvLNP", False, False, False), NLLLossLNPF(), 1.0
    if gp in ("cnp", "npml"):
        name = "ConvCNP" if gp == "cnp" else "ConvLNP"
        return gp_model_1d(name), gp_criterion(name), None if gp == "cnp" else 1.0
    if gp.endswith("_SUMO"):
        return gp_model_variant(gp[: -len("_SUMO")], False, True, True), SUMOLossLNPF(), None
    if "_ELBO" in gp:
        base, flags = gp.split("_", 1)
        elbo, lat_lb, sig_lb = (f"{k}True" in flags for k in ("ELBO", "LatLB", "SigLB"))
        return (gp_model_variant(base, elbo, lat_lb, sig_lb),
                ELBOLossLNPF() if elbo else NLLLossLNPF(), None)
    return gp_model_1d(gp), gp_criterion(gp), None


def gp_main(args) -> None:
    """The GP configuration's training (module docstring)."""
    from npf_gwwaveform_tpu.data.gp import KERNEL_CONFIGS, GPSampler

    batch = 32
    sampler = GPSampler(n_points=128, **KERNEL_CONFIGS["RBF_Kernel"])
    model, criterion, clip = gp_model_and_loss(args.gp)
    if args.banded:  # the same model with the banded-matmul depthwise lowering
        name = "ConvCNP" if args.gp == "cnp" else "ConvLNP"
        model = model.clone(CNNFactory=gp_model_1d(name, cnn_banded=True).CNNFactory)
    splitter = CntxtTrgtSplitter(contexts_getter=GetRandomIndcs(a=0.0, b=50),
                                 targets_getter=get_all_indcs)
    tx = make_optimizer(lr=1e-3, decay_lr=10.0, max_epochs=100, steps_per_epoch=1562,
                        grad_clip_norm=clip)
    trainer = Trainer(model, criterion, tx, splitter=splitter)
    key = jax.random.PRNGKey(args.seed)
    x0, y0 = sampler.sample(key, batch)
    state = create_train_state(model, tx, splitter(key, x0, y0), seed=args.seed)

    @jax.jit
    def one_step(state, k):
        x, y = sampler.sample(k, batch)
        state, metrics = trainer._train_step(state, x, y)
        return state, metrics["loss"]

    losses = []
    for i, k in enumerate(jax.random.split(jax.random.PRNGKey(1000 + args.seed), args.steps)):
        state, loss = one_step(state, k)
        losses.append(float(loss))
        if args.losses_out:
            with open(args.losses_out, "a") as f:
                f.write(f"{losses[-1]!r}\n")
        if (i + 1) % 50 == 0:
            print(f"{i + 1} mean of the last 50: {np.mean(losses[-50:]):.1f}", flush=True)
    print(json.dumps(dict(gp=args.gp, seed=args.seed, steps=args.steps,
                          means_50=[float(np.mean(losses[i:i + 50]))
                                    for i in range(0, args.steps, 50)],
                          median_first_50=float(np.median(losses[:50])),
                          median_last_50=float(np.median(losses[-50:])))))


def img_main(args) -> None:
    """The image configuration's training (module docstring)."""
    from experiments.reproduce_img import POINT_MODELS, build_model
    from npf_gwwaveform_tpu.data import get_train_test_img_dataset
    from npf_gwwaveform_tpu.data.datasplit import (
        GridCntxtTrgtSplitter, PointsFromGridSplitter, RandomMasker, no_masker,
    )
    from npf_gwwaveform_tpu.losses import CNPFLoss, NLLLossLNPF

    batch, epochs, inner = 32, 50, 100
    train_ds, _ = get_train_test_img_dataset(args.dataset)
    y_dim = int(train_ds.shape[-1])
    zsmms = dict(padding="CIRCULAR", norm_eps=1e-2) if args.dataset == "zsmms" else {}
    model = build_model(args.img, y_dim=y_dim, **zsmms)
    criterion = NLLLossLNPF() if "LNP" in args.img else CNPFLoss()
    masker = RandomMasker(a=0.0, b=0.3)
    splitter = (PointsFromGridSplitter(context_masker=masker) if args.img in POINT_MODELS else
                GridCntxtTrgtSplitter(context_masker=masker, target_masker=no_masker))
    tx = make_optimizer(lr=1e-3, decay_lr=10.0, max_epochs=epochs,
                        steps_per_epoch=max(1, len(train_ds) // batch), grad_clip_norm=1.0)
    trainer = Trainer(model, criterion, tx, splitter=splitter)
    imgs = train_ds.images
    x0, y0 = next(train_ds.epoch_batches(batch))
    state = create_train_state(model, tx, splitter(jax.random.PRNGKey(0), x0, y0),
                               seed=args.seed)

    @jax.jit
    def one_step(state, k):
        ki, _ = jax.random.split(k)
        y = imgs[jax.random.randint(ki, (batch,), 0, imgs.shape[0])]
        state, metrics = trainer._train_step(state, y, y)
        return state, metrics["loss"]

    losses = []
    for c in range(-(-args.steps // inner)):
        for k in jax.random.split(jax.random.PRNGKey(5 + c), inner)[:args.steps - c * inner]:
            state, loss = one_step(state, k)
            losses.append(float(loss))
            if args.losses_out:
                with open(args.losses_out, "a") as f:
                    f.write(f"{losses[-1]!r}\n")
            if len(losses) % 50 == 0:
                print(f"{len(losses)} mean of the last 50: {np.mean(losses[-50:]):.1f}",
                      flush=True)
    print(json.dumps(dict(img=args.img, dataset=args.dataset, seed=args.seed, steps=args.steps,
                          means_50=[float(np.mean(losses[i:i + 50]))
                                    for i in range(0, args.steps, 50)],
                          median_first_50=float(np.median(losses[:50])),
                          median_last_50=float(np.median(losses[-50:])))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=None, help="500, or 1,000 with --gp")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--fused-mlp", action="store_true")
    ap.add_argument("--gp", default=None, choices=("cnp", "npml", "notebook") + SET_NAMES)
    ap.add_argument("--banded", action="store_true",
                    help="with --gp, the depthwise convs as banded matmuls (cnn_banded)")
    ap.add_argument("--losses-out", default=None, metavar="FILE",
                    help="with --gp, append each step's loss to FILE as it comes")
    ap.add_argument("--img", default=None,
                    choices=("GridConvCNP", "GridConvLNP", "GridConvCNPXL", "CNP", "LNP",
                             "AttnCNP", "AttnLNP"))
    ap.add_argument("--dataset", default="digits",
                    choices=("digits", "rgb_digits", "rgb_digits128", "zsmms"))
    args = ap.parse_args()
    if args.img is not None:
        args.steps = args.steps or 300
        return img_main(args)
    if args.gp is not None:
        args.steps = args.steps or 1000
        return gp_main(args)
    args.steps = args.steps or 500
    batch, n_points = 32, 256
    gen, space = GWWaveformGenerator(duration=1.0, sample_rate=1024.0), GWParameterSpace()
    dtype = jnp.bfloat16 if args.bf16 else None
    model = gp_model_1d("ConvCNP", dtype=dtype, cnn_norm_eps=1e-3).clone(
        y_dim=1, cond_dim=4, cond_mode="film", density_induced=128, fused_mlp=args.fused_mlp)
    splitter = CntxtTrgtSplitter(contexts_getter=GetRandomIndcs(a=0.0, b=192),
                                 targets_getter=get_all_indcs)
    tx = make_optimizer(lr=1e-3, decay_lr=10.0, max_epochs=200_000 // 1562,
                        steps_per_epoch=1562)
    trainer = Trainer(model, gp_criterion("ConvCNP"), tx, splitter=splitter)
    stride = gen.n_time // n_points
    x_grid = jnp.linspace(-1.0, 1.0, n_points)

    def make_batch(key, n):
        theta = space.sample(key, n)
        _, h = gen.time_domain(theta)
        h = h[..., -n_points * stride::stride][..., :n_points]
        x = jnp.broadcast_to(x_grid[None, :, None], (n, n_points, 1))
        return x, h[..., None], space.normalize(theta)

    key = jax.random.PRNGKey(0)
    x0, y0, p0 = make_batch(key, batch)
    state = create_train_state(model, tx, splitter(key, x0, y0, condition=p0), seed=args.seed)

    @jax.jit
    def one_step(state, k):
        x, y, p = make_batch(k, batch)
        state, metrics = trainer._train_step_cond(state, x, y, p)
        return state, metrics["loss"]

    losses = []
    for i, k in enumerate(jax.random.split(key, args.steps)):
        state, loss = one_step(state, k)
        losses.append(float(loss))
        if (i + 1) % 10 == 0:
            print(f"{i + 1} median of the last 10: {np.median(losses[-10:]):.1f}", flush=True)
    print(json.dumps(dict(seed=args.seed, steps=args.steps, bf16=args.bf16,
                          fused_mlp=args.fused_mlp,
                          median_1_50=float(np.median(losses[:50])),
                          median_251_500=float(np.median(losses[250:500])))))


if __name__ == "__main__":
    main()
