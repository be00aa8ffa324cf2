"""The JAX package's own training of the flagship configuration, for
comparing the port's early training loss with the reference's. Not a test:
run it by hand on the CPU.

    JAX_PLATFORMS=cpu python tests/jax_reference_training.py [--seed 0] [--steps 500]

It builds what `experiments/reproduce_gw.py --cond --cond-mode film
--n-context 192 --density 128` trains (model, splitter, optimizer and
`make_batch`, batch 32, state from `create_train_state(seed=...)`), takes one
jitted train step at a time with data keys split from PRNGKey(0), and prints
the median loss of every 10 steps, then the medians over steps 1-50 and
251-500 as one JSON line.
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=500)
    args = ap.parse_args()
    batch, n_points = 32, 256
    gen, space = GWWaveformGenerator(duration=1.0, sample_rate=1024.0), GWParameterSpace()
    model = gp_model_1d("ConvCNP", cnn_norm_eps=1e-3).clone(
        y_dim=1, cond_dim=4, cond_mode="film", density_induced=128)
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
    print(json.dumps(dict(seed=args.seed, steps=args.steps,
                          median_1_50=float(np.median(losses[:50])),
                          median_251_500=float(np.median(losses[250:500])))))


if __name__ == "__main__":
    main()
