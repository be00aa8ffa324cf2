"""The port's training of the flagship configuration against the JAX
package's, like for like, over many steps. Not a test: run it by hand on the
CPU.

    JAX_PLATFORMS=cpu python tests/jax_port_training_comparison.py [--steps 500]
        [--seed 0] [--data-seed 0] [--f64-at STEP ...] [--out losses.json]

Both packages start from the same parameters, those of JAX's
`create_train_state(seed=--seed)`, loaded into the port with
`params_from_flax`, and take `--steps` train steps at batch 32 at full width
(`experiments/reproduce_gw.py --cond --cond-mode film --n-context 192
--density 128`: model, CNPF loss, Adam at 1e-3). Every step gets the same
numpy inputs on both sides, drawn from `--data-seed`: the 32 thetas, the
batch's context count U{0..192} and the [32, 256] split scores. Each package
makes its own waveforms from the thetas and its own context mask from the
count and the scores (`exact_topn_mask`, bit-identical in the two), then runs
its own forward, backward and Adam update. Each step the port also takes
that step from the JAX side's state, on JAX's own batch arrays (the two
packages' float32 waveforms differ by up to 0.4% of the peak, the TaylorF2
phase's rounding): a copy of the port model loaded with JAX's parameters
gives its loss and every parameter's gradient, and the port's optimizer,
over a float64 copy of JAX's parameters and given JAX's gradients, moments
and count, gives its update; each is held against JAX's. That separates a
fault in one step's computation (forward, backward, BatchNorm statistics,
Adam) from the two trajectories drifting apart.

It prints every 10 steps the two losses of that step, then one JSON line:
the first step whose two losses differ by more than 1e-3 relative, the
relative difference at steps 1, 10, 50, 100, 250 and 500, on identical
state the largest relative difference of a step's loss and, per step, of the
worst parameter's gradient and Adam update (max |port - JAX| over max |JAX|,
with the step and the parameter where each is largest, and the values at the
first parting step and the steps around it), and each package's median loss
over steps 1-50 and 251-500. What rounding alone does to the gradients is
shown beside them: at steps 1-50 and every 10th step, each package's
gradients against its own on the same state and batch with the batch's
examples in another order (equal in exact arithmetic; a gap between the
packages no larger than these is rounding, not a fault). At the `--f64-at`
steps both packages also compute that step's gradients in float64 (JAX in
64-bit mode, and every float32 cast or dtype argument of both packages read
as float64): each package's float32 gradients against its own float64
ones, the two float64 results against each other, and each package's
float32 error on the step's worst leaf. `--out` writes the per-step curves
as JSON.
"""

import argparse
import contextlib
import copy
import json
import os
import re
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from npf_gwwaveform_tpu.configs import gp_criterion, gp_model_1d  # noqa: E402
from npf_gwwaveform_tpu.data import (  # noqa: E402
    CntxtTrgtSplitter, GetRandomIndcs, GWParameterSpace, GWWaveformGenerator, get_all_indcs,
)
from npf_gwwaveform_tpu.data.datasplit import exact_topn_mask  # noqa: E402
from npf_gwwaveform_tpu.training import Trainer, create_train_state, make_optimizer  # noqa: E402
from npf_gwwaveform_tpu_torch import train_gw  # noqa: E402
from npf_gwwaveform_tpu_torch.configs import STEPS_PER_EPOCH, gw_train_summary  # noqa: E402
from npf_gwwaveform_tpu_torch.data.datasplit import exact_topn_mask as port_topn  # noqa: E402
from npf_gwwaveform_tpu_torch.data.gw import GWParameterSpace as PortSpace  # noqa: E402
from npf_gwwaveform_tpu_torch.score import make_eval_batch, run_generator  # noqa: E402
from npf_gwwaveform_tpu_torch.training import params_from_flax  # noqa: E402
from npf_gwwaveform_tpu_torch.training.optim import make_optimizer as port_optimizer  # noqa: E402

BATCH, N_POINTS, N_CONTEXT = 32, 256, 192
PART_RTOL = 1e-3
ROUNDING_STEPS = 50  # steps with a rounding witness for the gradients (then every 10th)
LR = 1e-3
# each residual block's conv1 biases reach the model's output only through
# linear maps into a train-mode BatchNorm (norm2), which removes them
ZERO_GRAD = re.compile(r"\.conv1\.(depthwise|pointwise)\.bias$")


def draw_inputs(rng, space):
    """One step's numpy inputs: thetas [B, 4], the context count, scores [B, N]."""
    ms = rng.uniform(space.m_min, space.m_max, (BATCH, 2))
    chis = rng.uniform(space.chi_min, space.chi_max, (BATCH, 2))
    theta = np.stack([ms.max(1), ms.min(1), chis[:, 0], chis[:, 1]], -1).astype(np.float32)
    n_ctx = int(rng.integers(0, N_CONTEXT + 1))
    scores = rng.random((BATCH, N_POINTS), dtype=np.float32)
    return theta, n_ctx, scores


def adam_moments(opt_state):
    """optax's ScaleByAdamState (count, mu, nu) inside the optimizer's state."""
    return next(s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda n: hasattr(n, "mu"))
                if hasattr(s, "mu"))


@contextlib.contextmanager
def float64_everywhere():
    """Inside: JAX with 64-bit types, torch's default float64, and every
    float32 pin of both packages (their casts and dtype arguments, which
    mirror each other) read as float64."""
    pins = jnp.float32, torch.float32, torch.Tensor.float, torch.get_default_dtype()
    with jax.enable_x64(True):
        jnp.float32, torch.float32, torch.Tensor.float = jnp.float64, torch.float64, \
            torch.Tensor.double
        torch.set_default_dtype(torch.float64)
        try:
            yield
        finally:
            jnp.float32, torch.float32, torch.Tensor.float = pins[:3]
            torch.set_default_dtype(pins[3])


def worst_gap(port: dict, ref: dict, zero=None):
    """(max over tensors of max |port - ref| / max |ref|, that tensor's name).
    Tensors whose name `zero` matches are 0 in exact arithmetic, so both
    packages' values are rounding noise: they are held against the largest
    entry of every tensor instead."""
    top = max(r.abs().max().item() for r in ref.values())
    gaps = {k: (port[k] - r).abs().max().item()
            / max(top if zero and zero.search(k) else r.abs().max().item(), 1e-30)
            for k, r in ref.items()}
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0, help="create_train_state's seed")
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--f64-at", type=int, nargs="*", default=[], metavar="STEP",
                    help="steps at which both packages' gradients are also computed in float64")
    args = ap.parse_args()
    torch.set_num_threads(4)

    # the JAX side, as tests/jax_reference_training.py builds it
    gen, space = GWWaveformGenerator(duration=1.0, sample_rate=1024.0), GWParameterSpace()
    model = gp_model_1d("ConvCNP", cnn_norm_eps=1e-3).clone(
        y_dim=1, cond_dim=4, cond_mode="film", density_induced=128)
    tx = make_optimizer(lr=LR, decay_lr=10.0, max_epochs=200_000 // STEPS_PER_EPOCH,
                        steps_per_epoch=STEPS_PER_EPOCH)
    splitter = CntxtTrgtSplitter(contexts_getter=GetRandomIndcs(a=0.0, b=N_CONTEXT),
                                 targets_getter=get_all_indcs)
    trainer = Trainer(model, gp_criterion("ConvCNP"), tx, splitter=splitter)
    stride = gen.n_time // N_POINTS
    x_grid = jnp.linspace(-1.0, 1.0, N_POINTS)

    def jax_batch(theta, n_ctx, scores):
        _, h = gen.time_domain(theta)
        h = h[..., -N_POINTS * stride::stride][..., :N_POINTS]
        x = jnp.broadcast_to(x_grid[None, :, None], (BATCH, N_POINTS, 1))
        mask_c = exact_topn_mask(scores, n_ctx, N_CONTEXT, BATCH)
        return dict(X_cntxt=x, Y_cntxt=h[..., None], X_trgt=x, Y_trgt=h[..., None],
                    mask_cntxt=mask_c, mask_trgt=jnp.ones((BATCH, N_POINTS), bool),
                    condition=space.normalize(theta))

    def jax_loss(params, extra_vars, theta, n_ctx, scores):
        batch = jax_batch(theta, n_ctx, scores)
        out, new_vars = trainer._apply(params, extra_vars, batch, jax.random.PRNGKey(0),
                                       train=True)
        return trainer.criterion(out, batch["Y_trgt"], batch["mask_trgt"], train=True), new_vars

    @jax.jit
    def jax_step(params, extra_vars, opt_state, theta, n_ctx, scores):
        (loss, new_vars), grads = jax.value_and_grad(jax_loss, has_aux=True)(
            params, extra_vars, theta, n_ctx, scores)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_vars, opt_state, loss, grads, updates

    jax_grads_of = jax.jit(jax.grad(lambda *a: jax_loss(*a)[0]))
    jax_grads_on = jax.jit(jax.grad(lambda p, e, b: trainer.criterion(
        trainer._apply(p, e, b, jax.random.PRNGKey(0), train=True)[0], b["Y_trgt"],
        b["mask_trgt"], train=True)))
    jax_batch_of = jax.jit(jax_batch)

    rng = np.random.default_rng(args.data_seed)
    theta0, n0, scores0 = draw_inputs(np.random.default_rng(args.data_seed + 10_000), space)
    state = create_train_state(model, tx, jax_batch(jnp.asarray(theta0), n0,
                                                    jnp.asarray(scores0)), seed=args.seed)
    params, extra_vars, opt_state = state.params, state.extra_vars, state.opt_state

    # the port, from the same parameters; the CPU wrappers run the plain versions
    summary = gw_train_summary()
    port = train_gw.build_trainer(summary, args.steps, "cpu", seed=args.seed)
    port.model.load_state_dict(params_from_flax(jax.device_get(params),
                                                jax.device_get(extra_vars)), strict=True)
    pgen, pspace = run_generator(summary), PortSpace()
    mask_t = torch.ones((BATCH, N_POINTS), dtype=torch.bool)

    # the port's step from the JAX side's state: its model, and the port's
    # optimizer over a float64 copy of the parameters, which takes JAX's
    # parameters, gradients, moments and count before each step (in float64
    # the update is new - old without the cancellation of float32 parameters)
    same = copy.deepcopy(port.model)
    same_params = dict(same.named_parameters())
    rounding_gaps, perm_rng = {}, np.random.default_rng(args.data_seed + 20_000)
    precision = {}
    f64 = {k: v.detach().double().clone() for k, v in same_params.items()}
    adam64 = port_optimizer(f64.values(), lr=LR, decay_lr=10.0,
                            max_epochs=200_000 // STEPS_PER_EPOCH,
                            steps_per_epoch=STEPS_PER_EPOCH)
    jax_losses, port_losses, same_losses, grad_gaps, update_gaps = [], [], [], [], []
    wave_gaps = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        theta, n_ctx, scores = draw_inputs(rng, space)
        jax_state = params_from_flax(jax.device_get(params), jax.device_get(extra_vars))
        same.load_state_dict(jax_state)
        moments = adam_moments(opt_state)
        mu, nu = params_from_flax(jax.device_get(moments.mu)), params_from_flax(
            jax.device_get(moments.nu))
        for k, v in f64.items():
            v.copy_(jax_state[k])
            adam64.adam.state[v] = dict(step=torch.tensor(float(moments.count)),
                                        exp_avg=mu[k].double(), exp_avg_sq=nu[k].double())
        params_before, extra_before = params, extra_vars
        params, extra_vars, opt_state, loss, grads, updates = jax_step(
            params, extra_vars, opt_state, jnp.asarray(theta), n_ctx, jnp.asarray(scores))
        jax_losses.append(float(loss))

        x, y, cond = make_eval_batch(torch.from_numpy(theta), pgen, pspace, N_POINTS)
        mask_c = port_topn(torch.from_numpy(scores), torch.tensor(n_ctx), N_CONTEXT, BATCH)
        batch = dict(X_cntxt=x, Y_cntxt=y, X_trgt=x, Y_trgt=y, mask_cntxt=mask_c,
                     mask_trgt=mask_t, condition=cond)
        port_losses.append(port.loss_and_grads(batch).item())
        port.state.optimizer.step()

        # the port's step on JAX's own arrays: the two packages' waveforms
        # differ by float32 rounding, which the first steps' loss (predicted
        # scales near 0) turns into gradient differences of 1e-3
        jb = {k: torch.from_numpy(np.asarray(v)) for k, v in jax.device_get(
            jax_batch_of(jnp.asarray(theta), n_ctx, jnp.asarray(scores))).items()}
        wave_gaps.append(((y - jb["Y_trgt"]).abs().max() / jb["Y_trgt"].abs().max()).item())
        x, y, mask_c, cond = jb["X_cntxt"], jb["Y_trgt"], jb["mask_cntxt"], jb["condition"]
        same.zero_grad(set_to_none=True)
        out = same.train()(x, y, x, mask_cntxt=mask_c, mask_trgt=mask_t, condition=cond)
        same_loss = port.criterion(out, y, mask_t, train=True)
        same_loss.backward()
        same_losses.append(same_loss.item())
        jax_grads = params_from_flax(jax.device_get(grads))
        port_grads = {k: v.grad.clone() for k, v in same_params.items()}
        grad_gaps.append(worst_gap(port_grads, jax_grads, ZERO_GRAD))
        if i < ROUNDING_STEPS or (i + 1) % 10 == 0:
            # what rounding alone makes of these gradients: each package's
            # own on the same batch with its examples in another order (the
            # same loss and gradients in exact arithmetic, summed in another
            # order)
            perm = perm_rng.permutation(BATCH)
            tp = torch.from_numpy(perm)
            same.zero_grad(set_to_none=True)
            out = same.train()(x[tp], y[tp], x[tp], mask_cntxt=mask_c[tp], mask_trgt=mask_t[tp],
                               condition=cond[tp])
            port.criterion(out, y[tp], mask_t[tp], train=True).backward()
            jax_perm = params_from_flax(jax.device_get(jax_grads_of(
                params_before, extra_before, jnp.asarray(theta[perm]), n_ctx,
                jnp.asarray(scores[perm]))))
            rounding_gaps[i + 1] = [
                worst_gap(port_grads, {k: v.grad for k, v in same_params.items()}, ZERO_GRAD)[0],
                worst_gap(jax_perm, jax_grads, ZERO_GRAD)[0]]
        if i + 1 in args.f64_at:
            # each package's float32 gradients against its own in float64 on
            # the same state and the same (float32) batch arrays
            with float64_everywhere():
                jb64 = {k: v.double() if v.is_floating_point() else v for k, v in jb.items()}
                j64 = jax_grads_on(*jax.tree_util.tree_map(
                    lambda a: jnp.asarray(a, jnp.float64), (params_before, extra_before)),
                    {k: jnp.asarray(v.numpy()) for k, v in jb64.items()})
                m64 = copy.deepcopy(same).double()
                out = m64.train()(jb64["X_cntxt"], jb64["Y_trgt"], jb64["X_cntxt"],
                                  mask_cntxt=jb64["mask_cntxt"], mask_trgt=mask_t,
                                  condition=jb64["condition"])
                port.criterion(out, jb64["Y_trgt"], mask_t, train=True).backward()
            j64 = params_from_flax(jax.device_get(j64))  # as float32
            p64 = {k: v.grad.float() for k, v in m64.named_parameters()}
            leaf = grad_gaps[-1][1]
            precision[i + 1] = dict(
                port_vs_own_f64=worst_gap(port_grads, p64, ZERO_GRAD),
                jax_vs_own_f64=worst_gap(jax_grads, j64, ZERO_GRAD),
                f64_port_vs_jax=worst_gap(p64, j64, ZERO_GRAD),
                on_worst_leaf=[leaf, grad_gaps[-1][0]] + [
                    worst_gap({leaf: a[leaf]}, {leaf: b[leaf]})[0]
                    for a, b in ((port_grads, p64), (jax_grads, j64))])
            print(f"step {i + 1}, float64: {precision[i + 1]}", flush=True)
        # the optimizer alone: JAX's gradients in, so that rounding in the
        # gradients (which Adam's first steps turn into sign flips) does not
        # count here
        for k, v in f64.items():
            v.grad = jax_grads[k].double()
        adam64.step()
        update_gaps.append(worst_gap({k: v - jax_state[k].double() for k, v in f64.items()},
                                     params_from_flax(jax.device_get(updates))))
        if (i + 1) % 10 == 0:
            print(f"step {i + 1}: JAX {jax_losses[-1]:.3f}, port {port_losses[-1]:.3f}, port on "
                  f"JAX's state {same_losses[-1]:.3f}, gradient gap {grad_gaps[-1][0]:.2e}, "
                  f"update gap {update_gaps[-1][0]:.2e} ({time.perf_counter() - t0:.0f}s)",
                  flush=True)

    j, p = np.asarray(jax_losses), np.asarray(port_losses)
    rel = np.abs(p - j) / np.maximum(np.abs(j), 1e-30)
    parted = np.nonzero(rel > PART_RTOL)[0]
    same_rel = np.abs(np.asarray(same_losses) - j) / np.maximum(np.abs(j), 1e-30)
    g_gap, u_gap = (np.asarray([v for v, _ in gaps]) for gaps in (grad_gaps, update_gaps))
    first = int(parted[0]) + 1 if parted.size else None
    around = range(max(1, first - 2), min(args.steps, first + 2) + 1) if first else ()
    res = dict(
        seed=args.seed, data_seed=args.data_seed, steps=args.steps,
        first_step_parted=first,
        rel_diff_at={s: float(rel[s - 1]) for s in (1, 10, 50, 100, 250, 500) if s <= args.steps},
        same_params_max_rel_diff=float(same_rel.max()),
        same_params_worst_step=int(same_rel.argmax()) + 1,
        waveform_gap_max=max(wave_gaps),
        same_state_grad_gap_max=float(g_gap.max()),
        same_state_grad_gap_median=float(np.median(g_gap)),
        same_state_grad_gap_worst=[int(g_gap.argmax()) + 1, grad_gaps[g_gap.argmax()][1]],
        same_state_update_gap_max=float(u_gap.max()),
        same_state_update_gap_median=float(np.median(u_gap)),
        same_state_update_gap_worst=[int(u_gap.argmax()) + 1, update_gaps[u_gap.argmax()][1]],
        same_state_gaps_around_parting={s: [float(g_gap[s - 1]), float(u_gap[s - 1])]
                                        for s in around},
        # [port, JAX]
        rounding_grad_gap_max=np.max(list(rounding_gaps.values()), 0).tolist(),
        rounding_grad_gap_median=np.median(list(rounding_gaps.values()), 0).tolist(),
        same_state_grad_gap_over_rounding_max=max(
            float(g_gap[s - 1]) / max(max(r), 1e-30) for s, r in rounding_gaps.items()),
        rounding_grad_gaps_around_parting={s: rounding_gaps[s] for s in around
                                           if s in rounding_gaps},
        float64=precision,
        jax_median_1_50=float(np.median(j[:50])), port_median_1_50=float(np.median(p[:50])),
        jax_median_251_500=float(np.median(j[250:500])),
        port_median_251_500=float(np.median(p[250:500])),
    )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(res, jax_losses=jax_losses, port_losses=port_losses,
                           same_params_losses=same_losses, same_state_grad_gaps=grad_gaps,
                           same_state_update_gaps=update_gaps,
                           rounding_grad_gaps=rounding_gaps), f)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
