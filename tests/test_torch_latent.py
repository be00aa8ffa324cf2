"""The latent ConvNP family of the port against the JAX package on the CPU:
the reparameterised draw and the diagonal-Gaussian KL, the latent losses
(NPML with and without importance weights, the ELBO, SUMO with its count
law) and `logcumsumexp` on identical arrays, the z-sample helpers, and a
small ConvLNP (r_dim 16, two blocks of k = 5, a 24-point grid) in each of
its cases: the latent and the "both" path, a global latent or not, the
sigmoid and the softplus q(z) scale, q(z|C,T), and FiLM conditioning. Each
case checks p(y|C), q(z|C) and q(z|C,T) in eval and train mode, the train
and eval losses, and the gradients of one train step; the ELBO step also
its BatchNorm running statistics after the two encodings.

The latent noise is an input: Philox cannot reproduce JAX's threefry, so
each test recovers JAX's own noise from the NPFOutput it returns, as (z -
loc) / scale of the distribution it sampled, in float64, and hands it to
the port (`eps=`). Parameters come from a flax `init`, perturbed so that
biases and BatchNorm statistics are off their init values, and are
carried over with `params_from_flax`; inputs are made with numpy from a
seed. The port runs its kernels' plain versions (CPU tensors).

Tolerances (float32 on both sides, the summation orders differ):
- op level (draws, KL, losses on identical arrays, logcumsumexp, the
  helpers): 1e-5 relative, 1e-5 absolute;
- the model's predictive and latent distributions (loc and scale): 5e-4
  absolute (measured: at most 9.3e-5, on a loc of magnitude 12);
- the train and eval losses of the model: 1e-5 relative;
- each gradient of one step: 1e-3 of its leaf's largest magnitude,
  `tests/test_torch_train.py`'s full-width bar (the same float32 sums in
  other orders through two CNNs with train-mode BatchNorm; a SetConv's
  length-scale gradient is one sum over every draw, key, query and
  channel whose terms cancel: measured at most 1.8e-4 there); the
  BatchNorm-cancelled conv1 biases (zero in exact arithmetic) are held
  below 1e-3 of their block's conv1.pointwise weight gradient on both
  sides;
- BatchNorm running statistics: 1e-5;
- masks: bit-identical (the split is not drawn here: both sides take the
  same boolean arrays).
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu import losses as jax_losses
from npf_gwwaveform_tpu.configs import _cnn_factory
from npf_gwwaveform_tpu.distributions import NormalDiag as JaxNormalDiag
from npf_gwwaveform_tpu.distributions import kl_normal_diag as jax_kl
from npf_gwwaveform_tpu.models.convnp import ConvLNP as JaxConvLNP
from npf_gwwaveform_tpu.utils import helpers as jax_helpers
from npf_gwwaveform_tpu_torch import losses
from npf_gwwaveform_tpu_torch.distributions import NormalDiag, kl_normal_diag
from npf_gwwaveform_tpu_torch.models.convnp import ConvLNP
from npf_gwwaveform_tpu_torch.training.checkpoint import params_from_flax
from npf_gwwaveform_tpu_torch.utils import helpers

torch.set_num_threads(1)

OP_TOL = 1e-5
DIST_ATOL = 5e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3
STAT_ATOL = 1e-5

B, NC, NT, R, DENSITY = 3, 12, 20, 16, 8


def _np(t):
    return np.asarray(t, dtype=np.float64)


def _dist(rng, shape, scale_lo=0.2):
    loc = rng.normal(size=shape).astype(np.float32)
    scale = (scale_lo + rng.uniform(size=shape)).astype(np.float32)
    return loc, scale


def _both(loc, scale):
    return (JaxNormalDiag(jnp.asarray(loc), jnp.asarray(scale)),
            NormalDiag(torch.from_numpy(loc), torch.from_numpy(scale)))


# ---------------------------------------------------------------- op level


def test_sample_is_loc_plus_scale_eps_and_kl_matches_jax():
    rng = np.random.default_rng(0)
    jq, tq = _both(*_dist(rng, (3, 5, 4)))
    jp, tp = _both(*_dist(rng, (3, 5, 4)))
    z = jq.sample(jax.random.PRNGKey(1), (7,))
    eps = (_np(z) - _np(jq.loc)) / _np(jq.scale)
    zt = tq.sample(None, (7,), eps=torch.from_numpy(eps).float())
    np.testing.assert_allclose(zt.numpy(), np.asarray(z), rtol=OP_TOL, atol=OP_TOL)
    # drawn from a generator: standard-normal noise of the sample shape, float32
    g = torch.Generator().manual_seed(0)
    zg = tq.sample(g, (4000,))
    assert zg.shape == (4000, 3, 5, 4) and zg.dtype == torch.float32
    e = ((zg - tq.loc) / tq.scale).double()
    assert abs(e.mean().item()) < 0.01 and abs(e.std().item() - 1) < 0.01
    assert tq.rsample(torch.Generator().manual_seed(0), (4000,)).equal(zg)
    with pytest.raises(ValueError):
        tq.sample(None, (2,), eps=torch.zeros(3, 3, 5, 4))
    np.testing.assert_allclose(kl_normal_diag(tq, tp).numpy(), np.asarray(jax_kl(jq, jp)),
                               rtol=OP_TOL, atol=OP_TOL)
    assert torch.count_nonzero(kl_normal_diag(tq, tq)) == 0


def test_z_sample_helpers_match_jax():
    rng = np.random.default_rng(1)
    t = rng.normal(size=(4, 3, 6, 5)).astype(np.float32)
    tt = torch.from_numpy(t)
    collapsed = helpers.collapse_z_samples_batch(tt)
    np.testing.assert_array_equal(collapsed.numpy(),
                                  np.asarray(jax_helpers.collapse_z_samples_batch(t)))
    assert helpers.extract_z_samples_batch(collapsed, 4).equal(tt)
    np.testing.assert_array_equal(helpers.replicate_z_samples(tt[0], 4).numpy(),
                                  np.asarray(jax_helpers.replicate_z_samples(t[0], 4)))
    np.testing.assert_allclose(helpers.pool_and_replicate_middle(tt).numpy(),
                               np.asarray(jax_helpers.pool_and_replicate_middle(t)),
                               rtol=OP_TOL, atol=OP_TOL)
    x = (rng.normal(size=(9, 4)) * 30).astype(np.float32)
    for dim in (0, 1):
        np.testing.assert_allclose(helpers.logcumsumexp(torch.from_numpy(x), dim).numpy(),
                                   np.asarray(jax_helpers.logcumsumexp(x, dim)),
                                   rtol=OP_TOL, atol=OP_TOL)


def _outputs(rng, n_z, with_qct):
    """A latent NPFOutput on identical arrays in both packages, the draws
    z from the sampled distribution, and targets with a padded point."""
    p = _dist(rng, (n_z, 2, 6, 1), 0.3)
    qc = _dist(rng, (2, 4, 3))
    qct = _dist(rng, (2, 4, 3)) if with_qct else None
    z = rng.normal(size=(n_z, 2, 4, 3)).astype(np.float32)
    y = rng.normal(size=(2, 6, 1)).astype(np.float32)
    mask = np.ones((2, 6), bool)
    mask[1, -2:] = False

    def make(dist_cls, arr):
        d = lambda pair: None if pair is None else dist_cls(*(arr(a) for a in pair))  # noqa: E731
        return d(p), arr(z), d(qc), d(qct)

    jout = jax_losses.NPFOutput(*make(JaxNormalDiag, jnp.asarray))
    tout = losses.NPFOutput(*make(NormalDiag, torch.from_numpy))
    return (jout, jnp.asarray(y), jnp.asarray(mask)), (tout, torch.from_numpy(y),
                                                        torch.from_numpy(mask))


@pytest.mark.parametrize("with_qct", [False, True])
def test_latent_losses_match_jax(with_qct):
    """NPML (importance-weighted when q(z|C,T) is given, and not), the ELBO,
    SUMO, and each loss object's train and forced-NPML eval loss."""
    rng = np.random.default_rng(2 + with_qct)
    (jo, jy, jm), (to, ty, tm) = _outputs(rng, 8, with_qct)
    pairs = [
        (jax_losses.npml_loss(jo, jy, jm), losses.npml_loss(to, ty, tm)),
        (jax_losses.npml_loss(jo, jy, jm, use_iw=False),
         losses.npml_loss(to, ty, tm, use_iw=False)),
        (jax_losses.sumo_loss(jo, jy, jm), losses.sumo_loss(to, ty, tm)),
        (jax_losses.sumo_loss(jo, jy, jm, m=2, alpha=5), losses.sumo_loss(to, ty, tm, 2, 5)),
    ]
    objects = [(jax_losses.NLLLossLNPF, losses.NLLLossLNPF),
               (jax_losses.SUMOLossLNPF, losses.SUMOLossLNPF)]
    if with_qct:
        pairs.append((jax_losses.elbo_loss(jo, jy, jm), losses.elbo_loss(to, ty, tm)))
        objects.append((jax_losses.ELBOLossLNPF, losses.ELBOLossLNPF))
    else:
        with pytest.raises(ValueError):
            losses.elbo_loss(to, ty, tm)
    for jc, tc in objects:
        for train in (True, False):
            for red in (None, "mean", "sum"):
                pairs.append((jc(reduction=red)(jo, jy, jm, train=train),
                              tc(reduction=red)(to, ty, tm, train=train)))
    for j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=OP_TOL, atol=OP_TOL)
    np.testing.assert_array_equal(losses.light_tail_pareto_inv_weights(200),
                                  jax_losses.light_tail_pareto_inv_weights(200))
    with pytest.raises(ValueError):
        losses.sumo_loss(to, ty, tm, m=8)


# ------------------------------------------------------------ the model

# name -> ConvLNP options shared by both packages
CASES = {
    "latent global sigmoid": dict(is_global=True),
    "latent local": dict(is_global=False),
    "softplus scale": dict(is_global=True, lat_scale_transform="softplus", min_lat_sigma=1e-4),
    "q(z|C,T)": dict(is_global=True, is_q_zCct=True, n_z_samples_train=1),
    "both": dict(encoded_path="both"),
    "film": dict(is_global=True, cond_dim=4, cond_mode="film"),
    "z_dim != r_dim": dict(is_global=True, z_dim=6),
}
N_Z_TRAIN, N_Z_TEST = 3, 5


def _models(case):
    opts = dict(CASES[case])
    opts.setdefault("n_z_samples_train", N_Z_TRAIN)
    jm = JaxConvLNP(y_dim=1, x_dim=1, r_dim=R, density_induced=DENSITY,
                    CNNFactory=_cnn_factory(2, kernel_size=5), n_z_samples_test=N_Z_TEST, **opts)
    tm = ConvLNP(x_dim=1, y_dim=1, r_dim=R, density_induced=DENSITY, cnn_n_blocks=2,
                 cnn_kernel_size=5, cnn_norm="batch", cnn_n_conv_layers=2, cnn_norm_eps=1e-3,
                 n_z_samples_test=N_Z_TEST, **opts)
    return jm, tm


def _inputs(rng, cond_dim):
    x_c = np.sort(rng.uniform(-1, 1, size=(B, NC, 1)), axis=1).astype(np.float32)
    y_c = np.sin(4 * x_c).astype(np.float32) + 0.1 * rng.normal(size=x_c.shape).astype(np.float32)
    x_t = np.sort(rng.uniform(-1, 1, size=(B, NT, 1)), axis=1).astype(np.float32)
    y_t = np.sin(4 * x_t).astype(np.float32)
    mask_c = np.ones((B, NC), bool)
    mask_c[1, 7:] = False
    mask_c[2, :] = False  # an empty context
    mask_t = np.ones((B, NT), bool)
    mask_t[0, -3:] = False
    cond = rng.normal(size=(B, cond_dim)).astype(np.float32) if cond_dim else None
    return x_c, y_c, x_t, y_t, mask_c, mask_t, cond


def _perturbed(variables, rng, scale=0.1):
    """Random offsets on every leaf; BatchNorm variances kept at 0.5 or more,
    so that the outputs stay of order 1 to 10."""
    tree = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(variables))
    out = jax.tree_util.tree_map(
        lambda a: a + scale * rng.normal(size=a.shape).astype(np.float32), tree)
    out["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a, out["batch_stats"])
    for path, leaf in _leaves(out["batch_stats"]):
        if path[-1] == "var":
            leaf[...] = 0.5 + np.abs(leaf)
    return out


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _setup(case, seed=0):
    rng = np.random.default_rng(seed)
    jm, tm = _models(case)
    inp = _inputs(rng, jm.cond_dim)
    x_c, y_c, x_t, y_t, mask_c, mask_t, cond = inp
    kw = {"condition": jnp.asarray(cond)} if cond is not None else {}
    variables = jm.init({"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)},
                        x_c, y_c, x_t, y_t, mask_c, mask_t, train=False, **kw)
    variables = _perturbed(variables, rng)
    extra = {k: v for k, v in variables.items() if k != "params"}
    tm.load_state_dict(params_from_flax(variables["params"], extra), strict=True)
    return jm, tm, variables, inp


def _jax_apply(jm, variables, inp, train, key=2):
    x_c, y_c, x_t, y_t, mask_c, mask_t, cond = inp
    kw = {"condition": jnp.asarray(cond)} if cond is not None else {}
    return jm.apply(variables, x_c, y_c, x_t, y_t, mask_c, mask_t, train=train,
                    rngs={"latent": jax.random.PRNGKey(key)},
                    mutable=["batch_stats"] if train else False, **kw)


def _eps(out):
    """JAX's standard-normal noise behind its draws, in float64."""
    q = out.q_zCc if out.q_zCct is None else out.q_zCct
    return torch.from_numpy((_np(out.z_samples) - _np(q.loc)) / _np(q.scale))


def _port_apply(tm, inp, eps):
    x_c, y_c, x_t, y_t, mask_c, mask_t, cond = (None if a is None else torch.from_numpy(a)
                                                 for a in inp)
    return tm(x_c, y_c, x_t, mask_c, mask_t, cond, y_trgt=y_t, eps=eps.float())


def _check_dists(t_out, j_out):
    for name in ("p_yCc", "q_zCc", "q_zCct"):
        jd, td = getattr(j_out, name), getattr(t_out, name)
        assert (jd is None) == (td is None), name
        if jd is None:
            continue
        for field in ("loc", "scale"):
            np.testing.assert_allclose(getattr(td, field).detach().numpy(),
                                       np.asarray(getattr(jd, field)), atol=DIST_ATOL, rtol=0,
                                       err_msg=f"{name}.{field}")
    np.testing.assert_allclose(t_out.z_samples.detach().numpy(), np.asarray(j_out.z_samples),
                               atol=DIST_ATOL, rtol=0)


def _criteria(jm):
    """The (JAX, port) loss classes of the model's objective."""
    if jm.is_q_zCct:
        return jax_losses.ELBOLossLNPF, losses.ELBOLossLNPF
    return jax_losses.NLLLossLNPF, losses.NLLLossLNPF


@pytest.mark.parametrize("case", list(CASES))
def test_convlnp_eval_matches_jax(case):
    """Eval mode: n_z_samples_test draws, the distributions and the eval
    loss (NPML without importance weights) on JAX's noise."""
    jm, tm, variables, inp = _setup(case)
    j_out = _jax_apply(jm, variables, inp, train=False)
    assert j_out.z_samples.shape[0] == N_Z_TEST
    with torch.no_grad():
        t_out = _port_apply(tm.eval(), inp, _eps(j_out))
    assert t_out.p_yCc.loc.shape == (N_Z_TEST, B, NT, 1)
    _check_dists(t_out, j_out)
    jc, tc = _criteria(jm)
    y_t, mask_t = inp[3], inp[5]
    j_loss = jc(reduction=None)(j_out, jnp.asarray(y_t), jnp.asarray(mask_t), train=False)
    t_loss = tc(reduction=None)(t_out, torch.from_numpy(y_t), torch.from_numpy(mask_t),
                                train=False)
    np.testing.assert_allclose(t_loss.numpy(), np.asarray(j_loss), rtol=LOSS_RTOL)


def _bn_cancelled(name):
    return ".conv1." in name and name.endswith(".bias")


@pytest.mark.parametrize("case", list(CASES))
def test_convlnp_train_step_matches_jax(case):
    """Train mode: n_z_samples_train draws (BatchNorm over n_z * B * grid
    points in the post-sampling CNN), the distributions, the train loss, the
    gradients of every parameter and the running statistics after the step."""
    jm, tm, variables, inp = _setup(case, seed=1)
    y_t, mask_t = jnp.asarray(inp[3]), jnp.asarray(inp[5])
    jc, tc = _criteria(jm)
    j_out, _ = _jax_apply(jm, variables, inp, train=True)
    eps = _eps(j_out)

    def loss_fn(params):
        out, upd = _jax_apply(jm, {**variables, "params": params}, inp, train=True)
        return jc()(out, y_t, mask_t, train=True), upd

    (j_loss, upd), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    t_out = _port_apply(tm.train(), inp, eps)
    _check_dists(t_out, j_out)
    t_loss = tc()(t_out, torch.from_numpy(inp[3]), torch.from_numpy(inp[5]), train=True)
    t_loss.backward()
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=LOSS_RTOL)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(j_grads)))
    grads = dict(tm.named_parameters())
    assert set(ref) == set(grads)
    for name, g in ref.items():
        port = grads[name].grad
        if _bn_cancelled(name):
            w = ref[name.rsplit(".", 2)[0] + ".pointwise.weight"].abs().max()
            assert max(port.abs().max(), g.abs().max()) <= GRAD_RTOL * w, name
            continue
        err = (port - g).abs().max() / g.abs().max().clamp_min(1e-30)
        assert err <= GRAD_RTOL, (name, float(err))
    stats = params_from_flax({}, {"batch_stats": jax.tree_util.tree_map(
        np.asarray, flax.core.unfreeze(upd["batch_stats"]))})
    for name, ref_buf in stats.items():
        np.testing.assert_allclose(tm.get_buffer(name).numpy(), ref_buf.numpy(), atol=STAT_ATOL,
                                   rtol=0, err_msg=name)


def test_elbo_step_moves_batchnorm_twice_in_jax_order():
    """With q(z|C,T) the grid CNN runs on the context and then on the
    targets in one train forward: its running statistics move twice, in
    that order, as JAX moves them (held in the train-step test); the
    post-sampling CNN's once. One move alone (the context's) would differ."""
    jm, tm, variables, inp = _setup("q(z|C,T)", seed=3)
    j_out, upd = _jax_apply(jm, variables, inp, train=True)
    t_out = _port_apply(tm.train(), inp, _eps(j_out))
    ref = params_from_flax({}, {"batch_stats": jax.tree_util.tree_map(
        np.asarray, flax.core.unfreeze(upd["batch_stats"]))})
    name = "induced_to_induced.block_0.norm1.mean"
    np.testing.assert_allclose(tm.get_buffer(name).numpy(), ref[name].numpy(), atol=STAT_ATOL)
    # the same forward without the targets encodes the context alone
    _, tm_once, _, _ = _setup("q(z|C,T)", seed=3)
    x_c, y_c, x_t, _, mask_c, mask_t, cond = (None if a is None else torch.from_numpy(a)
                                              for a in inp)
    eps_c = torch.zeros((1, B, tm_once.n_induced, R))
    tm_once.train()(x_c, y_c, x_t, mask_c, mask_t, cond, eps=eps_c)
    moved_once = tm_once.get_buffer(name).numpy()
    assert np.abs(moved_once - ref[name].numpy()).max() > 100 * STAT_ATOL
    for post in ("induced_to_induced_post_sampling.block_1.norm2.var",):
        np.testing.assert_allclose(tm.get_buffer(post).numpy(), ref[post].numpy(),
                                   atol=STAT_ATOL)


def test_draws_come_from_the_generator():
    """Without `eps` a latent model draws from the generator it is given:
    the same seed gives the same draws, and eval mode takes
    n_z_samples_test of them."""
    _, tm, _, inp = _setup("latent global sigmoid")
    x_c, y_c, x_t, _, mask_c, mask_t = (torch.from_numpy(a) for a in inp[:6])
    outs = []
    with torch.no_grad():
        for seed in (0, 0, 1):
            g = torch.Generator().manual_seed(seed)
            outs.append(tm.eval()(x_c, y_c, x_t, mask_c, mask_t, generator=g).z_samples)
    assert outs[0].shape == (N_Z_TEST, B, tm.n_induced, R)
    assert outs[0].equal(outs[1]) and not outs[0].equal(outs[2])


def test_loss_objects_are_frozen_dataclasses():
    """The loss objects take `reduction` and `is_force_mle_eval` as JAX's."""
    for cls in (losses.NLLLossLNPF, losses.ELBOLossLNPF, losses.SUMOLossLNPF, losses.CNPFLoss):
        obj = cls(reduction=None)
        assert obj.is_force_mle_eval and dataclasses.is_dataclass(obj)
        with pytest.raises(dataclasses.FrozenInstanceError):
            obj.reduction = "mean"
