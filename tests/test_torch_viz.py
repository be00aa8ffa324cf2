"""`npf_gwwaveform_tpu_torch.viz` against `npf_gwwaveform_tpu.viz` on the same
inputs and parameters, at a small width (r_dim 16): `gen_p_y_pred` for a
CNP (observation-noise draws) and an LNP (z draws), and
`get_posterior_samples_imgs` for a GridConvCNP and a GridConvLNP, each
with JAX's own noise (the z noise recovered from JAX's forward as (z -
loc) / scale in float64, the observation noise JAX's normals); the arrays
the figures plot (`ax.lines[i].get_ydata()`: the posterior means and the
exact GP's, the mixture marginals of the Sarle-ranked pixels);
`points_to_grid`, `sarle` and the mixture marginal; `fig2img` and
`giffify`. Tolerances: the predictive bar 5e-4 absolute on locs, scales,
samples and plotted curves; the marginal densities (up to ~1e2 at a
pixel's narrow mode) 5e-4 of their largest value; `sarle` 1e-9 relative
(float64 moments against scipy's); the mixture marginal against JAX's
numpy lines 1e-6 relative (both take the float32 log of the scales, which
numpy and torch round up to an ulp apart, 6e-8 of it); the grids and
images bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu import viz as jviz
from npf_gwwaveform_tpu.configs import gp_model_1d as jax_gp_model_1d
from npf_gwwaveform_tpu.data.gp import GPSampler as JaxGPSampler
from npf_gwwaveform_tpu.models import GridConvCNP as JaxGridConvCNP
from npf_gwwaveform_tpu.models import GridConvLNP as JaxGridConvLNP
from npf_gwwaveform_tpu.ops.cnn import CNN as JaxCNN
from npf_gwwaveform_tpu_torch import viz
from npf_gwwaveform_tpu_torch.configs import gp_model_1d
from npf_gwwaveform_tpu_torch.data.gp import GPSampler
from npf_gwwaveform_tpu_torch.models import GridConvCNP, GridConvLNP
from npf_gwwaveform_tpu_torch.training.checkpoint import params_from_flax

torch.set_num_threads(1)

R, B, N = 16, 3, 24
ATOL = 5e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _batch_1d(seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-1, 1, (B, N, 1)), axis=1).astype(np.float32)
    y = (np.sin(3 * x) + 0.1 * rng.standard_normal((B, N, 1))).astype(np.float32)
    mask_c = rng.random((B, N)) < 0.4
    mask_c[1, :3] = True
    return dict(X_cntxt=x, Y_cntxt=y, X_trgt=x, mask_cntxt=mask_c,
                mask_trgt=np.ones((B, N), bool))


def _pair_1d(name):
    jm, tm = jax_gp_model_1d(name, r_dim=R), gp_model_1d(name, r_dim=R)
    b = _batch_1d()
    v = jm.init({"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)},
                b["X_cntxt"], b["Y_cntxt"], b["X_trgt"], b["Y_cntxt"], mask_cntxt=b["mask_cntxt"],
                mask_trgt=b["mask_trgt"], train=True)
    tm.load_state_dict(params_from_flax(_np(v["params"])), strict=True)
    return jm, tm, {"params": v["params"]}


def _eps(out):
    q = out.q_zCc if out.q_zCct is None else out.q_zCct
    z, loc, scale = (np.asarray(a, np.float64) for a in (out.z_samples, q.loc, q.scale))
    return torch.from_numpy((z - loc) / scale).float()


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jax_noise(jm, v, batch, n, key):
    """What JAX's `gen_p_y_pred` draws from `key`: (the z noise or None, the
    observation noise)."""
    k_lat, k_obs = jax.random.split(key)
    if not jm.has_latent:
        return None, np.asarray(jax.random.normal(k_obs, (n, B, N, 1)))
    out = jm.clone(n_z_samples_test=n).apply(
        v, batch["X_cntxt"], batch["Y_cntxt"], batch["X_trgt"], mask_cntxt=batch["mask_cntxt"],
        mask_trgt=batch["mask_trgt"], train=False, rngs={"latent": k_lat})
    return _eps(out), np.asarray(jax.random.normal(k_obs, out.p_yCc.loc.shape))


@pytest.mark.parametrize("name,n", [("CNP", 1), ("CNP", 4), ("LNP", 5)])
def test_gen_p_y_pred_matches_jax(name, n):
    jm, tm, v = _pair_1d(name)
    batch = _batch_1d()
    key = jax.random.PRNGKey(3)
    j_loc, j_scale, j_samples = jviz.gen_p_y_pred(jm, v, batch, n, key)
    eps, obs = _jax_noise(jm, v, batch, n, key)
    loc, scale, samples = viz.gen_p_y_pred(tm, _torch(batch), n, eps=eps,
                                           obs_eps=torch.from_numpy(obs))
    assert loc.shape == j_loc.shape and samples.shape == j_samples.shape
    for got, ref in ((loc, j_loc), (scale, j_scale), (samples, j_samples)):
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    if name == "LNP":
        assert tm.n_z_samples_test == 32  # restored


def test_gen_p_y_pred_draws_from_its_generator():
    _, tm, _ = _pair_1d("LNP")
    batch = _torch(_batch_1d())
    runs = [viz.gen_p_y_pred(tm, batch, 3, torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not torch.equal(runs[0][2], runs[2][2])


def test_posterior_plot_lines_match_jax():
    import matplotlib.pyplot as plt

    jm, tm, v = _pair_1d("CNP")
    batch = _batch_1d()
    sampler_j, sampler = JaxGPSampler(kernel="rbf"), GPSampler(kernel="rbf")
    fig, (a0, a1) = plt.subplots(1, 2)
    jviz.plot_posterior_samples_1d(batch, jm, v, gp_sampler=sampler_j, n_samples=1, ax=a0)
    viz.plot_posterior_samples_1d(_torch(batch), tm, gp_sampler=sampler, n_samples=1, ax=a1)
    assert len(a0.lines) == len(a1.lines) == 2  # the model's mean and the exact GP's
    for lj, lt in zip(a0.lines, a1.lines):
        np.testing.assert_array_equal(lt.get_xdata(), lj.get_xdata())
        np.testing.assert_allclose(lt.get_ydata(), lj.get_ydata(), atol=ATOL, rtol=0)
    assert len(a0.collections) == len(a1.collections)
    plt.close(fig)


def _jax_cnn(r_dim, name=None):
    return JaxCNN(n_channels=r_dim, n_blocks=2, kernel_size=3, norm="batch", padding="SAME",
                  block_kwargs={"n_conv_layers": 2, "norm_eps": 1e-3}, name=name)


def _pair_img(latent):
    jkw = dict(y_dim=1, x_dim=1, r_dim=R, CNNFactory=_jax_cnn, conv_kernel_size=5)
    tkw = dict(y_dim=1, r_dim=R, cnn_n_blocks=2, cnn_kernel_size=3, conv_kernel_size=5)
    lat = dict(is_global=True, n_z_samples_train=2, n_z_samples_test=3)
    jm, tm = ((JaxGridConvLNP(**jkw, **lat), GridConvLNP(**tkw, **lat)) if latent
              else (JaxGridConvCNP(**jkw), GridConvCNP(**tkw)))
    y, mask = _img_inputs()
    v = jm.init({"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)},
                mask.astype(np.float32), y, np.ones_like(mask, np.float32), train=False)
    v = {"params": _np(v["params"]), "batch_stats": _np(v["batch_stats"])}
    tm.load_state_dict(params_from_flax(v["params"], {"batch_stats": v["batch_stats"]}),
                       strict=True)
    return jm, tm, v


def _img_inputs(seed=0):
    rng = np.random.default_rng(seed)
    y = rng.uniform(0, 1, (2, 8, 8, 1)).astype(np.float32)
    return y, rng.random((2, 8, 8, 1)) < 0.3


def _jax_img_eps(jm, v, mask, y, n, key):
    if not jm.has_latent:
        return None
    out = jm.clone(n_z_samples_test=n).apply(v, mask.astype(np.float32), y,
                                             np.ones_like(mask, np.float32), train=False,
                                             rngs={"latent": key})
    return _eps(out)


@pytest.mark.parametrize("latent", [False, True], ids=["GridConvCNP", "GridConvLNP"])
def test_posterior_samples_imgs_match_jax(latent):
    jm, tm, v = _pair_img(latent)
    y, mask = _img_inputs()
    key = jax.random.PRNGKey(5)
    j_loc, j_scale = jviz.visualize_imgs.get_posterior_samples_imgs(jm, v, jnp.asarray(mask), y,
                                                                    3, key)
    eps = _jax_img_eps(jm, v, mask, y, 3, key)
    loc, scale = viz.get_posterior_samples_imgs(tm, torch.from_numpy(mask), torch.from_numpy(y),
                                                3, eps=eps)
    assert loc.shape == j_loc.shape == (3 if latent else 1, 2, 8, 8, 1)
    np.testing.assert_allclose(loc.numpy(), j_loc, atol=ATOL, rtol=0)
    np.testing.assert_allclose(scale.numpy(), j_scale, atol=ATOL, rtol=0)


def test_marginal_plot_lines_match_jax():
    import matplotlib.pyplot as plt

    jm, tm, v = _pair_img(True)
    y, mask = _img_inputs()
    key = jax.random.PRNGKey(6)
    fj = jviz.plot_img_marginal_pred(jm, v, jnp.asarray(mask), y, n_samples=8, key=key)
    eps = _jax_img_eps(jm, v, mask, y, 8, key)
    ft = viz.plot_img_marginal_pred(tm, torch.from_numpy(mask), torch.from_numpy(y), n_samples=8,
                                    eps=eps)
    lj, lt = fj.axes[0].lines, ft.axes[0].lines
    assert len(lj) == len(lt) == 5
    peak = max(np.abs(line.get_ydata()).max() for line in lj)
    for a, b in zip(lj, lt):
        np.testing.assert_allclose(b.get_ydata(), a.get_ydata(), atol=ATOL * peak, rtol=0)
    plt.close(fj)
    plt.close(ft)


def test_points_to_grid_sarle_and_marginal():
    from scipy.special import logsumexp

    rng = np.random.default_rng(2)
    grid = (6, 5)
    idx = np.stack([rng.integers(0, s, (3, 20)) for s in grid], -1)
    x = (idx / (np.array(grid) - 1) * 2 - 1 + rng.uniform(-0.04, 0.04, idx.shape))
    x, y = x.astype(np.float32), rng.normal(size=(3, 20, 2)).astype(np.float32)
    np.testing.assert_array_equal(viz.points_to_grid(torch.from_numpy(x), torch.from_numpy(y),
                                                     grid).numpy(),
                                  jviz.points_to_grid(x, y, grid))
    out = rng.gamma(2.0, 1.0, (50, 7))
    np.testing.assert_allclose(viz.sarle(torch.from_numpy(out)).numpy(),
                               jviz.visualize_imgs.sarle(out), rtol=1e-9)
    locs = rng.uniform(0, 1, (4, 1, 3, 3, 1)).astype(np.float32)
    scales = rng.uniform(0.01, 0.3, (4, 1, 3, 3, 1)).astype(np.float32)
    arange, dens = viz.marginal_pred(torch.from_numpy(locs), torch.from_numpy(scales))
    # the JAX function's own lines (plot_img_marginal_pred), on numpy
    mu, sd = locs[:, 0, ..., 0].reshape(4, -1), np.maximum(scales[:, 0, ..., 0].reshape(4, -1),
                                                            1e-6)
    a = np.linspace(0.0, 1.0, 1000)
    log_p = (-0.5 * ((a[:, None, None] - mu[None]) / sd[None]) ** 2 - np.log(sd[None])
             - 0.5 * np.log(2 * np.pi))
    ref = np.exp(logsumexp(log_p, axis=1) - np.log(4))
    np.testing.assert_array_equal(arange.numpy(), a)
    np.testing.assert_allclose(dens.numpy(), ref, rtol=1e-6, atol=0)


def test_fig2img_and_giffify(tmp_path):
    import imageio
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(2, 2))
    ax.plot([0, 1], [1, 0])
    img = viz.fig2img(fig)
    np.testing.assert_array_equal(img, jviz.fig2img(fig))
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[-1] == 3
    plt.close(fig)

    def one(width):
        f, a = plt.subplots(figsize=(width, 2))
        a.plot([0, 1], [0, width])
        return f

    paths = [str(tmp_path / f"{k}.gif") for k in ("jax", "port")]
    jviz.giffify(paths[0], one, "width", [2, 2.5, 3])
    viz.giffify(paths[1], one, "width", [2, 2.5, 3])
    frames = [imageio.mimread(p) for p in paths]
    assert len(frames[0]) == len(frames[1]) == 3
    assert all(np.array_equal(a, b) for a, b in zip(*frames))
    with viz.plot_config():
        plt.close(one(2))
    assert os.path.getsize(paths[1]) > 0
