"""The GP data path and the GP harness of the port against the JAX package:
the covariances, the integer-order `ive` (against scipy's), the periodic
sampler's coefficients, `GPSampler` and `MixtureGPSampler` on JAX's own
noise against JAX's `sample` for all five kernels, the moments of the port's
own draws, the 1-D splitters, `rescale_range`, the other two radial basis
functions and SetConv's choice of them, and the datasets
(`tests/test_torch_gp_harness.py` holds the harness).

JAX's noise is rebuilt from its keys as `_sample_one` draws it: the x
uniforms (in the kernel's units, unsorted), the length scale, eps, and the
periodic sampler's xi and eta; the port's `sample_from_noise` takes them.

Tolerances:
- covariances 1e-6 absolute (values <= 1.1; XLA's and PyTorch's exp and
  sin round a few elements one ulp apart);
- `ive` 1e-12 relative to scipy's (both float64; measured 3e-14);
- the periodic coefficients bit for bit (the same float64 values rounded
  to float32), and the periodic draws 1e-5 of each function's largest
  magnitude (a float32 sum of 32 harmonics in another order);
- the Cholesky kernels: x bit for bit; which factorisation each function
  takes (1e-5 jitter, or 100 times it) the same on both sides; y within a
  share of each function's largest magnitude: RBF 3e-2, Matern and
  Variable Matern 5e-3, Noisy Matern 1e-5. XLA's and PyTorch's LAPACK
  factor a float32 matrix of condition 1e5-1e7 (the jitter on a nearly
  singular kernel) to different factors: each side's y lies 0.5-1.3% (RBF)
  and 0.04-0.1% (Matern) from the float64 factor's (measured); the noisy
  kernel's white noise makes its matrix well conditioned;
- moments of 4,096 of the port's own draws at fixed x: each covariance
  entry within 6 standard errors of the kernel's;
- the radial basis functions and SetConv 1e-5 absolute (float32 sums in
  other orders); masks bit for bit.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from npf_gwwaveform_tpu.data import datasplit as jds
from npf_gwwaveform_tpu.data import gp as jgp
from npf_gwwaveform_tpu.ops import setconv as jsc
from npf_gwwaveform_tpu.utils.helpers import rescale_range as jax_rescale
from npf_gwwaveform_tpu_torch.data import datasplit as tds
from npf_gwwaveform_tpu_torch.data import gp as tgp
from npf_gwwaveform_tpu_torch.ops.setconv import MlpRBF, SetConv, UnsharedExpRBF
from npf_gwwaveform_tpu_torch.training import params_from_flax
from npf_gwwaveform_tpu_torch.utils import rescale_range

torch.set_num_threads(1)

COV_ATOL, IVE_RTOL, RBF_ATOL = 1e-6, 1e-12, 1e-5
Y_RTOL = {"RBF_Kernel": 3e-2, "Periodic_Kernel": 1e-5, "Matern_Kernel": 5e-3,
          "Noisy_Matern_Kernel": 1e-5, "Variable_Matern_Kernel": 5e-3}
MOMENT_SES = 6.0
N_FN = 48


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_noise(js, keys, min_max=(-2.0, 2.0)):
    """The noise `_sample_one` draws from each key, stacked."""
    def one(k):
        kx, kl, ky = jax.random.split(k, 3)
        x = jax.random.uniform(kx, (js.n_points, 1), minval=min_max[0], maxval=min_max[1])
        lo, hi = js.length_scale_bounds
        ls = jax.random.uniform(kl, (), minval=lo, maxval=hi)
        kc, ks = jax.random.split(ky)
        return dict(x=x, length_scale=ls, eps=jax.random.normal(ky, (js.n_points, 1)),
                    xi=jax.random.normal(kc, (tgp.N_HARMONICS,)),
                    eta=jax.random.normal(ks, (tgp.N_HARMONICS,)))
    return {k: _t(v) for k, v in jax.vmap(one)(keys).items()}


@pytest.mark.parametrize("name", ["rbf", "matern15", "matern25", "expsinesquared", "white"])
def test_covariances_match_jax(name):
    x = np.sort(np.random.default_rng(0).uniform(-2, 2, (40, 1)), axis=0).astype(np.float32)
    args = {"rbf": (0.2,), "matern15": (0.2,), "matern25": (0.3,), "expsinesquared": (0.5, 0.5),
            "white": (0.1,)}[name]
    ref = np.asarray(getattr(jgp, f"{name}_cov")(jnp.asarray(x), *args))
    got = getattr(tgp, f"{name}_cov")(_t(x), *(torch.tensor(a) for a in args)).numpy()
    np.testing.assert_allclose(got, ref, atol=COV_ATOL, rtol=0)


def test_ive_matches_scipy():
    m = np.arange(40)
    for z in (1e-3, 0.5, 4.0, 25.0, 100.0, 400.0):
        np.testing.assert_allclose(tgp.ive(m, z), scipy.special.ive(m, z), rtol=IVE_RTOL, atol=0)
    assert tgp.ive([0, 3], 0.0).tolist() == [1.0, 0.0]
    with pytest.raises(ValueError):
        tgp.ive([1.5], 2.0)


def test_periodic_coefficients_match_jax():
    cfg = jgp.KERNEL_CONFIGS["Periodic_Kernel"]
    ref = jgp.GPSampler(**cfg)._periodic_fourier_coeffs()
    got = tgp.GPSampler(**cfg).periodic_fourier_coeffs()
    assert got.dtype == np.float32 and np.array_equal(got, ref)
    assert abs(float(got.astype(np.float64).sum()) - 1.0) < 1e-6


def _fallbacks(ts, x, ls):
    """Which functions fail the first factorisation (1e-5 jitter): port, JAX."""
    xs = torch.sort(x, dim=-2).values
    cov = ts._cov(xs, ls[:, None, None], jitter=ts.sample_jitter)
    port = torch.linalg.cholesky_ex(cov)[1] != 0
    jax_bad = jax.vmap(lambda c: ~jnp.all(jnp.isfinite(jnp.linalg.cholesky(c))))(cov.numpy())
    return port.numpy(), np.asarray(jax_bad)


@pytest.mark.parametrize("kernel", list(jgp.KERNEL_CONFIGS))
def test_sampler_on_jax_noise_matches_jax(kernel):
    cfg = jgp.KERNEL_CONFIGS[kernel]
    js, ts = jgp.GPSampler(n_points=128, **cfg), tgp.GPSampler(n_points=128, **cfg)
    key = jax.random.PRNGKey(11)
    jx, jy = js.sample(key, N_FN)
    noise = _jax_noise(js, jax.random.split(key, N_FN))
    if not ts.is_vary_kernel_hyp:
        noise["length_scale"] = torch.full((N_FN,), ts.length_scale)
    tx, ty = ts.sample_from_noise(**noise)
    assert tx.shape == ty.shape == (N_FN, 128, 1)
    assert torch.equal(tx, _t(jx))
    jy = np.asarray(jy)
    err = np.abs(ty.numpy() - jy).max(axis=(1, 2)) / np.abs(jy).max(axis=(1, 2))
    assert err.max() <= Y_RTOL[kernel], err.max()
    if kernel != "Periodic_Kernel":
        port_bad, jax_bad = _fallbacks(ts, noise["x"], noise["length_scale"])
        assert np.array_equal(port_bad, jax_bad)


def test_jitter_fallback_and_white_noise_guard():
    """Functions whose x are all one point (a kernel matrix of ones): at a
    jitter of 1e-9 (1 + 1e-9 is 1 in float32) the first factorisation fails
    and the second (1e-7) takes over, a nearly constant function; at a
    jitter of 0 both fail and the function is eps itself, as JAX's guard
    makes it."""
    g = torch.Generator().manual_seed(0)
    ts = tgp.GPSampler(kernel="rbf", n_points=8, sample_jitter=1e-9)
    noise = ts.draw_noise(g, 3)
    noise["x"] = torch.full_like(noise["x"], 0.3)
    _, y = ts.sample_from_noise(**noise)
    assert torch.isfinite(y).all() and not torch.equal(y, noise["eps"])
    torch.testing.assert_close(y, noise["eps"][:, :1].expand_as(y), atol=1e-2, rtol=0)
    _, y0 = tgp.GPSampler(kernel="rbf", n_points=8, sample_jitter=0.0).sample_from_noise(**noise)
    assert torch.equal(y0, noise["eps"])


def test_mixture_sampler_on_jax_noise_matches_jax():
    comps = ("RBF_Kernel", "Periodic_Kernel", "Noisy_Matern_Kernel")
    jm = jgp.MixtureGPSampler(tuple(jgp.GPSampler(n_points=128, **jgp.KERNEL_CONFIGS[k])
                                    for k in comps))
    tm = tgp.MixtureGPSampler(tuple(tgp.GPSampler(n_points=128, **jgp.KERNEL_CONFIGS[k])
                                    for k in comps))
    key = jax.random.PRNGKey(5)
    jx, jy = jm.sample(key, N_FN)
    kid_key, k = jax.random.split(key)
    kid = _t(jax.random.randint(kid_key, (N_FN,), 0, 3)).long()
    assert set(kid.tolist()) == {0, 1, 2}
    noise = _jax_noise(jm.components[0], jax.random.split(k, N_FN))
    tx, ty = tm.sample_from_noise(kid, **noise)
    assert torch.equal(tx, _t(jx))
    jy = np.asarray(jy)
    err = np.abs(ty.numpy() - jy).max(axis=(1, 2)) / np.abs(jy).max(axis=(1, 2))
    for i, name in enumerate(comps):
        assert err[kid.numpy() == i].max() <= Y_RTOL[name], name
    # the port's own mixture draws: each kernel about a third
    g = torch.Generator().manual_seed(0)
    x, y = tm.sample(g, 64)
    assert x.shape == y.shape == (64, 128, 1) and torch.isfinite(y).all()


@pytest.mark.parametrize("kernel", list(jgp.KERNEL_CONFIGS))
def test_port_draws_have_the_kernels_moments(kernel):
    ts = tgp.GPSampler(n_points=128, **jgp.KERNEL_CONFIGS[kernel])
    z = tgp.sample_covariance_z(ts, 4096, torch.Generator().manual_seed(1))
    assert z <= MOMENT_SES, z
    x, y = ts.sample(torch.Generator().manual_seed(2), 16)
    assert torch.all(x[:, 1:] >= x[:, :-1]) and x.min() >= -1 and x.max() <= 1
    assert torch.isfinite(y).all()


def test_wider_range_gives_x_past_one():
    ts = tgp.GPSampler(kernel="rbf")
    x, _ = ts.sample(torch.Generator().manual_seed(0), 4, min_max=(-4.0, 4.0))
    assert x.abs().max() > 1.0


def test_rescale_range_and_splitters_bit_identical():
    x = np.random.default_rng(0).uniform(-2, 2, (5, 17, 1)).astype(np.float32)
    assert np.array_equal(rescale_range(_t(x), (-2.0, 2.0), (-1.0, 1.0)).numpy(),
                          np.asarray(jax_rescale(jnp.asarray(x), (-2.0, 2.0), (-1.0, 1.0))))
    g = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    for arange in ((0, 5), (3, 40), (10, 10), (-3, 7)):
        ref = np.asarray(jds.get_range_indcs(arange)(key, 4, 32))
        assert np.array_equal(tds.get_range_indcs(arange)(g, 4, 32).numpy(), ref)
    # the union: two ranges and a random mask (JAX's, handed to both sides)
    rand = np.asarray(jds.GetRandomIndcs(a=0.0, b=8)(key, 4, 32))
    jm = jds.GetIndcsMerger((jds.get_range_indcs((0, 3)), jds.get_range_indcs((20, 24)),
                             lambda k, b, n: jnp.asarray(rand)))
    tm = tds.GetIndcsMerger((tds.get_range_indcs((0, 3)), tds.get_range_indcs((20, 24)),
                             lambda g_, b, n: _t(rand)))
    assert np.array_equal(tm(g, 4, 32).numpy(), np.asarray(jm(key, 4, 32)))


def _setconv_inputs():
    rng = np.random.default_rng(3)
    keys = np.sort(rng.uniform(-1, 1, (3, 20, 1)), axis=1).astype(np.float32)
    queries = np.linspace(-1.2, 1.2, 30, dtype=np.float32)[None, :, None].repeat(3, 0)
    values = rng.normal(size=(3, 20, 2)).astype(np.float32)
    mask = np.ones((3, 20), bool)
    mask[1, 9:] = False
    mask[2] = False
    return keys, queries, values, mask


@pytest.mark.parametrize("rbf", ["exp", "unshared", "mlp"])
def test_setconv_rbfs_match_jax(rbf):
    """Each radial basis function alone and in a SetConv (on the plain path),
    with JAX's parameters perturbed and carried over by `params_from_flax`."""
    jax_rbf = {"exp": jsc.ExpRBF, "unshared": jsc.UnsharedExpRBF, "mlp": jsc.MlpRBF}[rbf]
    keys, queries, values, mask = _setconv_inputs()
    jm = jsc.SetConv(out_channels=5, RadialBasisFunc=jax_rbf)
    params = jm.init(jax.random.PRNGKey(0), keys, queries, values, mask)["params"]
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32),
        flax.core.unfreeze(params))
    ref = np.asarray(jm.apply({"params": params}, keys, queries, values, mask))
    tm = SetConv(2, 5, use_kernel=True, rbf=rbf)
    assert tm.use_kernel == (rbf == "exp")
    tm.load_state_dict(params_from_flax(params), strict=True)
    args = [_t(a) for a in (keys, queries, values, mask)]
    with torch.no_grad():
        got = tm(*args).numpy()
        w, d = tm.rbf(args[0], args[1], args[3])
    np.testing.assert_allclose(got, ref, atol=RBF_ATOL, rtol=0)
    jw, jd = jax_rbf().apply({"params": params["rbf"]}, keys, queries, mask) if rbf != "exp" \
        else jsc.ExpRBF().apply({"params": params["rbf"]}, keys, queries, mask)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=RBF_ATOL, rtol=0)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=RBF_ATOL, rtol=0)
    assert isinstance(tm.rbf, {"unshared": UnsharedExpRBF, "mlp": MlpRBF}.get(rbf, type(tm.rbf)))


def test_datasets_chunk_and_merge():
    s = tgp.GPSampler(kernel="rbf", n_points=16)
    fixed = tgp.GPDataset(s, 40, seed=1, device="cpu")
    b1, b2 = list(fixed.epoch_batches(16)), list(fixed.epoch_batches(16))
    assert len(b1) == 2 and all(torch.equal(a[1], b[1]) for a, b in zip(b1, b2))
    fresh = tgp.GPDataset(s, 40, is_reuse_across_epochs=False, seed=1, device="cpu")
    f1, f2 = list(fresh.epoch_batches(16)), list(fresh.epoch_batches(16))
    assert len(f1) == 2 and not torch.equal(f1[0][1], f2[0][1])
    other = tgp.GPDataset(tgp.GPSampler(kernel="matern", n_points=16), 16, seed=2,
                          device="cpu")
    merged = list(tgp.DatasetMerger([fixed, other]).epoch_batches(16))
    assert len(merged) == 3
    assert torch.equal(merged[0][1], b1[0][1]) and torch.equal(merged[1][1],
                                                               list(other.epoch_batches(16))[0][1])
    x, y = tgp.DatasetMerger([fixed, other]).get_samples(10)
    assert x.shape == (10, 16, 1)
    train, test, valid = tgp.get_gp_datasets(names=("RBF_Kernel", "Matern_Kernel"),
                                             n_samples_train=64, n_samples_test=8,
                                             n_samples_valid=8, n_points=16, device="cpu")
    assert set(train) == set(test) == set(valid) == {"RBF_Kernel", "Matern_Kernel"}
    assert not train["RBF_Kernel"].is_reuse_across_epochs and test["RBF_Kernel"]._fixed is not None
    assert len(train["RBF_Kernel"]) == 64
