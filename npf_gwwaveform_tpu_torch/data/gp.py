"""GP function sampler and datasets, the counterpart of
`npf_gwwaveform_tpu/data/gp.py`.

The covariances (RBF, Matern 3/2 and 5/2, ExpSineSquared, white noise) keep
the JAX module's expressions in the same order. `GPSampler` draws `n`
functions of `n_points` sorted inputs x ~ U(min_max) each, rescaled by the
train range to [-1, 1]: a per-function length scale ~ U(length_scale_bounds)
for "variable_matern"; the exact harmonic sampler for "periodic" (the
ExpSineSquared kernel's Fourier series, whose coefficients are
exp(-z) I_m(z) with z = 1 / l^2, from this module's own integer-order
`ive`); for every other kernel y = L eps with L the Cholesky factor of the
covariance plus a jitter of 1e-5, or of 100 times that where the first
factorisation fails, and eps itself where both fail.

`GPSampler.sample_from_noise` is a pure function of the noise (the unsorted
x draws in the kernel's units, the length scales, and the normals eps, xi
and eta), so that a test can hand it the JAX package's noise; `sample` draws
that noise from an explicit `torch.Generator`, on its device. Both
factorisations run every time (`torch.linalg.cholesky_ex` without its host
check), and `MixtureGPSampler` computes every component for every function
and selects with `torch.where`, as JAX's vmapped `lax.switch` does: the
shapes are fixed and nothing reads back to the host, so a CUDA graph can
capture the sampling.

`GPDataset`, `DatasetMerger`, `KERNEL_CONFIGS` and `get_gp_datasets` chunk
functions into epochs, fixed test and valid chunks, and a round-robin merge.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.helpers import rescale_range

__all__ = ["rbf_cov", "matern15_cov", "matern25_cov", "expsinesquared_cov", "white_cov", "ive",
           "GPSampler", "MixtureGPSampler", "GPDataset", "DatasetMerger", "KERNEL_CONFIGS",
           "get_gp_datasets", "sample_covariance_z", "N_HARMONICS"]

N_HARMONICS = 32  # the periodic sampler's harmonics


# ---- kernels: x [..., n, 1] -> [..., n, n]; length scales broadcast as [..., 1, 1]


def _sq_dist(x: torch.Tensor) -> torch.Tensor:
    d = x[..., :, None, 0] - x[..., None, :, 0]
    return d * d


def rbf_cov(x, length_scale):
    return torch.exp(-0.5 * _sq_dist(x) / length_scale ** 2)


def matern15_cov(x, length_scale):
    d = torch.sqrt(_sq_dist(x) + 1e-12)
    z = math.sqrt(3.0) * d / length_scale
    return (1.0 + z) * torch.exp(-z)


def matern25_cov(x, length_scale):
    d = torch.sqrt(_sq_dist(x) + 1e-12)
    z = math.sqrt(5.0) * d / length_scale
    return (1.0 + z + z * z / 3.0) * torch.exp(-z)


def expsinesquared_cov(x, length_scale, periodicity):
    d = torch.sqrt(_sq_dist(x) + 1e-12)
    s = torch.sin(math.pi * d / periodicity) / length_scale
    return torch.exp(-2.0 * s * s)


def white_cov(x, noise_level):
    n = x.shape[-2]
    return noise_level * torch.eye(n, dtype=x.dtype, device=x.device)


def ive(m, z: float) -> np.ndarray:
    """exp(-z) I_m(z), the exponentially scaled modified Bessel function of
    the first kind, for integer orders m >= 0 and 0 <= z <= 700, in float64:
    the power series sum_k (z/2)^(2k+m) / (k! (k+m)!), its first term
    scaled by exp(-z) in log space and the rest by the terms' ratios,
    summed until a term no longer changes the sum."""
    m = np.atleast_1d(np.asarray(m))
    if np.any(m < 0) or np.any(m != np.round(m)):
        raise ValueError("ive takes integer orders m >= 0")
    if not 0.0 <= z <= 700.0:
        raise ValueError(f"ive: z={z} outside [0, 700]")
    out = np.empty(m.shape, dtype=np.float64)
    q = (z / 2.0) ** 2
    for i, order in enumerate(m.astype(np.int64).ravel()):
        if z == 0.0:
            out.flat[i] = 1.0 if order == 0 else 0.0
            continue
        term = math.exp(order * math.log(z / 2.0) - math.lgamma(order + 1) - z)
        total, k = term, 0
        while True:
            k += 1
            term *= q / (k * (k + order))
            if total + term == total and k > z:
                break
            total += term
        out.flat[i] = total
    return out


def _uniform(generator, shape, lo, hi, device):
    """U(lo, hi) float32 as lo + u * (hi - lo)."""
    return lo + torch.rand(shape, generator=generator, device=device) * (hi - lo)


@dataclass(frozen=True)
class GPSampler:
    """Batched GP function sampler. kernel: "rbf", "periodic", "matern",
    "noisy_matern" or "variable_matern"; the defaults are the JAX sampler's.
    `alpha` enters only the fitted posterior (`posterior`), not the draws."""

    kernel: str = "rbf"
    n_points: int = 128
    min_max: Tuple[float, float] = (-2.0, 2.0)
    alpha: float = 0.005
    sample_jitter: float = 1e-5
    length_scale: float = 0.2
    periodicity: float = 0.5
    noise_level: float = 0.1
    nu: float = 1.5
    length_scale_bounds: Tuple[float, float] = (0.01, 0.3)
    # the periodic sampler's coefficients by device, made at the sampler's
    # first eager call, so that a CUDA graph captured later copies nothing
    # from the host
    _coeffs: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.kernel not in ("rbf", "periodic", "matern", "noisy_matern", "variable_matern"):
            raise ValueError(f"Unknown kernel {self.kernel}")

    @property
    def is_vary_kernel_hyp(self) -> bool:
        return self.kernel.startswith("variable")

    def _cov(self, x: torch.Tensor, length_scale: torch.Tensor,
             jitter: Optional[float] = None) -> torch.Tensor:
        """x [..., n, 1], length_scale broadcastable to [..., 1, 1] -> the
        kernel matrix plus `jitter` (default `sample_jitter`) on its diagonal."""
        if self.kernel == "rbf":
            k = rbf_cov(x, length_scale)
        elif self.kernel == "periodic":
            k = expsinesquared_cov(x, length_scale, self.periodicity)
        elif self.kernel in ("matern", "variable_matern"):
            k = (matern15_cov if self.nu == 1.5 else matern25_cov)(x, length_scale)
        else:
            k = matern15_cov(x, length_scale) + white_cov(x, self.noise_level)
        jit = self.sample_jitter if jitter is None else jitter
        return k + jit * torch.eye(x.shape[-2], dtype=x.dtype, device=x.device)

    def periodic_fourier_coeffs(self, n_harmonics: int = N_HARMONICS) -> np.ndarray:
        """The harmonic variances a_m of ExpSineSquared (they sum to 1): with
        z = 1 / l^2, k(d) = e^-z [I_0(z) + 2 sum_m I_m(z) cos(2 pi m d / p)],
        float32 as JAX's."""
        a = ive(np.arange(n_harmonics), 1.0 / (self.length_scale ** 2))
        a[1:] *= 2.0
        return a.astype(np.float32)

    def noise_shapes(self, n: int) -> dict:
        """The shape of each noise input of `sample_from_noise` for n functions."""
        return dict(x=(n, self.n_points, 1), length_scale=(n,), eps=(n, self.n_points, 1),
                    xi=(n, N_HARMONICS), eta=(n, N_HARMONICS))

    def draw_noise(self, generator: torch.Generator, n: int,
                   min_max: Optional[Tuple[float, float]] = None) -> dict:
        """The noise of n functions from `generator`, on its device: the
        unsorted x ~ U(min_max) [n, n_points, 1], the length scales [n] (U of
        the bounds for "variable_matern", else `length_scale`), and the
        normals eps [n, n_points, 1], xi and eta [n, 32]."""
        lo, hi = self.min_max if min_max is None else min_max
        device = generator.device
        shapes = self.noise_shapes(n)
        noise = dict(x=_uniform(generator, shapes["x"], lo, hi, device))
        noise["length_scale"] = (_uniform(generator, (n,), *self.length_scale_bounds, device)
                                 if self.is_vary_kernel_hyp else
                                 torch.full((n,), self.length_scale, device=device))
        for name in ("eps", "xi", "eta"):
            noise[name] = torch.randn(shapes[name], generator=generator, device=device)
        return noise

    def sample_from_noise(self, x: torch.Tensor, length_scale: torch.Tensor, eps: torch.Tensor,
                          xi: torch.Tensor, eta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The functions of the given noise (`draw_noise`'s) -> (x [n,
        n_points, 1] sorted and rescaled by the train range to [-1, 1], y [n,
        n_points, 1]). "periodic" reads x, xi and eta; the others x and eps,
        and "variable_matern" its length scales (the others their own)."""
        x = torch.sort(x, dim=-2).values
        if not self.is_vary_kernel_hyp:
            length_scale = torch.full((x.shape[0],), self.length_scale, device=x.device)
        if self.kernel == "periodic":
            key = str(x.device)
            if key not in self._coeffs:
                self._coeffs[key] = torch.from_numpy(self.periodic_fourier_coeffs()).to(x.device)
            a = self._coeffs[key]
            m = torch.arange(a.shape[0], dtype=torch.float32, device=x.device)
            ang = 2.0 * math.pi * m[None, None, :] * x / self.periodicity  # [n, N, M]
            sqrt_a = torch.sqrt(a)
            y = (torch.cos(ang) @ (sqrt_a * xi)[..., None]
                 + torch.sin(ang) @ (sqrt_a * eta)[..., None])
        else:
            cov = self._cov(x, length_scale[:, None, None], jitter=0.0)
            eye = torch.eye(self.n_points, dtype=x.dtype, device=x.device)
            chol1, info1 = torch.linalg.cholesky_ex(cov + self.sample_jitter * eye)
            chol2, info2 = torch.linalg.cholesky_ex(cov + 100.0 * self.sample_jitter * eye)
            # a factorisation that fails leaves its info nonzero (JAX's: NaNs)
            bad1 = (info1 != 0) | ~torch.isfinite(chol1).all(dim=(-2, -1))
            bad2 = (info2 != 0) | ~torch.isfinite(chol2).all(dim=(-2, -1))
            chol = torch.where(bad1[:, None, None], chol2, chol1)
            y = chol @ eps
            # a doubly failed draw is white noise rather than NaNs in the batch
            failed = (bad1 & bad2) | ~torch.isfinite(y).all(dim=(-2, -1))
            y = torch.where(failed[:, None, None], eps, y)
        return rescale_range(x, self.min_max, (-1.0, 1.0)), y

    def sample(self, generator: torch.Generator, n_samples: int,
               min_max: Optional[Tuple[float, float]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """n functions drawn from `generator` on its device -> (x [n,
        n_points, 1] rescaled by the TRAIN range, so that a wider `min_max`
        gives |x| > 1, y [n, n_points, 1])."""
        return self.sample_from_noise(**self.draw_noise(generator, n_samples, min_max))

    def posterior(self, x_cntxt, y_cntxt, x_test, length_scale=None):
        """The GP posterior (mean [m], std [m]) at x_test [m, 1] given the
        context x_cntxt [n, 1], y_cntxt [n, 1], all x in the model's [-1, 1]
        coordinates (converted back to the kernel's units here), with the
        fitted regressor's `alpha` on the context's diagonal."""
        ls = torch.as_tensor(self.length_scale if length_scale is None else length_scale,
                             dtype=torch.float32, device=x_cntxt.device)
        lo, hi = self.min_max

        def to_native(x):
            return (x + 1.0) * 0.5 * (hi - lo) + lo

        xc, xt = to_native(x_cntxt), to_native(x_test)
        k_cc = self._cov(xc, ls, jitter=self.alpha)
        k_all = self._cov(torch.cat([xc, xt], dim=0), ls, jitter=0.0)
        n = xc.shape[0]
        k_ct, k_tt = k_all[:n, n:], k_all[n:, n:]
        sol = torch.linalg.solve(k_cc, torch.cat([y_cntxt, k_ct], dim=1))
        mean = k_ct.T @ sol[:, :1]
        cov = k_tt - k_ct.T @ sol[:, 1:]
        return mean[:, 0], torch.sqrt(torch.clamp(torch.diagonal(cov), min=1e-10))


@dataclass(frozen=True)
class MixtureGPSampler:
    """A uniform mixture of GPSamplers (the All_Kernels training stream):
    each function draws its component uniformly; every component is computed
    on the same noise and the function's is selected. For evaluation use the
    components' own test chunks, concatenated (`components`)."""

    components: Tuple[GPSampler, ...]

    def __post_init__(self):
        # one train range: each component's rescaling is then the mixture's
        if len({(s.min_max, s.n_points) for s in self.components}) != 1:
            raise ValueError("the components must share min_max and n_points")

    @property
    def n_points(self) -> int:
        return self.components[0].n_points

    @property
    def min_max(self):
        return self.components[0].min_max

    def sample_from_noise(self, kid: torch.Tensor, **noise) -> Tuple[torch.Tensor, torch.Tensor]:
        """kid [n] the component of each function; the noise as
        `GPSampler.draw_noise` gives it (one set serves every component)."""
        x, y = None, None
        for i, s in enumerate(self.components):
            xi_, yi_ = s.sample_from_noise(**noise)
            x = xi_ if x is None else torch.where((kid == i)[:, None, None], xi_, x)
            y = yi_ if y is None else torch.where((kid == i)[:, None, None], yi_, y)
        return x, y

    def sample(self, generator: torch.Generator, n_samples: int,
               min_max: Optional[Tuple[float, float]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        kid = torch.randint(0, len(self.components), (n_samples,), generator=generator,
                            device=generator.device)
        noise = self.components[0].draw_noise(generator, n_samples, min_max)
        return self.sample_from_noise(kid, **noise)


def sample_covariance_z(sampler: GPSampler, n: int, generator: torch.Generator,
                        n_x: int = 64) -> float:
    """The largest standardised error of the sample covariance of n draws
    of `sampler` (its own noise from `generator`) at one fixed x, `n_x`
    points evenly over its range, against the kernel's (for
    "variable_matern" the mean of the kernel over the draws' length scales;
    for "periodic" the ExpSineSquared kernel the harmonic series sums to):
    max |C_ij - K_ij| / sqrt((K_ii K_jj + K_ij^2) / n), each entry's error
    over its standard error for Gaussian draws."""
    lo, hi = sampler.min_max
    device = generator.device
    x = torch.linspace(lo, hi, n_x, device=device).reshape(1, n_x, 1)
    s = replace(sampler, n_points=n_x)
    noise = s.draw_noise(generator, n)
    noise["x"] = x.expand(n, n_x, 1).contiguous()
    _, y = s.sample_from_noise(**noise)
    y = y[..., 0].double()
    c = y.T @ y / n
    ls = (noise["length_scale"] if s.is_vary_kernel_hyp
          else torch.full((1,), s.length_scale, device=device)).double()
    k = s._cov(x.double().expand(ls.shape[0], n_x, 1), ls[:, None, None], jitter=0.0).mean(dim=0)
    d = torch.diagonal(k)
    se = torch.sqrt((d[:, None] * d[None, :] + k ** 2) / n)
    return float(((c - k).abs() / se).max())


# ---- dataset-style wrappers


class GPDataset:
    """Epoch-chunked GP functions: a fresh chunk each epoch, or with
    `is_reuse_across_epochs` one fixed chunk drawn at construction. Draws
    come from a generator seeded `seed` on `device`."""

    def __init__(self, sampler, n_samples: int = 1000, is_reuse_across_epochs: bool = True,
                 seed: int = 0, device="cuda"):
        self.sampler = sampler
        self.n_samples = n_samples
        self.is_reuse_across_epochs = is_reuse_across_epochs
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self._fixed = self.get_samples(n_samples) if is_reuse_across_epochs else None

    def __len__(self) -> int:
        return self.n_samples

    @property
    def n_points(self) -> int:
        return self.sampler.n_points

    def get_samples(self, n_samples: Optional[int] = None, test_min_max=None,
                    generator: Optional[torch.Generator] = None):
        n = self.n_samples if n_samples is None else n_samples
        return self.sampler.sample(self.generator if generator is None else generator, n,
                                   min_max=test_min_max)

    def set_samples_(self, data, targets) -> None:
        self.is_reuse_across_epochs = True
        self._fixed = (data, targets)
        self.n_samples = data.shape[0]

    def epoch_batches(self, batch_size: int,
                      generator: Optional[torch.Generator] = None) -> Iterator[tuple]:
        """(x, y) batches of one epoch: the fixed chunk's whole batches, or
        `n_samples // batch_size` fresh batches."""
        if self.is_reuse_across_epochs:
            x, y = self._fixed
            for i in range(0, x.shape[0] - batch_size + 1, batch_size):
                yield x[i:i + batch_size], y[i:i + batch_size]
        else:
            g = self.generator if generator is None else generator
            for _ in range(self.n_samples // batch_size):
                yield self.sampler.sample(g, batch_size)


class DatasetMerger:
    """Round-robin merge of datasets: one epoch's batches alternate between
    the sources until each is spent."""

    def __init__(self, datasets: Sequence[GPDataset]):
        self.datasets = list(datasets)
        self.n_samples = sum(d.n_samples for d in self.datasets)

    def __len__(self) -> int:
        return self.n_samples

    @property
    def n_points(self) -> int:
        return self.datasets[0].n_points

    def get_samples(self, n_samples: Optional[int] = None, test_min_max=None, generator=None):
        per = (n_samples or self.n_samples) // len(self.datasets)
        xs, ys = zip(*[d.get_samples(per, test_min_max=test_min_max, generator=generator)
                       for d in self.datasets])
        return torch.cat(xs, 0), torch.cat(ys, 0)

    def epoch_batches(self, batch_size: int, generator=None) -> Iterator[tuple]:
        alive = [d.epoch_batches(batch_size) for d in self.datasets]
        while alive:
            nxt = []
            for it in alive:
                try:
                    yield next(it)
                    nxt.append(it)
                except StopIteration:
                    pass
            alive = nxt


# the notebooks' kernels
KERNEL_CONFIGS = {
    "RBF_Kernel": dict(kernel="rbf", length_scale=0.2),
    "Periodic_Kernel": dict(kernel="periodic", length_scale=0.5, periodicity=0.5),
    "Matern_Kernel": dict(kernel="matern", length_scale=0.2, nu=1.5),
    "Noisy_Matern_Kernel": dict(kernel="noisy_matern", length_scale=0.2, noise_level=0.1,
                                nu=1.5),
    "Variable_Matern_Kernel": dict(kernel="variable_matern", length_scale_bounds=(0.01, 0.3),
                                   nu=1.5),
}


def get_gp_datasets(names=("RBF_Kernel", "Periodic_Kernel", "Noisy_Matern_Kernel"),
                    n_samples_train: int = 50_000, n_samples_test: int = 10_000,
                    n_samples_valid: int = 5_000, n_points: int = 128, seed: int = 123,
                    device="cuda"):
    """(train, test, valid) dicts of GPDatasets by kernel name: train fresh
    each epoch (seed + i), test and valid fixed chunks (seed + 1000 + i,
    seed + 2000 + i)."""
    train, test, valid = {}, {}, {}
    for i, name in enumerate(names):
        sampler = GPSampler(n_points=n_points, **KERNEL_CONFIGS[name])
        train[name] = GPDataset(sampler, n_samples_train, is_reuse_across_epochs=False,
                                seed=seed + i, device=device)
        test[name] = GPDataset(sampler, n_samples_test, seed=seed + 1000 + i, device=device)
        valid[name] = GPDataset(sampler, n_samples_valid, seed=seed + 2000 + i, device=device)
    return train, test, valid
