"""The port's waveform generator and match metric against the JAX package's.

The TaylorF2 phase grows large in float32, so the waveform tolerance comes
from a measurement: on the first 256 thetas recorded in the flagship run
(generator at 1024 Hz over 1 s), JAX's own float32 waveforms differ from its
float64 ones by up to 1.6e-3 of the peak, and the port's float32 waveforms
differ from JAX's float32 ones by up to 3.6e-3 (two independent roundings).
The bar is 5e-3 of the peak against both JAX precisions.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu.data.gw import GWParameterSpace as JaxSpace
from npf_gwwaveform_tpu.data.gw import GWWaveformGenerator as JaxGenerator
from npf_gwwaveform_tpu.data.gw import mismatch as jax_mismatch
from npf_gwwaveform_tpu_torch.data.gw import GWParameterSpace, GWWaveformGenerator, mismatch
from npf_gwwaveform_tpu_torch.score import read_run_thetas

torch.set_num_threads(1)

RUN_DIR = os.path.join(os.path.dirname(__file__), "..", "results",
                       "GW_time_cond_film_ctx192_d128", "ConvCNP", "run_1")
WAVE_ATOL = 5e-3


def _thetas():
    corners = np.array([[10, 10, -0.8, -0.8], [80, 80, 0.8, 0.8], [80, 10, 0.8, -0.8]],
                       np.float32)
    return np.concatenate([read_run_thetas(RUN_DIR)[:61], corners])


def _x64():
    return jax.enable_x64(True) if hasattr(jax, "enable_x64") else jax.experimental.enable_x64()


@pytest.mark.parametrize("gen_kwargs", [dict(duration=1.0, sample_rate=1024.0), dict()])
def test_time_domain_matches_jax(gen_kwargs):
    theta = _thetas()
    times, h = GWWaveformGenerator(**gen_kwargs).time_domain(torch.from_numpy(theta))
    jtimes, h32 = JaxGenerator(**gen_kwargs).time_domain(jnp.asarray(theta))
    with _x64():
        _, h64 = JaxGenerator(**gen_kwargs).time_domain(jnp.asarray(theta, jnp.float64))
        h64 = np.asarray(h64)
    assert h.dtype == torch.float32 and h.shape == h32.shape
    np.testing.assert_array_equal(times.numpy(), np.asarray(jtimes))
    h, h32 = h.numpy(), np.array(h32)
    assert np.isfinite(h).all()
    np.testing.assert_allclose(h, h32, rtol=0, atol=WAVE_ATOL)
    np.testing.assert_allclose(h, h64, rtol=0, atol=WAVE_ATOL)
    # the scored metric barely notices: the port's and JAX's waveforms match
    mm = mismatch(torch.from_numpy(h), torch.from_numpy(h32)).numpy()
    assert mm.max() < 1e-4


def test_mismatch_matches_jax():
    rng = np.random.default_rng(0)
    h1 = rng.normal(size=(5, 256)).astype(np.float32)
    h2 = (h1 + 0.3 * rng.normal(size=(5, 256))).astype(np.float32)
    h2[0] = np.roll(h1[0], 7)  # a pure time shift: mismatch ~0
    ref = np.asarray(jax_mismatch(jnp.asarray(h1), jnp.asarray(h2)))
    out = mismatch(torch.from_numpy(h1), torch.from_numpy(h2)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert abs(out[0]) < 1e-6


def test_parameter_space_normalize_and_sample():
    theta = _thetas()
    ref = np.asarray(JaxSpace().normalize(jnp.asarray(theta)))
    np.testing.assert_allclose(GWParameterSpace().normalize(torch.from_numpy(theta)).numpy(),
                               ref, atol=1e-6)
    s = GWParameterSpace().sample(1000, torch.Generator().manual_seed(0))
    assert s.shape == (1000, 4) and s.dtype == torch.float32
    assert (s[:, 0] >= s[:, 1]).all() and s[:, :2].min() >= 10 and s[:, :2].max() <= 80
    assert s[:, 2:].abs().max() <= 0.8
