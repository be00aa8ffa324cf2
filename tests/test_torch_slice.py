"""The whole scored slice against the JAX package: ConvCNP forward, predictive,
NPML log-likelihood and mismatch, at a small width from a flax `init` and at
full width on the flagship frozen run.

Tolerances: 5e-4 on loc/scale, the README's parity bar (measured: 1.3e-5 on
run_1). The per-waveform LL sums 256 log-probs whose predictive scale goes
down to 0.01, so a loc difference d moves it by up to about 256 * |z| * d /
0.01; at the measured d that is ~1e-2 (measured: 2e-3), and 2e-2 is the bar.
Mismatch: 1e-5 plus 1e-4 of its value (measured: 1.5e-5 on a waveform at
mismatch 0.33, 1.4e-6 below 0.05).
"""

import json
import os

import flax
import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu.configs import _cnn_factory
from npf_gwwaveform_tpu.configs import gw_model_from_summary as jax_gw_model_from_summary
from npf_gwwaveform_tpu.data.gw import GWWaveformGenerator as JaxGenerator
from npf_gwwaveform_tpu.data.gw import mismatch as jax_mismatch
from npf_gwwaveform_tpu.losses import CNPFLoss as JaxCNPFLoss
from npf_gwwaveform_tpu.models.convnp import ConvCNP as JaxConvCNP
from npf_gwwaveform_tpu_torch.configs import gw_model_from_summary
from npf_gwwaveform_tpu_torch.data.gw import mismatch
from npf_gwwaveform_tpu_torch.losses import CNPFLoss
from npf_gwwaveform_tpu_torch.models.convnp import ConvCNP
from npf_gwwaveform_tpu_torch.score import load_model, read_run_thetas, score_run
from npf_gwwaveform_tpu_torch.training.checkpoint import params_from_flax, read_msgpack

torch.set_num_threads(1)

RUN_DIR = os.path.join(os.path.dirname(__file__), "..", "results",
                       "GW_time_cond_film_ctx192_d128", "ConvCNP", "run_1")
PRED_ATOL = 5e-4
LL_ATOL = 2e-2
MISMATCH_ATOL, MISMATCH_RTOL = 1e-5, 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _batch(rng, B, N, counts):
    x = np.broadcast_to(np.linspace(-1, 1, N, dtype=np.float32)[None, :, None], (B, N, 1)).copy()
    y = np.sin(8 * x + rng.uniform(0, 6, (B, 1, 1))).astype(np.float32)
    mask_c = np.zeros((B, N), bool)
    for i, n in enumerate(counts):  # counts[0] == 0: an empty context
        mask_c[i, rng.permutation(N)[:n]] = True
    mask_t = np.ones((B, N), bool)
    return x, y, mask_c, mask_t


def _compare(jax_model, variables, torch_model, x, y, mask_c, mask_t, cond):
    apply = jax.jit(jax_model.apply, static_argnames="train")  # eager flax is slower here
    out = apply(variables, *(jnp.asarray(a) for a in (x, y, x)),
                mask_cntxt=jnp.asarray(mask_c), mask_trgt=jnp.asarray(mask_t),
                condition=jnp.asarray(cond), train=False)
    ll_ref = -np.asarray(JaxCNPFLoss(reduction=None)(out, jnp.asarray(y), jnp.asarray(mask_t),
                                                     train=False))
    mm_ref = np.asarray(jax_mismatch(out.p_yCc.loc[0, ..., 0], jnp.asarray(y[..., 0])))
    with torch.no_grad():
        t = torch_model(*(torch.from_numpy(a) for a in (x, y, x, mask_c, mask_t, cond)))
        ll = -CNPFLoss(reduction=None)(t, torch.from_numpy(y), torch.from_numpy(mask_t),
                                       train=False).numpy()
        mm = mismatch(t.p_yCc.loc[0, ..., 0], torch.from_numpy(y[..., 0])).numpy()
    np.testing.assert_allclose(t.p_yCc.loc.numpy(), np.asarray(out.p_yCc.loc), atol=PRED_ATOL)
    np.testing.assert_allclose(t.p_yCc.scale.numpy(), np.asarray(out.p_yCc.scale), atol=PRED_ATOL)
    np.testing.assert_allclose(ll, ll_ref, atol=LL_ATOL)
    np.testing.assert_allclose(mm, mm_ref, atol=MISMATCH_ATOL, rtol=MISMATCH_RTOL)
    assert np.isfinite(ll).all()


@pytest.mark.parametrize("use_kernels", [False, True])
def test_small_convcnp_matches_jax(use_kernels):
    """r_dim 16, density 16, two BatchNorm ResConvBlocks, FiLM conditioning."""
    rng = np.random.default_rng(0)
    B, N = 3, 40
    x, y, mask_c, mask_t = _batch(rng, B, N, [0, 7, 30])
    cond = rng.uniform(-1, 1, (B, 4)).astype(np.float32)
    jm = JaxConvCNP(y_dim=1, x_dim=1, r_dim=16, density_induced=16,
                    CNNFactory=_cnn_factory(2, kernel_size=5), cond_dim=4, cond_mode="film")
    init = jax.jit(lambda key: jm.init(
        key, *(jnp.asarray(a) for a in (x, y, x)), mask_cntxt=jnp.asarray(mask_c),
        mask_trgt=jnp.asarray(mask_t), condition=jnp.asarray(cond), train=False))
    variables = _np_tree(init(jax.random.PRNGKey(0)))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.1, 0.5, a.shape).astype(np.float32), variables["batch_stats"])
    tm = ConvCNP(r_dim=16, density_induced=16, cnn_n_blocks=2, cnn_kernel_size=5, cond_dim=4,
                 use_kernels=use_kernels)
    tm.load_state_dict(
        params_from_flax(variables["params"], {"batch_stats": variables["batch_stats"]}),
        strict=True)
    _compare(jm, variables, tm.eval(), x, y, mask_c, mask_t, cond)


def _flax_restore(path):
    with open(path, "rb") as f:
        data = f.read()
    return flax.serialization.from_bytes(flax.serialization.msgpack_restore(data), data)


@pytest.mark.parametrize("name", ["params.msgpack", "extra_vars.msgpack"])
def test_msgpack_reader_matches_flax_on_run(name):
    path = os.path.join(RUN_DIR, name)
    ref = jax.tree_util.tree_leaves_with_path(_flax_restore(path))
    out = jax.tree_util.tree_leaves_with_path(read_msgpack(path))
    assert [p for p, _ in out] == [p for p, _ in ref] and len(out) > 0
    for (p, a), (_, b) in zip(out, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(p))


def test_flagship_run_matches_jax_at_full_width():
    """run_1 (368,004 parameters), B=4 recorded thetas, JAX float32 waveforms
    fed to both; contexts of 0, 5, 96 and 192 points."""
    with open(os.path.join(RUN_DIR, "summary.json")) as f:
        summary = json.load(f)
    rng = np.random.default_rng(1)
    theta = read_run_thetas(RUN_DIR)[:4]
    _, h = JaxGenerator(duration=1.0, sample_rate=1024.0).time_domain(jnp.asarray(theta))
    x, _, mask_c, mask_t = _batch(rng, 4, 256, [0, 5, 96, 192])
    y = np.array(h)[:, ::4, None]
    cond = ((theta - [10, 10, -0.8, -0.8]) / [70, 70, 1.6, 1.6] * 2 - 1).astype(np.float32)
    variables = {"params": _flax_restore(os.path.join(RUN_DIR, "params.msgpack")),
                 **_flax_restore(os.path.join(RUN_DIR, "extra_vars.msgpack"))}
    tm = load_model(RUN_DIR, "cpu")
    assert sum(p.numel() for p in tm.parameters()) == 368004
    _compare(jax_gw_model_from_summary(summary), variables, tm, x, y, mask_c, mask_t, cond)


def test_score_run_on_cpu():
    """The scorer end to end on 8 recorded thetas: finite per-waveform
    results and the run's recorded quality on the easy ones."""
    res = score_run(RUN_DIR, n_test=8, thetas_from_run=True, device="cpu")
    assert res["n"] == 8 and np.isfinite(res["ll"]).all() and np.isfinite(res["mismatch"]).all()
    assert res["ll"].shape == res["mismatch"].shape == (8,)
    assert 0.0 <= res["median_mismatch"] < 1.0


def test_gw_model_from_summary_refuses_unported_configs():
    with pytest.raises(NotImplementedError):
        gw_model_from_summary({"model": "ConvCNP", "cnn_arch": "unet"})
    with pytest.raises(NotImplementedError):
        gw_model_from_summary({"model": "ConvLNP"})
    m = gw_model_from_summary({"model": "ConvCNP", "conditioned": True, "density_induced": 128})
    assert m.n_induced == 384
    assert m.induced_to_induced.block_0.conv1.depthwise.kernel_size == (19,)
