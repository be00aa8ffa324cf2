"""The 21 image runs in `results/` in the port: each loads strictly into
`configs.img_model_from_summary`'s model (`score_img.load_model`) and its
parameters and statistics written back (`flax_from_params`,
`write_msgpack`) are the run's files byte for byte (`zsmms/GridConvCNP/
run_0`, an earlier build of one conv layer a block without
`extra_vars.msgpack`, its parameters); and one run of each family (the six
`digits` runs, `zsmms/GridConvCNP/run_1` with circular padding and
`rgb_digits128/GridConvCNPXL/run_0` at batch 1) on the JAX package's own
eval inputs (`reproduce_img.py`'s first eval batch: its images and the
masks its eval splitter draws from `fold_in(PRNGKey(123), 0)`), against the
JAX package's forward of the same parameters (its `build_model`), a latent
model on JAX's own z noise: loc and scale within 5e-4 (2e-3 for the
attention runs, whose float32 logits reach ~1e3-1e4, as
tests/test_torch_setattn_runs.py explains), the
per-image log-likelihood within 1e-4 relative. JAX runs on the first few
images of the batch, the masks drawn for the whole batch.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from experiments.reproduce_img import POINT_MODELS, build_model
from npf_gwwaveform_tpu.data import get_train_test_img_dataset
from npf_gwwaveform_tpu.data.datasplit import (
    GridCntxtTrgtSplitter, PointsFromGridSplitter, RandomMasker, no_masker,
)
from npf_gwwaveform_tpu.losses import npml_loss as jax_npml
from npf_gwwaveform_tpu_torch import score_img
from npf_gwwaveform_tpu_torch.losses import npml_loss
from npf_gwwaveform_tpu_torch.run_report import img_rescorable, img_runs
from npf_gwwaveform_tpu_torch.training.checkpoint import (
    flax_from_params, load_run_params, write_msgpack,
)

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
RESULTS = os.path.join(REPO, "results")
RUNS = img_runs(RESULTS)


def test_the_21_runs_are_found():
    assert len(RUNS) == 21
    assert len(img_runs(RESULTS, scored=True)) == 20
    assert [os.path.relpath(r, RESULTS) for r in RUNS if r not in img_runs(RESULTS, True)] == \
        [os.path.join("zsmms", "GridConvCNP", "run_0")]


@pytest.mark.parametrize("run_dir", RUNS, ids=[os.path.relpath(r, RESULTS) for r in RUNS])
def test_run_loads_strictly_and_round_trips(run_dir, tmp_path):
    model = score_img.load_model(run_dir, "cpu")
    params, extra = load_run_params(run_dir)
    buffers = [n for n, _ in model.named_buffers()]
    back, back_extra = flax_from_params(model.state_dict(), buffers)
    write_msgpack(str(tmp_path / "params.msgpack"), back)
    with open(os.path.join(run_dir, "params.msgpack"), "rb") as f:
        assert (tmp_path / "params.msgpack").read_bytes() == f.read()
    extra_path = os.path.join(run_dir, "extra_vars.msgpack")
    if os.path.exists(extra_path):  # the point models' is an empty map
        write_msgpack(str(tmp_path / "extra_vars.msgpack"), back_extra)
        with open(extra_path, "rb") as f:
            assert (tmp_path / "extra_vars.msgpack").read_bytes() == f.read()
    elif any(True for _ in model.buffers()):  # the earlier one-layer build, init statistics
        assert not img_rescorable(run_dir)
        assert score_img.n_conv_layers(params) == 1
        assert all((b == 0).all() if n.endswith("mean") else (b == 1).all()
                   for n, b in model.named_buffers())


FAMILY = ["digits/GridConvCNP/run_0", "digits/GridConvLNP/run_0", "digits/CNP/run_0",
          "digits/LNP/run_0", "digits/AttnCNP/run_0", "digits/AttnLNP/run_0",
          "zsmms/GridConvCNP/run_1", "rgb_digits128/GridConvCNPXL/run_0"]
# images of the first eval batch run through both packages
N_IMAGES = {"digits/GridConvLNP/run_0": 2, "rgb_digits128/GridConvCNPXL/run_0": 1,
            "digits/AttnCNP/run_0": 4, "digits/AttnLNP/run_0": 4}


def _jax_batch(summary):
    """reproduce_img.py's first eval batch: its 32 test images, split by its
    eval splitter with the split key of fold_in(PRNGKey(123), 0); and the
    latent key."""
    _, test = get_train_test_img_dataset(summary["dataset"])
    masker = RandomMasker(a=0.0, b=0.3, is_indep_n=True)
    if summary["model"] in POINT_MODELS:
        splitter = PointsFromGridSplitter(
            context_masker=masker, upscale_factor=getattr(test, "test_upscale_factor", 1.0))
    else:
        splitter = GridCntxtTrgtSplitter(context_masker=masker, target_masker=no_masker)
    k_split, k_latent = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(123), 0))
    y = test.images[:32]
    return {k: np.asarray(v) for k, v in splitter(k_split, y, y).items()}, k_latent


@pytest.mark.parametrize("name", FAMILY)
def test_run_matches_jax_on_its_eval_inputs(name):
    run_dir = os.path.join(RESULTS, name)
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    batch, k_latent = _jax_batch(summary)
    n = N_IMAGES.get(name, 8)
    b = {k: v[:n] for k, v in batch.items()}
    zsmms = dict(padding="CIRCULAR", norm_eps=1e-2) if summary["dataset"] == "zsmms" else {}
    jm = build_model(summary["model"], y_dim=summary.get("y_dim", 1), **zsmms)
    params, extra = load_run_params(run_dir)
    j_out = jm.apply({"params": params, **extra}, b["X_cntxt"], b["Y_cntxt"], b["X_trgt"],
                     b["Y_trgt"], mask_cntxt=b["mask_cntxt"], mask_trgt=b["mask_trgt"],
                     train=False, rngs={"latent": k_latent})
    eps = None
    if j_out.z_samples is not None:
        q = j_out.q_zCc if j_out.q_zCct is None else j_out.q_zCct
        z, loc, scale = (np.asarray(a, np.float64) for a in (j_out.z_samples, q.loc, q.scale))
        eps = torch.from_numpy((z - loc) / scale).float()
    tm = score_img.load_model(run_dir, "cpu")
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.no_grad():
        out = tm(t["X_cntxt"], t["Y_cntxt"], t["X_trgt"], mask_cntxt=t["mask_cntxt"],
                 mask_trgt=t["mask_trgt"], y_trgt=t["Y_trgt"], eps=eps)
        ll = -npml_loss(out, t["Y_trgt"], t["mask_trgt"], use_iw=False).numpy()
    atol = 2e-3 if "Attn" in name else 5e-4
    for field in ("loc", "scale"):
        np.testing.assert_allclose(getattr(out.p_yCc, field).numpy(),
                                   np.asarray(getattr(j_out.p_yCc, field)), atol=atol, rtol=0,
                                   err_msg=f"{name} {field}")
    ref = -np.asarray(jax_npml(j_out, b["Y_trgt"], b["mask_trgt"], use_iw=False))
    np.testing.assert_allclose(ll, ref, rtol=1e-4, atol=1e-2)
