"""The image harness in the port on the CPU: `train_img` trains two steps
of GridConvCNP (and of LNP) and writes `reproduce_img.py`'s run layout,
whose flax files flax itself reads back into the JAX model's tree;
`score_img` scores a run and its `--out` is refused inside the run and
under `results/`; `--diag` gives the four rows of a zsmms run;
`adapt_batch_stats` moves the BatchNorm statistics as the JAX package's
does given its own draws (indices and masks); `run_report bands --img`;
each loader refuses the others' summaries."""

import json
import os

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu.data.datasplit import GridCntxtTrgtSplitter as JaxGridSplitter
from npf_gwwaveform_tpu.data.datasplit import RandomMasker as JaxRandomMasker
from npf_gwwaveform_tpu.losses import CNPFLoss as JaxCNPFLoss
from npf_gwwaveform_tpu.models import GridConvCNP as JaxGridConvCNP
from npf_gwwaveform_tpu.ops.cnn import CNN as JaxCNN
from npf_gwwaveform_tpu.training import Trainer as JaxTrainer
from npf_gwwaveform_tpu.training import adapt_batch_stats as jax_adapt
from npf_gwwaveform_tpu.training import create_train_state, make_optimizer
from npf_gwwaveform_tpu_torch import configs, run_report, score_img, train_img
from npf_gwwaveform_tpu_torch.models import GridConvCNP
from npf_gwwaveform_tpu_torch.training import adapt
from npf_gwwaveform_tpu_torch.training.checkpoint import params_from_flax

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
RESULTS = os.path.join(REPO, "results")
DIGITS_CNP = os.path.join(RESULTS, "digits", "CNP", "run_0")
ZSMMS = os.path.join(RESULTS, "zsmms", "GridConvCNP", "run_1")


@pytest.mark.parametrize("model", ["GridConvCNP", "LNP"])
def test_train_img_writes_a_run_flax_reads(model, tmp_path):
    summary = train_img.main(["--device", "cpu", "--model", model, "--steps", "2",
                              "--n-test", "2", "--out", str(tmp_path)])
    run_dir = tmp_path / "digits" / model / "run_0"
    for name in ("eval.csv", "model_summary.txt", "history.json", "params.msgpack",
                 "extra_vars.msgpack", "summary.json", "train_state.pt"):
        assert (run_dir / name).exists(), name
    assert summary["steps"] == 2 and summary["n_test"] == 2 and summary["y_dim"] == 1
    assert np.isfinite(summary["mean_test_ll"])
    assert json.loads((run_dir / "summary.json").read_text())["model"] == model
    from experiments.reproduce_img import build_model

    jm = build_model(model)
    y = np.zeros((1, 32, 32, 1), np.float32)
    m = np.ones((1, 32, 32), bool)
    if model == "LNP":
        x = np.zeros((1, 1024, 2), np.float32)
        args = (x, y.reshape(1, 1024, 1), x, y.reshape(1, 1024, 1))
        kw = dict(mask_cntxt=m.reshape(1, -1), mask_trgt=m.reshape(1, -1))
    else:
        args = (m[..., None], y, m[..., None], y)
        kw = dict(mask_cntxt=m, mask_trgt=m)
    v = jm.init({"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)}, *args,
                train=False, **kw)
    params = flax.serialization.from_bytes(v["params"], (run_dir / "params.msgpack").read_bytes())
    assert (jax.tree_util.tree_structure(params) ==
            jax.tree_util.tree_structure(v["params"]))
    extra = flax.serialization.msgpack_restore((run_dir / "extra_vars.msgpack").read_bytes())
    assert set(extra) == ({"batch_stats"} if model == "GridConvCNP" else set())
    # the port reloads the run it wrote, strictly
    assert score_img.load_model(str(run_dir), "cpu").training is False


def test_score_img_scores_and_refuses_to_write_into_results(tmp_path):
    line = score_img.main(["--run-dir", DIGITS_CNP, "--n-test", "4", "--device", "cpu",
                           "--out", str(tmp_path / "o")])
    assert line["n"] == 4 and line["model"] == "CNP" and np.isfinite(line["mean_ll"])
    written = json.loads((tmp_path / "o" / "summary.json").read_text())
    assert written["rescored_from"] == DIGITS_CNP and written["n_test"] == 4
    again = score_img.main(["--run-dir", DIGITS_CNP, "--n-test", "4", "--device", "cpu"])
    assert again["mean_ll"] == line["mean_ll"]  # the same draws from the same seed
    for out in (DIGITS_CNP, os.path.join(RESULTS, "x")):
        with pytest.raises(SystemExit):
            score_img.main(["--run-dir", DIGITS_CNP, "--device", "cpu", "--out", out])
    with pytest.raises(SystemExit):
        train_img.main(["--device", "cpu", "--out", RESULTS])


def test_diag_gives_the_four_rows():
    """On 32 images of each canvas, three adaptation passes: the rows
    `zsmms_diag.py` writes, finite; the model scores its training canvas far
    above the test canvas (JAX's rows: 518.0 and -24.2)."""
    line = score_img.diag(ZSMMS, "cpu", n_test=32, adapt_passes=3)
    rows = ("test_canvas", "train_canvas", "test_canvas_batchstats", "test_canvas_adapted")
    assert line["model"] == "GridConvCNP" and line["run"] == "run_1"
    assert all(np.isfinite(line[k]) for k in rows)
    assert line["train_canvas"] > line["test_canvas"] + 200
    with pytest.raises(ValueError):
        score_img.diag(DIGITS_CNP, "cpu", n_test=2)


def _small_pair():
    def cnn(r_dim, name=None):
        return JaxCNN(n_channels=r_dim, n_blocks=2, kernel_size=3, norm="batch",
                      block_kwargs={"n_conv_layers": 2}, name=name)
    jm = JaxGridConvCNP(y_dim=1, x_dim=1, r_dim=8, CNNFactory=cnn, conv_kernel_size=5)
    tm = GridConvCNP(r_dim=8, cnn_n_blocks=2, cnn_kernel_size=3, conv_kernel_size=5)
    return jm, tm


def test_adapt_batch_stats_matches_jax_given_its_draws(monkeypatch):
    """Five passes at batch 4 over 10 images of 8x8: the indices and the
    masks are the JAX package's draws; the statistics after each pass's EMA
    equal JAX's to 1e-5, the parameters untouched."""
    images = np.random.default_rng(0).uniform(0, 1, (10, 8, 8, 1)).astype(np.float32)
    jm, tm = _small_pair()
    splitter = JaxGridSplitter(context_masker=JaxRandomMasker(a=0.0, b=0.3, is_indep_n=True))
    trainer = JaxTrainer(jm, JaxCNPFLoss(), make_optimizer(lr=1e-3), splitter=splitter)
    state = create_train_state(jm, trainer.tx, splitter(jax.random.PRNGKey(0), images[:2],
                                                        images[:2]), seed=0)
    key, n_passes, bs = jax.random.PRNGKey(7), 5, 4
    adapted = jax_adapt(trainer, state, jax.numpy.asarray(images), key, n_passes=n_passes,
                        batch_size=bs)
    idx, masks = [], []
    for k in jax.random.split(key, n_passes):
        ki, ks, _ = jax.random.split(k, 3)
        i = np.asarray(jax.random.randint(ki, (bs,), 0, images.shape[0]))
        idx.append(i)
        masks.append(np.asarray(splitter(ks, images[i], images[i])["mask_cntxt"]))
    tm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, state.params),
                                        jax.tree_util.tree_map(np.asarray, state.extra_vars)),
                       strict=True)
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    draws = iter(idx)
    monkeypatch.setattr(adapt.torch, "randint",
                        lambda *a, **k: torch.from_numpy(next(draws).astype(np.int64)))
    grid_masks = iter(masks)

    def port_splitter(g, x, y):
        m = torch.from_numpy(next(grid_masks))
        return dict(X_cntxt=m[..., None], Y_cntxt=y, mask_cntxt=m,
                    X_trgt=torch.ones_like(m)[..., None], Y_trgt=y, mask_trgt=torch.ones_like(m))

    out = adapt.adapt_batch_stats(tm, port_splitter, torch.from_numpy(images),
                                  torch.Generator(), n_passes, bs)
    assert out is tm and not tm.training
    ref = params_from_flax({}, jax.tree_util.tree_map(np.asarray, adapted.extra_vars))
    for k, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), ref[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
    assert all(torch.equal(p, before[k]) for k, p in tm.named_parameters())


def test_bands_img_prints_the_21_runs(capsys):
    run_report.main(["bands", "--img", "--results", RESULTS])
    rows = [r for r in capsys.readouterr().out.splitlines() if r.startswith("| `")]
    assert len(rows) == 21
    assert sum("not rescored" in r for r in rows) == 1
    digits = next(r for r in rows if "digits/GridConvCNP/run_0" in r and "rgb" not in r)
    assert "| 160 | 2675.34 |" in digits


def test_loaders_refuse_each_others_summaries():
    img = {"model": "GridConvCNP", "dataset": "digits"}
    gp = {"model": "ConvCNP", "kernel": "RBF_Kernel"}
    gw = {"model": "ConvCNP", "mode": "time", "conditioned": False}
    assert configs.is_img_summary(img) and not configs.is_img_summary(gp)
    with pytest.raises(ValueError):
        configs.gw_model_from_summary(img)
    with pytest.raises(ValueError):
        configs.gp_model_from_summary(img)
    for other in (gp, gw):
        with pytest.raises(ValueError):
            configs.img_model_from_summary(other)
    assert configs.img_model_from_summary(img).conv.padding == "SAME"
    zs = configs.img_model_from_summary({"model": "GridConvLNP", "dataset": "zsmms"})
    assert zs.conv.padding == "CIRCULAR" and zs.is_global and zs.n_z_samples_test == 32
    xl = configs.img_model("GridConvCNPXL", "rgb_digits128", 3)
    assert xl.induced_to_induced.n_blocks == 12 and xl.decoder.module.out.out_features == 6
    assert isinstance(configs.img_criterion("AttnLNP"), type(configs.img_criterion("GridConvLNP")))
