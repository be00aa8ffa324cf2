"""The GP harness of the port: the GW and GP loaders' refusal of each
other's summaries (and the GP loader's BatchNorm eps), the GP model
builders and run names, `train_models` writing the JAX package's run layout
(flax reads its parameters back), `SamplePredictor`, `train_gp`'s loop
against `reproduce_gp.py`'s, and `train_gp` / `score_gp` on the CPU.
`tests/test_torch_gp.py` holds the data path to the JAX package."""

import json
import os
from types import SimpleNamespace

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu_torch import score, score_gp, train_gp
from npf_gwwaveform_tpu_torch.configs import (
    gp_model_1d, gp_model_from_summary, gp_model_variant, gw_model_from_summary, parse_variant,
    variant_name,
)
from npf_gwwaveform_tpu_torch.data import datasplit as tds
from npf_gwwaveform_tpu_torch.data import gp as tgp
from npf_gwwaveform_tpu_torch.ops.cnn import BatchNorm
from npf_gwwaveform_tpu_torch.training import params_from_flax, train_models
from npf_gwwaveform_tpu_torch.utils import SamplePredictor

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RESULTS = os.path.join(ROOT, "results")


def _summary(rel):
    with open(os.path.join(RESULTS, rel, "summary.json")) as f:
        return json.load(f)


def test_gw_and_gp_loaders_refuse_each_others_summaries():
    """A GP run's summary (it has a `kernel`): `gw_model_from_summary` and
    `score.load_model` refuse it, naming the GP loader; the GP loader builds
    BatchNorm with the run's own `norm_eps` and refuses a GW summary."""
    rel = os.path.join("RBF_Kernel", "ConvCNP", "run_0")
    with pytest.raises(ValueError, match="gp_model_from_summary"):
        gw_model_from_summary(_summary(rel))
    with pytest.raises(ValueError, match="score_gp.load_model"):
        score.load_model(os.path.join(RESULTS, rel), "cpu")
    with pytest.raises(ValueError, match="gw_model_from_summary"):
        gp_model_from_summary(_summary(os.path.join("GW_time_cond_film_ctx192_d128", "ConvCNP",
                                                     "run_1")))
    for rel, eps in ((rel, 1e-5),
                     (os.path.join("RBF_Kernel", "ConvLNP_ELBOFalse_LatLBFalse_SigLBFalse",
                                   "run_0"), 1e-3)):
        model = score_gp.load_model(os.path.join(RESULTS, rel), "cpu")
        norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
        assert norms and all(m.eps == eps for m in norms), rel


def test_gp_builders_and_names():
    assert variant_name("ConvLNP", True, False, True) == "ConvLNP_ELBOTrue_LatLBFalse_SigLBTrue"
    assert parse_variant("ConvLNP_ELBOTrue_LatLBFalse_SigLBTrue") == (
        "ConvLNP", {"ELBO": True, "LatLB": False, "SigLB": True})
    nb = gp_model_variant("ConvLNP", True, False, False)
    assert (nb.z_dim, nb.is_global, nb.is_q_zCct, nb.min_sigma_pred) == (16, False, True, 1e-4)
    assert (nb.n_z_samples_train, nb.n_z_samples_test, nb.lat_scale_transform) == (1, 16,
                                                                                   "softplus")
    hl = gp_model_variant("ConvLNP", False, True, True, headline_arch=True)
    assert (hl.z_dim, hl.is_global, hl.n_z_samples_train, hl.min_sigma_pred) == (128, True, 16,
                                                                                 0.01)
    cnp = gp_model_1d("ConvCNP")
    assert cnp.n_induced == 192 and cnp.cond_dim == 0
    for name in ("CNP", "LNP", "AttnCNP", "AttnLNP"):  # ported since the set family's slice
        assert type(gp_model_1d(name)).__name__ == name
    lnp = gp_model_variant("LNP", True, True, True)
    assert (lnp.is_q_zCct, lnp.n_z_samples_train, lnp.n_z_samples_test) == (True, 1, 32)
    with pytest.raises(ValueError):
        gp_model_variant("CNP", True, True, True)
    sumo = gp_model_from_summary({"model": "ConvLNP_SUMO", "kernel": "RBF_Kernel"})
    assert (sumo.z_dim, sumo.n_z_samples_train, sumo.min_sigma_pred) == (16, 16, 0.01)


def test_train_models_writes_the_jax_layout(tmp_path):
    """A tiny `train_models` run: the JAX layout's files, params.msgpack
    readable by flax's `from_bytes` into the JAX model's tree, eval.csv one
    log-likelihood a test function."""
    from npf_gwwaveform_tpu.configs import gp_model_1d as jax_gp_model_1d

    s = tgp.GPSampler(kernel="rbf", n_points=16)
    model = gp_model_1d("ConvCNP", r_dim=8)
    out = train_models(datasets={"RBF": tgp.GPDataset(s, 8, is_reuse_across_epochs=False,
                                                      device="cpu")},
                       models={"ConvCNP": model},
                       test_datasets={"RBF": tgp.GPDataset(s, 6, seed=2, device="cpu")},
                       valid_datasets={"RBF": tgp.GPDataset(s, 4, seed=3, device="cpu")},
                       chckpnt_dirname=str(tmp_path), max_epochs=2, batch_size=4, verbose=0,
                       device="cpu")
    run_dir = os.path.join(tmp_path, "RBF", "ConvCNP", "run_0")
    assert set(out) == {"RBF/ConvCNP/run_0"}
    # the port's train state (Adam, the count, the generator) where JAX writes state.msgpack
    assert sorted(os.listdir(run_dir)) == ["eval.csv", "extra_vars.msgpack", "history.json",
                                           "model_summary.txt", "params.msgpack",
                                           "train_state.pt"]
    assert np.loadtxt(os.path.join(run_dir, "eval.csv")).shape == (4,)
    with open(os.path.join(run_dir, "history.json")) as f:
        hist = json.load(f)
    assert [h["epoch"] for h in hist] == [1, 2] and all("valid_loss" in h for h in hist)
    jm = jax_gp_model_1d("ConvCNP", r_dim=8)
    x = np.linspace(-1, 1, 16, dtype=np.float32)[None, :, None]
    tmpl = jm.init(jax.random.PRNGKey(0), x, x, x, train=False)
    with open(os.path.join(run_dir, "params.msgpack"), "rb") as f:
        params = flax.serialization.from_bytes(tmpl["params"], f.read())
    with open(os.path.join(run_dir, "extra_vars.msgpack"), "rb") as f:
        flax.serialization.from_bytes({"batch_stats": tmpl["batch_stats"]}, f.read())
    got = params_from_flax(jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(params)))
    trained = out["RBF/ConvCNP/run_0"].model.state_dict()
    assert all(torch.equal(got[k], trained[k]) for k in got)


def test_sample_predictor():
    model = gp_model_1d("ConvLNP", r_dim=8)
    s = tgp.GPSampler(kernel="rbf", n_points=16)
    x, y = s.sample(torch.Generator().manual_seed(0), 2)
    batch = tds.CntxtTrgtSplitter(tds.GetRandomIndcs(0.0, 8))(torch.Generator(), x, y)
    pred = SamplePredictor(model, seed=1)
    loc = pred(batch)
    assert loc.shape == (32, 2, 16, 1) and not model.training
    dist = SamplePredictor(model, is_dist=True, seed=1)(batch)
    assert torch.equal(dist.loc, loc)


def test_train_gp_and_score_gp_on_the_cpu(tmp_path, capsys):
    """`train_gp --device cpu`, two steps of the GP ConvCNP (the JAX run
    layout and `reproduce_gp.py`'s summary fields), then `score_gp` on it
    with `--out` (never the run directory), and `score_gp --bf16` on it."""
    summary = train_gp.main(["--device", "cpu", "--model", "ConvCNP", "--epochs", "1",
                             "--fns-per-epoch", "64", "--n-test", "4", "--norm-eps", "1e-5",
                             "--init", "realized", "--out", str(tmp_path)])
    run_dir = os.path.join(tmp_path, "RBF_Kernel", "ConvCNP", "run_0")
    assert sorted(os.listdir(run_dir)) == ["eval.csv", "extra_vars.msgpack", "history.json",
                                           "model_summary.txt", "params.msgpack", "summary.json"]
    rec = _summary(os.path.join("RBF_Kernel", "ConvCNP", "run_0"))
    assert set(rec) <= set(summary)
    assert (summary["model"], summary["n_test"], summary["steps"]) == ("ConvCNP", 4, 2)
    assert summary["norm_eps"] == 1e-5 and summary["init"] == "realized"
    with open(os.path.join(run_dir, "model_summary.txt")) as f:
        assert f.read().rstrip().endswith("n_params: 276612")
    capsys.readouterr()
    out_dir = os.path.join(tmp_path, "rescored")
    line = score_gp.main(["--device", "cpu", "--run-dir", run_dir, "--n-test", "4",
                          "--out", out_dir])
    assert line["n"] == 4 and np.isfinite(line["mean_ll"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    assert sorted(os.listdir(out_dir)) == ["eval.csv", "summary.json"]
    with pytest.raises(SystemExit):
        score_gp.main(["--device", "cpu", "--run-dir", run_dir, "--out", run_dir])
    line16 = score_gp.main(["--device", "cpu", "--run-dir", run_dir, "--n-test", "4", "--bf16"])
    assert line16["n"] == 4 and np.isfinite(line16["mean_ll"])
    with pytest.raises(SystemExit):
        train_gp.main(["--device", "cpu", "--ablation", "ELBOTrue_LatLBTrue_SigLBTrue"])


def test_train_gp_restores_the_best_parameters_over_the_final_statistics(monkeypatch):
    """As `reproduce_gp.py` does: the parameters of the best valid check
    come back, the BatchNorm statistics stay the final ones; the best
    check's statistics are returned beside them."""
    model = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.BatchNorm1d(2))
    for p in model.parameters():  # whole numbers, so that each sum is exact
        torch.nn.init.zeros_(p)

    def steps(sample, n):  # each chunk moves every parameter and statistic by 1
        with torch.no_grad():
            for t in [*model.parameters(), model[1].running_mean]:
                t.add_(1.0)
        return torch.zeros(n)

    trainer = SimpleNamespace(model=model, state=SimpleNamespace(generator=torch.Generator()),
                              train_steps_generated=steps)
    checks = iter([3.0, 1.0, 2.0])  # the second of three supers is the best
    monkeypatch.setattr(train_gp, "valid_loss", lambda *a: next(checks))
    w0, m0 = model[0].weight.clone(), model[1].running_mean.clone()
    history, _, best_v, best_stats = train_gp.train(trainer, "RBF_Kernel", 1, 300, 2,
                                                    per_super=1, verbose=False)
    assert len(history) == 3 and best_v == 1.0
    assert torch.equal(model[0].weight, w0 + 2) and torch.equal(model[1].running_mean, m0 + 3)
    assert torch.equal(best_stats["1.running_mean"], m0 + 2)


def test_train_gp_schedule_is_reproduce_gps():
    """Whole supers of 50-step chunks: 100 epochs of 1,562 steps train
    160,000 steps in 40 supers of 80 chunks; a short run one chunk of its
    steps."""
    assert train_gp.schedule(100, 50_000, 32, 80) == dict(
        steps_per_epoch=1562, chunk=50, per_super=80, n_super=40, steps=160_000)
    assert train_gp.schedule(1, 64, 32, 80)["steps"] == 2
    assert train_gp.run_name("ConvLNP", "ELBOFalse_LatLBTrue_SigLBFalse") == (
        "ConvLNP_ELBOFalse_LatLBTrue_SigLBFalse")
    assert train_gp.run_name("ConvLNP", loss="sumo") == "ConvLNP_SUMO"
    s = train_gp.train_summary("ConvLNP", "All_Kernels", ablation="ELBOTrue_LatLBTrue_SigLBTrue")
    assert s["ablation_arch"] == "notebook" and s["kernel"] == "All_Kernels"
