"""Training the set and attention family in the port on the CPU: two steps of
each `reproduce_gp.py` configuration through `train_gp` (CNP, LNP and
AttnLNP with NPVI, AttnCNP, an NPML ablation variant of each latent
family, SUMO on LNP's and AttnLNP's NPML variants), each writing the JAX
run layout with the record's summary fields and the architecture's
parameter count; and the train state of `train_models` (ROADMAP section
3.15): a run stopped after two epochs and continued with
`is_continue_train` takes the same steps as an uninterrupted four-epoch
run, loss for loss and parameter for parameter, bit for bit (Adam's
moments, the update count and the trainer's generator come back from
`train_state.pt`); without it, Adam restarts and the steps part.

The valid set of `train_gp` is cut from 1,024 functions to 64 here, so that
an LNP's 32 draws keep the file under its time on one thread.
"""

import json
import os

import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu_torch import train_gp
from npf_gwwaveform_tpu_torch.configs import gp_model_1d
from npf_gwwaveform_tpu_torch.data.gp import GPDataset, GPSampler
from npf_gwwaveform_tpu_torch.losses import ELBOLossLNPF
from npf_gwwaveform_tpu_torch.training import train as train_mod
from npf_gwwaveform_tpu_torch.training.checkpoint import TRAIN_STATE
from npf_gwwaveform_tpu_torch.training.train import train_models

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RESULTS = os.path.join(ROOT, "results")
# (flags, the run directory's model name, a recorded run of the same configuration)
CONFIGS = {
    "CNP": ([], "CNP", "RBF_Kernel/CNP/run_0"),
    "LNP": (["--model", "LNP"], "LNP", "RBF_Kernel/LNP/run_0"),
    "AttnCNP": (["--model", "AttnCNP"], "AttnCNP", "RBF_Kernel/AttnCNP/run_0"),
    "AttnLNP": (["--model", "AttnLNP"], "AttnLNP", "RBF_Kernel/AttnLNP/run_0"),
    "LNP NPML": (["--model", "LNP", "--ablation", "ELBOFalse_LatLBTrue_SigLBFalse"],
                 "LNP_ELBOFalse_LatLBTrue_SigLBFalse",
                 "RBF_Kernel/LNP_ELBOFalse_LatLBTrue_SigLBFalse/run_0"),
    "AttnLNP NPML": (["--model", "AttnLNP", "--ablation", "ELBOFalse_LatLBFalse_SigLBFalse"],
                     "AttnLNP_ELBOFalse_LatLBFalse_SigLBFalse",
                     "RBF_Kernel/AttnLNP_ELBOFalse_LatLBFalse_SigLBFalse/run_0"),
    "LNP SUMO": (["--model", "LNP", "--loss", "sumo"], "LNP_SUMO", "RBF_Kernel/LNP_SUMO/run_0"),
    "AttnLNP SUMO": (["--model", "AttnLNP", "--loss", "sumo"], "AttnLNP_SUMO", None),
}


def _n_params(rel):
    with open(os.path.join(RESULTS, rel, "model_summary.txt")) as f:
        return f.read().rstrip().rsplit("n_params: ", 1)[1]


@pytest.mark.parametrize("case", list(CONFIGS))
def test_train_gp_two_cpu_steps(case, tmp_path, monkeypatch):
    monkeypatch.setattr(train_gp, "N_VALID", 64)
    flags, name, rel = CONFIGS[case]
    summary = train_gp.main(["--device", "cpu", "--epochs", "1", "--fns-per-epoch", "64",
                             "--n-test", "4", "--out", str(tmp_path), *flags])
    run_dir = os.path.join(tmp_path, "RBF_Kernel", name, "run_0")
    assert sorted(os.listdir(run_dir)) == ["eval.csv", "extra_vars.msgpack", "history.json",
                                           "model_summary.txt", "params.msgpack", "summary.json"]
    assert (summary["model"], summary["n_test"], summary["steps"]) == (name, 4, 2)
    assert np.isfinite(summary["mean_test_ll"]) and np.isfinite(summary["best_valid_loss"])
    if rel is not None:
        with open(os.path.join(RESULTS, rel, "summary.json")) as f:
            record = json.load(f)
        # the record's configuration fields (older records lack some)
        for key in ("model", "kernel", "ablation_arch", "loss"):
            assert summary.get(key) == record.get(key, summary.get(key)), key
        if os.path.exists(os.path.join(RESULTS, rel, "model_summary.txt")):
            with open(os.path.join(run_dir, "model_summary.txt")) as f:
                assert f.read().rstrip().endswith("n_params: " + _n_params(rel))


def test_train_gp_defaults_to_cnp_and_refuses_a_deterministic_ablation():
    assert train_gp.parser().parse_args([]).model == "CNP"
    assert train_gp.train_summary()["model"] == "CNP"
    for model in ("CNP", "AttnCNP"):
        with pytest.raises(ValueError):
            train_gp.train_summary(model, loss="sumo")
    assert train_gp.build_trainer(train_gp.train_summary("AttnLNP"), 1, 2, "cpu"
                                  ).state.optimizer.grad_clip_norm is None


def _train(run_dir, epochs, **kw):
    """A small AttnLNP (NPVI) on a fixed chunk of 64 RBF functions, batches
    of 16, no valid set (a checkpoint every epoch), no decay."""
    data = GPDataset(GPSampler(kernel="rbf", n_points=16), 64, seed=0, device="cpu")
    (trainer,) = train_models(
        datasets={"RBF": data}, models={"AttnLNP": gp_model_1d("AttnLNP", r_dim=16)},
        criterion=ELBOLossLNPF(), chckpnt_dirname=str(run_dir), max_epochs=epochs,
        batch_size=16, decay_lr=None, verbose=0, device="cpu", **kw).values()
    with open(os.path.join(run_dir, "RBF", "AttnLNP", "run_0", "history.json")) as f:
        losses = [h["train_loss"] for h in json.load(f)]
    return trainer, losses


def test_a_continued_run_equals_an_uninterrupted_one(tmp_path):
    whole, whole_losses = _train(tmp_path / "whole", 4)
    _train(tmp_path / "split", 2)
    assert os.path.exists(tmp_path / "split" / "RBF" / "AttnLNP" / "run_0" / TRAIN_STATE)
    cont, cont_losses = _train(tmp_path / "split", 2, is_continue_train=True)
    assert cont_losses == whole_losses[2:]
    assert cont.state.step == whole.state.step == 16
    assert cont.state.optimizer.count.item() == 16
    for (n, p), q in zip(whole.model.named_parameters(), cont.model.parameters()):
        assert torch.equal(p, q), n
    # a run that only reloads (no `is_retrain`) returns at once with the state
    again, _ = _train(tmp_path / "split", 2, is_retrain=False)
    assert again.state.step == 16


def test_without_the_train_state_adam_restarts(tmp_path):
    whole, whole_losses = _train(tmp_path / "whole", 4)
    _train(tmp_path / "split", 2)
    os.remove(tmp_path / "split" / "RBF" / "AttnLNP" / "run_0" / TRAIN_STATE)
    cont, cont_losses = _train(tmp_path / "split", 2, is_continue_train=True)
    assert cont.state.step == 8 and cont_losses != whole_losses[2:]
    assert train_mod.has_checkpoint(str(tmp_path / "split" / "RBF" / "AttnLNP" / "run_0"))
