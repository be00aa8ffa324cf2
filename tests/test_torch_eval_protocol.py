"""The port's eval protocol against `experiments/reproduce_gw.py`'s: every
run scored on the same draws whatever seed it was trained from, and from
256 on only whole batches of 256 waveforms. CPU.

A run directory of a narrow flagship-shaped model (density 8, k=3; made
here from the port's init) keeps the 300-waveform scoring cheap.
"""

import json
import os

import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu_torch import score, train_gw
from npf_gwwaveform_tpu_torch.configs import gw_model_from_summary, gw_train_summary
from npf_gwwaveform_tpu_torch.training.checkpoint import save_run_params
from npf_gwwaveform_tpu_torch.utils.init import init_module

torch.set_num_threads(1)


@pytest.fixture
def recorded_splits(monkeypatch):
    """The context masks of every eval batch `score_run` splits, in order."""
    masks = []
    make = score.eval_splitter

    def eval_splitter(n_context):
        split = make(n_context)

        def recording(generator, x, y, condition=None):
            batch = split(generator, x, y, condition=condition)
            masks.append(batch["mask_cntxt"].clone())
            return batch
        return recording

    monkeypatch.setattr(score, "eval_splitter", eval_splitter)
    return masks


def test_runs_trained_from_other_seeds_are_scored_on_the_same_draws(tmp_path, recorded_splits):
    """Two runs trained from seeds 0 and 1 (different models) score the same
    drawn thetas with the same context masks: the scorer's draws come from
    `score.EVAL_SEED`, never from the training seed."""
    thetas, summaries = [], []
    for seed in (0, 1):
        run_dir, summary = train_gw.run(2, batch=2, seed=seed, device="cpu",
                                        out=str(tmp_path / f"seed{seed}"), n_test=4)
        thetas.append(np.loadtxt(os.path.join(run_dir, "mismatch_theta.csv"), delimiter=",")[:, 1:])
        summaries.append(summary)
    assert len(recorded_splits) == 2
    assert torch.equal(recorded_splits[0], recorded_splits[1])
    np.testing.assert_array_equal(thetas[0], thetas[1])
    assert summaries[0]["test_ll_per_wf"] != summaries[1]["test_ll_per_wf"]
    assert score.EVAL_SEED == 0


@pytest.fixture(scope="module")
def narrow_run(tmp_path_factory):
    summary = {**gw_train_summary(density=8), "cnn_kernel_size": 3}
    model = gw_model_from_summary(summary)
    init_module(model, torch.Generator().manual_seed(0))
    run_dir = tmp_path_factory.mktemp("narrow")
    save_run_params(str(run_dir), model)
    (run_dir / "summary.json").write_text(json.dumps(summary))
    return str(run_dir)


@pytest.mark.parametrize("n_test,n", [(300, 256), (8, 8), (256, 256), (511, 256), (512, 512)])
def test_score_run_scores_whole_batches_from_256(narrow_run, n_test, n):
    assert score.n_scored(n_test) == n
    out = score.score_run(narrow_run, n_test, device="cpu")
    assert out["n"] == n and out["ll"].shape == out["theta"].shape[:1] == (n,)
    assert np.isfinite(out["ll"]).all()


def test_score_run_on_recorded_thetas_takes_the_first_whole_batches(narrow_run):
    run_1 = os.path.join(os.path.dirname(__file__), "..", "results",
                         "GW_time_cond_film_ctx192_d128", "ConvCNP", "run_1")
    out = score.score_run(narrow_run, 300, thetas_from=run_1, device="cpu")
    np.testing.assert_array_equal(out["theta"], score.read_run_thetas(run_1)[:256])
