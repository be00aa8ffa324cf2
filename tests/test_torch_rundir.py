"""A port-trained run directory in the JAX package's layout: the files and
summary fields `experiments/reproduce_gw.py` writes, in its formats, and the
scorer taking its thetas from a named run. CPU, 2 train steps at batch 2.

The reference layout is the flagship run `run_1`. The formats are compared
line by line: `np.savetxt`'s `%.18e`, comma-delimited, with the header
`# mismatch,m1,m2,chi1,chi2`. Thetas round-trip through the csv exactly
(float32 written as `%.18e`).
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu_torch import score, train_gw
from npf_gwwaveform_tpu_torch.score import read_run_thetas, score_run, write_scores

torch.set_num_threads(1)

RUN_DIR = os.path.join(os.path.dirname(__file__), "..", "results",
                       "GW_time_cond_film_ctx192_d128", "ConvCNP", "run_1")
RUN_FILES = ("eval.csv", "extra_vars.msgpack", "history.json", "mismatch_theta.csv",
             "model_summary.txt", "params.msgpack", "summary.json")
N_TEST = 4
_FIELD = r"-?\d\.\d{18}e[+-]\d{2}"


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A run trained by the port on the CPU and scored on run_1's first
    N_TEST recorded thetas -> (run_dir, summary)."""
    out = tmp_path_factory.mktemp("runs")
    summary = train_gw.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                             "--n-test", str(N_TEST), "--out", str(out),
                             "--thetas-from", RUN_DIR])
    return str(out / "GW_time_cond_film_ctx192_d128" / "ConvCNP" / "run_0"), summary


def test_port_run_has_the_files_of_the_jax_run(port_run):
    run_dir, _ = port_run
    assert set(RUN_FILES) <= set(os.listdir(RUN_DIR))
    for name in RUN_FILES:
        assert os.path.getsize(os.path.join(run_dir, name)) > 0, name
    text = open(os.path.join(run_dir, "model_summary.txt")).read()
    assert text.startswith("ConvCNP(") and text.endswith("n_params: 368004\n")


@pytest.mark.parametrize("name,n_fields", [("eval.csv", 1), ("mismatch_theta.csv", 5)])
def test_csv_formats_match_the_jax_run(port_run, name, n_fields):
    run_dir, _ = port_run
    ref = open(os.path.join(RUN_DIR, name)).read().splitlines()
    out = open(os.path.join(run_dir, name)).read().splitlines()
    row = re.compile(",".join([_FIELD] * n_fields) + "$")
    if n_fields == 5:
        assert out[0] == ref[0] == "# mismatch,m1,m2,chi1,chi2"
        ref, out = ref[1:], out[1:]
    assert len(out) == N_TEST
    for line in ref[:3] + out:
        assert row.match(line), line


def test_summary_has_every_key_of_the_jax_run(port_run):
    run_dir, summary = port_run
    with open(os.path.join(RUN_DIR, "summary.json")) as f:
        ref = json.load(f)
    with open(os.path.join(run_dir, "summary.json")) as f:
        written = json.load(f)
    assert written == summary
    assert set(ref) <= set(written), set(ref) - set(written)
    assert written["steps"] == 2
    ll = np.loadtxt(os.path.join(run_dir, "eval.csv"), delimiter=",")
    table = np.loadtxt(os.path.join(run_dir, "mismatch_theta.csv"), delimiter=",")
    np.testing.assert_allclose(written["test_ll_per_wf"], ll.mean(), rtol=1e-6)
    np.testing.assert_allclose(written["mismatch_median"], np.median(table[:, 0]), rtol=1e-6)
    # one z draw (a ConvCNP): the per-draw fields equal the mixture's, as in run_1
    for zdraw, mixture in (("mismatch_zdraw_median", "mismatch_median"),
                           ("mismatch_zdraw_p90", "mismatch_p90"),
                           ("zdraw_frac_below_0.03", "frac_below_0.03")):
        assert written[zdraw] == written[mixture] and ref[zdraw] == ref[mixture]


def test_the_port_run_is_scored_on_the_named_runs_thetas(port_run):
    run_dir, _ = port_run
    np.testing.assert_array_equal(read_run_thetas(run_dir), read_run_thetas(RUN_DIR)[:N_TEST])


def test_score_thetas_from_scores_another_run_on_exactly_those_thetas(port_run):
    """run_1 scored on the port run's recorded thetas, through the CLI and
    through score_run."""
    run_dir, _ = port_run
    res = score.main(["--run-dir", RUN_DIR, "--thetas-from", run_dir, "--n-test", "100",
                      "--device", "cpu"])
    assert res["n"] == N_TEST and res["thetas_from"] == run_dir
    assert np.isfinite(res["mean_ll"]) and 0.0 <= res["mismatch_p99"] < 1.0
    full = score_run(RUN_DIR, 100, device="cpu", thetas_from=run_dir)
    np.testing.assert_array_equal(full["theta"], read_run_thetas(run_dir))
    assert full["mean_ll"] == res["mean_ll"]


def test_write_scores_round_trips_sampled_thetas(port_run, tmp_path):
    """Without --thetas-from the scorer draws thetas; write_scores records
    them so that read_run_thetas gives exactly those back, and a summary
    merge keeps the training fields."""
    run_dir, summary = port_run
    for name in ("params.msgpack", "extra_vars.msgpack", "summary.json"):
        (tmp_path / name).write_bytes(open(os.path.join(run_dir, name), "rb").read())
    res = score_run(str(tmp_path), 3, device="cpu", seed=7)
    merged = write_scores(str(tmp_path), res)
    np.testing.assert_array_equal(read_run_thetas(str(tmp_path)), res["theta"])
    assert merged["steps"] == summary["steps"] and merged["test_ll_per_wf"] == res["mean_ll"]
    assert res["theta"].dtype == np.float32 and res["theta"].shape == (3, 4)


def test_score_cli_takes_one_source_of_thetas():
    with pytest.raises(SystemExit):
        score.main(["--run-dir", RUN_DIR, "--thetas-from-run", "--thetas-from", RUN_DIR])
