"""`run_report`: the recorded scores and bands of the runs in `results/`,
and the training-history table, on the CPU."""

import json
import os

import numpy as np
import pytest

from npf_gwwaveform_tpu_torch import run_report

RESULTS = os.path.join(os.path.dirname(__file__), "..", "results")
RUN_1 = os.path.join(RESULTS, "GW_time_cond_film_ctx192_d128", "ConvCNP", "run_1")


def test_scored_runs_are_the_nineteen():
    """The 19 time-domain runs and, since the frequency-domain data was
    ported, the two frequency-domain runs that hold parameters."""
    runs = run_report.scored_runs(RESULTS)
    assert len(runs) == 21 and runs == sorted(runs)
    assert os.path.join(RESULTS, "GW_time_cond_film_ctx192_d128", "ConvCNP", "run_1") in runs
    freq = [r for r in runs if "GW_freq_ap" in r]
    assert freq == [os.path.join(RESULTS, "GW_freq_ap_cond_film_ctx64", "ConvCNP", "run_0"),
                    os.path.join(RESULTS, "GW_freq_ap_ctx64", "ConvCNP", "run_1")]


def test_flagship_bands_hold_the_record_and_repeat():
    """The bands quoted in the module's docstring, drawn again bit for bit."""
    ll, mm = run_report.recorded_scores(RUN_1)
    assert ll.shape == mm.shape == (2048,)
    bands = run_report.score_bands(RUN_1)
    assert bands == run_report.score_bands(RUN_1)
    (l0, l1), (m0, m1) = bands["mean_ll"], bands["median_mismatch"]
    assert l0 < ll.mean() < l1 and m0 < np.median(mm) < m1
    np.testing.assert_allclose([l0, l1], [883.9, 905.5], rtol=0, atol=0.05)
    np.testing.assert_allclose([m0, m1], [0.00143, 0.00300], rtol=0, atol=5e-6)


def test_history_at_takes_the_entry_and_its_window():
    history = [{"step": s, "train_loss": float(s)} for s in range(50, 10_001, 50)]
    assert run_report.history_at(history, 10_000) == (10_000.0, float(np.mean(
        np.arange(9_050, 10_001, 50))))
    assert run_report.history_at(history, 50_000) == (None, None)


@pytest.mark.parametrize("cmd", ["bands", "history"])
def test_main_prints_a_table(cmd, tmp_path, capsys):
    if cmd == "bands":
        run_report.main(["bands", "--results", RESULTS])
        # the GW ConvCNP runs, then the four GW ConvLNP runs; then, after a
        # blank line, the 21 conv-family GP runs (their LL bands only)
        tables = capsys.readouterr().out.strip().split("\n\n")
        assert [len(t.splitlines()) for t in tables] == [2 + 21 + 4, 2 + 21]
        assert all(line.startswith("|") for t in tables for line in t.splitlines())
        return
    else:
        with open(tmp_path / "history.json", "w") as f:
            json.dump([{"step": s, "train_loss": -1.0} for s in range(50, 50_001, 50)], f)
        run_report.main(["history", "--run", str(tmp_path), "--ref", RUN_1])
        n_rows = len(run_report.HISTORY_STEPS)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 + n_rows and all(line.startswith("|") for line in lines)
    if cmd == "history":
        assert lines[3].startswith("| 50000 | -1.0 | -1.0 |") and "n/a" in lines[4]
