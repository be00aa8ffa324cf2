"""Run directories and summaries as `experiments/reproduce_gw.py` names and
writes them: `configs.run_tag` of every recorded GW ConvCNP run's
`summary.json` (time-domain and frequency-domain) is its directory's tag (the runs that hold only a summary
included), and `train_gw`'s flags, given as that script was given them,
state the recorded configuration (`configs.train_config`) field for field.
"""

import glob
import json
import os

import pytest

from npf_gwwaveform_tpu_torch import train_gw
from npf_gwwaveform_tpu_torch.configs import gw_train_summary, run_tag, train_config

RESULTS = os.path.join(os.path.dirname(__file__), "..", "results")
RUNS = sorted(glob.glob(os.path.join(RESULTS, "GW_*", "ConvCNP", "run_*")))
# summaries written before reproduce_gw.py recorded n_context: no flags state them
FLAGGED = [r for r in RUNS if "n_context" in json.load(open(os.path.join(r, "summary.json")))]


def _summary(run_dir):
    with open(os.path.join(run_dir, "summary.json")) as f:
        return json.load(f)


def _tag(run_dir):
    return os.path.basename(os.path.dirname(os.path.dirname(run_dir)))


def test_the_recorded_runs_are_all_there():
    """22 time-domain runs (20 with n_context) and three frequency-domain
    ones (`GW_freq_ap_ctx64/run_0` holds only its summary and scores)."""
    tags = {_tag(r) for r in RUNS}
    assert len(RUNS) == 25 and len(FLAGGED) == 23
    assert {"GW_time", "GW_time_cond", "GW_time_ctx64", "GW_freq_ap_cond_film_ctx64",
            "GW_freq_ap_ctx64"} <= tags


@pytest.mark.parametrize("run_dir", RUNS, ids=lambda r: f"{_tag(r)}/{os.path.basename(r)}")
def test_run_tag_names_every_recorded_run(run_dir):
    assert run_tag(_summary(run_dir)) == _tag(run_dir)


def _flags(summary):
    """The `reproduce_gw.py` flags of a recorded configuration, in the
    port's spelling (its defaults are the flagship's, so each is explicit)."""
    flags = ["--mode", summary["mode"], "--n-context", str(summary["n_context"]),
             "--density", str(summary.get("density_induced") or 0)]
    if summary["conditioned"]:
        flags += ["--cond-mode", summary.get("cond_mode") or "add"]
    else:
        flags += ["--no-cond"]
    if "cnn_kernel_size" in summary:
        flags += ["--cnn-kernel", str(summary["cnn_kernel_size"])]
    if "cnn_dilations" in summary:
        flags += ["--cnn-dilations", ",".join(str(d) for d in summary["cnn_dilations"])]
    if "cnn_arch" in summary:
        flags += ["--cnn-arch", summary["cnn_arch"]]
    if "duration" in summary:
        flags += ["--duration", str(summary["duration"]), "--n-points", str(summary["n_points"])]
    if summary.get("use_pallas_setconv"):
        flags += ["--pallas"]
    for key, flag in (("lr", "--lr"), ("decay_lr", "--decay-lr"), ("grad_clip_norm", "--clip")):
        if key in summary:
            flags += [flag, str(summary[key])]
    return flags


@pytest.mark.parametrize("run_dir", FLAGGED, ids=lambda r: f"{_tag(r)}/{os.path.basename(r)}")
def test_train_gw_flags_state_the_recorded_configuration(run_dir):
    recorded = _summary(run_dir)
    summary = train_gw.summary_from_args(train_gw.parser().parse_args(_flags(recorded)))
    assert summary == train_config(recorded)
    assert train_gw.output_dir(summary, "out", 3) == os.path.join("out", _tag(run_dir),
                                                                   "ConvCNP", "run_3")


def test_gw_train_summary_defaults_and_refusals():
    """The flagship by default; JAX's refusal and the unported knobs."""
    assert run_tag(gw_train_summary()) == "GW_time_cond_film_ctx192_d128"
    assert gw_train_summary(cond=False, density=None, n_context=64) == {
        "model": "ConvCNP", "mode": "time", "conditioned": False, "cond_mode": None,
        "n_context": 64}
    with pytest.raises(ValueError):
        gw_train_summary(cnn_arch="unet", cnn_dilations=[1, 1, 2, 4, 8])
    for bad in (dict(model="LNP"), dict(banded=True), dict(remat=True), dict(n_points=512),
                dict(mode="freq_ap", n_points=512)):
        with pytest.raises(NotImplementedError):
            gw_train_summary(**bad)
    with pytest.raises(ValueError):  # JAX's choices are time and freq_ap
        gw_train_summary(mode="freq")
    with pytest.raises(SystemExit):
        train_gw.main(["--device", "cpu", "--cnn-arch", "unet", "--cnn-dilations", "1,2,1,2,1"])


def test_freq_ap_summaries_and_tags():
    """`--mode freq_ap` with reproduce_gw.py's flags of the two recorded
    frequency-domain configurations: their summary fields and tags."""
    film = train_gw.summary_from_args(train_gw.parser().parse_args(
        ["--mode", "freq_ap", "--cond-mode", "film", "--n-context", "64", "--density", "0"]))
    assert film == {"model": "ConvCNP", "mode": "freq_ap", "conditioned": True,
                    "cond_mode": "film", "n_context": 64}
    assert run_tag(film) == "GW_freq_ap_cond_film_ctx64"
    plain = gw_train_summary(mode="freq_ap", cond=False, n_context=64, density=None)
    assert run_tag(plain) == "GW_freq_ap_ctx64"
    assert run_tag(gw_train_summary(mode="freq_ap", cond_mode="add", n_context=32)) == (
        "GW_freq_ap_cond_ctx32_d128")
    assert train_gw.parser().parse_args([]).mode == "time"
    with pytest.raises(SystemExit):
        train_gw.parser().parse_args(["--mode", "freq"])
