"""The image harness in bfloat16 compute on the CPU: `train_img --bf16`
trains two steps of GridConvCNP (the decoder chain) and of LNP and writes
`reproduce_img.py`'s run layout, a float32 run's summary fields (no dtype), whose flax
files flax reads back into the tree of the JAX model that
`build_model(name, dtype=jnp.bfloat16)` builds; `score_img --bf16`
rescores a recorded run, in float32-identical draws, and `--diag --bf16`
gives zsmms_diag.py's four rows; `run_report bands --img --bf16` prints the
eight image bar runs' bars from tests/jax_bf16_family_gaps.json."""

import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiments.reproduce_img import build_model
from npf_gwwaveform_tpu_torch import run_report, score_img, train_img

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
RESULTS = os.path.join(REPO, "results")
# the fields of a float32 run's summary.json (train_img.run)
FLOAT32_FIELDS = {"model", "dataset", "train_seconds", "imgs_per_sec", "epochs", "eval_protocol",
                  "y_dim", "steps", "seed", "mean_test_ll", "std_test_ll", "n_test"}


@pytest.mark.parametrize("model", ["GridConvCNP", "LNP"])
def test_train_img_bf16_writes_a_run_flax_reads(model, tmp_path):
    args = ["--device", "cpu", "--model", model, "--steps", "2", "--n-test", "2", "--out",
            str(tmp_path)]
    s16 = train_img.main(args + ["--bf16"])
    run_dir = tmp_path / "digits" / model / "run_0"
    for name in ("eval.csv", "model_summary.txt", "history.json", "params.msgpack",
                 "extra_vars.msgpack", "summary.json", "train_state.pt"):
        assert (run_dir / name).exists(), name
    assert s16["steps"] == 2 and np.isfinite(s16["mean_test_ll"])
    assert set(s16) == FLOAT32_FIELDS
    jm = build_model(model, dtype=jnp.bfloat16)
    y = np.zeros((1, 32, 32, 1), np.float32)
    m = np.ones((1, 32, 32), bool)
    if model == "LNP":
        x = np.zeros((1, 1024, 2), np.float32)
        args_ = (x, y.reshape(1, 1024, 1), x, y.reshape(1, 1024, 1))
        kw = dict(mask_cntxt=m.reshape(1, -1), mask_trgt=m.reshape(1, -1))
    else:
        args_ = (m[..., None], y, m[..., None], y)
        kw = dict(mask_cntxt=m, mask_trgt=m)
    v = jm.init({"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)}, *args_,
                train=False, **kw)
    params = flax.serialization.from_bytes(v["params"], (run_dir / "params.msgpack").read_bytes())
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(v["params"])
    model16 = score_img.load_model(str(run_dir), "cpu", dtype=torch.bfloat16)
    assert model16.dtype == torch.bfloat16 and model16.training is False


def test_score_img_bf16_and_diag():
    run = os.path.join(RESULTS, "digits", "GridConvCNP", "run_0")
    l32 = score_img.main(["--run-dir", run, "--n-test", "4", "--device", "cpu"])
    l16 = score_img.main(["--run-dir", run, "--n-test", "4", "--device", "cpu", "--bf16"])
    assert l16["n"] == 4 and np.isfinite(l16["mean_ll"])
    assert l16["mean_ll"] != l32["mean_ll"] and abs(l16["mean_ll"] - l32["mean_ll"]) < 50.0
    zsmms = os.path.join(RESULTS, "zsmms", "GridConvCNP", "run_1")
    line = score_img.diag(zsmms, "cpu", n_test=32, adapt_passes=2, dtype=torch.bfloat16)
    rows = ("test_canvas", "train_canvas", "test_canvas_batchstats", "test_canvas_adapted")
    assert all(np.isfinite(line[k]) for k in rows)
    assert line["train_canvas"] > line["test_canvas"] + 200  # JAX's rows: 518.0 and -24.2


def test_bands_img_bf16(capsys):
    run_report.main(["bands", "--img", "--bf16", "--results", RESULTS])
    rows = [r for r in capsys.readouterr().out.splitlines() if r.startswith("| `")]
    assert len(rows) == 8 and not any("not taken" in r for r in rows)
    gaps = json.load(open(os.path.join(REPO, "tests", "jax_bf16_family_gaps.json")))
    assert all("bf16_gap" in gaps[os.path.relpath(r, RESULTS)]
               for r in run_report.img_bf16_bar_runs(RESULTS))
