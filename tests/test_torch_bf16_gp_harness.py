"""The GP harness in bfloat16 compute on the CPU: `train_gp --bf16` trains
two steps of the GP ConvCNP (K1, the decoder chain) and of AttnLNP (the
transformer cross-attention, q(z|C,T)) and writes `reproduce_gp.py`'s run
layout, the summary a float32 run's fields (that script records no dtype),
whose flax files flax reads back into the JAX bf16 model's tree; `score_gp
--bf16` rescores the run it wrote; `profile_score` and `profile_train` take
`--bf16` on a GP run (they need the card, so only their refusal without
one is run here); `run_report bands --gp --bf16` prints the 13 GP bar runs'
bars from tests/jax_bf16_family_gaps.json. The valid check runs on 16
functions (`train_gp.N_VALID`) to keep the CPU's time."""

import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu.configs import gp_model_1d as jax_gp_model_1d
from npf_gwwaveform_tpu_torch import profile_score, profile_train, run_report, score_gp, train_gp

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
RESULTS = os.path.join(REPO, "results")


@pytest.mark.parametrize("model", ["ConvCNP", "AttnLNP"])
def test_train_gp_bf16_writes_a_run_flax_reads(model, tmp_path, monkeypatch):
    monkeypatch.setattr(train_gp, "N_VALID", 16)
    args = ["--device", "cpu", "--model", model, "--epochs", "1", "--fns-per-epoch", "64",
            "--n-test", "2", "--out", str(tmp_path)]
    s16 = train_gp.main(args + ["--bf16"])
    run_dir = tmp_path / "RBF_Kernel" / model / "run_0"
    for name in ("eval.csv", "history.json", "model_summary.txt", "params.msgpack",
                 "extra_vars.msgpack", "summary.json"):
        assert (run_dir / name).exists(), name
    assert s16["steps"] == 2 and np.isfinite(s16["mean_test_ll"])
    assert json.loads((run_dir / "summary.json").read_text()) == s16
    s32 = train_gp.main(args + ["--run", "1"])
    assert set(s16) == set(s32)
    jm = jax_gp_model_1d(model, dtype=jnp.bfloat16)
    x = np.zeros((1, 8, 1), np.float32)
    v = jm.init({"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)}, x, x, x, x,
                train=False)
    params = flax.serialization.from_bytes(v["params"], (run_dir / "params.msgpack").read_bytes())
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(v["params"])
    assert all(np.asarray(a).dtype == np.float32 for a in jax.tree_util.tree_leaves(params))
    line = score_gp.main(["--run-dir", str(run_dir), "--n-test", "2", "--device", "cpu",
                          "--bf16"])
    assert line["n"] == 2 and np.isfinite(line["mean_ll"])
    assert score_gp.load_model(str(run_dir), "cpu", dtype=torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("main", [profile_score.main, profile_train.main])
def test_profilers_take_bf16_on_a_gp_run(main):
    """The flag parses on a GP run; without a card they stop before any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the profilers would run")
    run = os.path.join(RESULTS, "RBF_Kernel", "ConvCNP", "run_0")
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["--run-dir", run, "--bf16"])


def test_bands_gp_bf16(capsys):
    run_report.main(["bands", "--gp", "--bf16", "--results", RESULTS])
    rows = [r for r in capsys.readouterr().out.splitlines() if r.startswith("| `")]
    assert len(rows) == 13 and not any("not taken" in r for r in rows)
    gaps = json.load(open(os.path.join(REPO, "tests", "jax_bf16_family_gaps.json")))
    for run in run_report.gp_bf16_bar_runs(RESULTS):
        gap = gaps[os.path.relpath(run, RESULTS)]["bf16_gap"]
        centre, half = run_report.bf16_gap_bar(gap)
        assert centre == gap["fused"]["d_mean_ll"] and half >= run_report.BF16_GAP_TOL
    with pytest.raises(SystemExit):
        run_report.main(["bands", "--bf16"])
