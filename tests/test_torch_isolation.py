"""The port runs without JAX: with jax, flax, msgpack and the JAX package made
unimportable, every module of the port and chip_smoke.py's module-level code
import, the scorer runs on the CPU, and `train_gw` trains 2 steps on the CPU
and scores its run; the set and attention family's modules (attention,
self-attention, CNP, LNP, AttnCNP, AttnLNP) import, `score_gp` scores an
AttnLNP run and `train_gp` trains 2 steps of LNP; the image family's
modules import with sklearn blocked too (the digits ship with the port),
`score_img` scores a digits GridConvLNP run and `train_img` trains 2 steps
of GridConvCNP; in bfloat16, `score_gp --bf16` scores a ConvLNP run,
`score_img --bf16` an AttnCNP run, and `train_gp --bf16` and `train_img
--bf16` train 2 steps; `eval_extrapolation` scores one model on 2
functions and `gw_eval_ctx` sweeps one count on 2 waveforms, with
matplotlib, pandas, PIL, imageio and seaborn blocked as well (every test
here blocks them). Also: chip_smoke.py fails, printing no result, where
it cannot run; and a train step on a 2-rank gloo mesh runs in ranks that
have JAX, flax and the JAX package blocked."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
RUN_DIR = os.path.join(REPO, "results", "GW_time_cond_film_ctx192_d128", "ConvCNP", "run_1")

# the JAX package and what the card's machine lacks: its plotting, table and
# HDF5 libraries (`viz`, `notebooks` and `data.cache` import them inside
# their functions)
_BLOCKED = ("jax", "jaxlib", "flax", "msgpack", "scipy", "h5py", "npf_gwwaveform_tpu",
            "matplotlib", "pandas", "PIL", "imageio", "seaborn")

_ISOLATED = f"""
import sys
for name in {_BLOCKED!r}:
    sys.modules[name] = None  # any import of it now raises ImportError
import importlib, importlib.util, pkgutil, runpy
import npf_gwwaveform_tpu_torch as port
for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(info.name)
spec = importlib.util.spec_from_file_location("chip_smoke", {os.path.join(REPO, "chip_smoke.py")!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))  # module level only
sys.argv = ["score", "--run-dir", {RUN_DIR!r}, "--n-test", "2", "--thetas-from-run",
            "--device", "cpu"]
runpy.run_module("npf_gwwaveform_tpu_torch.score", run_name="__main__")
loaded = [m for m, v in sys.modules.items() if v is not None
          and m.split(".")[0] in {_BLOCKED!r}]
assert not loaded, loaded
"""


_TRAIN_ISOLATED = f"""
import sys
for name in {_BLOCKED!r}:
    sys.modules[name] = None
import runpy
sys.argv = ["train_gw", "--device", "cpu", "--steps", "2", "--batch", "2", "--n-test", "2",
            "--out", sys.argv[1]]
runpy.run_module("npf_gwwaveform_tpu_torch.train_gw", run_name="__main__")
for name in ("utils.init", "training.optim", "training.state", "training.trainer",
             "training.checkpoint"):
    assert "npf_gwwaveform_tpu_torch." + name in sys.modules, name
loaded = [m for m, v in sys.modules.items() if v is not None
          and m.split(".")[0] in {_BLOCKED!r}]
assert not loaded, loaded
"""


_SET_ISOLATED = f"""
import sys
for name in {_BLOCKED!r}:
    sys.modules[name] = None
import json
from npf_gwwaveform_tpu_torch import score_gp, train_gp
line = score_gp.main(["--run-dir", {os.path.join(REPO, "results", "RBF_Kernel", "AttnLNP",
                                                  "run_0")!r},
                      "--n-test", "2", "--device", "cpu"])
train_gp.N_VALID = 16
summary = train_gp.main(["--device", "cpu", "--model", "LNP", "--epochs", "1",
                         "--fns-per-epoch", "64", "--n-test", "2", "--out", sys.argv[1]])
for name in ("ops.attention", "ops.selfattn", "models.np", "models.attnnp"):
    assert "npf_gwwaveform_tpu_torch." + name in sys.modules, name
loaded = [m for m, v in sys.modules.items() if v is not None
          and m.split(".")[0] in {_BLOCKED!r}]
assert not loaded, loaded
print(json.dumps({{"score": line, "steps": summary["steps"], "ll": summary["mean_test_ll"]}}))
"""


_IMG_ISOLATED = f"""
import sys
for name in {_BLOCKED + ("sklearn",)!r}:
    sys.modules[name] = None
import json
from npf_gwwaveform_tpu_torch import score_img, train_img
line = score_img.main(["--run-dir", {os.path.join(REPO, "results", "digits", "GridConvLNP",
                                                  "run_0")!r},
                       "--n-test", "2", "--device", "cpu"])
summary = train_img.main(["--device", "cpu", "--steps", "2", "--n-test", "2", "--out",
                          sys.argv[1]])
for name in ("data.images", "data.datasplit", "models.gridconvnp", "training.adapt"):
    assert "npf_gwwaveform_tpu_torch." + name in sys.modules, name
loaded = [m for m, v in sys.modules.items() if v is not None
          and m.split(".")[0] in {_BLOCKED + ("sklearn",)!r}]
assert not loaded, loaded
print(json.dumps({{"score": line, "steps": summary["steps"], "ll": summary["mean_test_ll"]}}))
"""


_BF16_ISOLATED = f"""
import sys
for name in {_BLOCKED + ("sklearn",)!r}:
    sys.modules[name] = None
import json
from npf_gwwaveform_tpu_torch import score_gp, score_img, train_gp, train_img
gp = score_gp.main(["--run-dir", {os.path.join(REPO, "results", "RBF_Kernel", "ConvLNP",
                                                "run_0")!r},
                    "--n-test", "1", "--device", "cpu", "--bf16"])
img = score_img.main(["--run-dir", {os.path.join(REPO, "results", "digits", "AttnCNP",
                                                  "run_0")!r},
                      "--n-test", "1", "--device", "cpu", "--bf16"])
train_gp.N_VALID = 16
s_gp = train_gp.main(["--device", "cpu", "--model", "CNP", "--epochs", "1",
                      "--fns-per-epoch", "64", "--n-test", "2", "--out", sys.argv[1], "--bf16"])
s_img = train_img.main(["--device", "cpu", "--steps", "2", "--n-test", "2", "--out",
                        sys.argv[1], "--bf16"])
loaded = [m for m, v in sys.modules.items() if v is not None
          and m.split(".")[0] in {_BLOCKED + ("sklearn",)!r}]
assert not loaded, loaded
print(json.dumps({{"gp": gp, "img": img, "lls": [s_gp["mean_test_ll"], s_img["mean_test_ll"]]}}))
"""


_EVAL_ISOLATED = f"""
import sys
for name in {_BLOCKED!r}:
    sys.modules[name] = None
import json, os
from npf_gwwaveform_tpu_torch import eval_extrapolation, gw_eval_ctx
rows = eval_extrapolation.main(["--device", "cpu", "--kernel", "RBF_Kernel", "--models",
                                "ConvCNP", "--n-test", "2", "--out", sys.argv[1]])
sweep = gw_eval_ctx.main([{RUN_DIR!r}, "--ctx", "16", "--n-test", "2", "--device", "cpu",
                          "--out", sys.argv[1]])
loaded = [m for m, v in sys.modules.items() if v is not None
          and m.split(".")[0] in {_BLOCKED!r}]
assert not loaded, loaded
print(json.dumps({{"extrap": rows, "sweep": sweep}}))
"""


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("PYTHONSTARTUP", None)
    return env


def test_port_imports_and_scores_without_jax():
    proc = subprocess.run([sys.executable, "-c", _ISOLATED], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["n"] == 2 and res["device"] == "cpu"
    assert all(isinstance(res[k], float) for k in ("mean_ll", "median_mismatch"))


def test_train_gw_runs_without_jax(tmp_path):
    proc = subprocess.run([sys.executable, "-c", _TRAIN_ISOLATED, str(tmp_path)], cwd=REPO,
                          env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["steps"] == 2 and isinstance(res["test_ll_per_wf"], float)
    for name in ("params.msgpack", "extra_vars.msgpack", "history.json", "summary.json"):
        assert os.path.exists(os.path.join(res["run_dir"], name)), name


def test_set_family_scores_and_trains_without_jax(tmp_path):
    proc = subprocess.run([sys.executable, "-c", _SET_ISOLATED, str(tmp_path)], cwd=REPO,
                          env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["score"]["n"] == 2 and res["score"]["model"] == "AttnLNP"
    assert res["steps"] == 2 and isinstance(res["ll"], float)


def test_image_family_scores_and_trains_without_jax(tmp_path):
    proc = subprocess.run([sys.executable, "-c", _IMG_ISOLATED, str(tmp_path)], cwd=REPO,
                          env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["score"]["n"] == 2 and res["score"]["model"] == "GridConvLNP"
    assert res["steps"] == 2 and isinstance(res["ll"], float)


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _env()
    env.pop("PYTHONPATH")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_bf16_gp_and_image_families_run_without_jax(tmp_path):
    """`score_gp --bf16` (a ConvLNP run: K1, the latent path), `score_img
    --bf16` (the self-attention AttnCNP), `train_gp --bf16` and `train_img
    --bf16`, none of the JAX package's modules importable."""
    proc = subprocess.run([sys.executable, "-c", _BF16_ISOLATED, str(tmp_path)], cwd=REPO,
                          env=_env(), capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["gp"]["n"] == 1 and res["img"]["n"] == 1
    assert all(isinstance(v, float) for v in res["lls"])


def test_eval_tools_run_without_jax(tmp_path):
    """`eval_extrapolation` (ConvCNP on twice the range, 2 functions) and
    `gw_eval_ctx` (16 contexts, 2 waveforms) on the CPU, none of the JAX
    package's modules nor the plotting and table libraries importable."""
    proc = subprocess.run([sys.executable, "-c", _EVAL_ISOLATED, str(tmp_path)], cwd=REPO,
                          env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    (row,) = res["extrap"]
    assert row["model"] == "ConvCNP" and row["n_test"] == 2
    assert all(isinstance(row[k], float) for k in ("interp_ll_per_fn", "extrap_ll_per_fn"))
    (sweep,) = res["sweep"]
    assert sweep["n_context"] == 16 and isinstance(sweep["p50"], float)
    assert os.path.exists(tmp_path / "extrapolation_RBF_Kernel.json")
    assert os.path.exists(tmp_path / "GW_time_cond_film_ctx192_d128" / "ConvCNP" / "run_1"
                          / "ctx_sweep.json")


def test_mesh_step_runs_without_jax():
    """Two gloo ranks, each with JAX, flax and the JAX package blocked
    before it imports the port (`tests/torch_parallel_worker.py`), run one
    train step of the tiny flagship on a `data` mesh and on `data` x `seq`."""
    from npf_gwwaveform_tpu_torch.parallel.launch import run_ranks

    ranks = run_ranks("torch_parallel_worker:isolated_mesh_step", 2, threads=1, timeout=120)
    assert all(r["loaded"] == [] for r in ranks)
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    assert set(ranks[0]["losses"]) == {"data", "data_seq"}
