"""Mid-run checkpoints and `--resume-from` in `train_gw`, against
`experiments/reproduce_gw.py`: checkpoints after the chunks where its rule
writes them, a resumed run starting from the source's parameters bit for
bit (a JAX run directory or a port run), `resumed_from` recorded, the run's
own directory refused, and the resumed run's files readable by the JAX
package. CPU, the flagship configuration at batch 2.

Tolerance: the JAX model on a port-written resumed run gives the port's
predictives within 5e-4, the README's parity bar.
"""

import json
import os

import flax.serialization
import jax
import numpy as np
import optax
import pytest
import torch

from npf_gwwaveform_tpu.configs import gw_model_from_summary as jax_gw_model_from_summary
from npf_gwwaveform_tpu.training import create_train_state
from npf_gwwaveform_tpu.training import load_run_params as jax_load_run_params
from npf_gwwaveform_tpu_torch import train_gw
from npf_gwwaveform_tpu_torch.configs import gw_train_summary
from npf_gwwaveform_tpu_torch.score import load_model
from npf_gwwaveform_tpu_torch.training.checkpoint import load_run_params, params_from_flax

torch.set_num_threads(1)

RUN_1 = os.path.join(os.path.dirname(__file__), "..", "results", "GW_time_cond_film_ctx192_d128",
                     "ConvCNP", "run_1")
PRED_ATOL = 5e-4
TAG = os.path.join("GW_time_cond_film_ctx192_d128", "ConvCNP")


def _jax_checkpoint_chunks(steps, chunk=50):
    """The chunks `reproduce_gw.py` checkpoints after (`:336-379`), its
    chunk of 50 steps taken as `chunk`: its chunk 0 compiles, then chunk i
    of n_chunks = max(1, steps // inner) writes when i % max(1, n_chunks //
    10) == 0."""
    inner = max(1, min(chunk, steps))
    n_chunks = max(1, steps // inner)
    return [i for i in range(1, n_chunks) if i % max(1, n_chunks // 10) == 0]


@pytest.mark.parametrize("steps", [1, 7, 50, 100, 130, 1000, 1049, 20_000, 200_000])
def test_checkpoint_chunks_follow_the_jax_rule(steps):
    assert train_gw.checkpoint_chunks(steps) == _jax_checkpoint_chunks(steps)


def test_checkpoint_chunks_of_a_full_run():
    assert train_gw.checkpoint_chunks(200_000) == list(range(400, 4000, 400))


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_a_short_run_writes_its_checkpoints_where_jax_does(tmp_path, monkeypatch):
    """Chunks of one step (12 steps, so checkpoints after chunks 1..11): each
    write holds the model as it stood after that chunk, and the last one
    loads back bit for bit."""
    monkeypatch.setattr(train_gw, "HISTORY_EVERY", 1)
    written = []
    save = train_gw.save_run_params

    def recording(run_dir, model):
        written.append((len(written), _state(model)))
        save(run_dir, model)

    monkeypatch.setattr(train_gw, "save_run_params", recording)
    summary = gw_train_summary()
    trainer = train_gw.build_trainer(summary, 12, "cpu")
    history, *_ = train_gw.train(trainer, summary, 12, 2, checkpoint_dir=str(tmp_path))
    assert [h["step"] for h in history] == list(range(1, 13))
    assert len(written) == len(_jax_checkpoint_chunks(12, chunk=1)) == 11
    final = _state(trainer.model)
    _, last = written[-1]  # after chunk 11, the last: the trained model
    loaded = params_from_flax(*load_run_params(str(tmp_path)))
    assert loaded.keys() == final.keys()
    for k in final:
        assert torch.equal(loaded[k], final[k]) and torch.equal(last[k], final[k]), k
    assert not torch.equal(written[0][1]["decoder.module.out.weight"], final["decoder.module.out.weight"])


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("runs")
    run_dir, _ = train_gw.run(2, batch=2, device="cpu", out=str(out), n_test=2)
    return str(out), run_dir


@pytest.mark.parametrize("source", ["port", "jax"])
def test_a_resumed_model_starts_from_its_source_bit_for_bit(port_run, source):
    """Loaded in place: the model's tensors keep their storage (a graph
    captured on them reads the loaded values) and hold the source's
    parameters and BatchNorm statistics exactly; its eval forward is the
    source's."""
    src = port_run[1] if source == "port" else RUN_1
    trainer = train_gw.build_trainer(gw_train_summary(), 4, "cpu", seed=3)
    before = {k: v.data_ptr() for k, v in trainer.model.state_dict().items()}
    train_gw.load_params_into(trainer.model, src)
    state = trainer.model.state_dict()
    ref = params_from_flax(*load_run_params(src))
    assert state.keys() == ref.keys()
    for k, v in state.items():
        assert v.data_ptr() == before[k] and torch.equal(v, ref[k]), k
    rng = np.random.default_rng(0)
    x = torch.linspace(-1, 1, 256)[None, :, None].expand(2, 256, 1)
    y = torch.from_numpy(rng.normal(size=(2, 256, 1)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=(2, 256)) < 0.3)
    cond = torch.from_numpy(rng.uniform(-1, 1, (2, 4)).astype(np.float32))
    with torch.no_grad():
        a = trainer.model.eval()(x, y, x, mask_cntxt=mask, condition=cond).p_yCc
        b = load_model(src, "cpu")(x, y, x, mask_cntxt=mask, condition=cond).p_yCc
    assert torch.equal(a.loc, b.loc) and torch.equal(a.scale, b.scale)


def test_resume_records_its_source_and_refuses_its_own_directory(port_run):
    out, src = port_run
    with pytest.raises(ValueError, match="own output dir"):
        train_gw.run(2, batch=2, device="cpu", out=out, run_index=0, resume_from=src + "/")
    with pytest.raises(SystemExit):
        train_gw.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--out", out,
                       "--run", "0", "--resume-from", src])
    run_dir, summary = train_gw.run(2, batch=2, device="cpu", out=out, run_index=1,
                                    n_test=2, resume_from=src)
    assert run_dir == os.path.join(out, TAG, "run_1")
    with open(os.path.join(run_dir, "summary.json")) as f:
        assert json.load(f)["resumed_from"] == summary["resumed_from"] == src


def test_main_reports_only_the_own_directory_as_a_usage_error(tmp_path, monkeypatch):
    """Any other ValueError from the run reaches the caller with its
    traceback, not as a usage error."""
    def fail(*args):
        raise ValueError("from inside the run")

    monkeypatch.setattr(train_gw, "run", fail)
    with pytest.raises(ValueError, match="from inside the run"):
        train_gw.main(["--device", "cpu", "--steps", "2", "--out", str(tmp_path),
                       "--resume-from", RUN_1])


def test_a_warm_start_from_the_jax_run_loads_into_jax(tmp_path):
    """Warm-started from the JAX package's flagship run_1 for two steps: the
    written run records its source and the JAX package's `load_run_params`
    restores it into a JAX train state that predicts as the port's model."""
    run_dir, summary = train_gw.run(2, batch=2, device="cpu", out=str(tmp_path), n_test=2,
                                    resume_from=RUN_1)
    assert summary["resumed_from"] == RUN_1
    jm = jax_gw_model_from_summary(summary)
    rng = np.random.default_rng(1)
    x = np.broadcast_to(np.linspace(-1, 1, 256, dtype=np.float32)[None, :, None],
                        (2, 256, 1)).copy()
    y = rng.normal(size=(2, 256, 1)).astype(np.float32)
    mask_c = rng.uniform(size=(2, 256)) < 0.3
    mask_t = np.ones((2, 256), bool)
    cond = rng.uniform(-1, 1, (2, 4)).astype(np.float32)
    batch = {"X_cntxt": x, "Y_cntxt": y, "X_trgt": x, "Y_trgt": y, "mask_cntxt": mask_c,
             "mask_trgt": mask_t, "condition": cond}
    state = create_train_state(jm, optax.adam(1e-3), batch, seed=0)
    state = jax_load_run_params(run_dir, state)
    out = jax.jit(jm.apply, static_argnames="train")(
        {"params": state.params, **state.extra_vars}, x, y, x, mask_cntxt=mask_c,
        mask_trgt=mask_t, condition=cond, train=False)
    model = load_model(run_dir, "cpu")
    with torch.no_grad():
        t = model(*(torch.from_numpy(a) for a in (x, y, x, mask_c, mask_t, cond)))
    np.testing.assert_allclose(t.p_yCc.loc.numpy(), np.asarray(out.p_yCc.loc), atol=PRED_ATOL)
    np.testing.assert_allclose(t.p_yCc.scale.numpy(), np.asarray(out.p_yCc.scale), atol=PRED_ATOL)
    with open(os.path.join(run_dir, "params.msgpack"), "rb") as f:
        restored = flax.serialization.msgpack_restore(f.read())
    assert restored.keys() == load_run_params(RUN_1)[0].keys()
