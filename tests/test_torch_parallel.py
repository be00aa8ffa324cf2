"""The device mesh of the port (`parallel`, `Trainer(mesh=...)`,
`train_models(mesh=...)`, `multichip`) on the CPU over gloo. Ranks are
processes (`parallel.launch.run_ranks`: a `file://` rendezvous in a
temporary directory, so that xdist workers share no port, and a deadline on
every launch); their functions live in `tests/torch_parallel_worker.py`,
which imports torch and the port only.

- The layout: on JAX's 8-device CPU mesh and on 8 ranks, each rank's rows
  (`shard_batch`) and target slice (`constrain_targets_seq`) are the values
  of the matching addressable shard of JAX's NamedSharding, bit for bit.
- One process against 2 and 4 ranks, 6 steps each, at the JAX package's own
  mesh bar (2e-4, `tests/test_training.py`): CNP, ConvCNP with BatchNorm,
  LNP under NPML with 4 z draws, ConvLNP under the ELBO on data 2 x seq 2,
  a ConvCNP at 25 targets on a seq axis (tensor_split's uneven slices), and
  a homoskedastic CNP (its scale pooled over the seq group's targets); the
  eval step's gathered per-function losses too. One rank is the plain step
  bit for bit.
- A BatchNorm GridConvCNP whose blocks are recomputed in the backward pass
  (`cnn_remat`) on 2 and 4 ranks, each backward on a thread of its own (as
  on CUDA, where the recomputation runs on the autograd engine's device
  thread, outside the step's context): the first step's gradients and the
  loss trace those of one process, within 2e-4.
- The port on a data 4 x seq 2 mesh against JAX's mesh on the same
  parameters and masks: the loss traces within 2e-4.
- `train_models` on 2 ranks: rank 0 alone writes, eval.csv holds every test
  function (the one process's, within 2e-4), and the files load into the
  JAX model's tree.
- `dryrun_multichip` on 2 and 4 CPU ranks; with fewer GPUs than ranks it
  raises. The refusals: an undivided batch, the graphed entry points on a
  gloo mesh, a seq axis under a grid model, a mesh the ranks do not fill,
  remat for a GW model."""

import os
from concurrent.futures import ThreadPoolExecutor

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parallel_worker as worker
from npf_gwwaveform_tpu.configs import _cnn_factory
from npf_gwwaveform_tpu.losses import CNPFLoss as JaxCNPFLoss
from npf_gwwaveform_tpu.models.convnp import ConvCNP as JaxConvCNP
from npf_gwwaveform_tpu.models.np import CNP as JaxCNP
from npf_gwwaveform_tpu.parallel import constrain_targets_seq as jax_constrain_targets_seq
from npf_gwwaveform_tpu.parallel import make_mesh as jax_make_mesh
from npf_gwwaveform_tpu.parallel import shard_batch as jax_shard_batch
from npf_gwwaveform_tpu.training import Trainer as JaxTrainer
from npf_gwwaveform_tpu.training import create_train_state
from npf_gwwaveform_tpu.training import make_optimizer as jax_make_optimizer
from npf_gwwaveform_tpu_torch.losses import CNPFLoss
from npf_gwwaveform_tpu_torch.models import GridConvCNP
from npf_gwwaveform_tpu_torch.multichip import dryrun_multichip, run_trainer, tiny_flagship
from npf_gwwaveform_tpu_torch.parallel import Mesh, make_mesh, shard_batch, use_mesh
from npf_gwwaveform_tpu_torch.parallel.launch import run_ranks
from npf_gwwaveform_tpu_torch.training import Trainer, make_optimizer
from npf_gwwaveform_tpu_torch.training.checkpoint import params_from_flax

torch.set_num_threads(1)

MESH_RTOL = MESH_ATOL = 2e-4  # tests/test_training.py's 1-device against 8-device bar
LAUNCH_S = 120  # a launch's deadline; each takes 5-10 s here

LAYOUTS = ({"data": 8}, {"data": 4, "seq": 2}, {"data": 2, "seq": 4})
TWIN_AXES = {"data": 4, "seq": 2}
RUNS = {
    2: (("cnp", {"data": 2}), ("convcnp_bn", {"data": 2}), ("lnp_npml", {"data": 2}),
        ("convcnp_seq25", {"seq": 2}), ("cnp_pooled", {"data": 1, "seq": 2})),
    4: (("cnp", {"data": 4}), ("convcnp_bn", {"data": 4}), ("lnp_npml", {"data": 2, "seq": 2}),
        ("convlnp_elbo", {"data": 2, "seq": 2}), ("convcnp_seq25", {"seq": 4})),
}


def _key(axes: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in axes.items())


def _in_background(fn, *args, **kwargs):
    """fn(*args, **kwargs) started in a thread -> its future (the ranks are
    processes: the test's own work goes on meanwhile)."""
    pool = ThreadPoolExecutor(max_workers=1)
    future = pool.submit(fn, *args, **kwargs)
    pool.shutdown(wait=False)
    return future


def _split(key, x, y):
    """JAX's side of `worker.fixed_split`."""
    return dict(X_cntxt=x, Y_cntxt=y, mask_cntxt=y[..., 0] > 0.5, X_trgt=x, Y_trgt=y,
                mask_trgt=jnp.ones(x.shape[:2], bool))


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every launch of the module at once, each a future: the cases of
    `RUNS` on 2 and on 4 ranks (the 2 ranks then run `train_models` into a
    directory of their own), the dry runs on 2 and 4 ranks, and 8 ranks
    running the layouts and the port's twin of JAX's data 4 x seq 2 training
    (ConvCNP, r_dim 16, density 16, two k=5 BatchNorm blocks, from one flax
    init, Adam at 1e-3, contexts where y > 0.5 on both sides), while JAX
    trains the same 6 steps on its mesh of 8 CPU devices (-> "jax")."""
    out_dir = str(tmp_path_factory.mktemp("train_models"))
    futures = {("cases", w): _in_background(run_ranks, "torch_parallel_worker:cases_rank", w,
                                            (list(runs), out_dir if w == 2 else None),
                                            threads=1, timeout=LAUNCH_S)
               for w, runs in RUNS.items()}
    futures.update({("dryrun", n): _in_background(dryrun_multichip, n, device="cpu",
                                                  timeout=LAUNCH_S) for n in (2, 4)})
    xs, ys = (t.numpy() for t in worker.case_data(worker.N_POINTS, seed=11))
    jm = JaxConvCNP(y_dim=1, x_dim=1, r_dim=16, density_induced=16,
                    CNNFactory=_cnn_factory(2, kernel_size=5))
    tx = jax_make_optimizer(lr=1e-3, decay_lr=None)
    state = jax.jit(lambda b: create_train_state(jm, tx, b, seed=0))(_split(None, xs[0], ys[0]))
    path = str(tmp_path_factory.mktemp("twin") / "state.pt")
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    torch.save(params_from_flax(to_np(state.params), to_np(dict(state.extra_vars))), path)
    futures["eight"] = _in_background(run_ranks, "torch_parallel_worker:eight_rank", 8,
                                      (list(LAYOUTS), path, TWIN_AXES), threads=1,
                                      timeout=LAUNCH_S)
    trainer = JaxTrainer(jm, JaxCNPFLoss(), tx, splitter=_split, mesh=jax_make_mesh(axes=TWIN_AXES))
    jax_losses = []
    for i in range(worker.STEPS):
        state, m = trainer.train_step(state, xs[i], ys[i])
        jax_losses.append(float(m["loss"]))
    return dict(futures, jax=jax_losses)


@pytest.fixture(scope="module")
def eight_ranks(launched):
    """(each of the 8 ranks' results, JAX's losses)."""
    return launched["eight"].result(), launched["jax"]


@pytest.mark.parametrize("axes", LAYOUTS, ids=_key)
def test_layout_matches_jax_shards(eight_ranks, axes):
    mesh = jax_make_mesh(axes=axes)
    x = np.arange(64, dtype=np.float32).reshape(8, 8, 1)
    sharded = jax_shard_batch(dict(X_cntxt=x, X_trgt=x, Y_trgt=-x, mask_trgt=x[..., 0] > 9), mesh)
    trgt = jax.jit(lambda b: jax_constrain_targets_seq(b, mesh))(sharded)

    def shard(arr, device):
        (s,) = [s for s in arr.addressable_shards if s.device == device]
        return np.asarray(s.data)

    for rank, device in enumerate(mesh.devices.flat):  # JAX's devices in row-major order
        port = eight_ranks[0][rank]["layouts"][_key(axes)]
        assert port["coords"] == [int(c) for c in np.unravel_index(rank, mesh.devices.shape)]
        np.testing.assert_array_equal(port["rows"], shard(sharded["X_cntxt"], device))
        np.testing.assert_array_equal(port["y_trgt"], shard(trgt["Y_trgt"], device))
        np.testing.assert_array_equal(port["mask_trgt"], shard(trgt["mask_trgt"], device))
        assert port["contiguous"]


@pytest.fixture(scope="module")
def mesh_runs(launched):
    return {world: launched[("cases", world)].result() for world in RUNS}


@pytest.mark.parametrize("world,name,axes",
                         [(w, n, a) for w, runs in RUNS.items() for n, a in runs],
                         ids=[f"{w}-{n}-{_key(a)}" for w, runs in RUNS.items() for n, a in runs])
def test_mesh_training_matches_one_process(mesh_runs, world, name, axes):
    ranks = [r[name] for r in mesh_runs[world]]
    assert all(r == ranks[0] for r in ranks)  # every rank reports the global numbers
    ref = worker.train_case(name)
    assert np.isfinite(ref["losses"]).all()
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], rtol=MESH_RTOL, atol=MESH_ATOL)
    assert len(ranks[0]["eval"]) == worker.BATCH
    np.testing.assert_allclose(ranks[0]["eval"], ref["eval"], rtol=MESH_RTOL, atol=MESH_ATOL)


@pytest.mark.parametrize("world", list(RUNS))
def test_remat_under_a_mesh_matches_one_process(mesh_runs, world):
    """The recomputation normalises with the global batch's statistics, as
    the forward did (ops/cnn.py)."""
    ranks = [r["grid_remat"] for r in mesh_runs[world]]
    assert all(r == ranks[0] for r in ranks)
    ref = worker.grid_remat_case()
    assert np.isfinite(ref["losses"]).all()
    grads, ref_grads = np.asarray(ranks[0]["grads"]), np.asarray(ref["grads"])
    assert np.abs(grads - ref_grads).max() <= MESH_RTOL * np.abs(ref_grads).max()
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], rtol=MESH_RTOL, atol=MESH_ATOL)


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_is_the_plain_step_bit_for_bit(one_rank_group):
    """A sum over one rank is a copy: BatchNorm's mean of one rank's means,
    the gradient all-reduce and the target sum change no bit."""
    plain = worker.train_case("convcnp_bn")
    for axes in ({"data": 1}, {"data": 1, "seq": 1}):
        assert worker.train_case("convcnp_bn", axes) == plain


def test_make_mesh_keeps_jax_axis_rules(one_rank_group):
    assert make_mesh(device="cpu").shape == (1,)
    mesh = make_mesh({"data": -1, "seq": 1}, device="cpu")
    assert (mesh.axis_names, mesh.shape, mesh.coords) == (("data", "seq"), (1, 1), (0, 0))
    with pytest.raises(ValueError):
        make_mesh({"data": 2}, device="cpu")
    with pytest.raises(ValueError):
        make_mesh({"data": -1, "seq": -1}, device="cpu")


def test_port_mesh_matches_jax_mesh(eight_ranks):
    ranks, jax_losses = eight_ranks
    assert all(r["twin"] == ranks[0]["twin"] for r in ranks)
    np.testing.assert_allclose(ranks[0]["twin"], jax_losses, rtol=MESH_RTOL, atol=MESH_ATOL)


def test_train_models_on_two_ranks(mesh_runs, tmp_path):
    r0, r1 = (r["train_models"] for r in mesh_runs[2])
    one_dir = worker.train_models_run(str(tmp_path))
    assert r1["writes"] == []
    assert {"save_run_params", "save_train_state", "write_history", "write_model_summary",
            "savetxt"} <= set(r0["writes"])
    run_dir = r0["run_dir"]
    lls = np.loadtxt(os.path.join(run_dir, "eval.csv"), delimiter=",")
    assert lls.shape == (16,)
    np.testing.assert_allclose(lls, np.loadtxt(os.path.join(one_dir, "eval.csv"), delimiter=","),
                               rtol=MESH_RTOL, atol=MESH_ATOL)
    x = np.zeros((2, 16, 1), np.float32)
    mask = np.ones((2, 16), bool)
    template = jax.jit(lambda key: JaxCNP(y_dim=1, x_dim=1, r_dim=16).init(
        key, x, x, x, mask_cntxt=mask, mask_trgt=mask))(jax.random.PRNGKey(0))

    def load(d):
        with open(os.path.join(d, "params.msgpack"), "rb") as f:
            return flax.serialization.from_bytes(template["params"], f.read())

    params, one = load(run_dir), load(one_dir)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(one)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


@pytest.fixture(scope="module")
def dryruns(launched):
    return {n: launched[("dryrun", n)].result() for n in (2, 4)}


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_cpu_ranks(dryruns, n):
    out = dryruns[n]
    assert set(out) == {"data", "data_seq"} and np.isfinite(list(out.values())).all()
    assert out["data_seq"] == pytest.approx(out["data"], rel=MESH_RTOL)


def test_dryrun_multichip_raises_without_the_gpus():
    n = torch.cuda.device_count() + 1 if torch.cuda.is_available() else 2
    with pytest.raises(RuntimeError, match="GPUs"):
        dryrun_multichip(n)


def _mesh(axes: dict, coords, backend="gloo") -> Mesh:
    """A mesh value for one rank, without a process group (no collective
    may run on it)."""
    return Mesh(tuple(axes), tuple(axes.values()), tuple(coords), {}, backend,
                torch.device("cpu"))


def test_shard_batch_refuses_an_undivided_batch():
    mesh = _mesh({"data": 4}, (1,))
    x = torch.arange(8).reshape(8, 1)
    assert shard_batch({"x": x, "none": None}, mesh)["x"].tolist() == [[2], [3]]
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch({"x": x[:6]}, mesh)


def test_graphed_entry_points_refuse_a_gloo_mesh():
    model = tiny_flagship()
    trainer = Trainer(model, CNPFLoss(), make_optimizer(model.parameters()), worker.fixed_split,
                      torch.Generator().manual_seed(0), _mesh({"data": 2}, (0,)))
    x = torch.zeros((4, 16, 1))
    with pytest.raises(ValueError, match="cannot capture gloo"):
        trainer.generated_graph(lambda g: (x, x, None))
    with pytest.raises(ValueError, match="cannot capture gloo"):
        trainer.scanned_graph(x, x)


@pytest.mark.parametrize("run_dir", [None, "results/GW_time_cond_film_ctx192_d128/ConvCNP/run_1"],
                         ids=["flagship", "gw-run"])
def test_remat_refused_for_a_gw_model(run_dir):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run_dir = run_dir and os.path.join(root, run_dir)
    with pytest.raises(ValueError, match="no remat"):
        run_trainer(run_dir, 1, 2, "cpu", remat=True)


def test_grid_model_refuses_a_seq_axis():
    model = GridConvCNP(r_dim=8, cnn_n_blocks=1, cnn_kernel_size=3, conv_kernel_size=3).eval()
    y = torch.rand((2, 4, 4, 1))
    mask = torch.ones((2, 4, 4), dtype=torch.bool)
    with use_mesh(_mesh({"seq": 2}, (0,))), pytest.raises(NotImplementedError, match="ROADMAP"):
        model(mask[..., None], y, mask[..., None])
