"""`npf_gwwaveform_tpu_torch.data.cache` and `npf_gwwaveform_tpu_torch.notebooks`
against `npf_gwwaveform_tpu.data.cache` and `npf_gwwaveform_tpu.notebooks`:
an HDF5 chunk round trip (each package reads what the other wrote) and
`NotLoadedError`; `train_dev_split` index for index; the GP dataset
builders (names, counts, samplers, seeds), `get_n_cntxt` (1-D and grid,
exactly n contexts), `add_y_dim` and `PRETTY_RENAMER`; `load_all_results`
on a temporary tree, the same DataFrame as JAX's. Everything is exact."""

import functools

import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu import notebooks as jnb
from npf_gwwaveform_tpu.data import cache as jcache
from npf_gwwaveform_tpu.data.images import GridImageDataset as JaxGridImageDataset
from npf_gwwaveform_tpu_torch import notebooks as nb
from npf_gwwaveform_tpu_torch.data import cache
from npf_gwwaveform_tpu_torch.data.datasplit import GridCntxtTrgtSplitter
from npf_gwwaveform_tpu_torch.data.gp import DatasetMerger, GPDataset
from npf_gwwaveform_tpu_torch.data.images import GridImageDataset
from npf_gwwaveform_tpu_torch.models import CNP

torch.set_num_threads(1)

SMALL = dict(n_samples_train=8, n_samples_test=6, n_samples_valid=4, n_points=16, seed=5)


def test_chunk_round_trip_and_not_loaded(tmp_path):
    arrays = {"x": np.arange(12, dtype=np.float32).reshape(3, 4), "n": np.array([1, 2, 3])}
    path = str(tmp_path / "sub" / "cache.hdf5")
    cache.save_chunk(arrays, (path, "test"), idx_chunk=2)
    for load in (cache.load_chunk, jcache.load_chunk):
        got = load(["x", "n"], (path, "test"), idx_chunk=2)
        assert got.keys() == arrays.keys()
        assert all(np.array_equal(got[k], arrays[k]) and got[k].dtype == arrays[k].dtype
                   for k in arrays)
    jcache.save_chunk({"y": np.ones(5)}, path)
    assert np.array_equal(cache.load_chunk(["y"], path)["y"], np.ones(5))
    cache.save_chunk({"y": np.zeros(2)}, path)  # an existing key is replaced
    assert np.array_equal(cache.load_chunk(["y"], path)["y"], np.zeros(2))
    cache.save_chunk(arrays, None)  # nothing to do
    for args in ((["x"], str(tmp_path / "absent.hdf5")), (["z"], (path, "test"), 2),
                 (["x"], (path, "test"), 3), (["x"], None)):
        with pytest.raises(cache.NotLoadedError):
            cache.load_chunk(*args)


@pytest.mark.parametrize("dev_size", [0.25, 3])
def test_train_dev_split_index_for_index(dev_size):
    imgs = np.random.default_rng(0).uniform(0, 1, (13, 4, 4, 1)).astype(np.float32)
    train, dev = cache.train_dev_split(GridImageDataset(imgs), dev_size, seed=7)
    j_train, j_dev = jcache.train_dev_split(JaxGridImageDataset(imgs), dev_size, seed=7)
    assert isinstance(train, GridImageDataset) and isinstance(dev, GridImageDataset)
    assert len(dev) == len(j_dev) == (3 if dev_size == 3 else int(0.25 * 13))
    for got, ref in ((train, j_train), (dev, j_dev)):
        np.testing.assert_array_equal(got.images.numpy(), np.asarray(ref.images))


def _describe(datasets):
    """name -> (n_samples, the sampler's fields, the dataset's reuse flag)."""
    out = {}
    for name, d in datasets.items():
        parts = d.datasets if hasattr(d, "datasets") else [d]
        out[name] = [(p.n_samples, p.sampler.kernel, p.sampler.length_scale,
                      p.sampler.n_points, p.sampler.min_max, p.is_reuse_across_epochs)
                     for p in parts]
    return out


@functools.lru_cache(maxsize=None)
def _jax_builders():
    return {f: getattr(jnb, f)(**SMALL) for f in (
        "get_datasets_single_gp", "get_datasets_variable_hyp_gp", "get_all_gp_datasets",
        "get_datasets_variable_kernel_gp")}


@pytest.mark.parametrize("builder", ["get_datasets_single_gp", "get_datasets_variable_hyp_gp",
                                     "get_all_gp_datasets", "get_datasets_variable_kernel_gp"])
def test_gp_dataset_builders(builder):
    got = getattr(nb, builder)(device="cpu", **SMALL)
    ref = _jax_builders()[builder]
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert list(g) == list(r) and _describe(g) == _describe(r)
    if builder == "get_datasets_variable_kernel_gp":
        assert isinstance(got[0]["All_Kernels"], DatasetMerger)
    else:
        assert all(isinstance(d, GPDataset) for d in got[1].values())
    x, y = next(iter(got[1].values())).get_samples()
    assert x.shape[1:] == y.shape[1:] == (SMALL["n_points"], 1)


def test_get_n_cntxt():
    gen = torch.Generator().manual_seed(0)
    split = nb.get_n_cntxt(7)
    j_split = jnb.get_n_cntxt(7)
    assert (split.contexts_getter.a, split.contexts_getter.b) == (
        j_split.contexts_getter.a, j_split.contexts_getter.b) == (7, 7)
    x = torch.zeros((5, 30, 1))
    batch = split(gen, x, x)
    assert (batch["mask_cntxt"].sum(1) == 7).all() and batch["mask_trgt"].all()
    grid = nb.get_n_cntxt(9, is_1d=False, upscale_factor=2.0)
    j_grid = jnb.get_n_cntxt(9, is_1d=False, upscale_factor=2.0)
    assert isinstance(grid, GridCntxtTrgtSplitter) and grid.upscale_factor == 2.0
    assert (grid.context_masker.a, grid.context_masker.b) == (
        j_grid.context_masker.a, j_grid.context_masker.b) == (9, 9)
    img = torch.zeros((2, 6, 6, 1))
    assert (grid(gen, img)["mask_cntxt"].reshape(2, -1).sum(1) == 9).all()


def test_add_y_dim_and_pretty_names():
    class Data:
        y_dim = 3

    models = nb.add_y_dim({"CNP": functools.partial(CNP, r_dim=8)},
                          {"rgb": Data(), "gp": object()})
    assert list(models) == ["rgb", "gp"]
    assert models["rgb"]["CNP"].y_dim == 3 and models["gp"]["CNP"].y_dim == 1
    assert models["rgb"]["CNP"].decoder is not models["gp"]["CNP"].decoder
    assert nb.PRETTY_RENAMER == jnb.PRETTY_RENAMER


def test_load_all_results_equals_jax(tmp_path):
    import pandas as pd

    rng = np.random.default_rng(3)
    for rel, n in (("RBF_Kernel/CNP/run_0", 5), ("RBF_Kernel/CNP/run_1", 4),
                   ("digits/GridConvCNP/run_0", 3), ("deep/GW/ConvCNP/run_2", 6)):
        d = tmp_path / rel
        d.mkdir(parents=True)
        np.savetxt(d / "eval.csv", rng.normal(size=n), delimiter=",")
    (tmp_path / "top").mkdir()
    np.savetxt(tmp_path / "top" / "eval.csv", np.ones(2), delimiter=",")  # too shallow
    got = nb.load_all_results(str(tmp_path))
    ref = jnb.load_all_results(str(tmp_path))
    assert len(got) == 4 and set(got["data"]) == {"RBF_Kernel", "digits", "GW"}
    pd.testing.assert_frame_equal(got, ref)
