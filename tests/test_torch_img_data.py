"""The image corpora, grid maskers and splitters in the port against the
JAX package, bit for bit: the bundled digits array against
`sklearn.datasets.load_digits()` (sklearn in this test only); every corpus
(`digits`, `rgb_digits`, `rgb_digits128`, `zsmms` train and test,
`digits16`) image for image; `RandomMasker` (per-batch and per-image
counts, batch-shared positions) given the JAX package's own count and
score draws; `no_masker`, `ResolutionMasker`, `half_masker`; the grid,
super-resolution and point splitters given the same masks; `grid_to_points`
and the splitter's coordinates with the zsmms upscale 1.6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu.data import datasplit as jds
from npf_gwwaveform_tpu.data import images as jimg
from npf_gwwaveform_tpu_torch.data import datasplit as tds
from npf_gwwaveform_tpu_torch.data import images as timg

torch.set_num_threads(1)

CPU = torch.Generator()


def test_bundled_digits_equal_load_digits():
    from sklearn.datasets import load_digits

    d = load_digits()
    with np.load(timg.DIGITS_FILE) as f:
        assert np.array_equal(f["images"].astype(np.float64), d.images)
        assert np.array_equal(f["target"], d.target)
    imgs, labels = timg._load_sklearn_digits(4)
    ref, ref_labels = jimg._load_sklearn_digits(4)
    assert imgs.dtype == ref.dtype and np.array_equal(imgs, ref)
    assert np.array_equal(labels, ref_labels)


@pytest.mark.parametrize("name", ["digits", "rgb_digits", "rgb_digits128", "zsmms", "digits16"])
def test_corpora_equal_jax(name):
    j_train, j_test = jimg.get_train_test_img_dataset(name)
    t_train, t_test = timg.get_train_test_img_dataset(name)
    for j, t in ((j_train, t_train), (j_test, t_test)):
        assert t.images.dtype == torch.float32 and t.shape == j.shape and len(t) == len(j)
        assert np.array_equal(t.images.numpy(), np.asarray(j.images))
        if hasattr(j, "labels"):
            assert np.array_equal(t.labels, j.labels)
    if name == "zsmms":
        assert t_test.test_upscale_factor == j_test.test_upscale_factor == 1.6
        assert t_train.shape == (20, 20, 1) and t_test.shape == (32, 32, 1)


def test_local_npz_dataset_raises_without_its_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        timg.get_train_test_img_dataset("mnist")
    imgs = np.random.default_rng(0).integers(0, 256, (5, 4, 4), dtype=np.uint8)
    np.savez(tmp_path / "x_train.npz", images=imgs)
    got = timg.LocalNpzDataset("x", True, root=str(tmp_path)).images.numpy()
    ref = np.asarray(jimg.LocalNpzDataset("x", True, root=str(tmp_path)).images)
    assert np.array_equal(got, ref) and got.shape == (5, 4, 4, 1)


def test_epoch_batches_and_samples_draw_from_the_generator():
    ds = timg.DigitsDataset(train=False)
    batches = list(ds.epoch_batches(32, torch.Generator().manual_seed(0)))
    again = list(ds.epoch_batches(32, torch.Generator().manual_seed(0)))
    assert len(batches) == len(ds) // 32
    assert all(torch.equal(a[0], b[0]) and a[0] is a[1] for a, b in zip(batches, again))
    order = torch.cat([x for x, _ in batches]).reshape(len(batches) * 32, -1)
    assert len({tuple(r.tolist()) for r in order}) > 100
    s = ds.get_samples(7, torch.Generator().manual_seed(1))
    assert s.shape == (7, 32, 32, 1)


class _Draws:
    """Stands for `torch` in the port's datasplit module: `randint` and
    `rand` return the JAX package's draws for the same call, in order."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __getattr__(self, name):
        return getattr(torch, name)

    def randint(self, lo, hi, shape, generator=None, device=None):
        return torch.from_numpy(np.array(self.draws.pop(0), np.int64)).reshape(shape)

    def rand(self, shape, generator=None, device=None):
        return torch.from_numpy(np.array(self.draws.pop(0), np.float32)).reshape(shape)


def _jax_draws(key, masker, batch, n_pix):
    """The count and the scores JAX's GetRandomIndcs draws inside `masker`."""
    def to_count(v):
        return max(0, min(int(v * n_pix) if 0 <= v < 1 else int(v), n_pix))

    k_n, _, _, k_perm = jax.random.split(key, 4)
    b = to_count(masker.b)
    a = min(to_count(masker.a), b)
    n = jax.random.randint(k_n, (batch, 1) if masker.is_indep_n else (), a, b + 1)
    scores = jax.random.uniform(k_perm, (batch, n_pix))
    return [np.asarray(n), np.asarray(scores)]


MASKERS = [dict(a=0.0, b=0.3), dict(a=0.0, b=0.3, is_indep_n=True), dict(a=0.1, b=0.5),
           dict(a=5, b=40, is_indep_n=True), dict(a=0.0, b=0.0)]


@pytest.mark.parametrize("kwargs", MASKERS, ids=["train", "eval", "default", "counts", "empty"])
@pytest.mark.parametrize("grid", [(32, 32), (20, 20), (7, 5)])
def test_random_masker_equals_jax_given_its_draws(monkeypatch, kwargs, grid):
    batch = 6
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        jm = jds.RandomMasker(**kwargs)
        ref = np.asarray(jm(key, batch, grid))
        monkeypatch.setattr(tds, "torch", _Draws(_jax_draws(key, jm, batch, grid[0] * grid[1])))
        got = tds.RandomMasker(**kwargs)(CPU, batch, grid)
        monkeypatch.setattr(tds, "torch", torch)
        assert got.shape == ref.shape and np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("grid", [(8, 8), (7, 10)])
def test_fixed_maskers_equal_jax(grid):
    key = jax.random.PRNGKey(0)
    assert np.array_equal(tds.no_masker(CPU, 3, grid).numpy(),
                          np.asarray(jds.no_masker(key, 3, grid)))
    for f in (2, 3):
        assert np.array_equal(tds.ResolutionMasker(f)(CPU, 3, grid).numpy(),
                              np.asarray(jds.ResolutionMasker(f)(key, 3, grid)))
    for dim in (0, 1):
        assert np.array_equal(tds.half_masker(CPU, 3, grid, dim).numpy(),
                              np.asarray(jds.half_masker(key, 3, grid, dim)))


def _images(batch=4, grid=(8, 6), y_dim=3, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (batch,) + grid + (y_dim,)).astype(
        np.float32)


def _fixed(mask):
    """A masker that returns `mask`, in the port's and JAX's signatures."""
    return lambda *_: torch.from_numpy(mask), lambda *_: jnp.asarray(mask)


def test_grid_splitters_equal_jax():
    y = _images()
    mask = np.random.default_rng(1).random(y.shape[:-1]) < 0.3
    t_ctx, j_ctx = _fixed(mask)
    ref = jds.GridCntxtTrgtSplitter(context_masker=j_ctx)(jax.random.PRNGKey(0), y, y)
    got = tds.GridCntxtTrgtSplitter(context_masker=t_ctx)(CPU, torch.from_numpy(y),
                                                          torch.from_numpy(y))
    ref_sr = jds.SuperresolutionCntxtTrgtSplitter(2)(jax.random.PRNGKey(0), y, y)
    got_sr = tds.SuperresolutionCntxtTrgtSplitter(2)(CPU, torch.from_numpy(y))
    for g, r in ((got, ref), (got_sr, ref_sr)):
        assert set(g) == set(r)
        for k in r:
            assert g[k].dtype == torch.from_numpy(np.asarray(r[k])).dtype, k
            assert np.array_equal(g[k].numpy(), np.asarray(r[k])), k


@pytest.mark.parametrize("upscale", [1.0, 1.6])
@pytest.mark.parametrize("grid", [(8, 8), (32, 32), (20, 20), (5, 7)])
def test_grid_to_points_and_coords_equal_jax(upscale, grid):
    """Coordinates in [-1, 1] times the upscale, the masked-in pixels first,
    each part in raster order; the padded tail holds the other pixels."""
    y = _images(3, grid, 1, seed=2)
    mask = np.random.default_rng(3).random(y.shape[:-1]) < 0.3
    mask[0] = False
    n = grid[0] * grid[1]
    for n_max in (n, n // 2):
        ref = jds.grid_to_points(jnp.asarray(y), jnp.asarray(mask), n_max, upscale)
        got = tds.grid_to_points(torch.from_numpy(y), torch.from_numpy(mask), n_max, upscale)
        for g, r in zip(got, ref):
            assert np.array_equal(g.numpy(), np.asarray(r))
    ref_c = jds.GridCntxtTrgtSplitter(upscale_factor=upscale).coords(grid)
    got_c = tds.GridCntxtTrgtSplitter(upscale_factor=upscale).coords(grid)
    assert np.array_equal(got_c.numpy(), np.asarray(ref_c))


def test_points_from_grid_splitter_equals_jax():
    y = _images(4, (10, 9), 3, seed=4)
    mask = np.random.default_rng(5).random(y.shape[:-1]) < 0.25
    mask[1] = False
    t_ctx, j_ctx = _fixed(mask)
    ref = jds.PointsFromGridSplitter(context_masker=j_ctx, upscale_factor=1.6)(
        jax.random.PRNGKey(0), y, y)
    got = tds.PointsFromGridSplitter(context_masker=t_ctx, upscale_factor=1.6)(
        CPU, torch.from_numpy(y), torch.from_numpy(y))
    assert set(got) == set(ref)
    for k in ref:
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
    assert got["mask_cntxt"][1].sum() == 0 and got["mask_trgt"].all()
