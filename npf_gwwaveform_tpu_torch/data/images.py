"""Image corpora for the grid and image family, the counterpart of
`npf_gwwaveform_tpu/data/images.py`.

Every corpus but the file-gated ones is built with numpy from the 1,797
8x8 digits that scikit-learn ships (`load_digits`), which this package
carries as `digits.npz` (uint8 images 0..16 and their labels; the tests hold
it to `load_digits()`), with numpy's `default_rng` drawn exactly as the JAX
package draws it, so that every image is the JAX package's bit for bit:

* `digits`: the digits scaled to [0, 1], nearest-upscaled x4 to 32x32x1; a
  fixed 90/10 train/test split (`default_rng(0).permutation`);
* `rgb_digits`: the same digits colorized to 32x32x3 (a foreground colour
  in [0.3, 1]^3 and a background tint in [0, 0.25]^3 per image, from
  `default_rng(7)`);
* `rgb_digits128`: 128x128x3 mosaics of four colorized digits of one fold
  (1,024 train and 256 test images);
* `zsmms` (`ZeroShotMultiDigits`): one 16px digit translated on a 20x20
  canvas for training; two digits in strips on a 32x32 canvas for testing
  (1,024 images), coordinates scaled by `test_upscale_factor` 1.6 for the
  point models;
* `digits16`: `digits` at 16x16;
* `mnist`, `celeba32`, `svhn`: `LocalNpzDataset`, which needs
  `data/{name}_{train|test}.npz` and raises without it.

Images are float32 torch tensors [N, H, W, C] in [0, 1] on the CPU
(`images`); `epoch_batches` and `get_samples` draw from an explicit
`torch.Generator`.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["GridImageDataset", "DigitsDataset", "RGBDigitsDataset", "RGBDigitsMosaicDataset",
           "ZeroShotMultiDigits", "SingleImage", "LocalNpzDataset", "DATASETS_DICT",
           "DIGITS_FILE", "get_train_test_img_dataset"]

DIGITS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "digits.npz")


class GridImageDataset:
    """A fixed array of images [N, H, W, C] in [0, 1]."""

    def __init__(self, images: np.ndarray):
        if images.ndim != 4:
            raise ValueError(f"images of shape {images.shape}: [N, H, W, C]")
        self.images = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32))
        self.n_samples = images.shape[0]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.images.shape[1:])

    def __len__(self) -> int:
        return self.n_samples

    def epoch_batches(self, batch_size: int, generator: Optional[torch.Generator] = None,
                      shuffle: bool = True):
        """(x, y) batches of one epoch, both the images (the grid splitters
        read the image from either), in an order drawn from `generator`;
        the last partial batch is dropped."""
        n = self.n_samples
        order = torch.randperm(n, generator=generator) if shuffle else torch.arange(n)
        for i in range(0, n - batch_size + 1, batch_size):
            img = self.images[order[i:i + batch_size]]
            yield img, img

    def get_samples(self, n_samples: Optional[int] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`n_samples` images (all by default) in an order drawn from `generator`."""
        n = n_samples or self.n_samples
        return self.images[torch.randperm(self.n_samples, generator=generator)[:n]]


def _load_sklearn_digits(upscale: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """The 8x8 digits -> ([N, 8u, 8u, 1] float32 in [0, 1], nearest-upscaled
    by u; labels), as `load_digits().images.astype(float32) / 16`."""
    with np.load(DIGITS_FILE) as d:
        imgs = d["images"].astype(np.float32) / 16.0
        labels = d["target"].astype(np.int64)
    if upscale > 1:
        imgs = imgs.repeat(upscale, axis=1).repeat(upscale, axis=2)
    return imgs[..., None], labels


def _fold(n: int, train: bool) -> np.ndarray:
    """The fixed 90/10 split of the digits' indices."""
    split = int(0.9 * n)
    order = np.random.default_rng(0).permutation(n)
    return order[:split] if train else order[split:]


class DigitsDataset(GridImageDataset):
    """The digits at 8 * upscale pixels a side, one channel."""

    def __init__(self, train: bool = True, upscale: int = 4, seed: int = 0):
        imgs, labels = _load_sklearn_digits(upscale)
        sel = _fold(imgs.shape[0], train)
        self.labels = labels[sel]
        super().__init__(imgs[sel])


class ZeroShotMultiDigits(GridImageDataset):
    """Train: each 16px digit at a random offset on a 20x20 canvas. Test:
    `n_test` 32x32 canvases of two digits, each shifted at random along one
    axis inside a strip, the two strips side by side (half the canvases
    vary axis 0, half axis 1). Drawn from `default_rng(seed)`."""

    def __init__(self, train: bool = True, upscale: int = 2, n_test: int = 1024,
                 seed: int = 123):
        imgs, _ = _load_sklearn_digits(upscale)
        n, h, w, _ = imgs.shape
        rng = np.random.default_rng(seed)
        if train:
            H = W = h + h // 4
            canvas = np.zeros((n, H, W, 1), np.float32)
            tops = rng.integers(0, H - h + 1, n)
            lefts = rng.integers(0, W - w + 1, n)
            for i in range(n):
                canvas[i, tops[i]:tops[i] + h, lefts[i]:lefts[i] + w] = imgs[i]
        else:
            F = 2 * h
            canvas = np.zeros((n_test, F, F, 1), np.float32)
            axes = rng.permutation(np.arange(n_test) % 2)
            for i in range(n_test):
                ax = axes[i]
                strips = []
                for _ in range(2):
                    strip = np.zeros((F, w) if ax == 0 else (h, F), np.float32)
                    shift = rng.integers(0, F - (h if ax == 0 else w) + 1)
                    j = rng.integers(n)
                    if ax == 0:
                        strip[shift:shift + h, :] = imgs[j, ..., 0]
                    else:
                        strip[:, shift:shift + w] = imgs[j, ..., 0]
                    strips.append(strip)
                canvas[i, ..., 0] = np.concatenate(strips, axis=1 - ax)
        super().__init__(canvas)

    @property
    def test_upscale_factor(self) -> float:
        """The test canvas's side over the train canvas's, 32 / 20."""
        return 32.0 / 20.0


def _colorize(imgs: np.ndarray, rng: np.random.Generator, lead: tuple) -> np.ndarray:
    """bg + imgs * (fg - bg), fg ~ U[0.3, 1]^3 and bg ~ U[0, 0.25]^3 drawn
    in that order with the leading shape `lead`."""
    fg = rng.uniform(0.3, 1.0, lead + (1, 1, 3)).astype(np.float32)
    bg = rng.uniform(0.0, 0.25, lead + (1, 1, 3)).astype(np.float32)
    return bg + imgs * (fg - bg)


class RGBDigitsDataset(GridImageDataset):
    """The 32x32 digits colorized to three channels, per image (colours
    from `default_rng(7)` over all 1,797, then the `digits` fold)."""

    def __init__(self, train: bool = True, upscale: int = 4, seed: int = 0):
        imgs, labels = _load_sklearn_digits(upscale)
        n = imgs.shape[0]
        rgb = _colorize(imgs, np.random.default_rng(7), (n,))
        sel = _fold(n, train)
        self.labels = labels[sel]
        super().__init__(rgb[sel])


class RGBDigitsMosaicDataset(GridImageDataset):
    """128x128x3 mosaics: four colorized 64px digits of the fold in a 2x2
    grid (`n_images`: 1,024 train, 256 test; drawn from `default_rng(11)`
    or `default_rng(12)`)."""

    def __init__(self, train: bool = True, n_images: Optional[int] = None, seed: int = 0):
        imgs, _ = _load_sklearn_digits(upscale=8)
        pool = imgs[_fold(imgs.shape[0], train)]
        if n_images is None:
            n_images = 1024 if train else 256
        rng = np.random.default_rng(11 if train else 12)
        idx = rng.integers(0, len(pool), (n_images, 4))
        tiles = _colorize(pool[idx], rng, (n_images, 4))
        top = np.concatenate([tiles[:, 0], tiles[:, 1]], axis=2)
        bot = np.concatenate([tiles[:, 2], tiles[:, 3]], axis=2)
        super().__init__(np.concatenate([top, bot], axis=1))


class SingleImage(GridImageDataset):
    """`n_samples` copies of one image [H, W] or [H, W, C]."""

    def __init__(self, image: np.ndarray, n_samples: int = 128, seed: int = 0):
        if image.ndim == 2:
            image = image[..., None]
        super().__init__(np.repeat(image[None].astype(np.float32), n_samples, axis=0))


class LocalNpzDataset(GridImageDataset):
    """Images from `{root}/{name}_{train|test}.npz` (an `images` array; over
    1.5 at most means 0..255, scaled to [0, 1]); raises FileNotFoundError
    where the file is absent."""

    def __init__(self, name: str, train: bool = True, root: str = "data", seed: int = 0):
        path = os.path.join(root, f"{name}_{'train' if train else 'test'}.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(f"{name}: place an npz with an 'images' array at {path}")
        with np.load(path) as data:
            imgs = data["images"].astype(np.float32)
        if imgs.max() > 1.5:
            imgs = imgs / 255.0
        if imgs.ndim == 3:
            imgs = imgs[..., None]
        super().__init__(imgs)


DATASETS_DICT = {
    "digits": DigitsDataset,
    "rgb_digits": RGBDigitsDataset,
    "rgb_digits128": RGBDigitsMosaicDataset,
    "digits16": lambda train=True, seed=0: DigitsDataset(train, upscale=2, seed=seed),
    "zs_multi_digits": ZeroShotMultiDigits,
    "zsmms": ZeroShotMultiDigits,
    "mnist": lambda train=True, seed=0: LocalNpzDataset("mnist", train, seed=seed),
    "celeba32": lambda train=True, seed=0: LocalNpzDataset("celeba32", train, seed=seed),
    "svhn": lambda train=True, seed=0: LocalNpzDataset("svhn", train, seed=seed),
}


def get_train_test_img_dataset(name: str, seed: int = 0) -> tuple:
    """(train, test) corpora by registry name."""
    if name not in DATASETS_DICT:
        raise KeyError(f"Unknown image dataset {name}; have {list(DATASETS_DICT)}")
    ctor = DATASETS_DICT[name]
    return ctor(train=True, seed=seed), ctor(train=False, seed=seed + 1)
