"""Vision datasets (port of ``MNIST`` of
``paddle_tpu/vision/datasets/__init__.py``).

``MNIST`` parses the idx files under ``PADDLE_TPU_DATA_HOME/mnist`` when
they are there, and otherwise falls back to the JAX package's synthetic
sample, pixel for pixel: image ``idx`` is a class-dependent sine pattern
plus noise from ``np.random.RandomState(seed * 1000003 + idx)``, label
``idx % 10``, 60000 train (seed 0) or 10000 test (seed 1) samples, or
``PADDLE_TPU_SYNTH_SAMPLES`` of them. It downloads nothing.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ...config import knobs
from ...io import Dataset

__all__ = ["MNIST"]


class _SyntheticImageDataset(Dataset):
    """Deterministic synthetic (image, label) pairs: a class-dependent
    pattern plus seeded noise, learnable by a small CNN.

    The JAX package's arithmetic, step for step, so the pixels are its
    own; the host work is cut (~45 us an image against ~370 on one core):
    one ``RandomState`` reseeded a sample instead of a new one, each
    class's pattern computed once, and the clip as ``minimum`` /
    ``maximum`` (``np.clip``'s error-state handling dominated)."""

    def __init__(self, num_samples, image_shape, num_classes, transform=None,
                 seed=0):
        self.num_samples = num_samples
        self.image_shape = image_shape
        self.num_classes = num_classes
        self.transform = transform
        self.seed = seed
        self._rng = np.random.RandomState(0)
        self._patterns = {}

    def _pattern(self, label):
        """``(sin(2 pi f x / w) cos(2 pi f y / h))[None] * 0.5 + 0.5``,
        f = label + 1, f32."""
        pat = self._patterns.get(label)
        if pat is None:
            h, w = self.image_shape[-2], self.image_shape[-1]
            yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
            freq = 1 + label
            base = (np.sin(2 * np.pi * freq * xx / w)
                    * np.cos(2 * np.pi * freq * yy / h))
            pat = self._patterns[label] = base[None] * 0.5 + 0.5
        return pat

    def _make(self, idx):
        self._rng.seed(self.seed * 1000003 + idx)
        label = idx % self.num_classes
        h, w = self.image_shape[-2], self.image_shape[-1]
        c = self.image_shape[0] if len(self.image_shape) == 3 else 1
        img = self._pattern(label) * 200 + self._rng.randn(c, h, w) * 10
        img = np.minimum(np.maximum(img, 0), 255).astype(np.uint8)
        if c == 1:
            img = img[0]
        return img, label

    def __getitem__(self, idx):
        img, label = self._make(idx)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(label, dtype=np.int64)

    def __len__(self):
        return self.num_samples


class MNIST(Dataset):
    """``(image f32 [1, 28, 28] in [0, 1], label int64)`` pairs (or
    ``transform(image uint8 [28, 28])``)."""

    NUM_CLASSES = 10

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        self._images = None
        self._labels = None
        data_dir = os.path.expanduser(knobs.get_str("PADDLE_TPU_DATA_HOME"))
        prefix = "train" if mode == "train" else "t10k"
        image_path = image_path or os.path.join(
            data_dir, "mnist", f"{prefix}-images-idx3-ubyte.gz")
        label_path = label_path or os.path.join(
            data_dir, "mnist", f"{prefix}-labels-idx1-ubyte.gz")
        if os.path.exists(image_path) and os.path.exists(label_path):
            self._images = self._parse_images(image_path)
            self._labels = self._parse_labels(label_path)
        else:
            n = 60000 if mode == "train" else 10000
            n = knobs.get_int("PADDLE_TPU_SYNTH_SAMPLES", default=n)
            self._synth = _SyntheticImageDataset(
                n, (1, 28, 28), 10, transform=None,
                seed=0 if mode == "train" else 1)

    @staticmethod
    def _parse_images(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            _, n, rows, cols = struct.unpack(">IIII", f.read(16))
            return np.frombuffer(f.read(), dtype=np.uint8).reshape(
                n, rows, cols)

    @staticmethod
    def _parse_labels(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            struct.unpack(">II", f.read(8))
            return np.frombuffer(f.read(), dtype=np.uint8)

    def __getitem__(self, idx):
        if self._images is not None:
            img = self._images[idx]
            label = int(self._labels[idx])
        else:
            img, label = self._synth._make(idx)
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32)[None] / 255.0
        return img, np.asarray(label, dtype=np.int64)

    def __len__(self):
        if self._images is not None:
            return len(self._images)
        return len(self._synth)
