"""Data loading (port of ``paddle_tpu/io/__init__.py``).

``Dataset`` / ``TensorDataset``, the samplers (``SequenceSampler``,
``RandomSampler``, ``BatchSampler``), ``default_collate_fn`` and a
single-process ``DataLoader``. Collation stacks a batch's numpy samples
on the host and moves each stacked array to the default place in one
copy (:func:`paddle_tpu_torch.core.tensor.to_tensor`: float64 data
becomes float32, as in the JAX package).

``RandomSampler`` draws its permutation from a ``np.random.RandomState``
(its ``generator`` argument, else :func:`paddle_tpu_torch.core.random.
host_generator`, which ``paddle_tpu_torch.seed(n)`` reseeds), where the
JAX package draws from numpy's global state: a shuffled epoch is fixed
by the seed and nothing else.

Worker threads (``num_workers > 0``, the JAX ``io/worker.py`` and its
shared-memory ring) are not ported yet: they raise
(``ROADMAP.md`` §1 item 9).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import random as _random
from ..core.tensor import to_tensor

__all__ = ["Dataset", "TensorDataset", "Sampler", "SequenceSampler",
           "RandomSampler", "BatchSampler", "DataLoader",
           "default_collate_fn"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class TensorDataset(Dataset):
    """Row ``i`` of every tensor (or array) of ``tensors``."""

    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """A permutation of the indices (or ``num_samples`` draws with
    ``replacement``), from ``generator`` (a ``np.random.RandomState``)
    or the port's host generator."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        rng = self.generator if self.generator is not None else \
            _random.host_generator()
        n = len(self.data_source)
        if self.replacement:
            return iter(rng.randint(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def default_collate_fn(batch):
    """Stack a list of samples: arrays and numbers into one tensor on the
    default place, tuples / lists field by field (a list back), dicts
    key by key."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return to_tensor(torch.stack(batch))
    if isinstance(sample, (np.ndarray, int, float, np.generic)):
        return to_tensor(np.stack([np.asarray(s) for s in batch]))
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn(list(col)) for col in zip(*batch)]
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    return batch


class DataLoader:
    """Batches of ``dataset`` in the order of ``batch_sampler`` (or of a
    ``BatchSampler(dataset, shuffle, batch_size, drop_last)``), each
    collated by ``collate_fn``."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        if num_workers:
            raise NotImplementedError(
                "DataLoader(num_workers=%d): worker threads and processes "
                "are not ported yet (ROADMAP.md §1 item 9); use "
                "num_workers=0" % num_workers)
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = 0
        self.drop_last = drop_last
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
        else:
            self.batch_size = batch_size
            self.batch_sampler = None if batch_size is None else \
                BatchSampler(dataset, shuffle=shuffle, batch_size=batch_size,
                             drop_last=drop_last)

    def __len__(self):
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def __iter__(self):
        if self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self.dataset[i]
            return
        for indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in indices])
