"""Data loading: the port of paddle_tpu/io (``Dataset`` and its kin,
the samplers, the collate functions, ``DataLoader``) and its
`DevicePrefetcher`.

The samplers draw from numpy's global RNG, as the reference's do, so
the same ``np.random.seed`` gives the same batches in both packages.
The collate functions stack samples into CPU torch tensors
(`default_collate_fn`) or numpy arrays (`numpy_collate_fn`); moving a
batch to the card is the consumer's (`hapi.Model`) or a
`DevicePrefetcher`'s.

`DistributedBatchSampler` gives a data-parallel rank its share of the
index space, split as the reference splits it (padded to a multiple of
the ranks by repeating the head, rank r taking every ranks-th index from
r; shuffled by ``np.random.RandomState(epoch)``). Not ported yet: the
loader's worker processes and their shared-memory ring (``num_workers >
0``: ROADMAP queue A10b), which raise.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from .device_prefetcher import DevicePrefetcher

__all__ = ["BatchSampler", "ChainDataset", "ComposeDataset", "ConcatDataset",
           "DataLoader", "Dataset", "DevicePrefetcher",
           "DistributedBatchSampler", "IterableDataset", "RandomSampler",
           "Sampler", "SequenceSampler", "Subset", "SubsetRandomSampler",
           "TensorDataset", "WeightedRandomSampler", "default_collate_fn",
           "numpy_collate_fn", "random_split"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Samples ``tuple(t[idx] for t in tensors)`` (tensors or arrays of
    one length)."""

    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    """The fields of several datasets' samples at one index, flattened
    into one tuple."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            out.extend(sample if isinstance(sample, (list, tuple))
                       else [sample])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = list(itertools.accumulate(
            len(d) for d in self.datasets))

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        for i, cs in enumerate(self.cumulative_sizes):
            if idx < cs:
                prev = self.cumulative_sizes[i - 1] if i else 0
                return self.datasets[i][idx - prev]
        raise IndexError(idx)


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Disjoint `Subset`s of the given lengths (or fractions) over one
    ``np.random.permutation``."""
    if all(isinstance(n, float) for n in lengths):
        total = len(dataset)
        sizes = [int(np.floor(total * n)) for n in lengths]
        sizes[-1] += total - sum(sizes)
        lengths = sizes
    total = sum(lengths)
    if total != len(dataset):
        raise ValueError(f"lengths sum to {total}, the dataset holds "
                         f"{len(dataset)}")
    perm = np.random.permutation(total)
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n].tolist()))
        offset += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    """A fixed index subset in random order."""

    def __init__(self, indices, generator=None):
        if len(indices) == 0:
            raise ValueError("indices must be non-empty")
        self.indices = list(indices)

    def __iter__(self):
        order = np.random.permutation(len(self.indices))
        return iter([self.indices[i] for i in order])

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

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


class DistributedBatchSampler(BatchSampler):
    """Reference io/__init__.py:219: the dataset's indices sharded over
    ``num_replicas`` ranks (default: the world's size and this process's
    rank, `distributed.env`)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        from ..distributed import env

        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.nranks = (env.get_world_size() if num_replicas is None
                       else int(num_replicas))
        self.local_rank = env.get_rank() if rank is None else int(rank)
        self.epoch = 0
        n = len(dataset)
        self.num_samples = int(np.ceil(n / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(n) \
                .tolist()
        else:
            indices = list(range(n))
        indices += indices[:(self.total_size - n)]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def numpy_collate_fn(batch):
    """Stack a list of samples field by field into numpy arrays (lists
    for strings), keeping the samples' nesting."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return np.stack([s.numpy() for s in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, float)):
        return np.asarray(batch)
    if isinstance(sample, (list, tuple)):
        return [numpy_collate_fn(list(items)) for items in zip(*batch)]
    if isinstance(sample, dict):
        return {k: numpy_collate_fn([d[k] for d in batch]) for k in sample}
    if isinstance(sample, str):
        return list(batch)
    return np.asarray(batch)


def default_collate_fn(batch):
    """`numpy_collate_fn` into CPU torch tensors (the numpy dtypes
    kept)."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn(list(items)) for items in zip(*batch)]
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    if isinstance(sample, str):
        return list(batch)
    return torch.from_numpy(numpy_collate_fn(batch))


class DataLoader:
    """Batches of a `Dataset` (through a `BatchSampler`) or of an
    `IterableDataset`, collated by ``collate_fn`` (default
    `default_collate_fn`) in the calling process. The reference's
    worker processes (``num_workers > 0``) are not ported yet (ROADMAP
    queue A10b): they raise."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        if num_workers > 0:
            raise NotImplementedError(
                f"DataLoader(num_workers={num_workers}): the worker "
                "processes and their shared-memory ring are not ported "
                "yet: ROADMAP queue A10b; use num_workers=0")
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def __iter__(self):
        if not self._iterable_mode:
            for indices in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in indices])
            return
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)
