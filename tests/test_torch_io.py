"""The port's data loading (`paddle_tpu_torch.io`) and vision datasets
against the JAX package's (paddle_tpu/io, paddle_tpu/vision/datasets).

The samplers draw from numpy's global RNG in both packages, so after the
same ``np.random.seed`` they give the same indices; every check here is
exact: index lists equal, batches equal element for element (the port's
as CPU torch tensors, the reference's as its Tensors), the synthetic
MNIST bytes equal. The loader's worker processes are not ported and
must raise, naming their ROADMAP item; ``DistributedBatchSampler`` gives
every rank the reference's indices.
"""
import gzip
import struct

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import paddle_tpu.io as jio
from paddle_tpu.vision.datasets import MNIST as JMNIST
from paddle_tpu_torch import io as pio
from paddle_tpu_torch.vision import datasets as pdatasets
from paddle_tpu_torch.vision.datasets import MNIST, FashionMNIST


class _Squares:
    """A map-style dataset with the same items in both packages: an
    image-like array, a scalar label and a dict field."""

    def __init__(self, base, n=23):
        self._base = base
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full((2, 3), i, np.float32), np.int64(i % 5),
                {"w": np.float32(i) / 2})


def _datasets(n=23):
    def make(io):
        cls = type("Squares", (_Squares, io.Dataset), {})
        return cls(io, n)
    return make(jio), make(pio)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "_data"):
        return np.asarray(x._data)
    return np.asarray(x)


def _same_tree(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)) and not isinstance(b, torch.Tensor):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        np.testing.assert_array_equal(_np(b), _np(a))


SAMPLERS = {
    "sequence": lambda io, ds: io.SequenceSampler(ds),
    "random": lambda io, ds: io.RandomSampler(ds),
    "random replacement": lambda io, ds: io.RandomSampler(
        ds, replacement=True, num_samples=40),
    "subset random": lambda io, ds: io.SubsetRandomSampler([3, 1, 4, 15, 9]),
    "weighted": lambda io, ds: io.WeightedRandomSampler(
        np.arange(1, 24, dtype=np.float64), 30),
    "weighted no replacement": lambda io, ds: io.WeightedRandomSampler(
        np.arange(1, 24, dtype=np.float64), 10, replacement=False),
    "batch": lambda io, ds: io.BatchSampler(ds, batch_size=5),
    "batch shuffle drop_last": lambda io, ds: io.BatchSampler(
        ds, shuffle=True, batch_size=5, drop_last=True),
}


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_samplers_give_the_reference_indices(name):
    jds, pds = _datasets()
    got = []
    for io, ds in ((jio, jds), (pio, pds)):
        np.random.seed(11)
        s = SAMPLERS[name](io, ds)
        got.append((list(s), len(s)))
    assert got[0] == got[1]


@pytest.mark.parametrize("shuffle,drop_last,batch_size", [
    (False, False, 4), (True, False, 5), (True, True, 6)])
def test_dataloader_batches_equal_the_reference(shuffle, drop_last,
                                                batch_size):
    jds, pds = _datasets()
    runs = []
    for io, ds in ((jio, jds), (pio, pds)):
        np.random.seed(3)
        loader = io.DataLoader(ds, batch_size=batch_size, shuffle=shuffle,
                               drop_last=drop_last)
        runs.append((len(loader), list(loader)))
    (jn, jb), (pn, pb) = runs
    assert jn == pn == len(pb) == len(jb)
    for a, b in zip(jb, pb):
        _same_tree(a, b)
        assert isinstance(b[0], torch.Tensor) and b[0].device.type == "cpu"
        assert b[0].dtype == torch.float32 and b[1].dtype == torch.int64


def test_collate_functions():
    samples = [(np.ones((2,), np.float32) * i, i, float(i), "s", {"k": i})
               for i in range(3)]
    for fn_j, fn_p in ((jio.numpy_collate_fn, pio.numpy_collate_fn),
                       (jio.default_collate_fn, pio.default_collate_fn)):
        _same_tree(fn_j(samples), fn_p(samples))
    out = pio.default_collate_fn(samples)
    assert isinstance(out[0], torch.Tensor) and out[3] == ["s"] * 3
    tens = [torch.full((2,), float(i)) for i in range(3)]
    assert torch.equal(pio.default_collate_fn(tens), torch.stack(tens))
    np.testing.assert_array_equal(pio.numpy_collate_fn(tens),
                                  torch.stack(tens).numpy())


def test_datasets_and_split():
    jds, pds = _datasets()
    for io, ds in ((jio, jds), (pio, pds)):
        assert len(io.ConcatDataset([ds, ds])) == 46
    jc, pc = (io.ConcatDataset([ds, ds]) for io, ds in ((jio, jds),
                                                          (pio, pds)))
    for i in (0, 22, 23, 45, -1):
        _same_tree(jc[i], pc[i])
    with pytest.raises(IndexError):
        pc[46]
    jcomp, pcomp = (io.ComposeDataset([ds, ds]) for io, ds in (
        (jio, jds), (pio, pds)))
    _same_tree(jcomp[4], pcomp[4])
    assert len(pcomp[4]) == 6
    t = pio.TensorDataset([torch.arange(6), np.arange(6) * 2])
    assert len(t) == 6 and int(t[4][1]) == 8
    sub = pio.Subset(pds, [5, 2])
    assert len(sub) == 2 and sub[1][0][0, 0] == 2
    splits = []
    for io, ds in ((jio, jds), (pio, pds)):
        np.random.seed(5)
        splits.append([s.indices for s in io.random_split(ds, [10, 13])])
        np.random.seed(5)
        splits.append([s.indices for s in io.random_split(ds, [0.5, 0.5])])
    assert splits[0] == splits[2] and splits[1] == splits[3]
    with pytest.raises(ValueError, match="lengths"):
        pio.random_split(pds, [3, 4])

    class Stream(pio.IterableDataset):
        def __iter__(self):
            return iter(range(7))

    chained = [x for x in pio.ChainDataset([Stream(), Stream()])]
    assert chained == list(range(7)) * 2
    batches = list(pio.DataLoader(Stream(), batch_size=3))
    assert [b.tolist() for b in batches] == [[0, 1, 2], [3, 4, 5], [6]]
    assert len(list(pio.DataLoader(Stream(), batch_size=3,
                                   drop_last=True))) == 2
    with pytest.raises(TypeError):
        len(pio.DataLoader(Stream()))


def test_the_workers_and_the_distributed_sampler_raise():
    _, pds = _datasets()
    with pytest.raises(NotImplementedError, match="A10b"):
        pio.DataLoader(pds, num_workers=2)
    jds, _ = _datasets()
    for shuffle in (False, True):
        for rank in range(3):
            got = pio.DistributedBatchSampler(pds, batch_size=4,
                                              num_replicas=3, rank=rank,
                                              shuffle=shuffle)
            want = jio.DistributedBatchSampler(jds, batch_size=4,
                                               num_replicas=3, rank=rank,
                                               shuffle=shuffle)
            got.set_epoch(1)
            want.set_epoch(1)
            assert [list(b) for b in got] == [list(b) for b in want]
            assert len(got) == len(want)
    assert pio.DevicePrefetcher is not None


@pytest.mark.parametrize("mode", ["train", "test"])
def test_synthetic_mnist_is_the_reference_bytes(mode):
    want, got = JMNIST(mode=mode), MNIST(mode=mode)
    assert len(got) == len(want) == 4096
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    for i in (0, 17, 4095):
        img, label = got[i]
        wimg, wlabel = want[i]
        assert img.shape == (1, 28, 28) and img.dtype == np.float32
        assert label.shape == (1,) and label.dtype == np.int64
        assert 0.0 <= img.min() and img.max() <= 1.0
        np.testing.assert_array_equal(img, wimg)
        np.testing.assert_array_equal(label, wlabel)
    assert isinstance(FashionMNIST(mode=mode), MNIST)
    assert FashionMNIST(mode=mode, transform=lambda im: im[:2])[3][0] \
        .shape == (2, 28)


def test_mnist_reads_idx_files(tmp_path):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (5, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, (5,), dtype=np.uint8)
    ipath, lpath = tmp_path / "img.gz", tmp_path / "lab.gz"
    with gzip.open(ipath, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + images.tobytes())
    with gzip.open(lpath, "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + labels.tobytes())
    got = MNIST(str(ipath), str(lpath))
    want = JMNIST(str(ipath), str(lpath))
    assert len(got) == 5
    for i in range(5):
        _same_tree(want[i], got[i])


@pytest.mark.parametrize("name", ["Cifar10", "Cifar100", "DatasetFolder",
                                  "ImageFolder", "Flowers", "VOC2012"])
def test_other_datasets_raise(name):
    with pytest.raises(NotImplementedError, match="A10b"):
        getattr(pdatasets, name)("somewhere")
