"""The port's `io.DevicePrefetcher` and `TrainStep.prefetch` on the CPU:
the reference's contract (paddle_tpu/io/device_prefetcher.py, and its
tests in tests/test_input_pipeline.py) without the streams the card adds.

* batches arrive in the loader's order, nested structures kept, non-array
  leaves passed through;
* at most ``depth`` batches are pulled ahead of the consumer;
* a staged batch never aliases the loader's memory: a loader that reuses
  and rewrites one host buffer still delivers every batch as it was;
* a loader's exception reaches the consumer's ``next()``;
* `get_stats` has the reference's keys;
* `TrainStep.prefetch` stages on the step's device and trains as the
  plain batches do, with the reference's prefetcher delivering the same
  values.
"""
import threading
import time

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

from paddle_tpu.io import DevicePrefetcher as JPrefetcher
from paddle_tpu_torch.io import DevicePrefetcher
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision.models import resnet18


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((2, 3)).astype(np.float32),
             {"y": rng.integers(0, 9, (2,)), "tag": f"b{i}"})
            for i in range(n)]


def test_order_nesting_and_passthrough():
    src = _batches(6)
    pf = DevicePrefetcher(src, depth=2, device="cpu")
    got = list(pf)
    assert len(got) == 6
    for (x, d), (gx, gd) in zip(src, got):
        assert isinstance(gx, torch.Tensor) and gx.device.type == "cpu"
        assert np.array_equal(gx.numpy(), x)
        assert np.array_equal(gd["y"].numpy(), d["y"])
        assert gd["tag"] == d["tag"]
    # a new epoch starts over
    assert len(list(pf)) == 6


def test_same_values_as_the_reference_prefetcher():
    src = _batches(4, seed=1)
    mine = list(DevicePrefetcher(src, device="cpu"))
    ref = list(JPrefetcher(src))
    for (a, da), (b, db) in zip(mine, ref):
        assert np.array_equal(a.numpy(), np.asarray(b._data))
        assert np.array_equal(da["y"].numpy(), np.asarray(db["y"]._data))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_at_most_depth_batches_are_pulled_ahead(depth):
    pulled = []

    def loader():
        for i in range(12):
            pulled.append(i)
            yield np.full(4, i, np.float32)

    pf = iter(DevicePrefetcher(loader(), depth=depth, device="cpu"))
    for taken in range(1, 6):
        next(pf)
        # the producer runs ahead until it holds depth batches
        deadline = time.monotonic() + 10
        while len(pulled) < taken + depth and time.monotonic() < deadline:
            time.sleep(0.005)
        time.sleep(0.02)
        assert len(pulled) == taken + depth
    pf.close()


def test_a_reused_host_buffer_is_copied():
    buf = np.zeros((3, 4), np.float32)
    gate = threading.Event()

    def loader():
        for i in range(5):
            buf[:] = i                # the loader rewrites one buffer
            yield buf
        gate.set()

    got = list(DevicePrefetcher(loader(), depth=3, device="cpu"))
    assert gate.is_set()
    assert [float(t[0, 0]) for t in got] == [0.0, 1.0, 2.0, 3.0, 4.0]
    buf[:] = -1
    assert float(got[0][0, 0]) == 0.0


def test_a_loader_error_reaches_the_consumer():
    def loader():
        yield np.zeros(2, np.float32)
        raise RuntimeError("disk gone")

    pf = iter(DevicePrefetcher(loader(), device="cpu"))
    next(pf)
    with pytest.raises(RuntimeError, match="disk gone"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)


def test_stats_have_the_reference_keys():
    pf = DevicePrefetcher(_batches(3), depth=2, device="cpu")
    list(pf)
    stats = pf.get_stats()
    ref = JPrefetcher(_batches(3), depth=2)
    list(ref)
    assert set(stats) == set(ref.get_stats())
    for key in ("input_stall_ms", "h2d_ms"):
        assert set(stats[key]) == {"total", "mean", "max", "count"}
        assert stats[key]["count"] == 3
    assert stats["depth"] == 2 and stats["batches"] == 3
    assert len(stats["per_step_h2d_ms"]) == 3
    pf.reset_stats()
    assert pf.get_stats()["batches"] == 0


def test_refusals_and_arguments():
    with pytest.raises(ValueError):
        DevicePrefetcher([], depth=0, device="cpu")
    for kw in (dict(sharding=object()), dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="A9b"):
            DevicePrefetcher([], device="cpu", **kw)
    with DevicePrefetcher(_batches(2), device="cpu",
                          process_local=True) as pf:
        assert len(list(pf)) == 2
    assert len(DevicePrefetcher(_batches(3), device="cpu")) == 3
    with DevicePrefetcher(_batches(3), device="cpu") as pf:
        next(iter(pf))


def test_trainstep_prefetch_trains_as_plain_batches():
    """`TrainStep.prefetch` binds the step's device; a resnet18 trained
    over prefetched batches ends where the same batches fed directly
    take it, bit for bit."""
    rng = np.random.default_rng(2)
    data = [(rng.standard_normal((4, 3, 16, 16)).astype(np.float32),
             rng.integers(0, 10, (4,))) for _ in range(3)]
    ends = []
    for prefetch in (False, True):
        model = resnet18(num_classes=10, device="cpu", seed=1)
        crit = CrossEntropyLoss()
        opt = Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=model.parameters())
        step = TrainStep(model, lambda m, x, y: crit(m(x), y), opt)
        if prefetch:
            pf = step.prefetch(iter(data), depth=2)
            assert pf.device == torch.device("cpu") and pf.depth == 2
            batches = list(pf)
        else:
            batches = [(torch.from_numpy(x), torch.from_numpy(y))
                       for x, y in data]
        losses = [float(step(x, y)) for x, y in batches]
        ends.append((losses, model.state_dict()))
    assert ends[0][0] == ends[1][0]
    assert all(torch.equal(a, ends[1][1][k]) for k, a in ends[0][1].items())
