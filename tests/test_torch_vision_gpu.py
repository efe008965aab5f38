"""The vision slice on a CUDA card: the prefetcher's streams, the guarded
ResNet step's rollback and checkpoint files written on the card.

These run only on a CUDA card (marker ``gpu``; each test skips without
one). The file imports torch, numpy and the port only, so it runs on a
machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_vision_gpu.py
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.io import DevicePrefetcher
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision.models import resnet18


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: streams and cuDNN have no CPU mode")
    return torch.device("cuda")


def _step(model, **kw):
    crit = CrossEntropyLoss()
    opt = Momentum(learning_rate=0.1, momentum=0.9,
                   parameters=model.parameters())
    return opt, TrainStep(model, lambda m, x, y: crit(m(x), y), opt, **kw)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
             rng.integers(0, 10, (4,))) for _ in range(n)]


@pytest.mark.gpu
def test_prefetch_copies_on_its_side_stream(cuda):
    """The compute stream sleeps; the prefetcher's copy still completes,
    so it was not queued behind the sleep on that stream."""
    data = _batches(2)
    pf = iter(DevicePrefetcher(data, depth=2, device=cuda))
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 30)                  # about a second
    x, y = next(pf)
    assert not torch.cuda.current_stream().query()   # still sleeping
    assert x.is_cuda and y.is_cuda
    assert np.array_equal(x.cpu().numpy(), data[0][0])
    assert np.array_equal(y.cpu().numpy(), data[0][1])
    pf.close()
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_a_prefetched_step_makes_no_host_sync(cuda):
    """Consuming a prefetched batch (the stream waits on the copy's
    event, ``record_stream``) and training on it run under
    ``set_sync_debug_mode("error")``."""
    model = resnet18(num_classes=10, device=cuda, seed=0)
    _, step = _step(model)
    data = _batches(4, seed=1)
    pf = step.prefetch(data, depth=2)
    batches = iter(pf)
    float(step(*next(batches)))                 # warm-up, outside
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = [step(x, y) for x, y in batches]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(losses) == 3 and all(torch.isfinite(v) for v in losses)
    stats = pf.get_stats()
    assert stats["batches"] == 4 and stats["h2d_ms"]["count"] == 4


@pytest.mark.gpu
def test_guarded_resnet_step_rolls_back_bit_for_bit(cuda):
    model = resnet18(num_classes=10, device=cuda, seed=0)
    opt, step = _step(model, guard_nonfinite=True)
    (x, y), (x2, y2) = [(torch.from_numpy(a).to(cuda),
                         torch.from_numpy(b).to(cuda))
                        for a, b in _batches(2, seed=2)]
    step(x, y)
    before = [t.clone() for t in model.state_dict().values()] + [
        v.clone() for v in opt._accumulators["velocity"].values()]
    bad = x2.clone()
    bad[0, 0, 0, 0] = float("inf")
    loss = step(bad, y2)
    after = list(model.state_dict().values()) + list(
        opt._accumulators["velocity"].values())
    assert not torch.isfinite(loss)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert opt._step_count == 1
    assert torch.isfinite(step(x2, y2))


@pytest.mark.gpu
def test_save_on_the_card_load_on_the_cpu(cuda, tmp_path):
    model = resnet18(num_classes=10, device=cuda, seed=3)
    opt, step = _step(model)
    x, y = (torch.from_numpy(a).to(cuda) for a in _batches(1, seed=3)[0])
    step(x, y)
    path = str(tmp_path / "resnet18.pdparams")
    pt.save({"model": convert.state_dict_to_jax(model.state_dict(),
                                                model=model, tensors=True),
             "opt": convert.optimizer_state_to_jax(opt.state_dict(), model,
                                                   opt)}, path)
    ck = pt.load(path)
    cpu = resnet18(num_classes=10, device="cpu", seed=4)
    cpu.load_state_dict(convert.state_dict_from_jax(ck["model"], model=cpu))
    cpu_opt = Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=cpu.parameters())
    cpu_opt.set_state_dict(convert.optimizer_state_from_jax(ck["opt"], cpu,
                                                            cpu_opt))
    for k, t in model.state_dict().items():
        assert torch.equal(t.cpu(), cpu.state_dict()[k]), k
    for (n, p), q in zip(model.named_parameters(), cpu.parameters()):
        assert torch.equal(opt._accumulators["velocity"][p].cpu(),
                           cpu_opt._accumulators["velocity"][q]), n
    assert cpu_opt._step_count == 1
