"""BERT and ``Model.fit`` on a CUDA card: masked attention with dropout,
a BERT-base O2 fine-tune step, and LeNet through ``paddle_tpu_torch.Model``.

These run only on a CUDA card (marker ``gpu``; each test skips without
one). The file imports torch, numpy and the port only, so it runs on a
machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_bert_gpu.py
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.amp import decorate
from paddle_tpu_torch.io import Subset
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.metric import Accuracy
from paddle_tpu_torch.models import (BertConfig,
                                     BertForSequenceClassification,
                                     bert_config)
from paddle_tpu_torch.nn import CrossEntropyLoss, LayerNorm
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops.kernels import multi_tensor
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.vision.datasets import MNIST
from paddle_tpu_torch.vision.models import LeNet


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the masked attention runs there as "
                    "aten ops, the optimizer as the port's kernel")
    return torch.device("cuda")


def _tokens(b, s, vocab, seed=0, low=None):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s))
    lengths = rng.integers(low or s // 4, s + 1, (b,))
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int64)
    return torch.from_numpy(ids), torch.from_numpy(mask)


@pytest.mark.gpu
def test_masked_sdpa_on_the_card_equals_the_cpu(cuda):
    """A bool and an additive mask, and dropout from one generator: the
    card's dense path against the CPU's (fp32 1e-4); dropout replays
    with the generator's seed."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 64, 4, 32, generator=g) for _ in range(3))
    keep = torch.rand(2, 4, 64, 64, generator=g) > 0.3
    keep[..., torch.arange(64), torch.arange(64)] = True
    for mask in (keep, torch.where(keep, 0.0, -1e9)):
        want = PF.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        got = PF.scaled_dot_product_attention(
            q.to(cuda), k.to(cuda), v.to(cuda), attn_mask=mask.to(cuda))
        assert float((got.cpu() - want).abs().max()) <= 1e-4
    qc = q.to(cuda)
    runs = [PF.scaled_dot_product_attention(
        qc, qc, qc, dropout_p=0.1,
        generator=torch.Generator(device=cuda).manual_seed(s))
        for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0],
                                                             runs[2])
    qkv = torch.stack([qc, qc, qc], dim=2)
    packed = [PF.flash_attn_qkvpacked(
        qkv, dropout=0.1,
        generator=torch.Generator(device=cuda).manual_seed(1))[0]
        for _ in range(2)]
    assert torch.equal(packed[0], packed[1])
    assert torch.equal(packed[0], runs[0])


@pytest.mark.gpu
def test_bert_on_the_card_equals_the_cpu(cuda):
    cfg = BertConfig(hidden_size=64, num_layers=2, num_attention_heads=4,
                     vocab_size=512, hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    cpu = BertForSequenceClassification(cfg, device="cpu", seed=1)
    card = BertForSequenceClassification(cfg, device=cuda, seed=1)
    card.load_state_dict(cpu.state_dict())
    ids, mask = _tokens(4, 64, 512, low=17)
    with torch.no_grad():
        want = cpu(ids, attention_mask=mask)
        got = card(ids.to(cuda), attention_mask=mask.to(cuda))
    assert float((got.cpu() - want).abs().max()) <= 1e-4


@pytest.mark.gpu
def test_bert_base_o2_step_on_the_card(cuda):
    """BERT-base (hidden 768, 12 layers, vocab 30522) with dropout 0.1,
    O2 bf16, AdamW with fp32 masters: two steps at 8 x 128, finite
    losses near ln 2, the LayerNorms in fp32, two ``mt_adam_kernel`` a
    step (one a dtype group: the bf16 weights with fp32 masters, the
    fp32 LayerNorms)."""
    model = BertForSequenceClassification(bert_config("bert-base"),
                                          num_classes=2, device=cuda)
    opt = AdamW(learning_rate=2e-5, parameters=model.parameters(),
                multi_precision=True)
    model, opt = decorate(models=model, optimizers=opt, level="O2")
    for m in model.modules():
        if isinstance(m, LayerNorm):
            assert m.weight.dtype == torch.float32
    crit = CrossEntropyLoss()
    step = TrainStep(model, lambda m, i, k, y: crit(
        m(i, attention_mask=k), y), opt)
    ids, mask = _tokens(8, 128, 30522, low=32)
    y = torch.from_numpy(np.random.default_rng(1).integers(0, 2, (8,)))
    multi_tensor.multi_tensor_adam.launches = 0
    losses = [float(step(ids.to(cuda), mask.to(cuda), y.to(cuda)))
              for _ in range(2)]
    assert all(math.isfinite(v) for v in losses), losses
    assert abs(losses[0] - math.log(2)) < 0.5, losses
    assert multi_tensor.multi_tensor_adam.launches == 4


@pytest.mark.gpu
def test_lenet_model_fit_on_the_card(cuda, tmp_path):
    net = LeNet(device=cuda)
    model = pt.Model(net)
    model.prepare(Adam(learning_rate=1e-3, parameters=net.parameters()),
                  CrossEntropyLoss(), Accuracy())
    train = Subset(MNIST(mode="train"), range(512))
    test = Subset(MNIST(mode="test"), range(256))
    model.fit(train, batch_size=64, epochs=1, verbose=0, prefetch=True)
    assert model.input_pipeline_stats["batches"] == 8
    logs = model.evaluate(test, batch_size=64, verbose=0)
    out = model.predict(test, batch_size=64, stack_outputs=True)[0]
    labels = np.concatenate([test[i][1] for i in range(256)])
    assert math.isfinite(logs["loss"][0])
    assert logs["acc"] == float((out.argmax(1) == labels).mean())
    model.save(str(tmp_path / "lenet"))
    again = pt.Model(LeNet(device=cuda, seed=9))
    again.prepare(Adam(parameters=again.network.parameters()))
    again.load(str(tmp_path / "lenet"))
    for a, b in zip(again.network.state_dict().values(),
                    net.state_dict().values()):
        assert torch.equal(a, b)
