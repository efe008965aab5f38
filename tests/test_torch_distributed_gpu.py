"""The dp and sharding axes on a CUDA card: every collective at a world
of one rank over NCCL, and `ShardedFusedScanTrainStep` on a 2-layer scan
GPT.

These run only on a CUDA card (marker ``gpu``; each test skips without
one). The file imports torch, numpy and the port only, so it runs on a
machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_distributed_gpu.py
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import env
from paddle_tpu_torch.distributed.sharding_selftest import check_world1
from paddle_tpu_torch.jit import FusedScanTrainStep, ShardedFusedScanTrainStep
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs the collectives there")
    dev = env.init_parallel_env(timeout=120)
    yield dev
    env.reset()


def test_every_collective_at_world_one_on_the_card(world):
    assert env.get_backend() == "nccl"
    res = check_world1(world)
    assert all(res.values()) and len(res) >= 40


def test_sharded_scan_on_the_card(world):
    """Both storages bit-identical; within 1e-4 of `FusedScanTrainStep`
    on the same card (the sharded step's clip takes its scale outside the
    norm kernel)."""
    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                    num_attention_heads=4, max_position_embeddings=64,
                    scan_layers=True)
    rng = np.random.default_rng(0)
    sd = {k: torch.from_numpy((rng.standard_normal(tuple(t.shape)) * 0.3)
                              .astype(np.float32))
          for k, t in GPTForCausalLM(cfg, device="cpu").state_dict().items()}
    ids = torch.from_numpy(rng.integers(0, 128, (4, 64))).to(world)
    labels = torch.from_numpy(rng.integers(0, 128, (4, 64))).to(world)
    out = {}
    for kind in ("fused", "replicated", "sharded"):
        model = GPTForCausalLM(cfg, device=world)
        model.load_state_dict(sd)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
        step = (FusedScanTrainStep(model, opt, fused_head=True)
                if kind == "fused" else
                ShardedFusedScanTrainStep(model, opt, fused_head=True,
                                          param_storage=kind))
        losses = [float(step(ids, labels)) for _ in range(3)]
        out[kind] = (losses, {k: v.detach().cpu().clone()
                              for k, v in model.state_dict().items()})
    assert out["replicated"][0] == out["sharded"][0]
    for k, v in out["replicated"][1].items():
        assert torch.equal(v, out["sharded"][1][k]), k
    assert max(abs(a - b) for a, b in zip(out["fused"][0],
                                          out["sharded"][0])) < 1e-4
