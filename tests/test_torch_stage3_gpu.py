"""Sharding stage 3 on a CUDA card (`chip_smoke.py` phase 28 at tiny
size).

These run only on a CUDA card (marker ``gpu``; each test skips without
one). The file imports torch, numpy and the port only, so it runs on a
machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_stage3_gpu.py

* a world of one in this process: a tiny bf16 GPT with recompute at 1024
  tokens through ``group_sharded_parallel(level="p_g_os")`` +
  `TrainStep` (``model.loss``): a step launches splash's forward twice a
  layer, its backward once, the fused CE once each way, one
  ``mt_adam_kernel`` and one ``mt_norm_kernel``; its losses within 1e-3
  of a plain `TrainStep`'s; with ``offload=True`` the shards are pinned
  host memory and the losses bit for bit;
* two ranks on the card over gloo
  (`sharding_selftest.launch_stage3_card(tiny=True)`): a tiny fp32 GPT
  under stage 3 against the same ranks on the CPU (loss 1e-4,
  parameters 1e-3 relative).
"""
import pytest
import torch

pytestmark = pytest.mark.gpu

TINY = dict(vocab_size=256, hidden_size=128, num_layers=2,
            num_attention_heads=2, max_position_embeddings=1024,
            hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
            use_recompute=True)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: splash and the CE have no CPU route")
    return torch.device("cuda")


def _run(dev, level=None, offload=False):
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops.kernels import fused_cross_entropy as fce
    from paddle_tpu_torch.ops.kernels import multi_tensor as mt
    from paddle_tpu_torch.ops.kernels import splash_attention as sa
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForCausalLM(GPTConfig(**TINY), device=dev,
                           dtype=torch.bfloat16, seed=0)
    model.train()
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                multi_precision=True, moment_dtype="bfloat16",
                grad_clip=ClipGradByGlobalNorm(1.0))
    wrapped = model
    if level is not None:
        wrapped, opt, _ = group_sharded_parallel(
            model, opt, level, segment_size=4096, offload=offload)
    step = TrainStep(wrapped, lambda m, x, y: m.loss(x, y), opt,
                     numerics=False)
    g = torch.Generator().manual_seed(0)
    ids, labels = (torch.randint(0, TINY["vocab_size"], (2, 1024),
                                 generator=g).to(dev) for _ in range(2))
    counters = [(sa.splash_attention_fwd, "launches_wgmma"),
                (sa.splash_attention_bwd, "launches_wgmma"),
                (fce.fused_ce_fwd, "launches_wgmma"),
                (fce.fused_ce_bwd, "launches"),
                (mt.multi_tensor_adam, "launches"),
                (mt.multi_tensor_norm, "launches")]
    losses = []
    for _ in range(3):
        before = [getattr(f, a) for f, a in counters]
        losses.append(float(step(ids, labels)))
        ran = [getattr(f, a) - b for (f, a), b in zip(counters, before)]
    return losses, ran, wrapped


def test_world_of_one_launches_and_offload(cuda):
    from paddle_tpu_torch.distributed import env

    env.init_parallel_env(backend="gloo", device="cuda")
    try:
        plain, _, _ = _run(cuda)
        got, ran, wrapped = _run(cuda, "p_g_os")
        L = TINY["num_layers"]
        assert ran == [2 * L, L, 1, 1, 1, 1], ran
        assert max(abs(a - b) for a, b in zip(got, plain)) < 1e-3
        off, _, w = _run(cuda, "p_g_os", offload=True)
        assert off == got
        assert w._shards and all(st.shard.is_pinned() for st in w._shards)
    finally:
        env.reset()


def test_ranks_on_the_card_against_the_cpu(cuda):
    from paddle_tpu_torch.distributed import sharding_selftest

    t = sharding_selftest.launch_stage3_card(2, tiny=True,
                                             deadline=300)["tiny_card_cpu"]
    assert t["max_loss_diff"] < 1e-4 and t["max_param_rel"] < 1e-3, t
