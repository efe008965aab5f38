"""The zero-bubble ring on a CUDA card (`chip_smoke.py` phase 27 at tiny
size).

These run only on a CUDA card (marker ``gpu``; each test skips without
one). The file imports torch, numpy and the port only, so it runs on a
machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_zero_bubble_gpu.py

* a ring of one stage in this process over a tiny bf16
  `GPTForCausalLMPipe` at 1024 tokens (where causal attention takes
  splash): the AD ring launches splash's forward twice a layer and
  micro-batch and its backward once, the zero-bubble ring its forward
  three times (the ring, the dX tick's recompute, the fold's) and its
  backward twice; the two losses bit for bit, the grads within 2e-2 of
  each tensor's largest element;
* two ranks (pp 2) on the card over gloo
  (`pipeline_selftest.launch_card(zb=True, tiny=True)`): a tiny fp32
  zero-bubble pipe and `zb_linear_pipeline` against the same ranks on
  the CPU (loss 1e-4, grads 1e-3 relative; outputs 1e-5, grads 1e-4).
"""
import pytest
import torch

pytestmark = pytest.mark.gpu

TINY = dict(vocab_size=256, hidden_size=128, num_layers=2,
            num_attention_heads=2, max_position_embeddings=1024,
            hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: splash has no CPU route")
    return torch.device("cuda")


def test_ring_of_one_launches(cuda):
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLMPipe,
                                         GPTPretrainingCriterion)
    from paddle_tpu_torch.ops.kernels import splash_attention as sa

    env.init_parallel_env(backend="gloo", device="cuda")
    try:
        g = torch.Generator().manual_seed(0)
        ids, labels = (torch.randint(0, TINY["vocab_size"], (2, 1024),
                                     generator=g).to(cuda) for _ in range(2))
        model = GPTForCausalLMPipe(GPTConfig(**TINY), num_stages=1,
                                   num_micro=2, device=cuda,
                                   dtype=torch.bfloat16)
        model.train()
        L, M = TINY["num_layers"], 2
        got = {}
        for zb in (False, True):
            model.use_zero_bubble = zb
            before = (sa.splash_attention_fwd.launches_wgmma,
                      sa.splash_attention_bwd.launches_wgmma)
            loss = GPTPretrainingCriterion()(model(ids), labels)
            loss.backward()
            ran = (sa.splash_attention_fwd.launches_wgmma - before[0],
                   sa.splash_attention_bwd.launches_wgmma - before[1])
            assert ran == ((3 if zb else 2) * L * M, (2 if zb else 1) * L * M)
            got[zb] = (float(loss), {k: p.grad.float() for k, p in
                                     model.named_parameters()})
            model.zero_grad(set_to_none=True)
        assert got[True][0] == got[False][0]
        for k, g in got[False][1].items():
            gap = float((got[True][1][k] - g).abs().max() / g.abs().max())
            assert gap < 2e-2, (k, gap)
    finally:
        env.reset()


def test_ranks_on_the_card_against_the_cpu(cuda):
    from paddle_tpu_torch.distributed import pipeline_selftest

    res = pipeline_selftest.launch_card(2, zb=True, tiny=True, deadline=300)
    for r in res["zb_card_cpu"]["ranks"]:
        assert r["gpt_loss_diff"] < 1e-4 and r["gpt_max_grad_rel"] < 1e-3, r
        assert r["lin_max_out_diff"] < 1e-5, r
        assert r["lin_max_grad_rel"] < 1e-4, r
