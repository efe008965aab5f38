"""The pp axis on a CUDA card: the pipelined scan's kernels and gloo ranks
sharing the card (`chip_smoke.py` phase 25 at tiny size).

These run only on a CUDA card (marker ``gpu``; each test skips without
one). The file imports torch, numpy and the port only, so it runs on a
machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_pp_gpu.py

* a pp of degree 1 (the ring of one stage) over a tiny bf16-compute scan
  GPT in this process: a step launches splash's forward on each layer
  and micro-batch twice (the ring and the recompute), its backward once,
  the CE's forward and backward once each, and its loss equals
  `FusedScanTrainStep`'s within 2e-2;
* two ranks (pp 2) and four (pp 2 x mp 2) on the card over gloo
  (`pipeline_selftest.launch_card(tiny=True)`): the tiny fp32 scan GPT
  against the same ranks on the CPU (loss 5e-4, parameters 5e-3
  relative); at pp 2 also `PipelineParallel.train_batch` and
  `GPTForCausalLMPipe` against one rank running the whole model (loss
  1e-4, parameters or grads 1e-3 relative).
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
        pytest.skip("needs a CUDA card: splash and the CE have no CPU route")
    return torch.device("cuda")


def _model(dev):
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    model = GPTForCausalLM(GPTConfig(**TINY, scan_layers=True), device=dev,
                           seed=0)
    model.train()
    return model


def test_pp1_ring_launches_the_kernels(cuda):
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.jit import FusedScanTrainStep, PipelineScanTrainStep
    from paddle_tpu_torch.ops.kernels import fused_cross_entropy as fce
    from paddle_tpu_torch.ops.kernels import splash_attention as sa
    from paddle_tpu_torch.optimizer import AdamW

    env.init_parallel_env(backend="gloo", device="cuda")
    try:
        mesh = env.build_mesh({"pp": 1, "dp": 1})
        env.set_mesh(mesh)
        g = torch.Generator().manual_seed(0)
        # 1024 tokens: the length from which causal attention without
        # segments takes splash (FLAGS_pallas_flash_min_seqlen)
        ids, labels = (torch.randint(0, TINY["vocab_size"], (4, 1024),
                                     generator=g).to(cuda) for _ in range(2))
        model = _model(cuda)
        step = PipelineScanTrainStep(
            model, AdamW(parameters=model.parameters()), mesh=mesh,
            num_micro=2, fused_head=True, compute_dtype="bfloat16",
            numerics=False)
        counters = [(sa.splash_attention_fwd, "launches_wgmma"),
                    (sa.splash_attention_bwd, "launches_wgmma"),
                    (fce.fused_ce_fwd, "launches_wgmma"),
                    (fce.fused_ce_bwd, "launches")]
        before = [getattr(f, a) for f, a in counters]
        loss = float(step(ids, labels))
        got = [getattr(f, a) - b for (f, a), b in zip(counters, before)]
        L, M = TINY["num_layers"], 2
        assert got == [2 * L * M, L * M, 1, 1], got
        ref = _model(cuda)
        want = float(FusedScanTrainStep(
            ref, AdamW(parameters=ref.parameters()), fused_head=True,
            compute_dtype="bfloat16", numerics=False)(ids, labels))
        assert abs(loss - want) < 2e-2, (loss, want)
    finally:
        env.reset()


@pytest.mark.parametrize("n, mp", [(2, 1), (4, 2)], ids=["pp2", "pp2mp2"])
def test_ranks_on_the_card_against_the_cpu(cuda, n, mp):
    from paddle_tpu_torch.distributed import pipeline_selftest

    res = pipeline_selftest.launch_card(n, tiny=True, tiny_mp=mp,
                                        deadline=300)
    t = res["tiny_card_cpu"]
    assert t["max_loss_diff"] < 5e-4 and t["max_param_rel"] < 5e-3, t
    if mp == 1:
        pl = res["pipe_layers"]["pipeline_parallel"]
        assert pl["max_loss_diff"] < 1e-4 and pl["max_param_rel"] < 1e-3
        for nc in (1, 2):
            g = res["pipe_layers"][f"gpt_pipe_c{nc}"]
            assert abs(g["loss"] - g["plain"]) < 1e-4, g
            assert g["max_grad_rel"] < 1e-3, g
