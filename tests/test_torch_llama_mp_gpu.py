"""LLaMA under mp on a CUDA card: the vocab-parallel head's kernels (#11 /
#12) on the shards of LLaMA-7B's head against their plain versions, and
a tiny LLaMA at mp 2 in two gloo ranks sharing the card against the same
ranks on the CPU.

These run only on a CUDA card (marker ``gpu``; each test skips without
one). The file imports torch, numpy and the port only, so it runs on a
machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_llama_mp_gpu.py

Bars (phase 3's for #11 / #12 in bf16): lse 1e-3, picked 2e-2; dh and dW
relative to the largest 2e-2; every shard bit-identical on a second
call; the counters step once a call.
"""
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from paddle_tpu_torch.ops.kernels import fused_cross_entropy as fce

pytestmark = pytest.mark.gpu

# LLaMA-7B's head: 4 x 2048 tokens, vocab 32000, hidden 4096; V/mp =
# 16000 and 8000 rows, each shard ending in a ragged 256-row tile
HEAD = (8192, 32000, 4096)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CE kernels have no CPU route")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-12))


@pytest.mark.parametrize("mp", [2, 4])
def test_llama_7b_head_shards_against_their_plain_version(cuda, mp):
    n, vocab, hidden = HEAD
    g = torch.Generator(device=cuda).manual_seed(26)
    h = torch.randn(n, hidden, device=cuda, generator=g).bfloat16()
    w = (torch.randn(vocab, hidden, device=cuda, generator=g) * 0.02) \
        .bfloat16()
    lbl = torch.randint(0, vocab, (n,), device=cuda, generator=g)
    lbl[::20] = -100
    gr = torch.where(lbl != -100, torch.full((n,), 1.0 / n, device=cuda),
                     0.0)
    vloc = vocab // mp
    lse_r, pk_r = [], []
    for r in range(mp):
        wl = w[r * vloc:(r + 1) * vloc]
        before = fce.fused_ce_fwd.launches_wgmma
        lse, pk = fce.sharded_fused_ce_fwd(h, wl, lbl, r * vloc)
        assert fce.fused_ce_fwd.launches_wgmma == before + 1
        lse2, pk2 = fce.sharded_fused_ce_fwd(h, wl, lbl, r * vloc)
        assert torch.equal(lse, lse2) and torch.equal(pk, pk2)
        want_lse, want_pk = fce.sharded_fused_ce_fwd_ref(h, wl, lbl,
                                                         r * vloc)
        assert (lse - want_lse).abs().max() < 1e-3
        assert (pk - want_pk).abs().max() < 2e-2
        lse_r.append(lse)
        pk_r.append(pk)
    stacked = torch.stack(lse_r)
    mx = stacked.max(0).values
    glob = mx + torch.log(torch.exp(stacked - mx).sum(0))
    for r in range(mp):
        wl = w[r * vloc:(r + 1) * vloc]
        before = fce.fused_ce_bwd.launches
        dh, dw = fce.sharded_fused_ce_bwd(h, wl, lbl, r * vloc, glob, gr)
        assert fce.fused_ce_bwd.launches == before + 1
        dh2, dw2 = fce.sharded_fused_ce_bwd(h, wl, lbl, r * vloc, glob, gr)
        assert torch.equal(dh, dh2) and torch.equal(dw, dw2)
        want_dh, want_dw = fce.sharded_fused_ce_bwd_ref(h, wl, lbl, r * vloc,
                                                        glob, gr)
        assert _rel(dh, want_dh) < 2e-2 and _rel(dw, want_dw) < 2e-2


def test_tiny_llama_at_mp_2_card_against_cpu(cuda):
    """`llama_selftest.tiny_card_cpu` under ``torch.distributed.run``
    with two ranks on one card over gloo (LLaMA-7B's widths are
    chip_smoke.py's phase 26)."""
    code = (
        "import json, torch\n"
        "from paddle_tpu_torch.distributed import env, llama_selftest as m\n"
        "dev = env.init_parallel_env(backend='gloo', device='cuda',"
        " timeout=300)\n"
        "r = m.tiny_card_cpu(dev, mp=2)\n"
        "env.reset()\n"
        "print(json.dumps(r))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    got = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_addr", "127.0.0.1", "--master_port", str(port),
         "--no-python", sys.executable, "-c", code], capture_output=True,
        text=True, timeout=600, cwd=root)
    assert got.returncode == 0, got.stderr[-3000:]
    res = json.loads(got.stdout.strip().splitlines()[-1])
    assert res["max_loss_diff"] < 5e-4 and res["max_param_rel"] < 5e-3, res
