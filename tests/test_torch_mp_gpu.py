"""The vocab-parallel head's kernels (#11 / #12 on a shard of W) on a
CUDA card, against their plain versions, and two gloo ranks sharing the
card.

These run only on a CUDA card (marker ``gpu``; each test skips without
one). The file imports torch, numpy and the port only, so it runs on a
machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_mp_gpu.py

Bars (phase 3's for #11 / #12): losses, lse and picked fp32 1e-4, bf16
2e-2 (lse 1e-3); dh and dW relative to the largest 1e-4 / 2e-2; every
shard bit-identical on a second call; the counters step once a shard.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import fused_cross_entropy as fce

pytestmark = pytest.mark.gpu

# (tokens, vocab, hidden): V/mp ends in a ragged 256-row tile at mp 2
# and 4, and a ragged 128-column tile of the plain version
CASES = [(200, 1000, 64), (333, 2056, 128)]
BARS = {torch.float32: (1e-4, 1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3,
                                                             2e-2)}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CE kernels have no CPU route")
    return torch.device("cuda")


def _inputs(dev, n, vocab, hidden, dtype, mp, seed=0):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(n, hidden, generator=g)
    w = torch.randn(vocab, hidden, generator=g) * 0.3
    lbl = torch.randint(0, vocab, (n,), generator=g)
    vloc = vocab // mp
    lbl[1::7] = vloc + torch.arange(len(lbl[1::7])) % 5   # the alias
    lbl[::20] = -100
    gr = torch.randn(n, generator=g)
    return (h.to(dev, dtype), w.to(dev, dtype), lbl.to(dev), gr.to(dev))


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-12))


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_shard_kernels_against_their_plain_version(cuda, case, dtype, mp):
    h, w, lbl, gr = _inputs(cuda, *case, dtype, mp)
    vloc = case[1] // mp
    fwd_bar, lse_bar, bwd_bar = BARS[dtype]
    fwd_counter = "launches_wgmma" if dtype == torch.bfloat16 \
        else "launches"
    shards = []
    for r in range(mp):
        wl = w[r * vloc:(r + 1) * vloc].contiguous()
        before = (getattr(fce.fused_ce_fwd, fwd_counter),
                  fce.fused_ce_bwd.launches)
        lse, pk = fce.sharded_fused_ce_fwd(h, wl, lbl, r * vloc)
        lse2, pk2 = fce.sharded_fused_ce_fwd(h, wl, lbl, r * vloc)
        assert torch.equal(lse, lse2) and torch.equal(pk, pk2)
        want_lse, want_pk = fce.sharded_fused_ce_fwd_ref(h, wl, lbl,
                                                         r * vloc)
        assert (lse - want_lse).abs().max() < lse_bar
        assert (pk - want_pk).abs().max() < fwd_bar
        shards.append((wl, lse, pk))
        assert getattr(fce.fused_ce_fwd, fwd_counter) == before[0] + 2
    lse = torch.stack([s[1] for s in shards])
    mx = lse.max(0).values
    glob = mx + torch.log(torch.exp(lse - mx).sum(0))
    pk = torch.stack([s[2] for s in shards]).sum(0)
    losses = torch.where(lbl != -100, glob - pk, torch.zeros((), device=cuda))
    full_loss, full_lse = fce.fused_ce_fwd(h, w, lbl)
    assert (losses - full_loss).abs().max() < fwd_bar * 4
    assert (glob - full_lse).abs().max() < lse_bar * 4
    g_eff = torch.where(lbl != -100, gr, torch.zeros((), device=cuda))
    dh_sum, dws = 0, []
    for r, (wl, _, _) in enumerate(shards):
        before = fce.fused_ce_bwd.launches
        dh, dw = fce.sharded_fused_ce_bwd(h, wl, lbl, r * vloc, glob, g_eff)
        dh2, dw2 = fce.sharded_fused_ce_bwd(h, wl, lbl, r * vloc, glob,
                                            g_eff)
        assert fce.fused_ce_bwd.launches == before + 2
        assert torch.equal(dh, dh2) and torch.equal(dw, dw2)
        want_dh, want_dw = fce.sharded_fused_ce_bwd_ref(h, wl, lbl, r * vloc,
                                                        glob, g_eff)
        assert _rel(dh, want_dh) < bwd_bar and _rel(dw, want_dw) < bwd_bar
        dh_sum = dh_sum + dh.float()
        dws.append(dw)
    full_dh, full_dw = fce.fused_ce_bwd(h, w, lbl, full_lse, g_eff)
    assert _rel(dh_sum, full_dh) < bwd_bar * 2
    assert _rel(torch.cat(dws), full_dw) < bwd_bar * 2


def test_two_gloo_ranks_share_the_card(cuda):
    """`mp_selftest` under ``torch.distributed.run`` with two ranks on one
    card over gloo: a tiny scan GPT at mp 2 on the card against the same
    ranks on the CPU (the 1.3B run is chip_smoke.py's phase 24)."""
    code = (
        "import json, torch\n"
        "from paddle_tpu_torch.distributed import env, mp_selftest as m\n"
        "dev = env.init_parallel_env(backend='gloo', device='cuda',"
        " timeout=300)\n"
        "m._init_mp(1, env.get_world_size())\n"
        "r = m.tiny_card_cpu(dev)\n"
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
