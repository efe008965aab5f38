"""The port's gradient buckets (`paddle_tpu_torch.distributed.
comm_bucketer`) against the JAX package's.

`build_buckets` is held to the reference's assignment entry for entry
(keys, offsets, sizes, padding, dtypes) on GPT's and BERT's named
parameter shapes at several caps and degrees, in this process. The
bucketed collectives run in 2 and 4 gloo ranks
(`sharding_selftest`'s ``buckets`` case, no jax, under the launcher's
deadline) and are held to the reference's on a CPU mesh of the same
degree: the bucketed all-reduce of tensors every rank holds equals the
reference's within 1e-6 relative, the bucketed reduce-scatter's shard r
equals block r of the reference's result packed in the same buckets;
each rank's own tensors sum as numpy sums them; one collective runs a
bucket; `GradBucketer` leaves the mean's shard and drops every grad.
"""
import functools

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed import comm_bucketer as jcb
from paddle_tpu.distributed import env as jenv
from paddle_tpu.models import BertConfig as JBertConfig
from paddle_tpu.models import BertForPretraining as JBert
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu_torch.distributed import comm_bucketer as tcb
from paddle_tpu_torch.distributed.sharding_selftest import start
from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                     GPTConfig, GPTForCausalLM)

GPT = dict(vocab_size=512, hidden_size=128, num_layers=3,
           num_attention_heads=4, max_position_embeddings=64)
BERT = dict(vocab_size=256, hidden_size=64, num_layers=2,
            num_attention_heads=4, max_position_embeddings=64)
SHAPES = [(64, 16), (16,), (7, 5), (33,), (16, 8)]
MBS = [0, 25]


def _named_shapes(model):
    return [(n, tuple(p.shape), p._data.dtype)
            for n, p in model.named_parameters()]


@functools.lru_cache(maxsize=1)
def _jax_models():
    paddle.seed(0)
    return {"gpt": JGPT(JGPTConfig(**GPT)),
            "gpt_scan": JGPT(JGPTConfig(**GPT, scan_layers=True)),
            "bert": JBert(JBertConfig(**BERT))}


@functools.lru_cache(maxsize=1)
def _port_models():
    return {"gpt": GPTForCausalLM(GPTConfig(**GPT), device="cpu"),
            "gpt_scan": GPTForCausalLM(GPTConfig(**GPT, scan_layers=True),
                                       device="cpu"),
            "bert": BertForPretraining(BertConfig(**BERT), device="cpu")}


def _as_tuples(assign):
    return [(str(np.dtype(b.dtype)) if not isinstance(b.dtype, torch.dtype)
             else str(b.dtype).split(".")[-1], b.numel,
             [(e.key, e.offset, e.numel) for e in b.entries])
            for b in assign.buckets]


@pytest.mark.parametrize("model", ["gpt", "gpt_scan", "bert"])
@pytest.mark.parametrize("cap", [1, 64 << 10, 1 << 20, 25 << 20])
@pytest.mark.parametrize("degree", [1, 2, 4, 8])
def test_build_buckets_is_the_reference_assignment(model, cap, degree):
    jm, tm = _jax_models()[model], _port_models()[model]
    shapes = _named_shapes(jm)
    want = jcb.build_buckets(shapes, bucket_bytes=cap, pad_multiple=degree)
    got = tcb.build_buckets(shapes, bucket_bytes=cap, pad_multiple=degree)
    assert _as_tuples(got) == _as_tuples(want)
    assert got.bucket_bytes == want.bucket_bytes
    assert got.pad_multiple == want.pad_multiple
    # the port's own parameters, in its order, give the same assignment
    # (a Linear weight is transposed: the same size)
    port = tcb.build_buckets(
        [(n, tuple(p.shape), p.dtype) for n, p in tm.named_parameters()],
        bucket_bytes=cap, pad_multiple=degree)
    assert _as_tuples(port) == _as_tuples(want)
    assert all(b.numel % degree == 0 for b in got.buckets)


def test_mixed_dtypes_split_buckets():
    shapes = [("a", (4,), "float32"), ("b", (3,), "bfloat16"),
              ("c", (5,), "bfloat16"), ("d", (2, 2), "float32")]
    want = jcb.build_buckets([(k, s, jnp.dtype(d)) for k, s, d in shapes],
                             bucket_bytes=1 << 20, pad_multiple=4)
    got = tcb.build_buckets(shapes, bucket_bytes=1 << 20, pad_multiple=4)
    assert _as_tuples(got) == _as_tuples(want)
    assert [b.nbytes for b in got.buckets] == [b.nbytes
                                               for b in want.buckets]


def _reference(n, data, mb):
    jenv.reset()
    jenv.set_mesh(jenv.build_mesh({"dp": n}))
    try:
        ts = [paddle.to_tensor(a) for a in data]
        ar = [np.asarray(t._data) for t in
              jcb.bucketed_all_reduce(ts, bucket_mb=mb, quant="")]
        ts = [paddle.to_tensor(a) for a in data]
        rs = [np.asarray(t._data) for t in
              jcb.bucketed_reduce_scatter(ts, bucket_mb=mb)]
    finally:
        jenv.reset()
    return ar, rs


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def world(request):
    n = request.param
    job = start("buckets", n, {"shapes": SHAPES, "bucket_mbs": MBS},
                timeout=60)
    rng = np.random.default_rng(0)
    same = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    try:        # the reference, while the ranks run
        ref = {mb: _reference(n, same, mb) for mb in MBS}
    finally:
        ranks = job.wait(deadline=120)
    return n, ranks, same, ref


@pytest.mark.parametrize("mb", MBS)
def test_bucketed_collectives_match_the_reference(world, mb):
    n, ranks, same, ref = world
    ar, rs = ref[mb]
    assign = tcb.build_buckets([(i, s, "float32")
                                for i, s in enumerate(SHAPES)],
                               bucket_bytes=max(mb << 20, 1),
                               pad_multiple=n)
    for r, out in enumerate(ranks):
        for got, want in zip(out[f"ar_same_{mb}"], ar):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert out[f"rs_numel_{mb}"] == [b.numel for b in assign.buckets]
        for b, shard in zip(assign.buckets, out[f"rs_same_{mb}"]):
            whole = tcb.pack(b, lambda i: torch.from_numpy(rs[i].copy()))
            s = b.numel // n
            np.testing.assert_allclose(shard, whole[r * s:(r + 1) * s]
                                       .numpy(), rtol=1e-6, atol=1e-6)
        nb = len(assign.buckets)
        assert out[f"ar_calls_same_{mb}"] == nb
        assert out[f"rs_calls_same_{mb}"] == nb


@pytest.mark.parametrize("mb", MBS)
def test_each_ranks_own_tensors_sum(world, mb):
    n, ranks, _, _ = world
    mine = [[np.random.default_rng(10 + r).standard_normal(s)
             .astype(np.float32) for s in SHAPES] for r in range(n)]
    total = [sum(m[i] for m in mine) for i in range(len(SHAPES))]
    for out in ranks:
        for got, want in zip(out[f"ar_mine_{mb}"], total):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_grad_bucketer_keeps_the_means_shard_only(world):
    n, ranks, _, _ = world
    grads = [sum(np.random.default_rng(10 + r).standard_normal(s)
                 .astype(np.float32) * (r + 1) for r in range(n)) / n
             for s in SHAPES]
    assign = tcb.build_buckets([(f"p{i}", s, "float32")
                                for i, s in enumerate(SHAPES)],
                               bucket_bytes=max(MBS[0] << 20, 1),
                               pad_multiple=n)
    for r, out in enumerate(ranks):
        assert out["bucketer_released"]
        assert out["bucketer_buckets"] == len(assign.buckets)
        assert out["bucketer_calls"] == len(assign.buckets)
        for b, shard in zip(assign.buckets, out["bucketer_shards"]):
            whole = tcb.pack(b, lambda k: torch.from_numpy(
                grads[int(k[1:])]))
            s = b.numel // n
            np.testing.assert_allclose(shard, whole[r * s:(r + 1) * s]
                                       .numpy(), rtol=1e-6, atol=1e-6)
