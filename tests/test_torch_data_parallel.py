"""`DataParallel`, the topology, ``fleet.init`` and
`DistributedBatchSampler` of the port, in 2 and 4 gloo ranks on the CPU
(`sharding_selftest`'s ``data_parallel`` case, no jax, under the
launcher's deadline), against the JAX package's.

* `DataParallel`: the reference's ``TestDataParallel`` case
  (tests/test_distributed.py:253-278): a Linear(4, 2) from the
  reference's seed takes one SGD step on 8 rows, each rank on its rows;
  the weights within rtol 1e-5 of the reference's DataParallel on a
  ``dp`` mesh of the same degree. Rank 0's weights are broadcast at
  construction (the other ranks start from others); one all-reduce a
  bucket; inside ``no_sync`` the grads stay local and the next backward
  averages them all.
* The topology: `CommunicateTopology`'s arithmetic equal to the
  reference's (``TestTopology``, :198-225), and `HybridCommunicateGroup`
  and ``fleet.init`` over the world: degrees, ranks, groups; an mp
  degree of the world gives the model axis and `TensorParallel`, a pp
  degree the pipe axis (stages, ring neighbours, `HybridParallel`), a
  sep degree the sequence axis (its group, the dp+sep group,
  `SegmentParallel`); a sharded optimizer beside it raises, naming
  ROADMAP A9b.5b.
* `DistributedBatchSampler`: every rank's batches equal the reference's
  for that rank, with and without shuffling and ``drop_last``.
"""
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.io as jio
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as popt
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed.fleet import CommunicateTopology as JTopo
from paddle_tpu.distributed.fleet import HybridCommunicateGroup as JHCG
from paddle_tpu_torch.distributed.fleet import CommunicateTopology
from paddle_tpu_torch.distributed.sharding_selftest import launch

DATASET = 23


def _case():
    x = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    y = np.random.RandomState(1).randn(8, 2).astype(np.float32)
    paddle.seed(0)
    m = jnn.Linear(4, 2)
    return (np.asarray(m.weight._data).copy(), np.asarray(m.bias._data)
            .copy(), x, y)


def _reference_dp(n):
    w, b, x, y = _case()
    jenv.reset()
    jenv.set_mesh(jenv.build_mesh({"dp": n}))
    try:
        paddle.seed(0)
        m = jnn.Linear(4, 2)
        dp = jdist.DataParallel(m)
        opt = popt.SGD(learning_rate=0.1, parameters=dp.parameters())
        tx, ty = paddle.to_tensor(x), paddle.to_tensor(y)
        loss = ((dp(tx) - ty) * (dp(tx) - ty)).mean()
        loss.backward()
        opt.step()
        return np.asarray(m.weight._data), np.asarray(m.bias._data)
    finally:
        jenv.reset()


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def world(request):
    n = request.param
    w, b, x, y = _case()
    ranks = launch("data_parallel", n, dict(w=w, b=b, x=x, y=y,
                                            dataset=DATASET),
                   timeout=60, deadline=120)
    return n, ranks


def test_data_parallel_matches_the_reference(world):
    n, ranks = world
    want_w, want_b = _reference_dp(n)
    for out in ranks:
        np.testing.assert_allclose(out["weight"], want_w, rtol=1e-5)
        np.testing.assert_allclose(out["bias"], want_b, rtol=1e-5,
                                   atol=1e-7)
        assert out["dp_all_reduces"] == 1          # one bucket


def test_no_sync_keeps_grads_local_then_averages(world):
    n, ranks = world
    locals_ = [out["no_sync_local"] for out in ranks]
    assert any(not np.allclose(locals_[0], v) for v in locals_[1:])
    # the synced grad: the mean over ranks of (no_sync grad + one more
    # backward's grad, equal to it: the same rows and weights)
    want = sum(2 * v for v in locals_) / n
    for out in ranks:
        np.testing.assert_allclose(out["no_sync_synced"], want, rtol=1e-5,
                                   atol=1e-6)


def test_topology_matches_the_reference():
    for dims in [(2, 2, 1, 1, 2), (1, 4, 2, 1, 1), (2, 1, 2, 2, 1)]:
        got, want = CommunicateTopology(dims=dims), JTopo(dims=dims)
        assert got.world_size() == want.world_size()
        for r in range(want.world_size()):
            assert got.get_coord(r) == want.get_coord(r)
            assert got.get_rank(**dict(zip(
                got.get_hybrid_group_names(), want.get_coord(r)))) == r
        for name in want.get_hybrid_group_names():
            assert got.get_comm_list(name) == want.get_comm_list(name)
            assert got.get_axis_list(name, 0) == want.get_axis_list(name, 0)
            assert got.get_dim(name) == want.get_dim(name)


def test_hybrid_group_and_fleet_init_over_the_world(world):
    n, ranks = world
    jenv.reset()
    try:
        want = JHCG(JTopo(dims=(1, 2, n // 2, 1, 1)))
        expect = [want.get_data_parallel_world_size(),
                  want.get_sharding_parallel_world_size(),
                  want.get_model_parallel_world_size(),
                  want.get_pipe_parallel_world_size()]
        groups = [want.get_data_parallel_group().nranks,
                  want.get_sharding_parallel_group().nranks]
    finally:
        jenv.reset()
    for r, out in enumerate(ranks):
        assert list(out["hcg"][:4]) == expect
        # rank r sits at (dp, sharding) = divmod(r, n // 2)
        assert list(out["hcg"][4:6]) == list(divmod(r, n // 2))
        assert list(out["hcg"][6:]) == groups
        dp_line, sh_line = out["hcg_groups"]
        assert dp_line == [r % (n // 2) + k * (n // 2) for k in range(2)]
        assert sh_line == [(r // (n // 2)) * (n // 2) + k
                           for k in range(n // 2)]
        assert list(out["fleet"]) == [n, r, int(r == 0), n]
        assert out["fleet_model"] == "DataParallel"
        # mp at the world's degree runs (the model axis, TensorParallel);
        # so does pp (the pipe axis: rank r is stage r, its ring
        # neighbours r + 1 and r - 1, a model that is not a PipelineLayer
        # HybridParallel), and sep (the sequence axis: rank r its block r,
        # SegmentParallel); a sharded optimizer beside sep raises, naming
        # A9b.5b
        assert out["mp_fleet"] == [n, r, 1, "TensorParallel"]
        assert out["pp_fleet"] == [n, r, r == 0, r == n - 1, (r + 1) % n,
                                   (r - 1) % n, "HybridParallel"]
        assert out["sep_fleet"] == [n, r, list(range(n)), list(range(n)),
                                    "SegmentParallel"]
        assert "A9b.5b" in out["refuse_sep_sharding"]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_distributed_batch_sampler_is_the_reference_split(world, shuffle,
                                                          drop_last):
    n, ranks = world
    ds = list(range(DATASET))
    for r, out in enumerate(ranks):
        want = jio.DistributedBatchSampler(ds, batch_size=3, num_replicas=n,
                                           rank=r, shuffle=shuffle,
                                           drop_last=drop_last)
        want.set_epoch(2)
        assert out[f"sampler_{shuffle}_{drop_last}"] == \
            [list(b) for b in want]
        assert out[f"sampler_len_{shuffle}_{drop_last}"] == len(want)
