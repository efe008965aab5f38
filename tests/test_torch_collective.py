"""The port's collectives (`paddle_tpu_torch.distributed.collective`) in
2 and 4 gloo ranks on the CPU, against the JAX package's on a CPU mesh
``build_mesh({"dp": n})`` with each input sharded on dim 0: rank r's
result is held to block r of the reference's global result (the
contract of the port's collectives).

The ranks run `paddle_tpu_torch.distributed.sharding_selftest`'s
``collectives`` case (no jax) on seeded global arrays, one launch a
degree, under the launcher's deadline. Bars: gathers, broadcasts,
scatters, all-to-alls, MAX and MIN exact, in fp32 and bf16; fp32 sums
(SUM, AVG, the reduce-scatter, ``reduce``) within 1e-6 relative; PROD
within 1e-5 (the reference takes it as exp of a sum of logs); the
compressed all-reduce, int8 and bf16, within 1e-6 of the reference's and
within the reference's own ``comm_quant_selftest`` bar (L2 relative
error < 1e-2) of the exact sum. p2p round trips, object collectives, the
store and a mesh-axis group are held to their meaning.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
from jax.sharding import NamedSharding, PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import env as jenv
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

from paddle_tpu_torch.distributed.collective import quantized_sum_plain
from paddle_tpu_torch.distributed.sharding_selftest import (global_arrays,
                                                            start)

EXACT = ("all_gather", "all_gather_list", "all_gather_concat0",
         "all_gather_concat1", "broadcast", "scatter", "alltoall_single",
         "all_reduce_max", "all_reduce_min")
SUMS = ("all_reduce_sum", "all_reduce_avg", "reduce_scatter")


def _block(a, r, n):
    b = a.shape[0] // n
    return a[r * b:(r + 1) * b]


def _reference(n, dtype):
    """{name: the reference's global result} on the arrays of degree n."""
    arrs = global_arrays(n)
    jenv.reset()
    mesh = jenv.build_mesh({"dp": n})
    jenv.set_mesh(mesh)
    out = {}
    try:
        def sharded(a):
            return paddle.Tensor(jax.device_put(
                jnp.asarray(a, dtype), NamedSharding(mesh, P("dp"))))

        def host(t):
            return np.asarray(t._data).astype(np.float32)

        for op in ("sum", "max", "min", "avg", "prod"):
            t = sharded(arrs["pos"] if op == "prod" else arrs["x"])
            jdist.all_reduce(t, op)
            out[f"all_reduce_{op}"] = host(t)
        out["all_gather"] = host(jdist.all_gather(None, sharded(arrs["x"])))
        out["all_gather_list"] = np.stack(
            [host(v) for v in jdist.all_gather([], sharded(arrs["x"]))])
        for ax in (0, 1):
            out[f"all_gather_concat{ax}"] = host(jdist.all_gather_concat(
                sharded(arrs["x"]), axis=ax))
        out["reduce_scatter"] = host(jdist.reduce_scatter(
            None, sharded(arrs["rs"])))
        t = sharded(arrs["x"])
        jdist.broadcast(t, src=n - 1)
        out["broadcast"] = host(t)
        out["scatter"] = host(jdist.scatter(
            None, [paddle.Tensor(jnp.asarray(row, dtype))
                   for row in arrs["list"]]))
        out["alltoall_single"] = host(jdist.alltoall_single(
            None, sharded(arrs["a2a"])))
        out["alltoall"] = host(jdist.alltoall(
            None, [paddle.Tensor(jnp.asarray(row, dtype))
                   for row in arrs["list"]]))
        if dtype == jnp.float32:
            for fmt in ("int8", "bf16"):
                t = sharded(arrs["q"])
                jdist.all_reduce_quantized(t, qformat=fmt)
                out[f"quantized_{fmt}"] = host(t)
    finally:
        jenv.reset()
    return arrs, out


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def world(request):
    n = request.param
    job = start("collectives", n, {}, timeout=60)
    try:        # the reference, while the ranks run
        ref = {"": _reference(n, jnp.float32),
               "_bf16": _reference(n, jnp.bfloat16)}
    finally:
        ranks = job.wait(deadline=120)
    return n, ranks, ref


def _rank_view(name, want, r, n):
    """The part of the reference's global result rank r holds."""
    if name in ("all_gather", "all_gather_list", "all_gather_concat0",
                "all_gather_concat1", "alltoall"):
        return want                    # every rank holds the whole
    if name == "scatter":
        return want[r]                 # row r of the stacked list
    return _block(want, r, n)


@pytest.mark.parametrize("tag", ["", "_bf16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", EXACT)
def test_exact_collectives_match_the_reference(world, name, tag):
    n, ranks, ref = world
    _, want = ref[tag]
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[name + tag],
                                      _rank_view(name, want[name], r, n))


@pytest.mark.parametrize("name", SUMS + ("all_reduce_prod", "reduce"))
def test_fp32_sums_match_the_reference(world, name):
    n, ranks, ref = world
    _, want = ref[""]
    bar = 1e-5 if name == "all_reduce_prod" else 1e-6
    key = "all_reduce_sum" if name == "reduce" else name
    for r, out in enumerate(ranks):
        if name == "reduce" and r:
            continue                   # the reduction lands on rank 0
        np.testing.assert_allclose(out[name], _rank_view(key, want[key],
                                                         r, n), rtol=bar,
                                   atol=bar)


def test_alltoall_list_form(world):
    """Every rank passes the same list (the reference's replicated
    input): rank r receives row r from each rank."""
    n, ranks, ref = world
    arrs, want = ref[""]
    np.testing.assert_array_equal(ranks[0]["alltoall"], want["alltoall"])
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["alltoall"],
                                      np.stack([arrs["list"][r]] * n))
        np.testing.assert_array_equal(
            out["alltoall_bf16"], np.stack(
                [arrs["list"][r].astype(ml_dtypes.bfloat16)
                 .astype(np.float32)] * n))


@pytest.mark.parametrize("fmt", ["int8", "bf16"])
def test_quantized_all_reduce(world, fmt):
    n, ranks, ref = world
    arrs, want = ref[""]
    exact = arrs["q"].reshape(n, -1).sum(0, dtype=np.float64)
    for r, out in enumerate(ranks):
        got = out[f"quantized_{fmt}"]
        np.testing.assert_allclose(got, _block(want[f"quantized_{fmt}"],
                                               r, n), rtol=1e-6, atol=1e-6)
        rel = np.linalg.norm(got - exact) / np.linalg.norm(exact)
        assert rel < 1e-2
        # bit for bit the recipe's plain version on the ranks' blocks
        plain = quantized_sum_plain([torch.from_numpy(_block(arrs["q"], j,
                                                             n).copy())
                                     for j in range(n)], fmt)
        np.testing.assert_array_equal(got, plain.numpy())
        np.testing.assert_allclose(out["quantized_off"], exact, rtol=1e-5,
                                   atol=1e-5)


def test_p2p_objects_store_and_groups(world):
    n, ranks, _ = world
    for r, out in enumerate(ranks):
        prv, nxt = (r - 1) % n, (r + 1) % n
        np.testing.assert_array_equal(out["p2p_ring"], [prv] * 3)
        np.testing.assert_array_equal(out["p2p_batch"],
                                      [[prv + 100] * 3, [nxt + 200] * 3])
        np.testing.assert_array_equal(out["objects"], np.arange(n))
        assert out["broadcast_object"]
        assert list(out["store"]) == [f"v{i}" for i in range(n)]
        assert int(out["store_count"]) == n * (n + 1) // 2
        # mesh {dp: 2, sharding: n/2}: the sharding line of this rank
        line = list(range((r // (n // 2)) * (n // 2),
                          (r // (n // 2) + 1) * (n // 2)))
        assert list(out["axis_group"]) == line
        np.testing.assert_array_equal(out["axis_group_sum"],
                                      [float(sum(line))] * 2)
        assert out["calls"]["all_reduce"] >= 10
