"""The port's `ring_attention` and `ring_flash_attention` over the sep
group, in 2 and 4 gloo ranks on the CPU (`sep_selftest`'s ``ring`` case,
no jax, under the launcher's deadline; one launch a world), against the
JAX package's ring attention on a CPU mesh ``{"sep": n}`` of the same
size: rank r is held to block r of the reference's global output and
gradients.

* `ring_attention` (the plain ring: aten ops a tick, the reference's
  XLA einsums), causal and not, fp32 and bf16, ``[2, 32, 2, 8]``: the
  forward within 2e-5 and the grads within 5e-4 in fp32
  (tests/test_ring_attention.py:52); in bf16 the forward within the
  flash tests' 2e-3 (tests/test_torch_flash_attention.py) and the grads
  within the bf16 flash backward's bar on the card, 2e-2 of the largest
  gradient (`chip_smoke.py` phase 3, ``TOL_BWD``): the reference's
  grads come from JAX's AD through its bf16 ``p``, the port's from
  PyTorch's, which round and sum the bf16 intermediates in other orders
  (measured: elementwise they part by up to 0.0078, 0.4-2.3% of the
  elements past 2e-3, the largest gradient about 1-3).
* `ring_flash_attention` (the tiled pair #7 / #8 each tick; here their
  plain versions, against the reference's Pallas kernels in interpret
  mode), causal and not, fp32, ``[1, 128 n, 2, 32]``: 3e-5 forward,
  5e-4 grads; and its refusal of a block that is not a multiple of 128.

The cotangent is a seeded array: the loss is ``sum(out * cot)``.
"""
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding

from paddle_tpu.distributed.fleet.meta_parallel import (ring_attention,
                                                        sep_sharding)
from paddle_tpu.distributed.fleet.meta_parallel.ring_attention import (
    ring_flash_attention)
from paddle_tpu_torch.distributed.sep_selftest import start

TOL = {("plain", "float32"): (2e-5, 5e-4),
       ("plain", "bfloat16"): (2e-3, None),
       ("flash", "float32"): (3e-5, 5e-4)}
BF16_GRAD_REL = 2e-2     # of the largest gradient (phase 3's TOL_BWD)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _problems(n):
    rng = np.random.default_rng(10 + n)
    out = {}
    for (kind, dtype) in TOL:
        shape = (2, 32, 2, 8) if kind == "plain" else (1, 128 * n, 2, 32)
        for causal in (True, False):
            x = [(rng.standard_normal(shape) * (0.5 if kind == "flash"
                                                else 1.0))
                 .astype(np.float32) for _ in range(4)]
            if dtype == "bfloat16":     # values the dtype holds exactly
                x = [np.asarray(jnp.asarray(a, jnp.bfloat16)
                                .astype(jnp.float32)) for a in x]
            out[f"{kind}-{dtype}-{'causal' if causal else 'full'}"] = dict(
                q=x[0], k=x[1], v=x[2], cot=x[3], causal=causal,
                dtype=dtype, kind=kind)
    return out


def _reference(p, n):
    mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("sep",))
    sh = sep_sharding(mesh)
    dt = JDT[p["dtype"]]
    fn = ring_attention if p["kind"] == "plain" else ring_flash_attention

    def f(q, k, v):
        return fn(*(jax.device_put(t, sh) for t in (q, k, v)), mesh=mesh,
                  axis="sep", causal=p["causal"])

    args = [jnp.asarray(p[x], dt) for x in ("q", "k", "v")]
    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(p["cot"], dt))
    as_np = lambda t: np.asarray(t.astype(jnp.float32))  # noqa: E731
    assert isinstance(out.sharding, NamedSharding)
    return [as_np(out)] + [as_np(g) for g in grads]


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def world(request):
    n = request.param
    problems = _problems(n)
    job = start("ring", n, {"problems": problems}, timeout=60)
    try:
        ref = {key: _reference(p, n) for key, p in problems.items()}
    finally:
        ranks = job.wait(deadline=150)
    return n, ranks, ref


@pytest.mark.parametrize("key", list(_problems(2)))
def test_ring_matches_the_reference(world, key):
    n, ranks, ref = world
    kind, dtype, _ = key.split("-")
    fwd_tol, grad_tol = TOL[(kind, dtype)]
    s = ref[key][0].shape[1]
    blk = s // n
    for r, out in enumerate(ranks):
        assert out["sep_rank"] == r
        sl = slice(r * blk, (r + 1) * blk)
        got = out[key]
        np.testing.assert_allclose(got["out"], ref[key][0][:, sl], rtol=0,
                                   atol=fwd_tol)
        for name, want in zip(("dq", "dk", "dv"), ref[key][1:]):
            if dtype == "bfloat16":
                err = np.abs(got[name] - want[:, sl]).max()
                assert err <= BF16_GRAD_REL * np.abs(want).max(), (name, err)
            else:
                np.testing.assert_allclose(got[name], want[:, sl], rtol=0,
                                           atol=grad_tol, err_msg=name)


def test_flash_ring_refuses_a_block_not_of_128(world):
    n, ranks, _ = world
    mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("sep",))
    x = jnp.zeros((1, 64 * n, 2, 16))
    with pytest.raises(ValueError) as want:
        ring_flash_attention(x, x, x, mesh=mesh)
    for out in ranks:
        assert out["refuse_block"] == str(want.value)
