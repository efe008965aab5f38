"""Rank workers of the data and sharding axes, and their launcher: the
counterpart of paddle_tpu/jit/sharded_scan_selftest.py.

Each case is a function of one rank (`Ctx`: its rank, the world size,
its device and the case's arguments) that returns numpy arrays, so the
ranks stay light (no jax: the caller computes the reference). Cases:

* ``collectives``: every collective on the rank's block of seeded global
  arrays, the compressed all-reduce, p2p round trips, the store;
* ``buckets``: the bucketed all-reduce and reduce-scatter, collective
  counts;
* ``data_parallel``: `DataParallel` over a Linear, the topology getters
  and ``fleet.init``, `DistributedBatchSampler`;
* ``sharding``: stage 1 or 2 through `jit.TrainStep` on a GPT (AdamW,
  the global clip, the guard), with the shard sizes, an inf on one rank
  only, the state dict through ``framework/io.py``;
* ``sharded_scan``: `ShardedFusedScanTrainStep` on a scan GPT, both
  storages, dropout masks across ranks;
* ``stage3``: stage 3 (`GroupShardedStage3`) on the reference's Linear
  case and a tiny GPT (fp32, O2, ``accumulate_steps`` 2, offload), what
  a rank holds, `get_all_parameters` / `reshard`, the saved file;
  ``stage3_mp``: a tiny LLaMA at sharding x mp.

`launch(case, nprocs, args)` runs a case in ``nprocs`` processes of this
module over gloo on the CPU (a ``file://`` store in a temporary
directory, so parallel launches never share a port): every collective
has the process group's ``timeout``, and the launcher waits at most
``deadline`` seconds before it kills every rank and raises. `start`
returns at once, so the caller computes the reference while the ranks
run, and its ``.wait(deadline)`` collects.

On cards, under ``torch.distributed.run`` (NCCL, one card a rank)::

    python -m torch.distributed.run --nproc_per_node 2 \\
        -m paddle_tpu_torch.distributed.sharding_selftest

runs stage 2 and the sharded scan on a small GPT over the world and
holds them against the same global batch on one rank alone (world 1);
``--device cpu`` runs it on gloo instead. ``--stage3`` (phase 28, ranks
sharing one card over gloo unless ``--nccl``) trains GPT-3 1.3B under
stage 3, plain and with ``offload=True`` (`stage3_full_width`), then a
tiny GPT card against CPU; `stage3_world_one` is the world of one it is
held to.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["CASES", "Ctx", "launch", "launch_stage3_card", "main",
           "run_stage3_card", "stage3_full_width", "stage3_world_one",
           "start", "worker"]


@dataclass
class Ctx:
    rank: int
    nprocs: int
    device: torch.device
    args: dict = field(default_factory=dict)


def _np(t):
    t = t.detach().cpu()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def global_arrays(n, seed=0):
    """The seeded global arrays the collectives case splits on dim 0
    (rank r's block is rows ``[r * rows, (r + 1) * rows)``)."""
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((n * 4, 6)).astype(np.float32),
        "pos": (rng.random((n * 4, 6)) + 0.5).astype(np.float32),
        "rs": rng.standard_normal((n * n * 2, 3)).astype(np.float32),
        "a2a": rng.standard_normal((n * n * 2, 3)).astype(np.float32),
        "q": (rng.standard_normal((n, 4096))
              * (1.0 + 0.1 * np.arange(n))[:, None]).astype(np.float32)
        .reshape(-1),
        "list": rng.standard_normal((n, 5)).astype(np.float32),
    }


def _block(a, r, n):
    b = a.shape[0] // n
    return a[r * b:(r + 1) * b]


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def case_collectives(ctx):
    from . import collective as C
    from . import env
    from .store import TCPStore

    r, n, dev = ctx.rank, ctx.nprocs, ctx.device
    arrs = global_arrays(n, ctx.args.get("seed", 0))
    out = {}
    for dt, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        t = lambda a: torch.tensor(  # noqa: E731
            _block(a, r, n), device=dev).to(dt)
        for op in ("sum", "max", "min", "avg", "prod"):
            src = arrs["pos"] if op == "prod" else arrs["x"]
            x = t(src)
            C.all_reduce(x, op)
            out[f"all_reduce_{op}{tag}"] = _np(x)
        out[f"all_gather{tag}"] = _np(C.all_gather(None, t(arrs["x"])))
        lst = []
        C.all_gather(lst, t(arrs["x"]))
        out[f"all_gather_list{tag}"] = np.stack([_np(v) for v in lst])
        for ax in (0, 1):
            out[f"all_gather_concat{ax}{tag}"] = _np(
                C.all_gather_concat(t(arrs["x"]), axis=ax))
        out[f"reduce_scatter{tag}"] = _np(C.reduce_scatter(t(arrs["rs"])))
        x = t(arrs["x"])
        C.broadcast(x, src=n - 1)
        out[f"broadcast{tag}"] = _np(x)
        x = t(arrs["x"])
        C.reduce(x, dst=0)
        if r == 0:
            out[f"reduce{tag}"] = _np(x)
        s = torch.empty(5, dtype=dt, device=dev)
        src_list = [torch.from_numpy(row).to(dev, dt)
                    for row in arrs["list"]]
        C.scatter(s, src_list if r == 0 else None, src=0)
        out[f"scatter{tag}"] = _np(s)
        out[f"alltoall_single{tag}"] = _np(
            C.alltoall_single(None, t(arrs["a2a"])))
        got = []
        C.alltoall(got, [v for v in src_list])
        out[f"alltoall{tag}"] = np.stack([_np(v) for v in got])
    q = torch.tensor(_block(arrs["q"], r, n), device=dev)
    for fmt in ("int8", "bf16"):
        x = q.clone()
        C.all_reduce_quantized(x, qformat=fmt)
        out[f"quantized_{fmt}"] = _np(x)
    x = q.clone()
    C.all_reduce_quantized(x, qformat="")
    out["quantized_off"] = _np(x)
    # p2p: a ring, then a batched exchange both ways
    nxt, prv = (r + 1) % n, (r - 1) % n
    ring = torch.full((3,), float(r), device=dev)
    got = torch.empty(3, device=dev)
    if r % 2 == 0:
        C.send(ring, nxt)
        C.recv(got, prv)
    else:
        C.recv(got, prv)
        C.send(ring, nxt)
    out["p2p_ring"] = _np(got)
    a, b = torch.empty(3, device=dev), torch.empty(3, device=dev)
    tasks = C.batch_isend_irecv([
        C.P2POp(C.isend, ring + 100, nxt), C.P2POp(C.isend, ring + 200, prv),
        C.P2POp(C.irecv, a, prv), C.P2POp(C.irecv, b, nxt)])
    for task in tasks:
        task.wait()
    out["p2p_batch"] = np.stack([_np(a), _np(b)])
    objs = []
    C.all_gather_object(objs, {"rank": r})
    out["objects"] = np.asarray([o["rank"] for o in objs])
    bl = [f"from{r}"]
    C.broadcast_object_list(bl, src=n - 1)
    out["broadcast_object"] = np.asarray(bl[0] == f"from{n - 1}")
    C.barrier()
    # the store: rank 0 hosts it on a free port, which the ranks share
    port = [None]
    if r == 0:
        store = TCPStore("127.0.0.1", 0, n, True, timeout=30)
        port = [store.port]
    C.broadcast_object_list(port, src=0)
    if r != 0:
        store = TCPStore("127.0.0.1", port[0], n, False, timeout=30)
    store.set(f"k{r}", f"v{r}")
    counts = store.add("count", r + 1)
    store.wait([f"k{i}" for i in range(n)])
    out["store"] = np.asarray([store.get(f"k{i}").decode()
                               for i in range(n)])
    C.barrier()
    out["store_count"] = np.asarray(int(store.add("count", 0)))
    out["store_first"] = np.asarray(counts)
    C.barrier()
    if n % 2 == 0:
        mesh = env.build_mesh({"dp": 2, "sharding": n // 2})
        g = C.new_group(axes=("sharding",), mesh=mesh)
        x = torch.full((2,), float(r), device=dev)
        C.all_reduce(x, group=g)
        out["axis_group"] = np.asarray(g.ranks)
        out["axis_group_sum"] = _np(x)
    out["calls"] = dict(C.calls)
    return out


def case_buckets(ctx):
    from . import collective as C
    from .comm_bucketer import (GradBucketer, bucketed_all_reduce,
                                bucketed_reduce_scatter)

    r, n, dev = ctx.rank, ctx.nprocs, ctx.device
    shapes = ctx.args["shapes"]
    rng = np.random.default_rng(0)
    same = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    mine = [np.random.default_rng(10 + r).standard_normal(s)
            .astype(np.float32) for s in shapes]
    out = {}
    for tag, data in (("same", same), ("mine", mine)):
        for mb in ctx.args["bucket_mbs"]:
            ts = [torch.from_numpy(a.copy()).to(dev) for a in data]
            C.reset_counts()
            bucketed_all_reduce(ts, bucket_mb=mb)
            out[f"ar_{tag}_{mb}"] = [_np(t) for t in ts]
            out[f"ar_calls_{tag}_{mb}"] = C.calls["all_reduce"]
            C.reset_counts()
            assign, shards = bucketed_reduce_scatter(
                [torch.from_numpy(a.copy()).to(dev) for a in data],
                bucket_mb=mb)
            out[f"rs_{tag}_{mb}"] = [_np(s) for s in shards]
            out[f"rs_numel_{mb}"] = [b.numel for b in assign.buckets]
            out[f"rs_calls_{tag}_{mb}"] = C.calls["reduce_scatter"]
    params = [torch.nn.Parameter(torch.from_numpy(a.copy()).to(dev))
              for a in mine]
    for p, a in zip(params, mine):
        p.grad = torch.from_numpy(a.copy()).to(dev) * (r + 1)
    bk = GradBucketer([(f"p{i}", p) for i, p in enumerate(params)],
                      bucket_mb=ctx.args["bucket_mbs"][0])
    C.reset_counts()
    shards = bk.reduce_scatter(average=True, release=True)
    out["bucketer_shards"] = [_np(s) for s in shards]
    out["bucketer_calls"] = C.calls["reduce_scatter"]
    out["bucketer_released"] = all(p.grad is None for p in params)
    out["bucketer_buckets"] = bk.num_buckets
    return out


def case_data_parallel(ctx):
    from .. import io as pio
    from ..optimizer import SGD
    from . import collective as C
    from . import env
    from .fleet import DistributedStrategy, fleet
    from .fleet.topology import CommunicateTopology, HybridCommunicateGroup
    from .parallel import DataParallel

    r, n, dev = ctx.rank, ctx.nprocs, ctx.device
    a = ctx.args
    out = {}
    torch.manual_seed(0)
    m = torch.nn.Linear(4, 2).to(dev)
    with torch.no_grad():       # the reference's weights; rank 0's win
        m.weight.copy_(torch.from_numpy(a["w"].T.copy()))
        m.bias.copy_(torch.from_numpy(a["b"]))
        if r != 0:
            m.weight.add_(1.0)
    dp = DataParallel(m)
    opt = SGD(learning_rate=0.1, parameters=dp.parameters())
    x = torch.from_numpy(_block(a["x"], r, n).copy()).to(dev)
    y = torch.from_numpy(_block(a["y"], r, n).copy()).to(dev)
    C.reset_counts()
    loss = ((dp(x) - y) * (dp(x) - y)).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()
    out["weight"] = _np(m.weight).T
    out["bias"] = _np(m.bias)
    out["dp_all_reduces"] = C.calls["all_reduce"]
    # no_sync: the grads of the block stay local, the next backward syncs
    with dp.no_sync():
        ((dp(x) - y) ** 2).mean().backward()
    local = _np(m.weight.grad).copy()
    ((dp(x) - y) ** 2).mean().backward()
    out["no_sync_local"] = local
    out["no_sync_synced"] = _np(m.weight.grad)
    opt.clear_grad()
    # the topology and fleet.init at this world's size
    if n % 2 == 0:
        topo = CommunicateTopology(dims=(1, 2, n // 2, 1, 1))
        hcg = HybridCommunicateGroup(topo)
        out["hcg"] = np.asarray([
            hcg.get_data_parallel_world_size(),
            hcg.get_sharding_parallel_world_size(),
            hcg.get_model_parallel_world_size(),
            hcg.get_pipe_parallel_world_size(),
            hcg.get_data_parallel_rank(), hcg.get_sharding_parallel_rank(),
            hcg.get_data_parallel_group().nranks,
            hcg.get_sharding_parallel_group().nranks])
        out["hcg_groups"] = [hcg.get_data_parallel_group().ranks,
                             hcg.get_sharding_parallel_group().ranks]
    strategy = DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": n}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    out["fleet"] = np.asarray([fleet.worker_num, fleet.worker_index(),
                               int(fleet.is_first_worker()),
                               hcg.get_data_parallel_world_size()])
    out["fleet_model"] = type(fleet.distributed_model(
        torch.nn.Linear(2, 2).to(dev))).__name__
    # an mp degree of the world: the model axis, wrapped by TensorParallel
    s = DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": n}
    fleet.init(is_collective=True, strategy=s)
    hcg = fleet.get_hybrid_communicate_group()
    out["mp_fleet"] = [hcg.get_model_parallel_world_size(),
                       hcg.get_model_parallel_rank(),
                       hcg.get_data_parallel_world_size(),
                       type(fleet.distributed_model(
                           torch.nn.Linear(2, 2).to(dev))).__name__]
    s = DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "pp_degree": n}
    fleet.init(is_collective=True, strategy=s)
    hcg = fleet.get_hybrid_communicate_group()
    out["pp_fleet"] = [hcg.get_pipe_parallel_world_size(),
                       hcg.get_stage_id(), hcg.is_first_stage(),
                       hcg.is_last_stage(), hcg.get_p2p_next_rank(),
                       hcg.get_p2p_prev_rank(),
                       type(fleet.distributed_model(
                           torch.nn.Linear(2, 2).to(dev))).__name__]
    s = DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "sep_degree": n}
    fleet.init(is_collective=True, strategy=s)
    hcg = fleet.get_hybrid_communicate_group()
    out["sep_fleet"] = [hcg.get_sep_parallel_world_size(),
                        hcg.get_sep_parallel_rank(),
                        hcg.get_sep_parallel_group().ranks,
                        hcg.get_dp_sep_parallel_group().ranks,
                        type(fleet.distributed_model(
                            torch.nn.Linear(2, 2).to(dev))).__name__]
    s.sharding = True           # a sharded optimizer beside sep
    try:
        from ..optimizer import SGD

        fleet.distributed_optimizer(SGD(parameters=torch.nn.Linear(2, 2)
                                        .to(dev).parameters()))
        out["refuse_sep_sharding"] = ""
    except NotImplementedError as e:
        out["refuse_sep_sharding"] = str(e)
    env.set_mesh(env.build_mesh({"dp": n}))
    ds = list(range(a["dataset"]))
    for shuffle in (False, True):
        for drop in (False, True):
            sampler = pio.DistributedBatchSampler(ds, batch_size=3,
                                                  shuffle=shuffle,
                                                  drop_last=drop)
            sampler.set_epoch(2)
            out[f"sampler_{shuffle}_{drop}"] = [list(b) for b in sampler]
            out[f"sampler_len_{shuffle}_{drop}"] = len(sampler)
    return out


def _gpt(ctx, named, scan):
    from .. import convert
    from ..models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(**ctx.args["config"], scan_layers=scan)
    model = GPTForCausalLM(cfg, device=ctx.device)
    model.load_state_dict(convert.state_dict_from_jax(named, model=model))
    model.train()
    return model


def _adamw(model, clip=1.0, lr=1e-2):
    """AdamW with a global-norm clip of ``clip`` (None: no clip), the
    LayerNorms and biases excluded from the decay."""
    from ..nn import ClipGradByGlobalNorm
    from ..optimizer import AdamW

    return AdamW(learning_rate=lr, parameters=model.named_parameters(),
                 grad_clip=None if clip is None else ClipGradByGlobalNorm(
                     clip),
                 apply_decay_param_fun=lambda name: not (
                     "ln" in name or name.endswith("bias")))


def _params(model):
    return {k: _np(v) for k, v in model.state_dict().items()}


def _sharding_run(ctx, stage, via_fleet):
    """One GPT run of stage ``stage`` through `jit.TrainStep` (the guard
    on): losses, parameters, shard sizes, the state dict's round trip
    through ``framework/io.py``, then a step with an inf on the last rank
    only."""
    from ..framework import io as fio
    from ..jit import TrainStep
    from ..models import GPTPretrainingCriterion
    from . import collective as C
    from .fleet import DistributedStrategy, DygraphShardingOptimizer, fleet
    from .sharding import group_sharded_parallel

    r, n, dev = ctx.rank, ctx.nprocs, ctx.device
    a = ctx.args
    crit = GPTPretrainingCriterion()

    def loss_fn(m, ids, labels):
        return crit(m(ids), labels)

    mine = [_block(torch.from_numpy(a[k]).to(dev), r, n)
            for k in ("ids", "labels")]
    out = {}
    model = _gpt(ctx, a["named"], scan=False)
    if via_fleet:
        s = DistributedStrategy()
        s.hybrid_configs = {"sharding_degree": n}
        fleet.init(is_collective=True, strategy=s)
        opt = fleet.distributed_optimizer(_adamw(model))
        wrapped = fleet.distributed_model(model)
    else:
        wrapped, opt, _ = group_sharded_parallel(
            model, _adamw(model), "os_g" if stage == 2 else "os")
    sharded = (opt if isinstance(opt, DygraphShardingOptimizer)
               else opt._inner_opt)
    step = TrainStep(wrapped, loss_fn, opt, guard_nonfinite=True)
    if stage == 1 and not via_fleet:
        # the numerics monitor's grad rows from the shards, against the
        # whole batch's grads in one process
        params = [p for p in model.parameters() if p.requires_grad]
        loss_fn(wrapped, *mine).backward()
        out["grad_sq_sharded"] = _np(sharded._sharded_grad_sq(params))
        sharded._bucketer.shards = None
        opt.clear_grad()
        whole = _gpt(ctx, a["named"], scan=False)
        loss_fn(whole, *[torch.from_numpy(a[k]).to(dev)
                         for k in ("ids", "labels")]).backward()
        out["grad_sq_whole"] = np.asarray(
            [float(p.grad.float().square().sum()) for p in whole.parameters()
             if p.requires_grad])
    C.reset_counts()
    losses = []
    for k in range(a["steps"]):
        if stage == 2 and k == 0:
            # what outlives the sync: the shards, no full grad
            loss_fn(wrapped, *mine).backward()
            wrapped.apply_collective_grads()
            out["grads_after_sync"] = sum(
                p.grad is not None for p in model.parameters())
            out["grad_shard_numel"] = [t.numel() for t in
                                       sharded._bucketer.shards]
            sharded._bucketer.shards = None
            opt.clear_grad()
        losses.append(float(step(*mine)))
    out["calls"] = dict(C.calls)
    out["losses"] = np.asarray(losses)
    out["params"] = _params(model)
    out["state_numel"] = [[t.numel() for t in st if t is not None]
                          for st in sharded._state]
    out["bucket_numel"] = [b.numel for b in
                           sharded._bucketer.assignment.buckets]
    state = opt.state_dict()
    path = os.path.join(a["dir"], f"opt{stage}{int(via_fleet)}_{r}.pdopt")
    fio.save(state, path)
    sharded.set_state_dict(fio.load(path))
    again = opt.state_dict()
    out["state_roundtrip"] = all(
        np.array_equal(np.asarray(state["accumulators"][k][p]),
                       np.asarray(again["accumulators"][k][p]))
        for k in state["accumulators"] for p in state["accumulators"][k])
    out["moment1"] = {k: _np(torch.as_tensor(v)) for k, v in
                      state["accumulators"]["moment1"].items()}
    out["step_count"] = state["step"]
    if stage == 2 and not via_fleet:
        from .sharding import save_group_sharded_model

        save_group_sharded_model(wrapped, os.path.join(a["dir"], "saved"),
                                 opt)
    # an inf on the last rank only: every rank skips, bit for bit
    before = _params(model)
    out["params_before_inf"] = before
    held = model.gpt.wte.weight.detach().clone()
    if r == n - 1:
        with torch.no_grad():
            model.gpt.wte.weight[int(mine[0][0, 0])].fill_(float("inf"))
    loss = step(*mine)
    with torch.no_grad():
        model.gpt.wte.weight.copy_(held)
    after = _params(model)
    out["inf_loss_finite"] = bool(torch.isfinite(loss))
    out["inf_skipped"] = all(np.array_equal(before[k], after[k])
                             for k in before)
    out["inf_step_count"] = opt.state_dict()["step"]
    return out


def _bert_run(ctx):
    """A tiny BERT classifier with stage 1 through
    ``fleet.distributed_optimizer``: its losses and parameters."""
    from ..jit import TrainStep
    from ..models import BertConfig, BertForSequenceClassification
    from ..nn import CrossEntropyLoss
    from ..optimizer import AdamW
    from .fleet import DistributedStrategy, fleet

    r, n, dev = ctx.rank, ctx.nprocs, ctx.device
    a = ctx.args["bert"]
    model = BertForSequenceClassification(BertConfig(**a["config"]),
                                          num_classes=3, device=dev)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in a["state"].items()})
    model.train()
    s = DistributedStrategy()
    s.hybrid_configs = {"sharding_degree": n}
    fleet.init(is_collective=True, strategy=s)
    opt = fleet.distributed_optimizer(
        AdamW(learning_rate=a["lr"], parameters=model.parameters()))
    crit = CrossEntropyLoss()
    step = TrainStep(fleet.distributed_model(model), lambda m, i, k, y:
                     crit(m(i, attention_mask=k), y), opt)
    batch = [_block(torch.from_numpy(a[k]).to(dev), r, n)
             for k in ("ids", "mask", "labels")]
    losses = [float(step(*batch)) for _ in range(a["steps"])]
    return {"losses": np.asarray(losses), "params": _params(model)}


def case_sharding(ctx):
    out = {}
    for run in ctx.args["runs"]:
        out[run] = _sharding_run(ctx, stage=2 if run == "stage2" else 1,
                                 via_fleet=run == "fleet")
    if "bert" in ctx.args:
        out["bert"] = _bert_run(ctx)
    out["dir"] = ctx.args["dir"]
    return out


def case_sharded_scan(ctx):
    from ..jit import ShardedFusedScanTrainStep, select_train_step
    from ..models import GPTPretrainingCriterion

    r, n, dev = ctx.rank, ctx.nprocs, ctx.device
    a = ctx.args
    ids = torch.from_numpy(a["ids"]).to(dev)
    labels = torch.from_numpy(a["labels"]).to(dev)
    mine = [_block(ids, r, n), _block(labels, r, n)]
    out = {}
    for storage in ("replicated", "sharded"):
        for chunk in a["chunks"]:
            model = _gpt(ctx, a["named"], scan=True)
            opt = _adamw(model, clip=a.get("clip"), lr=a["lr"])
            step = ShardedFusedScanTrainStep(
                model, opt, criterion=GPTPretrainingCriterion(),
                layer_chunk=chunk, param_storage=storage,
                guard_nonfinite=True, numerics=a.get("numerics", False))
            losses = [float(step(*mine)) for _ in range(a["steps"])]
            tag = f"{storage}_{chunk}"
            out[f"freed_{tag}"] = all(p.untyped_storage().size() == 0
                                      for p in step._stored())
            out[f"losses_{tag}"] = np.asarray(losses)
            out[f"params_{tag}"] = _params(model)   # gathers them back
            out[f"shards_{tag}"] = step.shard_numels()
            out[f"calls_{tag}"] = step.collectives_per_step
            if step._numerics is not None:
                out[f"numerics_{tag}"] = step._numerics.summary()
    out["buckets"] = [b.numel for b in step._s_assign.buckets] + \
        [b.numel for b in step._o_assign.buckets]
    if a.get("quant"):
        # the compressed wire format on the scatter and gather legs
        for storage in ("replicated", "sharded"):
            model = _gpt(ctx, a["named"], scan=True)
            step = ShardedFusedScanTrainStep(
                model, _adamw(model, clip=a.get("clip"), lr=a["lr"]),
                criterion=GPTPretrainingCriterion(), param_storage=storage,
                comm_quant=a["quant"], guard_nonfinite=True, numerics=False)
            out[f"losses_quant_{storage}"] = np.asarray(
                [float(step(*mine)) for _ in range(a["steps"])])
            out[f"params_quant_{storage}"] = _params(model)
    # dropout: distinct masks across ranks, the same for a seed
    if a.get("dropout"):
        masks = []
        for _ in range(2):
            torch.manual_seed(0)
            model = _gpt(Ctx(r, n, dev, {"config": {
                **a["config"], "hidden_dropout_prob": 0.5}}), a["named"],
                True)
            opt = _adamw(model, clip=None, lr=a["lr"])
            step = ShardedFusedScanTrainStep(
                model, opt, criterion=GPTPretrainingCriterion(),
                param_storage="replicated", numerics=False)
            step(_block(ids, 0, n), _block(labels, 0, n))
            masks.append(float(step.local_loss))
        out["dropout_losses"] = np.asarray(masks)
    model = _gpt(ctx, a["named"], scan=True)
    out["select"] = type(select_train_step(
        model, _adamw(model), criterion=GPTPretrainingCriterion())).__name__
    # a dp x mp mesh over the world: the dp x mp step, whose groups span
    # (dp, mp) and mp
    from . import env

    mesh = env.build_mesh({"dp": n // 2, "mp": 2})
    model = _gpt(ctx, a["named"], scan=True)
    step = select_train_step(model, _adamw(model),
                             criterion=GPTPretrainingCriterion(), mesh=mesh)
    out["select_mp"] = [type(step).__name__, step.group.nranks,
                        step.mp_group.nranks]
    return out


def _stage3_run(ctx, a, mine, *, o2=False, accumulate=1, offload=False,
                probe=False):
    """A tiny GPT (non-scan, tied head, recompute) through
    ``group_sharded_parallel(level="p_g_os")`` and the wrapper's
    ``train_step`` (a `jit.TrainStep` of ``model.loss``; AdamW with the
    clip, the guard; under O2 at ``o2_lr``): losses, whole parameters,
    resident parameter bytes between steps; with ``probe`` also what
    each parameter holds, `get_all_parameters` / `reshard` round trips,
    the saved file, an eval forward and a state dict loaded back."""
    from ..amp import decorate
    from . import collective as C
    from .sharding import group_sharded_parallel, save_group_sharded_model

    r, dev = ctx.rank, ctx.device
    model = _gpt(Ctx(r, ctx.nprocs, dev, {"config": dict(
        a["config"], use_recompute=True)}), a["named"], scan=False)
    opt = _adamw(model, lr=a["o2_lr"] if o2 else a["lr"])
    if o2:
        decorate(models=model, optimizers=opt, level="O2")
    wrapped, opt, _ = group_sharded_parallel(
        model, opt, "p_g_os", segment_size=a["segment"], offload=offload)
    step = wrapped.train_step(accumulate_steps=accumulate,
                              guard_nonfinite=True, numerics=probe)
    out = {"full_bytes": sum(p.numel() * p.element_size()
                             for p in model.parameters()),
           "step": [type(step).__name__, type(step.optimizer).__name__]}
    start = wrapped.state_dict() if probe else None
    C.reset_counts()
    losses, resident = [], []
    for _ in range(a["steps"]):
        losses.append(float(step(*mine)))
        resident.append(wrapped.resident_param_bytes())
    out["calls"] = dict(C.calls)
    out["losses"] = np.asarray(losses)
    out["resident"] = resident
    out["params"] = {k: _np(v) for k, v in wrapped.state_dict().items()}
    out["resident_after_state_dict"] = wrapped.resident_param_bytes()
    if not probe:
        return out
    out["numerics"] = step.numerics.summary()
    out["storage"] = {k: p.untyped_storage().nbytes()
                      for k, p in model.named_parameters()}
    out["shard_numel"] = [st.shard.numel() for st in wrapped._shards]
    host = wrapped.get_all_parameters(convert2cpu=True)
    out["cpu_copies"] = dict(zip([k for k, _ in model.named_parameters()],
                                 host))
    out["resident_after_cpu"] = wrapped.resident_param_bytes()
    params = wrapped.get_all_parameters()
    # copies: numpy over a tensor pins its storage's size
    out["gathered"] = {k: _np(p.detach().clone()) for k, p in zip(
        [k for k, _ in model.named_parameters()], params)}
    out["resident_gathered"] = wrapped.resident_param_bytes()
    wrapped.reshard()
    out["resident_resharded"] = wrapped.resident_param_bytes()
    save_group_sharded_model(wrapped, os.path.join(a["dir"], "stage3"), opt)
    with torch.no_grad():           # an eval forward: nothing stays whole
        out["eval_logits"] = _np(wrapped(torch.from_numpy(
            a["ids"][:1]).to(dev)))
    out["resident_after_eval"] = wrapped.resident_param_bytes()
    wrapped.load_state_dict(start)  # whole values in, the rank's shards kept
    out["reloaded"] = all(torch.equal(v, start[k])
                          for k, v in wrapped.state_dict().items())
    out["resident_after_load"] = wrapped.resident_param_bytes()
    C.barrier()
    return out


def case_stage3(ctx):
    """Sharding stage 3 at sharding = the world: the reference's Linear
    case (tests/test_distributed.py:429-470: ``segment_size=0``, AdamW,
    3 `TrainStep`s, the Linear's layout between them), then a tiny GPT
    (`_stage3_run`): fp32 with the probes, O2, ``accumulate_steps`` 2,
    ``offload=True``; ``offload`` at "os" / "os_g" accepted."""
    from ..jit import TrainStep
    from ..optimizer import AdamW
    from .sharding import group_sharded_parallel

    r, n, dev = ctx.rank, ctx.nprocs, ctx.device
    a = ctx.args
    out = {}
    lin = torch.nn.Linear(16, 8).to(dev)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(a["lin_w"].T.copy()))
        lin.bias.copy_(torch.from_numpy(a["lin_b"]))
    wrapped, opt, _ = group_sharded_parallel(
        lin, AdamW(learning_rate=0.01, parameters=lin.parameters()),
        level="p_g_os", segment_size=0)
    step = TrainStep(wrapped, lambda m, x, y: ((m(x) - y) ** 2).mean(), opt)
    xy = [_block(torch.from_numpy(a[k]).to(dev), r, n)
          for k in ("lin_x", "lin_y")]
    out["linear"] = {
        "losses": np.asarray([float(step(*xy)) for _ in range(3)]),
        "storage": [p.untyped_storage().nbytes() for p in lin.parameters()],
        "type": type(wrapped).__name__}
    sd = wrapped.state_dict()
    out["linear"]["weight"] = _np(sd["weight"]).T
    out["linear"]["bias"] = _np(sd["bias"])
    mine = [_block(torch.from_numpy(a[k]).to(dev), r, n)
            for k in ("ids", "labels")]
    out["fp32"] = _stage3_run(ctx, a, mine, probe=True)
    out["o2"] = _stage3_run(ctx, a, mine, o2=True)
    out["accumulate"] = _stage3_run(ctx, a, mine, accumulate=2)
    out["offload"] = _stage3_run(ctx, a, mine, offload=True)
    accepted = {}
    for level in ("os", "os_g"):
        model = _gpt(ctx, a["named"], scan=False)
        w, o, _ = group_sharded_parallel(model, _adamw(model, lr=a["lr"]),
                                         level, offload=True)
        accepted[level] = float(TrainStep(w, lambda m, i, l: m.loss(i, l),
                                          o)(*mine))
    out["offload_accepted"] = accepted
    out["dir"] = a["dir"]
    return out


def case_stage3_mp(ctx):
    """Stage 3 over sharding ``n / mp`` x mp ``mp``: a tiny LLaMA (the
    port's eager Megatron model: its column / row blocks and the
    vocab-parallel head are mp blocks, each sharded further over the
    sharding group), tied head, recompute, AdamW with the clip, through
    ``fleet.init`` + ``group_sharded_parallel(level="p_g_os")`` +
    `jit.TrainStep` on the rank's rows of the sharding axis."""
    from .. import convert
    from ..jit import TrainStep
    from ..models import LlamaConfig, LlamaForCausalLM
    from ..nn import ClipGradByGlobalNorm
    from ..optimizer import AdamW
    from . import env
    from .fleet import DistributedStrategy, fleet
    from .sharding import group_sharded_parallel

    dev, a = ctx.device, ctx.args
    mp = a["mp"]
    s = DistributedStrategy()
    s.hybrid_configs = {"sharding_degree": ctx.nprocs // mp,
                        "mp_degree": mp}
    fleet.init(is_collective=True, strategy=s)
    hcg = fleet.get_hybrid_communicate_group()
    r = hcg.get_model_parallel_rank()
    model = LlamaForCausalLM(LlamaConfig(**a["config"]), device=dev)
    model.load_state_dict(convert.mp_state_dict_from_jax(a["named"], model,
                                                         r, mp))
    model.train()
    opt = AdamW(learning_rate=a["lr"], parameters=model.parameters(),
                epsilon=a["eps"], weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(a["clip"]))
    wrapped, opt, _ = group_sharded_parallel(model, opt, "p_g_os",
                                             segment_size=a["segment"])
    step = TrainStep(wrapped, lambda m, i, l: m.loss(i, l), opt,
                     numerics=False)
    mine = env.data_shard([torch.from_numpy(a[k]).to(dev)
                           for k in ("ids", "labels")])
    losses = [float(step(*mine)) for _ in range(a["steps"])]
    return {"coords": [hcg.get_sharding_parallel_rank(), r],
            "losses": np.asarray(losses),
            "state": {k: _np(v) for k, v in wrapped.state_dict().items()},
            "groups": [opt._group.nranks, opt._mp_group.nranks],
            "resident": wrapped.resident_param_bytes(),
            "full_bytes": sum(p.numel() * p.element_size()
                              for p in model.parameters())}


def check_world1(dev, seed=0):
    """Every collective at a world of one rank on ``dev`` (the world must
    be joined), fp32 and bf16, held to its one-rank meaning (a sum of
    one, a gather of one, a batched send to oneself and its receive on
    NCCL, ...) bit for bit; the compressed all-reduce,
    int8 and bf16, bit for bit its plain twin from the same recipe on
    the CPU; a store round trip. Returns {check: result}; raises on a
    miss."""
    from . import collective as C
    from . import env
    from .store import TCPStore

    if env.get_world_size() != 1:
        raise ValueError("check_world1 needs a world of one rank")
    rng = np.random.default_rng(seed)
    res = {}

    def same(name, got, want):
        ok = bool(torch.equal(got.cpu(), want.cpu()))
        res[name] = ok
        if not ok:
            raise AssertionError(f"world-1 {name}: {got} != {want}")

    for dt, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        x = torch.from_numpy(rng.standard_normal((64, 48)).astype(
            np.float32)).to(dev, dt)
        pos = x.abs() + 0.5
        for op in ("sum", "max", "min", "avg", "prod"):
            src = pos if op == "prod" else x
            y = src.clone()
            C.all_reduce(y, op)
            same(f"all_reduce_{op}_{tag}", y, src)
        y = x.clone()
        C.reduce(y, dst=0)
        same(f"reduce_{tag}", y, x)
        same(f"all_gather_{tag}", C.all_gather(None, x), x[None])
        lst = []
        C.all_gather(lst, x)
        same(f"all_gather_list_{tag}", torch.stack(lst), x[None])
        for ax in (0, 1):
            same(f"all_gather_concat{ax}_{tag}",
                 C.all_gather_concat(x, axis=ax), x)
        flat = torch.empty(x.numel(), dtype=dt, device=dev)
        same(f"all_gather_into_{tag}",
             C.all_gather_into(flat, x.reshape(-1)), x.reshape(-1))
        same(f"reduce_scatter_{tag}", C.reduce_scatter(x), x)
        y = x.clone()
        C.broadcast(y, src=0)
        same(f"broadcast_{tag}", y, x)
        y = torch.empty_like(x)
        C.scatter(y, [x], src=0)
        same(f"scatter_{tag}", y, x)
        same(f"alltoall_single_{tag}", C.alltoall_single(None, x), x)
        got = []
        C.alltoall(got, [x])
        same(f"alltoall_{tag}", got[0], x)
        if env.get_backend() == "nccl":
            # p2p: a send to oneself and its receive, batched as one NCCL
            # group (gloo has no pair to oneself)
            y = torch.empty_like(x)
            for task in C.batch_isend_irecv([C.P2POp(C.isend, x, 0),
                                             C.P2POp(C.irecv, y, 0)]):
                task.wait()
            same(f"p2p_self_{tag}", y, x)
    q = torch.from_numpy((rng.standard_normal(4096 + 17) * 3).astype(
        np.float32)).to(dev)
    for fmt in ("int8", "bf16"):
        y = q.clone()
        C.all_reduce_quantized(y, qformat=fmt)
        same(f"all_reduce_quantized_{fmt}", y,
             C.quantized_sum_plain([q.cpu()], fmt))
    objs = []
    C.all_gather_object(objs, {"rank": 0})
    res["all_gather_object"] = objs == [{"rank": 0}]
    bl = ["x"]
    C.broadcast_object_list(bl, src=0)
    res["broadcast_object_list"] = bl == ["x"]
    C.barrier()
    res["barrier"] = True
    store = TCPStore("127.0.0.1", 0, 1, True, timeout=30)
    store.set("key", "value")
    store.wait("key")
    res["store"] = (store.get("key") == b"value" and store.add("n", 2) == 2
                    and store.add("n", 3) == 5)
    store.shutdown()
    if not all(res.values()):
        raise AssertionError(f"world-1 checks: {res}")
    return res


CASES = {"collectives": case_collectives, "buckets": case_buckets,
         "data_parallel": case_data_parallel, "sharding": case_sharding,
         "sharded_scan": case_sharded_scan, "stage3": case_stage3,
         "stage3_mp": case_stage3_mp}


# ---------------------------------------------------------------------------
# the launcher (CPU, gloo)
# ---------------------------------------------------------------------------

def _repo_root():
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def launch(case, nprocs, args=None, timeout=60, deadline=120,
           module=__name__):
    """Run ``case`` in ``nprocs`` gloo ranks on the CPU; returns each
    rank's result, in rank order. Raises when a rank fails or the whole
    run passes ``deadline`` seconds (every rank is killed then).
    ``module`` is the rank module whose ``CASES`` hold the case (its
    ``main`` runs `worker` for ``--worker``)."""
    return start(case, nprocs, args, timeout, module).wait(deadline)


class _Launch:
    """Ranks running a case (`start`); `wait` collects their results."""

    def __init__(self, case, tmp, procs, logs):
        self.case, self.tmp, self.procs, self.logs = case, tmp, procs, logs
        self.t0 = time.monotonic()

    def wait(self, deadline=120):
        """Each rank's result, in rank order, at most ``deadline`` seconds
        after the start (then every rank is killed and this raises)."""
        case, tmp, procs = self.case, self.tmp, self.procs
        n = len(procs)
        end = self.t0 + deadline
        try:
            for p in procs:
                p.wait(max(0.1, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            for p in procs:
                p.wait()
            raise TimeoutError(f"{case} x{n}: ranks passed the {deadline} "
                               f"s deadline and were killed\n"
                               f"{_tails(tmp, n)}")
        finally:
            for log in self.logs:
                log.close()
        if any(p.returncode for p in procs):
            raise RuntimeError(f"{case} x{n}: rank exit codes "
                               f"{[p.returncode for p in procs]}\n"
                               f"{_tails(tmp, n)}")
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def start(case, nprocs, args=None, timeout=60, module=__name__):
    """`launch`'s first half: the ranks start and run while the caller
    works (computes the reference); ``.wait(deadline)`` collects."""
    tmp = tempfile.mkdtemp(prefix="sharding_selftest_")
    args = dict(args or {}, dir=tmp)
    with open(os.path.join(tmp, "args.pkl"), "wb") as f:
        pickle.dump(args, f)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [_repo_root()] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
              "PADDLE_MASTER"):
        env.pop(k, None)
    procs, logs = [], []
    for r in range(nprocs):
        log = open(os.path.join(tmp, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, "--worker", case, "--rank",
             str(r), "--nprocs", str(nprocs), "--dir", tmp, "--timeout",
             str(timeout)], env=env, stdout=log, stderr=subprocess.STDOUT))
    return _Launch(case, tmp, procs, logs)


def _tails(tmp, n):
    parts = []
    for r in range(n):
        with open(os.path.join(tmp, f"rank{r}.log")) as f:
            parts.append(f"--- rank {r}:\n" + f.read()[-3000:])
    return "\n".join(parts)


def worker(case, rank, nprocs, tmp, timeout, cases=None):
    """One rank of a launch: joins the gloo world on the CPU through the
    launch's ``file://`` store, runs ``cases[case]`` and pickles what it
    returns."""
    from . import env

    torch.set_num_threads(1)
    with open(os.path.join(tmp, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    env.init_parallel_env(backend="gloo",
                          init_method="file://" + os.path.join(tmp, "store"),
                          rank=rank, world_size=nprocs, timeout=timeout)
    try:
        out = (cases or CASES)[case](Ctx(rank, nprocs, torch.device("cpu"),
                                         args))
    finally:
        env.reset()
    with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# N cards under torch.distributed.run: the world against world 1
# ---------------------------------------------------------------------------

SMALL = dict(vocab_size=512, hidden_size=128, num_layers=2,
             num_attention_heads=4, max_position_embeddings=64,
             hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def small_weights(config=SMALL, seed=0):
    """Seeded numpy weights of a scan GPT under the reference's names
    (Linear weights ``[in, out]``), as the tests draw them."""
    from .. import convert
    from ..models import GPTConfig, GPTForCausalLM

    model = GPTForCausalLM(GPTConfig(**config, scan_layers=True),
                           device="cpu")
    ref = convert.state_dict_to_jax(model.state_dict(), model=model)
    rng = np.random.default_rng(seed)
    named = {}
    for name, a in ref.items():
        w = rng.standard_normal(np.shape(a)).astype(np.float32)
        named[name] = (w * 0.05 if name.endswith("bias") else
                       1.0 + 0.1 * w if "ln" in name else w * 0.1)
    return named


def unrolled(named, layers):
    """A scan model's weights under the unrolled model's names."""
    out = {}
    for name, a in named.items():
        if "blocks__" in name:
            pname = name.split("blocks__", 1)[1].replace("__", ".")
            for i in range(layers):
                out[f"gpt.blocks.{i}.{pname}"] = a[i]
        else:
            out[name] = a
    return out


def key_bias_out(name, a):
    """``a`` without the keys' bias (the middle third of a ``qkv`` bias,
    stacked or not): softmax ignores a constant added to a row's scores,
    so its gradient is 0 up to rounding and Adam moves it by about lr a
    step whatever the rounding; parameter bars leave it out (the losses
    cover it)."""
    if name.endswith("qkv.bias") or name.endswith("qkv__bias"):
        h = a.shape[-1] // 3
        return np.concatenate([a[..., :h], a[..., 2 * h:]], axis=-1)
    return a


def run_world(device=None, steps=3, batch=8, seq=32):
    """Stage 2 and the sharded scan over the world, each against the same
    global batch trained on this rank alone (world-1 steps, no group):
    returns the JSON-able result (rank 0's) and raises on a miss of the
    bars (losses 1e-4, parameters 1e-3 of each tensor's largest, the keys'
    bias aside: `key_bias_out`)."""
    from ..jit import FusedScanTrainStep, ShardedFusedScanTrainStep, TrainStep
    from ..models import GPTPretrainingCriterion
    from . import env
    dev = env.init_parallel_env(device=device)
    r, n = env.get_rank(), env.get_world_size()
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, SMALL["vocab_size"],
                                        (batch * n, seq))).to(dev)
    labels = torch.from_numpy(rng.integers(0, SMALL["vocab_size"],
                                           (batch * n, seq))).to(dev)
    named = small_weights()
    ctx = Ctx(r, n, dev, {"config": SMALL})
    crit = GPTPretrainingCriterion()
    mine = [_block(ids, r, n), _block(labels, r, n)]
    result = {"world": n, "backend": env.get_backend()}

    def run(make_step, model, batch_):
        step = make_step(model)
        return [float(step(*batch_)) for _ in range(steps)], _params(model)

    def held(tag, got, want):
        (gl, gp), (wl, wp) = got, want
        dl = max(abs(a - b) for a, b in zip(gl, wl))
        dp = max(float(np.abs(key_bias_out(k, gp[k]) - key_bias_out(k, wp[k]))
                       .max() / max(np.abs(wp[k]).max(), 1e-12)) for k in wp)
        result[tag] = {"losses": gl, "world1_losses": wl,
                       "max_loss_diff": dl, "max_param_rel": dp}
        if not (dl < 1e-4 and dp < 1e-3):
            raise AssertionError(f"{tag}: world {n} against world 1: loss "
                                 f"{dl}, params {dp}")

    loss_fn = lambda m, a, b: crit(m(a), b)  # noqa: E731
    world = run(lambda m: _stage2_step(m, loss_fn),
                _gpt(ctx, unrolled(named, SMALL["num_layers"]), False), mine)
    alone = run(lambda m: TrainStep(m, loss_fn, _adamw(m)),
                _gpt(ctx, unrolled(named, SMALL["num_layers"]), False),
                [ids, labels])
    held("stage2", world, alone)
    for storage in ("replicated", "sharded"):
        world = run(lambda m: ShardedFusedScanTrainStep(
            m, _adamw(m), criterion=crit, param_storage=storage),
            _gpt(ctx, named, True), mine)
        alone = run(lambda m: FusedScanTrainStep(m, _adamw(m),
                                                 criterion=crit),
                    _gpt(ctx, named, True), [ids, labels])
        held(f"sharded_scan_{storage}", world, alone)
    env.reset()
    return result


# ---------------------------------------------------------------------------
# stage 3 on the card: ranks sharing it over gloo (phase 28)
# ---------------------------------------------------------------------------

def _stage3_model(dev, cfg=None, layers=None, seq=1024):
    """GPT-3 1.3B (or ``cfg``) in bf16 with recompute, weights from seed
    0, and AdamW(1e-4) with fp32 masters, bf16 moments and the global
    clip: phase 23(c)'s dtypes."""
    from ..models import GPTForCausalLM, gpt_config
    from ..nn import ClipGradByGlobalNorm
    from ..optimizer import AdamW

    cfg = cfg or gpt_config("gpt3-1.3b", use_recompute=True,
                            max_position_embeddings=seq,
                            **({} if layers is None
                               else {"num_layers": layers}))
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=True, moment_dtype="bfloat16",
                grad_clip=ClipGradByGlobalNorm(1.0))
    return cfg, model, opt


def _cuda(dev):
    return torch.device(dev).type == "cuda"


def _timed(step, batch, steps, dev, after=None):
    """``steps`` calls of ``step(*batch)``: losses, seconds, the last
    call's launches of the port's kernels, ``after()`` after each."""
    from .mp_selftest import _counters, _read

    counters = _counters()
    losses, secs, launches, seen = [], [], None, []
    for _ in range(steps):
        before = _read(counters)
        if _cuda(dev):
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        losses.append(float(step(*batch)))
        secs.append(time.perf_counter() - t0)
        now = _read(counters)
        launches = {k: now[k] - before[k] for k in now}
        if after is not None:
            seen.append(after())
    return losses, secs, launches, seen


def stage3_world_one(dev, steps=3, batch=4, seq=1024, cfg=None,
                     layers=None):
    """`stage3_full_width`'s model, optimizer and global batch through a
    world-of-one `jit.TrainStep` (``model.loss``): the losses, its
    parameter bytes and peak memory, what the ranks are held to."""
    from ..jit import TrainStep
    from .mp_selftest import full_width_batch

    cfg, model, opt = _stage3_model(dev, cfg, layers, seq)
    step = TrainStep(model, lambda m, x, y: m.loss(x, y), opt,
                     numerics=False)
    if _cuda(dev):
        torch.cuda.reset_peak_memory_stats(dev)
    losses, secs, launches, _ = _timed(
        step, full_width_batch(cfg, dev, batch, seq), steps, dev)
    out = {"losses": losses, "step_s": secs, "launches_per_step": launches,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in model.parameters()),
           "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                    if _cuda(dev) else None),
           "layers": cfg.num_layers}
    del step, opt, model
    return out


def stage3_full_width(dev, steps=3, batch=4, seq=1024, cfg=None,
                      layers=None, offload=False):
    """GPT-3 1.3B (bf16 with recompute, fp32 masters, bf16 moments, AdamW
    with the clip) through ``group_sharded_parallel(level="p_g_os")`` +
    `jit.TrainStep` (``model.loss``) at sharding = the world, the rank's
    rows of the ``batch x seq`` tokens: losses, step seconds, the last
    step's launches and collectives, the rank's resident parameter bytes
    after each step, its peak memory, where the shards live (every
    rank's, gathered)."""
    from ..jit import TrainStep
    from . import collective as C
    from . import env
    from .mp_selftest import full_width_batch
    from .sharding import group_sharded_parallel

    n, r = env.get_world_size(), env.get_rank()
    cfg, model, opt = _stage3_model(dev, cfg, layers, seq)
    wrapped, opt, _ = group_sharded_parallel(model, opt, "p_g_os",
                                             offload=offload)
    step = TrainStep(wrapped, lambda m, x, y: m.loss(x, y), opt,
                     numerics=False)
    mine = [_block(t, r, n) for t in full_width_batch(cfg, dev, batch, seq)]
    if _cuda(dev):
        torch.cuda.reset_peak_memory_stats(dev)
    calls = []

    def after():
        calls.append(dict(C.calls_by_group))
        return wrapped.resident_param_bytes()

    C.reset_counts()
    losses, secs, launches, resident = _timed(step, mine, steps, dev, after)
    per_step = {k: v - calls[-2].get(k, 0) for k, v in calls[-1].items()} \
        if len(calls) > 1 else calls[-1]
    shards = wrapped._shards
    rec = {"rank": r, "losses": losses, "step_s": secs,
           "launches_per_step": launches, "collectives_per_step": per_step,
           "resident_param_bytes": resident,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in model.parameters()),
           "sharded_buckets": len(shards),
           "segments": len(opt._segment_params()),
           "shards_pinned_host": all(st.shard.device.type == "cpu"
                                     and st.shard.is_pinned()
                                     for st in shards) if offload else None,
           "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                    if _cuda(dev) else None)}
    ranks = []
    C.all_gather_object(ranks, rec)
    del step, opt, wrapped, model
    return {"sharding": n, "offload": offload, "layers": cfg.num_layers,
            "tokens": [batch, seq], "ranks": ranks}


def stage3_tiny_card_cpu(dev, steps=3):
    """A tiny fp32 GPT (tied head, recompute) through stage 3 on the card
    and on the CPU over the same gloo ranks from the same weights, AdamW
    with the clip, 3 steps: the losses and the largest relative
    parameter difference (the keys' bias aside: `key_bias_out`)."""
    from ..jit import TrainStep
    from ..models import GPTConfig, GPTForCausalLM
    from ..nn import ClipGradByGlobalNorm
    from ..optimizer import AdamW
    from . import env
    from .sharding import group_sharded_parallel

    n, r = env.get_world_size(), env.get_rank()
    cfg = GPTConfig(**SMALL, use_recompute=True)
    rng = np.random.default_rng(4)
    sd = {k: torch.from_numpy((rng.standard_normal(tuple(v.shape)) * 0.1)
                              .astype(np.float32))
          for k, v in GPTForCausalLM(cfg, device="cpu").state_dict().items()}
    ids = rng.integers(0, SMALL["vocab_size"], (8, 64))
    labels = rng.integers(0, SMALL["vocab_size"], (8, 64))
    out = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = GPTForCausalLM(cfg, device=d)
        model.load_state_dict(sd)
        model.train()
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
        wrapped, opt, _ = group_sharded_parallel(model, opt, "p_g_os",
                                                 segment_size=4096)
        step = TrainStep(wrapped, lambda m, x, y: m.loss(x, y), opt,
                         numerics=False)
        batch = [_block(torch.from_numpy(x).to(d), r, n)
                 for x in (ids, labels)]
        out[where] = {"losses": [float(step(*batch)) for _ in range(steps)],
                      "params": {k: v.cpu() for k, v in
                                 wrapped.state_dict().items()}}
        del step, opt, wrapped, model
    dl = max(abs(x - y) for x, y in zip(out["card"]["losses"],
                                        out["cpu"]["losses"]))
    dp = max(float(np.abs(key_bias_out(k, _np(v)) - key_bias_out(
                 k, _np(out["cpu"]["params"][k]))).max()
                   / max(np.abs(_np(out["cpu"]["params"][k])).max(), 1e-12))
             for k, v in out["card"]["params"].items())
    return {"losses_card": out["card"]["losses"],
            "losses_cpu": out["cpu"]["losses"], "max_loss_diff": dl,
            "max_param_rel": dp, "sharding": n}


def run_stage3_card(nccl=False, steps=3, layers=None, tiny=False):
    """Phase 28's ranks: join the world (gloo sharing the card, or NCCL
    one card a rank), then `stage3_full_width` plain and with
    ``offload=True`` (not with ``tiny``), then `stage3_tiny_card_cpu`;
    rank 0's result."""
    from . import env

    dev = env.init_parallel_env(backend=None if nccl else "gloo",
                                device=None if nccl else "cuda",
                                timeout=600)
    result = {"backend": env.get_backend(), "device": str(dev),
              "world": env.get_world_size()}
    for tag, off in () if tiny else (("stage3", False), ("offload", True)):
        t0 = time.perf_counter()
        result[tag] = stage3_full_width(dev, steps=steps, layers=layers,
                                        offload=off)
        result[tag]["wall_s"] = time.perf_counter() - t0
        gc.collect()        # the wrapper's hooks hold it in a cycle
        torch.cuda.empty_cache()
    result["tiny_card_cpu"] = stage3_tiny_card_cpu(dev)
    env.reset()
    return result


def launch_stage3_card(nprocs=2, nccl=False, steps=3, layers=None,
                       deadline=900, tiny=False):
    """`run_stage3_card` in ``nprocs`` ranks under
    ``torch.distributed.run``: rank 0's result (`mp_selftest.launch_card`:
    every rank killed past ``deadline``)."""
    from .mp_selftest import launch_card

    return launch_card(nprocs, nccl, steps, deadline, module=__name__,
                       extra=["--stage3"] + (["--tiny"] if tiny else [])
                       + ([] if layers is None else ["--layers",
                                                     str(layers)]))


def _stage2_step(model, loss_fn):
    from ..jit import TrainStep
    from .sharding import group_sharded_parallel

    wrapped, opt, _ = group_sharded_parallel(model, _adamw(model), "os_g")
    return TrainStep(wrapped, loss_fn, opt)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--worker")
    p.add_argument("--rank", type=int)
    p.add_argument("--nprocs", type=int)
    p.add_argument("--dir")
    p.add_argument("--timeout", type=float, default=60)
    p.add_argument("--device", default=None,
                   help="cpu for gloo; the card (NCCL) by default")
    p.add_argument("--stage3", action="store_true",
                   help="phase 28: GPT-3 1.3B under stage 3, ranks sharing "
                        "the card over gloo (--nccl: one card a rank)")
    p.add_argument("--nccl", action="store_true")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--layers", type=int, default=None)
    p.add_argument("--tiny", action="store_true",
                   help="with --stage3: the tiny GPT alone")
    a = p.parse_args(argv)
    if a.worker:
        worker(a.worker, a.rank, a.nprocs, a.dir, a.timeout)
        return 0
    result = (run_stage3_card(a.nccl, a.steps, a.layers, a.tiny)
              if a.stage3 else run_world(a.device))
    if int(os.environ.get("RANK", "0")) == 0:
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
