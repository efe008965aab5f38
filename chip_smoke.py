#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``paddle_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, nothing is caught). Each phase's
lines go whole to ``chiprun_out/chip_smoke.log`` (git-ignored); stdout
holds one short line a phase (`_Lines`: the script's seconds at the
phase's last line, its lines in the log, the start of the last one),
then the kernels line with the contract's keys and every launch count
(whole in the log), the ``nvidia-smi`` line and the result, so that a
whole run's stdout fits a 24 KB tail:

1. the card: name, device count, ``nvidia-smi`` name and power limit;
2. build every kernel from ``paddle_tpu_torch/csrc`` with ``nvcc``, one
   compiler per source, all started together; for each kernel redesigned
   on warpgroup products (``csrc/hopper_tiles.cuh``: the bf16 fused CE
   backward and forward on one mainloop, the single-block flash forward,
   the tiled flash and splash forwards of ``csrc/attention_wgmma.cuh``,
   the dQ and dK/dV kernels of both flash backwards and of the splash
   backward, ``csrc/attention_wgmma_bwd.cuh``, the chunk attention of
   ``csrc/paged_wgmma.cuh`` and the weight-only linear's prompt route,
   ``wo_wgmma_kernel``), its registers, spills and shared memory
   from the ``-Xptxas=-v`` log and the ``HGMMA`` instructions in its
   SASS (``cuobjdump``; the run fails on none, on a backward or
   chunk kernel that spills at head dim 64, and on any spill of the
   weight-only kernel); the same with ``HMMA`` for the weight-only decode
   route ``wo_mma_kernel`` (mma.sync; it fails on none and on any
   spill), and for the split-K decode of ``csrc/paged_split.cuh`` (CUDA
   cores; it fails on any spill) and the optimizer's kernels of
   ``csrc/multi_tensor.cu`` (no spill);
3. each kernel against its plain PyTorch version on the card, in fp32
   and bf16 (tolerances at `check_kernels` and
   `check_training_kernels`), at the shapes the serving and training
   paths give it: the paged kernels over bf16, int8 and int4 pools, each
   bit-identical on a second call and timed beside its pages route (the
   first design) on the same inputs (the chunk's bf16 warpgroup route
   also at GQA, c of 1 to 64, head dims 16 to 128 and shuffled page
   tables; the decode's split route also at GQA, head dims 16 to 256
   and lengths at page and split edges); splash (the path's shape and GQA
   with segments in both dtypes; in bf16 also ragged lengths, head dims
   16, 80 and 128, a key tile fully masked for some rows and rows with
   no visible key; the bf16 backward on warpgroup products) and the
   fused CE (a ragged case and one over four vocab chunks; the bf16
   forward's first design timed beside it), each forward and backward
   run twice and compared bit for bit; the flash pairs at the flash runs'
   shapes (single-block [8, 1024, 32, 64], tiled [4, 2048, 32, 64]) with
   each backward run twice and compared bit for bit, both pairs at
   ragged shapes (forward and backward), and a ring tick (a key block's
   forward, and its backward from the global lse and out of two key
   halves); then timed
   with CUDA events (L2 flushed between launches) beside the plain
   version and one PyTorch library call on the same inputs (the paged
   kernels, their pages routes and SDPA as CUDA-graph replays: their
   wrappers take longer on the host than the kernels on the card); the
   optimizer's kernels (``csrc/multi_tensor.cu``: the norm with the
   non-finite check, and the fused Adam update) on the GPT-3 1.3B
   parameter list in its two configurations (bf16 parameters with fp32
   masters and bf16 moments; fp32 with amsgrad), with a group's lr and
   decay, L2 terms and a parameter outside the clip, and at odd sizes
   and more tensors than one launch takes, each bit-identical on a
   second call and unchanged under a set ``found_inf``, timed as
   CUDA-graph replays beside ``torch._fused_adamw_``; the fused CE again
   at LLaMA's vocab of 32000, TinyLlama's training shape (h [8192,
   2048]) and LLaMA-7B's head (h [2048, 4096]), fp32 and bf16, forward
   and backward, timed as at GPT's; the weight-only linear
   (``csrc/weight_only.cu``) on each of GPT-3 1.3B's four projections at
   M = 1, 8 (the decode routes), 128 and 1024 (the prompt routes: the
   decode lane's prompt passes at batch 1 and 8), int8 per
   channel, int4 and int8 grouped 128, fp32 x (the first design,
   ``wo_gemv_kernel`` / ``wo_tiled_kernel``) and bf16 x (``wo_mma_kernel``
   / ``wo_wgmma_kernel``), and fp16 on qkv at M 8, 40 (the speculative
   verify), 64 (a chunk) and 1024, each within its bar of the plain
   version, bit-identical on a second call and counted on its route,
   timed as CUDA-graph replays beside the plain version, its byte bound,
   ``F.linear`` over the bf16 weight and ``weight_dequantize`` + the
   product, each bf16 / fp16 row and ``F.linear`` also back to back over
   8 weights (``stream_ms``); the
   chunk kernel over bf16, int8
   and int4 pools again at the speculative verify's shape (q [8, 5, 32,
   64]: k = 4, over phase 5's pools), bit-identical twice, timed as
   CUDA-graph replays beside the plain version, SDPA over the dense K/V
   and its byte bound;
4. serving parity: a tiny fp32 GPT served through the engine's CUDA
   graphs on the card, its eager loop on the card (kernels) and on the
   CPU (plain versions) over fp32, int8 and int4 pools, at decode bursts
   1 and 4, gives identical greedy tokens (one decode graph each); then
   sampled requests with fixed seeds give identical tokens through the
   graphs and the eager loop on the card;
5. the serving path at GPT-3 1.3B width: 16 greedy requests through
   ``ServingEngine`` with bf16 weights and pools, first through the eager
   loop (``compiled=False``), then through the CUDA graphs (the
   default), each after ``warmup()``; the paged kernels' launch counters
   are zeroed just before and read just after each run: the decode's
   split route and the chunk's warpgroup kernel over bf16 pools must be
   > 0, both pages routes and the quantized kernels 0, and the launches
   a call equal in the two runs; the greedy tokens must be identical,
   and the graph run must capture nothing after ``warmup()`` (one decode
   graph, at most one prefill graph a chunk bucket); tok/s, TTFT and
   inter-token latency, peak memory (allocated, and reserved: the graphs'
   pools) and the warm-up time of both;
6. the same with ``kv_quant="int8"`` and then ``"int4"``: the split
   decode and the chunk's warpgroup kernel of that mode must be > 0,
   every other paged kernel 0; pool bytes and capacity against the bf16
   run;
7. ``generate()`` at the same width, 8 prompts of 128 tokens and 32 new
   tokens over the paged cache with bf16 and with int8 pools, compiled:
   the decode graph is captured in the warm-up call and replayed in the
   measured one; the split decode of the pools must have run, and
   neither its pages route nor a splash forward (a 128-token prefill is
   under ``FLAGS_pallas_flash_min_seqlen``: the dense attention, as in
   the reference);
8. training parity: a tiny fp32 GPT takes three ``TrainStep``s (AdamW,
   global-norm clip) on the card and on the CPU, with packed-sequence
   segment ids through splash, then with ``FLAGS_splash_attn`` off
   through the flash pairs at 128 (``FLAGS_pallas_flash_min_seqlen``
   lowered to 16) and 1280 tokens; losses and parameters must agree, the
   path's kernels (the optimizer's norm and update among them) must
   have run and no other training kernel; then a guarded variant
   (``GradScaler`` + ``guard_nonfinite``, an inf loss at the second of
   four steps, steps 2-4 under ``torch.cuda.set_sync_debug_mode
   ("error")``): the skip bit-identical on the card and on the CPU, the
   scale and the parameters in agreement;
9. the training path at GPT-3 1.3B width: ``TrainStep`` + AdamW (bf16
   weights, fp32 masters, bf16 moments, clip 1.0) over 8 x 1024 random
   tokens with recompute, 2 warm-up and 5 timed steps; the training
   kernels' counters are zeroed just before the timed steps and read
   just after: the bf16 splash forward and backward and the bf16 CE
   forward on warpgroup products, the CE backward and the optimizer's
   norm and update must be > 0, every other training kernel (the fp32
   splash and CE routes among them) 0, and every loss finite; the
   optimizer's launches a step must be 2 (one norm, one update of the
   one dtype group), and ``opt.step()`` alone under the profiler must
   launch those two kernels and nothing else; the steps run with the
   numerics monitor on (the default), then 1 + 5 more with
   ``numerics=False`` give the monitor's cost;
10. the same with ``FLAGS_splash_attn`` off (the reference's flash
    routing, the flag's off setting; splash is its default), 2 warm-up
    and 3 timed steps at 8 x 1024 (the single-block forward and the bf16
    single-block backward on warpgroup products must run, and no other
    attention kernel, the fp32 backward route among them) and at 4 x 2048
    (the bf16 tiled forward and backward on warpgroup products);
11. ResNet parity: resnet18 at 32 x 32, batch 4, Momentum(0.1, 0.9),
    three ``TrainStep``s on the card and on the CPU, each from the CPU's
    state (a trajectory at this size is chaotic); losses, parameters,
    batch norm buffers and velocities must agree; then a guarded step
    over a batch with an inf (under ``set_sync_debug_mode("error")`` on
    the card) must leave them bit-identical on both;
12. ResNet-50 training at the reference bench lane's configuration
    (``bench.py`` ``run_resnet_config``: fp32, batch 32 of 224 x 224,
    Momentum(0.1, 0.9)): 2 warm-up and 5 timed steps (step ms, images/s,
    ``mfu_fp32`` from the convolutions' and the Linear's FLOPs, peak
    memory), then 5 steps through ``step.prefetch`` with a new host batch
    a step (images/s, ``input_stall_ms``, ``h2d_ms``); every loss finite
    and every counter of the port's own kernels at 0 (convolution, batch
    norm and pooling run as cuDNN and aten ops); then ``save`` of the
    model and the Momentum state and ``load`` into a fresh CPU model and
    optimizer, bit for bit;
13. fused-scan parity: a tiny fp32 ``scan_layers`` GPT takes three
    ``FusedScanTrainStep``s (AdamW, global-norm clip, fused head, packed
    segment ids) on the card and on the CPU at ``layer_chunk`` 1 and 3;
    then a guarded run (``GradScaler`` + ``guard_nonfinite``, an inf in
    the embedding row of a batch token at the second of four steps,
    steps 2-4 under ``torch.cuda.set_sync_debug_mode("error")``): losses
    1e-4, parameters 1e-3 rel, the skip bit-identical on both, the step
    count raised once a step; the fp32 splash and CE kernels and the
    optimizer's norm and update must have run, no other training kernel;
14. GPT-3 1.3B through ``FusedScanTrainStep`` at the reference bench's
    default configuration for the model (``bench.py:52-64,79-86,
    100-126``: fp32 parameters with no separate masters, AdamW(1e-4)
    with bf16 moments, no clip, ``fused_head=True``,
    ``compute_dtype="bfloat16"``, ``layer_chunk=1``), 8 x 1024 random
    tokens, 2 warm-up and 5 timed steps with the numerics monitor on,
    then the same with ``numerics=False``: tokens/s, step ms, ``mfu``,
    peak memory; a step's launches must be 48 splash forwards (forward
    and recompute), 24 backwards, one CE forward and backward on
    warpgroup products and 25 ``mt_adam_kernel`` (one a layer, one for
    the outer parameters), every other training kernel 0 (the monitor's
    sums of squares run ``mt_norm_kernel``), and every loss finite;
15. LLaMA parity: a small fp32 GQA LLaMA (hidden 256, 4 layers, 8
    query over 2 KV heads), tied and untied head, takes three
    ``TrainStep``s (AdamW, global-norm clip, recompute, through
    ``model.loss``) on the card and on the CPU, each step from the CPU's
    state: losses 1e-4, parameters 1e-3 rel; the fp32 CE kernels and the
    optimizer's two must have run, no attention kernel;
16. TinyLlama-1.1B training at full width (``llama_config(
    "tinyllama-1.1b", use_recompute=True)``): bf16 through
    ``amp.decorate(level="O2")``, AdamW(1e-4) with fp32 masters and
    bf16 moments, clip 1.0, 4 x 2048 random tokens, 2 warm-up and 5
    timed steps with the numerics monitor, then 1 + 5 without it: step
    ms, tokens/s, ``mfu``, peak memory; a step launches exactly one CE
    forward on warpgroup products, one CE backward, one
    ``mt_adam_kernel``, one ``mt_norm_kernel`` and no attention kernel
    (the attention is dense, as in the reference); every loss finite,
    the first near ln(32000);
17. ``bench.py``'s decode lane (``run_decode_config``) at GPT-3 1.3B
    width: prompt 128, 64 new tokens, batch 1 and 8, greedy, over the
    dense cache, the paged cache and the dense cache with
    ``quantize_for_decode`` int8 weights, in fp32 (weights and cache, the
    reference's) and in bf16: decode tok/s, prefill TTFT and cold-start
    ms, peak memory, the weight-only launches per route and the graph
    counts; each run captures one prompt graph and one decode graph in
    its warm-up call and none after, the int8 runs launch the weight-only
    kernel on a decode and a prompt route (fp32: the first design's
    ``gemv`` / ``tiled``; bf16: ``mma`` / ``wgmma``; no other route) and
    the fp runs never; at batch 1 and 8, the fp32 int8 model's logits
    within 2e-4 of its ``weight_dequantize`` twin's, the bf16 one's
    greedy tokens equal to its twin's up to each row's first divergence,
    where the twin's top-2 gap must be under ``BF16_GAP_BAR``; first a tiny
    int8 GPT's dense greedy tokens equal on the card and the CPU;
18. speculative decoding: (a) ``inference.spec_decode_selftest.run_probe``
    on the CPU and on the card (a tiny fp32 GPT: greedy spec tokens equal
    to plain decoding's over dense, paged, int8 and int4 caches with a
    weak independent draft, the self-draft and the strong pair, whose
    dispatches must be ceil((n-1)/(k+1)); serving parity over fp, int8
    and int4 pools with no leak; one spec graph an engine on the card):
    every case's tokens equal on both; (b) ``generate()`` at GPT-3 1.3B
    width with the strong pair (k = 4), prompt 128, 64 new tokens, batch
    1 and 8, dense and paged, fp32 and bf16, beside plain decoding of the
    same target: decode tok/s, TTFT, accept rate, tokens a dispatch, the
    paged kernels' launches a dispatch, no capture after the warm-up call;
    fp32 tokens identical to plain, bf16 identical up to each row's first
    divergence, where the plain logits' top-2 gap must be under
    ``BF16_GAP_BAR``; (c) phase 5's traffic through ``ServingEngine``
    with the strong pair (bf16 and int8 pools) and with
    ``draft_model="self"`` on the zero target, each beside the plain
    engine of its target: output tok/s, the accept-rate gauge, no capture
    after ``warmup()``, and the paged kernels' launches exactly those of
    the dispatches and chunk calls (a draft dispatch: k + 1 one-layer
    decodes, one 24-layer verify; a self-draft dispatch: a 24-layer
    decode and a verify);
19. one JSON line ``{"kernels": [...]}`` with each kernel's error,
    times, bound and launches (a paged kernel's from the serving run of
    its pools' graph run, splash's, the CE's and the optimizer's from
    phase 9, a flash pair's from its phase-10 run; splash's, the CE's
    and the optimizer's phase-14 launches beside them, and the CE's and
    the optimizer's phase-16 launches; the CE rows also carry phase 3's
    numbers at LLaMA's two heads, ``llama_shapes``; the four weight-only
    kernels' launches from phase 17's int8 runs (the first design's from
    the fp32 runs, the Hopper routes' from the bf16 runs), with every
    phase-3 row of their route;
    the chunk rows' verify-shape numbers, and each paged kernel's launches
    a serving spec dispatch from phase 18; the optimizer's update also
    its phase-20 launches, ``launches_bert``; splash's, the CE's and the
    optimizer's phase-23(b) launches, ``launches_sharded_scan``),
    printed after phases 20-23, whose launches it carries;
20. BERT (masked attention and attention dropout on the card, as aten
    ops: the reference's XLA ``_sdpa_ref``): (a) a small fp32 BERT
    (hidden 64, 2 layers, 4 heads) at 4 x 64 tokens under padding masks
    of lengths 17-64, card against CPU: both heads' logits within 1e-4,
    3 AdamW ``TrainStep``s of the fine-tune head each from the CPU's
    state (losses 1e-4, parameters 1e-3 rel; ``mt_adam_kernel`` and no
    other kernel of the port's); (b) on the card, a row's pooled output
    within 1e-5 when its padded tokens change; (c) the dropout contract
    of SDPA with ``dropout_p`` 0.1 on [8, 128, 12, 64] on the card: the
    kept share within 4 sigma of 0.9, a generator's seed bit-identical
    twice and another seed different, ``training=False`` equal to
    ``dropout_p=0``; (d) BERT-base fine-tuning at full width (hidden 768,
    12 layers, vocab 30522, 2 classes; dropout 0.1; bf16 through
    ``amp.decorate(level="O2")``, AdamW(2e-5) with fp32 masters,
    ``TrainStep``), 32 x 128 random tokens under padding masks of
    lengths 32-128, 2 warm-up and 5 timed steps: step ms, samples/s,
    tokens/s, ``mfu``, peak memory; two ``mt_adam_kernel`` a step (the
    bf16 weights with fp32 masters, the fp32 LayerNorms) and no other
    kernel of the port's, every loss finite, the first within 0.5 of
    ln 2, the LayerNorms fp32;
21. LeNet through ``paddle_tpu_torch.Model`` on the reference's
    synthetic MNIST (4096 training and 4096 test images): (a)
    ``train_batch`` at batch 64 in order, card against CPU, 3 Adam steps
    each from the CPU's state (losses 1e-4, parameters 1e-3 rel); (b)
    ``prepare(Adam(1e-3), CrossEntropyLoss(), Accuracy())``, then
    ``fit`` one epoch at batch 64 without and with ``prefetch=True``,
    ``evaluate`` and ``predict``: losses finite, ``evaluate``'s ``acc``
    equal to a recount from ``predict``'s outputs, ``save`` -> ``load``
    bit for bit; images/s of both fits, the seconds of evaluate and
    predict, ``input_pipeline_stats``. Every phase-20 and -21 line holds
    the ``nvidia-smi`` name and power limit;
22. the collectives at a world of one over NCCL, through
    ``init_parallel_env()`` with no environment set (it fails if one
    is): every collective of ``distributed.collective`` on fp32 and bf16
    card tensors held to its one-rank meaning bit for bit (p2p as a
    batched send to oneself and its receive), the compressed all-reduce
    (int8, bf16) bit for bit its plain twin on the CPU, a store round
    trip (`sharding_selftest.check_world1`); the NCCL version, the
    backend, the time of a 256 MiB all-reduce and all-gather;
23. the sharded training paths: (a) a tiny fp32 scan GPT through
    ``ShardedFusedScanTrainStep`` on the card and on a gloo group of the
    same rank, both storages, 3 steps each card step from the CPU's
    state (losses 1e-4, shards 1e-3 rel); (b) GPT-3 1.3B through it at
    phase 14's configuration, both storages, 2 + 5 steps: step ms,
    tokens/s, ``mfu``, peak memory beside phase 14's (monitor off), the
    storages' losses and parameters bit-identical, every loss finite and
    the first within 0.5 of ln 50304, launches a step exactly phase
    14's, the collectives a step and each bucket's bytes; (c) eager
    stage 2 (``fleet.init`` + ``group_sharded_parallel(level="os_g")``
    + ``TrainStep``) at 4 layers of GPT-3 1.3B width, phase 9's
    configuration, losses within 1e-4 of plain ``TrainStep``, a guarded
    inf step bit-identical; (d) BERT-base with sharding stage 1 through
    ``fleet.distributed_optimizer`` at phase 20(d)'s configuration: step
    ms and samples/s beside phase 20(d), two ``mt_adam_kernel`` a step;
    (e) with two cards or more, ``sharding_selftest`` under
    ``torch.distributed.run --nproc_per_node 2``; with one, a line that
    says it did not run. Every phase-22 and -23 line holds the
    ``nvidia-smi`` name and power limit;
24. the mp axis, after phase 23 has left the world: (a) the
    vocab-parallel head's kernels in one process, GPT-3 1.3B's head (h
    [8192, 2048] over W [50304, 2048] in bf16; h [1024, 2048] over
    [4096, 2048] in fp32) cut in mp 2 and 4: every shard's forward
    (`sharded_fused_ce_fwd`: #11 with the labels as the shard's columns,
    the combine writing the picked logit) and backward (#12 against the
    global lse) against the plain version within phase 3's bars and
    bit-identical twice, the counters stepped once a shard, the shards
    combined as the collective combines them against the unsharded
    kernels, shard 0's ms (L2 flushed) beside its bound, the plain
    version and ``F.linear`` + ``logsumexp``; (b) GPT-3 1.3B at dp 1 x
    mp 2 with both ranks on the card over gloo
    (``mp_selftest.launch_card``: ``torch.distributed.run
    --nproc_per_node 2 -m paddle_tpu_torch.distributed.mp_selftest``,
    ``fleet.init(mp_degree=2)`` -> ``fleet.distributed_model(gpt_scan)
    .train_step(AdamW + ClipGradByGlobalNorm(1.0))``, bf16 compute over
    fp32 parameters, 4 x 1024 tokens, 3 steps) against a world-of-one
    ``FusedScanTrainStep`` on the same weights and batch computed first
    in this process (each of the 3 steps' losses within 1e-2, the gaps
    printed), the ranks'
    losses identical, a rank's launches a step exact (48 splash
    forwards, 24 backwards, 1 + 1 CE at V/2 rows, 25 ``mt_adam_kernel``,
    1 ``mt_norm_kernel``) and its collectives a step exact (6 mp
    all-reduces a layer and 3 in the head; the grads reduce-scattered
    once over the flattened group; no mp-only gradient collective); the
    step times, which gloo's trips through the host dominate, are no
    speed of mp; (c) a tiny fp32 scan GPT at mp 2, the two ranks on the
    card against the same ranks on the CPU (loss 5e-4, parameters 5e-3
    relative); (d) with two cards or more, (b) over NCCL, one card a
    rank; with one, a line that says it did not run. The kernels line
    carries a rank's launches a step at mp 2 (``launches_mp``) and the
    CE rows their shards' records (``mp_shards``);
25. the pp axis: (a) GPT-3 1.3B at dp 1 x pp 2 with both ranks on the
    card over gloo (``pipeline_selftest.launch_card``:
    ``torch.distributed.run --nproc_per_node 2 -m
    paddle_tpu_torch.distributed.pipeline_selftest``, ``fleet.init``
    with a strategy of ``pp_degree`` 2 and ``pipeline_configs={
    "accumulate_steps": 4}`` ->
    ``fleet.distributed_model(gpt_scan).train_step(AdamW +
    ClipGradByGlobalNorm(1.0), fused_head=True)``, bf16 compute over fp32
    parameters, 4 x 1024 tokens in 4 micro-batches, 3 steps) against
    phase 24's world-of-one ``FusedScanTrainStep`` losses (every step
    within 1e-2, the gaps printed), the ranks' losses identical, a rank's
    launches a step exact, counted from the design (`_pp_launches`: its
    12 layers' splash forwards on each micro-batch in the ring and again
    in the backward's recompute, their backwards, the CE's 1 + 1 on stage
    0 alone, 25 ``mt_adam_kernel``, 1 ``mt_norm_kernel``), its p2p sends
    and receives a step exact (4 a pass each way) and its collectives
    over the flattened group exact; the peak memory of a rank and the
    step times, which gloo's trips through the host set, are no speed
    of pp; (b) a tiny fp32 scan GPT at pp 2 and at pp 2 x mp 2 (four
    ranks), the ranks on the card against the same ranks on the CPU
    (loss 5e-4, parameters 5e-3 relative); (c) `PipelineParallel.
    train_batch` over a tiny model with a tied `SharedLayerDesc`
    embedding and `GPTForCausalLMPipe` (chunks 1 and 2) at pp 2 on the
    card, against one rank running the whole model (loss 1e-4,
    parameters or grads 1e-3 relative); (d) with two cards or more, (a)
    over NCCL, one card a rank; with one, a line that says it did not
    run. The kernels line carries a rank's launches a step at pp 2
    (``launches_pp``, by stage);
26. LLaMA under mp and pp (BASELINE config 5's layout): (a) #11 / #12 on
    LLaMA-7B's vocab-parallel head (h [8192, 4096] bf16 over W [32000,
    4096]) cut in mp 2 and 4 (16000 and 8000 rows, each shard ending in
    a ragged tile), phase 3's bars, bit-identical twice, the counters
    stepped once a shard, shard 0 timed beside its bound, the plain
    version and ``F.linear`` + ``logsumexp``; (b) LLaMA-7B's widths
    (hidden 4096, 32 heads, intermediate 11008, vocab 32000; depth cut
    to 8 layers) at dp 1 x mp 4, four gloo ranks sharing the card
    (``llama_selftest.launch_card(4)``: ``fleet.init`` at mp 4 ->
    ``fleet.distributed_model(llama).train_step(AdamW +
    ClipGradByGlobalNorm(1.0))``, bf16 O2 with recompute, 4 x 2048
    tokens, 3 steps) against a world-of-one ``TrainStep`` on the same
    weights and batch computed first in this process (every step within
    1e-2, the gaps printed), the ranks' losses identical, a rank's
    launches a step (`_llama_mp_launches`: #11 and #12 once each at V/4
    rows, one ``mt_adam_kernel``, two ``mt_norm_kernel``) and its
    collectives (`_llama_mp_collectives`) exact; (c) the same model at
    tp 4 x pp 2, eight gloo ranks sharing the card, through
    ``LlamaForCausalLMPipe`` and ``PipelineParallel``
    (``accumulate_steps`` 4, 2 steps) against the world of one's first
    two losses (1e-2), every rank's launches (`_llama_pp_launches`),
    collectives, sends and receives a step exact
    (`_llama_pp_collectives`), its peak memory and
    step times printed, which gloo's trips
    through the host set: no speed of mp or pp; (d) a tiny fp32 GQA
    LLaMA (KV heads 2) at dp 2 x mp 2 and dp 2 x pp 2 x mp 2, the ranks
    on the card against the same ranks on the CPU (loss 5e-4,
    parameters 5e-3 relative); (e) with two cards or more, (b) over
    NCCL, one card a rank; with one, a line that says it did not run.
    The kernels line carries a rank's launches a step at mp 4
    (``launches_llama_mp``) and at tp 4 x pp 2 by stage
    (``launches_llama_pp``), and the CE rows the head's shards
    (``llama_mp_shards``);
27. the zero-bubble ring: (a) ``GPTForCausalLMPipe`` at GPT-3 1.3B's
    widths (bf16, weights from seed 0, 24 layers, 12 a stage) at pp 2,
    two gloo ranks sharing the card (``pipeline_selftest.launch_card(2,
    zb=True)``), 4 x 1024 tokens in 4 micro-batches: the AD ring, then
    ``use_zero_bubble=True`` on the same weights and batch; the losses
    bit for bit (one forward), every grad within 2e-2 of its tensor's
    largest element of the AD ring's (bf16: the fold sums the
    micro-batches in fp32, the AD ring in bf16), each rank's launches of
    a forward and backward exact (`_zb_launches`: the AD ring's splash
    forwards twice a layer and micro-batch, its backwards once; the
    zero-bubble ring's forwards three times, in the ring, the dX tick's
    recompute and the fold's, its backwards twice; no CE kernel: the
    pipe's head is a product and the criterion, as the reference's);
    (b) a tiny fp32 zero-bubble pipe and (c) ``zb_linear_pipeline`` on
    the card against the same ranks on the CPU (loss 1e-4, grads 1e-3
    relative; outputs 1e-5, grads 1e-4). The kernels line carries a
    rank's launches at pp 2 by stage (``launches_zb``);
28. sharding stage 3: (a) GPT-3 1.3B's widths (bf16 weights with fp32
    masters and bf16 moments, AdamW(1e-4) with the clip, recompute, the
    fused head; depth `STAGE3_LAYERS`) through
    ``group_sharded_parallel(level="p_g_os")`` + ``TrainStep`` at
    sharding 2, two gloo ranks sharing the card
    (``sharding_selftest.launch_stage3_card(2)``), each rank on 2 of the
    4 x 1024 rows, 3 steps, against a world-of-one ``TrainStep`` on the
    same weights and batch computed first in this process (every step
    within 1e-2), the ranks' losses identical, each rank's launches a
    step exact (`_stage3_launches`: its layers' splash forwards twice,
    backwards once, the CE 1 + 1, the update and the clip's norm one
    launch per 448 segments of its shards), its resident parameter bytes
    between steps (about half the world of one's) and peak memory
    printed beside the world of one's; (b) ``offload=True``: the losses
    (a)'s bit for bit, the shards in pinned host memory; (c) a tiny fp32
    GPT under stage 3 card against CPU over the same ranks (loss 1e-4,
    parameters 1e-3 relative); (d) with two cards or more, (a) over
    NCCL; with one, a line that says it did not run. The kernels line
    carries a rank's launches a step (``launches_stage3``);
29. the sep axis (sequence blocks), two gloo ranks sharing the card at
    sep 2 (``sep_selftest.launch_card(2)``): (a) ``ring_flash_attention``
    at GPT-3 1.3B's attention widths ``[4, 4096, 32, 64]``, fp32 and
    bf16, causal and not, against the plain full attention of the same
    inputs (the plain versions of the tiled pair over the whole
    sequence) computed first in each rank: the forward within 3e-5 in
    fp32 (phase 3's 2e-2 in bf16), the grads within phase 3's flash bars
    (1e-4 / 2e-2 of the largest grad), bit for bit twice, and each
    rank's launches of #7 / #8 a ring call exact (`_sep_ring_launches`:
    ``r + 1`` on rank r causal, 2 not); (b) GPT-3 1.3B's widths with
    ``use_ring_attention=True`` (bf16 weights, fp32 masters, bf16
    moments, AdamW(1e-4) with the clip, recompute; depth
    `STAGE3_LAYERS`) through ``fleet.init(sep_degree=2)`` ->
    ``fleet.distributed_model(model).train_step(opt)``, 4 x 2048 tokens,
    each rank on its 4 x 1024 block, 3 steps, against a world-of-one
    ``TrainStep`` on the same weights and batch computed first in this
    process (every step within 1e-2), the ranks' losses identical, each
    rank's launches a step exact (`_sep_launches`: no splash (the ring
    is aten ops), the CE 1 + 1, the update and the clip's norm 1), peak
    memory printed beside the world of one's; (c) LLaMA-7B's widths at 2
    layers with the ring, fp32, 2 x 2048 tokens: one step's loss and
    grads against the world of one computed first in rank 0 (1e-2; the
    grads over each tensor's largest element); (d) a tiny fp32 GPT and
    GQA LLaMA with the ring card against CPU over the same ranks (loss
    1e-4, grads 1e-3 relative, 3 steps' losses 1e-4); (e) with two
    cards or more, (b) over NCCL; with one, a line that says it did not
    run. The kernels line carries a rank's launches of #7 / #8 a ring
    call (``launches_sep_ring``) and of the CE a step
    (``launches_sep``). Phase 28 runs at the depth `STAGE3_LAYERS` (8
    of GPT-3 1.3B's 24 layers) so that the script stays within half its
    time limit with this phase;
30. sep beside mp and pp (BASELINE config 5, "LLaMA-7B HybridParallel
    tp=4 pp=2 + sequence-parallel", in one run at tp 2; tp 4 is phase
    26's): LLaMA-7B's widths cut to `SEP_HYBRID_LAYERS` (4) layers,
    phase 16's dtypes, ``use_ring_attention=True``, 2 x 2048 tokens,
    weights from seed 0; (a) #11 / #12 on the rank's head shard at mp 2
    (h [2048, 4096] bf16 over W [16000, 4096], `_mp_ce_case`: phase 3's
    bars, shard 0 timed beside its bound), then mp 2 x sep 2, four gloo
    ranks sharing the card (``llama_selftest.launch_card(4, sep=2)``:
    ``fleet.init`` -> ``distributed_model`` (`SegmentParallel` over the
    Megatron blocks) -> ``train_step``), 3 steps; (b) tp 2 x pp 2 x sep
    2, eight ranks (`LlamaForCausalLMPipe` -> `PipelineParallel.
    train_batch`, 2 micro-batches, each cut to the rank's block), 2
    steps; each step's loss within 1e-2 of a world-of-one ``TrainStep``
    computed first in this process, the ranks' losses identical, a
    rank's launches a step (#11 and #12 once each at mp x sep, none in
    the pipe: A9b.7b; one ``mt_adam_kernel``, two ``mt_norm_kernel``)
    and collectives (`_sep_mp_collectives`, `_sep_pipe_collectives`)
    exact; (c) the tiny fp32 GQA LLaMA with the ring card against CPU
    over the same ranks (loss 1e-4, parameters 1e-3 relative). The
    kernels line carries a rank's launches a step at mp 2 x sep 2
    (``launches_sep_mp``) and at tp 2 x pp 2 x sep 2 by stage
    (``launches_sep_hybrid``);
31. mixture-of-experts on one card: (a) a tiny fp32 MoE GPT (hidden
    64, 2 layers, 4 experts; gshard at capacity factor 1, switch at
    0.75, so tokens drop) card against CPU: 3 ``TrainStep``s through
    ``model.loss`` (AdamW, ``ClipGradForMOEByGlobalNorm``, recompute
    "dots") and 3 ``FusedScanTrainStep``s of its ``scan_layers`` twin
    at ``layer_chunk`` 1 and 2, over packed documents; every gate call
    of the first step routes alike (experts, slots, drops), losses 1e-4,
    parameters 1e-3 relative; the fp32 splash, CE and optimizer kernels
    ran, no other; (b) GPT-3 1.3B's widths with `MOE_EXPERTS` (8)
    experts a layer (gshard, capacity factor 2) at `MOE_LAYERS` (8) of
    its 24 layers (24 layers' expert stacks are 6.4 B parameters)
    through ``FusedScanTrainStep`` at phase 14's configuration, 8 x 1024
    tokens, 2 + 5 steps, then one under sync debug mode "error": step
    ms, tokens/s, ``mfu`` (each token counts its two experts' FFNs),
    peak memory, each layer's dropped share of (token, choice) pairs; a
    step's launches exactly `MOE_LAUNCHES` (16 / 8 / 1 / 1, nine
    ``mt_adam_kernel``) and the monitor's ``mt_norm_kernel``; the first
    loss within 0.5 of ln 50304 plus the weighted aux; (c) a tiny MoE
    GPT's greedy dense generation, card tokens equal to the CPU's, one
    prompt graph and one decode graph captured in the warm-up call and
    none after. The kernels line carries (b)'s launches
    (``launches_moe``).

It then prints the ``nvidia-smi`` line again and, last, ``{"ok": true,
"device": {...}}``. Imports torch, numpy and the port only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12        # dense bf16 tensor-core peak
FP32_FLOP_PER_S = 67e12         # fp32 outside the tensor cores
PHASES = 31
ROOT = os.path.dirname(os.path.abspath(__file__))
LOG = os.path.join(ROOT, "chiprun_out", "chip_smoke.log")
SHORT = 240                     # characters of a phase's line on stdout


class _Lines:
    """Where the phases' lines go: each line whole to `LOG` (under the
    git-ignored ``chiprun_out/``), and stdout one line a phase, printed
    when the next phase speaks or the run ends: the phase, the script's
    seconds at its last line, its lines in the log and the start of the
    last one (`SHORT` characters), so that a whole run's stdout stays
    within a 24 KB tail."""

    def __init__(self):
        self.log = None
        self.phase, self.lines, self.last, self.at = None, 0, "", 0.0
        self.t0 = time.perf_counter()

    def say(self, text):
        if self.log is None:
            os.makedirs(os.path.dirname(LOG), exist_ok=True)
            self.log = open(LOG, "w")
        self.log.write(text + "\n")
        self.log.flush()
        m = re.match(r"\[(\d+)/\d+\]", text)
        k = int(m.group(1)) if m else self.phase
        if k != self.phase:
            self.close()
            self.phase = k
        self.lines += 1
        self.last, self.at = text, time.perf_counter() - self.t0

    def close(self, status="ok"):
        """The open phase's stdout line (``status`` "failed" when the run
        stops in it)."""
        if self.phase is None:
            return
        body = self.last.split("] ", 1)[-1]
        line = (f"[{self.phase}/{PHASES}] {status} at {self.at:.1f} s, "
                f"{self.lines} line(s) in chiprun_out/chip_smoke.log: "
                f"{body}")
        print(line if len(line) <= SHORT else line[:SHORT - 3] + "...",
              flush=True)
        self.phase, self.lines = None, 0


_LINES = _Lines()


def say(text, **_):
    """A phase's line (``[k/PHASES] ...``): whole to the log, one short
    line a phase on stdout (`_Lines`)."""
    _LINES.say(text)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, CUDA events
    around each launch, the L2 cache flushed before each (the serving
    path reaches attention with other layers' weights in between)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def graph_ms(fns, flush=None, iters=20) -> float:
    """Device ms a call of ``fns`` (one call, or a list run back to back)
    captured in one CUDA graph (`jit.graphs.graph_of`): the device time
    without the host's time to launch it. A paged call's Python wrapper
    takes longer on the host (about 60 us) than its kernel on the card,
    so eager launches would time the host. With ``flush``, `time_ms` of
    the replays, the L2 flushed before each; without, ``iters`` replays
    back to back, as a decode step's products run (a written flush
    leaves dirty lines that a byte-bound launch writes back as it
    reads)."""
    from paddle_tpu_torch.jit.graphs import graph_of

    fns = list(fns) if isinstance(fns, (list, tuple)) else [fns]
    graph = graph_of(fns)
    if flush is not None:
        return time_ms(graph.replay, flush, iters) / len(fns)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters / len(fns)


def bound_ms(nbytes: float, flops: float, itemsize: int):
    t_bytes = nbytes / HBM_BYTES_PER_S
    peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    t_ops = flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: the kernels on warpgroup products
# ---------------------------------------------------------------------------

# JSON name -> (source, its __global__ function on hopper_tiles.cuh)
WGMMA_KERNELS = {
    "fused_ce_bwd_kernels": ("fused_cross_entropy",
                             "fused_ce_bwd_wgmma_kernel"),
    # the bf16 CE forward on the backward's mainloop
    "fused_ce_fwd_wgmma_kernel": ("fused_cross_entropy",
                                  "fused_ce_fwd_wgmma_kernel"),
    "flash_single_fwd_kernel": ("flash_attention",
                                "flash_single_fwd_wgmma_kernel"),
    "flash_fwd_wgmma_kernel": ("flash_attention", "flash_fwd_wgmma_kernel"),
    "splash_fwd_wgmma_kernel": ("splash_attention",
                                "splash_fwd_wgmma_kernel"),
    # the bf16 flash backwards (csrc/attention_wgmma_bwd.cuh), two
    # kernels each: #6's and #8's
    "flash_single_bwd_wgmma_kernels[dq]": ("flash_attention",
                                           "flash_single_dq_wgmma_kernel"),
    "flash_single_bwd_wgmma_kernels[dkdv]": (
        "flash_attention", "flash_single_dkdv_wgmma_kernel"),
    "flash_bwd_wgmma_kernels[dq]": ("flash_attention",
                                    "flash_dq_wgmma_kernel"),
    "flash_bwd_wgmma_kernels[dkdv]": ("flash_attention",
                                      "flash_dkdv_wgmma_kernel"),
    # the bf16 splash backward on the same bodies, with GQA and segment
    # ids
    "splash_bwd_wgmma_kernels[dq]": ("splash_attention",
                                     "splash_dq_wgmma_kernel"),
    "splash_bwd_wgmma_kernels[dkdv]": ("splash_attention",
                                       "splash_dkdv_wgmma_kernel"),
    # the bf16 chunk attention over bf16, int8 and int4 pools
    # (csrc/paged_wgmma.cuh)
    "paged_chunk_wgmma_kernel": ("paged_attention",
                                 "paged_chunk_wgmma_kernel"),
    # the weight-only prompt route over bf16 and fp16 x
    # (csrc/weight_only.cu)
    "wo_wgmma_kernel": ("weight_only", "wo_wgmma_kernel"),
}
# the redesigned kernels on CUDA cores (no HGMMA): the split-K decode over
# each pool kind (csrc/paged_split.cuh), which must not spill at all (its
# instantiations cover every head dim, 64 among them)
CUDA_CORE_KERNELS = {
    "paged_decode_split_kernel": ("paged_attention",
                                  "paged_decode_split_kernel"),
}
# the redesigned kernels on mma.sync (HMMA, no HGMMA): the weight-only
# decode route (csrc/weight_only.cu)
HMMA_KERNELS = {
    "wo_mma_kernel": ("weight_only", "wo_mma_kernel"),
}
# kernels that must not spill in any instantiation
NO_SPILL = ("paged_decode_split_kernel", "wo_wgmma_kernel", "wo_mma_kernel")
# the split decode's shared memory is reported at the serving path's
# geometry: head dim 64, pages of 16 rows, MHA, a full ring
DECODE_PATH_GEOMETRY = (64, 16, 1, 4)
# kernels whose head-dim-64 instantiations (the training and serving
# paths' head dim) must not spill
NO_SPILL_AT_64 = ("flash_single_dq_wgmma_kernel",
                  "flash_single_dkdv_wgmma_kernel", "flash_dq_wgmma_kernel",
                  "flash_dkdv_wgmma_kernel", "splash_dq_wgmma_kernel",
                  "splash_dkdv_wgmma_kernel", "paged_chunk_wgmma_kernel")


def _template_args(mangled):
    """The int and bool template arguments of a mangled kernel name."""
    return re.findall(r"L[ib](\d+)E", mangled)


def _short(mangled, fn):
    """``fn<args>`` from a mangled template name."""
    args = _template_args(mangled)
    return f"{fn}<{', '.join(args)}>" if args else fn


def _ptxas_functions(log):
    """{mangled name: registers, spill bytes, static shared memory} from
    an ``-Xptxas=-v`` log."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[fn].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            out[fn]["stack_frame"] = int(m[1])
        m = re.search(r"Used (\d+) registers", line)
        if m:
            sm = re.search(r"(\d+) bytes smem", line)
            out[fn].update(registers=int(m[1]),
                           static_smem=int(sm[1]) if sm else 0)
    return out


def _hgmma_counts(lib, opcode="HGMMA"):
    """{mangled name: ``opcode`` (HGMMA, HMMA) instructions} of a
    library's SASS, or None without ``cuobjdump``."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump")
    if tool is None and CUDA_HOME:
        tool = os.path.join(CUDA_HOME, "bin", "cuobjdump")
    if tool is None or not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and opcode in line:
            counts[fn] += 1
    return counts


def check_wgmma_kernels(built):
    """Registers, spills and shared memory (static from ptxas, dynamic
    from the launcher) of each redesigned kernel, and the HGMMA (HMMA for
    the mma.sync kernels) instructions of its SASS; fails if a warpgroup
    kernel has no HGMMA or an mma.sync kernel no HMMA, if a backward or
    the chunk spills at head dim 64, or if the split decode or a
    weight-only kernel spills at all."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_cross_entropy as fce
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels import splash_attention as sa
    from paddle_tpu_torch.ops.kernels import weight_only as wo

    ce = _build.load("fused_cross_entropy", fce._SIGNATURES)
    fl = _build.load("flash_attention", fa._SIGNATURES)
    sp = _build.load("splash_attention", sa._SIGNATURES)
    pg = _build.load("paged_attention", pa._SIGNATURES)
    dynamic = {"fused_ce_bwd_wgmma_kernel": lambda args: (
                   ce.fused_ce_bwd_bf16_smem()),
               "fused_ce_fwd_wgmma_kernel": lambda args: (
                   ce.fused_ce_bwd_bf16_smem()),
               "paged_decode_split_kernel": lambda args: (
                   pg.paged_decode_split_smem(int(args[0]),
                                              *DECODE_PATH_GEOMETRY)),
               "flash_single_fwd_wgmma_kernel": lambda args: (
                   fl.flash_fwd_single_bf16_smem(int(args[0]))),
               "flash_fwd_wgmma_kernel": lambda args: (
                   fl.flash_fwd_bf16_smem(int(args[0]))),
               "splash_fwd_wgmma_kernel": lambda args: (
                   sp.splash_fwd_bf16_smem(int(args[0]), int(args[1])))}
    for fn in ("flash_single_dq_wgmma_kernel", "flash_dq_wgmma_kernel"):
        dynamic[fn] = lambda args: fl.flash_bwd_dq_bf16_smem(int(args[0]))
    for fn in ("flash_single_dkdv_wgmma_kernel", "flash_dkdv_wgmma_kernel"):
        dynamic[fn] = lambda args: fl.flash_bwd_dkdv_bf16_smem(int(args[0]))
    for which, fn in enumerate(("splash_dq_wgmma_kernel",
                                "splash_dkdv_wgmma_kernel")):
        dynamic[fn] = lambda args, w=which: sp.splash_bwd_bf16_smem(
            int(args[0]), int(args[1]), w)
    dynamic["paged_chunk_wgmma_kernel"] = lambda args: (
        pg.paged_chunk_wgmma_smem(int(args[0]), int(args[1])))
    wol = wo._lib()
    # the prompt route at its token tile; the decode route at phase 17's
    # fc1 split (8 or 16 rows of x staged)
    dynamic["wo_wgmma_kernel"] = lambda args: wol.wo_wgmma_smem(int(args[0]))
    dynamic["wo_mma_kernel"] = lambda args: wol.wo_mma_smem(
        8 * int(args[0]), wo.mma_plan(8192, 2048, 132)[0])
    report = {}
    for name, (src, fn) in {**WGMMA_KERNELS, **CUDA_CORE_KERNELS,
                            **HMMA_KERNELS}.items():
        cores = name in CUDA_CORE_KERNELS
        hmma = name in HMMA_KERNELS
        saved = _build.library_path(src).with_suffix(".log")
        log = built.get(src, {}).get("log") or (
            saved.read_text() if saved.exists() else "")
        props = {k: v for k, v in _ptxas_functions(log).items() if fn in k}
        counts = _hgmma_counts(_build.library_path(src),
                               "HMMA" if hmma else "HGMMA")
        hg = None if counts is None else \
            {k: v for k, v in counts.items() if fn in k}
        entries = []
        for mangled in sorted(set(props) | set(hg or {})):
            args = _template_args(mangled)
            p = props.get(mangled, {})
            entries.append({
                "kernel": _short(mangled, fn),
                "registers": p.get("registers", "not measured"),
                "spill_stores": p.get("spill_stores", "not measured"),
                "spill_loads": p.get("spill_loads", "not measured"),
                "static_smem": p.get("static_smem", "not measured"),
                "dynamic_smem": dynamic[fn](args),
                "hmma" if hmma else "hgmma":
                    "not measured" if hg is None else hg.get(mangled, 0)})
        report[name] = entries
        say(f"[2/{PHASES}] {name} ({src}.cu): {json.dumps(entries)}",
              flush=True)
        if not entries:
            raise AssertionError(f"{name}: no {fn} in the build")
        if not cores and hg is not None and (not hg or
                                             min(hg.values()) <= 0):
            raise AssertionError(f"{name}: a {fn} has no "
                                 f"{'HMMA' if hmma else 'HGMMA'}: {hg}")
        spills = [e for e in entries if (e["spill_stores"] != 0 or (
            fn in NO_SPILL and e["spill_loads"] != 0)) and (
            fn in NO_SPILL or fn in NO_SPILL_AT_64
            and e["kernel"].startswith(f"{fn}<64"))]
        if spills:
            raise AssertionError(f"{name}: spills: {spills}")
    return report


def _mt_types(mangled):
    """``<P, M>`` of a mangled ``mt_adam_kernel`` instantiation."""
    args = mangled.split("kernelI", 1)[1].split("EEv", 1)[0]
    names = (("13__nv_bfloat16", "bf16"), ("6__half", "fp16"), ("f", "fp32"))
    out = []
    while args:
        for code, name in names:
            if args.startswith(code):
                out.append(name)
                args = args[len(code):]
                break
        else:                     # a substitution: the first argument again
            out.append(out[0])
            args = args[args.index("_") + 1:]
    return f"<{', '.join(out)}>"


def check_multi_tensor_build(built):
    """Registers, spills and stack of the optimizer's kernels (CUDA cores,
    ``csrc/multi_tensor.cu``); fails on a spill."""
    from paddle_tpu_torch.ops.kernels import _build

    saved = _build.library_path("multi_tensor").with_suffix(".log")
    log = built.get("multi_tensor", {}).get("log") or (
        saved.read_text() if saved.exists() else "")
    entries = [{"kernel": ("mt_norm_kernel" if "mt_norm" in k else
                           "mt_adam_kernel" + _mt_types(k)),
                "registers": p.get("registers", "not measured"),
                "spill_stores": p.get("spill_stores", "not measured"),
                "stack_frame": p.get("stack_frame", "not measured"),
                "static_smem": p.get("static_smem", "not measured")}
               for k, p in sorted(_ptxas_functions(log).items())
               if "mt_norm_kernel" in k or "mt_adam_kernel" in k]
    say(f"[2/{PHASES}] multi_tensor (multi_tensor.cu): "
          f"{json.dumps(entries)}", flush=True)
    if not entries or any(e["spill_stores"] != 0 for e in entries):
        raise AssertionError(f"multi_tensor: missing or spilling: {entries}")


# ---------------------------------------------------------------------------
# phase 3: paged-attention kernels against their plain versions
# ---------------------------------------------------------------------------

PAGED_SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
PAGED_TPU = "paddle_tpu/ops/pallas/paged_attention.py"
# kernel -> (wrapper, its launch counter, pool quant mode, TPU kernel line);
# the decode rows are its split-K route and the chunk rows its bf16 route
# (warpgroup products), which the serving path takes
PAGED_KERNELS = {
    "paged_decode_split_kernel": ("paged_attention", "launches_split", None,
                                  163),
    "paged_chunk_wgmma_kernel": ("paged_attention_chunk", "launches_wgmma",
                                 None, 400),
    "paged_decode_split_kernel[int8]": ("paged_attention",
                                        "launches_split_int8", "int8", 208),
    "paged_decode_split_kernel[int4]": ("paged_attention",
                                        "launches_split_int4", "int4", 208),
    "paged_chunk_wgmma_kernel[int8]": ("paged_attention_chunk",
                                       "launches_wgmma_int8", "int8", 400),
    "paged_chunk_wgmma_kernel[int4]": ("paged_attention_chunk",
                                       "launches_wgmma_int4", "int4", 400),
}
# the other route of each (the pages kernels: the decode's and the
# chunk's first design, which take what the new kernels' gates refuse,
# and fp32 chunks): the same wrapper's counter; held against the plain
# version and timed on the same bf16 inputs beside the new kernel, and
# never launched on the serving path
PAGES_ROUTE = {
    "paged_decode_split_kernel": ("paged_decode_kernel", "launches"),
    "paged_decode_split_kernel[int8]": ("paged_decode_q_kernel[int8]",
                                        "launches_int8"),
    "paged_decode_split_kernel[int4]": ("paged_decode_q_kernel[int4]",
                                        "launches_int4"),
    "paged_chunk_wgmma_kernel": ("paged_chunk_kernel", "launches"),
    "paged_chunk_wgmma_kernel[int8]": ("paged_chunk_q_kernel[int8]",
                                       "launches_int8"),
    "paged_chunk_wgmma_kernel[int4]": ("paged_chunk_q_kernel[int4]",
                                       "launches_int4"),
}
SDPA_OVER_DEQUANT = ("scaled_dot_product_attention over the bf16 K/V the "
                     "pools dequantize to (dequant not counted)")
# the chunk's warpgroup route at the card tests' other geometries, over
# bf16, int8 and int4 pools with shuffled page tables: (slots, nh, kvh,
# d, page size, pages a slot, c, starts: 0, mid-page, the table's end)
CHUNK_CASES = {
    "gqa nh16 kvh1 c5": (3, 16, 1, 64, 16, 8, 5, (0, 5, 123)),
    "gqa nh8 kvh2 c40": (3, 8, 2, 64, 16, 8, 40, (0, 5, 88)),
    "c1": (3, 4, 1, 64, 16, 8, 1, (0, 5, 127)),
    "c33": (3, 2, 2, 64, 16, 8, 33, (0, 7, 95)),
    "d128 c64": (3, 4, 2, 128, 16, 8, 64, (0, 9, 64)),
    "d32 page 8": (3, 4, 4, 32, 8, 16, 8, (0, 5, 120)),
    "d16": (3, 16, 1, 16, 16, 8, 5, (0, 5, 123)),
}


def _paged_counters():
    """(kernel, wrapper, counter) of every paged kernel and route."""
    rows = [(name, w, c) for name, (w, c, _, _) in PAGED_KERNELS.items()]
    return rows + [(PAGES_ROUTE[name][0], w, PAGES_ROUTE[name][1])
                   for name, (w, _, _, _) in PAGED_KERNELS.items()]


def _paged_reset():
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    for _, wrapper, counter in _paged_counters():
        setattr(getattr(pa, wrapper), counter, 0)


def _paged_launches():
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    return {name: getattr(getattr(pa, wrapper), counter)
            for name, wrapper, counter in _paged_counters()}


def _pools(k32, v32, quant, dtype=torch.bfloat16):
    """(k, v, scale keywords) of fp32 K/V as ``dtype`` or quantized
    pools."""
    from paddle_tpu_torch.inference.kv_cache import quantize_rows

    if quant is None:
        return k32.to(dtype), v32.to(dtype), {}
    (kq, ks), (vq, vs) = quantize_rows(k32, quant), quantize_rows(v32, quant)
    return kq, vq, {"k_scales": ks, "v_scales": vs}


def _pages_route(q, k, v, table, pos, quant, sc):
    """The decode (q ``[b, nh, d]``, ``pos`` the lengths) or the chunk
    (``pos`` the starts) through its pages route (``paged_decode(_q)`` /
    ``paged_chunk(_q)``), whatever the dtype and geometry."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    fn, extra = ("paged_decode", q.shape[:1]) if q.dim() == 3 else \
        ("paged_chunk", q.shape[:2])
    return pa._launch(fn, q, k, v, table, pos, tuple(extra),
                      1.0 / q.shape[-1] ** 0.5, sc.get("k_scales"),
                      sc.get("v_scales"), quant)[0]


def check_chunk_cases(dev):
    """The chunk's warpgroup route against the plain version at
    `CHUNK_CASES` over each pool (bf16 tolerance), each call counted on
    the route's own counter and bit-identical on a second call."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    chunk = pa.paged_attention_chunk
    for case, (b, nh, kvh, d, ps, pp, c, starts) in CHUNK_CASES.items():
        gen = torch.Generator(device=dev).manual_seed(1)
        num_pages = 1 + b * pp
        q = torch.randn(b, c, nh, d, device=dev, generator=gen).bfloat16()
        k32 = torch.randn(kvh, num_pages, ps, d, device=dev, generator=gen)
        v32 = torch.randn(kvh, num_pages, ps, d, device=dev, generator=gen)
        table = (torch.randperm(num_pages - 1, device=dev, generator=gen)
                 + 1).to(torch.int32).reshape(b, pp)
        start = torch.tensor(starts, dtype=torch.int32, device=dev)
        errs = {}
        for quant in (None, "int8", "int4"):
            k, v, sc = _pools(k32, v32, quant)
            counter = "launches_wgmma" + (f"_{quant}" if quant else "")
            n = getattr(chunk, counter)
            got = chunk(q, k, v, table, start, **sc)
            again = chunk(q, k, v, table, start, **sc)
            torch.cuda.synchronize()
            want = pa.paged_attention_chunk_ref(q, k, v, table, start, **sc)
            errs[quant or "bf16"] = err = _max_err(got, want)
            if not (getattr(chunk, counter) == n + 2 and err <= 2e-2
                    and torch.isfinite(got).all()
                    and torch.equal(got, again)):
                raise AssertionError(
                    f"chunk {case} {quant or 'bf16'} pools: err {err}, "
                    f"{getattr(chunk, counter) - n} launches of 2, or a "
                    f"second call differs")
        say(f"[3/{PHASES}] paged_chunk_wgmma_kernel {case} q "
              f"{[b, c, nh, d]} kvh {kvh} page {ps}: max abs err "
              f"{json.dumps(errs)}, bit-identical on a second call",
              flush=True)


# the decode's split route at the card tests' other geometries, fp32 q
# over fp32 pools and bf16 q over bf16, int8 and int4 pools, with
# shuffled page tables and lengths at page and split edges: (slots, nh,
# kvh, d, page size, pages a slot)
DECODE_CASES = {
    "gqa nh16 kvh4 d128": (6, 16, 4, 128, 16, 20),
    "gqa nh16 kvh2 d256": (6, 16, 2, 256, 16, 20),
    "gqa nh8 kvh1 d16 page 8": (6, 8, 1, 16, 8, 40),
    "mha nh4 d64 page 32": (6, 4, 4, 64, 32, 10),
}
DECODE_LENS = (0, 15, 128, 129, 256, 320)


def check_decode_cases(dev):
    """The decode's split route against the plain version at
    `DECODE_CASES`, each call counted on the route's own counter and
    bit-identical on a second call."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    dec = pa.paged_attention
    for case, (b, nh, kvh, d, ps, pp) in DECODE_CASES.items():
        gen = torch.Generator(device=dev).manual_seed(2)
        num_pages = 1 + b * pp
        q = torch.randn(b, nh, d, device=dev, generator=gen)
        k32 = torch.randn(kvh, num_pages, ps, d, device=dev, generator=gen)
        v32 = torch.randn(kvh, num_pages, ps, d, device=dev, generator=gen)
        table = (torch.randperm(num_pages - 1, device=dev, generator=gen)
                 + 1).to(torch.int32).reshape(b, pp)
        lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
        errs = {}
        for q_dtype, quant, tol in ((torch.float32, None, 1e-4),
                                    (torch.bfloat16, None, 2e-2),
                                    (torch.bfloat16, "int8", 2e-2),
                                    (torch.bfloat16, "int4", 2e-2)):
            k, v, sc = _pools(k32, v32, quant)
            if q_dtype == torch.float32:
                k, v = k32, v32
            counter = "launches_split" + (f"_{quant}" if quant else "")
            n = getattr(dec, counter)
            args = (q.to(q_dtype), k, v, table, lens)
            got = dec(*args, **sc)
            again = dec(*args, **sc)
            torch.cuda.synchronize()
            err = _max_err(got, pa.paged_attention_ref(*args, **sc))
            what = f"{str(q_dtype)[6:]} q, {quant or str(k.dtype)[6:]}"
            errs[what] = err
            if not (getattr(dec, counter) == n + 2 and err <= tol
                    and torch.isfinite(got).all()
                    and torch.equal(got, again)):
                raise AssertionError(
                    f"decode {case} {what}: err {err}, "
                    f"{getattr(dec, counter) - n} launches of 2, or a "
                    f"second call differs")
        say(f"[3/{PHASES}] paged_decode_split_kernel {case} lens "
              f"{list(DECODE_LENS)}: max abs err {json.dumps(errs)}, "
              f"bit-identical on a second call", flush=True)


def check_kernels(dev, flush):
    """The paged kernels (fp, and int8 / int4 pools) at the serving
    path's shapes: decode q [8, 32, 64] over pools of 513 pages of 16
    rows, lens 0..1024; one chunk-prefill call q [4, 64, 32, 64]; each
    with its pages route beside it. The kernels, the pages routes and
    SDPA are timed as CUDA-graph replays (`graph_ms`), the plain versions
    eagerly. The chunk also at `CHUNK_CASES`, the decode at
    `DECODE_CASES`."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    b, nh, kvh, d, ps, pp = 8, 32, 32, 64, 16, 64   # decode at 1.3B width
    num_pages = 1 + b * pp
    L = pp * ps
    gen = torch.Generator(device=dev).manual_seed(0)
    q32 = torch.randn(b, nh, d, device=dev, generator=gen)
    k32 = torch.randn(kvh, num_pages, ps, d, device=dev, generator=gen)
    v32 = torch.randn(kvh, num_pages, ps, d, device=dev, generator=gen)
    pt = (torch.randperm(num_pages - 1, device=dev, generator=gen) + 1) \
        .to(torch.int32).reshape(b, pp)
    lens = torch.tensor([0, 1, 17, 100, 333, 512, 777, L], dtype=torch.int32,
                        device=dev)
    cb, c = 4, 64                                   # one chunk-prefill call
    qc32 = torch.randn(cb, c, nh, d, device=dev, generator=gen)
    ptc = pt[:cb].contiguous()
    start = torch.tensor([0, 64, 300, L - c], dtype=torch.int32, device=dev)

    results = {}
    for name, (wrapper, counter, quant, _) in PAGED_KERNELS.items():
        kernel = getattr(pa, wrapper)
        plain = getattr(pa, wrapper + "_ref")
        q, table, pos = ((q32, pt, lens) if wrapper == "paged_attention"
                         else (qc32, ptc, start))
        # a key's K (or V) bytes: bf16 pools, or the quantized row and
        # its scale
        row_bytes = 2 * d if quant is None else \
            (d if quant == "int8" else d // 2) + 4
        # the kernel and its pages route (the first design, which serves
        # every geometry the gate refuses), each held to the plain version
        errs, old_errs = {}, {}
        old = PAGES_ROUTE[name][0]
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            kp, vp, sc = _pools(k32, v32, quant, dtype)
            args = (q.to(dtype), kp, vp, table, pos)
            got = kernel(*args, **sc)
            got_old = _pages_route(*args, quant, sc)
            again_old = _pages_route(*args, quant, sc)
            torch.cuda.synchronize()
            want = plain(*args, **sc)
            errs[dtype] = err = _max_err(got, want)
            old_errs[dtype] = err_old = _max_err(got_old, want)
            if not (err <= tol and torch.isfinite(got).all()):
                raise AssertionError(
                    f"{name} {dtype}: max abs err {err} > {tol}")
            if not (err_old <= tol and torch.isfinite(got_old).all()
                    and torch.equal(got_old, again_old)):
                raise AssertionError(
                    f"{old} {dtype}: max abs err {err_old} > {tol}, or a "
                    f"second call differs")
        # times at the serving path's dtype (bf16 q; bf16 or quantized
        # pools)
        kp, vp, sc = _pools(k32, v32, quant)
        args = (q.to(torch.bfloat16), kp, vp, table, pos)
        n = getattr(kernel, counter)
        got = kernel(*args, **sc)
        again = kernel(*args, **sc)
        torch.cuda.synchronize()
        if getattr(kernel, counter) != n + 2 or not torch.equal(got, again):
            raise AssertionError(f"{name}: bf16 calls not counted on "
                                 f"{wrapper}.{counter}, or a second call "
                                 f"differs")
        kd = pa._densify(kp, table, sc.get("k_scales")).to(torch.bfloat16)
        vd = pa._densify(vp, table, sc.get("v_scales")).to(torch.bfloat16)
        if q.dim() == 3:
            qs = args[0][:, :, None]                # [b, nh, 1, d]
            mask = (torch.arange(L, device=dev)[None] < pos[:, None]) \
                [:, None, None]
            keys = pos.clamp(max=L).double()
            rows_keys = keys * nh                   # one query per head
        else:
            qs = args[0].transpose(1, 2)            # [b, nh, c, d]
            ipos = pos[:, None] + torch.arange(c, device=dev)[None]
            mask = (torch.arange(L, device=dev)[None, None]
                    <= ipos[:, :, None])[:, None]
            keys = (pos + c).clamp(max=L).double()
            rows_keys = (ipos + 1).clamp(max=L).double().sum(1) * nh
        library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qs, kd, vd, attn_mask=mask)
        item = 2
        # q in and out, each visible key's K and V rows once (with their
        # scales), the page-table entries that map them, the lengths
        nbytes = float(2 * qs.numel() * item
                       + (keys.sum() * kvh * 2 * row_bytes).item()
                       + ((keys / ps).ceil().sum() * 4).item()
                       + pos.numel() * 4)
        flops = float((4 * rows_keys.sum() * d).item())
        b_ms, b_by = bound_ms(nbytes, flops, item)
        results[name] = {
            "max_abs_err": errs[torch.bfloat16],
            "max_abs_err_fp32": errs[torch.float32],
            "ms": graph_ms(lambda: kernel(*args, **sc), flush),
            "plain_ms": time_ms(lambda: plain(*args, **sc), flush),
            "library_ms": graph_ms(library, flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": list(q.shape),
        }
        r = results[name]
        if quant is not None:
            r["library"] = SDPA_OVER_DEQUANT
        line = (f"[3/{PHASES}] {name}: q {r['shape']} max abs err fp32 "
                f"{errs[torch.float32]:.3g} bf16 {errs[torch.bfloat16]:.3g}")
        # the pages route timed on the same bf16 inputs
        r["pages_route"] = old
        if wrapper == "paged_attention_chunk":
            r["fp32_route"] = old
        r["pages_route_max_abs_err"] = old_errs[torch.bfloat16]
        r["pages_route_max_abs_err_fp32"] = old_errs[torch.float32]
        r["pages_route_ms"] = graph_ms(
            lambda: _pages_route(*args, quant, sc), flush)
        line += (f" ({old} fp32 {old_errs[torch.float32]:.3g} bf16 "
                 f"{old_errs[torch.bfloat16]:.3g}, {r['pages_route_ms']:.4f}"
                 f" ms), bit-identical on a second call")
        say(f"{line}; bf16 kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
        if wrapper == "paged_attention_chunk":
            r["verify"] = _verify_row(dev, flush, name, kernel, plain, counter,
                                      kp, vp, sc, pt, quant, row_bytes)
    check_chunk_cases(dev)
    check_decode_cases(dev)
    return results


# the speculative verify's shape at GPT-3 1.3B width (k = 4: c = 5 query
# rows a slot, 8 slots) over phase 5's serving pools; its starts
VERIFY_SHAPE = (8, 5, 32, 64)
VERIFY_STARTS = (0, 1, 17, 100, 333, 512, 777, 1019)


def _verify_row(dev, flush, name, kernel, plain, counter, kp, vp, sc, pt,
                quant, row_bytes):
    """The chunk kernel at the verify shape, bf16 q over the row's pools:
    error against the plain version (bit-identical on a second call),
    graph-replay time beside the plain version's, SDPA's over the dense
    K/V and the byte bound (q in and out, each visible key's K and V rows
    once with their scales, the page-table entries, the starts)."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    b, c, nh, d = VERIFY_SHAPE
    kvh, ps, L = kp.shape[0], kp.shape[2], pt.shape[1] * kp.shape[2]
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(b, c, nh, d, device=dev, generator=gen).bfloat16()
    start = torch.tensor(VERIFY_STARTS, dtype=torch.int32, device=dev)
    args = (q, kp, vp, pt, start)
    n = getattr(kernel, counter)
    got, again = kernel(*args, **sc), kernel(*args, **sc)
    torch.cuda.synchronize()
    err = _max_err(got, plain(*args, **sc))
    if not (getattr(kernel, counter) == n + 2 and err <= 2e-2
            and torch.isfinite(got).all() and torch.equal(got, again)):
        raise AssertionError(f"{name} at the verify shape: err {err}, "
                             f"{getattr(kernel, counter) - n} launches of 2, "
                             f"or a second call differs")
    kd = pa._densify(kp, pt, sc.get("k_scales")).to(torch.bfloat16)
    vd = pa._densify(vp, pt, sc.get("v_scales")).to(torch.bfloat16)
    ipos = start[:, None] + torch.arange(c, device=dev)[None]
    mask = (torch.arange(L, device=dev)[None, None]
            <= ipos[:, :, None])[:, None]
    qs = q.transpose(1, 2)
    keys = (start + c).clamp(max=L).double()
    rows_keys = (ipos + 1).clamp(max=L).double().sum(1) * nh
    nbytes = float(2 * q.numel() * 2 + (keys.sum() * kvh * 2 * row_bytes)
                   .item() + ((keys / ps).ceil().sum() * 4).item() + b * 4)
    b_ms, b_by = bound_ms(nbytes, float((4 * rows_keys.sum() * d).item()), 2)
    row = {"shape": list(VERIFY_SHAPE), "starts": list(VERIFY_STARTS),
           "max_abs_err": err,
           "ms": graph_ms(lambda: kernel(*args, **sc), flush),
           "plain_ms": time_ms(lambda: plain(*args, **sc), flush),
           "library_ms": graph_ms(
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   qs, kd, vd, attn_mask=mask), flush),
           "bound_ms": b_ms, "bound_by": b_by}
    say(f"[3/{PHASES}] {name} at the verify shape q {row['shape']}: max "
          f"abs err {err:.3g}, bit-identical on a second call; kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa "
          f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})",
          flush=True)
    return row


# ---------------------------------------------------------------------------
# phase 4: tiny model, card vs CPU
# ---------------------------------------------------------------------------

def parity(dev):
    """The same greedy requests served through the CUDA graphs on the
    card, the eager loop on the card and the eager loop on the CPU, over
    fp32 pools and over int8 and int4 pools, at decode bursts 1 and 4;
    then sampled requests with fixed seeds, graphs against the eager
    loop on the card."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                    num_attention_heads=4, max_position_embeddings=128)
    cpu = GPTForCausalLM(cfg, device="cpu")
    rng = np.random.default_rng(0)
    sd = {name: torch.from_numpy(
              (rng.standard_normal(tuple(t.shape)) * 0.3).astype(np.float32))
          for name, t in cpu.state_dict().items()}
    cpu.load_state_dict(sd)
    card = GPTForCausalLM(cfg, device=dev)
    card.load_state_dict(sd)
    prompts = [rng.integers(1, 128, (n,)).astype(np.int32)
               for n in (5, 17, 33, 64, 9, 70)]
    budgets = [int(n) for n in rng.integers(8, 17, len(prompts))]

    def serve(where, compiled, **kw):
        eng = ServingEngine(card if where == "card" else cpu, max_slots=4,
                            max_len=128, page_size=16, chunk_size=32,
                            prefill_batch=2, compiled=compiled,
                            device=dev if where == "card" else "cpu", **kw)
        handles = [eng.submit(p, n, seed=7 + i)
                   for i, (p, n) in enumerate(zip(prompts, budgets))]
        eng.run()
        lk = eng.leak_check()
        if not (lk["free_pages"] == lk["total_pages"]
                and lk["free_slots"] == lk["total_slots"]
                and lk["resident_slot_pages"] == 0):
            raise AssertionError(f"{where} {kw} engine leaked: {lk}")
        if compiled and where == "card" and \
                eng.compile_counts()["decode_traces"] != 1:
            raise AssertionError(f"{kw}: decode captured "
                                 f"{eng.compile_counts()}")
        return [h.output_tokens for h in handles]

    for quant in (None, "int8", "int4"):
        for burst in (1, 4):
            kw = dict(kv_quant=quant, decode_burst=burst)
            tokens = {"card graph": serve("card", True, **kw),
                      "card eager": serve("card", False, **kw),
                      "cpu": serve("cpu", False, **kw)}
            if len({json.dumps(t) for t in tokens.values()}) != 1:
                raise AssertionError(
                    f"greedy tokens differ ({quant} pools, burst "
                    f"{burst}): {json.dumps(tokens)}")
            n = sum(len(t) for t in tokens["cpu"])
            say(f"[4/{PHASES}] parity: tiny fp32 GPT, {quant or 'fp32'} "
                  f"pools, burst {burst}, {len(prompts)} greedy requests, "
                  f"{n} tokens identical through the card's graphs, its "
                  f"eager loop and the CPU; no leaks", flush=True)
    kw = dict(do_sample=True, top_k=20, top_p=0.9, decode_burst=4)
    graph, eager = serve("card", True, **kw), serve("card", False, **kw)
    if graph != eager:
        raise AssertionError(f"sampled tokens differ, graphs {graph}, "
                             f"eager {eager}")
    say(f"[4/{PHASES}] parity: sampled requests (top-k 20, top-p 0.9, "
          f"burst 4, fixed seeds), {sum(len(t) for t in graph)} tokens "
          f"identical through the card's graphs and its eager loop",
          flush=True)


# ---------------------------------------------------------------------------
# phases 5-6: the serving path at GPT-3 1.3B width, bf16 then int8 / int4
# pools
# ---------------------------------------------------------------------------

def _serve_run(dev, model, kv_quant, compiled):
    """One engine over phase 5's workload: `warmup()`, then the 16
    requests with the paged counters zeroed just before and read just
    after. Prints one line; (stats, tokens, launches of the kernels of
    ``kv_quant``'s pools)."""
    from paddle_tpu_torch.serving import ServingEngine

    cfg = model.config
    t0 = time.perf_counter()
    eng = ServingEngine(model, max_slots=8, max_len=1024, page_size=16,
                        chunk_size=64, prefill_batch=4,
                        cache_dtype=torch.bfloat16, kv_quant=kv_quant,
                        compiled=compiled, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # the graphs' captures (eager: one request a bucket), then fresh
    # metrics and step counters for the measured run
    eng.warmup()
    counts = eng.compile_counts()
    eng.prefill_step.calls = eng.decode_step.calls = 0
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 769, 16)
    budgets = rng.integers(32, 129, 16)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in lens]

    # an earlier run's engine (a reference cycle) must not hold its pools
    # through this run's peak
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _paged_reset()
    t0 = time.perf_counter()
    handles = [eng.submit(p, int(n)) for p, n in zip(prompts, budgets)]
    snap = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _paged_launches()

    for h, n in zip(handles, budgets):
        toks = np.asarray(h.output_tokens)
        if not (h.done and len(toks) == n and (toks >= 0).all()
                and (toks < cfg.vocab_size).all()):
            raise AssertionError(f"request {h.request.rid}: done={h.done}, "
                                 f"{len(toks)} of {n} tokens")
    leaks = eng.leak_check()
    if leaks["free_pages"] != leaks["total_pages"] or \
            leaks["free_slots"] != leaks["total_slots"]:
        raise AssertionError(f"leaked pages or slots: {leaks}")
    if compiled and (eng.compile_counts() != counts
                     or counts["decode_traces"] != 1
                     or counts["prefill_traces"]
                     > len(counts["chunk_buckets"])):
        raise AssertionError(f"captures: {counts} after warmup(), "
                             f"{eng.compile_counts()} after the run")
    pool = eng.cache.pool_stats()
    # the kernels this run must go through, and the ones it must not
    ran = [k for k, (_, _, quant, _) in PAGED_KERNELS.items()
           if quant == kv_quant]
    calls = {"decode": eng.decode_step.calls,
             "chunk": eng.prefill_step.calls}
    stats = {
        "model": "gpt3-1.3b", "layers": cfg.num_layers,
        "hidden": cfg.hidden_size, "heads": cfg.num_attention_heads,
        "vocab": cfg.vocab_size, "dtype": "bfloat16",
        "kv_quant": kv_quant, "compiled": compiled,
        "setup_s": round(setup_s, 3),
        "warmup_ms": eng.warmup_report["warmup_ms"],
        "compile_counts": counts,
        "requests": len(handles), "finished": snap["finished"],
        "prompt_tokens": int(lens.sum()),
        "generated_tokens": snap["generated_tokens"],
        "wall_s": round(wall, 3),
        "output_tok_s": round(snap["generated_tokens"] / wall, 2),
        "ttft_p50_s": snap["ttft_p50_s"], "ttft_p99_s": snap["ttft_p99_s"],
        "itl_p50_s": snap["itl_p50_s"], "itl_p99_s": snap["itl_p99_s"],
        "decode_steps": snap["decode_steps"],
        "decode_calls": calls["decode"],
        "prefill_calls": calls["chunk"],
        "preemptions": snap["preemptions"],
        "pool_bytes": pool["pool_bytes"],
        "kv_bytes_per_token": pool["bytes_per_token"],
        "effective_slots_vs_bf16": pool["effective_slots_vs_bf16"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        # the graphs' private pools are reserved, not allocated
        "max_memory_reserved": torch.cuda.max_memory_reserved(),
        "launches": launches,
        "launches_per_call": {
            k: launches[k] / max(calls["decode" if "decode" in k
                                       else "chunk"], 1) for k in ran},
    }
    tokens = [h.output_tokens for h in handles]
    del eng, handles
    gc.collect()
    torch.cuda.empty_cache()
    if min(launches[k] for k in ran) <= 0:
        raise AssertionError(f"a kernel never ran on the path: {launches}")
    idle = {k: n for k, n in launches.items() if k not in ran and n}
    if idle:
        raise AssertionError(f"kernels of other pools ran: {idle}")
    return stats, tokens, {k: launches[k] for k in ran}


def serve_full_width(dev, model, kv_quant=None, phase=5):
    """Phase 5's workload (6's with ``kv_quant``) through the eager loop
    (``compiled=False``), then through the engine's CUDA graphs (its
    default): one line each, the graphs' last. Greedy tokens and the
    paged kernels' launches a call must be identical; no capture may
    happen after `warmup()`. Returns the graph run's (launches, stats)."""
    eager, eager_tokens, _ = _serve_run(dev, model, kv_quant, False)
    say(f"[{phase}/{PHASES}] serve gpt3-1.3b {kv_quant or 'bf16'} pools, "
          f"eager loop: {json.dumps(eager)}", flush=True)
    stats, tokens, ran = _serve_run(dev, model, kv_quant, True)
    if tokens != eager_tokens:
        raise AssertionError(f"{kv_quant or 'bf16'} pools: greedy tokens of "
                             f"the graphs and the eager loop differ")
    if stats["launches_per_call"] != eager["launches_per_call"]:
        raise AssertionError(f"launches a call differ: graphs "
                             f"{stats['launches_per_call']}, eager "
                             f"{eager['launches_per_call']}")
    stats["tokens_equal_to_eager"] = True
    stats["eager"] = {k: eager[k] for k in (
        "output_tok_s", "wall_s", "ttft_p50_s", "ttft_p99_s", "itl_p50_s",
        "itl_p99_s", "warmup_ms", "max_memory_allocated",
        "max_memory_reserved")}
    say(f"[{phase}/{PHASES}] serve gpt3-1.3b {kv_quant or 'bf16'} pools: "
          f"{json.dumps(stats)}", flush=True)
    return ran, stats


# ---------------------------------------------------------------------------
# phase 7: generate() at GPT-3 1.3B width
# ---------------------------------------------------------------------------

def generate_full_width(dev, model):
    """``generate()`` of 8 prompts of 128 tokens, 32 new tokens, over the
    paged cache with bf16 pools and with int8 pools, compiled (the
    default): one warm-up call, which captures the decode graph, then one
    call with the kernels' counters zeroed just before and read just
    after, which must capture nothing. The decode kernel of the pools
    must have run, and no splash forward: a 128-token prefill is under
    ``FLAGS_pallas_flash_min_seqlen``, so it takes the dense attention,
    as in the reference."""
    from paddle_tpu_torch.ops.kernels import splash_attention as sa

    cfg = model.config
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (8, 128))
    out = {}
    for quant, decode in ((None, "paged_decode_split_kernel"),
                          ("int8", "paged_decode_split_kernel[int8]")):
        kw = dict(use_cache="paged", cache_dtype=torch.bfloat16,
                  **({"kv_quant": quant} if quant else {}))
        model.generate(ids, 32, **kw)               # engine, warm-up
        torch.cuda.synchronize()
        eng, = [e for e in model._generation_engines.values()
                if e.kind == "paged" and e.kv_quant == quant]
        captures = eng.decode_step.trace_count
        _paged_reset()
        sa.splash_attention_fwd.launches = 0
        sa.splash_attention_fwd.launches_wgmma = 0
        t0 = time.perf_counter()
        toks = model.generate(ids, 32, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        splash = {"splash_fwd_wgmma_kernel":
                  sa.splash_attention_fwd.launches_wgmma,
                  "splash_fwd_kernel": sa.splash_attention_fwd.launches}
        launches = {**splash, **_paged_launches()}
        t = toks.numpy()
        if not (t.shape == (8, 32) and (t >= 0).all()
                and (t < cfg.vocab_size).all()):
            raise AssertionError(f"generate {quant}: bad tokens {t.shape}")
        if not (eng.compiled and captures == 1 ==
                eng.decode_step.trace_count == eng.decode_step.cache_size()):
            raise AssertionError(
                f"generate {quant}: the decode graph was captured "
                f"{captures} then {eng.decode_step.trace_count} times")
        out[quant] = t
        stats = {"kv_quant": quant, "compiled": eng.compiled,
                 "decode_graphs": eng.decode_step.cache_size(),
                 "batch": 8, "prompt": 128, "new": 32,
                 "wall_s": round(wall, 4),
                 "output_tok_s": round(t.size / wall, 2),
                 "launches": {k: n for k, n in launches.items() if n}}
        if quant is not None:
            stats["tokens_equal_to_bf16_share"] = float(
                (t == out[None]).mean())
        say(f"[7/{PHASES}] generate gpt3-1.3b paged "
              f"{quant or 'bf16'}: {json.dumps(stats)}", flush=True)
        if launches[decode] <= 0 or launches[PAGES_ROUTE[decode][0]] or \
                any(splash.values()):
            raise AssertionError(f"generate {quant}: the split decode "
                                 f"never ran, or its pages route or a "
                                 f"splash forward did: {launches}")
    model.__dict__.pop("_generation_engines", None)


# ---------------------------------------------------------------------------
# phase 3, training kernels: splash attention and the fused cross entropy
# ---------------------------------------------------------------------------

# Tolerances. Forward: fp32 max abs 1e-4 (fp32 sums in another order than
# the plain version's matmuls), bf16 2e-2 (one bf16 rounding of outputs of
# order 1: P before P.V, the output itself). Backward: the error over the
# largest magnitude of the plain gradient, fp32 1e-4 and bf16 2e-2 (dS and
# d are rounded to bf16 before their products in both versions, but from
# fp32 values that differ in their last bits).
TOL_FWD = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TOL_BWD = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# lse: fp32 sums of the same products in another order; in bf16 the
# warpgroup forwards also work in log2 units (s * scale * log2 e) and
# convert back
TOL_LSE = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
SPLASH_SOURCE = "paddle_tpu_torch/csrc/splash_attention.cu"
# splash cases: (b, s, nh, kvh, d, causal, segment ids, keywords); docs an
# int: that many documents a row at random cuts (the last row one), a
# tuple: those document lengths in every row. In fp32 and bf16:
SPLASH_CASES = {
    "splash [8,1024,32,64] causal": (8, 1024, 32, 32, 64, True, None, {}),
    "splash gqa h8 kvh2 s256 segments": (4, 256, 8, 2, 64, True, 3, {}),
}
# and in bf16, the edges of the warpgroup forward's 128-row items and
# 128-key tiles: ragged lengths, head dims padded to 64 and 128, GQA, a
# key tile fully masked for some rows (rows 300-383 see none of keys
# 0-255), and rows with no visible key at all (non-causal, sk < sq: the
# third document's 100 rows)
SPLASH_RAGGED = {
    "splash gqa h8 kvh2 s200 segments": (2, 200, 8, 2, 64, True, 3, {}),
    "splash s130 d16 causal": (1, 130, 4, 4, 16, True, None, {}),
    "splash s208 d80 full": (2, 208, 4, 4, 80, False, None, {}),
    "splash gqa s384 d128 segments": (1, 384, 4, 2, 128, True, 3, {}),
    "splash s384 masked key tiles": (1, 384, 4, 2, 64, True, (130, 170, 84),
                                     {}),
    "splash sq300 sk200 full, rows with no key": (
        1, 300, 4, 2, 64, False, (120, 80, 100), {"sk": 200}),
}
CE_SOURCE = "paddle_tpu_torch/csrc/fused_cross_entropy.cu"
# the bf16 CE backward's scratch budget for the chunked case: d chunks of
# 768 vocab rows (four over 3000, the last 696: a last dW tile of 56 rows)
# beside the [1000, 512] fp32 dh sums
CE_CHUNKED_BUDGET = 1000 * 512 * 4 + 1000 * 768 * 2


def _max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def _rel_err(got, want):
    return _max_err(got, want) / max(float(want.float().abs().max()), 1e-30)


def _check(name, dtype, fwd_err, bwd_rel, finite, lse_err=0.0, same=True):
    if not finite:
        raise AssertionError(f"{name} {dtype}: non-finite output, or lse "
                             f"finite where the plain one is not")
    if not fwd_err <= TOL_FWD[dtype]:
        raise AssertionError(f"{name} {dtype}: forward max abs err "
                             f"{fwd_err} > {TOL_FWD[dtype]}")
    if not lse_err <= TOL_LSE[dtype]:
        raise AssertionError(f"{name} {dtype}: lse max abs err {lse_err} "
                             f"> {TOL_LSE[dtype]}")
    if not bwd_rel <= TOL_BWD[dtype]:
        raise AssertionError(f"{name} {dtype}: backward rel err "
                             f"{bwd_rel} > {TOL_BWD[dtype]}")
    if not same:
        raise AssertionError(f"{name} {dtype}: two runs differ")


def _segments(b, s, docs, rng):
    """[b, s] int32 ids: ``docs`` documents a row, the last row one; or,
    with ``docs`` a tuple of lengths, those documents in every row."""
    if isinstance(docs, tuple):
        return np.tile(np.repeat(np.arange(len(docs)), docs),
                       (b, 1)).astype(np.int32)
    rows = []
    for i in range(b):
        n = 1 if i == b - 1 else docs
        cuts = np.sort(rng.choice(np.arange(1, s), n - 1, replace=False))
        rows.append(np.searchsorted(cuts, np.arange(s), side="right"))
    return np.stack(rows).astype(np.int32)


def _splash_case(dev, b, s, h, kvh, d, causal, docs, dtype, seed=0,
                 sk=None):
    """One splash case in ``dtype``, q/k/v as strided views of one packed
    tensor (as the model passes them; ``sk`` < ``s`` keeps the first
    ``sk`` key rows): errors of out, lse and the backward (from the
    kernel's out and lse) against the plain versions, finiteness (lse
    +inf exactly where the plain one is), whether a second backward is
    bit-identical, and the inputs."""
    from paddle_tpu_torch.ops.kernels import splash_attention as sa

    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, s, h + 2 * kvh, d, device=dev, generator=gen) \
        .to(dtype)
    q, k, v = qkv.split([h, kvh, kvh], dim=2)
    k, v = k[:, :sk], v[:, :sk]
    seg = None
    if docs:
        seg = torch.from_numpy(_segments(
            b, s, docs, np.random.default_rng(seed))).to(dev)
    out, lse = sa.splash_attention_fwd(q, k, v, causal, seg)
    dout = torch.randn(out.shape, device=dev, generator=gen).to(dtype)
    counter = "launches_wgmma" if dtype == torch.bfloat16 else "launches"
    n = getattr(sa.splash_attention_bwd, counter)
    grads = sa.splash_attention_bwd(q, k, v, out, lse, dout, causal, seg)
    again = sa.splash_attention_bwd(q, k, v, out, lse, dout, causal, seg)
    torch.cuda.synchronize()
    if getattr(sa.splash_attention_bwd, counter) != n + 2:
        raise AssertionError(f"splash backward {dtype}: not counted on "
                             f".{counter}")
    want, want_lse = sa.splash_attention_ref(q, k, v, causal, seg,
                                             return_lse=True)
    ref = sa.splash_attention_bwd_ref(q, k, v, out, lse, dout, causal, seg)
    fin = torch.isfinite(want_lse)
    finite = bool(torch.isfinite(out).all()) and all(
        bool(torch.isfinite(g).all()) for g in grads) and \
        torch.equal(fin, torch.isfinite(lse))
    same = all(torch.equal(a, g) for a, g in zip(again, grads))
    errs = {"out": _max_err(out, want),
            "lse": _max_err(lse[fin], want_lse[fin]) if fin.any() else 0.0,
            "bwd_abs": max(_max_err(g, r) for g, r in zip(grads, ref)),
            "bwd_rel": max(_rel_err(g, r) for g, r in zip(grads, ref)),
            "empty_rows": int((~fin).sum())}
    return errs, finite, same, (q, k, v, out, lse, dout)


def _ce_case(dev, n, vocab, hidden, dtype, seed=0, budget=None):
    """One fused-CE case in ``dtype``, 5% of labels at ignore_index and
    the last row's label in the vocab's last column: errors of the
    forward (losses; lse) and the backward (dh, dW), and whether a second
    forward and a second backward are bit-identical. ``budget``: the
    bf16 backward's scratch budget (small: several vocab chunks)."""
    from paddle_tpu_torch.ops.kernels import fused_cross_entropy as fce

    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(n, hidden, device=dev, generator=gen).to(dtype)
    w = (torch.randn(vocab, hidden, device=dev, generator=gen) * 0.02) \
        .to(dtype)
    labels = torch.randint(0, vocab, (n,), device=dev, generator=gen)
    labels[torch.rand(n, device=dev, generator=gen) < 0.05] = -100
    labels[-1] = vocab - 1
    loss, lse = fce.fused_ce_fwd(h, w, labels)
    loss2, lse2 = fce.fused_ce_fwd(h, w, labels)
    g = torch.where(labels != -100, torch.full_like(loss, 1.0 / n), 0.0)
    saved = fce.SCRATCH_BYTES
    fce.SCRATCH_BYTES = budget or saved
    try:
        dh, dw = fce.fused_ce_bwd(h, w, labels, lse, g)
        again = fce.fused_ce_bwd(h, w, labels, lse, g)
        torch.cuda.synchronize()
    finally:
        fce.SCRATCH_BYTES = saved
    want, want_lse = fce.fused_ce_fwd_ref(h, w, labels)
    rdh, rdw = fce.fused_ce_bwd_ref(h, w, labels, lse, g)
    finite = all(bool(torch.isfinite(t).all()) for t in (loss, lse, dh, dw))
    same = torch.equal(again[0], dh) and torch.equal(again[1], dw) and \
        torch.equal(loss2, loss) and torch.equal(lse2, lse)
    fwd_err, lse_err = _max_err(loss, want), _max_err(lse, want_lse)
    bwd_abs = max(_max_err(dh, rdh), _max_err(dw, rdw))
    bwd_rel = max(_rel_err(dh, rdh), _rel_err(dw, rdw))
    return fwd_err, lse_err, bwd_abs, bwd_rel, finite, same, \
        (h, w, labels, lse, g)


def _time_ce(flush, h, w, labels, lse, g):
    """bf16 times of the CE forward and backward kernels on ``_ce_case``'s
    inputs, beside the plain version, ``F.linear`` + ``F.cross_entropy``
    (forward; forward + backward minus forward) and the bound."""
    from paddle_tpu_torch.ops.kernels import fused_cross_entropy as fce
    F = torch.nn.functional

    (n, hidden), vocab = h.shape, w.shape[0]
    hl, wl = h.clone().requires_grad_(), w.clone().requires_grad_()
    lib = lambda: F.cross_entropy(  # noqa: E731
        F.linear(hl, wl).float(), labels, ignore_index=-100,
        reduction="none")
    lib_fb = lambda: torch.autograd.grad(lib(), (hl, wl), g)  # noqa: E731
    nvh = 2.0 * n * vocab * hidden
    hw = (n + vocab) * hidden * 2
    lib_f = time_ms(lib, flush, iters=10)
    out = {}
    for name, kernel, plain, nbytes, flops, lib_ms in (
            ("fused_ce_fwd_wgmma_kernel",
             lambda: fce.fused_ce_fwd(h, w, labels),
             lambda: fce.fused_ce_fwd_ref(h, w, labels),
             hw + n * 4 + 2 * n * 4, nvh, lambda: lib_f),
            ("fused_ce_bwd_kernels",
             lambda: fce.fused_ce_bwd(h, w, labels, lse, g),
             lambda: fce.fused_ce_bwd_ref(h, w, labels, lse, g),
             2 * hw + 3 * n * 4, 3 * nvh,
             lambda: time_ms(lib_fb, flush, iters=10) - lib_f)):
        b_ms, b_by = bound_ms(nbytes, flops, 2)
        out[name] = {"ms": time_ms(kernel, flush, iters=10),
                     "plain_ms": time_ms(plain, flush, iters=3, warmup=1),
                     "library_ms": lib_ms(), "bound_ms": b_ms,
                     "bound_by": b_by, "shape": [n, hidden, vocab]}
    return out


def check_training_kernels(dev, flush):
    """Splash at the training shape ([8, 1024, 32, 64] causal) and at a
    GQA + segments case; the fused CE at the training shape (8192 tokens,
    hidden 2048, vocab 50304) and at a ragged one (300 x 1000): fp32 and
    bf16 against the plain versions; then bf16 times at the training
    shapes."""
    from paddle_tpu_torch.ops.kernels import fused_cross_entropy as fce
    from paddle_tpu_torch.ops.kernels import splash_attention as sa
    F = torch.nn.functional

    b, s, nh, d = 8, 1024, 32, 64
    n, vocab, hidden = 8192, 50304, 2048
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        cases = dict(SPLASH_CASES)
        if dtype == torch.bfloat16:
            cases.update(SPLASH_RAGGED)
        for case, args in cases.items():
            e, fin, same, _ = _splash_case(dev, *args[:7], dtype,
                                           **args[7])
            _check(case, dtype, e["out"], e["bwd_rel"], fin, e["lse"], same)
            errs[(case, dtype)] = (max(e["out"], e["lse"]), e["bwd_abs"],
                                   e["bwd_rel"])
            say(f"[3/{PHASES}] {case} {str(dtype)[6:]}: out max abs err "
                  f"{e['out']:.3g}, lse {e['lse']:.3g} ({e['empty_rows']} "
                  f"rows with no visible key: out 0, lse +inf); backward "
                  f"max abs err {e['bwd_abs']:.3g}, relative "
                  f"{e['bwd_rel']:.3g}, bit-identical on a second run",
                  flush=True)
        for case, args in {"fused_ce [8192,2048]x[50304,2048]":
                           (n, vocab, hidden),
                           "fused_ce ragged [300,256]x[1000,256]":
                           (300, 1000, 256),
                           "fused_ce [1000,512]x[3000,512] in 4 chunks":
                           (1000, 3000, 512, 0, CE_CHUNKED_BUDGET)}.items():
            fe, le, ba, br, fin, same, _ = _ce_case(dev, *args[:3], dtype,
                                                    *args[3:])
            _check(case, dtype, fe, br, fin, le, same=same)
            errs[(case, dtype)] = (max(fe, le), ba, br)
            say(f"[3/{PHASES}] {case} {str(dtype)[6:]}: forward max abs "
                  f"err {fe:.3g}, lse {le:.3g}; backward max abs err "
                  f"{ba:.3g}, relative {br:.3g}; forward and backward "
                  f"bit-identical on a second run", flush=True)
        torch.cuda.empty_cache()

    # times at the training path's dtype (bf16)
    bf = torch.bfloat16
    results = {}
    *_, (q, k, v, out, lse, dout) = _splash_case(dev, b, s, nh, nh, d,
                                                 True, None, bf)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = dout.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    sdpa_fb = lambda: torch.autograd.grad(  # noqa: E731
        sdpa(), (qt, kt, vt), dot)
    pairs = s * (s + 1) / 2                          # causal (row, key)
    prod = 2.0 * b * nh * pairs * d                  # one product
    tok = b * s * nh * d * 2                         # one [b,s,h,d] tensor
    lse_b = b * nh * s * 4
    lib_f = time_ms(sdpa, flush)
    for name, kernel, plain, nbytes, flops, lib in (
            ("splash_fwd_wgmma_kernel",
             lambda: sa.splash_attention_fwd(q, k, v, True),
             lambda: sa.splash_attention_ref(q, k, v, True,
                                             return_lse=True),
             4 * tok + lse_b, 2 * prod, lambda: lib_f),
            ("splash_bwd_wgmma_kernels",
             lambda: sa.splash_attention_bwd(q, k, v, out, lse, dout, True),
             lambda: sa.splash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                 True),
             8 * tok + lse_b, 5 * prod,
             lambda: time_ms(sdpa_fb, flush) - lib_f)):
        b_ms, b_by = bound_ms(nbytes, flops, 2)
        results[name] = {"ms": time_ms(kernel, flush),
                         "plain_ms": time_ms(plain, flush, iters=5),
                         "library_ms": lib(), "bound_ms": b_ms,
                         "bound_by": b_by, "shape": [b, s, nh, d]}
    del q, k, v, out, lse, dout, qt, kt, vt, dot
    torch.cuda.empty_cache()

    *_, (h, w, labels, lse, g) = _ce_case(dev, n, vocab, hidden, bf)
    results.update(_time_ce(flush, h, w, labels, lse, g))
    # the forward's first design (the fp32 route's kernel, in bf16) on
    # the same inputs
    lbl32 = labels.to(torch.int32)

    def first_design():
        out = (torch.empty(n, device=dev), torch.empty(n, device=dev))
        fce._fwd_tiles(h, w, lbl32, -100, *out)
        return out

    r = results["fused_ce_fwd_wgmma_kernel"]
    r["fp32_route"] = r["old_route"] = "fused_ce_fwd_kernel"
    (loss, lse1), again = first_design(), first_design()
    want, want_lse = fce.fused_ce_fwd_ref(h, w, labels)
    _check("fused_ce_fwd_kernel", bf, _max_err(loss, want), 0.0,
           bool(torch.isfinite(loss).all() and torch.isfinite(lse1).all()),
           _max_err(lse1, want_lse),
           torch.equal(loss, again[0]) and torch.equal(lse1, again[1]))
    r["old_route_max_abs_err"] = max(_max_err(loss, want),
                                     _max_err(lse1, want_lse))
    r["old_route_ms"] = time_ms(first_design, flush, iters=5)
    del loss, lse1, again, want, want_lse
    del h, w, labels, lse, g, lbl32
    torch.cuda.empty_cache()

    case_of = {"splash_fwd_wgmma_kernel": ("splash [8,1024,32,64] causal",
                                           0),
               "splash_bwd_wgmma_kernels": ("splash [8,1024,32,64] causal",
                                            1),
               "fused_ce_fwd_wgmma_kernel": (
                   "fused_ce [8192,2048]x[50304,2048]", 0),
               "fused_ce_bwd_kernels": ("fused_ce [8192,2048]x[50304,2048]",
                                        1)}
    for name, r in results.items():
        case, which = case_of[name]
        r["max_abs_err"] = errs[(case, torch.bfloat16)][which]
        r["max_abs_err_fp32"] = errs[(case, torch.float32)][which]
        if name == "splash_fwd_wgmma_kernel":
            r["fp32_route"] = "splash_fwd_kernel"
        if name == "splash_bwd_wgmma_kernels":
            r["fp32_route"] = "splash_bwd_kernels"
        if which:
            r["max_rel_err"] = errs[(case, torch.bfloat16)][2]
            r["max_rel_err_fp32"] = errs[(case, torch.float32)][2]
        old = "" if "old_route" not in r else (
            f", {r['old_route']} {r['old_route_ms']:.4f} ms (max abs err "
            f"{r['old_route_max_abs_err']:.3g})")
        say(f"[3/{PHASES}] {name}: bf16 kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}){old}",
              flush=True)
    return results


# ---------------------------------------------------------------------------
# phase 3, flash kernels: the single-block and the tiled pair
# ---------------------------------------------------------------------------

FLASH_SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
FLASH_TPU = "paddle_tpu/ops/pallas/flash_attention.py"
# entry -> TPU kernel line; the path's shapes (causal): the single-block
# pair at the 1024-token run's, the tiled pair at the 2048-token run's
FLASH_LINES = {"flash_single_fwd_kernel": 125,
               "flash_single_bwd_wgmma_kernels": 139,
               "flash_fwd_wgmma_kernel": 201, "flash_bwd_wgmma_kernels": 291}
# the fp32 routes of the entries whose bf16 route is on warpgroup products
FP32_ROUTES = {
    "flash_fwd_wgmma_kernel": "flash_fwd_kernel",
    "flash_single_bwd_wgmma_kernels": "flash_single_dq_kernel + "
                                      "flash_single_dkdv_kernel",
    "flash_bwd_wgmma_kernels": "flash_delta_kernel + flash_dkdv_kernel + "
                               "flash_dq_kernel"}
FLASH_SHAPES = {"single": (8, 1024, 32, 64), "tiled": (4, 2048, 32, 64)}
# the ring's off-diagonal tick on the tiled pair: the second half of the
# rows against the first half of the keys (a full block), from the global
# lse and out of both halves
RING_TICK = {"flash_fwd_wgmma_kernel[ring tick]": "flash_fwd_wgmma_kernel",
             "flash_bwd_wgmma_kernels[outside lse]": "flash_bwd_wgmma_kernels"}


# the single-block pair at ragged shapes: s not a multiple of the bf16
# kernels' 128-row (or the backward's 64-row) tiles, d padded to 64 or
# 128, causal and not; the backward too where its route takes d (fp32:
# up to 64)
FLASH_SINGLE_RAGGED = [((2, 80, 4, 16), False), ((2, 80, 4, 16), True),
                       ((2, 16, 2, 32), True), ((2, 208, 3, 80), False),
                       ((2, 200, 3, 48), True), ((1, 1008, 4, 128), True)]
# the tiled pair at ragged shapes (the bf16 forward's 128-row items and
# 128-key tiles, head dims padded to 64 and 128): forward and the backward
# from its out and lse
FLASH_TILED_RAGGED = [((1, 130, 2, 32), False), ((2, 208, 3, 80), True),
                      ((1, 256, 2, 128), True)]


def _qkv(dev, shape, dtype, seed=0):
    """q, k, v as strided views of one [b, s, 3, h, d] tensor (as the
    model passes them) and a contiguous dout."""
    b, s, h, d = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, s, 3, h, d, device=dev, generator=gen).to(dtype)
    dout = torch.randn(b, s, h, d, device=dev, generator=gen).to(dtype)
    return (*qkv.unbind(2), dout)


def _flash_case(dev, path, dtype, shape=None, causal=True):
    """One flash pair in ``dtype`` at its path's shape (or ``shape``):
    errors of the forward (out; lse on the tiled path) and the backward,
    finiteness, whether a second backward is bit-identical, and the
    inputs."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    q, k, v, dout = _qkv(dev, shape or FLASH_SHAPES[path], dtype)
    lse_err = 0.0
    if path == "single":
        out, lse = fa.flash_attention_fwd_single(q, k, v, causal), None
        grads = fa.flash_attention_bwd_single(q, k, v, dout, causal)
        again = fa.flash_attention_bwd_single(q, k, v, dout, causal)
        torch.cuda.synchronize()
        fwd_err = _max_err(out, fa.flash_attention_single_ref(q, k, v,
                                                              causal))
        ref = fa.flash_attention_single_bwd_ref(q, k, v, dout, causal)
    else:
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        grads = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal)
        again = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal)
        torch.cuda.synchronize()
        want, want_lse = fa.flash_attention_ref(q, k, v, causal,
                                                return_lse=True)
        fwd_err, lse_err = _max_err(out, want), _max_err(lse, want_lse)
        ref = fa.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal)
    finite = all(bool(torch.isfinite(t).all()) for t in (out, *grads)) and \
        (lse is None or bool(torch.isfinite(lse).all()))
    same = all(torch.equal(a, g) for a, g in zip(again, grads))
    errs = {"out": fwd_err, "lse": lse_err,
            "bwd_abs": max(_max_err(g, r) for g, r in zip(grads, ref)),
            "bwd_rel": max(_rel_err(g, r) for g, r in zip(grads, ref))}
    return errs, finite, same, (q, k, v, out, lse, dout)


def _ring_tick_case(dev, dtype):
    """The outside-lse contract: the last 1024 rows of the tiled shape
    against each key half (full, then causal), merged into the global out
    and lse, and each half's backward from them. Kernel against plain per
    half, and the halves' sum against the plain whole."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    q, k, v, dout = _qkv(dev, FLASH_SHAPES["tiled"], dtype, seed=1)
    h2 = q.shape[1] // 2
    q2, do2 = q[:, h2:], dout[:, h2:]
    halves = ((k[:, :h2], v[:, :h2], False), (k[:, h2:], v[:, h2:], True))
    fwd = [fa.flash_attention_fwd(q2, kk, vv, c) for kk, vv, c in halves]
    torch.cuda.synchronize()
    fwd_err = lse_err = 0.0
    for (o, l), (kk, vv, c) in zip(fwd, halves):
        w, wl = fa.flash_attention_ref(q2, kk, vv, c, return_lse=True)
        fwd_err = max(fwd_err, _max_err(o, w))
        lse_err = max(lse_err, _max_err(l, wl))
    (oa, la), (ob, lb) = fwd
    lse = torch.logaddexp(la, lb)
    out = (oa.float() * torch.exp(la - lse).transpose(1, 2)[..., None]
           + ob.float() * torch.exp(lb - lse).transpose(1, 2)[..., None]) \
        .to(dtype)
    grads = [fa.flash_attention_bwd(q2, kk, vv, out, lse, do2, c)
             for kk, vv, c in halves]
    again = [fa.flash_attention_bwd(q2, kk, vv, out, lse, do2, c)
             for kk, vv, c in halves]
    torch.cuda.synchronize()
    same = all(torch.equal(a, g) for gs, ags in zip(grads, again)
               for a, g in zip(ags, gs))
    refs = [fa.flash_attention_bwd_ref(q2, kk, vv, out, lse, do2, c)
            for kk, vv, c in halves]
    bwd_abs = max(_max_err(g, r) for gs, rs in zip(grads, refs)
                  for g, r in zip(gs, rs))
    bwd_rel = max(_rel_err(g, r) for gs, rs in zip(grads, refs)
                  for g, r in zip(gs, rs))
    # the merged halves against the whole causal attention's last rows
    wout, wlse = fa.flash_attention_ref(q, k, v, True, return_lse=True)
    wdq = fa.flash_attention_bwd_ref(q, k, v, wout, wlse, dout, True)[0]
    merge_err = max(_max_err(out, wout[:, h2:]),
                    _rel_err(grads[0][0].float() + grads[1][0].float(),
                             wdq[:, h2:]))
    finite = all(bool(torch.isfinite(t).all())
                 for t in (out, lse, *grads[0], *grads[1]))
    block = (q2, *halves[0][:2], out, lse, do2)
    errs = {"out": fwd_err, "lse": lse_err, "bwd_abs": bwd_abs,
            "bwd_rel": bwd_rel, "merge": merge_err}
    return errs, finite, same, block


def check_flash_kernels(dev, flush):
    """#5/#6 at [8, 1024, 32, 64] and #7/#8 at [4, 2048, 32, 64], causal,
    fp32 and bf16 against the plain versions, with a second backward
    compared bit for bit; the ring tick from an outside lse; #5 at the
    ragged shapes; then bf16 times beside the plain versions and SDPA."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    F = torch.nn.functional

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for path, (fwd_name, bwd_name) in (
                ("single", ("flash_single_fwd_kernel",
                            "flash_single_bwd_wgmma_kernels")),
                ("tiled", ("flash_fwd_wgmma_kernel",
                           "flash_bwd_wgmma_kernels"))):
            e, fin, same, _ = _flash_case(dev, path, dtype)
            _check(f"flash {path}", dtype, e["out"], e["bwd_rel"], fin,
                   e["lse"], same)
            errs[(fwd_name, dtype)] = (max(e["out"], e["lse"]),)
            errs[(bwd_name, dtype)] = (e["bwd_abs"], e["bwd_rel"])
            say(f"[3/{PHASES}] flash {path} {list(FLASH_SHAPES[path])} "
                  f"causal {str(dtype)[6:]}: out max abs err {e['out']:.3g}"
                  f", lse {e['lse']:.3g}; backward max abs err "
                  f"{e['bwd_abs']:.3g}, relative {e['bwd_rel']:.3g}, "
                  f"bit-identical on a second run", flush=True)
            torch.cuda.empty_cache()
        e, fin, same, _ = _ring_tick_case(dev, dtype)
        _check("flash ring tick", dtype, e["out"], e["bwd_rel"], fin,
               e["lse"], same)
        if not e["merge"] <= TOL_BWD[dtype]:
            raise AssertionError(f"flash ring tick {dtype}: halves merged "
                                 f"off the whole by {e['merge']}")
        errs[("flash_fwd_wgmma_kernel[ring tick]", dtype)] = (
            max(e["out"], e["lse"]),)
        errs[("flash_bwd_wgmma_kernels[outside lse]", dtype)] = (
            e["bwd_abs"], e["bwd_rel"])
        say(f"[3/{PHASES}] flash ring tick (rows 1024-2047 over two key "
              f"halves, outside lse) {str(dtype)[6:]}: out max abs err "
              f"{e['out']:.3g}, lse {e['lse']:.3g}; backward max abs err "
              f"{e['bwd_abs']:.3g}, relative {e['bwd_rel']:.3g}, "
              f"bit-identical on a second run; merged halves vs whole "
              f"{e['merge']:.3g}", flush=True)
        torch.cuda.empty_cache()

    for shape, causal in FLASH_TILED_RAGGED:
        e, fin, same, _ = _flash_case(dev, "tiled", torch.bfloat16, shape,
                                      causal)
        _check(f"flash tiled {shape} causal {causal}", torch.bfloat16,
               e["out"], e["bwd_rel"], fin, e["lse"], same)
        say(f"[3/{PHASES}] flash tiled {list(shape)} "
              f"{'causal' if causal else 'full'} bfloat16: out max abs err "
              f"{e['out']:.3g}, lse {e['lse']:.3g}; backward relative "
              f"{e['bwd_rel']:.3g}, bit-identical on a second run",
              flush=True)

    for shape, causal in FLASH_SINGLE_RAGGED:
        said = []
        for dtype in (torch.float32, torch.bfloat16):
            if dtype == torch.float32 and shape[3] > 64:
                # the fp32 backward takes d <= 64: the forward alone
                q, k, v, _ = _qkv(dev, shape, dtype, seed=2)
                out = fa.flash_attention_fwd_single(q, k, v, causal)
                torch.cuda.synchronize()
                err = _max_err(out, fa.flash_attention_single_ref(
                    q, k, v, causal))
                _check(f"flash single {shape} causal {causal}", dtype, err,
                       0.0, bool(torch.isfinite(out).all()))
                said.append(f"{str(dtype)[6:]} out {err:.3g}")
                continue
            e, fin, same, _ = _flash_case(dev, "single", dtype, shape,
                                          causal)
            _check(f"flash single {shape} causal {causal}", dtype,
                   e["out"], e["bwd_rel"], fin, 0.0, same)
            said.append(f"{str(dtype)[6:]} out {e['out']:.3g}, backward "
                        f"relative {e['bwd_rel']:.3g} (bit-identical twice)")
        say(f"[3/{PHASES}] flash single {list(shape)} "
              f"{'causal' if causal else 'full'}: max abs err "
              f"{'; '.join(said)}", flush=True)

    bf = torch.bfloat16
    results = {}
    for path, pair in (("single", ("flash_single_fwd_kernel",
                                   "flash_single_bwd_wgmma_kernels")),
                       ("tiled", ("flash_fwd_wgmma_kernel",
                                  "flash_bwd_wgmma_kernels")),
                       ("tick", tuple(RING_TICK))):
        if path == "tick":
            *_, (q, k, v, out, lse, dout) = _ring_tick_case(dev, bf)
            causal, b, s, h, d = False, *q.shape
            pairs = float(s * s)
        else:
            *_, (q, k, v, out, lse, dout) = _flash_case(dev, path, bf)
            causal, (b, s, h, d) = True, q.shape
            pairs = s * (s + 1) / 2
        if path == "single":
            fwd = lambda: fa.flash_attention_fwd_single(q, k, v)  # noqa: E731
            fwd_plain = lambda: fa.flash_attention_single_ref(  # noqa: E731
                q, k, v)
            bwd = lambda: fa.flash_attention_bwd_single(  # noqa: E731
                q, k, v, dout)
            bwd_plain = lambda: fa.flash_attention_single_bwd_ref(  # noqa: E731
                q, k, v, dout)
        else:
            fwd = lambda: fa.flash_attention_fwd(q, k, v, causal)  # noqa: E731
            fwd_plain = lambda: fa.flash_attention_ref(  # noqa: E731
                q, k, v, causal, return_lse=True)
            bwd = lambda: fa.flash_attention_bwd(  # noqa: E731
                q, k, v, out, lse, dout, causal)
            bwd_plain = lambda: fa.flash_attention_bwd_ref(  # noqa: E731
                q, k, v, out, lse, dout, causal)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        dot = dout.transpose(1, 2).contiguous()
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal)
        sdpa_fb = lambda: torch.autograd.grad(  # noqa: E731
            sdpa(), (qt, kt, vt), dot)
        prod = 2.0 * b * h * pairs * d               # one product
        tok = b * s * h * d * 2                      # one [b,s,h,d] tensor
        lse_b = 0 if path == "single" else b * h * s * 4
        lib_f = time_ms(sdpa, flush)
        # the outside-lse backward has no PyTorch call of the same function
        lib_b = None if path == "tick" else time_ms(sdpa_fb, flush) - lib_f
        io_b = 7 * tok if path == "single" else 8 * tok + lse_b
        for name, kernel, plain, nbytes, flops, lib in (
                (pair[0], fwd, fwd_plain, 4 * tok + lse_b, 2 * prod, lib_f),
                (pair[1], bwd, bwd_plain, io_b, 5 * prod, lib_b)):
            b_ms, b_by = bound_ms(nbytes, flops, 2)
            results[name] = {"ms": time_ms(kernel, flush),
                             "plain_ms": time_ms(plain, flush, iters=5),
                             "library_ms": lib, "bound_ms": b_ms,
                             "bound_by": b_by, "shape": [b, s, h, d],
                             "causal": causal}
        del q, k, v, out, lse, dout, qt, kt, vt, dot
        torch.cuda.empty_cache()

    for name, r in results.items():
        e32, e16 = errs[(name, torch.float32)], errs[(name, bf)]
        r["max_abs_err"], r["max_abs_err_fp32"] = e16[0], e32[0]
        if name.split("[")[0] in FP32_ROUTES:
            r["fp32_route"] = FP32_ROUTES[name.split("[")[0]]
        if len(e16) > 1:
            r["max_rel_err"], r["max_rel_err_fp32"] = e16[1], e32[1]
        lib = "null" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        say(f"[3/{PHASES}] {name}: bf16 kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    return results


# kernel -> (wrapper module, wrapper, its launch counter); the splash and
# tiled flash forwards and both flash backwards count their bf16 route
# (warpgroup products) apart from their fp32 one
TRAIN_COUNTERS = {
    "splash_fwd_wgmma_kernel": ("splash_attention", "splash_attention_fwd",
                                "launches_wgmma"),
    "splash_fwd_kernel": ("splash_attention", "splash_attention_fwd",
                          "launches"),
    "splash_bwd_wgmma_kernels": ("splash_attention", "splash_attention_bwd",
                                 "launches_wgmma"),
    "splash_bwd_kernels": ("splash_attention", "splash_attention_bwd",
                           "launches"),
    "fused_ce_fwd_wgmma_kernel": ("fused_cross_entropy", "fused_ce_fwd",
                                  "launches_wgmma"),
    "fused_ce_fwd_kernel": ("fused_cross_entropy", "fused_ce_fwd",
                            "launches"),
    "fused_ce_bwd_kernels": ("fused_cross_entropy", "fused_ce_bwd",
                             "launches"),
    "flash_single_fwd_kernel": ("flash_attention",
                                "flash_attention_fwd_single", "launches"),
    "flash_single_bwd_wgmma_kernels": ("flash_attention",
                                       "flash_attention_bwd_single",
                                       "launches_wgmma"),
    "flash_single_bwd_kernels": ("flash_attention",
                                 "flash_attention_bwd_single", "launches"),
    "flash_fwd_wgmma_kernel": ("flash_attention", "flash_attention_fwd",
                               "launches_wgmma"),
    "flash_fwd_kernel": ("flash_attention", "flash_attention_fwd",
                         "launches"),
    "flash_bwd_wgmma_kernels": ("flash_attention", "flash_attention_bwd",
                                "launches_wgmma"),
    "flash_bwd_kernels": ("flash_attention", "flash_attention_bwd",
                          "launches"),
    # the optimizer: the clip's norm and the fused AdamW update
    "mt_norm_kernel": ("multi_tensor", "multi_tensor_norm", "launches"),
    "mt_adam_kernel": ("multi_tensor", "multi_tensor_adam", "launches"),
}
# the CE's forward (bf16 on warpgroup products, fp32 the tiles) and
# backward
CE_KERNELS = ("fused_ce_fwd_wgmma_kernel", "fused_ce_fwd_kernel",
              "fused_ce_bwd_kernels")
# the optimizer's kernels (AdamW with the global-norm clip: every run)
OPT_KERNELS = ("mt_norm_kernel", "mt_adam_kernel")


def _path_kernels(seq, splash, bf16=True):
    """The training kernels a step at ``seq`` tokens launches: splash with
    the flag on, else the flash pair of the length's path; the CE (in
    bf16 the forwards of splash, of the tiled pair and of the CE, and
    both flash backwards, on warpgroup products); and the optimizer's
    norm and fused update."""
    if splash:
        attn = ("splash_fwd_wgmma_kernel", "splash_bwd_wgmma_kernels") \
            if bf16 else ("splash_fwd_kernel", "splash_bwd_kernels")
    elif seq <= 1024:
        attn = ("flash_single_fwd_kernel",
                "flash_single_bwd_wgmma_kernels" if bf16
                else "flash_single_bwd_kernels")
    else:
        attn = ("flash_fwd_wgmma_kernel" if bf16 else "flash_fwd_kernel",
                "flash_bwd_wgmma_kernels" if bf16 else "flash_bwd_kernels")
    ce = ("fused_ce_fwd_wgmma_kernel" if bf16 else "fused_ce_fwd_kernel",
          "fused_ce_bwd_kernels")
    return attn + ce + OPT_KERNELS


def _check_launches(launches, expect, what):
    never = [k for k in expect if launches[k] <= 0]
    if never:
        raise AssertionError(f"{what}: kernels of the path never ran: "
                             f"{never} ({launches})")
    stray = {k: n for k, n in launches.items() if k not in expect and n}
    if stray:
        raise AssertionError(f"{what}: kernels off the path ran: {stray}")


@contextlib.contextmanager
def routing_flags(**values):
    """Flags (``FLAGS_<name>``) set through the port's registry."""
    from paddle_tpu_torch import get_flags, set_flags

    names = [f"FLAGS_{n}" for n in values]
    saved = get_flags(names)
    set_flags(dict(zip(names, values.values())))
    try:
        yield
    finally:
        set_flags(saved)


class _TrainCounters:
    """The training kernels' launch counters: ``zero()``, ``read()``."""

    def __init__(self):
        import importlib

        self.at = {name: (getattr(importlib.import_module(
                       f"paddle_tpu_torch.ops.kernels.{mod}"), fn), attr)
                   for name, (mod, fn, attr) in TRAIN_COUNTERS.items()}

    def zero(self):
        for fn, attr in self.at.values():
            setattr(fn, attr, 0)

    def read(self):
        return {name: getattr(fn, attr) for name, (fn, attr)
                in self.at.items()}


# ---------------------------------------------------------------------------
# phase 3, the optimizer's multi-tensor kernels
# ---------------------------------------------------------------------------

MT_SOURCE = "paddle_tpu_torch/csrc/multi_tensor.cu"
# kernel -> the reference code it replaces (XLA, not Pallas: the fused
# update jits `_build_fused_fn`; the norm is the clip's)
MT_REPLACES = {
    "mt_norm_kernel": "paddle_tpu/nn/clip.py:50",
    "mt_adam_kernel": "paddle_tpu/optimizer/__init__.py:161 (XLA)",
}
# the configurations the training path uses: (parameter dtype, masters,
# moment dtype, amsgrad); phase 9's first, timed; phase 14's last
MT_CONFIGS = {
    "bf16 params, fp32 masters, bf16 moments":
        (torch.bfloat16, True, torch.bfloat16, False),
    "fp32 params and moments, amsgrad":
        (torch.float32, False, torch.float32, True),
    "fp32 params (own masters), bf16 moments, one call a layer":
        (torch.float32, False, torch.bfloat16, False),
}
# the configurations updated as `FusedScanTrainStep` does: one call a
# layer's tensors with ``bump=False``, then one over the rest that raises
# the step counter
MT_PER_LAYER = ("fp32 params (own masters), bf16 moments, one call a "
                "layer",)
# odd sizes: one element, numel not a multiple of the 8-element vector or
# of the 2048-element chunk; then more tensors than one launch's table
MT_ODD = (1, 7, 2049, 3 * 2048 + 5)
# fp32 values within 4 fp32 ulps of the plain version, bf16 ones within
# 1 bf16 ulp (one IEEE operation at a time in both; powf and the
# bias-corrected step may differ in the last place); the norm within 1e-6
# relative (fp64 block sums against fp32 tree sums)
MT_ULPS = {torch.float32: 4, torch.bfloat16: 1}


def _ulps(got, want):
    """max |got - want| in units of the last place of ``want`` in its
    dtype (fp32 or bf16)."""
    mant = 23 if want.dtype == torch.float32 else 7
    tiny = 2.0 ** -149 if want.dtype == torch.float32 else 2.0 ** -133
    w = want.double()
    e = torch.floor(torch.log2(w.abs().clamp(min=tiny)))
    return float(((got.double() - w).abs()
                  / torch.exp2(e - mant).clamp(min=tiny)).max())


def _mt_state(dev, shapes, config, seed):
    """Random optimizer state of one configuration, from ``seed``: the
    wrapper's keyword lists."""
    pdtype, master, mdtype, amsgrad = config
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(shape, dtype, scale, positive=False):
        x = torch.randn(shape, device=dev, generator=gen)
        x = (x.abs_() if positive else x).mul_(scale)
        return x.to(dtype)

    params = [rnd(s, pdtype, 0.02) for s in shapes]
    return {"params": params,
            "grads": [rnd(s, pdtype, 1.0) for s in shapes],
            "masters": [p.float() if master else None for p in params],
            "exp_avgs": [rnd(s, mdtype, 1e-3) for s in shapes],
            "exp_avg_sqs": [rnd(s, mdtype, 1e-6, True) for s in shapes],
            "max_exp_avg_sqs": [rnd(s, mdtype, 2e-6, True) for s in shapes]
            if amsgrad else None}


def _mt_keywords(dev, n, found=False, scaled=False):
    """The update's scalars and per-tensor lists: a group of every fifth
    tensor at half the lr and no decay, an L2 term on every seventh, the
    second tensor outside the clip."""
    return dict(
        lr=1e-4, beta1=0.9, beta2=0.95, eps=1e-8,
        step=torch.full((), 9, dtype=torch.int32, device=dev),
        lr_scales=[0.5 if i % 5 == 4 else 1.0 for i in range(n)],
        wds=[0.0 if i % 5 == 4 else 0.1 for i in range(n)],
        l2s=[0.01 if i % 7 == 6 else 0.0 for i in range(n)],
        need_clip=[i != 1 for i in range(n)],
        found_inf=torch.full((), found, device=dev),
        inv_scale=torch.full((), 1 / 1024.0, device=dev) if scaled
        else None)


def _mt_state_errs(got, want):
    """({list: worst ulps}, the largest absolute error of a value
    updated: masters, and parameters without one); raises past
    `MT_ULPS`."""
    worst, abs_err = {}, 0.0
    for key, ts in got.items():
        if key == "grads":
            continue
        for i, (a, b) in enumerate(zip(ts or (), want[key] or ())):
            if a is None:
                continue
            u = _ulps(a, b)
            worst[key] = max(worst.get(key, 0.0), u)
            if not u <= MT_ULPS[a.dtype]:
                raise AssertionError(f"mt_adam_kernel: {key} {u} ulps from "
                                     f"the plain version")
            if key == "masters" or (key == "params"
                                    and got["masters"][i] is None):
                abs_err = max(abs_err, _max_err(a, b))
    return worst, abs_err


def _mt_same(a, b):
    return all(x is None or torch.equal(x, y)
               for key in a for x, y in zip(a[key] or (), b[key] or ()))


def _mt_update(fn, st, kw, clip_scale, groups=None):
    """One step's update by ``fn`` (the wrapper or its plain version):
    one call over the list, or one call a group of ``groups`` (index
    lists) with ``bump=False`` and the last with ``bump=True``."""
    if groups is None:
        return fn(**st, **kw, clip_scale=clip_scale)
    per = ("lr_scales", "wds", "l2s", "need_clip")
    for j, idx in enumerate(groups):
        fn(**{k: None if v is None else [v[i] for i in idx]
              for k, v in st.items()},
           **{k: [v[i] for i in idx] if k in per else v
              for k, v in kw.items()},
           clip_scale=clip_scale, bump=j == len(groups) - 1)


def _mt_case(dev, shapes, config, scaled, seed, groups=None):
    """One configuration over ``shapes``: the norm against its plain
    version, the update (fed the kernel's clip scale; ``groups``: in
    calls as `_mt_update` makes them) twice (bit for bit) and against its
    plain version, and a set found_inf, which must leave every byte.
    Returns (the first run's state, its keywords, its norm stats, the
    errors)."""
    from paddle_tpu_torch.ops.kernels import multi_tensor as mt

    n = len(shapes)
    runs = []
    for _ in range(2):
        st = _mt_state(dev, shapes, config, seed)
        kw = _mt_keywords(dev, n, scaled=scaled)
        stats, found = mt.multi_tensor_norm(
            st["grads"], kw["need_clip"], kw["inv_scale"], clip_norm=1.0)
        _mt_update(mt.multi_tensor_adam, st, kw, stats[1], groups)
        runs.append((st, kw, stats, found))
    (st, kw, stats, found), (st2, kw2, stats2, _) = runs
    torch.cuda.synchronize()
    if not (_mt_same(st, st2) and torch.equal(stats, stats2)):
        raise AssertionError("multi-tensor kernels differ on a second call")
    del runs, st2, kw2, stats2
    torch.cuda.empty_cache()
    ref = _mt_state(dev, shapes, config, seed)
    kw_ref = _mt_keywords(dev, n, scaled=scaled)
    want, want_found = mt.multi_tensor_norm_ref(
        ref["grads"], kw_ref["need_clip"], kw_ref["inv_scale"],
        clip_norm=1.0)
    norm_rel = abs(float(stats[0]) - float(want[0])) / float(want[0])
    norm_abs = abs(float(stats[0].sqrt()) - float(want[0].sqrt()))
    if not norm_rel <= 1e-6 or bool(found) or bool(want_found):
        raise AssertionError(f"mt_norm_kernel: sum of squares {norm_rel} "
                             f"rel off the plain version, found "
                             f"{bool(found)}")
    _mt_update(mt.multi_tensor_adam_ref, ref, kw_ref, stats[1], groups)
    errs, abs_err = _mt_state_errs(st, ref)
    if int(kw["step"]) != 10 or int(kw_ref["step"]) != 10:
        raise AssertionError("the step counter was not raised once")
    del ref
    torch.cuda.empty_cache()
    # the gate: a set found_inf writes nothing, the counter included
    snap = {k: None if v is None else [None if t is None else t.clone()
                                       for t in v] for k, v in st.items()}
    kw_bad = _mt_keywords(dev, n, found=True, scaled=scaled)
    _mt_update(mt.multi_tensor_adam, st, kw_bad, stats[1], groups)
    torch.cuda.synchronize()
    if not _mt_same(st, snap) or int(kw_bad["step"]) != 9:
        raise AssertionError("mt_adam_kernel wrote under found_inf")
    del snap
    torch.cuda.empty_cache()
    return st, kw, stats, {"norm_rel_err": norm_rel,
                           "norm_abs_err": norm_abs, "ulps": errs,
                           "max_abs_err": abs_err}


def _mt_bytes(shapes, config):
    """The update's bytes a step: g, the value updated (master or
    parameter), the moments read once and written once, the parameter
    written."""
    pdtype, master, mdtype, amsgrad = config
    pb = 2 if pdtype != torch.float32 else 4
    mb = 2 if mdtype != torch.float32 else 4
    per = pb + (8 + pb if master else 2 * pb) + 2 * mb * (3 if amsgrad
                                                          else 2)
    return float(sum(int(np.prod(s)) for s in shapes) * per)


def check_optimizer_kernels(dev, flush):
    """Kernels (a) `multi_tensor_norm` and (b) `multi_tensor_adam` against
    their plain versions: on the GPT-3 1.3B parameter list (its 292
    shapes, random state) in the configurations of `MT_CONFIGS`, with
    a group's lr and decay, L2 terms and a parameter outside the clip;
    on TinyLlama-1.1B's list (201 shapes) in phase 16's configuration;
    then at odd sizes and more tensors than one table in both (with the
    loss-scale unscale). Each bit-identical on a second call; a set
    found_inf leaves every byte. Timed as CUDA-graph replays (phase 9's
    configuration) beside the bound, the plain version and
    ``torch._fused_adamw_`` over fp32 lists of the same shapes (for the
    norm: ``vector_norm`` over ``_foreach_norm``)."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_config
    from paddle_tpu_torch.ops.kernels import multi_tensor as mt

    model = GPTForCausalLM(gpt_config("gpt3-1.3b"), device=dev,
                           dtype=torch.bfloat16, seed=0)
    shapes = [tuple(p.shape) for p in model.parameters()]
    # the fused-scan step's calls: each layer's tensors, then the rest
    layer_of = [int(n.split(".")[2]) if n.startswith("gpt.blocks.")
                else None for n, _ in model.named_parameters()]
    per_layer = [[i for i, l in enumerate(layer_of) if l == layer]
                 for layer in sorted({l for l in layer_of if l is not None})]
    per_layer.append([i for i, l in enumerate(layer_of) if l is None])
    del model
    torch.cuda.empty_cache()
    numel = sum(int(np.prod(s)) for s in shapes)
    results, report = {}, {}
    for i, (name, config) in enumerate(MT_CONFIGS.items()):
        groups = per_layer if name in MT_PER_LAYER else None
        before = mt.multi_tensor_adam.launches
        st, kw, stats, errs = _mt_case(dev, shapes, config, False, seed=i,
                                       groups=groups)
        report[name] = errs
        per_call = (mt.multi_tensor_adam.launches - before) / 3
        say(f"[3/{PHASES}] multi-tensor, gpt3-1.3b list ({len(shapes)} "
              f"tensors, {numel} params), {name}: {json.dumps(errs)}; "
              f"{per_call:g} update launches a step; bit-identical twice; "
              f"found_inf leaves every byte; the step counter raised once "
              f"a step", flush=True)
        if groups is not None and per_call != len(groups):
            raise AssertionError(f"{name}: {per_call} update launches a "
                                 f"step, expected {len(groups)}")
        if i:
            del st, kw, stats
            torch.cuda.empty_cache()
            continue
        # times at phase 9's configuration, on this state
        need, grads = kw["need_clip"], st["grads"]
        kw["found_inf"] = None

        def norm():
            return mt.multi_tensor_norm(grads, need, clip_norm=1.0)

        def update():
            mt.multi_tensor_adam(**st, **kw, clip_scale=stats[1])

        def plain_norm():
            return mt.multi_tensor_norm_ref(grads, need, clip_norm=1.0)

        def plain_update():
            mt.multi_tensor_adam_ref(**st, **kw, clip_scale=stats[1])

        t = {"norm": graph_ms(norm, flush), "update": graph_ms(update, flush),
             "plain_norm": time_ms(plain_norm, flush, iters=3, warmup=1),
             "plain_update": time_ms(plain_update, flush, iters=3,
                                     warmup=1)}
        lib_norm = lambda: torch.linalg.vector_norm(  # noqa: E731
            torch.stack(torch._foreach_norm(grads, 2)).float())
        t["library_norm"] = graph_ms(lib_norm, flush)
        del st, kw, grads, stats
        torch.cuda.empty_cache()
        # the yardstick: torch._fused_adamw_ over fp32 lists
        gen = torch.Generator(device=dev).manual_seed(7)
        lists = [[torch.randn(s, device=dev, generator=gen) for s in shapes]
                 for _ in range(4)]
        lists[3] = [x.abs_() for x in lists[3]]
        steps = [torch.full((), 9.0, device=dev) for _ in shapes]
        fused = lambda: torch._fused_adamw_(  # noqa: E731
            lists[0], lists[1], lists[2], lists[3], [], steps, lr=1e-4,
            beta1=0.9, beta2=0.95, weight_decay=0.1, eps=1e-8,
            amsgrad=False, maximize=False)
        t["library_update"] = graph_ms(fused, flush)
        del lists, steps
        torch.cuda.empty_cache()
        n_bytes = float(numel * 2)
        u_bytes = _mt_bytes(shapes, config)
        for kernel, ms, plain, lib, nbytes, flops, library in (
                ("mt_norm_kernel", t["norm"], t["plain_norm"],
                 t["library_norm"], n_bytes, 2.0 * numel,
                 "torch.linalg.vector_norm over torch._foreach_norm"),
                ("mt_adam_kernel", t["update"], t["plain_update"],
                 t["library_update"], u_bytes, 20.0 * numel,
                 "torch._fused_adamw_ over fp32 lists")):
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = flops / FP32_FLOP_PER_S
            results[kernel] = {
                "ms": ms, "plain_ms": plain, "library_ms": lib,
                "library": library,
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "shape": [len(shapes), numel], "config": name}
        results["mt_norm_kernel"]["max_abs_err"] = errs["norm_abs_err"]
        results["mt_adam_kernel"]["max_abs_err"] = errs["max_abs_err"]
        for kernel, r in results.items():
            say(f"[3/{PHASES}] {kernel}: {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} "
                  f"ms ({r['library']}), bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})", flush=True)
    # TinyLlama-1.1B's list in phase 16's configuration: bf16 weights
    # under O2 (the RMSNorm weights too), fp32 masters, bf16 moments, an
    # untied [32000, 2048] head; one call over the list
    from paddle_tpu_torch.models import llama_config

    llama_shapes = _llama_shapes(llama_config("tinyllama-1.1b"))
    name = "tinyllama-1.1b list, bf16 params, fp32 masters, bf16 moments"
    before = mt.multi_tensor_adam.launches
    st, kw, stats, errs = _mt_case(
        dev, llama_shapes, MT_CONFIGS["bf16 params, fp32 masters, bf16 "
                                      "moments"], False, seed=5)
    report[name] = errs
    per_call = (mt.multi_tensor_adam.launches - before) / 3
    say(f"[3/{PHASES}] multi-tensor, {name} ({len(llama_shapes)} "
          f"tensors, {sum(int(np.prod(s)) for s in llama_shapes)} params): "
          f"{json.dumps(errs)}; {per_call:g} update launches a step; "
          f"bit-identical twice; found_inf leaves every byte", flush=True)
    if per_call != 1:
        raise AssertionError(f"{name}: {per_call} update launches a step")
    del st, kw, stats
    torch.cuda.empty_cache()
    # odd sizes and more tensors than one launch's table, loss-scaled
    sizes = list(MT_ODD) + [int(x) for x in np.random.default_rng(0)
                            .integers(1, 5000, mt.MAX_TENSORS + 40)]
    for i, (name, config) in enumerate(MT_CONFIGS.items()):
        before = mt.multi_tensor_adam.launches
        st, kw, stats, errs = _mt_case(dev, [(s,) for s in sizes], config,
                                       True, seed=10 + i)
        report[f"odd sizes, {name}"] = errs
        per_call = (mt.multi_tensor_adam.launches - before) / 3
        say(f"[3/{PHASES}] multi-tensor, {len(sizes)} tensors of "
              f"{list(MT_ODD)} and 1-4999 elements, {name}, unscaled by "
              f"1/1024: {json.dumps(errs)}; {per_call:g} update launches "
              f"a call", flush=True)
        if per_call != -(-len(sizes) // mt.MAX_TENSORS):
            raise AssertionError("the update's table did not split")
        del st, kw, stats
        torch.cuda.empty_cache()
    # the errors of the line: the worst over every case
    worst_rel = max(r["norm_rel_err"] for r in report.values())
    worst_ulps = max(max(r["ulps"].values()) for r in report.values())
    results["mt_norm_kernel"]["max_rel_err"] = worst_rel
    results["mt_adam_kernel"]["max_ulps"] = worst_ulps
    return results


# ---------------------------------------------------------------------------
# phase 8: tiny model training, card vs CPU
# ---------------------------------------------------------------------------

def train_parity(dev, splash=True, seq=128):
    """Three ``TrainStep``s of a tiny fp32 GPT on the card and on the CPU
    under the current ``FLAGS_splash_attn``: with splash, over packed
    sequences (segment ids); with flash (no segment ids: the flag off
    sends them to dense attention), at ``seq`` tokens, which picks the
    single-block or the tiled pair. The kernels of the path must run,
    no other training kernel."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                    num_attention_heads=4, max_position_embeddings=seq)
    rng = np.random.default_rng(0)
    cpu = GPTForCausalLM(cfg, device="cpu")
    sd = {name: torch.from_numpy(
              (rng.standard_normal(tuple(t.shape)) * 0.3).astype(np.float32))
          for name, t in cpu.state_dict().items()}
    ids = rng.integers(0, 128, (2, seq))
    labels = rng.integers(0, 128, (2, seq))
    seg = _segments(2, seq, 3, rng) if splash else None
    counters = _TrainCounters()
    counters.zero()
    losses, params = {}, {}
    for where in ("card", "cpu"):
        d = dev if where == "card" else torch.device("cpu")
        model = GPTForCausalLM(cfg, device=d)
        model.load_state_dict(sd)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
        step = TrainStep(model, lambda m, x, y, s: m.loss(
            x, y, segment_ids=s), opt)
        batch = [torch.from_numpy(a).to(d) for a in (ids, labels)] + \
            [None if seg is None else torch.from_numpy(seg).to(d)]
        losses[where] = [float(step(*batch)) for _ in range(3)]
        params[where] = {k: t.detach().cpu() for k, t in
                         model.state_dict().items()}
    launches = counters.read()
    loss_err = max(abs(a - b) for a, b in zip(losses["card"],
                                              losses["cpu"]))
    param_rel = max(_rel_err(params["card"][k], params["cpu"][k])
                    for k in params["cpu"])
    what = "splash, with segments" if splash else f"flash, seq {seq}"
    say(f"[8/{PHASES}] train parity ({what}): tiny fp32 GPT, 3 "
          f"TrainSteps; losses card {losses['card']} cpu {losses['cpu']} "
          f"(max |diff| {loss_err:.3g}); params max rel diff "
          f"{param_rel:.3g}; kernel launches "
          f"{ {k: n for k, n in launches.items() if n} }", flush=True)
    if not loss_err <= 1e-4:
        raise AssertionError(f"card/CPU losses differ by {loss_err}")
    if not param_rel <= 1e-3:
        raise AssertionError(f"card/CPU params differ by {param_rel} rel")
    _check_launches(launches, _path_kernels(seq, splash, bf16=False),
                    "train parity")


def train_guarded_parity(dev):
    """The guarded step: a tiny fp32 GPT takes four ``TrainStep``s with a
    ``GradScaler`` and ``guard_nonfinite`` (AdamW, global-norm clip), the
    second over a loss multiplied by inf (every grad non-finite), on the
    card and on the CPU. The skipped step must leave parameters, masters,
    moments and the step count bit-identical on both, and the scale
    halve; losses, scales and parameters must agree. Every step after
    the first (which makes the state and the optimizer's tables) runs
    under ``torch.cuda.set_sync_debug_mode("error")``, so a host sync
    inside the step fails the phase."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    seq = 128
    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                    num_attention_heads=4, max_position_embeddings=seq)
    rng = np.random.default_rng(1)
    cpu = GPTForCausalLM(cfg, device="cpu")
    sd = {name: torch.from_numpy(
              (rng.standard_normal(tuple(t.shape)) * 0.3).astype(np.float32))
          for name, t in cpu.state_dict().items()}
    ids = rng.integers(0, 128, (2, seq))
    labels = rng.integers(0, 128, (2, seq))
    ks = (1.0, float("inf"), 1.0, 1.0)
    out = {}
    for where in ("card", "cpu"):
        d = dev if where == "card" else torch.device("cpu")
        model = GPTForCausalLM(cfg, device=d)
        model.load_state_dict(sd)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
        scaler = GradScaler(init_loss_scaling=1024.0, incr_every_n_steps=2)
        step = TrainStep(model, lambda m, x, y, k: m.loss(x, y) * k, opt,
                         scaler=scaler, guard_nonfinite=True)
        batch = [torch.from_numpy(a).to(d) for a in (ids, labels)]
        mults = [torch.full((), k, device=d) for k in ks]
        losses = [step(*batch, mults[0])]
        if where == "card":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            before = [t.clone() for t in opt._state()]
            losses.append(step(*batch, mults[1]))
            after = [t.clone() for t in opt._state()]
            for k in mults[2:]:
                losses.append(step(*batch, k))
        finally:
            if where == "card":
                torch.cuda.set_sync_debug_mode(0)
        skipped_same = len(after) == len(before) and all(
            torch.equal(a, b) for a, b in zip(after, before))
        out[where] = {
            "losses": [float(x) for x in losses],
            "skip_bit_identical": bool(skipped_same),
            "step_count": opt._step_count,
            "scale": scaler.get_loss_scaling(),
            "skipped": int(step.guard.skipped),
            "params": {k: t.detach().cpu() for k, t in
                       model.state_dict().items()}}
    card, cpu_ = out["card"], out["cpu"]
    loss_err = max(abs(a - b) for a, b in zip(card["losses"], cpu_["losses"])
                   if np.isfinite(b))
    param_rel = max(_rel_err(card["params"][k], cpu_["params"][k])
                    for k in cpu_["params"])
    say(f"[8/{PHASES}] train guarded (GradScaler + guard_nonfinite, an "
          f"inf loss at step 2; steps 2-4 under sync debug mode 'error'): "
          f"losses card {card['losses']} cpu {cpu_['losses']}; skip "
          f"bit-identical card {card['skip_bit_identical']} cpu "
          f"{cpu_['skip_bit_identical']}; step count {card['step_count']} /"
          f" {cpu_['step_count']}; scale {card['scale']} / {cpu_['scale']};"
          f" params max rel diff {param_rel:.3g}", flush=True)
    for r in (card, cpu_):
        if not (r["skip_bit_identical"] and r["step_count"] == 3
                and r["skipped"] == 1 and r["scale"] == 1024.0
                and np.isinf(r["losses"][1])):
            raise AssertionError(f"guarded step: {r}")
    if not (loss_err <= 1e-4 and param_rel <= 1e-3):
        raise AssertionError(f"guarded step: card/CPU losses differ by "
                             f"{loss_err}, params by {param_rel} rel")


# ---------------------------------------------------------------------------
# phases 9-10: the training path at GPT-3 1.3B width
# ---------------------------------------------------------------------------

OPT_LAUNCHES = 2


def _optimizer_step_alone(model, opt, ids, labels, tries=3):
    """One more step's grads, then ``opt.step()`` alone under
    ``torch.profiler``: the device kernels it launched, in order, and
    their device time (the step's grads are dropped after). The port's
    counters say how many launches the step made; a trace that holds
    fewer of the port's kernels lost records (CUPTI's: in 8 runs phase 9
    once recorded no kernel and phase 10 once only ``mt_adam_kernel``,
    both counters stepped), and the step is taken again, at most
    ``tries`` times."""
    from paddle_tpu_torch.ops.kernels import multi_tensor as mt

    wrappers = (mt.multi_tensor_norm, mt.multi_tensor_adam)
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, tries + 1):
        model.loss(ids, labels).backward()
        torch.cuda.synchronize()
        before = [w.launches for w in wrappers]
        with torch.profiler.profile(activities=acts) as prof:
            opt.step()
            torch.cuda.synchronize()
        opt.clear_grad()
        launched = sum(w.launches - b for w, b in zip(wrappers, before))
        kernels = sorted((ev for ev in prof.events()
                          if ev.device_type == torch.autograd.DeviceType.CUDA
                          and "memcpy" not in ev.name.lower()
                          and "memset" not in ev.name.lower()),
                         key=lambda ev: ev.time_range.start)
        names = [("mt_norm_kernel" if "mt_norm_kernel" in ev.name else
                  "mt_adam_kernel" if "mt_adam_kernel" in ev.name
                  else ev.name) for ev in kernels]
        if sum(n in OPT_KERNELS for n in names) >= launched:
            break
    us = sum(ev.time_range.elapsed_us() for ev in kernels)
    return {"kernels": names, "device_ms": us / 1e3, "launched": launched,
            "attempts": attempt}


def train_full_width(dev, warmup=2, timed=5, batch=8, seq=1024,
                     splash=True, phase=9):
    """``TrainStep`` + AdamW at GPT-3 1.3B width over ``batch`` x ``seq``
    random tokens, under the current ``FLAGS_splash_attn`` (``splash``
    says which it is). The training kernels' counters are zeroed just
    before the timed steps and read just after: the path's kernels must
    have run, no other training kernel."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_config
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    cfg = gpt_config("gpt3-1.3b", use_recompute=True,
                     max_position_embeddings=seq)
    before = torch.cuda.memory_allocated()     # what earlier phases hold
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=True, moment_dtype="bfloat16",
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(model, lambda m, x, y: m.loss(x, y), opt)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (batch, seq))).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (batch, seq))).to(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses = [float(step(ids, labels)) for _ in range(warmup)]

    counters = _TrainCounters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters.zero()
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = counters.read()
    peak = torch.cuda.max_memory_allocated()
    # the same steps without the numerics monitor: its cost
    step_off = TrainStep(model, lambda m, x, y: m.loss(x, y), opt,
                         numerics=False)
    off_losses = [float(step_off(ids, labels))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times_off = []
    for _ in range(timed):
        t0 = time.perf_counter()
        loss = step_off(ids, labels)
        torch.cuda.synchronize()
        times_off.append(time.perf_counter() - t0)
        off_losses.append(float(loss))
    opt_step = _optimizer_step_alone(model, opt, ids, labels)

    params = sum(p.numel() for p in model.parameters())
    tokens = batch * seq
    pairs = seq * (seq + 1) / 2
    # forward + backward attention products (2 + 4), causal pairs only
    attn = 6 * 2.0 * batch * pairs * cfg.hidden_size * cfg.num_layers
    step_s = statistics.median(times)
    ran = _path_kernels(seq, splash)
    stats = {
        "model": "gpt3-1.3b", "layers": cfg.num_layers,
        "hidden": cfg.hidden_size, "heads": cfg.num_attention_heads,
        "vocab": cfg.vocab_size, "seq": seq, "batch": batch,
        "attention": "splash" if splash else "flash",
        "FLAGS_splash_attn": splash,
        "params": params, "dtype": "bfloat16 (fp32 masters, bf16 moments)",
        "recompute": True, "setup_s": round(setup_s, 3),
        "losses": losses, "step_ms": [t * 1e3 for t in times],
        "step_ms_median": step_s * 1e3,
        "tokens_per_s": tokens / step_s,
        "mfu": (6.0 * params * tokens + attn) / step_s / BF16_FLOP_PER_S,
        "max_memory_allocated": peak,
        "memory_allocated_before": before,
        "numerics": "on",
        "numerics_off": {
            "losses": off_losses,
            "step_ms": [t * 1e3 for t in times_off],
            "step_ms_median": statistics.median(times_off) * 1e3,
            "tokens_per_s": tokens / statistics.median(times_off),
            "max_memory_allocated": torch.cuda.max_memory_allocated()},
        "numerics_cost": step_s / statistics.median(times_off) - 1.0,
        "launches": {k: n for k, n in launches.items() if n},
        "launches_per_step": {k: launches[k] / timed for k in ran},
        "optimizer_launches_per_step": sum(
            launches[k] for k in OPT_KERNELS) / timed,
        "optimizer_step_alone": opt_step,
    }
    say(f"[{phase}/{PHASES}] train gpt3-1.3b {stats['attention']} seq "
          f"{seq}: {json.dumps(stats)}", flush=True)
    if not all(np.isfinite(losses + off_losses)):
        raise AssertionError(f"non-finite loss: {losses} {off_losses}")
    _check_launches(launches, ran, f"train seq {seq}")
    # one norm and one update launch (one dtype group: every parameter
    # bf16), whatever the parameter count
    if stats["optimizer_launches_per_step"] != OPT_LAUNCHES:
        raise AssertionError(f"optimizer launches a step: "
                             f"{stats['optimizer_launches_per_step']}")
    if (opt_step["kernels"] != list(OPT_KERNELS)
            or opt_step["launched"] != OPT_LAUNCHES):
        raise AssertionError(f"opt.step() launched {opt_step['kernels']} "
                             f"({opt_step['launched']} counted)")
    del model, opt, step, step_off
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches[k] for k in ran}, timed


# ---------------------------------------------------------------------------
# phases 13-14: fused-scan training (scan_layers GPT, FusedScanTrainStep)
# ---------------------------------------------------------------------------

def _scan_gpt(dev, sd, cfg):
    from paddle_tpu_torch.models import GPTForCausalLM

    model = GPTForCausalLM(cfg, device=dev)
    model.load_state_dict(sd)
    return model


def fused_scan_parity(dev):
    """Three ``FusedScanTrainStep``s of a tiny fp32 ``scan_layers`` GPT
    (AdamW, global-norm clip, fused head, packed segment ids) on the card
    and on the CPU, at ``layer_chunk`` 1 and 3; then a guarded run
    (``GradScaler`` + ``guard_nonfinite``) whose second of four steps
    meets an inf in the embedding row of a batch token (put back after
    the step), steps 2-4 under ``torch.cuda.set_sync_debug_mode
    ("error")``. The step count must rise once a step (skipped steps
    aside), the skip leave every byte of the optimizer's state, and the
    path's kernels run, no other training kernel. Then phase 14's
    configuration at this size, card against CPU
    (`fused_scan_bf16_parity`), and both steps past the numerics
    monitor's queue under sync debug mode "error"
    (`monitor_past_its_ring`)."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.jit import FusedScanTrainStep
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    seq = 128
    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=3,
                    num_attention_heads=4, max_position_embeddings=seq,
                    scan_layers=True)
    rng = np.random.default_rng(2)
    cpu = GPTForCausalLM(cfg, device="cpu")
    sd = {name: torch.from_numpy(
              (rng.standard_normal(tuple(t.shape)) * 0.3).astype(np.float32))
          for name, t in cpu.state_dict().items()}
    ids = rng.integers(0, 128, (2, seq))
    labels = rng.integers(0, 128, (2, seq))
    seg = _segments(2, seq, 3, rng)
    counters = _TrainCounters()
    counters.zero()
    out = {}
    for chunk in (1, 3):
        for where in ("card", "cpu"):
            d = dev if where == "card" else torch.device("cpu")
            model = _scan_gpt(d, sd, cfg)
            opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                        grad_clip=ClipGradByGlobalNorm(1.0))
            step = FusedScanTrainStep(model, opt, fused_head=True,
                                      layer_chunk=chunk)
            batch = [torch.from_numpy(a).to(d) for a in (ids, labels, seg)]
            out[chunk, where] = {
                "losses": [float(step(*batch)) for _ in range(3)],
                "step_count": opt._step_count,
                "params": {k: t.detach().cpu() for k, t in
                           model.state_dict().items()}}
    launches = counters.read()
    errs = {}
    for chunk in (1, 3):
        card, cpu_ = out[chunk, "card"], out[chunk, "cpu"]
        errs[chunk] = (
            max(abs(a - b) for a, b in zip(card["losses"], cpu_["losses"])),
            max(_rel_err(card["params"][k], cpu_["params"][k])
                for k in cpu_["params"]))
    say(f"[13/{PHASES}] fused-scan parity: tiny fp32 scan GPT, 3 "
          f"FusedScanTrainSteps (clip, fused head, segments); losses "
          + "; ".join(f"layer_chunk {c}: card {out[c, 'card']['losses']} "
                      f"cpu {out[c, 'cpu']['losses']} (max |diff| "
                      f"{errs[c][0]:.3g}, params max rel diff "
                      f"{errs[c][1]:.3g})" for c in (1, 3))
          + f"; step counts { {f'{c}/{w}': r['step_count'] for (c, w), r in out.items()} }"
          f"; kernel launches { {k: n for k, n in launches.items() if n} }",
          flush=True)
    for c, (loss_err, param_rel) in errs.items():
        if not (loss_err <= 1e-4 and param_rel <= 1e-3):
            raise AssertionError(f"fused scan, layer_chunk {c}: card/CPU "
                                 f"losses differ by {loss_err}, params by "
                                 f"{param_rel} rel")
    if any(r["step_count"] != 3 for r in out.values()):
        raise AssertionError("the step count did not rise once a step")
    _check_launches(launches, _path_kernels(seq, True, bf16=False),
                    "fused-scan parity")

    # the guarded run
    res = {}
    for where in ("card", "cpu"):
        d = dev if where == "card" else torch.device("cpu")
        model = _scan_gpt(d, sd, cfg)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
        scaler = GradScaler(init_loss_scaling=1024.0, incr_every_n_steps=2)
        step = FusedScanTrainStep(model, opt, fused_head=True,
                                  scaler=scaler, guard_nonfinite=True)
        batch = [torch.from_numpy(a).to(d) for a in (ids, labels, seg)]
        wte = model.gpt.wte.weight.detach()
        row = int(ids[0, 0])
        losses = [step(*batch)]
        if where == "card":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            before = [t.clone() for t in opt._state()]
            kept = wte[row].clone()
            wte[row] = float("inf")
            losses.append(step(*batch))
            wte[row] = kept
            after = [t.clone() for t in opt._state()]
            for _ in range(2):
                losses.append(step(*batch))
        finally:
            if where == "card":
                torch.cuda.set_sync_debug_mode(0)
        res[where] = {
            "losses": [float(x) for x in losses],
            "skip_bit_identical": len(after) == len(before) and all(
                torch.equal(a, b) for a, b in zip(after, before)),
            "step_count": opt._step_count,
            "scale": scaler.get_loss_scaling(),
            "skipped": int(step._guard.skipped),
            "params": {k: t.detach().cpu() for k, t in
                       model.state_dict().items()}}
    card, cpu_ = res["card"], res["cpu"]
    loss_err = max(abs(a - b) for a, b in zip(card["losses"], cpu_["losses"])
                   if np.isfinite(b))
    param_rel = max(_rel_err(card["params"][k], cpu_["params"][k])
                    for k in cpu_["params"])
    say(f"[13/{PHASES}] fused-scan guarded (GradScaler + "
          f"guard_nonfinite, an inf embedding row at step 2; steps 2-4 "
          f"under sync debug mode 'error'): losses card {card['losses']} "
          f"cpu {cpu_['losses']}; skip bit-identical card "
          f"{card['skip_bit_identical']} cpu {cpu_['skip_bit_identical']}; "
          f"step count {card['step_count']} / {cpu_['step_count']}; scale "
          f"{card['scale']} / {cpu_['scale']}; params max rel diff "
          f"{param_rel:.3g}", flush=True)
    for r in (card, cpu_):
        if not (r["skip_bit_identical"] and r["step_count"] == 3
                and r["skipped"] == 1 and r["scale"] == 1024.0
                and not np.isfinite(r["losses"][1])):
            raise AssertionError(f"guarded fused step: "
                                 f"{ {k: v for k, v in r.items() if k != 'params'} }")
    if not (loss_err <= 1e-4 and param_rel <= 1e-3):
        raise AssertionError(f"guarded fused step: card/CPU losses differ "
                             f"by {loss_err}, params by {param_rel} rel")
    fused_scan_bf16_parity(dev, sd, cfg, ids, labels, seg)
    monitor_past_its_ring(dev, cfg)


# phase 14's configuration at phase 13's size, card against CPU: the
# losses and the whole update ``w3 - w0`` (its norm relative to the
# CPU's). cuBLAS, the kernels and the CPU round bf16 at other places, and
# Adam turns the rounding of near-zero grads into whole steps, so the
# bars are loose (the gaps measured on an H100: 6.7e-4 and 0.093, see
# PERF.md); the same update moved one layer along the stack misses the
# update bar by far. That the card computed in bf16 at all is held
# apart: its first loss must move from a run computed in fp32 by more
# than `BF16_SCAN_CAST_MIN` (1.2e-4 measured; fp32 card against CPU
# 4.8e-7).
BF16_SCAN_LOSS_BAR = 3e-3
BF16_SCAN_UPDATE_BAR = 0.3
BF16_SCAN_CAST_MIN = 1e-5


def fused_scan_bf16_parity(dev, sd, cfg, ids, labels, seg):
    """Three ``FusedScanTrainStep``s at phase 14's configuration (fp32
    parameters that are their own masters, bf16 moments, bf16 compute,
    the fused head, no clip) over phase 13's tiny model, on the card and
    on the CPU, so that ``mt_adam_kernel<float, bf16>`` takes each
    layer's slices with ``bump=False``; then the same on the card
    computed in fp32 (``compute_dtype=None``), which the bf16 run's first
    loss must differ from."""
    from paddle_tpu_torch.jit import FusedScanTrainStep
    from paddle_tpu_torch.optimizer import AdamW

    out = {}
    for where, cd in (("card", "bfloat16"), ("cpu", "bfloat16"),
                      ("card", None)):
        d = dev if where == "card" else torch.device("cpu")
        model = _scan_gpt(d, sd, cfg)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    moment_dtype="bfloat16")
        step = FusedScanTrainStep(model, opt, fused_head=True,
                                  compute_dtype=cd, layer_chunk=1)
        batch = [torch.from_numpy(a).to(d) for a in (ids, labels, seg)]
        out[where, cd] = {
            "losses": [float(step(*batch)) for _ in range(3)],
            "step_count": opt._step_count,
            "moments": sorted({str(t.dtype) for store in
                               opt._accumulators.values()
                               for t in store.values()}),
            "params": {k: t.detach().cpu() for k, t in
                       model.state_dict().items()}}
    card, ref = out["card", "bfloat16"], out["cpu", "bfloat16"]

    def update_gap(r, roll=False):
        num = den = 0.0
        for k, w0 in sd.items():
            d, want = r["params"][k] - w0, ref["params"][k] - w0
            if roll and k.startswith("gpt.blocks."):
                d = d.roll(1, 0)
            num += float((d - want).double().square().sum())
            den += float(want.double().square().sum())
        return (num / den) ** 0.5

    loss_gap = max(abs(a - b) for a, b in zip(card["losses"],
                                              ref["losses"]))
    upd, rolled = update_gap(card), update_gap(card, roll=True)
    fp32 = out["card", None]
    cast = abs(card["losses"][0] - fp32["losses"][0])
    fp32_gaps = (max(abs(a - b) for a, b in zip(fp32["losses"],
                                                ref["losses"])),
                 update_gap(fp32))
    say(f"[13/{PHASES}] fused-scan bf16 compute (fp32 params, bf16 "
          f"moments, fused head, no clip): losses card {card['losses']} "
          f"cpu {ref['losses']}; max |diff| {loss_gap:.3g} (bar "
          f"{BF16_SCAN_LOSS_BAR}), update rel diff {upd:.3g} (bar "
          f"{BF16_SCAN_UPDATE_BAR}; moved one layer along the stack "
          f"{rolled:.3g}); computed in fp32 on the card: losses "
          f"{fp32['losses']}, first loss moved {cast:.3g} by the bf16 "
          f"cast (at least {BF16_SCAN_CAST_MIN}), from the CPU's bf16 run "
          f"{fp32_gaps[0]:.3g} in loss and {fp32_gaps[1]:.3g} in the "
          f"update; moments "
          f"{card['moments']}; step counts "
          f"{[r['step_count'] for r in out.values()]}", flush=True)
    if not (loss_gap <= BF16_SCAN_LOSS_BAR and upd <= BF16_SCAN_UPDATE_BAR
            and rolled > BF16_SCAN_UPDATE_BAR
            and cast > BF16_SCAN_CAST_MIN):
        raise AssertionError(f"fused scan in bf16: loss gap {loss_gap}, "
                             f"update gap {upd} (rolled {rolled}), cast "
                             f"{cast}")
    if any(r["step_count"] != 3 for r in out.values()) or \
            card["moments"] != ["torch.bfloat16"]:
        raise AssertionError("bf16 fused step: step count or moments")


def monitor_past_its_ring(dev, cfg, steps=70):
    """``steps`` steps of ``TrainStep`` (the unrolled model) and of
    ``FusedScanTrainStep`` with the numerics monitor on, past its 64-block
    queue, under ``torch.cuda.set_sync_debug_mode("error")`` after a
    first step (which builds the optimizer's tables). Past the queue's
    depth each step folds the oldest blocks whose copies to the host have
    landed, never waiting: after a ``synchronize`` outside the guarded
    loop, the last four steps must fold exactly what the queue holds
    beyond its depth."""
    from dataclasses import replace

    from paddle_tpu_torch.jit import FusedScanTrainStep, TrainStep
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    ids = torch.zeros(2, cfg.max_position_embeddings, dtype=torch.long,
                      device=dev)
    seen = {}
    for fused in (False, True):
        model = GPTForCausalLM(replace(cfg, scan_layers=fused), device=dev,
                               seed=0)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        if fused:
            step = FusedScanTrainStep(model, opt, numerics=True)
            mon = step._numerics
        else:
            step = TrainStep(model, lambda m, x, y: m.loss(x, y), opt,
                             numerics=True)
            mon = step.numerics
        step(ids, ids)
        torch.cuda.synchronize()
        try:
            torch.cuda.set_sync_debug_mode("error")
            for _ in range(steps - 5):
                step(ids, ids)
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            for _ in range(4):
                step(ids, ids)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        name = type(step).__name__
        seen[name] = (mon._steps_seen, mon.summary()["steps_seen"])
        if seen[name] != (steps - mon._depth, steps):
            raise AssertionError(f"{name}: the monitor folded {seen[name]}")
    say(f"[13/{PHASES}] numerics monitor past its queue: {steps} steps "
          f"of each step under sync debug mode 'error'; (folded in the "
          f"steps, seen at the boundary) {seen}", flush=True)


# a fused-scan step's launches at GPT-3 1.3B (24 layers, layer_chunk 1, no
# clip): splash forward in the forward and in each recompute, its backward
# once a layer, the CE once each way, one Adam update a layer chunk and one
# for the outer parameters
FUSED_SCAN_LAUNCHES = {"splash_fwd_wgmma_kernel": 48,
                       "splash_bwd_wgmma_kernels": 24,
                       "fused_ce_fwd_wgmma_kernel": 1,
                       "fused_ce_bwd_kernels": 1,
                       "mt_adam_kernel": 25}


def fused_scan_full_width(dev, warmup=2, timed=5, batch=8, seq=1024):
    """GPT-3 1.3B through ``FusedScanTrainStep`` at ``bench.py``'s default
    configuration for it (fp32 parameters, no masters, AdamW(1e-4) with
    bf16 moments, no clip, the fused head, bf16 compute, one layer a
    chunk) over ``batch`` x ``seq`` random tokens: ``warmup`` + ``timed``
    steps with the numerics monitor on, then with it off. The training
    kernels' counters are zeroed just before each timed run and read just
    after; the timed steps must build no multi-tensor table."""
    from paddle_tpu_torch.jit import FusedScanTrainStep
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt_config)
    from paddle_tpu_torch.ops.kernels import multi_tensor as mt
    from paddle_tpu_torch.optimizer import AdamW

    cfg = gpt_config("gpt3-1.3b", max_position_embeddings=seq,
                     hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                     scan_layers=True)
    before = torch.cuda.memory_allocated()     # what earlier phases hold
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                moment_dtype="bfloat16")
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (batch, seq))).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (batch, seq))).to(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    params = sum(p.numel() for p in model.parameters())
    tokens = batch * seq
    attn = 6 * 2.0 * batch * seq * (seq + 1) / 2 * cfg.hidden_size \
        * cfg.num_layers
    counters = _TrainCounters()
    # a table build of the multi-tensor kernels (its `_launches`) in the
    # timed steps would mean the plan cache lost a list of the step
    real_launches, builds = mt._launches, []
    mt._launches = lambda *a, **k: builds.append(1) or real_launches(*a,
                                                                      **k)
    runs = {}
    for numerics in (True, False):
        step = FusedScanTrainStep(model, opt,
                                  criterion=GPTPretrainingCriterion(),
                                  fused_head=True, compute_dtype="bfloat16",
                                  layer_chunk=1, numerics=numerics)
        losses = [float(step(ids, labels)) for _ in range(warmup)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters.zero()
        built = len(builds)
        times = []
        for _ in range(timed):
            t0 = time.perf_counter()
            loss = step(ids, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
        launches = counters.read()
        built = len(builds) - built
        step_s = statistics.median(times)
        runs["on" if numerics else "off"] = {
            "losses": losses, "step_ms": [t * 1e3 for t in times],
            "step_ms_median": step_s * 1e3,
            "tokens_per_s": tokens / step_s,
            "mfu": (6.0 * params * tokens + attn) / step_s
            / BF16_FLOP_PER_S,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": {k: n for k, n in launches.items() if n},
            "launches_per_step": {k: n / timed for k, n in launches.items()
                                  if n},
            "optimizer_tables_built": built,
            "monitor_summary": (step._numerics.summary() if numerics
                                else None)}
        del step
    mt._launches = real_launches
    stats = {
        "model": "gpt3-1.3b", "step": "FusedScanTrainStep",
        "layers": cfg.num_layers, "hidden": cfg.hidden_size,
        "heads": cfg.num_attention_heads, "vocab": cfg.vocab_size,
        "seq": seq, "batch": batch, "params": params,
        "dtype": "float32 parameters (their own masters), bf16 compute, "
                 "bf16 moments", "layer_chunk": 1, "fused_head": True,
        "clip": None, "setup_s": setup_s,
        "memory_allocated_before": before,
        "step_count": opt._step_count,
        "numerics_on": runs["on"], "numerics_off": runs["off"],
        "numerics_cost": (runs["on"]["step_ms_median"]
                          / runs["off"]["step_ms_median"] - 1.0),
        "nvidia_smi": nvidia_smi(),
    }
    say(f"[14/{PHASES}] train gpt3-1.3b FusedScanTrainStep: "
          f"{json.dumps(stats)}", flush=True)
    _PHASE_STATS["fused_scan"] = stats
    for name, r in runs.items():
        if not all(np.isfinite(r["losses"])):
            raise AssertionError(f"non-finite fused-scan loss ({name}): "
                                 f"{r['losses']}")
        expect = dict(FUSED_SCAN_LAUNCHES)
        per_step = r["launches_per_step"]
        if name == "on":        # the monitor's sums of squares
            expect["mt_norm_kernel"] = per_step.get("mt_norm_kernel", 0)
            if not expect["mt_norm_kernel"]:
                raise AssertionError("the monitor ran no mt_norm_kernel")
        if per_step != expect:
            raise AssertionError(f"fused-scan launches a step ({name}): "
                                 f"{per_step}, expected {expect}")
        if r["optimizer_tables_built"]:
            raise AssertionError(f"fused-scan ({name}): "
                                 f"{r['optimizer_tables_built']} optimizer "
                                 f"tables built in the timed steps")
    if stats["step_count"] != 2 * (warmup + timed):
        raise AssertionError(f"step count {stats['step_count']}")
    launches = {k: n for k, n in runs["on"]["launches"].items()}
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return launches, timed


# ---------------------------------------------------------------------------
# phases 11-12: ResNet training (the vision slice)
# ---------------------------------------------------------------------------

def _port_counters():
    """Zero / read every launch counter of the port's own kernels (the
    training, optimizer and paged kernels)."""
    train = _TrainCounters()

    def zero():
        train.zero()
        _paged_reset()

    def read():
        return {**train.read(), **_paged_launches()}

    return zero, read


def _resnet_step(model, lr=0.1, **kw):
    """(optimizer, step): the bench lane's Momentum(lr, 0.9) and
    ``TrainStep`` over ``CrossEntropyLoss`` (``kw``: the guard)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum

    crit = CrossEntropyLoss()
    opt = Momentum(learning_rate=lr, momentum=0.9,
                   parameters=model.parameters())
    return opt, TrainStep(model, lambda m, x, y: crit(m(x), y), opt, **kw)


def _resnet_state(model, opt):
    """The model's parameters and buffers and the optimizer's velocities,
    by name, on the CPU."""
    out = {k: t.detach().cpu() for k, t in model.state_dict().items()}
    names = {p: n for n, p in model.named_parameters()}
    for p, v in opt._accumulators.get("velocity", {}).items():
        out[f"velocity:{names[p]}"] = v.detach().cpu()
    return out


def _set_resnet_state(model, opt, state):
    """`_resnet_state`'s values into ``model`` and ``opt``, in place."""
    with torch.no_grad():
        model.load_state_dict({k: v for k, v in state.items()
                               if not k.startswith("velocity:")})
        for n, p in model.named_parameters():
            v = state.get(f"velocity:{n}")
            if v is not None:
                opt._get_accumulator("velocity", p).copy_(v)


def resnet_parity(dev):
    """Phase 11: resnet18 at 32 x 32, batch 4, 10 classes, Momentum(0.1,
    0.9), 3 ``TrainStep``s on the card and on the CPU from the same
    weights; each step starts both from the CPU's state (parameters,
    buffers, velocities), because a trajectory at this size is chaotic
    (batch norm over 4 values a channel in layer4: a 1e-7 relative change
    of the weights moves the third loss past 5e-4 on the CPU alone,
    tests/test_torch_vision.py).
    Loss 1e-4, parameters, buffers and velocities 1e-3 relative. Then a
    guarded step over a batch with an inf, under
    ``set_sync_debug_mode("error")``: parameters, buffers and velocities
    bit-identical to before it, on the card and on the CPU."""
    from paddle_tpu_torch.vision.models import resnet18

    rng = np.random.default_rng(11)
    batches = [(rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
                rng.integers(0, 10, (4,))) for _ in range(4)]
    models = {"card": resnet18(num_classes=10, device=dev, seed=0),
              "cpu": resnet18(num_classes=10, device="cpu", seed=0)}
    models["card"].load_state_dict(models["cpu"].state_dict())
    steps = {w: _resnet_step(m) for w, m in models.items()}
    losses, loss_err, rel = {"card": [], "cpu": []}, 0.0, 0.0
    for i, (x, y) in enumerate(batches[:3]):
        if i:
            _set_resnet_state(models["card"], steps["card"][0],
                              _resnet_state(models["cpu"], steps["cpu"][0]))
        for where, (opt, step) in steps.items():
            d = dev if where == "card" else torch.device("cpu")
            losses[where].append(float(step(torch.from_numpy(x).to(d),
                                            torch.from_numpy(y).to(d))))
        loss_err = max(loss_err, abs(losses["card"][-1]
                                     - losses["cpu"][-1]))
        got = _resnet_state(models["card"], steps["card"][0])
        want = _resnet_state(models["cpu"], steps["cpu"][0])
        rel = max(rel, max(_rel_err(got[k], want[k]) for k in want))

    guarded = {}
    bad = batches[3][0].copy()
    bad[1, 2, 5, 5] = np.inf
    for where, model in models.items():
        d = dev if where == "card" else torch.device("cpu")
        opt, step = _resnet_step(model, guard_nonfinite=True)
        x, y = (torch.from_numpy(a).to(d) for a in batches[3])
        step(x, y)                           # makes the velocities
        before = _resnet_state(model, opt)
        xb = torch.from_numpy(bad).to(d)
        if where == "card":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            loss = step(xb, y)
        finally:
            if where == "card":
                torch.cuda.set_sync_debug_mode(0)
        after = _resnet_state(model, opt)
        guarded[where] = {
            "loss": float(loss),
            "rollback_bit_identical": before.keys() == after.keys() and all(
                torch.equal(before[k], after[k]) for k in before),
            "skipped": int(step.guard.skipped)}
    say(f"[11/{PHASES}] resnet parity: resnet18 32x32 batch 4, "
          f"Momentum(0.1, 0.9), 3 TrainSteps, each from the CPU's state; "
          f"losses card {losses['card']} cpu {losses['cpu']} (max |diff| "
          f"{loss_err:.3g}); params, buffers and velocities max rel diff "
          f"{rel:.3g}; guarded inf step (sync debug 'error' on the card): "
          f"{json.dumps(guarded)}; cudnn deterministic "
          f"{torch.backends.cudnn.deterministic} benchmark "
          f"{torch.backends.cudnn.benchmark} allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}; {nvidia_smi()}", flush=True)
    if not loss_err <= 1e-4:
        raise AssertionError(f"resnet card/CPU losses differ by {loss_err}")
    if not rel <= 1e-3:
        raise AssertionError(f"resnet card/CPU state differs by {rel} rel")
    for where, r in guarded.items():
        if not (r["rollback_bit_identical"] and r["skipped"] == 1
                and not np.isfinite(r["loss"])):
            raise AssertionError(f"resnet guarded step, {where}: {r}")


def _resnet_flops(model, x):
    """Training FLOPs of one step: 2 x the multiply-adds of every
    convolution and Linear in a forward at ``x``'s shape, times 3 (the
    backward takes two products a forward product)."""
    from paddle_tpu_torch.nn import Conv2D

    macs = []

    def conv(m, inp, out):
        kh, kw = m.weight.shape[2:]
        macs.append(out.numel() * m.weight.shape[1] * kh * kw)

    def linear(m, inp, out):
        macs.append(out.numel() * m.in_features)

    hooks = [m.register_forward_hook(conv if isinstance(m, Conv2D)
                                     else linear)
             for m in model.modules()
             if isinstance(m, (Conv2D, torch.nn.Linear))]
    try:
        with torch.no_grad():
            model.eval()
            model(x)
            model.train()
    finally:
        for h in hooks:
            h.remove()
    return 3 * 2.0 * sum(macs)


def resnet_full_width(dev, warmup=2, timed=5, batch=32):
    """Phase 12: ResNet-50 at the bench lane's configuration
    (bench.py:544-600: resnet50(num_classes=1000) from seed 0,
    CrossEntropyLoss, Momentum(0.1, 0.9), fp32, batch 32 of 3 x 224 x 224
    random images and labels from ``default_rng(0)``); ``warmup`` then
    ``timed`` steps on one batch held on the card (then as many more
    with the numerics monitor off, beside them), then ``timed`` steps
    through ``step.prefetch(..., depth=2)`` over a new random host batch a
    step. Every counter of the port's own kernels is zeroed before the
    ResNet steps and must read 0 after them (they run cuDNN and aten
    only). Then the model and the Momentum state go through `save` and
    `load` into a fresh CPU model and optimizer, bit for bit."""
    import shutil
    import tempfile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    zero, read = _port_counters()
    t0 = time.perf_counter()
    model = resnet50(num_classes=1000, device=dev, seed=0)
    opt, step = _resnet_step(model)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((batch, 3, 224, 224))
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 1000, (batch,))).to(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    flops = _resnet_flops(model, x)
    zero()
    losses = [float(step(x, y)) for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        loss = step(x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    # the same steps without the numerics monitor: its cost
    crit = CrossEntropyLoss()
    step_off = TrainStep(model, lambda m, a, b: crit(m(a), b), opt,
                         numerics=False)
    off_losses = [float(step_off(x, y))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times_off = []
    for _ in range(timed):
        t0 = time.perf_counter()
        loss = step_off(x, y)
        torch.cuda.synchronize()
        times_off.append(time.perf_counter() - t0)
        off_losses.append(float(loss))
    off = {"losses": off_losses, "step_ms": [t * 1e3 for t in times_off],
           "step_ms_median": statistics.median(times_off) * 1e3,
           "images_per_s": batch / statistics.median(times_off),
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del step_off

    def host_batches():
        for _ in range(timed):
            yield (rng.standard_normal((batch, 3, 224, 224))
                   .astype(np.float32),
                   rng.integers(0, 1000, (batch,), dtype=np.int64))

    pf = step.prefetch(host_batches(), depth=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pf_losses = [step(xb, yb) for xb, yb in pf]
    torch.cuda.synchronize()
    pf_s = time.perf_counter() - t0
    losses += [float(v) for v in pf_losses]
    launches = read()
    pf_stats = pf.get_stats()

    # the file goes to a scratch directory of the checkout (gitignored)
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chip_scratch")
    os.makedirs(scratch, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=scratch)
    try:
        path = os.path.join(tmp, "resnet50.pdparams")
        t0 = time.perf_counter()
        pt.save({"model": convert.state_dict_to_jax(
                     model.state_dict(), model=model, tensors=True),
                 "opt": convert.optimizer_state_to_jax(opt.state_dict(),
                                                       model, opt)}, path)
        save_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(path)
        t0 = time.perf_counter()
        ck = pt.load(path)
        cpu_model = resnet50(num_classes=1000, device="cpu", seed=1)
        cpu_model.load_state_dict(convert.state_dict_from_jax(
            ck["model"], model=cpu_model))
        cpu_opt = Momentum(learning_rate=0.1, momentum=0.9,
                           parameters=cpu_model.parameters())
        cpu_opt.set_state_dict(convert.optimizer_state_from_jax(
            ck["opt"], cpu_model, cpu_opt))
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got, want = _resnet_state(cpu_model, cpu_opt), _resnet_state(model, opt)
    same = got.keys() == want.keys() and all(
        torch.equal(got[k], want[k]) for k in want)

    step_s = statistics.median(times)
    stats = {
        "model": "resnet50", "num_classes": 1000, "batch": batch,
        "image": [3, 224, 224], "dtype": "float32",
        "optimizer": "Momentum(0.1, 0.9), per-parameter",
        "params": sum(p.numel() for p in model.parameters()),
        "setup_s": setup_s, "losses": losses,
        "step_ms": [t * 1e3 for t in times],
        "step_ms_median": step_s * 1e3,
        "images_per_s": batch / step_s,
        "train_flops_per_step": flops,
        "mfu_fp32": flops / step_s / FP32_FLOP_PER_S,
        "max_memory_allocated": peak,
        "numerics": "on", "numerics_off": off,
        "numerics_cost": step_s / (off["step_ms_median"] / 1e3) - 1.0,
        "prefetch": {"steps": timed, "depth": 2, "wall_s": pf_s,
                     "images_per_s": batch * timed / pf_s,
                     "input_stall_ms_mean": pf_stats["input_stall_ms"]
                     ["mean"],
                     "h2d_ms_mean": pf_stats["h2d_ms"]["mean"],
                     "per_step_input_stall_ms":
                         pf_stats["per_step_input_stall_ms"],
                     "per_step_h2d_ms": pf_stats["per_step_h2d_ms"]},
        "port_kernel_launches": {k: n for k, n in launches.items() if n},
        "checkpoint": {"file_bytes": file_bytes, "save_s": save_s,
                       "load_s": load_s, "bit_identical": same},
        "cudnn": {"deterministic": torch.backends.cudnn.deterministic,
                  "benchmark": torch.backends.cudnn.benchmark,
                  "allow_tf32": torch.backends.cudnn.allow_tf32},
        "nvidia_smi": nvidia_smi(),
    }
    say(f"[12/{PHASES}] train resnet50 (bench lane): {json.dumps(stats)}",
          flush=True)
    if not all(np.isfinite(losses + off_losses)):
        raise AssertionError(f"non-finite resnet50 loss: {losses} "
                             f"{off_losses}")
    if stats["port_kernel_launches"]:
        raise AssertionError(f"the port's kernels ran in the ResNet steps: "
                             f"{stats['port_kernel_launches']}")
    if not same:
        raise AssertionError("resnet50 save/load is not bit-identical")
    del model, opt, step, cpu_model, cpu_opt, ck
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3, the fused CE at LLaMA's heads; phases 15-16: LLaMA training
# ---------------------------------------------------------------------------

# name -> (tokens, vocab 32000, hidden): TinyLlama-1.1B's training shape
# (4 x 2048 tokens) and LLaMA-7B's head at 2048 tokens
LLAMA_CE_SHAPES = {"tinyllama-1.1b": (8192, 32000, 2048),
                   "llama-7b head": (2048, 32000, 4096)}


def check_llama_ce(dev, flush):
    """The fused CE (#11/#12) at LLaMA's vocab of 32000 (not a multiple
    of the bf16 backward's chunk tile: ragged chunks), fp32 and bf16,
    forward and backward against the plain version under phase 3's bars,
    each bit-identical on a second run; then bf16 times beside the plain
    version and ``F.linear`` + ``F.cross_entropy``. Returns {kernel
    name: {shape name: numbers}}."""
    from paddle_tpu_torch.ops.kernels import fused_cross_entropy as fce

    out = {"fused_ce_fwd_wgmma_kernel": {}, "fused_ce_bwd_kernels": {}}
    for shape, (n, vocab, hidden) in LLAMA_CE_SHAPES.items():
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            fe, le, ba, br, fin, same, args = _ce_case(dev, n, vocab, hidden,
                                                       dtype, seed=3)
            _check(f"fused_ce {shape}", dtype, fe, br, fin, le, same=same)
            errs[dtype] = (max(fe, le), ba, br)
            say(f"[3/{PHASES}] fused_ce {shape} [{n},{hidden}]x[{vocab},"
                  f"{hidden}] {str(dtype)[6:]}: forward max abs err "
                  f"{fe:.3g}, lse {le:.3g}; backward max abs err {ba:.3g}, "
                  f"relative {br:.3g}; forward and backward bit-identical "
                  f"on a second run; backward chunks "
                  f"{fce.plan_chunks(n, vocab, hidden)}", flush=True)
            if dtype == torch.float32:
                del args
                torch.cuda.empty_cache()
        for name, r in _time_ce(flush, *args).items():
            which = int(name == "fused_ce_bwd_kernels")
            r["max_abs_err"] = errs[torch.bfloat16][which]
            r["max_abs_err_fp32"] = errs[torch.float32][which]
            if which:
                r["max_rel_err"] = errs[torch.bfloat16][2]
                r["max_rel_err_fp32"] = errs[torch.float32][2]
            out[name][shape] = r
            say(f"[3/{PHASES}] {name} {shape}: bf16 kernel {r['ms']:.4f} "
                  f"ms, plain {r['plain_ms']:.4f} ms, library "
                  f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})", flush=True)
        del args
        torch.cuda.empty_cache()
    return out


# the phase-15 model: fp32 GQA at a few layers
LLAMA_SMALL = dict(vocab_size=512, hidden_size=256, num_layers=4,
                   num_attention_heads=8, num_key_value_heads=2,
                   intermediate_size=688, max_position_embeddings=256,
                   use_recompute=True)


def llama_parity(dev):
    """Phase 15: a small fp32 GQA LLaMA (``LLAMA_SMALL``), tied and
    untied head, takes three ``TrainStep``s of AdamW with a global-norm
    clip through ``model.loss`` with recompute, on the card and on the
    CPU, each step from the CPU's state (parameters, moments and step
    count, through ``state_dict``): losses 1e-4, parameters 1e-3 rel.
    One CPU step comes first, so every compared step has moments: Adam's
    first step moves each element by about lr whatever its gradient, so
    a gradient of summation noise moves an element by up to 2 lr, which
    takes 1e-7 relative noise in the weights to 1e-3 relative in the
    parameters on the CPU alone (and to 1e-5 from the second step on).
    The fp32 CE kernels and the optimizer's two kernels must have run, no
    attention kernel and no other training kernel."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    rng = np.random.default_rng(15)
    seq = 128
    batches = [(torch.from_numpy(rng.integers(0, 512, (2, seq))),
                torch.from_numpy(rng.integers(0, 512, (2, seq))))
               for _ in range(4)]
    counters = _TrainCounters()
    report = {}
    for tied in (True, False):
        cfg = LlamaConfig(**LLAMA_SMALL, tie_word_embeddings=tied)
        runs = {}
        for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
            model = LlamaForCausalLM(cfg, device=d, seed=1)
            opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                        grad_clip=ClipGradByGlobalNorm(1.0))
            runs[where] = (model, opt, TrainStep(
                model, lambda m, x, y: m.loss(x, y), opt), d)
        cpu_model, cpu_opt, cpu_step, _ = runs["cpu"]
        cpu_step(*batches[0])                       # the moments
        losses, loss_err, rel, worst = {"card": [], "cpu": []}, 0.0, 0.0, ""
        for ids, labels in batches[1:]:
            card_model, card_opt, card_step, _ = runs["card"]
            card_model.load_state_dict(cpu_model.state_dict())
            card_opt.set_state_dict(cpu_opt.state_dict())
            counters.zero()
            for where, (model, opt, step, d) in runs.items():
                losses[where].append(float(step(ids.to(d), labels.to(d))))
            launches = counters.read()
            _check_launches(launches, ("fused_ce_fwd_kernel",
                                       "fused_ce_bwd_kernels") + OPT_KERNELS,
                            "llama parity")
            loss_err = max(loss_err, abs(losses["card"][-1]
                                         - losses["cpu"][-1]))
            want = cpu_model.state_dict()
            rel, worst = max((rel, worst), max(
                (_rel_err(t.cpu(), want[k]), k)
                for k, t in card_model.state_dict().items()))
        report["tied" if tied else "untied"] = {
            "losses_card": losses["card"], "losses_cpu": losses["cpu"],
            "max_loss_diff": loss_err, "params_max_rel_diff": rel,
            "worst": worst, "step_count": card_opt._step_count}
    say(f"[15/{PHASES}] llama parity: fp32 GQA LLaMA {LLAMA_SMALL}, 3 "
          f"TrainSteps (AdamW, clip 1.0, recompute) each from the CPU's "
          f"state after one CPU step: {json.dumps(report)}; kernel "
          f"launches a step { {k: n for k, n in launches.items() if n} }",
          flush=True)
    for case, r in report.items():
        if not r["max_loss_diff"] <= 1e-4:
            raise AssertionError(f"llama {case}: card/CPU losses differ by "
                                 f"{r['max_loss_diff']}")
        if not r["params_max_rel_diff"] <= 1e-3:
            raise AssertionError(f"llama {case}: card/CPU params differ by "
                                 f"{r['params_max_rel_diff']} rel")


def _llama_shapes(cfg):
    """A LLaMA's parameter shapes in creation order (untied head)."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    hd = h // cfg.num_attention_heads
    q, kv = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd
    layer = [(h,), (q, h), (kv, h), (kv, h), (h, q), (h,), (i, h), (i, h),
             (h, i)]
    return ([(cfg.vocab_size, h)] + layer * cfg.num_layers
            + [(h,), (cfg.vocab_size, h)])


# phase 15's bf16 case, card against CPU (each step from the CPU's
# state): the loss, and the fp32 masters' update relative to the CPU
# update's norm over the whole model. Measured on an H100 (700 W): the
# card 2.96e-4 in loss and 0.0151 / 0.0076 / 0.0073 in the update; the
# same steps computed in fp32 on the card 6.61e-4 and 0.0208 / 0.0124 /
# 0.0083 (what bf16 rounding alone moves); the update moved one layer
# along the stack 1.41. The bars lie between: the fp32 run must miss the
# loss bar and the moved update the update bar.
LLAMA_O2_LOSS_BAR = 4.5e-4
LLAMA_O2_UPDATE_BAR = 0.05


def llama_o2_parity(dev):
    """Phase 15, bf16: phase 16's configuration at ``LLAMA_SMALL``'s
    size with an untied head (``amp.decorate(level="O2")``: bf16 weights,
    RMSNorm's too, fp32 masters; AdamW(1e-3) with bf16 moments and a
    global-norm clip; bf16 attention scores), card against CPU over three
    ``TrainStep``s, each from the CPU's state after one CPU step. Held:
    the losses, and the update of the fp32 masters relative to the CPU
    update's norm. Controls: the card's update against the CPU's moved
    one layer along the stack, which must miss the update bar, and the
    same steps on the card computed in fp32 (no ``decorate``, from the
    CPU's masters and moments), which must miss the loss bar. The bf16
    CE kernels and the optimizer's two kernels must have run, and no
    attention kernel."""
    from paddle_tpu_torch import get_flags
    from paddle_tpu_torch.amp import decorate
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    if get_flags(["FLAGS_attention_fp32_scores"])[
            "FLAGS_attention_fp32_scores"]:
        raise AssertionError("phase 15's bf16 case needs bf16 scores")
    cfg = LlamaConfig(**LLAMA_SMALL, tie_word_embeddings=False)
    rng = np.random.default_rng(16)
    seq = 128
    batches = [(torch.from_numpy(rng.integers(0, 512, (2, seq))),
                torch.from_numpy(rng.integers(0, 512, (2, seq))))
               for _ in range(4)]

    def make(d, o2):
        model = LlamaForCausalLM(cfg, device=d, seed=1)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    moment_dtype="bfloat16",
                    grad_clip=ClipGradByGlobalNorm(1.0))
        if o2:
            model, opt = decorate(models=model, optimizers=opt, level="O2")
        return model, opt, TrainStep(model, lambda m, x, y: m.loss(x, y),
                                     opt)

    cpu, card, ctl = (make(torch.device("cpu"), True), make(dev, True),
                      make(dev, False))
    if [tuple(p.shape) for p in cpu[0].parameters()] != _llama_shapes(cfg):
        raise AssertionError("_llama_shapes is not the model's list")
    if {p.dtype for p in card[0].parameters()} != {torch.bfloat16}:
        raise AssertionError("O2 left a parameter outside bf16")
    cpu[2](*batches[0])                             # the moments
    names = [n for n, _ in cpu[0].named_parameters()]
    counters = _TrainCounters()
    losses = {"card": [], "cpu": [], "fp32 on the card": []}
    gaps = {"card": [], "fp32 on the card": [], "shifted": []}
    for ids, labels in batches[1:]:
        sd, osd = cpu[0].state_dict(), cpu[1].state_dict()
        start = [cpu[1]._master_weights[p].clone()
                 for p in cpu[0].parameters()]
        card[0].load_state_dict(sd)
        card[1].set_state_dict(osd)
        with torch.no_grad():
            for p, m in zip(ctl[0].parameters(), start):
                p.copy_(m)
        ctl[1].set_state_dict({"accumulators": osd["accumulators"],
                               "step": osd["step"]})
        counters.zero()
        losses["card"].append(float(card[2](ids.to(dev), labels.to(dev))))
        launches = counters.read()
        _check_launches(launches, ("fused_ce_fwd_wgmma_kernel",
                                   "fused_ce_bwd_kernels") + OPT_KERNELS,
                        "llama O2 parity")
        losses["fp32 on the card"].append(
            float(ctl[2](ids.to(dev), labels.to(dev))))
        losses["cpu"].append(float(cpu[2](ids, labels)))
        want = [cpu[1]._master_weights[p] - s
                for p, s in zip(cpu[0].parameters(), start)]
        got = {"card": [card[1]._master_weights[p].cpu() - s for p, s in
                        zip(card[0].parameters(), start)],
               "fp32 on the card": [p.detach().cpu() - s for p, s in
                                    zip(ctl[0].parameters(), start)]}
        # layer l's update against the CPU's of layer l + 1
        nxt = {n: names.index(n.replace(f"layers.{l}.", f"layers.{l + 1}."))
               for n in names if (l := _layer_of(n)) is not None
               and l + 1 < cfg.num_layers}
        got["shifted"] = [got["card"][names.index(n)] for n in nxt]
        den = sum(float(w.double().square().sum()) for w in want)
        for case in gaps:
            ref = [want[j] for j in nxt.values()] if case == "shifted" \
                else want
            num = sum(float((a - b).double().square().sum())
                      for a, b in zip(got[case], ref))
            sub = den if case != "shifted" else sum(
                float(w.double().square().sum()) for w in ref)
            gaps[case].append((num / sub) ** 0.5)
    loss_gap = {case: max(abs(a - b) for a, b in zip(ls, losses["cpu"]))
                for case, ls in losses.items() if case != "cpu"}
    report = {"losses": losses, "max_loss_diff": loss_gap,
              "update_rel_diff": gaps,
              "bars": {"loss": LLAMA_O2_LOSS_BAR,
                       "update": LLAMA_O2_UPDATE_BAR},
              "step_count": card[1]._step_count}
    say(f"[15/{PHASES}] llama parity, bf16 O2 (bf16 weights and scores, "
          f"fp32 masters, bf16 moments, untied head), 3 TrainSteps each "
          f"from the CPU's state after one CPU step: {json.dumps(report)}",
          flush=True)
    if not (loss_gap["card"] <= LLAMA_O2_LOSS_BAR
            and max(gaps["card"]) <= LLAMA_O2_UPDATE_BAR):
        raise AssertionError(f"llama O2: card/CPU loss gap "
                             f"{loss_gap['card']}, update gap "
                             f"{gaps['card']}")
    if not min(gaps["shifted"]) > LLAMA_O2_UPDATE_BAR:
        raise AssertionError(f"llama O2: the update moved a layer along "
                             f"passes the bar: {gaps['shifted']}")
    if not loss_gap["fp32 on the card"] > LLAMA_O2_LOSS_BAR:
        raise AssertionError("llama O2: the run computed in fp32 passes "
                             "the loss bar, which then cannot see bf16")
    del cpu, card, ctl
    gc.collect()
    torch.cuda.empty_cache()


def _layer_of(name):
    """The layer index of a LLaMA parameter's name, else None."""
    parts = name.split(".")
    return int(parts[2]) if parts[1:2] == ["layers"] else None


def llama_full_width(dev, warmup=2, timed=5, batch=4, seq=2048):
    """Phase 16: TinyLlama-1.1B (``llama_config("tinyllama-1.1b",
    use_recompute=True)``, every width as published) in bf16 through
    ``amp.decorate(level="O2")`` (fp32 masters), AdamW(1e-4) with bf16
    moments and ``ClipGradByGlobalNorm(1.0)``, ``batch`` x ``seq`` random
    tokens from seed 0: ``warmup`` + ``timed`` steps with the numerics
    monitor, then 1 + ``timed`` without. The training kernels' counters
    are zeroed just before the timed steps and read just after: a step
    launches one CE forward on warpgroup products and one CE backward,
    one ``mt_adam_kernel`` (one dtype group) and one ``mt_norm_kernel``
    (the clip), and no attention kernel (the attention is dense, as in
    the reference). Every loss finite, the first near ln(32000)."""
    from paddle_tpu_torch.amp import decorate
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_config
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    cfg = llama_config("tinyllama-1.1b", use_recompute=True)
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                moment_dtype="bfloat16", grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = decorate(models=model, optimizers=opt, level="O2")
    step = TrainStep(model, lambda m, x, y: m.loss(x, y), opt)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (batch, seq))).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (batch, seq))).to(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses = [float(step(ids, labels)) for _ in range(warmup)]

    counters = _TrainCounters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters.zero()
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = counters.read()
    peak = torch.cuda.max_memory_allocated()
    step_off = TrainStep(model, lambda m, x, y: m.loss(x, y), opt,
                         numerics=False)
    off_losses = [float(step_off(ids, labels))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times_off = []
    for _ in range(timed):
        t0 = time.perf_counter()
        loss = step_off(ids, labels)
        torch.cuda.synchronize()
        times_off.append(time.perf_counter() - t0)
        off_losses.append(float(loss))

    params = sum(p.numel() for p in model.parameters())
    tokens = batch * seq
    pairs = seq * (seq + 1) / 2
    # forward + backward attention products (2 + 4) over the causal
    # pairs, recompute not counted; the dense path computes the whole
    # [seq, seq] square
    attn = 6 * 2.0 * batch * pairs * cfg.hidden_size * cfg.num_layers
    step_s = statistics.median(times)
    per_step = {k: launches[k] / timed for k in launches if launches[k]}
    stats = {
        "model": "tinyllama-1.1b", "layers": cfg.num_layers,
        "hidden": cfg.hidden_size, "heads": cfg.num_attention_heads,
        "kv_heads": cfg.num_key_value_heads,
        "intermediate": cfg.intermediate_size, "vocab": cfg.vocab_size,
        "seq": seq, "batch": batch, "attention": "dense (as the reference)",
        "params": params,
        "dtype": "bfloat16 via amp.decorate O2 (fp32 masters, bf16 moments)",
        "recompute": True, "setup_s": round(setup_s, 3),
        "losses": losses, "step_ms": [t * 1e3 for t in times],
        "step_ms_median": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "mfu": (6.0 * params * tokens + attn) / step_s / BF16_FLOP_PER_S,
        "max_memory_allocated": peak, "memory_allocated_before": before,
        "numerics": "on",
        "numerics_off": {
            "losses": off_losses,
            "step_ms": [t * 1e3 for t in times_off],
            "step_ms_median": statistics.median(times_off) * 1e3,
            "tokens_per_s": tokens / statistics.median(times_off),
            "max_memory_allocated": torch.cuda.max_memory_allocated()},
        "numerics_cost": step_s / statistics.median(times_off) - 1.0,
        "launches": {k: n for k, n in launches.items() if n},
        "launches_per_step": per_step,
    }
    say(f"[16/{PHASES}] train tinyllama-1.1b: {json.dumps(stats)}",
          flush=True)
    if not all(np.isfinite(losses + off_losses)):
        raise AssertionError(f"non-finite loss: {losses} {off_losses}")
    if not abs(losses[0] - float(np.log(cfg.vocab_size))) < 0.5:
        raise AssertionError(f"first loss {losses[0]} is not near "
                             f"ln({cfg.vocab_size})")
    want = {"fused_ce_fwd_wgmma_kernel": 1.0, "fused_ce_bwd_kernels": 1.0,
            "mt_adam_kernel": 1.0, "mt_norm_kernel": 1.0}
    if per_step != want:
        raise AssertionError(f"llama launches a step {per_step}, want "
                             f"{want} (no attention kernel)")
    del model, opt, step, step_off
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches[k] for k in want}, timed


# ---------------------------------------------------------------------------
# phase 3, the weight-only linear; phase 17, the decode lane
# ---------------------------------------------------------------------------

WO_SOURCE = "paddle_tpu_torch/csrc/weight_only.cu"
WO_REPLACES = "paddle_tpu/nn/quant/__init__.py:154"
# GPT-3 1.3B's four projections, [out, in]
WO_PROJECTIONS = {"qkv": (6144, 2048), "out_proj": (2048, 2048),
                  "fc1": (8192, 2048), "fc2": (2048, 8192)}
# decode at batch 1 and 8; the prompt passes of phase 17's batch 1 and 8
# (prompt 128), which take the prompt route's 128- and 256-token tiles
WO_ROWS = (1, 8, 128, 1024)
WO_QUANTS = {"int8": ("weight_only_int8", -1),
             "int4": ("weight_only_int4", -1),
             "int8_g128": ("weight_only_int8", 128)}
# the error over the plain output's largest magnitude: fp32 sums in
# another order; bf16 / fp16 one rounding of the output
WO_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3, torch.float16: 8e-3}
# route -> kernel: the Hopper design (bf16 / fp16 x) and the first design
# (fp32 x, and the shapes the Hopper routes refuse)
WO_KERNELS = {"mma": "wo_mma_kernel", "wgmma": "wo_wgmma_kernel",
              "gemv": "wo_gemv_kernel", "tiled": "wo_tiled_kernel"}
# a route's rows in the kernels line, one list each, in this order
WO_ROW_KEYS = ("proj", "m", "quant", "dtype", "max_rel_err", "ms",
               "plain_ms", "bound_ms", "bytes_bound_ms", "library_ms",
               "dequant_linear_ms", "stream_ms", "library_stream_ms")
# the headline shape of each route in the kernels line: fc1, int8 per
# channel, at the lane's batch 8 (decode) and its prompt pass; bf16 x on
# the Hopper routes, fp32 x on the first design
WO_HEADLINE = {"mma": ("fc1", 8, "int8", "bfloat16"),
               "wgmma": ("fc1", 1024, "int8", "bfloat16"),
               "gemv": ("fc1", 8, "int8", "float32"),
               "tiled": ("fc1", 1024, "int8", "float32")}

# the Hopper routes' rows are also timed as `STREAM_COPIES` calls back to
# back in one graph, each over its own weight, so that the copies (8 x
# 16.8 MB of int8 at fc1, 8 x 33.5 MB in bf16) outgrow the 50 MB L2 and
# no launch finds its weight there
STREAM_COPIES = 8


def _wo_row(dev, flush, proj, m, quant, dtype, seed):
    """One row of phase 3's weight-only table: the kernel against its
    plain version (and bit-identical twice), then its graph-replay time
    beside the plain version, the byte bound and the two library
    yardsticks."""
    from paddle_tpu_torch.nn.quant import weight_dequantize, weight_quantize
    from paddle_tpu_torch.ops.kernels import weight_only as wo

    n, k = WO_PROJECTIONS[proj]
    algo, group = WO_QUANTS[quant]
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, s = weight_quantize(torch.randn(k, n, device=dev, generator=gen) *
                           0.02, algo=algo, group_size=group)
    x = torch.randn(m, k, device=dev, generator=gen).to(dtype)
    b = (torch.randn(n, device=dev, generator=gen) * 0.02).to(dtype)
    route = wo.route(dtype, m, k, 0 if group == -1 else group, True)
    counter = f"launches_{route}"
    before = getattr(wo.weight_only_linear, counter)
    got = wo.weight_only_linear(x, q, b, s)
    again = wo.weight_only_linear(x, q, b, s)
    torch.cuda.synchronize()
    want = wo.weight_only_linear_ref(x, q, b, s)
    err = _rel_err(got, want)
    name = f"weight_only {proj} [{n},{k}] M {m} {quant} {str(dtype)[6:]}"
    if getattr(wo.weight_only_linear, counter) != before + 2:
        raise AssertionError(f"{name}: not counted on {counter}")
    if not (err <= WO_TOL[dtype] and torch.isfinite(got).all()
            and torch.equal(got, again)):
        raise AssertionError(f"{name}: error {err} over the largest output "
                             f"> {WO_TOL[dtype]}, or a second call differs")
    isz = x.element_size()
    # the int8 weight, its scales, x, y and the bias once each
    nbytes = float(n * k + s.numel() * 4 + (m * k + m * n + n) * isz)
    b_ms, b_by = bound_ms(nbytes, 2.0 * m * n * k, isz)
    wb = weight_dequantize(q, s, algo=algo, out_dtype=torch.bfloat16) \
        .t().contiguous()
    xb = x.to(torch.bfloat16)
    bb = b.to(torch.bfloat16)
    row = {
        "proj": proj, "shape": [m, n, k], "quant": quant,
        "dtype": str(dtype)[6:], "route": route, "max_rel_err": err,
        "max_abs_err": _max_err(got, want),
        "ms": graph_ms(lambda: wo.weight_only_linear(x, q, b, s), flush),
        "plain_ms": time_ms(lambda: wo.weight_only_linear_ref(x, q, b, s),
                            flush),
        "bound_ms": b_ms, "bound_by": b_by,
        "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        # F.linear over the bf16 weight, what int8 is meant to beat
        "library_ms": graph_ms(
            lambda: torch.nn.functional.linear(xb, wb, bb), flush),
        # weight_dequantize + the product, the dequantize counted
        "dequant_linear_ms": graph_ms(
            lambda: torch.addmm(b, x, weight_dequantize(
                q, s, algo=algo, out_dtype=dtype)), flush),
        "stream_ms": None, "library_stream_ms": None,
    }
    if route in ("mma", "wgmma"):
        # the Hopper route and F.linear back to back over
        # `STREAM_COPIES` weights
        ws = [(q, s)] + [weight_quantize(
            torch.randn(k, n, device=dev, generator=gen) * 0.02, algo=algo,
            group_size=group) for _ in range(STREAM_COPIES - 1)]
        row["stream_ms"] = graph_ms(
            [lambda q=q, s=s: wo.weight_only_linear(x, q, b, s)
             for q, s in ws])
        wbs = [weight_dequantize(q, s, algo=algo, out_dtype=torch.bfloat16)
               .t().contiguous() for q, s in ws]
        row["library_stream_ms"] = graph_ms(
            [lambda w=w: torch.nn.functional.linear(xb, w, bb)
             for w in wbs])
        del ws, wbs
    stream = "" if row["stream_ms"] is None else (
        f"; back to back {row['stream_ms']:.4f}, F.linear "
        f"{row['library_stream_ms']:.4f}")
    say(f"[3/{PHASES}] {name}: {route}, error/max {err:.3g}, "
          f"bit-identical twice; {row['ms']:.4f} ms (plain "
          f"{row['plain_ms']:.4f}, bf16 F.linear {row['library_ms']:.4f}, "
          f"dequantize + product {row['dequant_linear_ms']:.4f}, bound "
          f"{b_ms:.4f} {b_by}{stream})", flush=True)
    return row


def check_weight_only(dev, flush):
    """Phase 3's weight-only rows (``csrc/weight_only.cu``): each of GPT-3
    1.3B's four projections at M = 1, 8, 128 and 1024 (`WO_ROWS`), in
    int8 per channel, int4 and int8 grouped 128, with fp32 x (the first
    design) and bf16 x (the Hopper routes), and fp16 cases at the
    speculative verify's M 40 and a chunk's M 64 too; each held to
    `weight_only_linear_ref` (`WO_TOL`) and bit-identical on a second
    call, and timed as graph replays (L2 flushed) beside the plain
    version, the byte bound and two library yardsticks (the Hopper
    routes' rows and ``F.linear`` also back to back over
    `STREAM_COPIES` weights, ``stream_ms``). Returns the kernels line's
    four entries, the headline numbers of each route
    (`WO_HEADLINE`) and all its rows."""
    rows = []
    seed = 0
    for dtype in (torch.float32, torch.bfloat16):
        for proj in WO_PROJECTIONS:
            for m in WO_ROWS:
                for quant in WO_QUANTS:
                    seed += 1
                    rows.append(_wo_row(dev, flush, proj, m, quant, dtype,
                                        seed))
    for m in (8, 40, 64, 1024):
        seed += 1
        rows.append(_wo_row(dev, flush, "qkv", m, "int8", torch.float16,
                            seed))
    out = {}
    for route, kernel in WO_KERNELS.items():
        proj, m, quant, dtype = WO_HEADLINE[route]
        head, = [r for r in rows if (r["proj"], r["shape"][0], r["quant"],
                                     r["dtype"]) == (proj, m, quant, dtype)]
        mine = [r for r in rows if r["route"] == route]
        out[kernel] = {
            **{k: head[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "dequant_linear_ms", "shape",
                                    "stream_ms", "library_stream_ms")},
            "max_rel_err": max(r["max_rel_err"] for r in mine),
            "library": "torch.nn.functional.linear over the bf16 weight",
            "config": f"{proj} {quant} {dtype} x",
            "row_keys": WO_ROW_KEYS,
            "rows": [[r["shape"][0] if k == "m" else r[k]
                      for k in WO_ROW_KEYS] for r in mine]}
    return out


DECODE_LANE = dict(prompt=128, new=64, batches=(1, 8))
SPEC_K = 4                      # phase 18's proposals a dispatch


def _decode_run(model, kind, bs, ids, cache_dtype, draft=None):
    """bench.py ``run_decode_config``'s timing of one (model, cache,
    batch), plain or speculative (``draft``, k = `SPEC_K`): a cold
    ``generate(ids, 2)`` (which captures the prompt bucket's graph and
    the decode or spec graph), ``generate(ids, 1)`` (TTFT), then
    ``generate(ids, new)`` with the weight-only and paged counters
    zeroed just before and read just after; graph counts after each;
    peak memory over the three. Returns (stats, tokens, engine)."""
    from paddle_tpu_torch.jit import GenerationEngine
    from paddle_tpu_torch.ops.kernels import weight_only as wo

    new = DECODE_LANE["new"]
    extra = {} if draft is None else dict(draft_model=draft, spec_k=SPEC_K)
    eng = GenerationEngine(model, kind=kind, batch=bs,
                           max_len=DECODE_LANE["prompt"] + new,
                           cache_dtype=cache_dtype, **extra)
    step = eng.decode_step if draft is None else eng.spec_step

    def graphs():
        return (eng.prefill_step.trace_count, step.trace_count)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.generate(ids, 2)
    torch.cuda.synchronize()
    cold, captures = time.perf_counter() - t0, [graphs()]
    t0 = time.perf_counter()
    eng.generate(ids, 1)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    for route in WO_KERNELS:
        setattr(wo.weight_only_linear, f"launches_{route}", 0)
    _paged_reset()
    t0 = time.perf_counter()
    toks = eng.generate(ids, new)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    captures.append(graphs())
    t = toks.numpy()
    if not (t.shape == (bs, new) and (t >= 0).all()
            and (t < model.config.vocab_size).all()):
        raise AssertionError(f"decode lane {kind} bs{bs}: bad tokens "
                             f"{t.shape}")
    if not (captures == [(1, 1), (1, 1)]
            and eng.prefill_step.cache_size() == 1
            and step.cache_size() == 1):
        raise AssertionError(
            f"decode lane {kind} bs{bs} draft {draft is not None}: (prompt, "
            f"step) captures {captures}, graphs "
            f"{eng.prefill_step.cache_size()}, {step.cache_size()}: one "
            f"each, in the warm-up")
    paged = {k: n for k, n in _paged_launches().items() if n}
    r = {"decode_tok_s": bs * (new - 1) / max(total - ttft, 1e-9),
         "prefill_ttft_ms": ttft * 1e3, "cold_start_ms": cold * 1e3,
         "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
         **{f"launches_{route}": getattr(wo.weight_only_linear,
                                         f"launches_{route}")
            for route in WO_KERNELS},
         "launches_paged": paged,
         "prefill_graphs": eng.prefill_step.cache_size(),
         "decode_graphs": step.cache_size(), "captures": captures[-1]}
    if draft is not None:
        st = eng.spec_stats
        r.update(dispatches=st["dispatches"],
                 tokens_per_dispatch=st["emitted"] / max(
                     st["dispatches"] * bs, 1),
                 accept_rate=st["accepted"] / max(st["proposed"], 1),
                 launches_per_dispatch={k: n / st["dispatches"]
                                        for k, n in paged.items()})
    return r, t, eng


def _dequantized_twin(qmodel, cfg, dev, dtype):
    """A fp model whose Linears hold ``weight_dequantize`` of the
    quantized model's weights (the same function through ``F.linear``),
    with the quantized model's other parameters (biases among them)."""
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.nn.quant import WeightOnlyLinear, weight_dequantize

    twin = GPTForCausalLM(cfg, device=dev, dtype=dtype, seed=0)
    twin.eval()
    mods = dict(twin.named_modules())
    with torch.no_grad():
        for name, mod in qmodel.named_modules():
            if isinstance(mod, WeightOnlyLinear):
                lin = mods[name]
                lin.weight.copy_(weight_dequantize(
                    mod.quant_weight, mod.weight_scale, out_dtype=dtype).t())
        sd = {k: v for k, v in qmodel.state_dict().items()
              if "quant_weight" not in k and "weight_scale" not in k}
        twin.load_state_dict(sd, strict=False)
    return twin


def _tiny_int8_dense_parity(dev):
    """The int8 dense decode on the card (graphs) gives the CPU port's
    greedy tokens on a tiny model (phase 4's weights)."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn.quant import quantize_for_decode

    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                    num_attention_heads=4, max_position_embeddings=128,
                    tie_word_embeddings=False)
    cpu = GPTForCausalLM(cfg, device="cpu")
    rng = np.random.default_rng(0)
    sd = {name: torch.from_numpy(
              (rng.standard_normal(tuple(t.shape)) * 0.3).astype(np.float32))
          for name, t in cpu.state_dict().items()}
    cpu.load_state_dict(sd)
    card = GPTForCausalLM(cfg, device=dev)
    card.load_state_dict(sd)
    quantize_for_decode(cpu)
    quantize_for_decode(card)
    ids = rng.integers(1, 128, (4, 24))
    want = cpu.generate(ids, 16).numpy()
    got = card.generate(ids, 16).numpy()
    if not np.array_equal(got, want):
        raise AssertionError(f"tiny int8 dense decode: card {got.tolist()} "
                             f"vs cpu {want.tolist()}")
    say(f"[17/{PHASES}] decode lane: tiny int8 GPT (untied head), dense "
          f"greedy tokens {got.size} identical on the card (graphs) and the "
          f"CPU", flush=True)


def decode_lane(dev):
    """Phase 17: ``bench.py``'s decode lane (``run_decode_config``) at
    GPT-3 1.3B width (24 layers, random weights from seed 0, prompt 128,
    64 new tokens, batch 1 and 8, greedy), over the dense cache, the
    paged cache and the dense cache with ``quantize_for_decode`` int8
    weights; in the reference's fp32 (weights and cache), then bf16
    weights over a bf16 cache. Each run captures one prompt graph and
    one decode graph in its warm-up call and none after; the int8 runs
    launch the weight-only kernel on both routes (once a projection a
    prompt pass and a decode step), the fp runs never. At batch 1 and 8
    the int8 model is held to its twin that holds ``weight_dequantize``
    of its weights: in fp32 its logits within 2e-4, in bf16 its greedy
    tokens up to each row's first divergence (`_divergence_gaps`). The
    fp32 int8 runs take the
    first design (``gemv`` / ``tiled``), the bf16 ones the Hopper routes
    (``mma`` / ``wgmma``), and no other route launches. Returns {route:
    launches} over the int8 runs' timed calls, and {route: decode steps
    or prompt passes} those took."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_config
    from paddle_tpu_torch.nn.quant import quantize_for_decode

    _tiny_int8_dense_parity(dev)
    prompt, new = DECODE_LANE["prompt"], DECODE_LANE["new"]
    cfg = gpt_config("gpt3-1.3b", max_position_embeddings=prompt + new)
    per_pass = 4 * cfg.num_layers          # the quantized projections
    launches = dict.fromkeys(WO_KERNELS, 0)
    passes = dict.fromkeys(WO_KERNELS, 0)
    rng = np.random.default_rng(0)
    ids = {bs: rng.integers(1, cfg.vocab_size, (bs, prompt))
           for bs in DECODE_LANE["batches"]}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        models = {"fp": GPTForCausalLM(cfg, device=dev, dtype=dtype, seed=0),
                  "int8": quantize_for_decode(
                      GPTForCausalLM(cfg, device=dev, dtype=dtype, seed=0))}
        for m in models.values():
            m.eval()
        for bs in DECODE_LANE["batches"]:
            for kind, tag in (("dense", "fp"), ("paged", "fp"),
                              ("dense", "int8")):
                r, _, _ = _decode_run(models[tag], kind, bs, ids[bs], dtype)
                step, prompt = ("gemv", "tiled") if dtype == torch.float32 \
                    else ("mma", "wgmma")
                want = dict.fromkeys(WO_KERNELS, 0)
                if tag == "int8":
                    want.update({step: per_pass * (new - 1),
                                 prompt: per_pass})
                got = {k: r[f"launches_{k}"] for k in WO_KERNELS}
                if got != want:
                    raise AssertionError(
                        f"decode lane {name} {kind} {tag} bs{bs}: weight-only "
                        f"launches {got}, want {want}")
                if tag == "int8":
                    for k in WO_KERNELS:
                        launches[k] += got[k]
                    passes[step] += new - 1
                    passes[prompt] += 1
                say(f"[17/{PHASES}] decode lane gpt3-1.3b {name} "
                      f"{kind}{'_int8' if tag == 'int8' else ''} bs{bs}: "
                      f"{json.dumps(r)}", flush=True)
        twin = _dequantized_twin(models["int8"], cfg, dev, dtype)
        steps = min(16, new)
        for bs in DECODE_LANE["batches"]:
            got_t, got_l = models["int8"].generate(ids[bs], steps,
                                                   return_logits=True)
            want_t, want_l = twin.generate(ids[bs], steps,
                                           return_logits=True)
            # steps up to the first token that differs share a context
            same = (got_t == want_t).numpy()
            first = same.all(0)
            upto = int(np.argmin(first)) + 1 if not first.all() else steps
            err = float((got_l[:, :upto] - want_l[:, :upto]).abs().max())
            label = f"decode lane {name} int8 bs{bs}"
            gaps = (_divergence_gaps(label, same, want_l)
                    if dtype == torch.bfloat16 else [])
            say(f"[17/{PHASES}] {label} vs its weight_dequantize twin "
                  f"(F.linear), {steps} tokens: logits max abs diff "
                  f"{err:.3g} over {upto} steps, tokens equal "
                  f"{bool(same.all())}, top-2 gaps at divergences {gaps}",
                  flush=True)
            if dtype == torch.float32 and not err <= 2e-4:
                raise AssertionError(f"{label}: logits differ from the "
                                     f"dequantized model's by {err} > 2e-4")
        del twin
        for m in models.values():
            m.__dict__.pop("_generation_engines", None)
        del models
        gc.collect()
        torch.cuda.empty_cache()
    return launches, passes


# ---------------------------------------------------------------------------
# phase 18: speculative decoding
# ---------------------------------------------------------------------------

# bf16 greedy tokens of the spec engine and of plain decoding may part
# where the plain logits' two best are closer than the products' rounding
# (the verify scores k + 1 rows a slot in one product, the plain decode
# one): the largest top-2 gap allowed at a first divergence. A flip needs
# the two rows' logits to differ by half the gap at least; each call
# prints that difference over the rows both runs share
# (``logits_max_abs_diff``: 0.03125-0.0625 at GPT-3 1.3B width, one bf16
# ulp of logits of 4-16, over phase 18's four bf16 runs, none of which
# diverged), so the bar is twice the largest. Phase 17 holds the bf16
# int8 lane to its weight_dequantize twin by the same bar
BF16_GAP_BAR = 0.125


def _divergence_gaps(label, same, logits):
    """The reference ``logits``' top-2 gap at each row's first divergence
    (``same``: [rows, steps], tokens equal to the reference's); raises if
    one is at or over `BF16_GAP_BAR`."""
    top2 = logits.topk(2, dim=-1).values
    gaps = []
    for row in range(same.shape[0]):
        if same[row].all():
            continue
        t = int(np.argmin(same[row]))
        gaps.append(float(top2[row, t, 0] - top2[row, t, 1]))
    if gaps and max(gaps) >= BF16_GAP_BAR:
        raise AssertionError(f"{label}: a divergence where the reference "
                             f"top-2 gap is {max(gaps)} >= {BF16_GAP_BAR}")
    return gaps


def _spec_tiny(dev):
    """(a) `spec_decode_selftest.run_probe` on the CPU and on the card:
    each passes (spec tokens = the same device's plain tokens, one spec
    graph an engine on the card, the strong pair's dispatch count,
    serving parity and no leak) and every case's tokens agree."""
    from paddle_tpu_torch.inference.spec_decode_selftest import run_probe

    cpu, card = run_probe("cpu"), run_probe(dev)
    for where, rec in (("cpu", cpu), ("card", card)):
        if rec["check"] != "pass":
            raise AssertionError(f"spec probe on the {where}: "
                                 f"{json.dumps({k: v for k, v in rec.items() if k != 'tokens'})}")
    differ = [k for k in cpu["tokens"] if cpu["tokens"][k] != card["tokens"][k]]
    if differ:
        raise AssertionError(f"spec probe: card tokens differ from the CPU's "
                             f"in {differ}")
    say(f"[18/{PHASES}] spec decoding, tiny fp32 GPT: greedy spec tokens of "
          f"{len(cpu['tokens'])} cases (weak draft, self-draft, strong pair "
          f"over dense, paged, int8, int4; serving over fp, int8, int4 with "
          f"the strong pair) equal on the card (graphs) and the CPU and to "
          f"each device's plain decoding; "
          f"{json.dumps({k: v for k, v in card.items() if k != 'tokens'})}",
          flush=True)


def _spec_lane_case(label, tgt, drf, kind, bs, ids, dtype):
    """One (target, draft, cache, batch) of phase 18 (b): spec against
    plain decoding through `_decode_run`; fp32 tokens identical to plain,
    bf16 identical up to each row's first divergence, where the plain
    logits' top-2 gap must be under `BF16_GAP_BAR`. Prints one line;
    returns the spec run's stats."""
    new = DECODE_LANE["new"]
    name = str(dtype)[6:]
    plain, want, peng = _decode_run(tgt, kind, bs, ids, dtype)
    spec, got, seng = _decode_run(tgt, kind, bs, ids, dtype, drf)
    same = got == want
    spec["tokens_equal_to_plain"] = bool(same.all())
    if dtype == torch.float32 and not same.all():
        raise AssertionError(
            f"spec lane {label} fp32 {kind} bs{bs}: tokens differ from plain "
            f"decoding at {np.argwhere(~same).tolist()}")
    # the two engines' logits over the steps every row shares
    _, lg = peng.generate(ids, new, return_logits=True)
    _, slg = seng.generate(ids, new, return_logits=True)
    upto = int(np.argmin(same.all(0))) if not same.all() else new
    spec["logits_max_abs_diff"] = float(
        (lg[:, :upto] - slg[:, :upto]).abs().max()) if upto else None
    if not same.all():
        spec["divergence_top2_gaps"] = _divergence_gaps(
            f"spec lane {label} bf16 {kind} bs{bs}", same, lg)
    spec["speedup"] = spec["decode_tok_s"] / plain["decode_tok_s"]
    say(f"[18/{PHASES}] spec lane gpt3-1.3b {label} {name} {kind} bs{bs}: "
          f"plain {json.dumps(plain)}; spec {json.dumps(spec)}", flush=True)
    return spec


def _spec_generate(dev):
    """(b) GPT-3 1.3B width, k = 4, prompt 128, 64 new tokens, fp32 and
    bf16, dense and paged (`_spec_lane_case`): the strong pair at batch 1
    and 8 (spec against plain decode tok/s, accept rate, tokens a
    dispatch, no capture after the warm-up call), and at batch 8 the
    random target, unmodified, as its own draft. The strong pair's blocks
    1-23 add nothing to the residual stream, so only the second holds the
    verify's products through the full depth against plain decoding: its
    draft decodes are plain decoding's, so a verify row that rounds to
    another argmax is a rejection and a token that differs."""
    from paddle_tpu_torch.inference.spec_decode_selftest import strong_pair
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_config

    prompt, new = DECODE_LANE["prompt"], DECODE_LANE["new"]
    cfg = gpt_config("gpt3-1.3b", max_position_embeddings=prompt + new)
    rng = np.random.default_rng(0)
    ids = {bs: rng.integers(1, cfg.vocab_size, (bs, prompt))
           for bs in DECODE_LANE["batches"]}
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        tgt, drf = strong_pair(cfg, device=dev, dtype=dtype)
        for bs in DECODE_LANE["batches"]:
            for kind in ("dense", "paged"):
                out[(name, kind, bs)] = _spec_lane_case(
                    "strong pair", tgt, drf, kind, bs, ids[bs], dtype)
        del tgt, drf
        gc.collect()
        rnd = GPTForCausalLM(cfg, device=dev, dtype=dtype, seed=0).eval()
        bs = max(DECODE_LANE["batches"])
        for kind in ("dense", "paged"):
            out[("random_self", name, kind, bs)] = _spec_lane_case(
                "random target as its own draft", rnd, rnd, kind, bs,
                ids[bs], dtype)
        del rnd
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _spec_serve(dev, model, kv_quant, draft, per_dispatch, per_chunk):
    """Phase 5's traffic through a speculative engine (greedy, graphs)
    after `warmup()`: the paged counters zeroed just before the run and
    read just after must equal ``per_dispatch`` times the spec dispatches
    plus ``per_chunk`` times the chunk calls, every other one 0; no
    capture after `warmup()`; no leak."""
    from paddle_tpu_torch.serving import ServingEngine

    cfg = model.config
    eng = ServingEngine(model, max_slots=8, max_len=1024, page_size=16,
                        chunk_size=64, prefill_batch=4,
                        cache_dtype=torch.bfloat16, kv_quant=kv_quant,
                        draft_model=draft, spec_k=SPEC_K, device=dev)
    eng.warmup()
    counts = eng.compile_counts()
    eng.prefill_step.calls = eng.spec_step.calls = 0
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 769, 16)
    budgets = rng.integers(32, 129, 16)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in lens]
    gc.collect()
    torch.cuda.synchronize()
    _paged_reset()
    t0 = time.perf_counter()
    handles = [eng.submit(p, int(n)) for p, n in zip(prompts, budgets)]
    snap = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _paged_launches()
    d, c = eng.spec_step.calls, eng.prefill_step.calls
    want = {k: per_dispatch.get(k, 0) * d + per_chunk.get(k, 0) * c
            for k in launches}
    if launches != want:
        raise AssertionError(f"spec serve {kv_quant}: launches {launches}, "
                             f"want {want} ({d} dispatches, {c} chunks)")
    # the run's own launches a dispatch: the chunk calls' share taken out
    measured = {k: (n - per_chunk.get(k, 0) * c) / d
                for k, n in launches.items()}
    measured = {k: v for k, v in measured.items() if v}
    for h, n in zip(handles, budgets):
        if not (h.done and len(h.output_tokens) == n):
            raise AssertionError(f"spec serve: request {h.request.rid} "
                                 f"{len(h.output_tokens)} of {n} tokens")
    lk = eng.leak_check()
    if lk["free_pages"] != lk["total_pages"] or \
            lk["free_slots"] != lk["total_slots"]:
        raise AssertionError(f"spec serve: leaked {lk}")
    if eng.compile_counts() != counts or counts["decode_traces"] != 1:
        raise AssertionError(f"spec serve captures: {counts} after warmup(), "
                             f"{eng.compile_counts()} after the run")
    stats = {"kv_quant": kv_quant, "wall_s": wall,
             "output_tok_s": snap["generated_tokens"] / wall,
             "generated_tokens": snap["generated_tokens"],
             "itl_p50_s": snap["itl_p50_s"], "itl_p99_s": snap["itl_p99_s"],
             "ttft_p50_s": snap["ttft_p50_s"],
             "accept_rate": snap["spec_accept_rate"],
             "tokens_per_dispatch": snap["spec_tokens_per_dispatch"],
             "dispatches": d, "chunk_calls": c, "compile_counts": counts,
             "warmup_ms": eng.warmup_report["warmup_ms"],
             "launches_per_dispatch": measured,
             "max_memory_reserved": torch.cuda.max_memory_reserved()}
    tokens = [list(h.output_tokens) for h in handles]
    del eng, handles
    gc.collect()
    torch.cuda.empty_cache()
    return stats, tokens, prompts


def _hold_serve_tokens(label, model, kv_quant, prompts, want, got):
    """Spec serving tokens against the plain engine's on the same traffic:
    identical up to each request's first divergence, where the plain
    target's top-2 logit gap (a bf16 prompt pass over the request's
    prompt and the plain tokens before it, on ``kv_quant`` pools) must be
    under `BF16_GAP_BAR`. Returns (share of equal tokens, the gaps)."""
    from paddle_tpu_torch.jit import GenerationEngine

    gaps = []
    for p, w, g in zip(prompts, want, got):
        if len(w) != len(g):
            raise AssertionError(f"spec serve {label}: {len(g)} tokens, "
                                 f"plain {len(w)}")
        diff = [t for t, (a, b) in enumerate(zip(w, g)) if a != b]
        if not diff:
            continue
        ctx = np.concatenate([p, np.asarray(w[:diff[0]], p.dtype)])
        eng = GenerationEngine(model, kind="paged", batch=1, max_len=1024,
                               cache_dtype=torch.bfloat16, kv_quant=kv_quant)
        _, lg = eng.generate(ctx[None], 1, return_logits=True)
        top2 = lg[0, 0].topk(2).values
        gaps.append(float(top2[0] - top2[1]))
        del eng
    if gaps and max(gaps) >= BF16_GAP_BAR:
        raise AssertionError(f"spec serve {label}: a divergence where the "
                             f"plain top-2 gap is {max(gaps)} >= "
                             f"{BF16_GAP_BAR}")
    share = float(np.mean([a == b for x, y in zip(want, got)
                           for a, b in zip(x, y)]))
    return share, gaps


def _spec_serving(dev):
    """(c) phase 5's traffic with the strong pair at GPT-3 1.3B width
    (bf16 and int8 pools) and with ``draft_model="self"`` on the zero
    target (bf16 pools), each beside the plain engine of the same target:
    output tok/s, the accept-rate gauge, no capture after `warmup()`,
    exact launches a dispatch (a draft dispatch: k + 1 one-layer decodes
    on the draft's bf16 pools and one 24-layer verify; a self-draft
    dispatch: one 24-layer decode and one verify, both on the target's
    pools; a chunk call: 24 target layers, and 1 for a separate draft's
    pools); the strong pair's tokens held to plain serving's by
    `_hold_serve_tokens`, the zero target's equal to plain serving's
    (every logit is 0: token 0 throughout). Returns {kernel: launches a
    dispatch, as this run measured them}."""
    from paddle_tpu_torch.inference.spec_decode_selftest import (
        strong_pair, zero_self_target)
    from paddle_tpu_torch.models import gpt_config

    cfg = gpt_config("gpt3-1.3b")
    n_l, k1 = cfg.num_layers, SPEC_K + 1
    split, wg = "paged_decode_split_kernel", "paged_chunk_wgmma_kernel"
    tgt, drf = strong_pair(cfg, device=dev, dtype=torch.bfloat16)
    per_dispatch = {}
    for quant in (None, "int8"):
        verify = wg if quant is None else f"{wg}[int8]"
        pd = {split: k1, verify: n_l}
        pc = {verify: n_l}
        pc[wg] = pc.get(wg, 0) + 1                  # the draft's chunk
        plain, plain_tokens, _ = _serve_run(dev, tgt, quant, True)
        spec, tokens, prompts = _spec_serve(dev, tgt, quant, drf, pd, pc)
        spec["tokens_equal_to_plain_share"], \
            spec["divergence_top2_gaps"] = _hold_serve_tokens(
                f"strong pair {quant or 'bf16'}", tgt, quant, prompts,
                plain_tokens, tokens)
        spec["speedup"] = spec["output_tok_s"] / plain["output_tok_s"]
        say(f"[18/{PHASES}] spec serve gpt3-1.3b strong pair "
              f"{quant or 'bf16'} pools: plain output tok/s "
              f"{plain['output_tok_s']}; spec {json.dumps(spec)}", flush=True)
        per_dispatch.update(spec["launches_per_dispatch"])
    del tgt, drf
    gc.collect()
    torch.cuda.empty_cache()
    ztgt = zero_self_target(SPEC_K, cfg, device=dev, dtype=torch.bfloat16)
    plain, plain_tokens, _ = _serve_run(dev, ztgt, None, True)
    pd = {split: n_l, wg: n_l}
    spec, tokens, _ = _spec_serve(dev, ztgt, None, "self", pd, {wg: n_l})
    spec["speedup"] = spec["output_tok_s"] / plain["output_tok_s"]
    say(f"[18/{PHASES}] spec serve gpt3-1.3b zero target, draft_model="
          f"'self', bf16 pools: plain output tok/s {plain['output_tok_s']}; "
          f"spec {json.dumps(spec)}", flush=True)
    if spec["accept_rate"] != 1.0:
        raise AssertionError(f"zero target self-draft accept rate "
                             f"{spec['accept_rate']} != 1.0")
    if [list(t) for t in plain_tokens] != tokens or \
            any(any(t) for t in tokens):
        raise AssertionError("zero target self-draft: tokens are not plain "
                             "serving's, all 0")
    del ztgt
    gc.collect()
    torch.cuda.empty_cache()
    return per_dispatch


def spec_decode(dev):
    """Phase 18: speculative decoding, (a) the tiny probe card against
    CPU, (b) `generate()` at GPT-3 1.3B width, (c) serving. Returns
    {kernel: launches a serving spec dispatch} for the kernels line."""
    t0 = time.perf_counter()
    _spec_tiny(dev)
    _spec_generate(dev)
    per_dispatch = _spec_serving(dev)
    say(f"[18/{PHASES}] spec decoding done in {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    return per_dispatch


# ---------------------------------------------------------------------------
# phase 20: BERT (masked attention and dropout); phase 21: LeNet through
# paddle.Model
# ---------------------------------------------------------------------------

# phase 20(a)'s small BERT: card against CPU in fp32
BERT_SMALL = dict(vocab_size=512, hidden_size=64, num_layers=2,
                  num_attention_heads=4, max_position_embeddings=128,
                  hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def _padded_tokens(rng, batch, seq, vocab, low):
    """Random ids and a 1/0 padding mask of random lengths in [low,
    seq], as CPU tensors."""
    ids = rng.integers(0, vocab, (batch, seq))
    lengths = rng.integers(low, seq + 1, (batch,))
    mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.int64)
    return torch.from_numpy(ids), torch.from_numpy(mask)


def _bert_step(model, lr, **kw):
    """(optimizer, step): AdamW(lr) and ``TrainStep`` over
    ``CrossEntropyLoss`` of the fine-tune head."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW

    crit = CrossEntropyLoss()
    opt = AdamW(learning_rate=lr, parameters=model.parameters(), **kw)
    return opt, TrainStep(model, lambda m, i, k, y: crit(
        m(i, attention_mask=k), y), opt)


def bert_parity(dev):
    """Phase 20(a-b): the small fp32 BERT (``BERT_SMALL``: hidden 64, 2
    layers, 4 heads) at batch 4 x seq 64 under padding masks of lengths
    17-64, card against CPU: both heads' logits within 1e-4; 3 AdamW(1e-3)
    ``TrainStep``s of the fine-tune head, each from the CPU's state after
    one CPU step (Adam's first step turns summation noise into lr-sized
    moves), losses 1e-4 and parameters 1e-3 rel, ``mt_adam_kernel`` and
    no other kernel of the port's; then on the card a row's pooled output
    within 1e-5 when its padded tokens change."""
    from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                         BertForSequenceClassification)

    cfg = BertConfig(**BERT_SMALL)
    rng = np.random.default_rng(20)
    ids, mask = _padded_tokens(rng, 4, 64, cfg.vocab_size, 17)
    report = {"nvidia_smi": nvidia_smi()}
    for cls in (BertForSequenceClassification, BertForPretraining):
        cpu = cls(cfg, device="cpu", seed=1).eval()
        card = cls(cfg, device=dev, seed=1).eval()
        card.load_state_dict(cpu.state_dict())
        with torch.no_grad():
            want = cpu(ids, attention_mask=mask)
            got = card(ids.to(dev), attention_mask=mask.to(dev))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        report[f"{cls.__name__}_logits_max_abs_err"] = max(
            _max_err(g.cpu(), w) for g, w in zip(got, want))
    batches = [(*_padded_tokens(rng, 4, 64, cfg.vocab_size, 17),
                torch.from_numpy(rng.integers(0, 2, (4,))))
               for _ in range(4)]
    runs = {}
    for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
        model = BertForSequenceClassification(cfg, device=d, seed=1)
        runs[where] = (model, *_bert_step(model, 1e-3), d)
    cpu_model, cpu_opt, cpu_step, _ = runs["cpu"]
    cpu_step(*batches[0])                               # the moments
    zero, read = _port_counters()
    losses, loss_err, rel, worst = {"card": [], "cpu": []}, 0.0, 0.0, ""
    for batch in batches[1:]:
        card_model, card_opt = runs["card"][:2]
        card_model.load_state_dict(cpu_model.state_dict())
        card_opt.set_state_dict(cpu_opt.state_dict())
        zero()
        for where, (_, _, step, d) in runs.items():
            losses[where].append(float(step(*(t.to(d) for t in batch))))
        _check_launches(read(), ("mt_adam_kernel",), "bert parity")
        loss_err = max(loss_err, abs(losses["card"][-1]
                                     - losses["cpu"][-1]))
        want = cpu_model.state_dict()
        rel, worst = max((rel, worst), max(
            (_rel_err(t.cpu(), want[k]), k)
            for k, t in card_model.state_dict().items()))
    report.update({"losses_card": losses["card"], "losses_cpu": losses["cpu"],
                   "max_loss_diff": loss_err, "params_max_rel_diff": rel,
                   "worst": worst})
    card_model.eval()
    moved = ids.clone()
    row, length = int(mask.sum(1).argmin()), int(mask.sum(1).min())
    moved[row, length:] = (moved[row, length:] + 7) % cfg.vocab_size
    with torch.no_grad():
        a = card_model.bert(ids.to(dev), attention_mask=mask.to(dev))[1]
        b = card_model.bert(moved.to(dev), attention_mask=mask.to(dev))[1]
    report["padding_pooled_max_abs_diff"] = _max_err(a[row], b[row])
    report["padding_row_length"] = length
    say(f"[20/{PHASES}] bert parity: fp32 {BERT_SMALL}, batch 4 x 64, "
          f"padding lengths 17-64: {json.dumps(report)}", flush=True)
    for cls in ("BertForSequenceClassification", "BertForPretraining"):
        if not report[f"{cls}_logits_max_abs_err"] <= 1e-4:
            raise AssertionError(f"bert {cls}: card/CPU logits differ by "
                                 f"{report[f'{cls}_logits_max_abs_err']}")
    if not (loss_err <= 1e-4 and rel <= 1e-3):
        raise AssertionError(f"bert: card/CPU losses differ by {loss_err}, "
                             f"params by {rel} rel ({worst})")
    if not report["padding_pooled_max_abs_diff"] <= 1e-5:
        raise AssertionError("bert: padded tokens reach the pooled output: "
                             f"{report['padding_pooled_max_abs_diff']}")


def dropout_contract(dev, shape=(8, 128, 12, 64), p=0.1):
    """Phase 20(c): SDPA with ``dropout_p`` on ``shape`` on the card, each
    draw from a ``torch.Generator`` on the card: the kept share of the
    ``b * h * s * s`` probabilities within 4 sigma of ``1 - p``; the same
    seed bit-identical twice, another seed different; ``training=False``
    equal to ``dropout_p=0`` bit for bit (on random q, k, v)."""
    from paddle_tpu_torch.nn import functional as PF

    b, s, h, d = shape
    zeros = torch.zeros(shape, device=dev)
    # V[k, j] = 1 where j == k mod d: column j sums keys j and j + d
    v = torch.eye(d, device=dev).repeat(s // d, 1)[None, :, None, :] \
        .expand(b, s, h, d).contiguous()

    def run(seed, q=zeros, k=zeros, vv=v, **kw):
        g = torch.Generator(device=dev).manual_seed(seed)
        return PF.scaled_dot_product_attention(q, k, vv, dropout_p=p,
                                               generator=g, **kw)

    # a kept probability is 1 / (s (1 - p)): each output element counts
    # the kept ones of its column's keys
    kept = int(torch.round(run(0).double() * (s * (1.0 - p))).sum())
    total = b * h * s * s
    share = kept / total
    sigma = (p * (1 - p) / total) ** 0.5
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, vr = (torch.randn(shape, device=dev, generator=gen)
                for _ in range(3))
    same = torch.equal(run(5, q, k, vr), run(5, q, k, vr))
    differs = not torch.equal(run(5, q, k, vr), run(6, q, k, vr))
    off = torch.equal(run(5, q, k, vr, training=False),
                      PF.scaled_dot_product_attention(q, k, vr))
    report = {"shape": list(shape), "dropout_p": p, "kept_share": share,
              "sigma": sigma, "deviation_sigmas": abs(share - (1 - p))
              / sigma, "same_seed_bit_identical": same,
              "other_seed_differs": differs,
              "training_false_equals_p0": off, "nvidia_smi": nvidia_smi()}
    say(f"[20/{PHASES}] dropout contract on the card: "
          f"{json.dumps(report)}", flush=True)
    if not abs(share - (1 - p)) < 4 * sigma:
        raise AssertionError(f"dropout kept share {share}, want {1 - p} "
                             f"within 4 sigma ({sigma})")
    if not (same and differs and off):
        raise AssertionError(f"dropout determinism: {report}")


def bert_full_width(dev, warmup=2, timed=5, batch=32, seq=128):
    """Phase 20(d): BERT-base fine-tune at full width (``bert_config(
    "bert-base")``: hidden 768, 12 layers, 12 heads, vocab 30522; 2
    classes), hidden and attention dropout 0.1, ``amp.decorate(level=
    "O2")`` in bf16, AdamW(2e-5) with fp32 masters, through ``TrainStep``,
    ``batch`` x ``seq`` random tokens under padding masks of random
    lengths 32-``seq`` from seed 0: ``warmup`` + ``timed`` steps. The port's
    kernel counters are zeroed just before the timed steps and read just
    after: two ``mt_adam_kernel`` a step (one a dtype group: the bf16
    weights with their fp32 masters, the LayerNorms' fp32 parameters)
    and no other kernel of the port's (the attention is the dense path:
    aten ops, as the reference's XLA). Every loss finite, the first
    within 0.5 of ln 2 (the head's XavierUniform init gives logits of
    about unit spread, so the first loss sits above ln 2: ln 2 + var / 8
    on average), the LayerNorms fp32 after ``decorate``. Returns the
    launches and the step count."""
    from paddle_tpu_torch.amp import decorate
    from paddle_tpu_torch.models import (BertForSequenceClassification,
                                         bert_config)
    from paddle_tpu_torch.nn import LayerNorm

    cfg = bert_config("bert-base")
    before = torch.cuda.memory_allocated()
    model = BertForSequenceClassification(cfg, num_classes=2, device=dev,
                                          seed=0)
    opt, step = _bert_step(model, 2e-5, multi_precision=True)
    decorate(models=model, optimizers=opt, level="O2")
    norms = {str(m.weight.dtype) for m in model.modules()
             if isinstance(m, LayerNorm)}
    rng = np.random.default_rng(0)
    ids, mask = _padded_tokens(rng, batch, seq, cfg.vocab_size, 32)
    labels = torch.from_numpy(rng.integers(0, 2, (batch,)))
    ids, mask, labels = ids.to(dev), mask.to(dev), labels.to(dev)
    losses = [float(step(ids, mask, labels)) for _ in range(warmup)]
    zero, read = _port_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero()
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        loss = step(ids, mask, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = read()
    peak = torch.cuda.max_memory_allocated()
    h, layers = cfg.hidden_size, cfg.num_layers
    encoder = sum(p.numel() for p in model.bert.encoder.parameters())
    tokens = batch * seq
    # 6 x the encoder's parameters x every position (the embeddings are
    # lookups; the pooler and the head see one position a row), plus the
    # dense attention's two products over the whole [seq, seq] square,
    # forward and backward: 3 x 2 x 2 x batch x seq^2 x hidden a layer
    flops = 6.0 * encoder * tokens + 12.0 * layers * batch * seq * seq * h
    step_s = statistics.median(times)
    per_step = {k: n / timed for k, n in launches.items() if n}
    stats = {
        "model": "bert-base", "hidden": h, "layers": layers,
        "heads": cfg.num_attention_heads, "vocab": cfg.vocab_size,
        "classes": 2, "batch": batch, "seq": seq,
        "padding_lengths": [int(mask.sum(1).min()), int(mask.sum(1).max())],
        "dropout": [cfg.hidden_dropout_prob, cfg.attention_dropout_prob],
        "dtype": "bfloat16 via amp.decorate O2 (fp32 masters)",
        "layer_norm_dtypes": sorted(norms),
        "optimizer": "AdamW(2e-5, multi_precision)",
        "attention": "dense (attn_mask, dropout 0.1), as the reference",
        "params": sum(p.numel() for p in model.parameters()),
        "encoder_params": encoder, "losses": losses,
        "step_ms": [t * 1e3 for t in times], "step_ms_median": step_s * 1e3,
        "samples_per_s": batch / step_s, "tokens_per_s": tokens / step_s,
        "train_flops_per_step": flops,
        "mfu": flops / step_s / BF16_FLOP_PER_S,
        "max_memory_allocated": peak, "memory_allocated_before": before,
        "launches": {k: n for k, n in launches.items() if n},
        "launches_per_step": per_step, "nvidia_smi": nvidia_smi(),
    }
    say(f"[20/{PHASES}] train bert-base (fine-tune): {json.dumps(stats)}",
          flush=True)
    _PHASE_STATS["bert"] = stats
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite bert loss: {losses}")
    if not abs(losses[0] - float(np.log(2.0))) < 0.5:
        raise AssertionError(f"first bert loss {losses[0]} is not near ln 2")
    if norms != {"torch.float32"}:
        raise AssertionError(f"decorate cast a LayerNorm: {norms}")
    if per_step != {"mt_adam_kernel": 2.0}:
        raise AssertionError(f"bert launches a step {per_step}, want two "
                             f"mt_adam_kernel (bf16 with masters, fp32) "
                             f"and nothing else")
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"mt_adam_kernel": launches["mt_adam_kernel"]}, timed


def _lenet_model(dev, seed):
    """A LeNet on ``dev`` under ``paddle_tpu_torch.Model``, prepared with
    Adam(1e-3), CrossEntropyLoss and Accuracy."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision.models import LeNet

    net = LeNet(device=dev, seed=seed)
    model = pt.Model(net)
    model.prepare(Adam(learning_rate=1e-3, parameters=net.parameters()),
                  CrossEntropyLoss(), Accuracy())
    return model


def lenet_parity(dev):
    """Phase 21(a): LeNet through ``Model.train_batch`` on the card and on
    the CPU, the card loading the CPU's weights and Adam state before each
    step, the reference's synthetic MNIST
    in order (``shuffle=False``), batch 64: 3 steps, each from the CPU's
    state after one CPU step, losses 1e-4 and parameters 1e-3 rel (cuDNN
    sums in another order); ``mt_adam_kernel`` and no other kernel of the
    port's."""
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision.datasets import MNIST

    models = {"cpu": _lenet_model(torch.device("cpu"), 0),
              "card": _lenet_model(dev, 0)}
    batches = list(DataLoader(MNIST(mode="train"), batch_size=64))[:4]
    cpu = models["cpu"]
    cpu.train_batch(*batches[0])                        # the moments
    zero, read = _port_counters()
    losses, loss_err, rel = {"card": [], "cpu": []}, 0.0, 0.0
    for x, y in batches[1:]:
        card = models["card"]
        card.network.load_state_dict(cpu.network.state_dict())
        card._optimizer.set_state_dict(cpu._optimizer.state_dict())
        zero()
        for where, m in models.items():
            (loss,), _ = m.train_batch([x], [y])
            losses[where].append(loss)
        _check_launches(read(), ("mt_adam_kernel",), "lenet parity")
        loss_err = max(loss_err, abs(losses["card"][-1]
                                     - losses["cpu"][-1]))
        want = cpu.network.state_dict()
        rel = max(rel, max(_rel_err(t.cpu(), want[k]) for k, t in
                           models["card"].network.state_dict().items()))
    report = {"losses_card": losses["card"], "losses_cpu": losses["cpu"],
              "max_loss_diff": loss_err, "params_max_rel_diff": rel,
              "nvidia_smi": nvidia_smi()}
    say(f"[21/{PHASES}] lenet parity (Model.train_batch, batch 64, "
          f"synthetic MNIST in order): {json.dumps(report)}", flush=True)
    if not (loss_err <= 1e-4 and rel <= 1e-3):
        raise AssertionError(f"lenet: card/CPU losses differ by {loss_err}, "
                             f"params by {rel} rel")


def lenet_full_loop(dev, batch=64):
    """Phase 21(b): LeNet through ``Model.fit`` (one epoch of the
    reference's 4096 synthetic MNIST training images, batch 64, verbose
    0) on the card, without and then with ``prefetch=True``, then
    ``evaluate`` and ``predict`` over the 4096 test images: every batch's
    loss finite, ``evaluate``'s ``acc`` equal to a recount from
    ``predict``'s outputs, and ``save`` -> ``load`` into a fresh model
    bit for bit. Prints images/s for both fits, the seconds of evaluate
    and predict, and ``input_pipeline_stats``."""
    import shutil
    import tempfile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.vision.datasets import MNIST

    class Losses(Callback):
        def __init__(self):
            super().__init__()
            self.values = []

        def on_train_batch_end(self, step, logs=None):
            self.values.append(logs["loss"][0])

    train, test = MNIST(mode="train"), MNIST(mode="test")
    model = _lenet_model(dev, 0)
    report = {"train_images": len(train), "test_images": len(test),
              "batch": batch}
    for prefetch in (False, True):
        rec = Losses()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(train, batch_size=batch, epochs=1, verbose=0,
                  prefetch=prefetch, callbacks=[rec])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        key = "fit_prefetch" if prefetch else "fit"
        report[key] = {"wall_s": wall, "images_per_s": len(train) / wall,
                       "steps": len(rec.values),
                       "first_loss": rec.values[0],
                       "last_loss": rec.values[-1],
                       "all_finite": bool(np.isfinite(rec.values).all())}
    stats = model.input_pipeline_stats
    report["input_pipeline_stats"] = {k: stats[k] for k in (
        "depth", "batches", "input_stall_ms", "h2d_ms")}
    t0 = time.perf_counter()
    logs = model.evaluate(test, batch_size=batch, verbose=0)
    report["evaluate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.predict(test, batch_size=batch, stack_outputs=True)[0]
    report["predict_s"] = time.perf_counter() - t0
    recount = float((out.argmax(1) == test.labels).mean())
    report.update({"evaluate": {"loss": logs["loss"][0], "acc": logs["acc"]},
                   "predict_shape": list(out.shape),
                   "acc_recount_from_predict": recount})
    tmp = tempfile.mkdtemp(prefix="lenet_")
    try:
        model.save(os.path.join(tmp, "lenet"))
        again = _lenet_model(dev, 9)
        again.load(os.path.join(tmp, "lenet"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = all(torch.equal(a, b) for a, b in zip(
        again.network.state_dict().values(),
        model.network.state_dict().values()))
    sa, sb = again._optimizer.state_dict(), model._optimizer.state_dict()
    same = same and sa["step"] == sb["step"] and all(
        torch.equal(sa["accumulators"][acc][k], v)
        for acc, store in sb["accumulators"].items()
        for k, v in store.items())
    report["save_load_bit_identical"] = same
    report["nvidia_smi"] = nvidia_smi()
    say(f"[21/{PHASES}] lenet through paddle.Model: {json.dumps(report)}",
          flush=True)
    if not (report["fit"]["all_finite"]
            and report["fit_prefetch"]["all_finite"]
            and np.isfinite(logs["loss"][0])):
        raise AssertionError(f"lenet: non-finite loss: {report}")
    if logs["acc"] != recount:
        raise AssertionError(f"lenet: evaluate's acc {logs['acc']} is not "
                             f"the recount {recount} from predict")
    if stats["batches"] != len(train) // batch:
        raise AssertionError(f"lenet: the prefetcher staged "
                             f"{stats['batches']} batches")
    if not same:
        raise AssertionError("lenet: Model.save/load is not bit-identical")


# ---------------------------------------------------------------------------
# phases 22-23: the dp and sharding axes over torch.distributed
# ---------------------------------------------------------------------------

# the reference's GPT-3 1.3B vocab: a random model's first loss sits at
# ln(vocab)
GPT_VOCAB = 50304
# phase 20(d)'s and phase 14's stats, for phase 23's side-by-side lines
_PHASE_STATS = {}


def _nccl_version():
    v = torch.cuda.nccl.version()
    if isinstance(v, int):
        v = (v // 10000, v // 100 % 100, v % 100) if v >= 10000 else \
            (v // 1000, v // 100 % 10, v % 100)
    return ".".join(str(x) for x in v)


def collectives_world1(dev):
    """Phase 22: a world of one rank over NCCL through
    ``init_parallel_env()`` with no environment set; every collective on
    fp32 and bf16 card tensors held to its one-rank meaning, the
    compressed all-reduce (int8, bf16) bit for bit its plain twin on the
    CPU, a store round trip (`sharding_selftest.check_world1`); then the
    time of a 256 MiB all-reduce and all-gather (a world of one: NCCL's
    copy, the floor of a collective here)."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.distributed.sharding_selftest import check_world1

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_MASTER"):
        if os.environ.get(k):
            raise AssertionError(f"phase 22 needs no world in the "
                                 f"environment; {k} is set")
    t0 = time.perf_counter()
    got = env.init_parallel_env(timeout=120)
    init_s = time.perf_counter() - t0
    if env.get_backend() != "nccl" or got != dev:
        raise AssertionError(f"init_parallel_env: {env.get_backend()} on "
                             f"{got}, want nccl on {dev}")
    res = check_world1(dev)
    x = torch.randn(64 << 20, device=dev)
    out = torch.empty_like(x)
    times = {}
    for name, fn in (("all_reduce", lambda: C.all_reduce(x)),
                     ("all_gather_into", lambda: C.all_gather_into(out, x))):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        torch.cuda.synchronize()
        times[name] = start.elapsed_time(end) / 10
    del x, out
    say(f"[22/{PHASES}] collectives at world 1: backend "
          f"{env.get_backend()}, NCCL {_nccl_version()}, init "
          f"{init_s:.2f} s; {len(res)} checks ok "
          f"({', '.join(sorted(res))}); 256 MiB fp32 ms: "
          f"{json.dumps(times)}; {nvidia_smi()}", flush=True)


def _copy_sharded_state(dst, src):
    """``src``'s shards, moments, masters and step count into ``dst`` (two
    `ShardedFusedScanTrainStep` of one layout; their devices may
    differ)."""
    with torch.no_grad():
        for a, b in zip(dst._s_p + dst._o_p, src._s_p + src._o_p):
            a.copy_(b)
        for sa, sb in zip(dst._s_state + dst._o_state,
                          src._s_state + src._o_state):
            for a, b in zip(sa, sb):
                if a is not None:
                    a.copy_(b)
    dst._opt._step_count = src._opt._step_count


def sharded_scan_parity(dev):
    """Phase 23(a): a tiny fp32 scan GPT (2 layers, hidden 64) through
    ``ShardedFusedScanTrainStep`` on the card (the NCCL world of one) and
    on the CPU (a gloo group of the same rank), both storages, AdamW with
    the global-norm clip and the guard, the fused head: 3 steps, each
    card step from the CPU step's state before it (the shards, moments
    and step count copied). Bars, PERF.md §2's card-against-CPU: losses
    1e-4, the updated shards 1e-3 relative."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.jit import ShardedFusedScanTrainStep
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    seq = 64
    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                    num_attention_heads=4, max_position_embeddings=seq,
                    scan_layers=True)
    rng = np.random.default_rng(3)
    cpu = GPTForCausalLM(cfg, device="cpu")
    sd = {name: torch.from_numpy(
              (rng.standard_normal(tuple(t.shape)) * 0.3).astype(np.float32))
          for name, t in cpu.state_dict().items()}
    ids = rng.integers(0, 128, (4, seq))
    labels = rng.integers(0, 128, (4, seq))
    cpu_group = C.new_group(ranks=[0], backend="gloo")
    out = {}
    for storage in ("replicated", "sharded"):
        steps = {}
        for where, d, group in (("card", dev, None),
                                ("cpu", torch.device("cpu"), cpu_group)):
            model = GPTForCausalLM(cfg, device=d)
            model.load_state_dict(sd)
            opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                        grad_clip=ClipGradByGlobalNorm(1.0))
            steps[where] = (ShardedFusedScanTrainStep(
                model, opt, fused_head=True, param_storage=storage,
                guard_nonfinite=True, numerics=False, group=group),
                [torch.from_numpy(a).to(d) for a in (ids, labels)])
        losses, errs = [], []
        for k in range(3):
            (card, cb), (cpu_, pb) = steps["card"], steps["cpu"]
            if k:
                _copy_sharded_state(card, cpu_)
            lc, lp = float(card(*cb)), float(cpu_(*pb))
            losses.append((lc, lp))
            errs.append((abs(lc - lp), max(
                _rel_err(a.cpu(), b) for a, b in
                zip(card._s_p + card._o_p, cpu_._s_p + cpu_._o_p))))
        out[storage] = {"losses_card_cpu": losses,
                        "max_loss_diff": max(e[0] for e in errs),
                        "max_shard_rel": max(e[1] for e in errs),
                        "collectives_per_step":
                            steps["card"][0].collectives_per_step}
    say(f"[23/{PHASES}] (a) sharded scan card against CPU (tiny fp32 scan "
          f"GPT, 3 steps each from the CPU's state): {json.dumps(out)}; "
          f"{nvidia_smi()}", flush=True)
    for storage, r in out.items():
        if not (r["max_loss_diff"] <= 1e-4 and r["max_shard_rel"] <= 1e-3):
            raise AssertionError(f"sharded scan ({storage}) card/CPU: {r}")


def sharded_full_width(dev, warmup=2, timed=5, batch=8, seq=1024):
    """Phase 23(b): GPT-3 1.3B (``gpt_config("gpt3-1.3b",
    scan_layers=True)``, not cut) through ``ShardedFusedScanTrainStep``
    at phase 14's configuration and batch (fp32 parameters, bf16 compute
    and moments, AdamW(1e-4), no clip, the fused head, one layer a chunk,
    the numerics monitor off) over the NCCL world of one, with each
    storage: ``warmup`` + ``timed`` steps. Step ms, tokens/s, ``mfu``,
    peak memory beside phase 14's ``FusedScanTrainStep`` (monitor off);
    the two storages' losses and parameters bit-identical; every loss
    finite, the first within 0.5 of ln 50304; the training kernels'
    launches a step (counters zeroed just before the timed steps, read
    just after) exactly phase 14's; the collectives a step with each
    bucket's bytes. Returns the replicated run's launches and steps."""
    from paddle_tpu_torch.jit import ShardedFusedScanTrainStep
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt_config)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = gpt_config("gpt3-1.3b", max_position_embeddings=seq,
                     hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                     scan_layers=True)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (batch, seq))).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (batch, seq))).to(dev)
    tokens = batch * seq
    attn = 6 * 2.0 * batch * seq * (seq + 1) / 2 * cfg.hidden_size \
        * cfg.num_layers
    counters = _TrainCounters()
    runs, kept = {}, None
    for storage in ("replicated", "sharded"):
        before = torch.cuda.memory_allocated()
        model = GPTForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
        params = sum(p.numel() for p in model.parameters())
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                    moment_dtype="bfloat16")
        step = ShardedFusedScanTrainStep(
            model, opt, criterion=GPTPretrainingCriterion(),
            fused_head=True, compute_dtype="bfloat16", layer_chunk=1,
            param_storage=storage, numerics=False)
        losses = [float(step(ids, labels)) for _ in range(warmup)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters.zero()
        times = []
        for _ in range(timed):
            t0 = time.perf_counter()
            loss = step(ids, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
        launches = counters.read()
        step_s = statistics.median(times)
        coll = dict(step.collectives_per_step)
        runs[storage] = {
            "losses": losses, "step_ms": [t * 1e3 for t in times],
            "step_ms_median": step_s * 1e3,
            "tokens_per_s": tokens / step_s,
            "mfu": (6.0 * params * tokens + attn) / step_s
            / BF16_FLOP_PER_S,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "memory_allocated_before": before,
            "launches_per_step": {k: n / timed for k, n in launches.items()
                                  if n},
            "collectives_per_step": coll,
            "buckets": len(step._s_assign.buckets) + len(
                step._o_assign.buckets)}
        if storage == "replicated":
            runs[storage]["bucket_bytes"] = {
                "stack_per_layer": [b.nbytes for b in step._s_assign.buckets],
                "outer": [b.nbytes for b in step._o_assign.buckets]}
            kept_launches = launches
            del step, opt
            kept = model                # its parameters, for the parity
        else:
            named = dict(kept.named_parameters())
            same = all(torch.equal(p.detach(), named[n].detach())
                       for n, p in model.named_parameters())
            runs["bit_identical_parameters"] = bool(same)
            del step, opt, model, kept, named
        gc.collect()
        torch.cuda.empty_cache()
    rep, shd = runs["replicated"], runs["sharded"]
    fused = _PHASE_STATS.get("fused_scan", {}).get("numerics_off", {})
    stats = {
        "model": "gpt3-1.3b", "step": "ShardedFusedScanTrainStep",
        "world": 1, "backend": "nccl", "layers": cfg.num_layers,
        "hidden": cfg.hidden_size, "seq": seq, "batch": batch,
        "dtype": "float32 parameters, bf16 compute and moments",
        "params": params, "replicated": rep, "sharded": shd,
        "bit_identical_losses": rep["losses"] == shd["losses"],
        "bit_identical_parameters": runs["bit_identical_parameters"],
        "phase14_fused_scan_step_ms_median": fused.get("step_ms_median"),
        "phase14_fused_scan_tokens_per_s": fused.get("tokens_per_s"),
        "phase14_fused_scan_max_memory_allocated":
            fused.get("max_memory_allocated"),
        "nvidia_smi": nvidia_smi()}
    say(f"[23/{PHASES}] (b) train gpt3-1.3b ShardedFusedScanTrainStep: "
          f"{json.dumps(stats)}", flush=True)
    for name in ("replicated", "sharded"):
        r = runs[name]
        if not all(np.isfinite(r["losses"])):
            raise AssertionError(f"non-finite sharded loss ({name})")
        if not abs(r["losses"][0] - float(np.log(GPT_VOCAB))) < 0.5:
            raise AssertionError(f"first sharded loss {r['losses'][0]} is "
                                 f"not near ln {GPT_VOCAB}")
        if r["launches_per_step"] != FUSED_SCAN_LAUNCHES:
            raise AssertionError(f"sharded launches a step ({name}): "
                                 f"{r['launches_per_step']}, expected "
                                 f"{FUSED_SCAN_LAUNCHES}")
    if not (stats["bit_identical_losses"]
            and stats["bit_identical_parameters"]):
        raise AssertionError("the two storages differ")
    return ({k: n for k, n in kept_launches.items() if n}, timed)


def stage2_eager(dev, steps=3, layers=4, batch=8, seq=1024):
    """Phase 23(c): sharding stage 2 through ``fleet.init`` +
    ``group_sharded_parallel(level="os_g")`` + ``TrainStep`` at phase 9's
    configuration (bf16 weights, fp32 masters, bf16 moments, AdamW(1e-4),
    global-norm clip 1.0, recompute, splash) at ``layers`` layers of
    GPT-3 1.3B width, beside the plain ``TrainStep`` at the same depth
    on the same batch: losses within 1e-4; then a step with an inf in the
    embedding row of a batch token under the guard: parameters, master
    and moment shards and the step count bit-identical."""
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy, fleet
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_config
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    cfg = gpt_config("gpt3-1.3b", use_recompute=True, num_layers=layers,
                     max_position_embeddings=seq)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (batch, seq))).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (batch, seq))).to(dev)
    fleet.init(is_collective=True, strategy=DistributedStrategy())
    out = {}
    for kind in ("plain", "stage2"):
        model = GPTForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=0)
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                    multi_precision=True, moment_dtype="bfloat16",
                    grad_clip=ClipGradByGlobalNorm(1.0))
        wrapped = model
        if kind == "stage2":
            wrapped, opt, _ = group_sharded_parallel(model, opt, "os_g")
        step = TrainStep(wrapped, lambda m, x, y: m.loss(x, y), opt,
                         guard_nonfinite=True, numerics=False)
        torch.manual_seed(1234)         # the same dropout masks in both
        times, losses = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(step(ids, labels)))
            times.append((time.perf_counter() - t0) * 1e3)
        out[kind] = {"losses": losses, "step_ms": times}
        if kind == "stage2":
            def state():
                ts = [p.detach().clone() for p in model.parameters()]
                for st in opt._state:
                    ts += [t.clone() for t in st if t is not None]
                return ts, opt._step_count
            before, count = state()
            wte = model.gpt.wte.weight
            row = int(ids[0, 0])
            held = wte.detach()[row].clone()
            with torch.no_grad():
                wte[row] = float("inf")
            bad = float(step(ids, labels))
            with torch.no_grad():
                wte[row] = held
            after, count_after = state()
            out[kind]["inf_loss"] = bad
            out[kind]["skip_bit_identical"] = bool(
                count_after == count and all(
                    torch.equal(a, b) for a, b in zip(after, before)))
            out[kind]["shard_numels"] = [
                [t.numel() for t in st if t is not None]
                for st in opt._state]
        del step, opt, wrapped, model
        gc.collect()
        torch.cuda.empty_cache()
    diff = max(abs(a - b) for a, b in zip(out["plain"]["losses"],
                                          out["stage2"]["losses"]))
    say(f"[23/{PHASES}] (c) eager stage 2 (fleet.init + "
          f"group_sharded_parallel os_g + TrainStep, {layers} layers of "
          f"gpt3-1.3b width, {batch} x {seq}): {json.dumps(out)}; max "
          f"loss diff {diff:.3g}; {nvidia_smi()}", flush=True)
    if not diff <= 1e-4:
        raise AssertionError(f"stage 2 losses differ from plain by {diff}")
    if not (not np.isfinite(out["stage2"]["inf_loss"])
            and out["stage2"]["skip_bit_identical"]):
        raise AssertionError(f"stage 2 guard: {out['stage2']}")


def bert_stage1(dev, warmup=2, timed=5, batch=32, seq=128):
    """Phase 23(d): BERT-base at phase 20(d)'s configuration with sharding
    stage 1 through ``fleet.distributed_optimizer`` (``strategy.sharding``
    at a world of one): step ms and samples/s beside phase 20(d); two
    ``mt_adam_kernel`` a step and no other kernel of the port's; losses
    finite, the first within 0.5 of ln 2."""
    from paddle_tpu_torch.amp import decorate
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy, fleet
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (BertForSequenceClassification,
                                         bert_config)
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW

    cfg = bert_config("bert-base")
    model = BertForSequenceClassification(cfg, num_classes=2, device=dev,
                                          seed=0)
    opt = AdamW(learning_rate=2e-5, parameters=model.parameters(),
                multi_precision=True)
    decorate(models=model, optimizers=opt, level="O2")
    strategy = DistributedStrategy()
    strategy.sharding = True
    fleet.init(is_collective=True, strategy=strategy)
    dopt = fleet.distributed_optimizer(opt)
    crit = CrossEntropyLoss()
    step = TrainStep(fleet.distributed_model(model), lambda m, i, k, y: crit(
        m(i, attention_mask=k), y), dopt)
    rng = np.random.default_rng(0)
    ids, mask = _padded_tokens(rng, batch, seq, cfg.vocab_size, 32)
    labels = torch.from_numpy(rng.integers(0, 2, (batch,)))
    ids, mask, labels = ids.to(dev), mask.to(dev), labels.to(dev)
    losses = [float(step(ids, mask, labels)) for _ in range(warmup)]
    zero, read = _port_counters()
    torch.cuda.synchronize()
    zero()
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        loss = step(ids, mask, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = read()
    step_s = statistics.median(times)
    per_step = {k: n / timed for k, n in launches.items() if n}
    ref = _PHASE_STATS.get("bert", {})
    stats = {"model": "bert-base", "sharding": "stage 1 (world 1, NCCL)",
             "optimizer": type(dopt._inner_opt).__name__,
             "losses": losses, "step_ms": [t * 1e3 for t in times],
             "step_ms_median": step_s * 1e3,
             "samples_per_s": batch / step_s,
             "phase20d_step_ms_median": ref.get("step_ms_median"),
             "phase20d_samples_per_s": ref.get("samples_per_s"),
             "launches_per_step": per_step,
             "buckets": len(dopt._inner_opt._bucketer.assignment.buckets),
             "nvidia_smi": nvidia_smi()}
    say(f"[23/{PHASES}] (d) train bert-base with sharding stage 1: "
          f"{json.dumps(stats)}", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite bert loss: {losses}")
    if not abs(losses[0] - float(np.log(2.0))) < 0.5:
        raise AssertionError(f"first bert loss {losses[0]} is not near ln 2")
    if per_step != {"mt_adam_kernel": 2.0}:
        raise AssertionError(f"bert stage 1 launches a step {per_step}")
    del model, opt, dopt, step
    gc.collect()
    torch.cuda.empty_cache()


def multi_rank(dev):
    """Phase 23(e): with two cards or more, `sharding_selftest` under
    ``torch.distributed.run --nproc_per_node 2`` (stage 2 and the sharded
    scan over the world against world 1); with one, says so."""
    if torch.cuda.device_count() < 2:
        say(f"[23/{PHASES}] (e) multi-rank on the card: not run (1 card)",
              flush=True)
        return
    got = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "-m", "paddle_tpu_torch.distributed.sharding_selftest"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if got.returncode:
        raise AssertionError(f"multi-rank selftest failed:\n"
                             f"{got.stdout[-3000:]}\n{got.stderr[-3000:]}")
    say(f"[23/{PHASES}] (e) multi-rank on the card (2 ranks, NCCL): "
          f"{got.stdout.strip().splitlines()[-1]}; {nvidia_smi()}",
          flush=True)


def sharded_training(dev):
    """Phase 23 (a)-(e), then the world is left (the process group
    destroyed); returns phase 23(b)'s launches and steps."""
    from paddle_tpu_torch.distributed import env

    sharded_scan_parity(dev)
    launches = sharded_full_width(dev)
    stage2_eager(dev)
    bert_stage1(dev)
    multi_rank(dev)
    env.reset()
    return launches


# phase 24(a): the vocab-parallel head's shapes, (tokens, vocab, hidden)
MP_CE_SHAPES = {torch.bfloat16: (8192, GPT_VOCAB, 2048),
                torch.float32: (1024, 4096, 2048)}
MP_DEGREES = (2, 4)


def _mp_ce_case(dev, flush, dtype, mp, shape=None):
    """Phase 24(a) at one dtype and degree (``shape``: ``(tokens, vocab,
    hidden)``, else `MP_CE_SHAPES`'): every shard's forward and
    backward against its plain version and bit-identical twice, the
    counters stepped once a shard, the shards combined as the collective
    combines them against the unsharded kernels; shard 0 timed."""
    from paddle_tpu_torch.ops.kernels import fused_cross_entropy as fce
    F = torch.nn.functional

    n, vocab, hidden = shape or MP_CE_SHAPES[dtype]
    gen = torch.Generator(device=dev).manual_seed(24)
    h = torch.randn(n, hidden, device=dev, generator=gen).to(dtype)
    w = (torch.randn(vocab, hidden, device=dev, generator=gen) * 0.02) \
        .to(dtype)
    labels = torch.randint(0, vocab, (n,), device=dev, generator=gen)
    labels[torch.rand(n, device=dev, generator=gen) < 0.05] = -100
    g = torch.where(labels != -100, torch.full((n,), 1.0 / n, device=dev),
                    0.0)
    full_loss, full_lse = fce.fused_ce_fwd(h, w, labels)
    full_dh, full_dw = fce.fused_ce_bwd(h, w, labels, full_lse, g)
    counter = "launches_wgmma" if dtype == torch.bfloat16 else "launches"
    vloc = vocab // mp
    shard = lambda r: w[r * vloc:(r + 1) * vloc]  # noqa: E731
    err = dict.fromkeys(("lse", "picked", "dh", "dw"), 0.0)
    same, steps, lse_r, pk_r = True, [], [], []
    for r in range(mp):
        before = getattr(fce.fused_ce_fwd, counter)
        lse, pk = fce.sharded_fused_ce_fwd(h, shard(r), labels, r * vloc)
        steps.append(getattr(fce.fused_ce_fwd, counter) - before)
        again = fce.sharded_fused_ce_fwd(h, shard(r), labels, r * vloc)
        same &= torch.equal(again[0], lse) and torch.equal(again[1], pk)
        p_lse, p_pk = fce.sharded_fused_ce_fwd_ref(h, shard(r), labels,
                                                   r * vloc)
        err["lse"] = max(err["lse"], _max_err(lse, p_lse))
        err["picked"] = max(err["picked"], _max_err(pk, p_pk))
        lse_r.append(lse)
        pk_r.append(pk)
    stacked = torch.stack(lse_r)
    mx = stacked.max(0).values
    glob = mx + torch.log(torch.exp(stacked - mx).sum(0))
    losses = torch.where(labels != -100, glob - torch.stack(pk_r).sum(0),
                         0.0)
    dh_sum, dws = torch.zeros(n, hidden, device=dev), []
    for r in range(mp):
        before = fce.fused_ce_bwd.launches
        dh, dw = fce.sharded_fused_ce_bwd(h, shard(r), labels, r * vloc,
                                          glob, g)
        steps.append(fce.fused_ce_bwd.launches - before)
        again = fce.sharded_fused_ce_bwd(h, shard(r), labels, r * vloc, glob,
                                         g)
        same &= torch.equal(again[0], dh) and torch.equal(again[1], dw)
        p_dh, p_dw = fce.sharded_fused_ce_bwd_ref(h, shard(r), labels,
                                                  r * vloc, glob, g)
        err["dh"] = max(err["dh"], _rel_err(dh, p_dh))
        err["dw"] = max(err["dw"], _rel_err(dw, p_dw))
        dh_sum += dh.float()
        dws.append(dw)
    torch.cuda.synchronize()
    whole = {"loss": _max_err(losses, full_loss),
             "lse": _max_err(glob, full_lse),
             "dh_rel": _rel_err(dh_sum, full_dh),
             "dw_rel": _rel_err(torch.cat(dws), full_dw)}
    finite = all(bool(torch.isfinite(t).all())
                 for t in (losses, glob, dh_sum, *dws))
    name = f"vocab-parallel CE mp {mp}"
    _check(name, dtype, max(err["picked"], whole["loss"]),
           max(err["dh"], err["dw"], whole["dh_rel"], whole["dw_rel"]),
           finite, lse_err=max(err["lse"], whole["lse"]), same=same)
    if steps != [1] * (2 * mp):
        raise AssertionError(f"{name} {dtype}: launches a shard {steps}")
    # shard 0 timed (the shards are the same work)
    wl, it = shard(0), h.element_size()
    flops = 2.0 * n * vloc * hidden
    hw = (n + vloc) * hidden * it
    lib = lambda: torch.logsumexp(F.linear(h, wl).float(), -1)  # noqa
    rec = {"shape": [n, hidden, vloc], "errors": err, "whole": whole}
    for kind, kernel, plain, nbytes, fl in (
            ("fwd", lambda: fce.sharded_fused_ce_fwd(h, wl, labels, 0),
             lambda: fce.sharded_fused_ce_fwd_ref(h, wl, labels, 0),
             hw + n * 4 + 2 * n * 4, flops),
            ("bwd", lambda: fce.sharded_fused_ce_bwd(h, wl, labels, 0, glob,
                                                     g),
             lambda: fce.sharded_fused_ce_bwd_ref(h, wl, labels, 0, glob, g),
             2 * hw + 3 * n * 4, 3 * flops)):
        b_ms, b_by = bound_ms(nbytes, fl, it)
        rec[kind] = {"ms": time_ms(kernel, flush, iters=10),
                     "plain_ms": time_ms(plain, flush, iters=2, warmup=1),
                     "bound_ms": b_ms, "bound_by": b_by,
                     # the shard's lse alone, one product and a reduction
                     "library_ms": time_ms(lib, flush, iters=10)
                     if kind == "fwd" else None}
    return rec


def vocab_parallel_kernels(dev):
    """Phase 24(a): #11 / #12 on the vocab-parallel head's shards, GPT-3
    1.3B's head in bf16 (h [8192, 2048], W [50304, 2048]) and fp32 (h
    [1024, 2048], W [4096, 2048]), cut in mp 2 and 4 (`_mp_ce_case`);
    phase 3's bars. Returns {dtype: {mp: record}}."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = {}
    for dtype in MP_CE_SHAPES:
        for mp in MP_DEGREES:
            rec = _mp_ce_case(dev, flush, dtype, mp)
            out.setdefault(str(dtype)[6:], {})[mp] = rec
            say(f"[24/{PHASES}] (a) vocab-parallel CE {str(dtype)[6:]} "
                  f"mp {mp}, shard {rec['shape']}: errors "
                  f"{json.dumps(rec['errors'])}, combined against the "
                  f"unsharded kernels {json.dumps(rec['whole'])}; shard ms "
                  f"fwd {rec['fwd']['ms']:.4f} (bound {rec['fwd']['bound_ms']:.4f}"
                  f" {rec['fwd']['bound_by']}, plain "
                  f"{rec['fwd']['plain_ms']:.2f}, F.linear + logsumexp "
                  f"{rec['fwd']['library_ms']:.4f}), bwd "
                  f"{rec['bwd']['ms']:.4f} (bound "
                  f"{rec['bwd']['bound_ms']:.4f} {rec['bwd']['bound_by']}, "
                  f"plain {rec['bwd']['plain_ms']:.2f}); {nvidia_smi()}",
                  flush=True)
    del flush
    torch.cuda.empty_cache()
    return out


# phase 24(b): a rank's launches a step at GPT-3 1.3B, dp 1 x mp 2, and
# the bar on each step's loss against the world-of-one step (bf16
# compute: the two sum in other orders)
MP_LOSS_BAR = 1e-2
MP_LAUNCHES = {"splash_fwd_wgmma_kernel": 48, "splash_bwd_wgmma_kernels": 24,
               "fused_ce_fwd_wgmma_kernel": 1, "fused_ce_bwd_kernels": 1,
               "mt_adam_kernel": 25, "mt_norm_kernel": 1}


def _mp_collectives(b):
    """What a rank's step must call at GPT-3 1.3B, dp 1 x mp 2 (`b`: the
    rank's record): the activations' all-reduces over mp (6 a layer, 3
    in the head), one reduce-scatter a bucket a layer and one an outer
    bucket over the flattened group, the clip's and the loss's
    all-reduces there, and the sharded storage's gathers."""
    L, (s, o) = b["layers"], b["buckets"]
    flat = "+".join(b["axes"][0])
    return {"all_reduce@mp": 6 * L + 3,
            f"reduce_scatter@{flat}": s * L + o,
            f"all_reduce@{flat}": 2,
            f"all_gather@{flat}": 2 * s * L + o}


def tensor_parallel_two_ranks(dev):
    """Phase 24(b)-(d): GPT-3 1.3B at dp 1 x mp 2 with both ranks on the
    card over gloo (`mp_selftest.launch_card`), held to a world-of-one
    `FusedScanTrainStep` on the same weights and batch (every step's
    loss within `MP_LOSS_BAR`: step 1 holds the forward, steps 2-3 the
    backward through the shards, the grads' scatter, the clip and Adam)
    with exact launches and collectives a step; the tiny fp32 GPT
    at mp 2 card against CPU (loss 5e-4, parameters 5e-3 rel); with two
    cards, the same over NCCL. Returns a rank's launches a step and the
    world-of-one losses (phase 25 holds pp 2 to them too)."""
    from paddle_tpu_torch.distributed import mp_selftest

    t0 = time.perf_counter()
    want = mp_selftest.world_one(dev, steps=3)
    world1_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = mp_selftest.launch_card(2, steps=3, deadline=700)
    wall = time.perf_counter() - t0
    b = res["gpt3_1.3b"]
    gaps = [abs(x - y) for x, y in zip(b["losses"], want)]
    per_step = b["launches_per_step"]
    coll = {k: v for k, v in b["collectives_per_step"]["by_group"].items()}
    report = {"model": "gpt3-1.3b", "dp": 1, "mp": 2,
              "backend": res["backend"], "device": res["device"],
              "losses": b["losses"], "world1_losses": want,
              "loss_gaps": gaps, "rank_losses": b["rank_losses"],
              "step_s": b["step_s"], "launches_per_step": per_step,
              "collectives_per_step": b["collectives_per_step"],
              "max_memory_allocated_rank0": b["max_memory_allocated"],
              "world1_s": world1_s, "launch_wall_s": wall,
              "nvidia_smi": nvidia_smi()}
    say(f"[24/{PHASES}] (b) gpt3-1.3b dp 1 x mp 2, two ranks sharing "
          f"the card over gloo (activations through the host: no speed of "
          f"mp): {json.dumps(report)}", flush=True)
    if not (len(gaps) == len(want) and max(gaps) < MP_LOSS_BAR
            and all(np.isfinite(b["losses"]))):
        raise AssertionError(f"mp 2 losses {b['losses']} against world 1 "
                             f"{want}")
    if any(r != b["rank_losses"][0] for r in b["rank_losses"]):
        raise AssertionError(f"ranks' losses differ: {b['rank_losses']}")
    if per_step != MP_LAUNCHES:
        raise AssertionError(f"mp 2 launches a step {per_step}, want "
                             f"{MP_LAUNCHES}")
    if coll != _mp_collectives(b):
        raise AssertionError(f"mp 2 collectives a step {coll}, want "
                             f"{_mp_collectives(b)}")
    tiny = res["tiny_card_cpu"]
    say(f"[24/{PHASES}] (c) tiny fp32 scan GPT at mp 2, card against "
          f"CPU over the same gloo ranks: {json.dumps(tiny)}; "
          f"{nvidia_smi()}", flush=True)
    if not (tiny["max_loss_diff"] < 5e-4 and tiny["max_param_rel"] < 5e-3):
        raise AssertionError(f"mp 2 card against CPU: {tiny}")
    if torch.cuda.device_count() < 2:
        say(f"[24/{PHASES}] (d) dp 1 x mp 2 over NCCL: not run (1 card)",
              flush=True)
    else:
        nccl = mp_selftest.launch_card(2, nccl=True, steps=3, deadline=600)
        nb = nccl["gpt3_1.3b"]
        say(f"[24/{PHASES}] (d) dp 1 x mp 2 over NCCL, one card a rank: "
              f"losses {nb['losses']}, step s {nb['step_s']}; "
              f"{nvidia_smi()}", flush=True)
        if max(abs(x - y) for x, y in zip(nb["losses"], want)) >= \
                MP_LOSS_BAR or nb["launches_per_step"] != MP_LAUNCHES:
            raise AssertionError(f"mp 2 over NCCL: {nb}")
    return per_step, want


PP_LOSS_BAR = 1e-2
PP_MICRO = 4


def _pp_launches(stage, layers=24, pp=2, micro=PP_MICRO):
    """A rank's launches a step at GPT-3 1.3B, dp 1 x pp 2 (counted from
    the design): its layers' splash forwards on each micro-batch in the
    ring and again in the backward's recompute, their backwards once; the
    head's CE on stage 0 alone; one fused update a chunk (every rank
    updates its shards of every layer) and the outer one; the clip's
    norm."""
    own = layers // pp
    return {"splash_fwd_wgmma_kernel": 2 * own * micro,
            "splash_bwd_wgmma_kernels": own * micro,
            "fused_ce_fwd_wgmma_kernel": int(stage == 0),
            "fused_ce_bwd_kernels": int(stage == 0),
            "mt_adam_kernel": layers + 1, "mt_norm_kernel": 1}


def _pp_collectives(b, pp=2, micro=PP_MICRO):
    """What a rank's step must call at dp 1 x pp 2 (`b`: the record): one
    reduce-scatter a bucket a layer (every stage takes part, the owner
    contributing) and one an outer bucket over the flattened group (the
    world's here), the sharded storage's gathers (each layer in the
    ring's forward and in the backward, the outer buckets once), the
    clip's and the loss's all-reduces there, the loss's over pp; M sends
    and M receives a pass each way."""
    L, (s, o) = b["layers"], b["buckets"]
    flat = "world" if b["axes"][0] is None else "+".join(b["axes"][0])
    v = L // pp
    return {f"reduce_scatter@{flat}": s * L + o,
            f"all_gather@{flat}": 2 * s * L + o,
            f"all_reduce@{flat}": 2, "all_reduce@pp": 1,
            "send@pp": 2 * v * micro, "recv@pp": 2 * v * micro}


def pipeline_two_ranks(dev, want):
    """Phase 25: GPT-3 1.3B at dp 1 x pp 2 with both ranks on the card
    over gloo (`pipeline_selftest.launch_card`), held to phase 24's
    world-of-one losses ``want`` with exact launches, transfers and
    collectives a step; the tiny scan GPT at pp 2 and pp 2 x mp 2 card
    against CPU; the eager pipeline and `GPTForCausalLMPipe` card against
    one rank; with two cards, (a) over NCCL. Returns the launches a step
    by stage."""
    from paddle_tpu_torch.distributed import pipeline_selftest

    t0 = time.perf_counter()
    res = pipeline_selftest.launch_card(2, steps=len(want), deadline=700)
    wall = time.perf_counter() - t0
    b = res["gpt3_1.3b"]
    gaps = [abs(x - y) for x, y in zip(b["losses"], want)]
    ranks = b["ranks"]
    report = {"model": "gpt3-1.3b", "dp": 1, "pp": 2, "micro": b["micro"],
              "backend": res["backend"], "device": res["device"],
              "losses": b["losses"], "world1_losses": want,
              "loss_gaps": gaps, "schedule": b["schedule"],
              "ranks": ranks, "launch_wall_s": wall,
              "nvidia_smi": nvidia_smi()}
    say(f"[25/{PHASES}] (a) gpt3-1.3b dp 1 x pp 2, two ranks sharing "
          f"the card over gloo (activations, grads and parameters through "
          f"the host: the step times and the peak memory are gloo's, no "
          f"speed of pp): {json.dumps(report)}", flush=True)
    if not (len(gaps) == len(want) and max(gaps) < PP_LOSS_BAR
            and all(np.isfinite(b["losses"]))):
        raise AssertionError(f"pp 2 losses {b['losses']} against world 1 "
                             f"{want}")
    if any(r["losses"] != ranks[0]["losses"] for r in ranks):
        raise AssertionError(f"ranks' losses differ: {ranks}")
    by_stage = {}
    for r in ranks:
        st = r["stage"]
        by_stage[st] = r["launches_per_step"]
        if r["launches_per_step"] != _pp_launches(st):
            raise AssertionError(f"pp 2 stage {st} launches a step "
                                 f"{r['launches_per_step']}, want "
                                 f"{_pp_launches(st)}")
        coll = dict(r["collectives_per_step"]["by_group"])
        if coll != _pp_collectives(b):
            raise AssertionError(f"pp 2 stage {st} collectives a step "
                                 f"{coll}, want {_pp_collectives(b)}")
    tiny = res["tiny_card_cpu"]
    quad = pipeline_selftest.launch_card(4, tiny=True, tiny_mp=2,
                                         deadline=300)["tiny_card_cpu"]
    say(f"[25/{PHASES}] (b) tiny fp32 scan GPT card against CPU over "
          f"the same gloo ranks: pp 2 {json.dumps(tiny)}; pp 2 x mp 2 "
          f"{json.dumps(quad)}; {nvidia_smi()}", flush=True)
    for t in (tiny, quad):
        if not (t["max_loss_diff"] < 5e-4 and t["max_param_rel"] < 5e-3):
            raise AssertionError(f"pp card against CPU: {t}")
    pipe = res["pipe_layers"]
    say(f"[25/{PHASES}] (c) PipelineParallel.train_batch and "
          f"GPTForCausalLMPipe at pp 2 on the card against one rank: "
          f"{json.dumps(pipe)}; {nvidia_smi()}", flush=True)
    pl = pipe["pipeline_parallel"]
    if not (pl["max_loss_diff"] < 1e-4 and pl["max_param_rel"] < 1e-3):
        raise AssertionError(f"PipelineParallel against one rank: {pl}")
    for nc in (1, 2):
        g = pipe[f"gpt_pipe_c{nc}"]
        if not (abs(g["loss"] - g["plain"]) < 1e-4
                and g["max_grad_rel"] < 1e-3):
            raise AssertionError(f"GPTForCausalLMPipe chunks {nc}: {g}")
    if torch.cuda.device_count() < 2:
        say(f"[25/{PHASES}] (d) dp 1 x pp 2 over NCCL: not run (1 card); "
              f"{nvidia_smi()}", flush=True)
    else:
        nccl = pipeline_selftest.launch_card(2, nccl=True, steps=len(want),
                                             deadline=600)
        nb = nccl["gpt3_1.3b"]
        say(f"[25/{PHASES}] (d) dp 1 x pp 2 over NCCL, one card a rank: "
              f"losses {nb['losses']}, step s {nb['step_s']}; "
              f"{nvidia_smi()}", flush=True)
        if max(abs(x - y) for x, y in zip(nb["losses"], want)) >= \
                PP_LOSS_BAR or any(
                    r["launches_per_step"] != _pp_launches(r["stage"])
                    for r in nb["ranks"]):
            raise AssertionError(f"pp 2 over NCCL: {nb}")
    return by_stage


# phase 26: LLaMA under mp and pp (BASELINE config 5's tp 4 x pp 2)
LLAMA_HEAD = (8192, 32000, 4096)    # 4 x 2048 tokens, LLaMA-7B's head
LLAMA_MP = 4
LLAMA_PP = 2
LLAMA_LOSS_BAR = 1e-2
LLAMA_STEPS, LLAMA_PP_STEPS = 3, 2


def llama_head_shards(dev):
    """Phase 26(a): #11 / #12 on LLaMA-7B's vocab-parallel head (h [8192,
    4096] bf16 over W [32000, 4096]) cut in mp 2 and 4: 16000 and 8000
    rows, neither a multiple of 256, so each shard ends in a ragged
    tile (`_mp_ce_case`: phase 3's bars, bit-identical twice, the
    counters stepped once a shard, shard 0 timed)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = {}
    for mp in MP_DEGREES:
        rec = _mp_ce_case(dev, flush, torch.bfloat16, mp, shape=LLAMA_HEAD)
        out[mp] = rec
        say(f"[26/{PHASES}] (a) LLaMA-7B head, vocab-parallel CE bf16 mp "
              f"{mp}, shard {rec['shape']}: errors "
              f"{json.dumps(rec['errors'])}, combined against the "
              f"unsharded kernels {json.dumps(rec['whole'])}; shard ms fwd "
              f"{rec['fwd']['ms']:.4f} (bound {rec['fwd']['bound_ms']:.4f} "
              f"{rec['fwd']['bound_by']}, plain {rec['fwd']['plain_ms']:.2f},"
              f" F.linear + logsumexp {rec['fwd']['library_ms']:.4f}), bwd "
              f"{rec['bwd']['ms']:.4f} (bound {rec['bwd']['bound_ms']:.4f} "
              f"{rec['bwd']['bound_by']}, plain "
              f"{rec['bwd']['plain_ms']:.2f}); {nvidia_smi()}", flush=True)
    del flush
    torch.cuda.empty_cache()
    return out


def _llama_mp_launches():
    """A rank's launches a step at LLaMA-7B's widths, dp 1 x mp 4, bf16
    O2 (counted from the design): the vocab-parallel CE forward and
    backward once each over the rank's V/4 rows, one fused AdamW (one
    dtype group: bf16 parameters with fp32 masters), and the global
    norm's two sums of squares (the blocks', all-reduced over mp, then
    the replicated norms': `nn.clip.mp_norm_stats`)."""
    return {"fused_ce_fwd_wgmma_kernel": 1, "fused_ce_bwd_kernels": 1,
            "mt_adam_kernel": 1, "mt_norm_kernel": 2}


def _llama_mp_collectives(layers):
    """A rank's collectives a step at dp 1 x mp: over mp the embedding's
    sum, a layer's two forward sums (o, down), the recompute's one (the
    checkpoint stops its replay once the attention's output is back) and
    two backward sums (the f before q|k|v and before gate|up), the head's
    f and its CE's two combines (max, then sum), the clip's sum of the
    blocks' squares; the loss's mean over the data axes (one rank)."""
    return {"all_reduce@mp": 5 * layers + 5, "all_reduce@sharding": 1}


def _llama_pp_launches():
    """A rank's launches a step at LLaMA-7B's widths, tp 4 x pp 2, bf16
    O2 (counted from the design), alike on both stages: no fused CE (the
    last stage's loss is the vocab-parallel criterion over its logits'
    columns, `ParallelCrossEntropy`'s, in PyTorch: ROADMAP A9b.7b), one
    fused AdamW over the stage's parameters, and the global norm's two
    sums of squares (the blocks', then the replicated norms')."""
    return {"fused_ce_fwd_wgmma_kernel": 0, "fused_ce_bwd_kernels": 0,
            "mt_adam_kernel": 1, "mt_norm_kernel": 2}


def _llama_pp_collectives(stage, layers, micro, pp=LLAMA_PP):
    """A rank's collectives a step at tp x pp (``layers`` decoder layers
    a stage, ``micro`` micro-batches): over mp the batch's two
    broadcasts, on each micro-batch stage 0's embedding sum, each layer's
    five sums (`_llama_mp_collectives`), the last stage's head f and its
    CE's two combines, and the clip's one; over pp the clip's sum, the
    loss's broadcast, and M activations one way and M cotangents the
    other (stage 0 sends one shape header more)."""
    last = stage == pp - 1
    per_micro = 5 * layers + (1 if stage == 0 else 0) + (3 if last else 0)
    return {"broadcast@mp": 2, "all_reduce@mp": micro * per_micro + 1,
            "all_reduce@pp": 1, "broadcast@pp": 1,
            "send@pp": micro + (stage == 0),
            "recv@pp": micro + (stage > 0)}


def llama_hybrid(dev):
    """Phase 26(b)-(e): LLaMA-7B's widths (8 layers) at dp 1 x mp 4
    (four gloo ranks sharing the card: `llama_selftest.launch_card(4)`)
    and at tp 4 x pp 2 (eight: ``launch_card(8, pp=2)``), each step's
    loss held to a world-of-one `TrainStep` on the same weights and
    batch (`LLAMA_LOSS_BAR`), each rank's launches and collectives a
    step exact; the tiny fp32 GQA LLaMA card against CPU at dp 2 x mp 2
    and dp 2 x pp 2 x mp 2; with two cards, (b) over NCCL. Returns a
    rank's launches a step at mp 4, and at tp 4 x pp 2 by stage (mp
    rank 0's)."""
    from paddle_tpu_torch.distributed import llama_selftest

    cfg = llama_selftest.full_width_config()
    t0 = time.perf_counter()
    want = llama_selftest.world_one(dev, steps=LLAMA_STEPS)
    world1_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = llama_selftest.launch_card(LLAMA_MP, steps=LLAMA_STEPS,
                                     deadline=600)
    wall = time.perf_counter() - t0
    b = res["llama_7b"]
    gaps = [abs(x - y) for x, y in zip(b["losses"], want)]
    per_step = b["launches_per_step"]
    coll = dict(b["collectives_per_step"]["by_group"])
    report = {"model": "llama-7b widths", "layers": cfg.num_layers,
              "cut": f"depth {cfg.num_layers} of 32 layers",
              "dp": 1, "mp": LLAMA_MP, "backend": res["backend"],
              "tokens": [4, 2048], "losses": b["losses"],
              "world1_losses": want, "loss_gaps": gaps,
              "rank_losses": b["rank_losses"], "step_s": b["step_s"],
              "launches_per_step": per_step,
              "collectives_per_step": b["collectives_per_step"],
              "head_rows": b["head_rows"],
              "max_memory_allocated_rank0": b["max_memory_allocated"],
              "types": b["types"], "world1_s": world1_s,
              "launch_wall_s": wall, "nvidia_smi": nvidia_smi()}
    say(f"[26/{PHASES}] (b) LLaMA-7B widths at dp 1 x mp {LLAMA_MP}, "
          f"four ranks sharing the card over gloo (activations through "
          f"the host: no speed of mp): {json.dumps(report)}", flush=True)
    if not (len(gaps) == len(want) and max(gaps) < LLAMA_LOSS_BAR
            and all(np.isfinite(b["losses"]))):
        raise AssertionError(f"mp {LLAMA_MP} losses {b['losses']} against "
                             f"world 1 {want}")
    if any(r != b["rank_losses"][0] for r in b["rank_losses"]):
        raise AssertionError(f"ranks' losses differ: {b['rank_losses']}")
    if b["head_rows"] != LLAMA_HEAD[1] // LLAMA_MP:
        raise AssertionError(f"head rows a rank {b['head_rows']}")
    if per_step != _llama_mp_launches():
        raise AssertionError(f"mp {LLAMA_MP} launches a step {per_step}, "
                             f"want {_llama_mp_launches()}")
    if coll != _llama_mp_collectives(cfg.num_layers):
        raise AssertionError(f"mp {LLAMA_MP} collectives a step {coll}, "
                             f"want {_llama_mp_collectives(cfg.num_layers)}")
    n = LLAMA_MP * LLAMA_PP
    t0 = time.perf_counter()
    pres = llama_selftest.launch_card(n, steps=LLAMA_PP_STEPS, pp=LLAMA_PP,
                                      deadline=600)
    pwall = time.perf_counter() - t0
    ranks = pres["llama_7b"]["ranks"]
    pgaps = [abs(x - y) for x, y in zip(pres["llama_7b"]["losses"], want)]
    report = {"model": "llama-7b widths", "layers": cfg.num_layers,
              "tp": LLAMA_MP, "pp": LLAMA_PP,
              "micro": ranks[0]["micro"],
              "losses": pres["llama_7b"]["losses"],
              "world1_losses": want[:LLAMA_PP_STEPS], "loss_gaps": pgaps,
              "ranks": [{k: r[k] for k in (
                  "rank", "stage", "mp_rank", "layers", "losses", "step_s",
                  "p2p_per_step", "max_memory_allocated",
                  "launches_per_step")} for r in ranks],
              "collectives_per_step_rank0": ranks[0]["collectives_per_step"],
              "launch_wall_s": pwall, "nvidia_smi": nvidia_smi()}
    say(f"[26/{PHASES}] (c) BASELINE config 5's layout, tp {LLAMA_MP} x "
          f"pp {LLAMA_PP}: eight ranks sharing the card over gloo "
          f"(activations and sends through the host: the step times and "
          f"peak memory are gloo's, no speed of mp or pp): "
          f"{json.dumps(report)}", flush=True)
    if not (len(pgaps) == LLAMA_PP_STEPS and max(pgaps) < LLAMA_LOSS_BAR
            and all(np.isfinite(pres["llama_7b"]["losses"]))):
        raise AssertionError(f"tp x pp losses {pres['llama_7b']['losses']} "
                             f"against world 1 {want}")
    if any(r["losses"] != ranks[0]["losses"] for r in ranks):
        raise AssertionError(f"tp x pp ranks' losses differ: {ranks}")
    lps = cfg.num_layers // LLAMA_PP
    if sorted(r["layers"] for r in ranks) != [lps] * n:
        raise AssertionError(f"decoder layers a stage: {ranks}")
    for r in ranks:
        if r["launches_per_step"] != _llama_pp_launches():
            raise AssertionError(
                f"tp x pp rank {r['rank']} launches a step "
                f"{r['launches_per_step']}, want {_llama_pp_launches()}")
        want_c = _llama_pp_collectives(r["stage"], lps, r["micro"])
        if dict(r["collectives_per_step"]["by_group"]) != want_c:
            raise AssertionError(
                f"tp x pp rank {r['rank']} collectives a step "
                f"{r['collectives_per_step']['by_group']}, want {want_c}")
    tiny = [res["tiny_card_cpu"], pres["tiny_card_cpu"]]
    say(f"[26/{PHASES}] (d) tiny fp32 GQA LLaMA (KV heads 2) card against "
          f"CPU over the same gloo ranks: dp 2 x mp 2 {json.dumps(tiny[0])};"
          f" dp 2 x pp 2 x mp 2 {json.dumps(tiny[1])}; {nvidia_smi()}",
          flush=True)
    for t in tiny:
        if not (t["max_loss_diff"] < 5e-4 and t["max_param_rel"] < 5e-3):
            raise AssertionError(f"LLaMA card against CPU: {t}")
    if torch.cuda.device_count() < 2:
        say(f"[26/{PHASES}] (e) dp 1 x mp over NCCL: not run (1 card); "
              f"{nvidia_smi()}", flush=True)
    else:
        k = min(torch.cuda.device_count(), LLAMA_MP)
        nb = llama_selftest.launch_card(k, nccl=True, steps=LLAMA_STEPS,
                                        deadline=600)["llama_7b"]
        say(f"[26/{PHASES}] (e) dp 1 x mp {k} over NCCL, one card a "
              f"rank: losses {nb['losses']}, step s {nb['step_s']}; "
              f"{nvidia_smi()}", flush=True)
        if max(abs(x - y) for x, y in zip(nb["losses"], want)) >= \
                LLAMA_LOSS_BAR or nb["launches_per_step"] != \
                _llama_mp_launches():
            raise AssertionError(f"mp {k} over NCCL: {nb}")
    return per_step, {r["stage"]: r["launches_per_step"] for r in ranks
                      if r["mp_rank"] == 0}


# phase 27: the zero-bubble ring
ZB_GRAD_BAR = 2e-2


def _zb_launches(layers, zb, micro=PP_MICRO):
    """A rank's launches of one forward and backward of
    ``GPTForCausalLMPipe`` at GPT-3 1.3B's widths, bf16, ``layers`` a
    stage (counted from the design): the AD ring runs each layer's
    splash forward on every micro-batch in the ring and again in the
    backward's recompute, its backward once; the zero-bubble ring its
    forward in the ring, in the dX tick's recompute and in the fold's,
    its backward in the tick and in the fold; no CE kernel (the head is a
    product, then the criterion), no optimizer."""
    m = layers * micro
    return {"splash_fwd_wgmma_kernel": (3 if zb else 2) * m,
            "splash_bwd_wgmma_kernels": (2 if zb else 1) * m,
            "fused_ce_fwd_wgmma_kernel": 0, "fused_ce_bwd_kernels": 0,
            "mt_adam_kernel": 0, "mt_norm_kernel": 0}


def zero_bubble_two_ranks(dev):
    """Phase 27: the zero-bubble ring beside the AD ring at GPT-3 1.3B's
    widths, two gloo ranks sharing the card; the tiny pipe and the
    tanh-linear ring card against CPU. Returns a rank's zero-bubble
    launches by stage."""
    from paddle_tpu_torch.distributed import pipeline_selftest

    t0 = time.perf_counter()
    res = pipeline_selftest.launch_card(2, zb=True, deadline=600)
    wall = time.perf_counter() - t0
    b = res["zb_1.3b"]
    ranks = b["ranks"]
    report = {"model": "gpt3-1.3b widths", "pp": b["pp"],
              "micro": b["micro"], "tokens": b["tokens"],
              "layers": b["num_layers"], "backend": res["backend"],
              "ranks": ranks, "launch_wall_s": wall,
              "nvidia_smi": nvidia_smi()}
    say(f"[27/{PHASES}] (a) GPTForCausalLMPipe at gpt3-1.3b widths, pp 2, "
          f"the AD ring then use_zero_bubble=True on the same weights, two "
          f"ranks sharing the card over gloo (activations through the "
          f"host: no speed of the ring): {json.dumps(report)}", flush=True)
    for r in ranks:
        ad, zb = r["ad"], r["zb"]
        if not (np.isfinite(ad["loss"]) and zb["loss"] == ad["loss"]
                and ad["loss"] == ranks[0]["ad"]["loss"]):
            raise AssertionError(f"zero-bubble losses: {ranks}")
        if not r["max_grad_rel"] < ZB_GRAD_BAR:
            raise AssertionError(f"zero-bubble grads against the AD ring "
                                 f"on stage {r['stage']}: {r['worst']} "
                                 f"{r['max_grad_rel']}")
        for tag, want in (("ad", _zb_launches(r["layers"], False)),
                          ("zb", _zb_launches(r["layers"], True))):
            if r[tag]["launches"] != want:
                raise AssertionError(
                    f"{tag} ring stage {r['stage']} launches "
                    f"{r[tag]['launches']}, want {want}")
    tiny = res["zb_card_cpu"]
    say(f"[27/{PHASES}] (b)-(c) a tiny fp32 zero-bubble GPTForCausalLMPipe "
          f"and zb_linear_pipeline at pp 2, card against CPU over the same "
          f"gloo ranks: {json.dumps(tiny)}; {nvidia_smi()}", flush=True)
    for r in tiny["ranks"]:
        if not (r["gpt_loss_diff"] < 1e-4 and r["gpt_max_grad_rel"] < 1e-3
                and r["lin_max_out_diff"] < 1e-5
                and r["lin_max_grad_rel"] < 1e-4):
            raise AssertionError(f"zero-bubble card against CPU: {r}")
    return {f"stage{r['stage']}": r["zb"]["launches"] for r in ranks}


# phase 28: sharding stage 3
# GPT-3 1.3B's depth cut to 8 of its 24 layers (phases 28 and 29(b)): the
# gloo ranks' grads go through the host, 17-30 s a step at 24 layers
STAGE3_LAYERS = 8
STAGE3_STEPS = 3


def _stage3_launches(layers, segments=None):
    """A rank's launches a step of GPT-3 1.3B's widths under stage 3 (or
    the world of one), bf16 with recompute (counted from the design):
    each layer's splash forward twice (the forward and the recompute),
    its backward once, the fused CE 1 + 1, and the update and the clip's
    norm one launch per `MAX_TENSORS` (448) tensors: the segments of the
    rank's shards (every parameter at a world of one)."""
    from paddle_tpu_torch.ops.kernels.multi_tensor import MAX_TENSORS

    k = -(-(segments or 1) // MAX_TENSORS)
    return {"splash_fwd_wgmma_kernel": 2 * layers,
            "splash_bwd_wgmma_kernels": layers,
            "fused_ce_fwd_wgmma_kernel": 1, "fused_ce_bwd_kernels": 1,
            "mt_adam_kernel": k, "mt_norm_kernel": k}


def stage3_two_ranks(dev):
    """Phase 28: GPT-3 1.3B's widths under stage 3 at sharding 2 (two gloo
    ranks sharing the card), plain and offloaded, against a world-of-one
    ``TrainStep``; the tiny GPT card against CPU. Returns rank 0's
    launches a step."""
    from paddle_tpu_torch.distributed import sharding_selftest

    t0 = time.perf_counter()
    want = sharding_selftest.stage3_world_one(dev, steps=STAGE3_STEPS,
                                              layers=STAGE3_LAYERS)
    world1_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = sharding_selftest.launch_stage3_card(
        2, steps=STAGE3_STEPS, layers=STAGE3_LAYERS, deadline=800)
    wall = time.perf_counter() - t0
    a, off = res["stage3"], res["offload"]
    L = want["layers"]
    report = {"model": "gpt3-1.3b widths", "layers": L,
              "cut": None if L == 24 else f"depth {L} of 24 layers",
              "sharding": a["sharding"], "tokens": a["tokens"],
              "backend": res["backend"], "world1": want,
              "ranks": a["ranks"], "launch_wall_s": wall,
              "world1_s": world1_s, "nvidia_smi": nvidia_smi()}
    say(f"[28/{PHASES}] (a) gpt3-1.3b widths under group_sharded_parallel"
          f"(level='p_g_os') + TrainStep at sharding 2, two ranks sharing "
          f"the card over gloo (parameters and grads through the host: the "
          f"step times are gloo's, no speed of stage 3): "
          f"{json.dumps(report)}", flush=True)
    if want["launches_per_step"] != _stage3_launches(L):
        raise AssertionError(f"world-of-one launches a step "
                             f"{want['launches_per_step']}, want "
                             f"{_stage3_launches(L)}")
    for r in a["ranks"]:
        gaps = [abs(x - y) for x, y in zip(r["losses"], want["losses"])]
        if not (len(gaps) == STAGE3_STEPS and max(gaps) < MP_LOSS_BAR
                and all(np.isfinite(r["losses"]))):
            raise AssertionError(f"stage 3 rank {r['rank']} losses "
                                 f"{r['losses']} against world 1 "
                                 f"{want['losses']}")
        if r["losses"] != a["ranks"][0]["losses"]:
            raise AssertionError(f"ranks' losses differ: {a['ranks']}")
        expect = _stage3_launches(L, r["segments"])
        if r["launches_per_step"] != expect:
            raise AssertionError(f"stage 3 rank {r['rank']} launches a step "
                                 f"{r['launches_per_step']}, want {expect}")
        if not max(r["resident_param_bytes"]) < 0.55 * want["param_bytes"]:
            raise AssertionError(
                f"stage 3 rank {r['rank']} holds "
                f"{r['resident_param_bytes']} parameter bytes between "
                f"steps, the world of one {want['param_bytes']}")
    keys = ("losses", "shards_pinned_host", "resident_param_bytes",
            "max_memory_allocated", "step_s")
    rows = [{k: r[k] for k in keys} for r in off["ranks"]]
    say(f"[28/{PHASES}] (b) offload=True (the shards in pinned host "
          f"memory): {json.dumps(rows)}; {nvidia_smi()}", flush=True)
    for r, q in zip(off["ranks"], a["ranks"]):
        if not (r["losses"] == q["losses"] and r["shards_pinned_host"]):
            raise AssertionError(f"offload rank {r['rank']}: {r}")
    tiny = res["tiny_card_cpu"]
    say(f"[28/{PHASES}] (c) tiny fp32 GPT under stage 3 at sharding 2, "
          f"card against CPU over the same gloo ranks: {json.dumps(tiny)}; "
          f"{nvidia_smi()}", flush=True)
    if not (tiny["max_loss_diff"] < 1e-4 and tiny["max_param_rel"] < 1e-3):
        raise AssertionError(f"stage 3 card against CPU: {tiny}")
    if torch.cuda.device_count() < 2:
        say(f"[28/{PHASES}] (d) sharding 2 over NCCL: not run (1 card); "
              f"{nvidia_smi()}", flush=True)
    else:
        nb = sharding_selftest.launch_stage3_card(
            2, nccl=True, steps=STAGE3_STEPS, layers=STAGE3_LAYERS,
            deadline=600)["stage3"]["ranks"][0]
        say(f"[28/{PHASES}] (d) sharding 2 over NCCL, one card a rank: "
              f"losses {nb['losses']}, step s {nb['step_s']}; "
              f"{nvidia_smi()}", flush=True)
        if max(abs(x - y) for x, y in zip(nb["losses"], want["losses"])) \
                >= MP_LOSS_BAR:
            raise AssertionError(f"stage 3 over NCCL: {nb}")
    return a["ranks"][0]["launches_per_step"]


# phase 29: the sep axis
SEP = 2
SEP_LOSS_BAR = 1e-2
SEP_RING_FWD = {"float32": 3e-5, "bfloat16": TOL_FWD[torch.bfloat16]}
SEP_RING_BWD = {"float32": TOL_BWD[torch.float32],
                "bfloat16": TOL_BWD[torch.bfloat16]}


def _sep_ring_launches(rank, causal, n=SEP):
    """A rank's launches of #7 and #8 a ring call (counted from the
    design): a causal ring's diagonal tick and the ``rank`` ticks below
    it, every tick of a full one; the skipped ticks launch nothing."""
    k = rank + 1 if causal else n
    return {"flash_fwd": k, "flash_bwd": k}


def _sep_launches():
    """A rank's launches a step of phase 29(b) (counted from the design):
    the ring is aten ops, so no attention kernel; the CE 1 + 1 on the
    rank's rows; the update and the clip's norm once (fewer than 448
    tensors)."""
    return {"splash_fwd_wgmma_kernel": 0, "splash_bwd_wgmma_kernels": 0,
            "fused_ce_fwd_wgmma_kernel": 1, "fused_ce_bwd_kernels": 1,
            "mt_adam_kernel": 1, "mt_norm_kernel": 1}


def sep_two_ranks(dev):
    """Phase 29: the sep axis at sep 2, two gloo ranks sharing the card.
    Returns rank 0's launches (the ring's a call by its mode, the CE's a
    step)."""
    from paddle_tpu_torch.distributed import sep_selftest

    t0 = time.perf_counter()
    want = sep_selftest.gpt_world_one(dev, layers=STAGE3_LAYERS)
    world1_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = sep_selftest.launch_card(SEP, layers=STAGE3_LAYERS, deadline=700)
    wall = time.perf_counter() - t0
    ring = res["ring"]
    say(f"[29/{PHASES}] (a) ring_flash_attention at gpt3-1.3b attention "
          f"widths, sep {SEP}, two ranks sharing the card over gloo (K/V "
          f"through the host: no speed of the ring), against the plain "
          f"full attention: {json.dumps(ring)}; {nvidia_smi()}", flush=True)
    for r in ring:
        for row in r["rows"]:
            dt = row["dtype"]
            want_n = _sep_ring_launches(r["sep_rank"], row["causal"])
            if not (row["max_abs_err"] < SEP_RING_FWD[dt]
                    and row["max_grad_rel"] < SEP_RING_BWD[dt]
                    and row["same_twice"] and row["finite"]
                    and row["launches"] == want_n
                    and row["launches_again"] == want_n):
                raise AssertionError(f"flash ring on sep rank "
                                     f"{r['sep_rank']}: {row}, launches "
                                     f"want {want_n}")
    b = res["gpt"]
    L = b["layers"]
    report = {"model": "gpt3-1.3b widths", "layers": L,
              "cut": None if L == 24 else f"depth {L} of 24 layers",
              "sep": res["world"], "tokens": b["tokens"],
              "backend": res["backend"], "world1": want,
              "world1_s": world1_s, "ranks": b["ranks"],
              "launch_wall_s": wall, "nvidia_smi": nvidia_smi()}
    say(f"[29/{PHASES}] (b) gpt3-1.3b widths, use_ring_attention=True, "
          f"fleet.init(sep_degree={SEP}) -> distributed_model -> "
          f"train_step, two ranks sharing the card over gloo (K/V and "
          f"grads through the host: the step times are gloo's, no speed of "
          f"sep): {json.dumps(report)}", flush=True)
    if want["launches_per_step"] != _stage3_launches(L):
        raise AssertionError(f"world-of-one launches a step "
                             f"{want['launches_per_step']}, want "
                             f"{_stage3_launches(L)}")
    for r in b["ranks"]:
        gaps = [abs(x - y) for x, y in zip(r["losses"], want["losses"])]
        if not (len(gaps) == 3 and max(gaps) < SEP_LOSS_BAR
                and all(np.isfinite(r["losses"]))):
            raise AssertionError(f"sep rank {r['rank']} losses "
                                 f"{r['losses']} against world 1 "
                                 f"{want['losses']}")
        if r["losses"] != b["ranks"][0]["losses"]:
            raise AssertionError(f"ranks' losses differ: {b['ranks']}")
        if r["launches_per_step"] != _sep_launches():
            raise AssertionError(f"sep rank {r['rank']} launches a step "
                                 f"{r['launches_per_step']}, want "
                                 f"{_sep_launches()}")
        if r["wrapper"] != "SegmentParallel":
            raise AssertionError(f"distributed_model gave {r['wrapper']}")
    c = res["llama"]
    say(f"[29/{PHASES}] (c) llama-7b widths at {c['layers']} layers, "
          f"use_ring_attention=True, fp32, sep {SEP}, one step against the "
          f"world of one: {json.dumps(c)}; {nvidia_smi()}", flush=True)
    r0 = c["ranks"][0]
    if not (r0["loss_diff"] < SEP_LOSS_BAR
            and r0["max_grad_rel"] < SEP_LOSS_BAR
            and len({r["loss"] for r in c["ranks"]}) == 1):
        raise AssertionError(f"llama under sep: {c}")
    tiny = res["tiny"]
    say(f"[29/{PHASES}] (d) a tiny fp32 GPT and GQA LLaMA with the ring "
          f"at sep {SEP}, card against CPU over the same gloo ranks: "
          f"{json.dumps(tiny)}; {nvidia_smi()}", flush=True)
    for fam, t in tiny.items():
        if not (t["loss_diff"] < 1e-4 and t["max_grad_rel"] < 1e-3
                and t["max_step_loss_diff"] < 1e-4):
            raise AssertionError(f"sep {fam} card against CPU: {t}")
    if torch.cuda.device_count() < 2:
        say(f"[29/{PHASES}] (e) sep {SEP} over NCCL: not run (1 card); "
              f"{nvidia_smi()}", flush=True)
    else:
        nb = sep_selftest.launch_card(SEP, nccl=True, layers=STAGE3_LAYERS,
                                      deadline=600)["gpt"]["ranks"][0]
        say(f"[29/{PHASES}] (e) sep {SEP} over NCCL, one card a rank: "
              f"losses {nb['losses']}, step s {nb['step_s']}; "
              f"{nvidia_smi()}", flush=True)
        if max(abs(x - y) for x, y in zip(nb["losses"], want["losses"])) \
                >= SEP_LOSS_BAR:
            raise AssertionError(f"sep over NCCL: {nb}")
    rows = {(row["dtype"], row["causal"]): row["launches"]
            for row in ring[0]["rows"]}
    return ({"causal": rows[("bfloat16", True)],
             "full": rows[("bfloat16", False)]},
            b["ranks"][0]["launches_per_step"])


# phase 30: sep beside mp and pp (BASELINE config 5 in one run)
SEP_HYBRID_LAYERS = 4              # of LLaMA-7B's 32
SEP_HYBRID_BATCH = 2               # rows of 2048 tokens
SEP_HYBRID_STEPS, SEP_HYBRID_PP_STEPS, SEP_HYBRID_MICRO = 3, 2, 2
SEP_HYBRID_SHARD = (2048, 32000, 4096)   # phase 30(a)'s CE shard (mp 2)


def _sep_mp_collectives(layers, buckets):
    """A rank's collectives a step at mp 2 x sep 2 (counted from the
    design): over mp the batch's two broadcasts (`SegmentParallel` sends
    mp rank 0's ids and labels before the cut) and the sums of
    `_llama_mp_collectives`; over sep each layer's K/V rotation three
    times a step each way (the forward, the recompute's replay, the
    backward's reverse ring) and the loss's one sum of the token losses
    and counts; the grads' ``buckets`` over dp+sep; the loss's mean over
    the data axes."""
    c = {"broadcast@mp": 2, "send@sep": 3 * layers, "recv@sep": 3 * layers,
         "all_reduce@sep": 1, "all_reduce@dp+sep": buckets}
    c.update(_llama_mp_collectives(layers))
    return c


def _sep_pipe_collectives(stage, layers, micro, buckets):
    """A rank's collectives a step at tp 2 x pp 2 x sep 2 (``layers`` a
    stage): `_llama_pp_collectives`', and over sep each layer's K/V
    rotation three times a micro-batch each way and, on the last stage,
    the criterion's sum a micro-batch; the grads' ``buckets`` over
    dp+sep."""
    c = _llama_pp_collectives(stage, layers, micro)
    c.update({"send@sep": 3 * layers * micro, "recv@sep": 3 * layers * micro,
              "all_reduce@dp+sep": buckets})
    if stage == LLAMA_PP - 1:
        c["all_reduce@sep"] = micro
    return c


def sep_beside_mp_pp(dev):
    """Phase 30: LLaMA-7B's widths at 4 of 32 layers, bf16 O2 (phase 16's
    dtypes), ``use_ring_attention=True``, 2 x 2048 tokens, weights from
    seed 0: (a) #11 / #12 on the rank's vocab-parallel head shard at mp
    2 over a rank's block of rows (`_mp_ce_case`); mp 2 x sep 2, four
    gloo ranks sharing the card (`llama_selftest.launch_card(4, sep=2)`:
    ``fleet.init`` -> ``distributed_model`` (`SegmentParallel`) ->
    ``train_step``), 3 steps; (b) tp 2 x pp 2 x sep 2, eight ranks
    (`LlamaForCausalLMPipe` -> `PipelineParallel.train_batch`, 2
    micro-batches), 2 steps; each step's loss within `LLAMA_LOSS_BAR` of
    a world-of-one `TrainStep` on the same weights and batch, computed
    first here; the ranks' losses identical; launches and collectives a
    step exact; (c) the tiny fp32 GQA LLaMA with the ring card against
    CPU over the same ranks (mp 2 x sep 2, mp 2 x pp 2 x sep 2). Returns a
    rank's launches a step at mp 2 x sep 2, and at tp 2 x pp 2 x sep 2 by
    stage (mp and sep rank 0's), and the shard's record."""
    from paddle_tpu_torch.distributed import llama_selftest

    L = SEP_HYBRID_LAYERS
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    shard = _mp_ce_case(dev, flush, torch.bfloat16, 2,
                        shape=SEP_HYBRID_SHARD)
    del flush
    say(f"[30/{PHASES}] (a) #11 / #12 on phase 30(a)'s head shard (h "
        f"[{SEP_HYBRID_SHARD[0]}, {SEP_HYBRID_SHARD[2]}] bf16 over W shard "
        f"[{SEP_HYBRID_SHARD[1] // 2}, {SEP_HYBRID_SHARD[2]}]): "
        f"{json.dumps(shard)}; {nvidia_smi()}")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama_selftest.full_width_config(num_layers=L,
                                           use_ring_attention=True)
    t0 = time.perf_counter()
    want = llama_selftest.world_one(dev, steps=SEP_HYBRID_STEPS,
                                    batch=SEP_HYBRID_BATCH, cfg=cfg)
    world1_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = llama_selftest.launch_card(4, steps=SEP_HYBRID_STEPS, sep=SEP,
                                     layers=L, batch=SEP_HYBRID_BATCH,
                                     deadline=300)
    wall = time.perf_counter() - t0
    b = res["llama_7b"]
    gaps = [abs(x - y) for x, y in zip(b["losses"], want)]
    per_step = b["launches_per_step"]
    coll = dict(b["collectives_per_step"]["by_group"])
    want_c = _sep_mp_collectives(L, b["grad_buckets"])
    report = {"model": "llama-7b widths", "layers": L,
              "cut": f"depth {L} of 32 layers", "mp": 2, "sep": SEP,
              "backend": res["backend"], "tokens": [SEP_HYBRID_BATCH, 2048],
              "losses": b["losses"], "world1_losses": want,
              "loss_gaps": gaps, "rank_losses": b["rank_losses"],
              "step_s": b["step_s"], "launches_per_step": per_step,
              "collectives_per_step": b["collectives_per_step"],
              "grad_buckets": b["grad_buckets"], "head_rows": b["head_rows"],
              "max_memory_allocated_rank0": b["max_memory_allocated"],
              "types": b["types"], "world1_s": world1_s,
              "launch_wall_s": wall, "nvidia_smi": nvidia_smi()}
    say(f"[30/{PHASES}] (a) LLaMA-7B widths at mp 2 x sep 2, ring on, four "
        f"ranks sharing the card over gloo (activations, K/V and grads "
        f"through the host: no speed): {json.dumps(report)}")
    if not (len(gaps) == SEP_HYBRID_STEPS and max(gaps) < LLAMA_LOSS_BAR
            and all(np.isfinite(b["losses"]))):
        raise AssertionError(f"mp x sep losses {b['losses']} against world "
                             f"1 {want}")
    if any(r != b["rank_losses"][0] for r in b["rank_losses"]):
        raise AssertionError(f"ranks' losses differ: {b['rank_losses']}")
    if b["types"][0] != "SegmentParallel" or \
            b["head_rows"] != SEP_HYBRID_SHARD[1] // 2:
        raise AssertionError(f"mp x sep wrapper / head rows: {b['types']}, "
                             f"{b['head_rows']}")
    if per_step != _llama_mp_launches():
        raise AssertionError(f"mp x sep launches a step {per_step}, want "
                             f"{_llama_mp_launches()}")
    if coll != want_c:
        raise AssertionError(f"mp x sep collectives a step {coll}, want "
                             f"{want_c}")
    t0 = time.perf_counter()
    pres = llama_selftest.launch_card(8, steps=SEP_HYBRID_PP_STEPS,
                                      pp=LLAMA_PP, sep=SEP, layers=L,
                                      batch=SEP_HYBRID_BATCH,
                                      micro=SEP_HYBRID_MICRO, deadline=360)
    pwall = time.perf_counter() - t0
    ranks = pres["llama_7b"]["ranks"]
    pgaps = [abs(x - y) for x, y in zip(pres["llama_7b"]["losses"], want)]
    report = {"model": "llama-7b widths", "layers": L, "tp": 2,
              "pp": LLAMA_PP, "sep": SEP, "micro": SEP_HYBRID_MICRO,
              "losses": pres["llama_7b"]["losses"],
              "world1_losses": want[:SEP_HYBRID_PP_STEPS],
              "loss_gaps": pgaps,
              "ranks": [{k: r[k] for k in (
                  "rank", "stage", "mp_rank", "sep_rank", "layers",
                  "losses", "step_s", "p2p_per_step", "grad_buckets",
                  "max_memory_allocated", "launches_per_step")}
                  for r in ranks],
              "collectives_per_step_rank0": ranks[0]["collectives_per_step"],
              "launch_wall_s": pwall, "nvidia_smi": nvidia_smi()}
    say(f"[30/{PHASES}] (b) BASELINE config 5's layout at tp 2 x pp 2 x sep "
        f"2, ring on: eight ranks sharing the card over gloo (no speed; tp "
        f"4 is phase 26's): {json.dumps(report)}")
    if not (len(pgaps) == SEP_HYBRID_PP_STEPS
            and max(pgaps) < LLAMA_LOSS_BAR
            and all(np.isfinite(pres["llama_7b"]["losses"]))):
        raise AssertionError(f"tp x pp x sep losses "
                             f"{pres['llama_7b']['losses']} against world 1 "
                             f"{want}")
    if any(r["losses"] != ranks[0]["losses"] for r in ranks):
        raise AssertionError(f"tp x pp x sep ranks' losses differ: {ranks}")
    lps = L // LLAMA_PP
    for r in ranks:
        if r["layers"] != lps or r["wrapper"] != "PipelineParallel":
            raise AssertionError(f"tp x pp x sep rank {r['rank']}: "
                                 f"{r['layers']} layers, {r['wrapper']}")
        if r["launches_per_step"] != _llama_pp_launches():
            raise AssertionError(
                f"tp x pp x sep rank {r['rank']} launches a step "
                f"{r['launches_per_step']}, want {_llama_pp_launches()}")
        want_c = _sep_pipe_collectives(r["stage"], lps, r["micro"],
                                       r["grad_buckets"])
        if dict(r["collectives_per_step"]["by_group"]) != want_c:
            raise AssertionError(
                f"tp x pp x sep rank {r['rank']} collectives a step "
                f"{r['collectives_per_step']['by_group']}, want {want_c}")
    tiny = [res["tiny_card_cpu"], pres["tiny_card_cpu"]]
    say(f"[30/{PHASES}] (c) tiny fp32 GQA LLaMA (KV heads 2) with the ring, "
        f"card against CPU over the same gloo ranks: mp 2 x sep 2 "
        f"{json.dumps(tiny[0])}; mp 2 x pp 2 x sep 2 {json.dumps(tiny[1])}; "
        f"{nvidia_smi()}")
    for t in tiny:
        if not (t["max_loss_diff"] < 1e-4 and t["max_param_rel"] < 1e-3):
            raise AssertionError(f"LLaMA under sep card against CPU: {t}")
    return (per_step, {r["stage"]: r["launches_per_step"] for r in ranks
                       if r["mp_rank"] == 0 and r["sep_rank"] == 0}, shard)


# ---------------------------------------------------------------------------
# phase 31: mixture-of-experts on one card
# ---------------------------------------------------------------------------

MOE_LAYERS = 8       # of GPT-3 1.3B's 24: 24 layers' expert stacks are 6.4 B
MOE_EXPERTS = 8
# a step of phase 31(b): each layer's splash forward twice (the forward
# pass and the update pass's recompute) and its backward once, the CE
# once each way, one mt_adam_kernel a layer and one for the rest
MOE_LAUNCHES = {"splash_fwd_wgmma_kernel": 2 * MOE_LAYERS,
                "splash_bwd_wgmma_kernels": MOE_LAYERS,
                "fused_ce_fwd_wgmma_kernel": 1, "fused_ce_bwd_kernels": 1,
                "mt_adam_kernel": MOE_LAYERS + 1}


class _RouteLog:
    """While open, records each gate call of ``model`` (its eager
    blocks' gates, or a scan stack's template gate): the ``(experts,
    slots, keep)`` tensors `route` returned, left on their device."""

    def __init__(self, model):
        blocks = model.gpt.blocks
        held = getattr(blocks, "_template", None)
        self.gates = [b.mlp.moe.gate for b in
                      ([held] if held is not None else blocks)]
        self.calls = []

    def __enter__(self):
        for g in self.gates:
            def record(logits, capacity, real=g.route):
                out = real(logits, capacity)
                self.calls.append(out[:3])
                return out
            g.route = record
        return self

    def __exit__(self, *exc):
        for g in self.gates:
            del g.route         # the class's method again


def _moe_tiny(gate, cf, **over):
    from paddle_tpu_torch.models import GPTConfig

    return GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                     num_attention_heads=4, max_position_embeddings=128,
                     num_experts=4, moe_gate=gate, moe_capacity_factor=cf,
                     **over)


def _moe_weights(cfg, rng):
    """Random eager weights of ``cfg`` and the same as a scan model's
    stacks."""
    from paddle_tpu_torch.models import GPTForCausalLM

    sd = {name: torch.from_numpy(
              (rng.standard_normal(tuple(t.shape)) * 0.3).astype(np.float32))
          for name, t in GPTForCausalLM(cfg, device="cpu")
          .state_dict().items()}
    scan = GPTForCausalLM(dataclasses.replace(cfg, scan_layers=True),
                          device="cpu")
    stacked = dict(scan.gpt.blocks._stacked_names)
    scan_sd = {}
    for name in scan.state_dict():
        flat = name.rsplit(".", 1)[-1]
        scan_sd[name] = (torch.stack([
            sd[f"gpt.blocks.{i}.{stacked[flat]}"]
            for i in range(cfg.num_layers)]) if flat in stacked
            else sd[name])
    return sd, scan_sd


def moe_parity(dev):
    """Phase 31(a): a tiny fp32 MoE GPT (hidden 64, 2 layers, 4 heads, 4
    experts; gshard at capacity factor 1, then switch at 0.75, so tokens
    drop), card against CPU: 3 `TrainStep`s through ``model.loss``
    (AdamW, `ClipGradForMOEByGlobalNorm`, recompute "dots") and 3
    `FusedScanTrainStep`s of its ``scan_layers`` twin at ``layer_chunk``
    1 and 2, from the same weights, over packed documents (segment ids:
    the splash kernel at 128 tokens). Every gate call of the first step
    routes alike (experts, slots, drops); losses within 1e-4, parameters
    1e-3 relative; the fp32 splash and CE kernels and the optimizer's two
    ran, no other training kernel."""
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        ClipGradForMOEByGlobalNorm)
    from paddle_tpu_torch.jit import FusedScanTrainStep, TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    seq = 128
    rng = np.random.default_rng(31)
    ids = rng.integers(0, 128, (2, seq))
    labels = rng.integers(0, 128, (2, seq))
    seg = _segments(2, seq, 3, rng)       # packed documents: splash
    counters = _TrainCounters()
    counters.zero()
    rows = []
    for gate, cf in (("gshard", 1.0), ("switch", 0.75)):
        cfg = _moe_tiny(gate, cf, use_recompute=True,
                        recompute_policy="dots")
        sd, scan_sd = _moe_weights(cfg, rng)
        for path in ("TrainStep", "fused layer_chunk 1",
                     "fused layer_chunk 2"):
            fused = path != "TrainStep"
            out = {}
            for where in ("card", "cpu"):
                d = dev if where == "card" else torch.device("cpu")
                model = _scan_gpt(d, scan_sd if fused else sd,
                                  dataclasses.replace(cfg,
                                                      scan_layers=fused))
                opt = AdamW(learning_rate=1e-3,
                            parameters=model.parameters(),
                            grad_clip=ClipGradForMOEByGlobalNorm(1.0))
                step = (FusedScanTrainStep(model, opt, fused_head=True,
                                           layer_chunk=int(path[-1]))
                        if fused else
                        TrainStep(model, lambda m, x, y, s: m.loss(
                            x, y, segment_ids=s), opt))
                batch = [torch.from_numpy(a).to(d)
                         for a in (ids, labels, seg)]
                with _RouteLog(model) as log:
                    losses = [float(step(*batch))]
                routes = [[t.cpu() for t in call] for call in log.calls]
                losses += [float(step(*batch)) for _ in range(2)]
                out[where] = {"losses": losses, "routes": routes,
                              "params": {k: t.detach().cpu() for k, t in
                                         model.state_dict().items()}}
            card, cpu_ = out["card"], out["cpu"]
            same = len(card["routes"]) == len(cpu_["routes"]) and all(
                torch.equal(a, b) for ca, cb in zip(card["routes"],
                                                    cpu_["routes"])
                for a, b in zip(ca, cb))
            first = cpu_["routes"][:cfg.num_layers]
            rows.append({
                "gate": gate, "capacity_factor": cf, "path": path,
                "routing_equal": same, "gate_calls": len(card["routes"]),
                "dropped_share_by_layer": [
                    float((~keep).float().mean()) for _, _, keep in first],
                "losses_card": card["losses"], "losses_cpu": cpu_["losses"],
                "max_loss_diff": max(abs(a - b) for a, b in
                                     zip(card["losses"], cpu_["losses"])),
                "max_param_rel": max(_rel_err(card["params"][k],
                                              cpu_["params"][k])
                                     for k in cpu_["params"])})
    launches = counters.read()
    say(f"[31/{PHASES}] (a) tiny fp32 MoE GPT card against CPU: "
        f"{json.dumps(rows)}; kernel launches "
        f"{ {k: n for k, n in launches.items() if n} }", flush=True)
    for r in rows:
        if not (r["routing_equal"] and r["max_loss_diff"] <= 1e-4
                and r["max_param_rel"] <= 1e-3
                and all(np.isfinite(r["losses_card"]))):
            raise AssertionError(f"MoE card against CPU: {r}")
        if not any(r["dropped_share_by_layer"]):
            raise AssertionError(f"MoE parity dropped no token: {r}")
    _check_launches(launches, _path_kernels(seq, True, bf16=False),
                    "MoE parity")


def moe_full_width(dev, warmup=2, timed=5, batch=8, seq=1024):
    """Phase 31(b): GPT-3 1.3B's widths with `MOE_EXPERTS` experts a
    layer (gshard, capacity factor 2.0) at `MOE_LAYERS` of its 24
    layers, through ``FusedScanTrainStep`` at phase 14's configuration
    (fp32 parameters, AdamW(1e-4) with bf16 moments, the fused head, bf16
    compute, one layer a chunk, the numerics monitor on) over ``batch`` x
    ``seq`` random tokens: ``warmup`` + ``timed`` steps, the counters
    zeroed just before the timed ones and read just after; then one step
    under sync debug mode "error" whose gate calls give each layer's
    dropped share. ``mfu`` counts each token's two experts' FFNs, not
    all eight. Returns the launches of the timed steps and their
    count."""
    from paddle_tpu_torch.jit import FusedScanTrainStep
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt_config)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = gpt_config("gpt3-1.3b", num_layers=MOE_LAYERS,
                     num_experts=MOE_EXPERTS, scan_layers=True,
                     use_recompute=True, recompute_policy="dots",
                     max_position_embeddings=seq, hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.float32, seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                moment_dtype="bfloat16")
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (batch, seq))).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (batch, seq))).to(dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    params = sum(p.numel() for p in model.parameters())
    experts = sum(p.numel() for n, p in model.named_parameters()
                  if "experts__" in n)
    top_k = model.gpt.blocks._template.mlp.moe.gate.top_k
    active = params - experts + experts * top_k // cfg.num_experts
    tokens = batch * seq
    attn = 6 * 2.0 * batch * seq * (seq + 1) / 2 * cfg.hidden_size \
        * cfg.num_layers
    step = FusedScanTrainStep(model, opt, criterion=GPTPretrainingCriterion(),
                              fused_head=True, compute_dtype="bfloat16",
                              layer_chunk=1)
    losses = [float(step(ids, labels)) for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _TrainCounters()
    counters.zero()
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = counters.read()
    peak = torch.cuda.max_memory_allocated()
    # the routing reads nothing back: a step under sync debug "error"
    torch.cuda.set_sync_debug_mode("error")
    try:
        with _RouteLog(model) as log:
            loss = step(ids, labels)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    losses.append(float(loss))
    dropped = [float((~keep).float().mean())
               for _, _, keep in log.calls[:cfg.num_layers]]
    step_s = statistics.median(times)
    per_step = {k: n / timed for k, n in launches.items() if n}
    stats = {
        "model": "gpt3-1.3b widths", "layers": cfg.num_layers,
        "experts": cfg.num_experts, "gate": cfg.moe_gate,
        "capacity_factor": cfg.moe_capacity_factor, "top_k": top_k,
        "capacity": model.gpt.blocks._template.mlp.moe.capacity(tokens),
        "seq": seq, "batch": batch, "params": params,
        "expert_params": experts, "active_params_per_token": active,
        "setup_s": setup_s, "memory_allocated_before": before,
        "losses": losses, "step_ms": [t * 1e3 for t in times],
        "step_ms_median": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "mfu": (6.0 * active * tokens + attn) / step_s / BF16_FLOP_PER_S,
        "max_memory_allocated": peak,
        "dropped_share_by_layer": dropped,
        "launches_per_step": per_step, "step_count": opt._step_count,
        "nvidia_smi": nvidia_smi()}
    say(f"[31/{PHASES}] (b) train gpt3-1.3b widths, {cfg.num_experts} "
        f"experts, {cfg.num_layers} layers, FusedScanTrainStep: "
        f"{json.dumps(stats)}", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite MoE loss: {losses}")
    first = math.log(cfg.vocab_size) + cfg.moe_aux_weight
    if abs(losses[0] - first) > 0.5:
        raise AssertionError(f"MoE first loss {losses[0]}, expected near "
                             f"ln(vocab) + the weighted aux {first}")
    expect = dict(MOE_LAUNCHES, mt_norm_kernel=per_step.get(
        "mt_norm_kernel", 0))
    if not expect["mt_norm_kernel"] or per_step != expect:
        raise AssertionError(f"MoE launches a step {per_step}, expected "
                             f"{MOE_LAUNCHES} and the monitor's "
                             f"mt_norm_kernel")
    if opt._step_count != warmup + timed + 1:
        raise AssertionError(f"step count {opt._step_count}")
    if not (0.0 <= min(dropped) and max(dropped) < 1.0):
        raise AssertionError(f"dropped shares {dropped}")
    del step, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {k: n for k, n in launches.items() if n}, timed


def moe_generate(dev, new=12):
    """Phase 31(c): a tiny MoE GPT's greedy tokens through a dense
    `GenerationEngine` (``generate(use_cache="dense")``'s engine), card
    against CPU from the same weights; on the card one prompt graph and
    one decode graph captured in the warm-up call and none after."""
    from paddle_tpu_torch.jit import GenerationEngine

    cfg = _moe_tiny("gshard", 1.0)
    rng = np.random.default_rng(33)
    sd, _ = _moe_weights(cfg, rng)
    ids = rng.integers(0, cfg.vocab_size, (2, 16))
    toks, caps = {}, {}
    for where in ("card", "cpu"):
        d = dev if where == "card" else torch.device("cpu")
        model = _scan_gpt(d, sd, cfg).eval()
        eng = GenerationEngine(model, kind="dense", batch=2, max_len=64)
        eng.generate(ids, 2)
        got = [(eng.prefill_step.trace_count, eng.decode_step.trace_count)]
        toks[where] = eng.generate(ids, new).numpy()
        got.append((eng.prefill_step.trace_count,
                    eng.decode_step.trace_count,
                    eng.prefill_step.cache_size(),
                    eng.decode_step.cache_size()))
        caps[where] = got
    same = bool(np.array_equal(toks["card"], toks["cpu"]))
    say(f"[31/{PHASES}] (c) tiny MoE GPT greedy dense generation: tokens "
        f"card {toks['card'].tolist()} cpu {toks['cpu'].tolist()} equal "
        f"{same}; card (prompt, decode) captures after the warm-up call "
        f"and after the run, graphs {caps['card']}", flush=True)
    if not same:
        raise AssertionError("MoE generation: card and CPU tokens differ")
    if caps["card"] != [(1, 1), (1, 1, 1, 1)]:
        raise AssertionError(f"MoE generation captures {caps['card']}")


def mixture_of_experts(dev):
    """Phase 31: (a) `moe_parity`, (b) `moe_full_width`, (c)
    `moe_generate`. Returns (b)'s launches and its timed steps."""
    moe_parity(dev)
    ran = moe_full_width(dev)
    moe_generate(dev)
    return ran


# the contract's keys of a kernel's record (every launch count stays too)
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")


def main() -> int:
    try:
        return _main()
    except BaseException:
        _LINES.close("failed")
        raise


def _main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    from paddle_tpu_torch.framework import resolve_device
    from paddle_tpu_torch.ops.kernels import _build

    dev = resolve_device()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    say(f"[1/{PHASES}] device: {kind}, count {count}; nvidia-smi: {smi}",
          flush=True)

    t0 = time.perf_counter()
    built = _build.build()
    regs = [line.strip() for info in built.values()
            for line in info["log"].splitlines() if "registers" in line]
    say(f"[2/{PHASES}] build: {sorted(built) or 'up to date'} in "
          f"{time.perf_counter() - t0:.1f} s; ptxas: {regs}", flush=True)
    check_wgmma_kernels(built)
    check_multi_tensor_build(built)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    kernels = check_kernels(dev, flush)
    kernels.update(check_training_kernels(dev, flush))
    kernels.update(check_flash_kernels(dev, flush))
    kernels.update(check_optimizer_kernels(dev, flush))
    llama_ce = check_llama_ce(dev, flush)
    weight_only = check_weight_only(dev, flush)
    del flush
    torch.cuda.empty_cache()
    parity(dev)

    from paddle_tpu_torch.models import GPTForCausalLM, gpt_config

    model = GPTForCausalLM(gpt_config("gpt3-1.3b"), device=dev,
                           dtype=torch.bfloat16, seed=0)
    launches, bf16 = serve_full_width(dev, model)
    for quant in ("int8", "int4"):
        ran, stats = serve_full_width(dev, model, quant, phase=6)
        launches.update(ran)
        ratio = stats["pool_bytes"] / bf16["pool_bytes"]
        say(f"[6/{PHASES}] {quant} pools: pool_bytes {ratio:.4f}x the "
              f"bf16 run's, effective_slots_vs_bf16 "
              f"{stats['effective_slots_vs_bf16']}, output tok/s "
              f"{stats['output_tok_s']} vs {bf16['output_tok_s']} (graphs; "
              f"eager {stats['eager']['output_tok_s']} vs "
              f"{bf16['eager']['output_tok_s']})", flush=True)
    generate_full_width(dev, model)
    del model
    torch.cuda.empty_cache()
    train_parity(dev)
    with routing_flags(splash_attn=False):
        with routing_flags(pallas_flash_min_seqlen=16):
            train_parity(dev, splash=False, seq=128)
        train_parity(dev, splash=False, seq=1280)
    train_guarded_parity(dev)
    steps = {}
    ran, n = train_full_width(dev)
    launches.update(ran)
    steps.update(dict.fromkeys(ran, n))
    with routing_flags(splash_attn=False):
        for batch, seq in ((8, 1024), (4, 2048)):
            ran, n = train_full_width(dev, timed=3, batch=batch, seq=seq,
                                      splash=False, phase=10)
            launches.update({k: m for k, m in ran.items()
                             if k not in CE_KERNELS + OPT_KERNELS})
            steps.update({k: n for k in ran
                          if k not in CE_KERNELS + OPT_KERNELS})
    for name, base in RING_TICK.items():
        launches[name], steps[name] = launches[base], steps[base]
    resnet_parity(dev)
    resnet_full_width(dev)
    fused_scan_parity(dev)
    fused, fused_steps = fused_scan_full_width(dev)
    llama_parity(dev)
    llama_o2_parity(dev)
    llama, llama_steps = llama_full_width(dev)
    lane, lane_passes = decode_lane(dev)
    spec = spec_decode(dev)
    bert_parity(dev)
    dropout_contract(dev)
    bert, bert_steps = bert_full_width(dev)
    lenet_parity(dev)
    lenet_full_loop(dev)
    collectives_world1(dev)
    sharded, sharded_steps = sharded_training(dev)
    mp_shards = vocab_parallel_kernels(dev)
    mp_launches, world1 = tensor_parallel_two_ranks(dev)
    pp_launches = pipeline_two_ranks(dev, world1)
    llama_shards = llama_head_shards(dev)
    llama_mp_launches, llama_pp_launches = llama_hybrid(dev)
    t0 = time.perf_counter()
    zb_launches = zero_bubble_two_ranks(dev)
    say(f"[27/{PHASES}] wall {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    stage3_launches = stage3_two_ranks(dev)
    say(f"[28/{PHASES}] wall {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    sep_ring, sep_launches = sep_two_ranks(dev)
    say(f"[29/{PHASES}] wall {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    sep_mp_launches, sep_hybrid_launches, sep_shard = sep_beside_mp_pp(dev)
    say(f"[30/{PHASES}] wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moe, moe_steps = mixture_of_experts(dev)
    say(f"[31/{PHASES}] wall {time.perf_counter() - t0:.1f} s")

    where = {name: (PAGED_SOURCE, f"{PAGED_TPU}:{line}")
             for name, (_, _, _, line) in PAGED_KERNELS.items()}
    where.update({
        "splash_fwd_wgmma_kernel": (
            SPLASH_SOURCE, "paddle_tpu/ops/pallas/splash_attention.py:139"),
        "splash_bwd_wgmma_kernels": (
            SPLASH_SOURCE, "paddle_tpu/ops/pallas/splash_attention.py:255"),
        "fused_ce_fwd_wgmma_kernel": (
            CE_SOURCE, "paddle_tpu/ops/pallas/fused_cross_entropy.py:92"),
        "fused_ce_bwd_kernels": (
            CE_SOURCE, "paddle_tpu/ops/pallas/fused_cross_entropy.py:161"),
    })
    where.update({name: (FLASH_SOURCE, f"{FLASH_TPU}:{line}")
                  for name, line in FLASH_LINES.items()})
    where.update({name: where[base] for name, base in RING_TICK.items()})
    where.update({name: (MT_SOURCE, line)
                  for name, line in MT_REPLACES.items()})
    keys = ("max_abs_err", "max_abs_err_fp32", "max_rel_err",
            "max_rel_err_fp32", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library", "shape", "causal", "fp32_route",
            "pages_route", "pages_route_max_abs_err",
            "pages_route_max_abs_err_fp32", "pages_route_ms",
            "old_route", "old_route_max_abs_err", "old_route_ms",
            "max_ulps", "config", "verify")
    line = [{"name": name, "route": "cuda", "source": where[name][0],
             "replaces": where[name][1], "launches": launches[name],
             **({"launches_per_step": launches[name] / steps[name]}
                if name in steps else {}),
             **({"launches_fused_scan": fused[name],
                 "launches_fused_scan_per_step": fused[name] / fused_steps}
                if name in fused else {}),
             **({"launches_llama": llama[name],
                 "launches_llama_per_step": llama[name] / llama_steps}
                if name in llama else {}),
             **({"launches_bert": bert[name],
                 "launches_bert_per_step": bert[name] / bert_steps}
                if name in bert else {}),
             **({"launches_sharded_scan": sharded[name],
                 "launches_sharded_scan_per_step":
                     sharded[name] / sharded_steps}
                if name in sharded else {}),
             **({"llama_shapes": llama_ce[name]} if name in llama_ce
                else {}),
             # phase 24(b): a rank's launches a step at dp 1 x mp 2
             **({"launches_mp": mp_launches[name]}
                if name in mp_launches else {}),
             # phase 25(a): a rank's launches a step at dp 1 x pp 2
             **({"launches_pp": {f"stage{st}": ran[name]
                                 for st, ran in sorted(pp_launches.items())}}
                if name in pp_launches[0] else {}),
             # phase 26(b): a rank's launches a step at LLaMA-7B's
             # widths, dp 1 x mp 4
             **({"launches_llama_mp": llama_mp_launches[name]}
                if name in llama_mp_launches else {}),
             # phase 26(c): a rank's launches a step at tp 4 x pp 2
             **({"launches_llama_pp": {
                 f"stage{st}": ran[name]
                 for st, ran in sorted(llama_pp_launches.items())}}
                if name in llama_pp_launches[0] else {}),
             # phase 27(a): a rank's launches of a forward and backward
             # through the zero-bubble ring at pp 2, by stage
             **({"launches_zb": {st: ran[name]
                                 for st, ran in sorted(zb_launches.items())}}
                if name in zb_launches["stage0"] else {}),
             # phase 28(a): a rank's launches a step under stage 3
             **({"launches_stage3": stage3_launches[name]}
                if name in stage3_launches else {}),
             # phase 29(a): sep rank 0's launches a ring call (bf16), by
             # mode
             **({"launches_sep_ring": {
                 mode: ran["flash_fwd" if "fwd" in name else "flash_bwd"]
                 for mode, ran in sep_ring.items()}}
                if name in ("flash_fwd_wgmma_kernel",
                            "flash_bwd_wgmma_kernels") else {}),
             # phase 29(b): a rank's launches a step at sep 2
             **({"launches_sep": sep_launches[name]}
                if name in sep_launches else {}),
             # phase 30(a): a rank's launches a step at mp 2 x sep 2;
             # (b): at tp 2 x pp 2 x sep 2, by stage
             **({"launches_sep_mp": sep_mp_launches[name]}
                if name in sep_mp_launches else {}),
             # phase 31(b): the MoE fused-scan step's (8 layers)
             **({"launches_moe": moe[name],
                 "launches_moe_per_step": moe[name] / moe_steps}
                if name in moe else {}),
             **({"launches_sep_hybrid": {
                 f"stage{st}": ran[name]
                 for st, ran in sorted(sep_hybrid_launches.items())}}
                if name in sep_hybrid_launches[0] else {}),
             # phase 30(a): the rank's head shard at mp 2 x sep 2
             **({"sep_mp_shard": {k: sep_shard[k]
                                  for k in ("shape", "errors")}
                 | sep_shard["fwd" if "fwd" in name else "bwd"]}
                if name in ("fused_ce_fwd_wgmma_kernel",
                            "fused_ce_bwd_kernels") else {}),
             # phase 26(a): the shards of LLaMA-7B's head at mp 2 and 4
             **({"llama_mp_shards": {
                 mp: {k: rec[k] for k in ("shape", "errors")}
                 | rec["fwd" if "fwd" in name else "bwd"]
                 for mp, rec in llama_shards.items()}}
                if name in ("fused_ce_fwd_wgmma_kernel",
                            "fused_ce_bwd_kernels") else {}),
             **({"mp_shards": {
                 dt: {mp: {k: rec[k] for k in ("shape", "errors")}
                      | rec["fwd" if "fwd" in name else "bwd"]
                      for mp, rec in recs.items()}
                 for dt, recs in mp_shards.items()}}
                if name in ("fused_ce_fwd_wgmma_kernel",
                            "fused_ce_bwd_kernels") else {}),
             **({"launches_per_spec_dispatch": spec[name]} if name in spec
                else {}),
             **{k: r[k] for k in keys if k in r}}
            for name, r in kernels.items()]
    for route, name in WO_KERNELS.items():
        r = weight_only[name]
        line.append({"name": name, "route": "cuda", "source": WO_SOURCE,
                     "replaces": WO_REPLACES, "launches": lane[route],
                     # the decode routes' a decode step, the prompt
                     # routes' a prompt pass, in the runs that took them
                     "launches_per_step": lane[route] / lane_passes[route],
                     **{k: r[k] for k in ("max_abs_err", "max_rel_err", "ms",
                                          "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "library",
                                          "dequant_linear_ms", "shape",
                                          "stream_ms", "library_stream_ms",
                                          "config", "row_keys", "rows")}})
    say(f"[19/{PHASES}] kernels (whole in the log; on stdout the "
        f"contract's keys and the launches):")
    _LINES.log.write(json.dumps({"kernels": line}) + "\n")
    _LINES.close()
    print(json.dumps({"kernels": [
        {k: v for k, v in r.items() if k in KERNEL_KEYS
         or k.startswith("launches")} for r in line]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
