"""Speculative-decoding probe and serving A/B of the port.

    python -m paddle_tpu_torch.inference.spec_decode_selftest
        [--bench] [--device cuda|cpu]

Counterpart of paddle_tpu/inference/spec_decode_selftest.py; prints one
JSON line. Both modes run on the card unless ``--device cpu`` asks for
the CPU (the probe only: ``--bench`` times the card and refuses the
CPU). Two modes:

* default (`run_probe`): greedy speculative tokens equal plain greedy
  decoding's over dense, paged, int8 and int4 caches with a weak,
  independent draft (losslessness must not hang on the draft), with the
  target's draft heads (``draft_model="self"``: no draft parameters, no
  draft cache), and with the strong pair (exactly ceil((n-1)/(k+1))
  dispatches); serving parity, the accept-rate gauge, no leaked page;
  the pools' capacity receipts. The emitted tokens of each case are in
  the record, so two devices' runs can be compared.
* ``--bench`` (`run_bench`): the same traffic through a plain
  ``ServingEngine`` and speculative ones (the strong pair over fp, int8
  and int4 pools; the zero target with ``draft_model="self"`` against
  its own plain run, both over int4 pools): output tokens/s a user, the
  speedups, the accept rate and tokens a dispatch.

The strong pair is built, not trained: the target's blocks past block 0
have their residual writes (``attn.out_proj``, ``mlp.fc2``) zeroed, so a
one-layer draft holding the target's embeddings, block 0 and ``ln_f``
computes the target's logits and greedy acceptance is 1.0. The zero
target (every parameter 0, ``num_draft_heads=k``) gives logits of 0
everywhere, so every argmax is token 0 and the self-draft accepts
everything too.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..framework.device import resolve_device
from ..models import GPTConfig, GPTForCausalLM

__all__ = ["strong_pair", "zero_self_target", "run_probe", "run_bench"]

TINY = dict(vocab_size=97, hidden_size=32, num_layers=2,
            num_attention_heads=4, max_position_embeddings=256)


def _tiny(device, seed=0, **over):
    """The tiny GPT, its weights drawn on the CPU (the same on every
    device) and moved to ``device``."""
    m = GPTForCausalLM(GPTConfig(**{**TINY, **over}), device="cpu",
                       seed=seed)
    return m.to(device).eval()


def strong_pair(config=None, device=None, dtype=torch.float32, seed=0):
    """(target, draft) with greedy accept rate 1.0: the target of
    ``config`` (default the tiny GPT) with the residual writes of every
    block but block 0 zeroed, and a one-layer draft holding its
    embeddings, block 0, ``ln_f`` (and untied head)."""
    cfg = config or GPTConfig(**TINY)
    tgt = GPTForCausalLM(cfg, device=device, dtype=dtype, seed=seed).eval()
    with torch.no_grad():
        for name, p in tgt.named_parameters():
            if name.startswith("gpt.blocks.") and \
                    not name.startswith("gpt.blocks.0.") and \
                    (".attn.out_proj." in name or ".mlp.fc2." in name):
                p.zero_()
    dcfg = GPTConfig(**{**vars(cfg), "num_layers": 1})
    drf = GPTForCausalLM(dcfg, device=device, dtype=dtype, seed=seed + 1)
    drf.load_state_dict({k: v for k, v in tgt.state_dict().items()
                         if k in drf.state_dict()})
    return tgt, drf.eval()


def zero_self_target(spec_k=4, config=None, device=None,
                     dtype=torch.float32):
    """A target with draft heads whose every parameter is 0: base, head
    and verify logits are all 0, so greedy self-speculation accepts
    every proposal."""
    cfg = config or GPTConfig(**TINY)
    cfg = GPTConfig(**{**vars(cfg), "num_draft_heads": spec_k})
    tgt = GPTForCausalLM(cfg, device=device, dtype=dtype).eval()
    with torch.no_grad():
        for p in tgt.parameters():
            p.zero_()
    return tgt


def run_probe(device=None):
    """The correctness lanes on ``device`` (the card unless "cpu"; see
    the module docstring); the record's ``check`` is "pass" or names the
    failure."""
    from ..inference.kv_cache import PagedKVCache
    from ..jit.decode_step import GenerationEngine
    from ..serving import ServingEngine

    device = resolve_device(device)
    rec, tokens = {}, {}
    tgt = _tiny(device)
    weak = _tiny(device, seed=7, hidden_size=16, num_layers=1,
                 num_attention_heads=2)
    heads = _tiny(device, num_draft_heads=3)
    stgt, sdrf = (m.to(device) for m in strong_pair(device="cpu"))
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 97, (2, 11))
    n, k = 17, 3
    ok = True
    for kind, quant in (("dense", None), ("paged", None), ("paged", "int8"),
                        ("paged", "int4")):
        extra = {} if quant is None else {"kv_quant": quant}
        tag = f"{kind}_{quant or 'fp'}"
        for name, model, draft in (("weak", tgt, weak),
                                   ("self", heads, "self"),
                                   ("strong", stgt, sdrf)):
            plain = GenerationEngine(model, kind=kind, batch=2, max_len=64,
                                     **extra).generate(ids, n).numpy()
            eng = GenerationEngine(model, kind=kind, batch=2, max_len=64,
                                   draft_model=draft, spec_k=k, **extra)
            out = eng.generate(ids, n).numpy()
            case = f"{name}_{tag}"
            tokens[case] = out.tolist()
            rec[f"parity_{case}"] = same = bool((out == plain).all())
            ok &= same
            if name == "self":
                ok &= eng.draft_cache is None
            if name == "strong":
                rec[f"dispatches_{case}"] = eng.spec_step.calls
                ok &= eng.spec_step.calls == -(-(n - 1) // (k + 1))
            if device.type == "cuda":
                rec[f"graphs_{case}"] = eng.spec_step.cache_size()
                ok &= eng.spec_step.cache_size() == 1
    rec["strong_dispatches_expected"] = -(-(n - 1) // (k + 1))

    prompts = [rng.integers(1, 97, (m,)) for m in (5, 11, 23, 8)]

    def serve(model, **kw):
        e = ServingEngine(model, max_slots=4, max_len=96, page_size=16,
                          chunk_size=16, device=device, **kw)
        hs = [e.submit(p, 12) for p in prompts]
        e.run()
        return e, [list(h.output_tokens) for h in hs]

    for quant in (None, "int8", "int4"):
        tag = quant or "fp"
        _, want = serve(stgt, kv_quant=quant)
        eng, got = serve(stgt, draft_model=sdrf, spec_k=k, kv_quant=quant)
        snap, lk = eng.metrics_snapshot(), eng.leak_check()
        tokens[f"serving_{tag}"] = got
        rec[f"serving_parity_{tag}"] = got == want
        rec[f"serving_accept_rate_{tag}"] = snap["spec_accept_rate"]
        rec[f"serving_tokens_per_dispatch_{tag}"] = \
            snap["spec_tokens_per_dispatch"]
        rec[f"serving_pages_leaked_{tag}"] = \
            lk["total_pages"] - lk["free_pages"]
        ok &= got == want and lk["total_pages"] == lk["free_pages"]
        if quant is None:
            ok &= snap["spec_accept_rate"] == 1.0

    def bpt(dtype, quant):
        return PagedKVCache(2, 4, 64, num_pages=8, page_size=16,
                            max_slots=2, pages_per_seq=4, dtype=dtype,
                            quant=quant, device="cpu").pool_stats()[
            "bytes_per_token"]

    b16, i8, i4 = (bpt(torch.bfloat16, None), bpt(torch.int8, "int8"),
                   bpt(torch.uint8, "int4"))
    rec["int8_slots_ratio_vs_bf16"] = round(b16 / i8, 3)
    rec["int4_slots_ratio_vs_int8"] = round(i8 / i4, 3)
    rec["int4_slots_ratio_vs_bf16"] = round(b16 / i4, 3)
    ok &= (rec["int8_slots_ratio_vs_bf16"] >= 1.8
           and rec["int4_slots_ratio_vs_int8"] >= 1.8
           and rec["int4_slots_ratio_vs_bf16"] >= 3.5)
    rec["tokens"] = tokens
    rec["check"] = "pass" if ok else "FAIL: spec decode probe"
    return rec


def run_bench(device=None, users=4, new_tokens=48, spec_k=4):
    """Serving A/B on the card at accept rate 1.0 by construction (module
    docstring): tokens/s a user for plain, spec (fp, int8, int4 pools)
    and the self-draft against its own plain run on the same pools."""
    from ..serving import ServingEngine

    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("run_bench times the card: a CUDA device is "
                         f"needed, not {device}")
    tgt, drf = strong_pair(device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 97, (int(m),))
               for m in rng.integers(8, 33, users)]

    def lane(model=None, **kw):
        eng = ServingEngine(model if model is not None else tgt,
                            max_slots=users, max_len=128, page_size=16,
                            chunk_size=32, device=device, **kw)
        for p in prompts:                     # warm-up: the captures
            eng.submit(p, new_tokens)
        eng.run()
        eng.reset_metrics()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs = [eng.submit(p, new_tokens) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        toks = sum(len(h.output_tokens) for h in hs)
        snap = eng.metrics_snapshot()
        out = {"tok_s_user": toks / dt / users, "wall_s": dt,
               "tokens": toks}
        if kw.get("draft_model") is not None:
            out["accept_rate"] = snap["spec_accept_rate"]
            out["tokens_per_dispatch"] = snap["spec_tokens_per_dispatch"]
        return out

    rec = {"config": {"users": users, "new_tokens": new_tokens,
                      "spec_k": spec_k, "device": str(device)},
           "plain": lane(),
           "spec": lane(draft_model=drf, spec_k=spec_k),
           "spec_int8": lane(draft_model=drf, spec_k=spec_k,
                             kv_quant="int8"),
           "spec_int4": lane(draft_model=drf, spec_k=spec_k,
                             kv_quant="int4")}
    rec["tok_s_user_speedup"] = rec["spec"]["tok_s_user"] / max(
        rec["plain"]["tok_s_user"], 1e-9)
    ztgt = zero_self_target(spec_k=spec_k, device=device)
    rec["self_plain"] = lane(model=ztgt, kv_quant="int4")
    rec["self_spec"] = lane(model=ztgt, draft_model="self", spec_k=spec_k,
                            kv_quant="int4")
    rec["self_spec_tok_s_user_speedup"] = rec["self_spec"]["tok_s_user"] \
        / max(rec["self_plain"]["tok_s_user"], 1e-9)
    rec["check"] = ("pass" if rec["spec"]["accept_rate"] == 1.0
                    and rec["self_spec"]["accept_rate"] == 1.0
                    else "FAIL: accept rate under 1.0 by construction")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench", action="store_true",
                    help="the serving A/B instead of the probe")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the probe only)")
    args = ap.parse_args(argv)
    rec = run_bench(args.device) if args.bench else run_probe(args.device)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
