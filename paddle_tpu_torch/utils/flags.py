"""Env-flag registry: the port's copy of paddle_tpu/utils/flags.py.

Reference parity: paddle/common/flags.h (PHI_DEFINE_EXPORTED_*) and
``paddle.set_flags`` / ``paddle.get_flags``. A flag is overridable by an
environment variable of the same name, read when the flag is defined;
`get_flags` raises on an unknown name, `set_flags` registers one (the
reference tolerates flags that are phasing in), and a defined flag's new
value is coerced to its default's type (bool from "1", "true", "yes",
"on"; int; float).

Only the flags that the port's routes consult are defined here, with the
reference's names, defaults and help.
"""
from __future__ import annotations

import os
import threading

__all__ = ["define_flag", "get_flags", "set_flags", "get_flag"]

_lock = threading.Lock()
_registry: dict[str, dict] = {}


def _coerce(value, default):
    if isinstance(default, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(default, int):
        return int(value)
    if isinstance(default, float):
        return float(value)
    return value


def define_flag(name: str, default, help_str: str = ""):
    """Register ``name``; the environment variable of the same name, when
    set, overrides ``default``. Returns the flag's value."""
    with _lock:
        env = os.environ.get(name)
        value = _coerce(env, default) if env is not None else default
        _registry[name] = {"value": value, "default": default,
                           "help": help_str}
    return value


def get_flags(flags):
    """``{name: value}`` for a name or a list of names; raises
    ``ValueError`` on an unknown one."""
    names = [flags] if isinstance(flags, str) else list(flags)
    out = {}
    for n in names:
        if n not in _registry:
            raise ValueError(f"unknown flag {n!r}")
        out[n] = _registry[n]["value"]
    return out


def set_flags(flags: dict):
    """Set each flag; an unknown name is registered with its value as
    its default."""
    with _lock:
        for n, v in flags.items():
            if n not in _registry:
                _registry[n] = {"value": v, "default": v, "help": ""}
            else:
                _registry[n]["value"] = _coerce(v, _registry[n]["default"])


def get_flag(name: str):
    """The value of ``name``, or None if it is not defined."""
    return _registry[name]["value"] if name in _registry else None


define_flag("FLAGS_splash_attn", True,
            "route training attention (causal/plain, no mask, no "
            "dropout) through the splash Pallas kernel "
            "(ops/pallas/splash_attention.py: tiled online-softmax "
            "fwd, stats-recompute bwd, GQA, segment IDs) on TPU when "
            "the geometry qualifies, and packed-sequence segment "
            "attention through it on every backend (XLA fallback off "
            "TPU). Off restores the round-3 flash/XLA routing.")
define_flag("FLAGS_pallas_flash_min_seqlen", 1024,
            "min seq len to route scaled_dot_product_attention to the "
            "pallas flash kernel. Measured on v5e (h16 d64 bf16, fwd+bwd "
            "vs bf16-score XLA attention): the round-3 kernels (fused "
            "single-block path at <=1024; single-pass fused backward "
            "beyond) win from seq 1024 up (1.22x at 1024, 1.64x at 2048, "
            "1.17x at 4096, 2.5x at 8192 — PERF.md round-3 A/B), and from "
            "16384 the O(s^2) score matrix OOMs 16G HBM while the flash "
            "kernel trains. Below 1024 XLA's fused softmax is fine and "
            "the kernel is not plumbed for masks/dropout.")
define_flag("FLAGS_numerics_monitor", True,
            "training-numerics monitor: every train step (TrainStep, "
            "FusedScanTrainStep) fills a per-layer-chunk (or "
            "per-parameter) stats block on the device (grad/param "
            "sq-norms, update ratio, activation RMS, finite flags), read "
            "back lazily by observability.numerics.NumericsMonitor at a "
            "logging boundary. Off removes the stats from the steps. "
            "Per-step override: numerics=True/False")
define_flag("FLAGS_attention_fp32_scores", False,
            "store attention scores in fp32 instead of the input dtype "
            "(softmax math is fp32 either way); costs ~2x score-matrix "
            "HBM traffic")
define_flag("FLAGS_fused_ce_chunks", 4,
            "token-chunk count for fused_linear_cross_entropy: logits are "
            "computed per chunk and discarded instead of materializing the "
            "full [tokens, vocab] fp32 matrix")
define_flag("FLAGS_fused_ce", True,
            "route fused_linear_cross_entropy through the vocab-tiled "
            "streaming CE (ops/kernels/fused_cross_entropy.py) — the "
            "[tokens, vocab] logits never exist in forward or backward. "
            "Off restores the token-chunked logsumexp path "
            "(FLAGS_fused_ce_chunks).")
define_flag("FLAGS_comm_bucket_mb", 25,
            "gradient-communication bucket size in MB: per-parameter "
            "grads coalesce into size-capped flat buckets and sync as one "
            "reduce_scatter / all_reduce a bucket (0: one collective a "
            "parameter). DataParallel sizes its buckets from its "
            "comm_buffer_size argument and honours only the 0 here")
define_flag("FLAGS_comm_quant", "",
            "opt-in compressed gradient collectives on the bucketed "
            "paths: 'int8' (symmetric scales a 32-element block on both "
            "the scatter and the gather leg) or 'bf16'; '' (default) "
            "keeps full-precision payloads. Accumulation is fp32 in "
            "every mode")
define_flag("FLAGS_param_storage", "",
            "parameter storage of ShardedFusedScanTrainStep: 'sharded' "
            "(the default when empty: parameters live as 1/N flat bucket "
            "shards between steps, gathered on use) or 'replicated' "
            "(full parameters, views into the flat buckets). Per-step "
            "override: param_storage=")
