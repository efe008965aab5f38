#!/usr/bin/env python3
"""Training step times of two checkouts, for an A/B inside one card call.

    cd <checkout> && python3 <path to>/chip_ab.py <tag>

Imports the ``chip_smoke.py`` (and so the ``paddle_tpu_torch``) of the
current directory, not of the directory this script sits in, and runs
its ``train_full_width`` as phases 9 and 10 do: splash at 8 x 1024 (5
timed steps), then with ``FLAGS_splash_attn`` off the flash pairs at 8 x
1024 and 4 x 2048 (3 timed steps each), GPT-3 1.3B width, each run
failing on a kernel launched off its path. Prints one line, ``AB `` and
a JSON object: the tag, the card's ``nvidia-smi`` name and power limit,
and for each run its step times, median, peak device memory, tokens/s
and kernel launches. Run the parent checkout, this one, this one again
and the parent again in one call, and compare medians within the call.
Needs a CUDA card; imports torch, numpy and the port only.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402

KEYS = ("step_ms", "step_ms_median", "max_memory_allocated",
        "tokens_per_s", "launches")


def run(dev, **kw) -> dict:
    """One `train_full_width` run; its printed stats, the keys above."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        chip_smoke.train_full_width(dev, **kw)
    stats = json.loads(out.getvalue().strip().splitlines()[-1]
                       .split(": ", 1)[1])
    return {k: stats[k] for k in KEYS}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    result = {"tree": sys.argv[1] if len(sys.argv) > 1 else os.getcwd(),
              "smi": chip_smoke.nvidia_smi(),
              "splash_8x1024": run(dev)}
    with chip_smoke.routing_flags(splash_attn=False):
        result["flash_8x1024"] = run(dev, timed=3, batch=8, seq=1024,
                                     splash=False, phase=10)
        result["flash_4x2048"] = run(dev, timed=3, batch=4, seq=2048,
                                     splash=False, phase=10)
    print("AB " + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
