"""Named RNG states for tensor parallelism: the port of paddle_tpu/
distributed/fleet/layers/mpu/random.py (`RNGStatesTracker` :34,
`get_rng_state_tracker` :99, `model_parallel_random_seed`).

Each named state is an explicit ``torch.Generator`` on the rank's device.
``with tracker.rng_state(name):`` makes the default generator of that
device draw from it (what dropout inside a tensor-parallel region draws)
and keeps where it got to, so the stream goes on across uses and the
default generator is as it was outside. `model_parallel_random_seed`
gives the model-parallel state a seed of its own a model-parallel rank
(masks over sharded activations differ across ranks) and seeds the
default generator alike on every rank (masks over replicated ones
agree), as Paddle does.
"""
from __future__ import annotations

import contextlib
import random as _random

import torch

__all__ = ["MODEL_PARALLEL_RNG", "RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed"]

MODEL_PARALLEL_RNG = "model_parallel_rng"


def _device():
    from .... import env

    return env.get_device() if env.is_initialized() else torch.device("cpu")


class RNGStatesTracker:
    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name, seed, device=None):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        gen = torch.Generator(device=device or _device())
        gen.manual_seed(int(seed))
        self.seeds_.add(seed)
        self.states_[name] = gen

    def get_states_tracker(self):
        return {name: g.get_state() for name, g in self.states_.items()}

    def set_states_tracker(self, states):
        for name, st in states.items():
            if name in self.states_:
                self.states_[name].set_state(st)

    @contextlib.contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        gen = self.states_[name]
        dev = gen.device
        cuda = dev.type == "cuda"
        with torch.random.fork_rng(devices=[dev.index or 0] if cuda else [],
                                   enabled=True):
            if cuda:
                torch.cuda.set_rng_state(gen.get_state(), dev)
            else:
                torch.set_rng_state(gen.get_state())
            try:
                yield
            finally:
                gen.set_state(torch.cuda.get_rng_state(dev) if cuda
                              else torch.get_rng_state())


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker():
    return _RNG_STATE_TRACKER


def model_parallel_random_seed(seed=None):
    """The tracker's model-parallel state from ``seed + 1024 + mp rank``
    (a seed of its own a rank), the default generators from ``seed``
    (alike on every rank); a random seed when none is given."""
    from ...topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    rank = hcg.get_model_parallel_rank() if hcg is not None else 0
    seed = _random.randint(0, 2 ** 31 - 1) if seed is None else int(seed)
    _RNG_STATE_TRACKER.reset()
    _RNG_STATE_TRACKER.add(MODEL_PARALLEL_RNG, seed + 1024 + rank)
    torch.manual_seed(seed)
