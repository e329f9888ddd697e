"""Seeded random number generators, one ``torch.Generator`` per device.

PyTorch counterpart of ``mxnet_tpu/random.py``. ``seed(s)`` makes every
later draw deterministic: each device gets its own generator, created on
first use and seeded from ``s``. Torch's Philox and JAX's threefry draw
different numbers from one seed, so tests hand both packages the same
values (made with numpy) instead of the same seed.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator"]

_DEFAULT_SEED = 0
_state = threading.local()


def _gens():
    if not hasattr(_state, "gens"):
        _state.seed = _DEFAULT_SEED
        _state.gens = {}
    return _state.gens


def seed(seed_state):
    """Seed the generators of every device (mx.random.seed)."""
    _gens()
    _state.seed = int(seed_state)
    _state.gens = {}


def generator(device):
    """The generator of ``device`` (a ``torch.device``)."""
    gens = _gens()
    key = str(device)
    if key not in gens:
        g = torch.Generator(device=device)
        g.manual_seed(_state.seed)
        gens[key] = g
    return gens[key]
