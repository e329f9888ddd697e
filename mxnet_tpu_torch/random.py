"""Seeded random number generators, one ``torch.Generator`` per device.

PyTorch counterpart of ``mxnet_tpu/random.py``. ``seed(s)`` makes every
later draw deterministic: each device gets its own generator, created on
first use and seeded from ``s``, and numpy's legacy global generator is
seeded too (``NDArrayIter(shuffle=True)`` draws from it), as in the JAX
package. Torch's Philox and JAX's threefry draw different numbers from
one seed, so tests hand both packages the same values (made with numpy)
instead of the same seed.

``get_state``/``set_state`` snapshot and restore all of it — what a
checkpoint stores so that a resumed run draws what the uninterrupted run
would have. The generators are per thread: take the snapshot on the
thread that trains.
"""
from __future__ import annotations

import threading

import numpy as onp
import torch

__all__ = ["seed", "generator", "get_state", "set_state"]

_DEFAULT_SEED = 0
_state = threading.local()


def _gens():
    if not hasattr(_state, "gens"):
        _state.seed = _DEFAULT_SEED
        _state.gens = {}
    return _state.gens


def seed(seed_state):
    """Seed the generators of every device and numpy's global generator
    (mx.random.seed)."""
    _gens()
    _state.seed = int(seed_state)
    _state.gens = {}
    onp.random.seed(int(seed_state) % (2 ** 32))


def generator(device):
    """The generator of ``device`` (a ``torch.device``)."""
    gens = _gens()
    key = str(device)
    if key not in gens:
        g = torch.Generator(device=device)
        g.manual_seed(_state.seed)
        gens[key] = g
    return gens[key]


def get_state():
    """This thread's RNG state as a host-side dict: the seed, each
    created generator's state (uint8 numpy, keyed by device) and numpy's
    legacy state."""
    gens = _gens()
    return {"seed": int(_state.seed),
            "torch": {k: g.get_state().numpy().copy()
                      for k, g in gens.items()},
            "numpy": onp.random.get_state()}


def set_state(state):
    """Restore a snapshot taken by :func:`get_state`. A generator whose
    device this process lacks is dropped (a card's state restored on a
    CPU-only host); generators absent from the snapshot start again from
    its seed on first use."""
    gens = {}
    for key, st in state.get("torch", {}).items():
        dev = torch.device(key)
        if dev.type == "cuda" and not torch.cuda.is_available():
            continue
        g = torch.Generator(device=dev)
        g.set_state(torch.as_tensor(onp.asarray(st, onp.uint8)))
        gens[key] = g
    _gens()
    _state.seed = int(state.get("seed", _DEFAULT_SEED))
    _state.gens = gens
    onp.random.set_state(tuple(state["numpy"]))
