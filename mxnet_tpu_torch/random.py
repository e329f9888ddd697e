"""Seeded random number generators, one ``torch.Generator`` per device.

PyTorch counterpart of ``mxnet_tpu/random.py``. ``seed(s)`` makes every
later draw deterministic: each device gets its own generator, created on
first use and seeded from ``s``, and numpy's legacy global generator is
seeded too (``NDArrayIter(shuffle=True)`` draws from it), as in the JAX
package. Torch's Philox and JAX's threefry draw different numbers from
one seed, so tests hand both packages the same values (made with numpy)
instead of the same seed.

``next_key`` is the executor's key source, the counterpart of the JAX
package's ``next_key``: one key for each training forward or step, a
64-bit integer that is a pure function of (seed, number of keys drawn
since the seed). Ops that draw (Dropout, ``rrelu``) turn the key, split
per node, into counter-based uniforms on the tensor's device
(``key_uniform``): a pure function of (key, element index), equal on the
CPU and the card, that needs no generator state, so a remat segment's
recompute draws the same masks as its first run.

``uniform``, ``normal`` and ``randint`` are the public samplers with the
JAX package's signatures (``mx.random.uniform(0, 1, shape=(2, 3))``):
they run the sampling operators of ``ops/sample.py`` on ``ctx`` (the
default context, ``gpu(0)``, unless given), each call drawing one key
from ``next_key``.

``get_state``/``set_state`` snapshot and restore all of it — what a
checkpoint stores so that a resumed run draws what the uninterrupted run
would have. The state is per thread: take the snapshot on the thread
that trains.
"""
from __future__ import annotations

import threading

import numpy as onp
import torch

__all__ = ["seed", "generator", "next_key", "split", "fold_in",
           "key_uniform", "key_normal", "key_generator", "uniform", "normal",
           "randint", "get_state", "set_state"]

_DEFAULT_SEED = 0
_state = threading.local()
_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF


def _gens():
    if not hasattr(_state, "gens"):
        _state.seed = _DEFAULT_SEED
        _state.gens = {}
        _state.keys_drawn = 0
    return _state.gens


def seed(seed_state):
    """Seed the generators of every device and numpy's global generator
    (mx.random.seed)."""
    _gens()
    _state.seed = int(seed_state)
    _state.gens = {}
    _state.keys_drawn = 0
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


# ---------------------------------------------------------------------------
# the executor's keys: 64-bit integers, split and folded with SplitMix64
# ---------------------------------------------------------------------------
def _splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def fold_in(key, i):
    """The key of sub-stream ``i`` of ``key`` (a node's key from the
    forward's, a grouped step's from the group's)."""
    return _splitmix64(_splitmix64(int(key) & _M64) ^ (int(i) & _M64))


def split(key, n):
    """``n`` independent keys from ``key``."""
    return [fold_in(key, i) for i in range(n)]


def next_key():
    """A fresh key for one training forward or step; advances this
    thread's state (``mx.random.seed(s)`` fixes every later key)."""
    _gens()
    k = fold_in(_splitmix64(_state.seed & _M64), _state.keys_drawn)
    _state.keys_drawn += 1
    return k


def _mul32(x, c):
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant ``c``, in 16-bit halves of ``c`` so that no product passes
    2**49."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A bijective 32-bit finaliser (lowbias32) on int64 tensors."""
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def key_uniform(key, shape, device):
    """float32 uniforms in [0, 1) of ``shape`` on ``device``, 24 random
    bits each: a pure function of (key, element index), bit for bit the
    same on every device. Element i is
    ``mix32(mix32(i + k0) ^ k1) >> 8`` over the key's two 32-bit words;
    ``mix32`` is a bijection, so one key gives distinct counters."""
    n = 1
    for d in shape:
        n *= int(d)
    if n > 1 << 32:
        raise ValueError("uniform: %d elements exceed the 32-bit counter"
                         % n)
    k = _splitmix64(int(key) & _M64)
    k0, k1 = k & _M32, k >> 32
    x = (torch.arange(n, dtype=torch.int64, device=device) + k0) & _M32
    x = _mix32(_mix32(x) ^ k1)
    return ((x >> 8).to(torch.float32) * (1.0 / (1 << 24))).reshape(shape)


def key_normal(key, shape, device):
    """float32 standard normals of ``shape`` on ``device`` by Box-Muller
    over two counter streams of ``key`` (sub-keys 0 and 1): like
    :func:`key_uniform`, a pure function of the key and the index."""
    u1 = key_uniform(fold_in(key, 0), shape, device)
    u2 = key_uniform(fold_in(key, 1), shape, device)
    # 1 - u1 lies in (0, 1], so the log is finite
    r = torch.sqrt(-2.0 * torch.log1p(-u1))
    return r * torch.cos((2.0 * torch.pi) * u2)


def key_generator(key, device):
    """A ``torch.Generator`` on ``device`` seeded from ``key``: for the
    draws that have no counter form (gamma, Poisson, integers). It
    repeats bit for bit on one device; two devices draw differently."""
    g = torch.Generator(device=device)
    g.manual_seed(_splitmix64(int(key) & _M64) & 0x7FFFFFFFFFFFFFFF)
    return g


# ---------------------------------------------------------------------------
# the public samplers (mx.random.uniform/normal/randint)
# ---------------------------------------------------------------------------
def uniform(low=0, high=1, shape=None, ctx=None, out=None, dtype=None):
    """Samples from U[low, high) (mx.random.uniform)."""
    from . import ndarray as nd
    return nd.uniform(low=low, high=high, shape=shape, ctx=ctx, out=out,
                      dtype=dtype)


def normal(loc=0, scale=1, shape=None, ctx=None, out=None, dtype=None):
    """Samples from N(loc, scale²) (mx.random.normal)."""
    from . import ndarray as nd
    return nd.normal(loc=loc, scale=scale, shape=shape, ctx=ctx, out=out,
                     dtype=dtype)


def randint(low, high, shape=None, ctx=None, dtype="int32"):
    """Integers in [low, high) (mx.random.randint)."""
    from . import ndarray as nd
    return nd.random_randint(low=low, high=high, shape=shape, ctx=ctx,
                             dtype=dtype)


def get_state():
    """This thread's RNG state as a host-side dict: the seed, the number
    of keys drawn since it, each created generator's state (uint8 numpy,
    keyed by device) and numpy's legacy state."""
    gens = _gens()
    return {"seed": int(_state.seed), "keys_drawn": int(_state.keys_drawn),
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
    _state.keys_drawn = int(state.get("keys_drawn", 0))
    _state.gens = gens
    onp.random.set_state(tuple(state["numpy"]))
