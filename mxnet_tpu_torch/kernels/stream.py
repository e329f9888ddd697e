"""Launch plans of the port's streaming engine (``csrc/stream.cuh``).

The engine maps an elementwise body over ``n_in`` float32 inputs into
``n_out`` float32 outputs (``mx.rtc``, ``kernels/rtc.py``) or copies bytes
(the copy probe, ``kernels/copy.py``) in one pass. ``plan`` is a pure
function that mirrors the C side, as ``batchnorm.plan`` does for the
BatchNorm kernels: the wrappers call it once per key and hand the C
function ``Plan.packed()``.

The body is cut into 16-byte vectors aligned to the first output: the
``head`` elements before its first 16-byte boundary and the ``tail``
after the last whole vector move one by one. Each thread takes
``unroll`` vectors a round (``RTC_UNROLL`` for rtc; the copy probe sweeps
1, 4 and 16), and the grid gives every thread one round. Ref r moves as
one 16-byte access where its own address is aligned at those vectors
(bit r of ``vec_mask``, inputs first) and as four words otherwise. A
copy's buffers are 16-byte aligned: no head, every vector whole.
"""
from __future__ import annotations

from typing import NamedTuple

from ..base import MXNetError

__all__ = ["Plan", "plan", "RTC_UNROLL", "COPY_UNROLLS", "THREADS"]

RTC_UNROLL = 2               # kRtcUnroll in stream.cuh
COPY_UNROLLS = (1, 4, 16)    # the copy kernels launch_copy instantiates
THREADS = 256                # kThreads in stream.cuh: threads per block
_VEC = 16                    # bytes of one vector


class Plan(NamedTuple):
    """One launch: ``head``, ``body`` and ``tail`` elements (in order,
    summing to n); ``vectors`` 16-byte vectors of the body; ``unroll``
    vectors per thread a round; ``grid`` blocks of ``THREADS``;
    ``vec_mask`` the refs that move as 16-byte accesses."""
    head: int
    body: int
    tail: int
    vectors: int
    unroll: int
    grid: int
    vec_mask: int

    def packed(self):
        """The 7 int64 the C side reads as ``mxstream::Plan``."""
        return tuple(int(v) for v in self)


def plan(n, offsets, n_in, n_out, elem_bytes=4, unroll=RTC_UNROLL):
    """The plan of one pass over ``n`` elements of ``elem_bytes`` bytes
    (4: floats, an rtc pass; 1: bytes, a copy) whose refs (inputs, then
    outputs) sit at the addresses mod 16 ``offsets``."""
    if len(offsets) != n_in + n_out or n_in < 1 or n_out < 1:
        raise MXNetError("stream plan: %d offsets for %d input(s) and %d "
                         "output(s)" % (len(offsets), n_in, n_out))
    if elem_bytes == 4:
        if unroll != RTC_UNROLL:
            raise MXNetError("stream plan: an rtc pass takes %d vectors a "
                             "round, not %r" % (RTC_UNROLL, unroll))
    elif elem_bytes == 1:
        if n_in + n_out != 2 or any(offsets):
            raise MXNetError("stream plan: a copy takes one 16-byte aligned "
                             "source and destination; got offsets %s"
                             % (offsets,))
        if unroll not in COPY_UNROLLS:
            raise MXNetError("stream plan: a copy takes %s vectors a round, "
                             "not %r" % (COPY_UNROLLS, unroll))
    else:
        raise MXNetError("stream plan: %d-byte elements; the engine maps "
                         "floats or copies bytes" % elem_bytes)
    if any(o % elem_bytes or not 0 <= o < _VEC for o in offsets):
        raise MXNetError("stream plan: offsets %s are not addresses mod 16 "
                         "of %d-byte elements" % (offsets, elem_bytes))
    per_vec = _VEC // elem_bytes
    head = min(n, (_VEC - offsets[n_in]) % _VEC // elem_bytes)
    vectors = (n - head) // per_vec
    body = vectors * per_vec
    mask = sum(1 << r for r, o in enumerate(offsets)
               if (o + head * elem_bytes) % _VEC == 0)
    return Plan(head, body, n - head - body, vectors, unroll,
                max(1, -(-vectors // (THREADS * unroll))), mask)
