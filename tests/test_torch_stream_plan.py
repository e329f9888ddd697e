"""Launch plans of the port's streaming engine (``kernels/stream.py``,
mirroring ``kernels/csrc/stream.cuh``), on the CPU.

The engine runs only on the card (``chip_smoke.py`` phases 2 and 6). Here:
the head and tail around the 16-byte vectors for offsets 0, 4, 8 and 12
bytes; which refs move as vectors and which as words when the refs
differ mod 16; vectors, rounds and grid; the copy sweep's plans; the
refusals; and that the packed plan and its constants match the C header
field for field.
"""
import ast
import os
import re

import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.kernels import copy as C
from mxnet_tpu_torch.kernels import stream

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join(ROOT, "mxnet_tpu_torch", "kernels", "csrc",
                      "stream.cuh")
N = 32 * 256 * 56 * 56      # one ResNet-50 activation


@pytest.mark.parametrize("offset,head,tail", [
    (0, 0, 0), (4, 3, 1), (8, 2, 2), (12, 1, 3)])
def test_plan_head_and_tail(offset, head, tail):
    """Refs that share an address mod 16 all move as vectors; the head
    reaches the first 16-byte boundary, the tail is what is left past the
    last whole 4 floats."""
    p = stream.plan(N, (offset,) * 3, 2, 1)
    assert (p.head, p.tail, p.vec_mask) == (head, tail, 0b111)
    assert p.head + p.body + p.tail == N and p.body == 4 * p.vectors
    assert (offset + 4 * p.head) % 16 == 0


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7])
def test_plan_smaller_than_its_head(n):
    p = stream.plan(n, (4, 4), 1, 1)
    assert p.head == min(n, 3)
    assert p.head + p.body + p.tail == n
    assert p.vectors == (1 if n == 7 else 0) and p.grid == 1


def test_plan_vectors_rounds_and_grid():
    """256 threads a block, 2 vectors a thread a round, one round for
    every thread of the grid."""
    axpy = stream.plan(N, (0, 0, 0), 2, 1)
    assert (axpy.vectors, axpy.unroll, stream.THREADS) == (N // 4, 2, 256)
    assert axpy.grid == N // (4 * 256 * 2) == 12544
    two = stream.plan(N, (0,) * 4, 2, 2)
    assert two[:6] == axpy[:6] and two.vec_mask == 0b1111
    small = stream.plan(5000, (0, 0, 0), 2, 1)
    assert (small.vectors, small.grid, small.tail) == (1250, 3, 0)
    ragged = stream.plan(5 * 3 * 17 * 13, (0, 0), 1, 1)
    assert (ragged.vectors, ragged.tail, ragged.grid) == (828, 3, 2)


@pytest.mark.parametrize("offsets,head,mask", [
    ((8, 0, 8), 2, 0b101),       # x and z move as vectors, y as words
    ((0, 4, 0), 0, 0b101),
    ((4, 8, 12), 1, 0b100),
    ((8, 0, 8, 4), 2, 0b0101),   # two outputs: the first sets the vectors
])
def test_refs_that_differ_mod_16_move_as_words(offsets, head, mask):
    n_out = len(offsets) - 2
    p = stream.plan(3315, offsets, 2, n_out)
    assert (p.head, p.vec_mask) == (head, mask)
    assert p.head + p.body + p.tail == 3315 and p.body == 4 * p.vectors
    assert p.unroll == stream.RTC_UNROLL
    assert p.grid == -(-p.vectors // (256 * stream.RTC_UNROLL))


def test_plan_grid_at_full_size_with_words():
    p = stream.plan(N, (8, 0, 8), 2, 1)
    # one round of 2 vectors per thread
    assert p.grid == (N - 4) // (4 * 256 * 2) + 1 == 12544


def test_copy_plans_of_the_sweep():
    """Copy moves bytes: 16-byte aligned buffers, no head, 16-byte
    vectors, the bytes past the last whole one in the tail."""
    assert C.COPY_SWEEP == stream.COPY_UNROLLS == (1, 4, 16)
    for unroll in C.COPY_SWEEP:
        p = stream.plan(1000003, (0, 0), 1, 1, elem_bytes=1, unroll=unroll)
        assert (p.head, p.body, p.tail) == (0, 1000000, 3)
        assert (p.vectors, p.vec_mask) == (62500, 0b11)
        assert p.grid == -(-62500 // (256 * unroll))
        assert C.plan(1000003, unroll) == p


@pytest.mark.parametrize("case", ["offsets", "unaligned", "out_of_range",
                                  "elem_bytes", "copy_refs", "copy_mixed",
                                  "rtc_unroll", "copy_unroll",
                                  "copy_floats", "negative"])
def test_plan_refuses(case):
    args = dict(n=1024, offsets=(0, 0), n_in=1, n_out=1)
    args.update({
        "offsets": dict(offsets=(0, 0, 0)),
        "unaligned": dict(offsets=(2, 2)),
        "out_of_range": dict(offsets=(16, 16)),
        "elem_bytes": dict(elem_bytes=2),
        "copy_refs": dict(elem_bytes=1, offsets=(0, 0, 0), n_in=2),
        "copy_mixed": dict(elem_bytes=1, offsets=(0, 8)),
        "rtc_unroll": dict(unroll=4),
        "copy_unroll": dict(elem_bytes=1, unroll=2),
        "copy_floats": dict(elem_bytes=1, offsets=(4, 4)),
        "negative": dict(offsets=(-4, -4)),
    }[case])
    with pytest.raises(tmx.MXNetError):
        stream.plan(**args)


def _header():
    with open(HEADER) as f:
        return f.read()


def test_packed_plan_matches_the_c_struct():
    src = _header()
    struct = re.search(r"struct Plan \{\s*long long ([^;]*);", src).group(1)
    assert [f.strip() for f in struct.split(",")] == list(stream.Plan._fields)
    p = stream.plan(N, (4, 8, 4), 2, 1)
    assert p.packed() == tuple(p) and len(p.packed()) == 7
    assert "kRtcUnroll = %d;" % stream.RTC_UNROLL in src
    assert "kThreads = %d;" % stream.THREADS in src
    launch_copy = src[src.index("inline int launch_copy"):]
    assert tuple(int(c) for c in re.findall(r"case (\d+):", launch_copy)) \
        == stream.COPY_UNROLLS


def test_port_imports_no_triton_jax_or_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "mxnet_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
        mods += [n.module or "" for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and not n.level]
        roots = {m.split(".")[0] for m in mods}
        assert not roots & {"triton", "jax", "mxnet_tpu"}, path
