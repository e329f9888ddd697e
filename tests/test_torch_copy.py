"""The copy kernel's wrapper and the copy probe of the PyTorch port, on the
CPU.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` and
``python -m mxnet_tpu_torch.tools.bn_probe --copy-sweep``). Here: the
plain version, the launch plans of the streaming engine's copy (head,
body, tail, vectors, grid per swept number of vectors per thread), the probe's
array and bound, and the wrapper's refusals, through its checking
helper, which reads only tensor metadata.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.kernels import copy as C
from mxnet_tpu_torch.kernels import stream
from mxnet_tpu_torch.tools import bn_probe

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.uint8])
def test_plain_copy_is_exact_on_the_cpu(dtype):
    x = torch.from_numpy(np.random.RandomState(0).randn(7, 13)).to(dtype)
    out = C.copy(x, unroll=4)
    assert out.data_ptr() != x.data_ptr()
    assert torch.equal(out, x)
    dst = torch.empty_like(x)
    assert C.copy(x, dst) is dst and torch.equal(dst, x)


@pytest.mark.parametrize("n_bytes,unroll,want", [
    (16, 1, (0, 16, 0, 1, 1)),
    (17, 1, (0, 16, 1, 1, 1)),
    (15, 4, (0, 0, 15, 0, 1)),     # no whole vector: the tail alone
    (16384, 4, (0, 16384, 0, 1024, 1)),
    (16385, 1, (0, 16384, 1, 1024, 4)),
    (16400, 16, (0, 16400, 0, 1025, 1)),
    (32768 * 1000 + 10, 4, (0, 32768000, 10, 2048000, 2000)),
    (65536 * 200, 16, (0, 13107200, 0, 819200, 200)),
])
def test_copy_plan(n_bytes, unroll, want):
    p = C.plan(n_bytes, unroll)
    assert (p.head, p.body, p.tail, p.vectors, p.grid) == want
    assert p.unroll == unroll and p.vec_mask == 0b11
    assert p.head + p.body + p.tail == n_bytes and p.body == 16 * p.vectors
    # one round of `unroll` vectors for every thread of the grid
    per_block = stream.THREADS * unroll
    assert p.grid * per_block >= p.vectors > (p.grid - 1) * per_block \
        or p.vectors == 0


@pytest.mark.parametrize("unroll", [0, 2, 3, 8, 32, 64])
def test_copy_plan_refuses_other_tiles(unroll):
    """The copy kernels take 1, 4 or 16 vectors a thread a round."""
    with pytest.raises(tmx.MXNetError):
        C.plan(1024, unroll)


def test_probe_copies_the_reference_array():
    n_bytes, bound_ms, plans = bn_probe.copy_plan()
    assert bn_probe.COPY_SHAPE == (128, 256 * 3136)
    assert n_bytes == 128 * 256 * 3136 * 2 == 205520896
    # read once and written once at 3.35 TB/s
    assert bound_ms == pytest.approx(0.1227, abs=1e-4)
    assert sorted(plans) == sorted(C.COPY_SWEEP)
    # 16, 64 and 256 bytes in flight per thread, one round each
    assert [(plans[u].vectors, plans[u].grid) for u in C.COPY_SWEEP] == [
        (12845056, 50176), (12845056, 12544), (12845056, 3136)]
    assert all(p.body == n_bytes and p.tail == 0 for p in plans.values())
    assert C.UNROLL in C.COPY_SWEEP


def test_probe_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the sweep runs in chip_smoke.py")
    with pytest.raises(tmx.MXNetError):
        bn_probe.copy_sweep(reps=1)


def test_ab_tool_loads_another_checkout_under_its_own_name():
    """The A/B tool imports a second checkout's package beside this one
    (here: this checkout again) without touching ``mxnet_tpu_torch``."""
    from mxnet_tpu_torch.tools import stream_ab
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = stream_ab.load_checkout(root, name="ab_test_mxnet_tpu_torch")
    assert other.kernels.copy.copy is not C.copy
    assert other.kernels.copy.COPY_SWEEP == C.COPY_SWEEP
    assert other.rtc.Rtc is not tmx.rtc.Rtc
    if not torch.cuda.is_available():
        with pytest.raises(tmx.MXNetError):
            stream_ab.main(["--other", root])


def test_probe_cli_wants_the_copy_sweep_flag():
    with pytest.raises(SystemExit):
        bn_probe.main([])


def _buf(n, dtype=torch.bfloat16):
    return torch.empty(n + 64, dtype=dtype)


@pytest.mark.parametrize("case", ["non_contiguous_x", "non_contiguous_out",
                                  "misaligned_x", "misaligned_out",
                                  "shape", "dtype"])
def test_copy_check_refuses(case):
    x = _buf(64)[:64]
    out = _buf(64)[:64]
    assert x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    if case == "non_contiguous_x":
        x = _buf(128)[:128:2]
    elif case == "non_contiguous_out":
        out = _buf(128)[:128:2]
    elif case == "misaligned_x":
        x = _buf(64)[1:65]          # 2 bytes past a 16-byte boundary
    elif case == "misaligned_out":
        out = _buf(64)[3:67]
    elif case == "shape":
        out = _buf(64)[:32]
    else:
        out = torch.empty(64, dtype=torch.float16)
    with pytest.raises(tmx.MXNetError):
        C.check_copy(x, out)


def test_copy_check_accepts_aligned_contiguous_views():
    base = _buf(256)
    C.check_copy(base[8:72], base[136:200])   # offsets of 16 bytes


def test_copy_refuses_tensors_on_other_devices():
    x = torch.zeros(16, device="meta")
    with pytest.raises(tmx.MXNetError):
        C.copy(x)
