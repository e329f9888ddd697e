"""The copy kernel's wrapper and the copy probe of the PyTorch port, on the
CPU.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` and
``python -m mxnet_tpu_torch.tools.bn_probe --copy-sweep``). Here: the
plain version, the launch planning, the probe's array and bound, and the
wrapper's refusals, through its checking helper, which reads only tensor
metadata.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.kernels import copy as C
from mxnet_tpu_torch.tools import bn_probe

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.uint8])
def test_plain_copy_is_exact_on_the_cpu(dtype):
    x = torch.from_numpy(np.random.RandomState(0).randn(7, 13)).to(dtype)
    out = C.copy(x, tile_bytes=16)
    assert out.data_ptr() != x.data_ptr()
    assert torch.equal(out, x)
    dst = torch.empty_like(x)
    assert C.copy(x, dst) is dst and torch.equal(dst, x)


@pytest.mark.parametrize("n_bytes,tile,want", [
    (16, 16, (1, 0, 1)),
    (17, 16, (1, 1, 1)),
    (15, 64, (0, 15, 1)),
    (4096, 16, (256, 0, 1)),
    (4097, 16, (256, 1, 1)),     # the tail rides in block 0
    (4112, 16, (257, 0, 2)),
    (256 * 64 * 3 + 10, 64, (3072, 10, 3)),
    (256 * 256 * 2, 256, (8192, 0, 2)),
])
def test_copy_plan(n_bytes, tile, want):
    assert C.plan(n_bytes, tile) == want
    n_vec, tail, blocks = want
    assert n_vec * 16 + tail == n_bytes
    assert blocks * C.THREADS * (tile // 16) >= n_vec


def test_copy_plan_refuses_other_tiles():
    with pytest.raises(tmx.MXNetError):
        C.plan(1024, 32)


def test_probe_copies_the_reference_array():
    n_bytes, bound_ms, plans = bn_probe.copy_plan()
    assert bn_probe.COPY_SHAPE == (128, 256 * 3136)
    assert n_bytes == 128 * 256 * 3136 * 2 == 205520896
    # read once and written once at 3.35 TB/s
    assert bound_ms == pytest.approx(0.1227, abs=1e-4)
    assert sorted(plans) == [16, 64, 256]
    assert plans[16] == (12845056, 0, 50176)
    assert plans[256] == (12845056, 0, 3136)


def test_probe_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the sweep runs in chip_smoke.py")
    with pytest.raises(tmx.MXNetError):
        bn_probe.copy_sweep(reps=1)


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
