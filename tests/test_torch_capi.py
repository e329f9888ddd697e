"""The port's C API (``mxnet_tpu_torch/capi``: its own copy of
``c_api.cpp`` over ``mxnet_tpu_torch.capi_bridge``) against the repo's C
tests, on the CPU.

The library is built with ``g++`` against ``include/mxnet_tpu/c_api.h``
into ``build/capi_torch/libmxnet_tpu.so`` (the JAX package's soname in a
directory of its own; ``capi/build`` is never written), and
``tests/cpp/test_c_api.c`` and ``test_c_api_ext.c``, unchanged, link to it
with ``-lmxnet_tpu`` and pass: ndarray, symbol, executor, predictor,
data iterator, kvstore, recordio, rtc, autograd, C custom op and
profiler families, all on ``dev_type`` 1 (the CPU) through the port.
"""
import json
import os
import subprocess

import pytest

from mxnet_tpu_torch import capi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("src,expect", [
    ("test_c_api.c", "CAPI_TEST_PASS"),
    ("test_c_api_ext.c", "CAPI_EXT_TEST_PASS")])
def test_c_test_passes_against_the_port_library(tmp_path, src, expect):
    so = capi.build_library()
    assert os.path.dirname(so) == os.path.join(ROOT, "build", "capi_torch")
    exe = capi.build_client(os.path.join(ROOT, "tests", "cpp", src),
                            str(tmp_path / src[:-2]))
    env = capi.client_env()
    log = tmp_path / "launches.jsonl"
    env["MXNET_CAPI_LAUNCH_LOG"] = str(log)
    proc = subprocess.run([exe], env=env, capture_output=True, text=True,
                          timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, (
        "C test failed:\nstdout:%s\nstderr:%s" % (proc.stdout[-3000:],
                                                  proc.stderr[-3000:]))
    assert expect in proc.stdout
    # the port's bridge answered: its MXNDArrayWaitAll wrote the launch
    # log (no kernel launches on the CPU)
    lines = log.read_text().splitlines()
    assert lines and all(v == 0 for v in json.loads(lines[-1]).values())
