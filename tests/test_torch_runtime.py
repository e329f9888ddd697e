"""The native host runtime of the PyTorch port (mxnet_tpu_torch.runtime):
its build, the record reader and batch assembly against the JAX package's
native ones, and ``tests/test_engine.py``'s contracts on the port's
``NativeEngine``, ``HostPool`` and ``engine.py``, on the CPU.

* The libraries build with ``g++`` into the port's cache (``build/native``
  or ``kernels.build.cache_root()``), keyed by a digest of the source, the
  flags and what ``-march=native`` means here; without a library every
  entry point takes the numpy path of ``io_runtime``.
* ``RecordFile`` reads every record of a pack bit for bit as the JAX
  package's native reader does; ``assemble_batch`` equals the JAX
  package's native assembly bit for bit (the same source and flags) over
  mean, std, mirror, crop and a staging buffer, and the numpy path
  within one ulp.
* The engine contracts of ``tests/test_engine.py``, one for one: writes
  serialize, reads overlap and a write waits for them, disjoint vars
  overlap, the diamond, ``wait_for_var``, errors at the wait, a var given
  as read and write, the profiler's dump (and its escaping), the
  ``engine.py`` facade on the native engine (and the profiler's merge of
  its stamps), ``close``, the Python path's ``wait_for_var``; and the
  pool's recycling, statistics, ``release_all`` and distinct buffers.
"""
import json
import os
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from mxnet_tpu import runtime as jrt

from mxnet_tpu_torch import engine as E
from mxnet_tpu_torch import io_runtime, recordio, runtime
from mxnet_tpu_torch.kernels import build as kbuild
from mxnet_tpu_torch.runtime import _native_build, core
from mxnet_tpu_torch.runtime.core import HostPool, NativeEngine

torch.set_num_threads(2)


def _pack(path, n=40, seed=0):
    """A RecordIO file of ``n`` records of random lengths (1..300)."""
    rs = np.random.RandomState(seed)
    payloads = [rs.bytes(rs.randint(1, 300)) for _ in range(n)]
    rec = recordio.MXRecordIO(path, "w")
    for p in payloads:
        rec.write(p)
    rec.close()
    return payloads


# ---------------------------------------------------------------- build
def test_libraries_build_into_the_cache_keyed_by_digest(tmp_path):
    assert runtime.get_lib() is not None and core.get_lib() is not None
    default = _native_build.native_path("recordio.cpp",
                                        ("-march=native", "-fopenmp"))
    assert os.path.exists(default)
    assert os.sep.join(("build", "native", "recordio")) in default
    kbuild.set_cache_root(str(tmp_path))
    try:
        moved = _native_build.native_path("recordio.cpp",
                                          ("-march=native", "-fopenmp"))
        assert moved.startswith(str(tmp_path / "native" / "recordio"))
        assert os.path.basename(moved) == os.path.basename(default)
        lib = _native_build.load_native("engine_core.cpp")
        assert lib is not None and os.path.exists(
            _native_build.native_path("engine_core.cpp"))
    finally:
        kbuild.set_cache_root(None)
    # the flags and the host's target are in the name
    assert _native_build.native_path("recordio.cpp") != default
    assert _native_build._host_target().startswith("-march=")


def test_no_library_takes_the_numpy_path(tmp_path, monkeypatch):
    payloads = _pack(str(tmp_path / "a.rec"))
    monkeypatch.setattr(runtime, "get_lib", lambda: None)
    rf = runtime.RecordFile(str(tmp_path / "a.rec"))
    assert rf._handle is None and isinstance(rf._py, io_runtime.RecordFile)
    assert [rf.read(i) for i in range(len(rf))] == payloads
    imgs = np.random.RandomState(1).randint(0, 256, (3, 5, 6, 3)).astype(
        np.uint8)
    before = runtime.native_assemblies
    np.testing.assert_array_equal(
        runtime.assemble_batch(imgs, mean=[1, 2, 3], std=[2, 3, 4]),
        io_runtime.assemble_batch(imgs, mean=[1, 2, 3], std=[2, 3, 4]))
    assert runtime.native_assemblies == before


# ------------------------------------------------------ reader, assembly
def test_recordfile_bitwise_the_jax_native_reader(tmp_path):
    path = str(tmp_path / "p.rec")
    payloads = _pack(path)
    assert jrt.get_lib() is not None
    mine, theirs = runtime.RecordFile(path), jrt.RecordFile(path)
    assert mine._handle is not None and theirs._handle
    assert len(mine) == len(theirs) == len(payloads)
    for i, p in enumerate(payloads):
        assert mine.read(i) == theirs.read(i) == p
    with pytest.raises(IndexError):
        mine.read(len(payloads))
    mine.close()
    mine.close()


ASSEMBLY = {
    "plain": {},
    "mean_std": dict(mean=[123.68, 116.28, 103.53], std=[58.4, 57.1, 57.4]),
    "mirror": dict(mean=[1.5, 2.5, 3.5], mirror=[1, 0, 1, 1]),
    "crop": dict(std=[3.0, 5.0, 7.0], crop=True),
    "all": dict(mean=[10.0, 20.0, 30.0], std=[2.0, 4.0, 8.0],
                mirror=[0, 1, 1, 0], crop=True),
}


@pytest.mark.parametrize("case", sorted(ASSEMBLY))
def test_assemble_batch_bitwise_the_jax_native(case):
    kw = dict(ASSEMBLY[case])
    rs = np.random.RandomState(7)
    imgs = rs.randint(0, 256, (4, 20, 18, 3)).astype(np.uint8)
    if kw.pop("crop", False):
        kw["crop_yx"] = (rs.randint(0, 7, 4), rs.randint(0, 5, 4))
        kw["out_hw"] = (13, 13)
    before = runtime.native_assemblies
    mine = runtime.assemble_batch(imgs, **kw)
    assert runtime.native_assemblies == before + 1
    theirs = jrt.assemble_batch(imgs, **kw)
    assert mine.dtype == np.float32 and mine.shape == theirs.shape
    np.testing.assert_array_equal(mine, theirs)
    staged = np.empty_like(mine)
    assert runtime.assemble_batch(imgs, out=staged, **kw) is staged
    np.testing.assert_array_equal(staged, mine)
    numpy = io_runtime.assemble_batch(imgs, **kw)
    ulps = np.abs(mine.view(np.int32).astype(np.int64)
                  - numpy.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    with pytest.raises(ValueError):
        runtime.assemble_batch(imgs, out=np.empty((1, 2), np.float32), **kw)


# --------------------------------------------- tests/test_engine.py, port
def _native():
    e = NativeEngine(4)
    assert e.available, "the native engine did not build"
    return e


def test_write_ops_serialize_in_order():
    e = _native()
    v = e.new_var()
    log = []
    for i in range(100):
        e.push(lambda i=i: log.append(i), mutate_vars=[v])
    e.wait_all()
    assert log == list(range(100))


def test_reads_run_concurrently_writes_exclusive():
    e = _native()
    v = e.new_var()
    lock = threading.Lock()
    state = {"active": 0, "max_active": 0, "at_write": -1}

    def reader():
        with lock:
            state["active"] += 1
            state["max_active"] = max(state["max_active"], state["active"])
        time.sleep(0.01)
        with lock:
            state["active"] -= 1

    for _ in range(8):
        e.push(reader, const_vars=[v])
    e.push(lambda: state.__setitem__("at_write", state["active"]),
           mutate_vars=[v])
    e.wait_all()
    assert state["max_active"] > 1, "readers should overlap"
    assert state["at_write"] == 0, "write must wait for all readers"


def test_independent_vars_overlap():
    e = _native()
    ev = threading.Event()
    v1, v2 = e.new_var(), e.new_var()
    e.push(lambda: ev.wait(5), mutate_vars=[v1])
    e.push(ev.set, mutate_vars=[v2])  # must not queue behind v1's op
    t0 = time.time()
    e.wait_all()
    assert time.time() - t0 < 4, "independent ops serialized"


def test_diamond_dependency():
    e = _native()
    a, b, c = e.new_var(), e.new_var(), e.new_var()
    log = []
    e.push(lambda: log.append("a"), mutate_vars=[a])
    e.push(lambda: log.append("b"), const_vars=[a], mutate_vars=[b])
    e.push(lambda: log.append("c"), const_vars=[a], mutate_vars=[c])
    e.push(lambda: log.append("d"), const_vars=[b, c])
    e.wait_all()
    assert log[0] == "a" and log[-1] == "d"
    assert set(log[1:3]) == {"b", "c"}


def test_wait_for_var_blocks_until_writes_done():
    e = _native()
    v = e.new_var()
    out = []
    e.push(lambda: (time.sleep(0.05), out.append(1)), mutate_vars=[v])
    e.wait_for_var(v)
    assert out == [1]


def test_push_error_surfaces_on_waitall():
    e = _native()
    v = e.new_var()
    e.push(lambda: 1 / 0, mutate_vars=[v])
    with pytest.raises(ZeroDivisionError):
        e.wait_all()


def test_dedup_overlapping_var_lists():
    e = _native()
    v = e.new_var()
    log = []
    e.push(lambda: log.append(1), const_vars=[v], mutate_vars=[v])
    e.wait_all()
    assert log == [1]


def test_profiler_records_dump():
    e = _native()
    v = e.new_var()
    e.profile_start()
    e.push(lambda: time.sleep(0.001), mutate_vars=[v], name="op_x")
    e.wait_all()
    e.profile_stop()
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        assert e.profile_dump(f.name) >= 1
        trace = json.load(open(f.name))
    ev = [t for t in trace["traceEvents"] if t["name"] == "op_x"][0]
    assert ev["ph"] == "X" and ev["dur"] >= 1000  # slept 1 ms


def test_engine_facade_uses_native():
    e = E.Engine()
    assert e.is_native
    v = e.new_var()
    log = []
    for i in range(10):
        e.push(lambda i=i: log.append(i), mutate_vars=[v])
    e.wait_for_all()
    assert log == list(range(10))
    e.del_var(v)
    with pytest.raises(ValueError):
        e.push(lambda: None, mutate_vars=[v])
    e.shutdown()


def test_pool_alloc_free_recycles():
    p = HostPool()
    assert p.available
    a = p.alloc_array((64, 64), np.float32)
    a[:] = 7.0
    addr = a.ctypes.data
    assert addr % 64 == 0, "64B alignment for staging copies"
    p.release(a)
    b = p.alloc_array((60, 64), np.float32)  # same pow2 bucket
    assert b.ctypes.data == addr, "free-list must recycle the buffer"


def test_pool_stats_and_release_all():
    p = HostPool()
    arrs = [p.alloc_array((1024,), np.float32) for _ in range(4)]
    assert p.used_bytes() >= 4 * 4096
    for a in arrs:
        p.release(a)
    assert p.used_bytes() == 0
    assert p.pooled_bytes() >= 4 * 4096
    p.release_all()
    assert p.pooled_bytes() == 0


def test_pool_distinct_buffers_while_held():
    p = HostPool()
    a = p.alloc_array((256,), np.uint8)
    b = p.alloc_array((256,), np.uint8)
    assert a.ctypes.data != b.ctypes.data
    a[:] = 1
    b[:] = 2
    assert int(a.sum()) == 256 and int(b.sum()) == 512
    # a pooled buffer crosses to torch without a copy
    t = torch.from_numpy(b)
    assert t.data_ptr() == b.ctypes.data


def test_profiler_facade_merges_native(tmp_path):
    from mxnet_tpu_torch import profiler as prof
    e = E.get()
    assert e.is_native
    out = tmp_path / "prof.json"
    prof.profiler_set_config(mode="all", filename=str(out))
    prof.profiler_set_state("run")
    try:
        v = e.new_var()
        e.push(lambda: time.sleep(0.001), mutate_vars=[v],
               name="host_stage")
        e.wait_for_all()
    finally:
        prof.profiler_set_state("stop")
    prof.dump_profile()
    prof.profiler_set_config()
    trace = json.load(open(str(out)))
    stage = [ev for ev in trace["traceEvents"] if ev["name"] == "host_stage"]
    assert stage and stage[0]["cat"] == "engine"


def test_engine_close_releases():
    e = _native()
    v = e.new_var()
    e.push(lambda: None, mutate_vars=[v])
    e.wait_all()
    e.close()
    e.close()  # idempotent
    assert not e.available


def test_profiler_escapes_op_names():
    e = _native()
    v = e.new_var()
    e.profile_start()
    e.push(lambda: None, mutate_vars=[v], name='stage "decode"\\x')
    e.wait_all()
    e.profile_stop()
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        assert e.profile_dump(f.name) >= 1
        trace = json.load(open(f.name))  # must parse despite quotes
    assert any("decode" in ev["name"] for ev in trace["traceEvents"])


def test_fallback_wait_for_var_drains(monkeypatch):
    """Where no library builds, the Python path keeps the hazard API."""
    monkeypatch.setattr(core, "get_lib", lambda: None)
    e = E.Engine(2)
    assert not e.is_native
    v = e.new_var()
    out = []
    e.push(lambda: (time.sleep(0.05), out.append(1)), mutate_vars=[v])
    e.wait_for_var(v)
    assert out == [1]
    e.shutdown()
