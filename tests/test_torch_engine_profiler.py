"""``mx.engine`` and ``mx.profiler`` of the PyTorch port
(mxnet_tpu_torch/engine.py, profiler.py), on the CPU.

The engine is held to the JAX package's engine contract as
``tests/test_engine.py`` states it for the native engine (writes
serialize in push order, reads overlap and a write waits for them,
disjoint vars overlap, the diamond, ``wait_for_var``, errors surface at
the waits, a var given as read and write), plus the NaiveEngine mode and
``MXNET_CPU_WORKER_NTHREADS``; where the JAX package's native engine
builds, the same push sequences run through it and log the same order.
The profiler's dump is held to the JAX package's event schema (the same
Scope sequence through both), its mode ``"all"`` to the engine's stamps
and the torch.profiler bridge's operators, and its env contract
(``MXNET_PROFILER_AUTOSTART``) in a subprocess. The profiler_demo twin
runs with its asserts.
"""
import json
import os
import subprocess
import sys
import threading
import time

import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import engine as E
from mxnet_tpu_torch import profiler as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_native():
    from mxnet_tpu.runtime.core import NativeEngine
    e = NativeEngine(4)
    return e if e.available else None


def _order_log(push, wait, new_var):
    """The diamond plus a serial chain, logged."""
    a, b, c, v = new_var(), new_var(), new_var(), new_var()
    log = []
    lock = threading.Lock()

    def rec(x):
        def f():
            with lock:
                log.append(x)
        return f

    push(rec("a"), mutate_vars=[a])
    push(rec("b"), const_vars=[a], mutate_vars=[b])
    push(rec("c"), const_vars=[a], mutate_vars=[c])
    push(rec("d"), const_vars=[b, c])
    for i in range(20):
        push(rec(i), mutate_vars=[v])
    wait()
    return log


def test_writes_serialize_in_order():
    e = E.Engine(4)
    v = e.new_var()
    log = []
    for i in range(100):
        e.push(lambda i=i: log.append(i), mutate_vars=[v])
    e.wait_for_all()
    assert log == list(range(100))


def test_reads_run_concurrently_writes_exclusive():
    e = E.Engine(4)
    v = e.new_var()
    lock = threading.Lock()
    state = {"active": 0, "max_active": 0, "at_write": -1}

    def reader():
        with lock:
            state["active"] += 1
            state["max_active"] = max(state["max_active"], state["active"])
        time.sleep(0.02)
        with lock:
            state["active"] -= 1

    for _ in range(8):
        e.push(reader, const_vars=[v])
    e.push(lambda: state.__setitem__("at_write", state["active"]),
           mutate_vars=[v])
    e.wait_for_all()
    assert state["max_active"] > 1, "readers should overlap"
    assert state["at_write"] == 0, "write must wait for all readers"


def test_independent_vars_overlap():
    e = E.Engine(2)
    ev = threading.Event()
    v1, v2 = e.new_var(), e.new_var()
    e.push(lambda: ev.wait(5), mutate_vars=[v1])
    e.push(ev.set, mutate_vars=[v2])   # must not queue behind v1's op
    t0 = time.time()
    e.wait_for_all()
    assert time.time() - t0 < 4, "independent ops serialized"


def test_diamond_and_chain_order_matches_the_jax_engine():
    e = E.Engine(4)
    log = _order_log(e.push, e.wait_for_all, e.new_var)
    assert log.index("a") < min(log.index("b"), log.index("c"))
    assert log.index("d") > max(log.index("b"), log.index("c"))
    assert [x for x in log if isinstance(x, int)] == list(range(20))
    native = _jax_native()
    if native is not None:
        jlog = _order_log(native.push, native.wait_all, native.new_var)
        ints = [x for x in jlog if isinstance(x, int)]
        assert ints == [x for x in log if isinstance(x, int)]
        assert jlog.index("a") < jlog.index("b") < jlog.index("d") or \
            jlog.index("a") < jlog.index("c") < jlog.index("d")


def test_wait_for_var_blocks_until_writes_done():
    e = E.Engine(2)
    v = e.new_var()
    out = []
    e.push(lambda: (time.sleep(0.05), out.append(1)), mutate_vars=[v])
    e.wait_for_var(v)
    assert out == [1]


def test_push_error_surfaces_on_the_waits():
    e = E.Engine(2)
    v = e.new_var()
    e.push(lambda: 1 / 0, mutate_vars=[v])
    with pytest.raises(ZeroDivisionError):
        e.wait_for_all()
    e.push(lambda: [][1], mutate_vars=[v])
    with pytest.raises(IndexError):
        e.wait_for_var(v)
    e.wait_for_all()    # errors are raised once


def test_var_given_as_read_and_write_does_not_deadlock():
    e = E.Engine(2)
    v = e.new_var()
    log = []
    e.push(lambda: log.append(1), const_vars=[v], mutate_vars=[v])
    e.wait_for_all()
    assert log == [1]


def test_priority_orders_ready_ops():
    e = E.Engine(1)
    gate = threading.Event()
    log = []
    e.push(lambda: gate.wait(5))              # holds the single worker
    for p in (0, 5, 2):
        e.push(lambda p=p: log.append(p), priority=p)
    gate.set()
    e.wait_for_all()
    assert log == [5, 2, 0]


def test_naive_engine_runs_at_push(monkeypatch):
    monkeypatch.setattr(E, "_NAIVE", True)
    e = E.Engine()
    assert not e._workers
    v = e.new_var()
    log = []
    done = e.push(lambda: log.append(threading.current_thread().name),
                  mutate_vars=[v])
    assert done.is_set() and log == [threading.current_thread().name]
    with pytest.raises(ZeroDivisionError):
        e.push(lambda: 1 / 0)
    code = ("import mxnet_tpu_torch as mx, mxnet_tpu as jmx; "
            "print(mx.engine.is_naive(), jmx.engine.is_naive(), "
            "mx.engine.get()._workers)")
    env = dict(os.environ, MXNET_ENGINE_TYPE="NaiveEngine",
               PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split()[-3:] == ["True", "True", "[]"]


def test_worker_threads_from_env(monkeypatch):
    """The native engine sizes its pool from the environment; where no
    library builds, the Python path does, on named daemon threads."""
    from mxnet_tpu_torch.runtime import core
    monkeypatch.setenv("MXNET_CPU_WORKER_NTHREADS", "3")
    native = E.Engine()
    assert native.num_workers == 3
    assert native.is_native == (core.get_lib() is not None)
    monkeypatch.setattr(core, "get_lib", lambda: None)
    for e in (native, E.Engine()):
        if e is not native:
            assert [t.name for t in e._workers] == \
                ["mxnet-engine-0", "mxnet-engine-1", "mxnet-engine-2"]
            assert all(t.daemon for t in e._workers)
            assert not e.is_native
        e.shutdown()
        e.shutdown()     # idempotent
        assert not e.is_native
        log = []
        e.push(lambda: log.append(1))   # after shutdown: runs in line
        assert log == [1]


def test_waitall_names_and_del_var():
    assert mx.waitall is mx.nd.waitall
    e = E.get()
    assert e is E.get()
    v = e.new_var()
    e.push(lambda: None, mutate_vars=[v])
    mx.waitall()
    e.del_var(v)
    with pytest.raises(ValueError):
        e.push(lambda: None, mutate_vars=[v])


# ---------------------------------------------------------------- profiler
@pytest.fixture
def fresh_profiler():
    P.profiler_set_state("stop")
    del P._events[:]
    del P._torch_events[:]
    del P._engine_events[:]
    yield
    P.profiler_set_state("stop")
    P.profiler_set_config()


def test_dump_matches_the_jax_event_schema(tmp_path, fresh_profiler):
    from mxnet_tpu import profiler as jprof
    for prof, name in ((P, "port.json"), (jprof, "jax.json")):
        prof.profiler_set_config(mode="symbolic",
                                 filename=str(tmp_path / name))
        prof.profiler_set_state("run")
        with prof.Scope("outer"):
            with prof.Scope("inner"):
                time.sleep(0.002)
        prof.profiler_set_state("stop")
        with prof.Scope("after_stop"):
            pass
        prof.dump_profile()
    port = json.load(open(str(tmp_path / "port.json")))
    jax = json.load(open(str(tmp_path / "jax.json")))
    assert set(port) == set(jax) == {"traceEvents", "displayTimeUnit"}
    assert port["displayTimeUnit"] == jax["displayTimeUnit"]

    def scopes(d):
        return [e for e in d["traceEvents"] if e["name"] in
                ("outer", "inner", "after_stop")]

    ps, js = scopes(port), scopes(jax)
    assert [e["name"] for e in ps] == [e["name"] for e in js] == \
        ["inner", "outer"]
    for p, j in zip(ps, js):
        assert set(p) == set(j)
        assert (p["cat"], p["ph"], p["pid"]) == (j["cat"], j["ph"], j["pid"])
    inner, outer = ps
    assert inner["dur"] >= 2000
    assert outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_all_mode_carries_engine_stamps_and_torch_ops(tmp_path,
                                                      fresh_profiler):
    import torch
    out = str(tmp_path / "all.json")
    P.profiler_set_config(mode="all", filename=out)
    P.profiler_set_state("run")
    e = E.get()
    v = e.new_var()
    e.push(lambda: time.sleep(0.001), mutate_vars=[v], name="host_stage")
    e.wait_for_all()
    with P.Scope("mm"):
        torch.randn(32, 32) @ torch.randn(32, 32)
    P.profiler_set_state("stop")
    P.dump_profile()
    events = json.load(open(out))["traceEvents"]
    stage = [ev for ev in events if ev["name"] == "host_stage"]
    assert stage and stage[0]["ph"] == "X" and stage[0]["dur"] >= 1000
    mm = [ev for ev in events if ev["name"] == "mm"][0]
    ops = [ev for ev in events if ev.get("cat") == "operator"
           and ev["name"].startswith("aten::")]
    assert any(ev["name"] == "aten::mm" for ev in ops)
    # the bridge's operators sit on the host's wall clock, inside the scope
    mmop = [ev for ev in ops if ev["name"] == "aten::mm"][0]
    assert mm["ts"] - 1e5 <= mmop["ts"] <= mm["ts"] + mm["dur"] + 1e5
    # symbolic mode leaves the engine's stamps out
    P.profiler_set_config(mode="symbolic", filename=out)
    P.dump_profile()
    events = json.load(open(out))["traceEvents"]
    assert not [ev for ev in events if ev["name"] == "host_stage"]


def test_autostart_env_contract(tmp_path):
    out = tmp_path / "auto.json"
    code = ("import mxnet_tpu_torch as mx\n"
            "with mx.profiler.Scope('auto_region'):\n"
            "    pass\n")
    env = dict(os.environ, PYTHONPATH=ROOT, MXNET_PROFILER_AUTOSTART="1",
               MXNET_PROFILER_MODE="1", MXNET_PROFILER_FILENAME=str(out))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    names = [e["name"] for e in json.load(open(str(out)))["traceEvents"]]
    assert "auto_region" in names


def test_profiler_demo_twin(tmp_path, fresh_profiler):
    from mxnet_tpu_torch.examples import profiler_demo
    res = profiler_demo.main(["--cpu", "--iter-num", "4", "--size", "64",
                              "--output", str(tmp_path / "p.json")])
    names = {e["name"] for e in res["events"]}
    assert {"matmul_%d" % i for i in range(4)} <= names
    assert res["kernels"] == 0          # no card here
    assert any(n.startswith("aten::") for n in names)
