"""The port's checkpoint manager (mxnet_tpu_torch.checkpoint) on the CPU.

Mirrors ``tests/test_checkpoint.py``'s contracts on the port's
``CheckpointManager``: atomic commits, invisible and swept partials,
retention and step collisions, async saves that snapshot before the next
step mutates the weights in place, a pending save drained at interpreter
exit, the RNG state round trip, and ``fit(resume_from=)`` equal to the
uninterrupted run bit for bit. Across packages: an entry the JAX
package's manager wrote restores in the port bit for bit and the reverse,
``Module.load`` in each package binds the other's entry with the same
parameters, and the port refuses the JAX package's optimizer-state
payload.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.name import NameManager as JNameManager

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import CheckpointManager, serialize
from mxnet_tpu_torch.checkpoint import manager as manager_mod
from mxnet_tpu_torch.name import NameManager as TNameManager

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = tmx.cpu()
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def _mlp(pkg=tmx, names=TNameManager):
    with names():
        net = pkg.sym.Variable("data")
        net = pkg.sym.FullyConnected(net, num_hidden=32, name="fc1")
        net = pkg.sym.BatchNorm(net, fix_gamma=False, name="bn1")
        net = pkg.sym.Activation(net, act_type="relu")
        net = pkg.sym.FullyConnected(net, num_hidden=10, name="fc2")
        return pkg.sym.SoftmaxOutput(net, name="softmax")


def _data(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(64, 20).astype(np.float32),
            rs.randint(0, 10, 64).astype(np.float32))


def _iter(pkg=tmx, shuffle=True):
    x, y = _data()
    return pkg.io.NDArrayIter(x, y, batch_size=16, shuffle=shuffle)


def _fit(mod, it, num_epoch, resume_from=None, callback=None):
    mod.fit(it, num_epoch=num_epoch, resume_from=resume_from,
            epoch_end_callback=callback, initializer=tmx.init.Xavier(),
            optimizer_params=OPT)


def _params_np(mod):
    a, x = mod.get_params()
    return {k: v.asnumpy() for k, v in list(a.items()) + list(x.items())}


def _w(v):
    return tmx.nd.array(np.asarray(v, np.float32), ctx=CPU)


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------
def test_async_save_snapshots_before_in_place_mutation(tmp_path):
    """save() returns with its own host copy: the next step's in-place
    update of the weight tensor cannot reach the committed entry."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    w = _w([1.0, 2.0, 3.0])
    before = w.asnumpy().copy()
    mgr.save(0, {"w": w}, async_save=True)
    with torch.no_grad():
        w._read().mul_(-7.0)   # what sgd_mom_update does to a weight
    mgr.wait_until_finished()
    np.testing.assert_array_equal(mgr.restore(0).params["w"], before)


def test_async_save_drained_at_interpreter_exit(tmp_path):
    root = str(tmp_path / "ckpt")
    script = (
        "import sys, time\n"
        "import numpy as np\n"
        "import mxnet_tpu_torch as mx\n"
        "from mxnet_tpu_torch.checkpoint import CheckpointManager, "
        "serialize\n"
        "real = serialize.write_array\n"
        "def slow(path, arr):\n"
        "    time.sleep(1.5)\n"
        "    return real(path, arr)\n"
        "serialize.write_array = slow\n"
        "mgr = CheckpointManager(sys.argv[1])\n"
        "mgr.save(0, {'w': np.array([5.0], np.float32)}, async_save=True)\n"
        "# no wait_until_finished(): exits with the save in flight\n")
    res = subprocess.run([sys.executable, "-c", script, root],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr
    mgr = CheckpointManager(root)
    assert mgr.latest() == 0
    np.testing.assert_array_equal(mgr.restore().params["w"], [5.0])


def test_crash_before_rename_keeps_previous_step(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(0, {"w": _w([42.0])}, async_save=False)

    def die(tmp, final):
        raise OSError("simulated preemption before rename")

    monkeypatch.setattr(manager_mod, "_commit_entry", die)
    mgr.save(1, {"w": _w([-1.0])}, async_save=True)
    with pytest.raises(MXNetError, match="step 1"):
        mgr.wait_until_finished()
    monkeypatch.undo()
    assert mgr.all_steps() == [0] and mgr.latest() == 0
    np.testing.assert_array_equal(mgr.restore().params["w"], [42.0])
    assert not [n for n in os.listdir(mgr.directory) if n.startswith(".tmp")]
    mgr.save(1, {"w": _w([9.0])}, async_save=False)
    assert mgr.latest() == 1


def test_partial_entries_are_invisible_and_swept(tmp_path):
    root = str(tmp_path / "ckpt")
    mgr = CheckpointManager(root)
    mgr.save(2, {"w": _w([1.0])}, async_save=False)
    crashed = os.path.join(root, ".tmp-step_00000003-deadbeef")
    os.makedirs(crashed)
    with open(os.path.join(crashed, "a00000_s00.npy"), "wb") as f:
        f.write(b"partial")
    os.makedirs(os.path.join(root, "step_00000007"))   # no manifest
    assert mgr.all_steps() == [2] and mgr.latest() == 2
    assert CheckpointManager(root).latest() == 2
    assert os.path.exists(crashed)          # readers never sweep
    writer = CheckpointManager(root)
    writer.save(8, {"w": _w([2.0])}, async_save=False)
    assert not os.path.exists(crashed)
    assert writer.all_steps() == [2, 8]


def test_retention_gc_and_step_collision(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2, keep_every=4)
    for s in range(10):
        mgr.save(s, {"w": _w([float(s)])}, async_save=(s % 2 == 0))
    mgr.wait_until_finished()
    assert mgr.all_steps() == [0, 4, 8, 9]
    np.testing.assert_array_equal(mgr.restore(4).params["w"], [4.0])
    with pytest.raises(MXNetError, match="already exists"):
        mgr.save(9, {"w": _w([1.0])}, async_save=False)


def test_restore_walks_back_past_a_corrupt_entry(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    for s in (1, 2):
        mgr.save(s, {"w": _w([float(s)] * 4)}, extra={"epoch": s},
                 async_save=False)
    shard = os.path.join(mgr.directory, "step_00000002", "a00000_s00.npy")
    with open(shard, "r+b") as f:
        f.seek(-4, os.SEEK_END)
        f.write(b"\xff\xff\xff\xff")
    with pytest.raises(MXNetError, match="crc32"):
        mgr.restore(2)
    ckpt = mgr.restore()
    assert ckpt.step == 1 and mgr.step_metadata(1) == {"epoch": 1}
    assert mgr.restore_before(lambda s, extra: extra["epoch"] < 2).step == 1
    assert mgr.discard_after(1) == [2] and mgr.all_steps() == [1]


def test_rng_state_round_trips(tmp_path):
    """numpy's legacy generator and every torch generator come back, in
    memory and through the entry's rng.npz."""
    tmx.random.seed(11)
    gen = tmx.random.generator(torch.device("cpu"))
    torch.rand(3, generator=gen)
    state = tmx.random.get_state()
    t1 = torch.rand(4, generator=gen)
    n1 = np.random.rand(3)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(0, {"w": _w([1.0])}, rng_state=state, async_save=False)
    for restored in (state, mgr.restore().rng):
        tmx.random.seed(99)
        np.random.rand(5)
        tmx.random.set_state(restored)
        g = tmx.random.generator(torch.device("cpu"))
        assert torch.equal(torch.rand(4, generator=g), t1)
        np.testing.assert_array_equal(np.random.rand(3), n1)


# ---------------------------------------------------------------------------
# fit and Module persistence
# ---------------------------------------------------------------------------
def _train(num_epoch, manager=None, stop_after=None, resume=False):
    """Seeded fit of the mlp, optionally checkpointing every epoch into
    ``manager`` and stopping after ``stop_after`` epochs (a preemption),
    or resuming from it."""
    np.random.seed(7)
    tmx.random.seed(7)
    mod = tmx.mod.Module(_mlp(), context=CPU)
    callbacks = []
    if manager is not None:
        callbacks.append(tmx.callback.module_checkpoint(
            mod, save_optimizer_states=True, manager=manager))
    _fit(mod, _iter(), stop_after or num_epoch,
         resume_from=manager if resume else None,
         callback=callbacks or None)
    if manager is not None:
        manager.wait_until_finished()
    return mod


def test_fit_resume_equals_uninterrupted_bit_for_bit(tmp_path):
    ref = _train(4)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    _train(4, manager=mgr, stop_after=2)
    assert mgr.latest() == 1
    meta = mgr.step_metadata()
    assert meta["epoch"] == 1 and meta["precision_mode"] == "f32"
    assert meta["params_digest"] == tmx.checkpoint.params_digest(
        meta["symbol"], tmx.checkpoint.pack_params(*ref.get_params()))
    mod = _train(4, manager=mgr, resume=True)
    a, b = _params_np(ref), _params_np(mod)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert mod._optimizer.num_update == ref._optimizer.num_update == 16


def test_resume_from_empty_manager_starts_fresh(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mod = tmx.mod.Module(_mlp(), context=CPU)
    _fit(mod, _iter(), 1, resume_from=str(tmp_path / "ckpt"))
    assert mod.params_initialized and mgr.latest() is None
    assert mod._optimizer.num_update == 4


def test_resume_refuses_step_granular_entry(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mod = tmx.mod.Module(_mlp(), context=CPU)
    _fit(mod, _iter(), 1)
    mod.save_checkpoint(None, 0, manager=mgr, async_save=False,
                        extra={"nbatch": 3})
    with pytest.raises(MXNetError, match="dist slice"):
        _fit(tmx.mod.Module(_mlp(), context=CPU), _iter(), 2,
             resume_from=mgr)


def test_load_legacy_prefix_colliding_with_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    os.makedirs("mymodel")
    it = _iter()
    mod = tmx.mod.Module(_mlp(), context=CPU)
    _fit(mod, it, 1)
    mod.save_checkpoint("mymodel", 1, save_optimizer_states=True)
    mod2 = tmx.mod.Module.load("mymodel", 1, load_optimizer_states=True,
                               context=CPU)
    mod2.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod2.init_optimizer(optimizer_params=OPT)
    a, b = _params_np(mod), _params_np(mod2)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert mod2._optimizer.num_update == mod._optimizer.num_update == 4


def test_module_checkpoint_needs_a_target():
    with pytest.raises(ValueError):
        tmx.callback.module_checkpoint(tmx.mod.Module(_mlp(), context=CPU))


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------
def _jax_module():
    """A JAX-package module of the same mlp, trained one epoch."""
    jmx.random.seed(3)
    mod = jmx.mod.Module(_mlp(jmx, JNameManager), context=jmx.cpu())
    mod.fit(_iter(jmx, shuffle=False), num_epoch=1,
            initializer=jmx.init.Xavier(), optimizer_params=OPT)
    return mod


def _jax_params_np(mod):
    a, x = mod.get_params()
    return {k: v.asnumpy() for k, v in list(a.items()) + list(x.items())}


def test_jax_entry_restores_in_the_port_bit_for_bit(tmp_path):
    jmod = _jax_module()
    jmgr = jmx.checkpoint.CheckpointManager(str(tmp_path / "j"))
    jmod.save_checkpoint(None, 0, save_optimizer_states=True, manager=jmgr,
                         async_save=False)
    want = _jax_params_np(jmod)
    ckpt = CheckpointManager(str(tmp_path / "j")).restore()
    for k, v in tmx.checkpoint.pack_params(*jmod.get_params()).items():
        np.testing.assert_array_equal(ckpt.params[k], v.asnumpy(),
                                      err_msg=k)
    # Module.load in the port binds the JAX entry with its parameters
    tmod = tmx.mod.Module.load(str(tmp_path / "j"), context=CPU)
    tmod.bind(data_shapes=[("data", (16, 20))],
              label_shapes=[("softmax_label", (16,))])
    got = _params_np(tmod)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the JAX optimizer-state payload is refused, naming its writer
    tmod = tmx.mod.Module.load(str(tmp_path / "j"),
                               load_optimizer_states=True, context=CPU)
    tmod.bind(data_shapes=[("data", (16, 20))],
              label_shapes=[("softmax_label", (16,))])
    with pytest.raises(MXNetError, match="JAX package"):
        tmod.init_optimizer(optimizer_params=OPT)


def test_port_entry_restores_in_jax_bit_for_bit(tmp_path):
    mod = tmx.mod.Module(_mlp(), context=CPU)
    _fit(mod, _iter(), 1)
    mgr = CheckpointManager(str(tmp_path / "t"))
    mod.save_checkpoint(None, 5, save_optimizer_states=True, manager=mgr)
    mgr.wait_until_finished()
    want = _params_np(mod)
    ckpt = jmx.checkpoint.CheckpointManager(str(tmp_path / "t")).restore()
    assert ckpt.step == 5 and ckpt.extra["epoch"] == 5
    jmod = jmx.mod.Module.load(str(tmp_path / "t"), context=jmx.cpu())
    jmod.bind(data_shapes=[("data", (16, 20))],
              label_shapes=[("softmax_label", (16,))])
    got = _jax_params_np(jmod)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the two packages key the entry by the same structural digest
    assert ckpt.extra["params_digest"] == \
        jmx.checkpoint.params_digest(ckpt.extra["symbol"], ckpt.params)


def test_rng_file_reads_across_packages(tmp_path):
    """rng.npz of either package reads in the other: numpy's state both
    ways, the port's seed as the JAX key ``PRNGKey(seed)``."""
    tmx.random.seed(21)
    np.random.rand(2)
    path = str(tmp_path / "rng.npz")
    serialize.dump_rng(path, tmx.random.get_state())
    jstate = jmx.checkpoint.serialize.load_rng(path)
    np.testing.assert_array_equal(jstate["jax_key"], [0, 21])
    n1 = np.random.rand(3)
    jmx.random.set_state(jstate)
    np.testing.assert_array_equal(np.random.rand(3), n1)
    jmx.random.seed(5)
    jpath = str(tmp_path / "jrng.npz")
    jmx.checkpoint.serialize.dump_rng(jpath, jmx.random.get_state())
    tstate = serialize.load_rng(jpath)
    assert tstate["seed"] == 5 and tstate["torch"] == {}
    tmx.random.set_state(tstate)
    np.testing.assert_array_equal(np.random.rand(4),
                                  np.random.RandomState(5).rand(4))
