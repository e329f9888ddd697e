"""The port's example twins (``mxnet_tpu_torch.examples.train_mnist``,
``.train_cifar10`` and ``.decode_lm``) on the CPU (``--cpu``), run in
subprocesses with timeouts as a user runs them: MNIST mlp and lenet;
CIFAR resnet-8 preempted after its first committed epoch (exit 66) and
resumed, landing on the uninterrupted run's parameter digest bit for bit;
one resnet-20 epoch with the serving smoke; the char-LM trained and
served through the decode engine with the arguments
``tests/test_examples.py`` gives the JAX script; and every flag whose
module the port does not have yet refused with ``MXNetError`` naming its
slice.
"""
import os
import subprocess
import sys

import pytest

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.examples import decode_lm, train_cifar10

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
RESNET8 = ["--cpu", "--network", "resnet-8", "--num-epochs", "2",
           "--seed", "7"]


def _run(module, args, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    return subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.examples." + module] + args,
        capture_output=True, text=True, timeout=TIMEOUT, cwd=str(cwd),
        env=env)


def _ok(res):
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    return res


@pytest.mark.parametrize("network", ["mlp", "lenet"])
def test_train_mnist_twin(tmp_path, network):
    res = _ok(_run("train_mnist", ["--cpu", "--network", network,
                                   "--num-epochs", "2"], tmp_path))
    assert "final validation: [('accuracy'," in res.stdout
    acc = float(res.stdout.split("('accuracy', ")[1].split(")")[0])
    assert acc >= 0.9, res.stdout


@pytest.fixture(scope="module")
def preempted(tmp_path_factory):
    """resnet-8 with a checkpoint per epoch, preempted after epoch 1."""
    d = tmp_path_factory.mktemp("cifar")
    res = _run("train_cifar10", RESNET8 + [
        "--checkpoint-dir", str(d / "ckpt"), "--exit-after-epoch", "1"], d)
    return d, res


def test_train_cifar10_twin_preempts_with_exit_66(preempted):
    d, res = preempted
    assert res.returncode == 66, res.stderr[-4000:]
    assert CheckpointManager(str(d / "ckpt")).all_steps() == [0]


def test_train_cifar10_twin_resume_equals_uninterrupted(preempted, tmp_path):
    d, _ = preempted
    _ok(_run("train_cifar10", RESNET8 + [
        "--params-digest-out", str(tmp_path / "straight.txt")], tmp_path))
    res = _ok(_run("train_cifar10", RESNET8 + [
        "--checkpoint-dir", str(d / "ckpt"), "--resume",
        "--params-digest-out", str(tmp_path / "resumed.txt"),
        "--acc-out", str(tmp_path / "acc.txt")], tmp_path))
    assert "resumed from checkpoint step 0" in res.stderr
    straight = (tmp_path / "straight.txt").read_text()
    assert len(straight.strip()) == 64
    assert (tmp_path / "resumed.txt").read_text() == straight
    assert CheckpointManager(str(d / "ckpt")).all_steps() == [0, 1]
    assert float((tmp_path / "acc.txt").read_text()) >= 0.9


def test_train_cifar10_twin_resnet20_serves(tmp_path):
    res = _ok(_run("train_cifar10", [
        "--cpu", "--num-epochs", "1", "--seed", "7", "--serve-smoke",
        "--min-accuracy", "0.5"], tmp_path))
    assert "serving smoke: 64 requests ok" in res.stderr
    assert "compiles frozen at 5" in res.stderr


@pytest.mark.parametrize("flag", sorted(train_cifar10.LATER_SLICES))
def test_train_cifar10_twin_refuses_later_flags(flag):
    value = {"batch_group": "2", "prefetch_device": "2",
             "telemetry_port": "0", "augment_placement": "host"}.get(
                 flag, "x")
    argv = ["--cpu", "--" + flag.replace("_", "-")]
    if flag not in ("device_augment", "cache_dataset", "guardian"):
        argv.append(value)
    with pytest.raises(MXNetError, match="slice"):
        train_cifar10.main(argv)


def test_decode_lm_twin(tmp_path):
    """The JAX script's four checks: engine/module parity and the learned
    continuation (each >= 0.9), continuous streams bit for bit equal to
    sequential ones, and more tokens/s continuous than sequential."""
    res = _ok(_run("decode_lm", ["--cpu", "--num-epochs", "3", "--seq-len",
                                 "16", "--num-hidden", "64"], tmp_path))
    assert "decode_lm: all asserts passed" in res.stdout
    assert "parity: engine greedy matches module argmax" in res.stdout
    assert "streams sha256: " in res.stdout


def test_decode_lm_twin_refuses_int8_weights():
    with pytest.raises(MXNetError, match="A6"):
        decode_lm.main(["--cpu", "--int8-weights"])
