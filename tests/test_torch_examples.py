"""The port's example twins (``mxnet_tpu_torch.examples.train_mnist``,
``.train_cifar10``, ``.train_imagenet`` and ``.decode_lm``) on the CPU
(``--cpu``), run in subprocesses with timeouts as a user runs them: MNIST
mlp and lenet; CIFAR resnet-8 preempted after its first committed epoch
(exit 66) and resumed, landing on the uninterrupted run's parameter
digest bit for bit; one resnet-20 epoch with the serving smoke; the
CIFAR data flags (``--device-augment`` on the card's placement and the
host's, ``--cache-dataset`` with ``--prefetch-device``) landing on one
digest; the ImageNet twin on a synthesized PIL-JPEG pack at resnet-8
depth, and on inception-bn; every zoo network taken by its argument
check and built at its image shape; the scoring twin
(``benchmark_score``) and the fine-tuning twin (``fine_tune``, its two
asserts); the char-LM trained and served through the decode engine with
the arguments ``tests/test_examples.py`` gives the JAX script, and again
with ``--int8-weights``; the CIFAR twin under ``--precision int8_act``;
and each of the CIFAR twin's guardian, fault and telemetry flags, which
it refused until their modules were ported, running with its checks.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from mxnet_tpu_torch import models
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.examples import decode_lm, train_cifar10, train_imagenet

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


# the flags the twin refused until their modules were ported
ROBUSTNESS_FLAGS = ("fault_plan", "guardian", "health_report",
                    "program_report", "telemetry_jsonl", "telemetry_port")


@pytest.mark.parametrize("flag", ROBUSTNESS_FLAGS)
def test_train_cifar10_twin_refuses_later_flags(flag, tmp_path):
    """Each flag now runs (in process, the mlp for 2 epochs) and its
    checks hold: a healed commit transient, a rollback onto the committed
    entry, the step lines, the endpoint, the reports."""
    from mxnet_tpu_torch import faults, telemetry
    assert not train_cifar10.LATER_SLICES
    # the health report's "healthy" must not hang on host-clock noise: the
    # watchdog's time judges are held on fixed series elsewhere
    wd = telemetry.health_watchdog()
    wd.reset()
    tolerance, margin = wd.tolerance, wd.host_wait_margin
    wd.tolerance, wd.host_wait_margin = 1e9, 1.0
    argv = ["--cpu", "--network", "mlp", "--num-epochs", "2", "--seed", "3",
            "--checkpoint-dir", str(tmp_path / "ckpt")]
    value = {"fault_plan": "checkpoint.commit:transient@step=0",
             "telemetry_port": "0"}.get(flag, str(tmp_path / flag))
    if flag == "guardian":
        argv += ["--guardian", "--fault-plan",
                 "module.step:grad_nonfinite@epoch=1,nbatch=2"]
    else:
        argv += ["--" + flag.replace("_", "-"), value]
    try:
        res = train_cifar10.main(argv)
    finally:
        telemetry.disable()
        faults.disarm()
        wd.tolerance, wd.host_wait_margin = tolerance, margin
    assert res["accuracy"] >= 0.9
    if flag == "fault_plan":
        assert [i["site"] for i in res["incidents"]] == ["checkpoint.commit"]
    elif flag == "guardian":
        assert res["guardian"]["rollbacks"] == 1
        assert res["guardian"]["skipped"] == [(1, 2)]
    elif flag == "telemetry_port":
        assert res["step_records"] >= 64
    elif flag == "telemetry_jsonl":
        lines = (tmp_path / flag).read_text().split("\n")
        assert sum('"kind": "step"' in line for line in lines) == 64
    else:
        assert os.path.getsize(str(tmp_path / flag)) > 0


# the u8 pipeline three ways, started at once: the host placement of the
# augment, the card's placement streamed, and the card's placement cached
# on the device and prefetched
U8_RUNS = {"host": ["--device-augment", "--augment-placement", "host"],
           "device": ["--device-augment"],
           "cached": ["--cache-dataset", "--prefetch-device", "2"]}


@pytest.fixture(scope="module")
def u8_digests(tmp_path_factory):
    d = tmp_path_factory.mktemp("u8")
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    procs = {}
    for name, flags in U8_RUNS.items():
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "mxnet_tpu_torch.examples.train_cifar10"]
            + RESNET8 + flags + ["--params-digest-out",
                                 str(d / (name + ".txt")),
                                 "--acc-out", str(d / (name + ".acc"))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=str(d), env=env)
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, name + stderr[-4000:]
        out[name] = ((d / (name + ".txt")).read_text(),
                     float((d / (name + ".acc")).read_text()), stderr)
    return out


def test_train_cifar10_twin_augment_placements_equal(u8_digests):
    """--device-augment on the card's placement and on the host's (the
    same draws through apply_host) land on one parameter digest."""
    assert len(u8_digests["host"][0].strip()) == 64
    assert u8_digests["device"][0] == u8_digests["host"][0]
    assert u8_digests["device"][1] >= 0.9


def test_train_cifar10_twin_cache_dataset_equals_streaming(u8_digests):
    """--cache-dataset --prefetch-device 2 (the decoded epoch held on the
    device, batches staged ahead) lands on the streaming run's digest, and
    the cache was built and the ring used."""
    digest, acc, stderr = u8_digests["cached"]
    assert digest == u8_digests["device"][0]
    assert "dataset cache: device on cpu" in stderr
    assert "Host-wait=" in stderr
    assert acc >= 0.9


def test_train_cifar10_twin_refuses_serve_smoke_with_u8():
    with pytest.raises(SystemExit):
        train_cifar10.main(["--cpu", "--device-augment", "--serve-smoke"])


def test_train_imagenet_twin(tmp_path):
    """The ImageNet twin on its synthesized PIL-JPEG pack at resnet-8
    depth: a few steps through ImageRecordIter and fit."""
    res = _ok(_run("train_imagenet", [
        "--cpu", "--network", "resnet-8", "--image-shape", "3,28,28",
        "--batch-size", "8", "--synthetic-images", "32", "--num-epochs",
        "2", "--model-prefix", str(tmp_path / "m")],
        tmp_path))
    assert res.stdout.strip().endswith("TRAIN_IMAGENET_DONE")
    assert "synthesized 32-image rec" in res.stderr
    assert "final train accuracy" in res.stderr
    assert (tmp_path / "m-0002.params").exists()


@pytest.mark.parametrize("network", ["alexnet", "vgg", "googlenet",
                                     "inception-bn", "inception-v3",
                                     "resnext"])
def test_train_imagenet_twin_takes_zoo_networks(network):
    """The twin's argument check takes every zoo name, and the network it
    names builds and infers at the twin's image shape (299² for
    inception-v3)."""
    argv = ["--cpu", "--network", network]
    if network == "inception-v3":
        argv += ["--image-shape", "3,299,299"]
    args = train_imagenet.parse_args(argv)
    shape = tuple(int(x) for x in args.image_shape.split(","))
    net = models.get_symbol(args.network, num_classes=args.num_classes,
                            image_shape=args.image_shape)
    _, out_shapes, _ = net.infer_shape(data=(2,) + shape)
    assert out_shapes == [(2, args.num_classes)]


def test_train_imagenet_twin_refuses_unknown_networks():
    for name in ("vgg-bf16", "res"):
        with pytest.raises(MXNetError, match="not a name of the zoo"):
            train_imagenet.main(["--cpu", "--network", name])


def test_train_imagenet_twin_trains_a_zoo_network(tmp_path):
    """inception-bn (BatchNorm + ReLU throughout) a few steps through the
    twin on its synthesized pack at 32²."""
    res = _ok(_run("train_imagenet", [
        "--cpu", "--network", "inception-bn", "--image-shape", "3,32,32",
        "--batch-size", "4", "--synthetic-images", "8", "--num-epochs",
        "1"], tmp_path))
    assert res.stdout.strip().endswith("TRAIN_IMAGENET_DONE")


def test_benchmark_score_twin(tmp_path):
    """The scoring twin's log line per network, per batch and per group
    (``score_stacked`` with --batch-group), at tiny sizes."""
    res = _ok(_run("benchmark_score", [
        "--cpu", "--networks", "alexnet,inception-bn", "--batch-size", "2",
        "--num-batches", "4"], tmp_path))
    for net in ("alexnet", "inception-bn"):
        assert "network: %s, batch 2, group 1: " % net in res.stderr
    res = _ok(_run("benchmark_score", [
        "--cpu", "--networks", "alexnet", "--batch-size", "2",
        "--num-batches", "4", "--batch-group", "2"], tmp_path))
    line = [ln for ln in res.stderr.splitlines()
            if "network: alexnet, batch 2, group 2: " in ln]
    assert line and float(line[0].split(": ")[-1].split()[0]) > 0


def test_fine_tune_twin(tmp_path):
    """The JAX script's two asserts (trunk carried over, task-B accuracy
    above 0.85) hold, and the accuracy line is printed."""
    res = _ok(_run("fine_tune", ["--cpu"], tmp_path))
    acc = float(res.stdout.split("fine-tuned accuracy on task B: ")[1]
                .split()[0])
    assert acc > 0.85


def test_train_imagenet_twin_refuses_dist_kvstore(tmp_path):
    """The twin takes every dist kind now: in a world of one
    ``--kv-store dist_sync`` trains to the ``local`` run's parameters bit
    for bit (the step, not the store, reduces); an unknown kind is
    still refused."""
    def run(kv):
        out = str(tmp_path / ("%s.npz" % kv))
        train_imagenet.main([
            "--cpu", "--network", "resnet-8", "--image-shape", "3,28,28",
            "--batch-size", "8", "--synthetic-images", "16",
            "--num-epochs", "1", "--seed", "1", "--kv-store", kv,
            "--save-params", out])
        return dict(np.load(out))
    a, b = run("local"), run("dist_sync")
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(MXNetError):
        train_imagenet.main(["--cpu", "--kv-store", "bogus"])


def test_decode_lm_twin(tmp_path):
    """The JAX script's four checks: engine/module parity and the learned
    continuation (each >= 0.9), continuous streams bit for bit equal to
    sequential ones, and more tokens/s continuous than sequential."""
    res = _ok(_run("decode_lm", ["--cpu", "--num-epochs", "3", "--seq-len",
                                 "16", "--num-hidden", "64"], tmp_path))
    assert "decode_lm: all asserts passed" in res.stdout
    assert "parity: engine greedy matches module argmax" in res.stdout
    assert "streams sha256: " in res.stdout


def test_decode_lm_twin_int8_weights():
    """``--int8-weights`` as the JAX script runs it: the step's argument
    bytes below f32 (the ratio printed), parity and continuation above
    0.8, streams bit for bit, continuous faster than sequential."""
    res = decode_lm.main(["--cpu", "--int8-weights", "--num-epochs", "3",
                          "--seq-len", "16", "--num-hidden", "64"])
    assert res["continuous"]["weight_quant"] == "int8"
    assert res["continuous"]["precision_mode"] == "int8_weight"
    assert res["step_bytes_ratio"] > 2.0
    assert res["parity"] >= int(0.8 * res["prompts"])
    assert res["continuation"] >= 0.8


def test_train_cifar10_twin_int8_act(tmp_path):
    """The CIFAR twin trains under the experimental ``int8_act`` mode
    (bfloat16 compute, every input round-tripped through int8, the live
    loss scale) at resnet-8 depth."""
    env = dict(os.environ, MXNET_PRECISION_EXPERIMENTAL="1")
    res = _ok(subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.examples.train_cifar10"]
        + RESNET8 + ["--num-epochs", "1", "--precision", "int8_act",
                     "--params-digest-out", str(tmp_path / "d")],
        capture_output=True, text=True, timeout=TIMEOUT, cwd=str(tmp_path),
        env=dict(env, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)))
    assert "precision mode: int8_act" in res.stderr
    assert len((tmp_path / "d").read_text().strip()) == 64
