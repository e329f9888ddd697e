"""The serve twin (``mxnet_tpu_torch.examples.serve_cifar10``, the port's
``example/image-classification/serve_cifar10.py``) end to end on the CPU.

A cold replica trains resnet-8 through ``fit`` into a CheckpointManager
directory, serves from it, traces and commits every bucket's program,
scrapes its Prometheus endpoint, reports its SLO and warm-starts a second
replica in process; a warm replica in a second process serves the same
checkpoint with ``--expect-warm``: no training, every bucket loaded, zero
compiles and traces, and the served-response digest of the cold run bit
for bit. Both run as a user runs them (subprocesses, with timeouts).
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
SMALL = ["--cpu", "--num-examples", "256", "--batch-size", "32",
         "--num-epochs", "1", "--max-batch-size", "8", "--clients", "4",
         "--requests", "6"]


def _run(args, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    env.pop("MXNET_COMPILE_CACHE_DIR", None)
    res = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.examples.serve_cifar10"] +
        SMALL + args, capture_output=True, text=True, timeout=TIMEOUT,
        cwd=str(cwd), env=env)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("SERVE_CIFAR10 ")][-1]
    return json.loads(line[len("SERVE_CIFAR10 "):]), res.stdout


@pytest.fixture(scope="module")
def cold(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_twin")
    out, text = _run(["--checkpoint-dir", "ck", "--cache-dir", "cache",
                      "--slo-report", "--digest-out", "cold.sha"], d)
    return d, out, text


def test_cold_replica_trains_checkpoints_and_commits(cold):
    d, out, text = cold
    assert out["source"] == "trained" and out["train_steps"] == 8
    assert sorted(out["warmup"]) == ["2", "4", "8"]
    assert {r["source"] for r in out["warmup"].values()} == {"compiled"}
    assert out["compiles"] == out["traces"] == out["cache_misses"] == 3
    assert out["warmup_compiles"] == 3
    # on the CPU nothing launches the BatchNorm kernels and nothing builds
    assert out["bn_fwd_launches"] == out["bn_bwd_launches"] == 0
    assert out["nvcc_builds"] == 0
    assert out["max_rel_l2"] <= 1e-5
    assert len(os.listdir(str(d / "cache" / "aot"))) == 3
    assert (d / "cold.sha").read_text() == out["digest"]
    for want in ("prometheus scrape ok", "slo report OK",
                 "second replica warm-started", "serving demo OK"):
        assert want in text, want


def test_warm_replica_in_a_second_process(cold):
    d, cold_out, _ = cold
    out, text = _run(["--checkpoint-dir", "ck", "--cache-dir", "cache",
                      "--expect-warm", "--digest-out", "warm.sha"], d)
    assert "warm start OK" in text
    assert out["source"] == "checkpoint" and out["train_steps"] == 0
    assert {r["source"] for r in out["warmup"].values()} == \
        {"deserialized"}
    assert out["compiles"] == out["traces"] == out["warmup_compiles"] == 0
    assert out["cache_hits"] == 3 and out["cache_misses"] == 0
    assert out["bn_fwd_launches"] == out["bn_bwd_launches"] == 0
    assert out["digest"] == cold_out["digest"]
    assert (d / "warm.sha").read_text() == (d / "cold.sha").read_text()


def test_expect_warm_fails_loudly_on_a_cold_cache(cold, tmp_path):
    """``--expect-warm`` against an empty cache directory is the gate's
    failure: the run exits non-zero naming the recompiled buckets."""
    d = cold[0]
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    env.pop("MXNET_COMPILE_CACHE_DIR", None)
    res = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.examples.serve_cifar10"] +
        SMALL + ["--checkpoint-dir", str(d / "ck"), "--cache-dir",
                 str(tmp_path / "empty"), "--expect-warm"],
        capture_output=True, text=True, timeout=TIMEOUT, cwd=str(tmp_path),
        env=env)
    assert res.returncode != 0
    assert "warm replica recompiled buckets" in res.stderr


def test_expect_warm_needs_a_cache_dir():
    from mxnet_tpu_torch.examples import serve_cifar10
    with pytest.raises(SystemExit):
        serve_cifar10.parse_args(["--expect-warm"])
