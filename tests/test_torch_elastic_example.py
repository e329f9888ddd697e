"""The port's twin of example/distributed-training/elastic_virtual_hosts.py
on the CPU, in a subprocess as a user runs it: two of four virtual hosts
killed at step 14, the resume at width 2 from step 12 bit for bit equal
to a continuous width-2 run, and the JAX script's accuracy assert (above
0.9); then in process at resnet-20 width, the net phase 19 of
chip_smoke.py runs on the card.
"""
import os
import subprocess
import sys

from mxnet_tpu_torch.examples import elastic_virtual_hosts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_elastic_twin_passes_the_jax_scripts_asserts(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-m",
         "mxnet_tpu_torch.examples.elastic_virtual_hosts", "--cpu"],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
        env=env)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    out = res.stdout
    assert "cluster: 4 hosts x 1 devices -> dp=4" in out
    assert "attempt 0: dp=4 worker_lost" in out
    assert "attempt 1: dp=2 finished (resume step 12)" in out
    assert "elastic == continuous: bitwise OK" in out
    acc = float(out.split("final train accuracy: ")[1].split()[0])
    assert acc > 0.9
    assert out.strip().endswith("ELASTIC_DEMO_OK")


def test_elastic_twin_resnet20():
    res = elastic_virtual_hosts.main([
        "--cpu", "--network", "resnet-20", "--num-epochs", "2",
        "--fail-at-step", "7", "--checkpoint-every", "3"])
    events = [(e["event"], e["dp_width"]) for e in res["transcript"]]
    assert events == [("worker_lost", 4), ("finished", 2)]
    assert res["resume_step"] == 6 and res["num_update"] == 32
