"""Online inference demo: the port's twin of
``example/image-classification/serve_cifar10.py``.

    python -m mxnet_tpu_torch.examples.serve_cifar10 [--cpu]
        [--checkpoint-dir D] [--cache-dir C [--expect-warm]]
        [--digest-out F] [--metrics-port P] [--slo-report]
        [--num-examples 4096] [--batch-size 128] [--num-epochs 2]

A CIFAR-10 model served to concurrent clients through
``mxnet_tpu_torch.serving``: a ``Predictor`` (one bound module per padded
batch-size bucket) behind a ``DynamicBatcher`` (bounded queue and request
coalescing), with client threads firing mixed-size requests. The flow is
the JAX script's:

1. train resnet-8 on the JAX script's synthetic CIFAR data through
   ``fit`` — with ``--checkpoint-dir`` a ``CheckpointManager`` commits each
   epoch and the model is then served FROM the directory; a run whose
   ``--checkpoint-dir`` already holds a committed entry skips training;
2. warm every bucket up: with ``--cache-dir`` each bucket's program is
   traced with ``torch.export`` and committed, or loaded when a replica
   already committed it (``serving.cache``; ``--expect-warm`` asserts
   the load: every bucket ``"deserialized"``, zero compiles, zero
   warmup compiles);
3. serve a concurrent mixed-size load, scrape the Prometheus endpoint
   once (``--metrics-port``; 0 picks a free port), and with
   ``--slo-report`` check the SLO tracker's gauges and request traces;
4. print the stats and assert the serving contracts; with ``--cache-dir``
   and no ``--expect-warm``, a second replica in process warm-starts from
   the entries just committed.

``--cache-dir`` also moves every ``nvcc`` build of the process under
``<cache-dir>/cuda/`` (``enable_persistent_compile_cache``): on the card
the twin loads its BatchNorm kernels before anything else, so a second
process pointed at the same directory runs no ``nvcc``.

Differences from the JAX script: it runs on ``gpu(0)`` (or ``--gpus``/
``--tpus``) unless ``--cpu`` is given, with cuDNN deterministic; clients'
rows are held to ``Module.predict`` within a relative L2 of
``SERVE_REL_L2`` (``Module.predict`` runs at 128 rows, the buckets at
2-32, and the GEMM and convolution libraries may pick another algorithm
at another batch size, as in ``train_cifar10``), while the warm replicas'
rows are held to the cold replica's bit for bit; ``--expect-warm``
counts the compile watch's warmup compiles from the warmup on (the JAX
script reads the process total, the same number in a fresh process);
``--num-examples`` sizes the synthetic set. The last line of output is
``SERVE_CIFAR10 {json}`` with the run's numbers (BatchNorm launches,
``nvcc`` runs, traces, per-bucket warmup, the served digest, ...);
``main(argv)`` returns the same dict.
"""
import argparse
import hashlib
import json
import logging
import threading
import time
import urllib.request

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import models
from mxnet_tpu_torch.examples.common import device_context
from mxnet_tpu_torch.examples.train_cifar10 import synthetic_cifar
from mxnet_tpu_torch.kernels import batchnorm as bn_kernels
from mxnet_tpu_torch.kernels import build
from mxnet_tpu_torch.serving import DynamicBatcher, Predictor, QueueFull
from mxnet_tpu_torch.serving import cache as serving_cache

SERVE_REL_L2 = 1e-5
IMAGE = (3, 28, 28)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="serve cifar10")
    parser.add_argument("--network", default="resnet-8")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--num-epochs", type=int, default=2)
    parser.add_argument("--num-examples", type=int, default=4096,
                        help="size of the synthetic training set")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--max-batch-size", type=int, default=32,
                        help="top serving bucket (powers of two below)")
    parser.add_argument("--clients", type=int, default=8)
    parser.add_argument("--requests", type=int, default=24,
                        help="requests per client thread")
    parser.add_argument("--max-wait-ms", type=float, default=2.0)
    parser.add_argument("--checkpoint-dir", default=None,
                        help="train into this CheckpointManager directory "
                             "and serve from it; a directory that already "
                             "holds a committed entry is served without "
                             "training")
    parser.add_argument("--cache-dir", default=None,
                        help="persistent executable cache: warmup loads "
                             "each bucket's program from here or traces "
                             "and commits it for the next replica; nvcc "
                             "builds go under <dir>/cuda")
    parser.add_argument("--expect-warm", action="store_true",
                        help="assert this replica warm-started: every "
                             "bucket loaded from --cache-dir, zero "
                             "compiles and zero warmup compiles")
    parser.add_argument("--digest-out", default=None,
                        help="write the sha256 of a fixed serial request "
                             "sweep's responses here")
    parser.add_argument("--metrics-port", type=int, default=0,
                        help="Prometheus /metrics endpoint beside the "
                             "batcher (0 = a free port); scraped once")
    parser.add_argument("--slo-report", action="store_true",
                        help="attach an SLOTracker and request traces; "
                             "assert the slo.* gauges and no breach")
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card to run on (one id)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU")
    args = parser.parse_args(argv)
    if args.expect_warm and not args.cache_dir:
        parser.error("--expect-warm needs --cache-dir")
    return args


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def train(args, ctx, X, y):
    """``fit`` resnet-8 (checkpointing each epoch into --checkpoint-dir);
    returns (module, steps)."""
    net = models.get_symbol(args.network, num_classes=10, image_shape=IMAGE)
    mod = mx.mod.Module(net, context=ctx)
    it = mx.io.NDArrayIter(X, y, batch_size=args.batch_size, shuffle=True)
    steps = []
    callbacks = None
    manager = None
    if args.checkpoint_dir:
        manager = mx.checkpoint.CheckpointManager(args.checkpoint_dir,
                                                  keep=2)
        callbacks = [mx.callback.module_checkpoint(mod, manager=manager)]
    mod.fit(it, num_epoch=args.num_epochs,
            initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9,
                              "wd": 1e-4},
            batch_end_callback=lambda p: steps.append(p.nbatch),
            epoch_end_callback=callbacks)
    if manager is not None:
        manager.wait_until_finished()
    return mod, len(steps)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)
    np.random.seed(args.seed)
    mx.random.seed(args.seed)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    builds0, traces0 = build.builds, serving_cache.traces
    bn0 = (bn_kernels.bn_fwd.launches, bn_kernels.bn_bwd.launches)
    if args.cache_dir:
        serving_cache.enable_persistent_compile_cache(args.cache_dir)
    if ctx.device_type == "gpu":
        bn_kernels._library()     # this path's kernels, built or found

    rng = np.random.RandomState(0)
    X, y = synthetic_cifar(rng, n=args.num_examples)
    Xte, yte = X[:512], y[:512]

    steps = 0
    committed = args.checkpoint_dir and \
        mx.checkpoint.CheckpointManager(args.checkpoint_dir).latest() \
        is not None
    if committed:
        logging.info("serving the committed entry of %s (no training)",
                     args.checkpoint_dir)
    else:
        mod, steps = train(args, ctx, X, y)
    data_shapes = None
    if args.checkpoint_dir:
        mod = mx.mod.Module.load(args.checkpoint_dir, context=ctx)
        data_shapes = [("data", (args.batch_size,) + IMAGE)]

    pred = Predictor(mod, data_shapes=data_shapes,
                     max_batch_size=args.max_batch_size)
    # offline reference: the blocking predict loop (a restored module
    # binds for itself here)
    if not mod.binded:
        mod.bind(data_shapes=[("data", (args.batch_size,) + IMAGE)],
                 for_training=False)
    ref = mod.predict(mx.io.NDArrayIter(
        Xte, yte, batch_size=args.batch_size)).asnumpy()

    watch = mx.telemetry.compile_watch()
    warm0 = watch.warmup_compiles
    t0 = time.time()
    pred.warmup(cache_dir=args.cache_dir)
    rep = pred.warmup_report()
    logging.info("warmup: buckets %s ready in %.1fs (%s)", pred.buckets,
                 time.time() - t0, ", ".join(
                     "b%d:%s %.0fms" % (b, r["source"], r["warmup_ms"])
                     for b, r in sorted(rep.items())))
    # compiles expected after warmup: one per bucket not loaded
    expected_compiles = sum(1 for r in rep.values()
                            if r["source"] != "deserialized")
    warmup_compiles = watch.warmup_compiles - warm0
    if args.expect_warm:
        cold = {b: r["source"] for b, r in rep.items()
                if r["source"] != "deserialized"}
        assert not cold, "warm replica recompiled buckets %r" % cold
        s0 = pred.stats()
        assert s0["compiles"] == 0, s0
        assert s0["cache_hits"] == len(pred.buckets), s0
        assert warmup_compiles == 0, warmup_compiles
        print("warm start OK: %d buckets loaded in %.2fs, zero traces"
              % (len(pred.buckets), time.time() - t0))

    errs, worst = [], [0.0]
    slo = None
    if args.slo_report:
        mx.telemetry.enable()   # request traces ride the same switch
        slo = mx.telemetry.SLOTracker(
            name="serve_cifar10", p99_ms=60_000.0, error_rate=1e-3,
            availability=0.99)
    server = DynamicBatcher(pred, max_queue=4 * args.clients,
                            max_wait_ms=args.max_wait_ms,
                            metrics_port=args.metrics_port, slo=slo)
    logging.info("Prometheus endpoint: %s", server.metrics_server.url)

    def client(i):
        crng = np.random.RandomState(1000 + i)
        for _ in range(args.requests):
            n = int(crng.randint(1, args.max_batch_size // 2 + 2))
            lo = int(crng.randint(0, len(Xte) - n))
            try:
                out = server.predict(Xte[lo:lo + n], timeout=300)
            except QueueFull:
                time.sleep(0.005)   # backpressure: shed and retry later
                continue
            err = rel_l2(out, ref[lo:lo + n])
            worst[0] = max(worst[0], err)
            if err > SERVE_REL_L2:
                errs.append("client %d: rows differ from Module.predict "
                            "(relative L2 %.3g)" % (i, err))
                return

    t0 = time.time()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(args.clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    # scrape the live endpoint once, while the counters are hot
    with urllib.request.urlopen(server.metrics_server.url,
                                timeout=10) as resp:
        prom = resp.read().decode()
    assert resp.status == 200
    assert "mxtpu_serving_" in prom and "_latency_ms_bucket" in prom, \
        prom[:400]
    sample = [ln for ln in prom.splitlines()
              if ln.startswith("mxtpu_serving_") and "{" not in ln][:6]
    print("prometheus scrape ok (%d lines), e.g.:" % len(prom.splitlines()))
    for ln in sample:
        print("   ", ln)

    # a FIXED serial sweep through the live server: the responses are a
    # function of the served parameters and programs only, so cold and
    # warm replicas of one checkpoint give the same digest bit for bit
    h = hashlib.sha256()
    n_digest_reqs = 0
    step = max(1, args.max_batch_size // 2)
    for lo in range(0, min(256, len(Xte)), step):
        out = server.predict(Xte[lo:lo + step], timeout=300)
        h.update(np.ascontiguousarray(out).tobytes())
        n_digest_reqs += 1
    digest = h.hexdigest()
    if args.digest_out:
        with open(args.digest_out, "w") as f:
            f.write(digest)
    print("served-response digest: %s" % digest)

    server.shutdown(drain=True)
    wall = time.time() - t0

    s = pred.stats()
    lat = s["latency_ms"]
    print("served %d requests from %d clients in %.2fs (%.1f req/s)"
          % (s["completed"], args.clients, wall, s["completed"] / wall))
    print("launches %d  batch-fill %.2f  bucket hits %s"
          % (s["batches"], s["batch_fill"], s["bucket_hits"]))
    print("latency ms: p50 %.1f  p95 %.1f  p99 %.1f  max %.1f"
          % (lat["p50"], lat["p95"], lat["p99"], lat["max"]))
    print("compiles %d (all during warmup)  rejected %d  timeouts %d"
          % (s["compiles"], s["rejected"], s["timeouts"]))

    if args.slo_report:
        srep = slo.report()
        state = srep["state"]
        assert state["n_events"] >= s["completed"] > 0, (state, s)
        assert not srep["breach"], "smoke workload breached SLO: %r" % srep
        gauges = mx.telemetry.registry().snapshot()["gauges"]
        assert any(g.startswith("slo.serve_cifar10.") for g in gauges), \
            "slo.* gauge scope not populated"
        assert gauges["slo.serve_cifar10.breach"] == 0
        assert gauges[
            "slo.serve_cifar10.availability.budget_remaining"] == 1.0
        assert "mxtpu_slo_serve_cifar10_breach" in prom, \
            "slo gauges missing from the Prometheus scrape"
        traces = pred._stats.request_traces()
        assert traces, "no request traces recorded"
        ph = traces[-1]["phases"]
        assert ph["device_ms"] > 0 and traces[-1]["outcome"] == "ok"
        for obj in ("p99_ms", "error_rate", "availability"):
            print("slo %-12s burn fast %.3f / slow %.3f, budget %.3f"
                  % (obj, state[obj]["burn_rate_fast"],
                     state[obj]["burn_rate_slow"],
                     state[obj]["budget_remaining"]))
        print("slo report OK: %d events, no breach, %d traces"
              % (state["n_events"], len(traces)))

    assert not errs, errs[:3]
    assert s["compiles"] == expected_compiles, \
        "traffic triggered compiles beyond warmup: %d != %d" \
        % (s["compiles"], expected_compiles)
    total = args.clients * args.requests + n_digest_reqs
    assert s["completed"] + s["rejected"] + s["timeouts"] + \
        s["errors"] == total, (s, total)
    assert s["completed"] > 0, "no requests served"

    k = args.max_batch_size
    if args.cache_dir and not args.expect_warm:
        # the in-process second replica: a fresh Predictor warming from
        # the cache this run just filled loads every bucket and serves
        # the cold replica's rows
        warm = Predictor(mod, data_shapes=data_shapes,
                         max_batch_size=args.max_batch_size)
        traces1 = serving_cache.traces
        warm.warmup(cache_dir=args.cache_dir)
        wrep = warm.warmup_report()
        assert all(r["source"] == "deserialized"
                   for r in wrep.values()), wrep
        assert warm.stats()["compiles"] == 0
        assert serving_cache.traces == traces1
        assert np.array_equal(warm.predict(Xte[:k]), pred.predict(Xte[:k])), \
            "warm-replica rows differ from the cold replica"
        warm.release()
        print("second replica warm-started: %d buckets loaded, zero "
              "traces, bitwise-equal rows" % len(warm.buckets))
    print("serving demo OK: rows within %g of Module.predict, zero "
          "post-warmup compiles" % SERVE_REL_L2)
    result = {
        "source": "checkpoint" if committed else "trained",
        "train_steps": steps,
        "bn_fwd_launches": bn_kernels.bn_fwd.launches - bn0[0],
        "bn_bwd_launches": bn_kernels.bn_bwd.launches - bn0[1],
        "nvcc_builds": build.builds - builds0,
        "traces": serving_cache.traces - traces0,
        "warmup": {str(b): r for b, r in sorted(rep.items())},
        "compiles": s["compiles"], "warmup_compiles": warmup_compiles,
        "cache_hits": s["cache_hits"], "cache_misses": s["cache_misses"],
        "digest": digest, "completed": s["completed"],
        "req_per_s": s["completed"] / wall,
        "latency_ms": {p: lat[p] for p in ("p50", "p99")},
        "max_rel_l2": worst[0],
    }
    pred.release()
    print("SERVE_CIFAR10 " + json.dumps(result, sort_keys=True))
    return result


if __name__ == "__main__":
    main()
