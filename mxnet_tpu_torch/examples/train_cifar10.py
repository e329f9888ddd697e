"""Train CIFAR-10: the port's twin of ``example/image-classification/
train_cifar10.py``.

    python -m mxnet_tpu_torch.examples.train_cifar10 [--network resnet-20]
        [--cpu] [--seed 7] [--checkpoint-dir D [--resume]
        [--exit-after-epoch 1]] [--serve-smoke] [--precision bf16]
        [--opt-state-dtype bfloat16] [--remat dots_saveable]
        [--batch-group 4] [--prefetch-device 2] [--device-augment
        [--augment-placement host] [--cache-dataset]] [--guardian]
        [--fault-plan PLAN] [--telemetry-jsonl F] [--telemetry-port P]
        [--program-report F] [--health-report F] ...

Uses a real CIFAR-10 python-pickle batch directory when ``--data-dir`` has
one, else the JAX script's synthetic CIFAR-shaped data (the same seed, so
the same values). Images are center-cropped to 28x28, as in the JAX
script. ``--params-digest-out`` writes the same sha256 over the final
parameter values as the JAX script.

The robustness and telemetry flags are the JAX script's: ``--fault-plan``
arms a seeded ``faults.FaultPlan`` and, after training, requires every
deterministic rule to have fired and logs the incident transcript;
``--guardian`` arms ``guardian.Guardian`` on the ``--checkpoint-dir``
manager (else a run-local directory) and, when the plan holds a
numeric rule (``module.step``, ``guardian.sdc``), requires a rollback;
``--telemetry-jsonl``/``--telemetry-port`` enable telemetry (a step
line per train step, a Prometheus endpoint) and require zero new
programs after the warmup boundary; ``--program-report`` writes the
program inventory and requires a counted train step, the optimizer
account and (past one epoch) the live roofline's gauges;
``--health-report`` writes the regression watchdog's report and requires
it armed, calibrated (past one epoch) and healthy.

The data flags are the JAX script's: ``--prefetch-device N`` trains
through ``data.DeviceLoader`` (a ring of N batches staged on the card);
``--device-augment`` feeds uint8 NHWC wire batches with a pad-2 random
crop and mirror (``data.DeviceAugment``, draws keyed on (seed, epoch,
batch)) run on the card at staging, or with ``--augment-placement host``
the same draws through ``apply_host`` on the host; ``--cache-dataset``
(implies the u8 pipeline) holds the decoded epoch on the card
(``data.CachedDataset``). ``--prefetch-device`` and ``--cache-dataset``
train to the same parameters as the run without them, and the two
augment placements to the same parameters as each other, bit for bit.

Differences from the JAX script: the twin trains on ``gpu(0)`` (or
``--gpus``/``--tpus``, one card) unless ``--cpu`` is given, where the JAX
script defaults to the CPU; ``--seed`` also makes cuDNN pick deterministic
algorithms, so that a preempted and resumed run retraces the
uninterrupted one bit for bit (and the guardian's probe can compare two
runs); the checks after training raise ``MXNetError`` where the JAX
script asserts; and ``--serve-smoke`` serves float32 rows, so it does not combine with the u8
pipeline. ``main(argv)`` returns the run's results.
"""
import argparse
import hashlib
import logging
import os
import pickle
import threading
import time

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import models
from mxnet_tpu_torch.examples.common import (add_precision_args,
                                             check_grouped, device_context,
                                             precision_policy)

# Served rows against Module.predict, as relative L2 per request. The JAX
# script holds them bit for bit; here Module.predict runs at 128 rows and
# the buckets at 2-32, and PyTorch's GEMM and convolution libraries may
# take another algorithm at another batch size, on the CPU as on the card
# (tools/batch_parity.py finds the first node that differs)
SERVE_REL_L2 = 1e-5

# flag -> the slice of the port that brings its module (none left)
LATER_SLICES = {}


def load_cifar_dir(data_dir):
    """cifar-10-batches-py layout (data_batch_1..5 + test_batch)."""
    def _load(names):
        xs, ys = [], []
        for n in names:
            with open(os.path.join(data_dir, n), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"].reshape(-1, 3, 32, 32)[:, :, 2:30, 2:30])
            ys.append(np.array(d[b"labels"]))
        return (np.concatenate(xs).astype(np.float32) / 255.0,
                np.concatenate(ys).astype(np.float32))
    train = _load(["data_batch_%d" % i for i in range(1, 6)])
    test = _load(["test_batch"])
    return train, test


def synthetic_cifar(rng, n=4096):
    protos = rng.rand(10, 3, 7, 7).astype(np.float32)
    y = rng.randint(0, 10, n)
    up = np.kron(protos[y], np.ones((1, 1, 4, 4), np.float32))
    X = up + 0.25 * rng.rand(n, 3, 28, 28).astype(np.float32)
    return X, y.astype(np.float32)


def params_digest(mod):
    """sha256 over every final param/aux array's name and bytes (sorted
    by name): the JAX script's bit-identity pin."""
    h = hashlib.sha256()
    arg_params, aux_params = mod.get_params()
    for params in (arg_params, aux_params or {}):
        for name in sorted(params):
            h.update(name.encode())
            h.update(np.ascontiguousarray(params[name].asnumpy()).tobytes())
    return h.hexdigest()


def serve_smoke(mod, val, Xte, batch_size):
    """The serving gate: ``Predictor`` + ``DynamicBatcher`` over the
    trained module, 8 client threads of mixed-size requests; every
    client's rows must equal ``Module.predict``'s within
    ``SERVE_REL_L2``, and traffic after
    ``warmup()`` must add no compile. Returns the predictor's stats with
    the largest relative L2 error and the count of requests served bit
    for bit."""
    from mxnet_tpu_torch.serving import DynamicBatcher, Predictor

    ref = mod.predict(val).asnumpy()
    pred = Predictor(mod, max_batch_size=min(batch_size, 32))
    pred.warmup()
    frozen = pred.stats()["compiles"]
    srv = DynamicBatcher(pred, max_queue=256, max_wait_ms=2)
    errs, rel_l2 = [], []

    def client(i):
        rng = np.random.RandomState(100 + i)
        for _ in range(8):
            n = int(rng.randint(1, 9))
            lo = int(rng.randint(0, len(ref) - n))
            try:
                out = srv.predict(Xte[lo:lo + n], timeout=300)
            except Exception as e:  # noqa: BLE001 - the gate reports it
                errs.append("client %d: %r" % (i, e))
                return
            want = ref[lo:lo + n]
            rel = float(np.linalg.norm(out - want) / np.linalg.norm(want))
            rel_l2.append(rel)
            if rel > SERVE_REL_L2:
                errs.append("client %d: served rows != Module.predict "
                            "(relative L2 %.3g)" % (i, rel))
                return

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    srv.shutdown(drain=True)
    stats = pred.stats()
    if errs or any(t.is_alive() for t in threads):
        raise mx.MXNetError("serving smoke failed: %r" % (errs[:3],))
    if stats["completed"] != 8 * 8:
        raise mx.MXNetError("serving smoke verified %d of %d requests"
                            % (stats["completed"], 8 * 8))
    if stats["compiles"] != frozen:
        raise mx.MXNetError("serving compiled under traffic: %d compiles "
                            "after warmup's %d"
                            % (stats["compiles"], frozen))
    stats["max_rel_l2"] = max(rel_l2)
    stats["bitwise_requests"] = sum(r == 0.0 for r in rel_l2)
    logging.info("serving smoke: %d requests ok (%d bit for bit, max "
                 "relative L2 %.3g), buckets %s, fill %.2f, p50 %.1f ms, "
                 "compiles frozen at %d", stats["completed"],
                 stats["bitwise_requests"], stats["max_rel_l2"],
                 pred.buckets, stats["batch_fill"],
                 stats["latency_ms"]["p50"], frozen)
    return stats


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="train cifar10")
    parser.add_argument("--network", default="resnet-20",
                        help="model zoo name (resnet-N, mlp, lenet)")
    parser.add_argument("--data-dir", default="cifar10/")
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card's id (one device)")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--num-epochs", type=int, default=10)
    parser.add_argument("--kv-store", default="local")
    parser.add_argument("--model-prefix", default=None)
    parser.add_argument("--min-accuracy", type=float, default=None,
                        help="fail if the final validation accuracy lands "
                             "below this (the convergence gate)")
    parser.add_argument("--checkpoint-dir", default=None,
                        help="commit one atomic step entry per epoch into "
                             "this directory (checkpoint.CheckpointManager)")
    parser.add_argument("--resume", action="store_true",
                        help="resume params/optimizer/RNG from the latest "
                             "committed step in --checkpoint-dir (a cold "
                             "start when the directory is empty)")
    parser.add_argument("--seed", type=int, default=None,
                        help="seed numpy and mx.random (fixes the shuffle "
                             "order) and make cuDNN deterministic, so a "
                             "resumed run retraces the uninterrupted one")
    parser.add_argument("--exit-after-epoch", type=int, default=None,
                        help="exit with code 66 once this many epochs are "
                             "committed (a simulated preemption)")
    parser.add_argument("--acc-out", default=None,
                        help="write the final validation accuracy here")
    parser.add_argument("--params-digest-out", default=None,
                        help="write a sha256 over the final params + aux "
                             "arrays here")
    parser.add_argument("--serve-smoke", action="store_true",
                        help="after training, serve the model through "
                             "Predictor + DynamicBatcher under concurrent "
                             "clients and hold the rows to Module.predict "
                             "(within SERVE_REL_L2)")
    add_precision_args(parser)
    parser.add_argument("--prefetch-device", type=int, default=None,
                        help="train through data.DeviceLoader: a ring of "
                             "N batches staged on the card while the step "
                             "runs; the parameters equal the plain path's "
                             "bit for bit")
    parser.add_argument("--device-augment", action="store_true",
                        help="feed uint8 NHWC wire batches (4x fewer bytes "
                             "than float32 NCHW); the pad-2 random crop, "
                             "mirror and normalize run on the card at "
                             "staging (data.DeviceAugment)")
    parser.add_argument("--augment-placement", default="device",
                        choices=["device", "host"],
                        help="where the augment runs: 'device' (the u8 "
                             "wire path) or 'host' (apply_host on the same "
                             "draws); both train to the same parameters")
    parser.add_argument("--cache-dataset", action="store_true",
                        help="hold the decoded u8 epoch on the card "
                             "(data.CachedDataset): later epochs are a "
                             "gather there; implies the u8 pipeline")
    parser.add_argument("--telemetry-jsonl", default=None,
                        help="enable telemetry and stream one JSON line "
                             "per train step (and per-epoch metrics "
                             "snapshots) into this file; training stays "
                             "bit for bit the telemetry-off run's")
    parser.add_argument("--telemetry-port", type=int, default=None,
                        help="serve the telemetry registry as a "
                             "Prometheus /metrics endpoint on this port "
                             "for the run (0 picks a free port)")
    parser.add_argument("--program-report", default=None,
                        help="enable telemetry, write the program "
                             "inventory (counted FLOPs and bytes per "
                             "program) here after training, and require "
                             "a counted train step, the optimizer "
                             "account and the live roofline's gauges")
    parser.add_argument("--health-report", default=None,
                        help="enable telemetry's regression watchdog and "
                             "write its report here after training; "
                             "require it armed, calibrated and healthy")
    parser.add_argument("--fault-plan", default=None,
                        help="arm a seeded faults.FaultPlan (grammar "
                             "string, JSON list or @file); after training "
                             "require every deterministic rule to have "
                             "fired and log the incident transcript")
    parser.add_argument("--guardian", action="store_true",
                        help="arm the training guardian (numeric-health "
                             "word on the step, rollback-and-skip) on the "
                             "--checkpoint-dir manager, else a run-local "
                             "directory; with numeric fault rules, "
                             "require a rollback")
    args = parser.parse_args(argv)
    args.precision_policy = precision_policy(parser, args)
    if args.exit_after_epoch is not None and args.checkpoint_dir is None:
        parser.error("--exit-after-epoch needs --checkpoint-dir (it "
                     "simulates preemption after the commit)")
    args.u8_pipeline = args.device_augment or args.cache_dataset
    if args.u8_pipeline and args.serve_smoke:
        parser.error("--serve-smoke serves float32 rows; it does not "
                     "combine with --device-augment/--cache-dataset")
    return args


def to_u8(x):
    """float32 NCHW in [0, ~1] -> the uint8 NHWC wire layout."""
    return (np.clip(x, 0.0, 1.0) * 255.0).round() \
        .astype(np.uint8).transpose(0, 2, 3, 1)


def u8_iters(args, mod, Xtr, ytr, Xte, yte):
    """The u8 pipeline's train and eval iterators (the JAX script's): a
    pad-2 random crop and mirror, normalized back to the [0, 1] range the
    plain path trains on (scale 1/255); draws keyed on (seed, epoch,
    batch), so both placements see the same stream."""
    from mxnet_tpu_torch.data import (CachedDataset, DeviceAugment,
                                      DeviceAugmentIter)
    spec = DeviceAugment(shape=(3, 28, 28), rand_crop=True,
                         rand_mirror=True, pad=2, mean=0.0, std=1.0,
                         scale=1.0 / 255.0, seed=args.seed or 0)
    train_src = mx.io.NDArrayIter(to_u8(Xtr), ytr,
                                  batch_size=args.batch_size, shuffle=True)
    if args.cache_dataset:
        train = CachedDataset(train_src, augment=spec, module=mod,
                              augment_placement=args.augment_placement)
    else:
        train = DeviceAugmentIter(train_src, spec,
                                  placement=args.augment_placement)
    # the eval variant: both placements score the same center crop
    val = DeviceAugmentIter(
        mx.io.NDArrayIter(to_u8(Xte), yte, batch_size=args.batch_size),
        spec, placement=args.augment_placement, train=False)
    return train, val


def check_u8_pipeline(args, mod, train):
    """The u8 flags must have done what they say: the augment bound on
    the card (device placement) and the cache built."""
    trained = mod._optimizer is not None and mod._optimizer.num_update > 0
    if not (args.u8_pipeline and trained):
        return
    if args.augment_placement == "device":
        if not getattr(mod._exec_group, "_device_augment", None) or \
                not any(np.dtype(getattr(d, "dtype", np.float32)) ==
                        np.uint8 for d in train.provide_data):
            raise mx.MXNetError("--device-augment requested but the bound "
                                "group stages no uint8 wire input")
    if args.cache_dataset and args.num_epochs > 1:
        info = train.cache_info()
        if info["built_epoch"] is None:
            raise mx.MXNetError("--cache-dataset ran %d epochs but never "
                                "built the cache: %r"
                                % (args.num_epochs, info))
        logging.info("dataset cache: %s on %s, %d rows, %.1f MB, built "
                     "after epoch %d", info["placement"], info["device"],
                     info["rows"], info["bytes"] / (1 << 20),
                     info["built_epoch"])


def check_telemetry(args):
    """The telemetry flags' checks (the JAX script's asserts): no new
    program after the warmup boundary, the program report and the health
    report where asked. Returns what they read."""
    watch = mx.telemetry.compile_watch()
    if watch.post_warmup_count:
        raise mx.MXNetError(
            "the train loop ran %d new program(s) after the warmup "
            "boundary: %r" % (watch.post_warmup_count, watch.events()))
    tl = mx.telemetry.timeline()
    logging.info("telemetry: %d step records; slowest: %r", len(tl),
                 tl.slowest(1))
    mx.telemetry.flush_metrics("train_cifar10 end")
    out = {"step_records": len(tl)}
    if args.program_report:
        report = mx.telemetry.dump_programs(args.program_report)
        kinds = {p["kind"] for p in report["programs"]
                 if p.get("flops") and p.get("bytes_accessed")}
        if not kinds & {"train_step", "train_step_grouped"}:
            raise mx.MXNetError("program report lacks a counted train "
                                "step with FLOPs and bytes: %r"
                                % sorted(kinds))
        if "optimizer_update" not in kinds:
            raise mx.MXNetError("program report lacks the optimizer-"
                                "update account: %r" % sorted(kinds))
        gauges = mx.telemetry.registry().snapshot()["gauges"]
        if args.num_epochs > 1:
            # the live roofline resolves at the end of the first epoch
            missing = [g for g in ("train.mfu", "train.achieved_tflops",
                                   "train.achieved_hbm_gbps",
                                   "train.bound_by") if g not in gauges]
            if missing:
                raise mx.MXNetError("roofline gauges missing: %r"
                                    % missing)
        logging.info("program report: %d programs -> %s",
                     report["n_programs"], args.program_report)
        out["programs"] = report
    if args.health_report:
        rep = mx.telemetry.health_report()
        if not rep["armed"]:
            raise mx.MXNetError("the health watchdog never armed")
        if args.num_epochs > 1 and not rep["calibrated"]:
            raise mx.MXNetError("the health watchdog never calibrated: %r"
                                % (rep,))
        if not rep["healthy"]:
            raise mx.MXNetError("a clean run raised health incidents: %r"
                                % (rep["incidents"],))
        mx.telemetry.atomic_json_dump(args.health_report, rep)
        logging.info("health report: armed=%s healthy=%s polls=%d -> %s",
                     rep["armed"], rep["healthy"], rep["polls"],
                     args.health_report)
        out["health"] = rep
    return out


def check_guardian(guard, fault_plan):
    """A planned numeric fault must have been healed by a rollback (and
    training reached its end, which returning here proves)."""
    st = guard.stats()
    logging.info("guardian: rollbacks=%d skipped=%r sdc_checks=%d "
                 "sdc_mismatches=%d", st["rollbacks"], st["skipped"],
                 st["sdc_checks"], st["sdc_mismatches"])
    numeric = [r.describe() for r in (fault_plan.rules if fault_plan
                                      else [])
               if r.site in ("module.step", "guardian.sdc")]
    if numeric and st["rollbacks"] < 1:
        raise mx.MXNetError("numeric fault(s) %r were planned but the "
                            "guardian never rolled back" % (numeric,))
    return st


def check_fault_plan(fault_plan):
    """Every deterministic rule must have fired (a plan that missed its
    target coordinates is a failure, not a pass); logs the transcript and
    disarms. Returns the incidents."""
    unfired = fault_plan.unfired()
    if unfired:
        raise mx.MXNetError("fault plan rules never fired: %r" % (unfired,))
    incidents = fault_plan.incidents()
    logging.info("fault plan: %d incident(s) injected and recovered: %s",
                 len(incidents), ", ".join("%s(%s)" % (i["site"], i["kind"])
                                           for i in incidents))
    mx.faults.disarm()
    return incidents


def main(argv=None):
    """Train; returns a dict of the results (``score``, ``accuracy``,
    ``params_digest`` when asked, ``fit_s``, ``fit_img_per_s`` over each
    epoch's batches after its first, ``serving`` stats, ``module``,
    ``manager``; with the robustness and telemetry flags ``guardian``
    stats, the plan's ``incidents``, ``step_records``, ``programs``,
    ``health``)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)
    telemetry_on = (args.telemetry_jsonl or args.telemetry_port is not None
                    or args.program_report or args.health_report)
    if telemetry_on:
        server = mx.telemetry.enable(jsonl=args.telemetry_jsonl,
                                     port=args.telemetry_port)
        if server is not None:
            logging.info("telemetry: Prometheus endpoint at %s", server.url)
    if args.seed is not None:
        np.random.seed(args.seed)
        mx.random.seed(args.seed)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    fault_plan = None
    if args.fault_plan:
        fault_plan = mx.faults.arm(args.fault_plan, seed=args.seed or 0)
        logging.info("fault plan armed (seed %d): %s", fault_plan.seed,
                     "; ".join(r.describe() for r in fault_plan.rules))

    batch_dir = os.path.join(args.data_dir, "cifar-10-batches-py")
    if os.path.exists(batch_dir):
        (Xtr, ytr), (Xte, yte) = load_cifar_dir(batch_dir)
    else:
        logging.warning("CIFAR batches not found in %s; synthetic data",
                        args.data_dir)
        rng = np.random.RandomState(0)
        Xtr, ytr = synthetic_cifar(rng)
        Xte, yte = Xtr[:512], ytr[:512]

    net = models.get_symbol(args.network, num_classes=10,
                            image_shape=(3, 28, 28))
    mod = mx.mod.Module(net, context=ctx, precision=args.precision_policy)
    if args.precision_policy is not None:
        logging.info("precision mode: %s (%r)", mod.precision_mode,
                     mod._precision.describe())
    if args.u8_pipeline:
        train, val = u8_iters(args, mod, Xtr, ytr, Xte, yte)
    else:
        train = mx.io.NDArrayIter(Xtr, ytr, batch_size=args.batch_size,
                                  shuffle=True)
        val = mx.io.NDArrayIter(Xte, yte, batch_size=args.batch_size)

    callbacks = []
    if args.model_prefix:
        callbacks.append(mx.callback.do_checkpoint(args.model_prefix))
    manager = None
    if args.checkpoint_dir:
        manager = mx.checkpoint.CheckpointManager(args.checkpoint_dir,
                                                  keep=3)
        callbacks.append(mx.callback.module_checkpoint(
            mod, save_optimizer_states=True, manager=manager))
    if args.exit_after_epoch is not None:
        def _preempt(iter_no, sym=None, arg=None, aux=None):
            if iter_no + 1 >= args.exit_after_epoch:
                manager.wait_until_finished()
                logging.info("simulated preemption after epoch %d", iter_no)
                os._exit(66)

        callbacks.append(_preempt)

    guard = None
    if args.guardian:
        import tempfile
        guard = mx.guardian.Guardian(
            manager if manager is not None
            else tempfile.mkdtemp(prefix="cifar_guardian_"))
        logging.info("guardian armed: window=%d threshold=%g "
                     "max_rollbacks=%d sdc_period=%d", guard.spike_window,
                     guard.spike_threshold, guard.max_rollbacks,
                     guard.sdc_probe_period)
    stamps = {}   # epoch -> batch-end host times

    def _stamp(param):
        stamps.setdefault(param.epoch, []).append(time.perf_counter())

    t0 = time.perf_counter()
    mod.fit(train, eval_data=val, num_epoch=args.num_epochs,
            kvstore=args.kv_store,
            initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
            optimizer_params={"learning_rate": args.lr, "momentum": 0.9,
                              "wd": 1e-4},
            batch_end_callback=[mx.callback.Speedometer(args.batch_size, 20),
                                _stamp],
            epoch_end_callback=callbacks or None,
            resume_from=manager if args.resume else None,
            batch_group=args.batch_group,
            prefetch_to_device=args.prefetch_device, guardian=guard)
    if manager is not None:
        manager.wait_until_finished()
    result = {"module": mod, "manager": manager}
    if telemetry_on:
        result.update(check_telemetry(args))
    if guard is not None:
        result["guardian"] = check_guardian(guard, fault_plan)
    if fault_plan is not None:
        result["incidents"] = check_fault_plan(fault_plan)
    check_grouped(mod, args.batch_group)
    check_u8_pipeline(args, mod, train)
    result["fit_s"] = time.perf_counter() - t0
    span = sum(t[-1] - t[0] for t in stamps.values() if len(t) > 1)
    if span > 0:
        result["fit_img_per_s"] = sum(
            len(t) - 1 for t in stamps.values()) * args.batch_size / span
    if args.params_digest_out:
        # before scoring: the gate pins the trained state itself
        result["params_digest"] = params_digest(mod)
        with open(args.params_digest_out, "w") as f:
            f.write(result["params_digest"] + "\n")
        logging.info("params digest: %s", result["params_digest"])
    score = mod.score(val, "acc")
    print("final validation:", score)
    result["score"] = score
    result["accuracy"] = dict(score)["accuracy"]
    if args.serve_smoke:
        result["serving"] = serve_smoke(mod, val, Xte, args.batch_size)
    if args.acc_out:
        with open(args.acc_out, "w") as f:
            f.write("%.6f\n" % result["accuracy"])
    if args.min_accuracy is not None and \
            result["accuracy"] < args.min_accuracy:
        raise mx.MXNetError("convergence regression: accuracy %.3f < "
                            "required %.3f" % (result["accuracy"],
                                               args.min_accuracy))
    return result


if __name__ == "__main__":
    main()
