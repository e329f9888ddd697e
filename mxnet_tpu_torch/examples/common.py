"""What the example twins share: the device they train on, the
precision and grouped-step flags, and a per-epoch clock."""
import logging
import time

import torch

import mxnet_tpu_torch as mx


def device_context(args):
    """``--cpu``, else the one card named by ``--gpus``/``--tpus``
    (default 0). On the card, float32 stays float32 (TF32 off for
    convolutions and matrix products), as the JAX package's
    ``f32_precision`` asks of XLA."""
    if args.cpu:
        return mx.cpu()
    ids = [int(i) for i in (args.tpus or "0").split(",")]
    if len(ids) != 1:
        raise mx.MXNetError("one process trains on one device (got %s): "
                            "several devices in one process come with the "
                            "model-parallel half of the port (ROADMAP "
                            "A8b); data parallelism launches one process "
                            "per card (tools/launch.py, --kv-store "
                            "dist_sync)" % args.tpus)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return mx.gpu(ids[0])


def add_precision_args(parser):
    """``--precision``, ``--opt-state-dtype``, ``--remat`` and
    ``--batch-group``, as the JAX scripts take them."""
    parser.add_argument("--precision", default=None,
                        help="precision mode (mx.precision.MODES: f32, "
                             "bf16, bf16_opt, combined; int8_act and fp8 "
                             "with MXNET_PRECISION_EXPERIMENTAL=1)")
    parser.add_argument("--opt-state-dtype", default=None,
                        help="optimizer-state storage dtype (float32 or "
                             "bfloat16); with --remat an ad-hoc policy "
                             "when --precision is not given")
    parser.add_argument("--remat", default=None,
                        help="remat policy of the training step (none, "
                             "full, dots_saveable, offload_bn_stats)")
    parser.add_argument("--batch-group", type=int, default=None,
                        help="train K batches per grouped step (one copy "
                             "per input, K steps in one call); the "
                             "numbers equal per-batch training")


def precision_policy(parser, args):
    """The mode name of ``--precision``, or an ad-hoc PrecisionPolicy of
    ``--opt-state-dtype``/``--remat``, or None."""
    extra = args.opt_state_dtype or args.remat
    if args.precision is not None and extra:
        parser.error("--precision is a complete mode; do not combine it "
                     "with --opt-state-dtype/--remat")
    if extra:
        return mx.precision.PrecisionPolicy(
            opt_state_dtype=args.opt_state_dtype, remat=args.remat)
    return args.precision


def check_grouped(mod, batch_group):
    """With ``--batch-group`` K > 1 the grouped step must have run: a
    silent per-batch fallback would make the flag a no-op."""
    trained = mod._optimizer is not None and mod._optimizer.num_update > 0
    if batch_group and batch_group > 1 and trained and \
            not mod.grouped_train_engaged():
        raise mx.MXNetError("--batch-group %d requested but the grouped "
                            "step never ran (fit trained per batch)"
                            % batch_group)


class EpochClock(object):
    """Per-epoch step time and training metric of a ``fit``: pass
    ``batch_end`` as a batch-end callback and ``epoch_end`` as an
    epoch-end callback. The clock starts at the end of an epoch's first
    batch and stops at the epoch's end, each after ``sync()`` (the card's
    queue drained), so ``ms_per_step`` covers batches 2..n. With
    ``work(batch)`` (tokens of a batch, say) each row also has
    ``work_per_s`` over the same batches."""

    def __init__(self, sync=None, work=None):
        self._sync = sync or (lambda: None)
        self._work = work
        self._t0 = None
        self._batches = 0
        self._done = 0
        self._metric = None
        self.rows = []

    def batch_end(self, param):
        if param.nbatch == 0:
            self._sync()
            self._t0 = time.perf_counter()
            self._metric = param.eval_metric
            self._done = 0
        elif self._work is not None:
            self._done += self._work(param.locals["data_batch"])
        self._batches = param.nbatch + 1

    def epoch_end(self, epoch, symbol, arg_params, aux_params):
        self._sync()
        seconds = time.perf_counter() - self._t0
        steps = max(self._batches - 1, 1)
        row = {"epoch": epoch, "batches": self._batches,
               "ms_per_step": 1000.0 * seconds / steps,
               "metric": self._metric.get()[1]}
        if self._work is not None:
            row["work_per_s"] = self._done / max(seconds, 1e-9)
        self.rows.append(row)
        logging.info("Epoch[%d] %d steps, %.3f ms a step over steps 2-%d, "
                     "train %s=%f", epoch, self._batches, row["ms_per_step"],
                     self._batches, self._metric.get()[0], row["metric"])


def card_sync(ctx):
    """A function that waits for ``ctx``'s queue (a no-op on the CPU)."""
    if ctx.device_type == "cpu":
        return lambda: None
    return lambda: torch.cuda.synchronize(ctx.torch_device())


class StepTimer(object):
    """Wall time of a training loop, the card's queue drained at both
    ends: ``with StepTimer(ctx) as t: ...``, then set ``t.steps`` and
    read ``t.ms_per_step``."""

    def __init__(self, ctx):
        self._sync = card_sync(ctx)
        self.steps = 0
        self.seconds = 0.0

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.seconds += time.perf_counter() - self._t0

    @property
    def ms_per_step(self):
        return 1000.0 * self.seconds / max(self.steps, 1)
