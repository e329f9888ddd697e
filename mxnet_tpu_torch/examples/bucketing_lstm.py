"""A bucketed LSTM language model through ``BucketingModule`` and
``BucketSentenceIter``: the port's twin of
``example/rnn/bucketing_lstm.py``.

    python -m mxnet_tpu_torch.examples.bucketing_lstm [--cpu]

With its defaults it is the JAX script: 800 sentences of 5-29 tokens
drawn uniformly from a vocabulary of 50 (``RandomState(0)``), buckets
10/20/30, batch 16, one ``FusedRNNCell`` LSTM layer of 128 (embedding
32), SGD (lr 0.05, gradient clip 5), 2 epochs, perplexity ignoring the
pad id 0. Beyond the JAX script's flags, ``--vocab-size``,
``--sentences``, ``--buckets`` and ``--zipf`` size the data, so that the
widths of MXNet 0.9.5's ``example/rnn/lstm_bucketing.py`` run too (2
layers, 200 hidden, 200 embedding, batch 32, buckets 10-60, a
10,000-word vocabulary): ``--zipf a`` draws tokens with probability
proportional to 1/rank^a, a learnable unigram distribution, instead of
uniformly. The twin trains on ``gpu(0)`` (or ``--gpus``/``--tpus``)
unless ``--cpu`` is given. ``main(argv)`` returns a dict: the module,
the steps, per epoch the training perplexity, ms a step and positions
(batch × bucket length) a second, per bucket the steps and ms a step,
and the bucket modules bound; the clock's lines replace the JAX script's
Speedometer (which resets the metric the epoch's perplexity is read
from).
"""
import argparse
import logging
import random
import time

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import rnn
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch.examples.common import (EpochClock, card_sync,
                                             device_context)


def make_sentences(args):
    """The sentences, from ``RandomState(args.seed)``: the JAX script's
    uniform draw, or ranks under a Zipf law with ``--zipf``."""
    rng = np.random.RandomState(args.seed)
    top = max(args.buckets)
    if not args.zipf:
        return [list(rng.randint(1, args.vocab_size, rng.randint(5, top)))
                for _ in range(args.sentences)]
    ranks = np.arange(1, args.vocab_size, dtype=np.float64)
    p = ranks ** -args.zipf
    p /= p.sum()
    return [list(rng.choice(ranks.size, rng.randint(5, top), p=p) + 1)
            for _ in range(args.sentences)]


class BucketTimes(object):
    """Steps and host seconds a batch by bucket (the queue drained at
    each batch's end)."""

    def __init__(self, mod, sync):
        self._mod = mod
        self._sync = sync
        self._last = None
        self.by_bucket = {}

    def batch_end(self, param):
        self._sync()
        now = time.perf_counter()
        if param.nbatch > 0 and self._last is not None:
            key = self._mod._curr_bucket_key
            row = self.by_bucket.setdefault(key, [0, 0.0])
            row[0] += 1
            row[1] += now - self._last
        self._last = now


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-hidden", type=int, default=128)
    parser.add_argument("--num-embed", type=int, default=32)
    parser.add_argument("--num-layers", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--num-epochs", type=int, default=2)
    parser.add_argument("--vocab-size", type=int, default=50)
    parser.add_argument("--sentences", type=int, default=800)
    parser.add_argument("--buckets", default="10,20,30",
                        help="comma-separated bucket lengths")
    parser.add_argument("--zipf", type=float, default=0.0,
                        help="draw tokens by a Zipf law of this exponent "
                        "(0: uniformly, as the JAX script)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seeds the sentences (RandomState), the "
                        "initializer and the shuffles")
    parser.add_argument("--per-bucket-times", action="store_true",
                        help="drain the queue after every batch and time "
                        "each bucket's steps")
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card's id (one device)")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    args = parser.parse_args(argv)
    args.buckets = [int(b) for b in args.buckets.split(",")]
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)

    sentences = make_sentences(args)
    # the iterator shuffles its batches with Python's generator and its
    # rows with numpy's (mx.random.seed seeds numpy's)
    random.seed(args.seed)
    mx.random.seed(args.seed)
    it = rnn.BucketSentenceIter(sentences, args.batch_size,
                                buckets=args.buckets, invalid_label=0)
    vocab_size = args.vocab_size

    def sym_gen(seq_len):
        cell = rnn.FusedRNNCell(args.num_hidden, num_layers=args.num_layers,
                                mode="lstm", prefix="lstm_")
        data = sym.Variable("data")
        embed = sym.Embedding(data, input_dim=vocab_size,
                              output_dim=args.num_embed, name="embed")
        output, _ = cell.unroll(seq_len, inputs=embed, layout="NTC",
                                merge_outputs=True)
        pred = sym.Reshape(output, shape=(-1, args.num_hidden))
        pred = sym.FullyConnected(pred, num_hidden=vocab_size, name="pred")
        label = sym.Reshape(sym.Variable("softmax_label"), shape=(-1,))
        pred = sym.SoftmaxOutput(pred, label, name="softmax")
        return pred, ("data",), ("softmax_label",)

    mod = mx.mod.BucketingModule(sym_gen,
                                 default_bucket_key=it.default_bucket_key,
                                 context=ctx)
    sync = card_sync(ctx)
    # positions a batch: batch × bucket length, padding included
    clock = EpochClock(sync, work=lambda b: args.batch_size * b.bucket_key)
    callbacks = [clock.batch_end]
    times = BucketTimes(mod, sync) if args.per_bucket_times else None
    if times is not None:
        callbacks.append(times.batch_end)
    mod.fit(it, num_epoch=args.num_epochs,
            eval_metric=mx.metric.Perplexity(ignore_label=0),
            optimizer_params={"learning_rate": 0.05,
                              "clip_gradient": 5.0},
            batch_end_callback=callbacks, epoch_end_callback=clock.epoch_end)
    ppl = [r["metric"] for r in clock.rows]
    steps = sum(r["batches"] for r in clock.rows)
    print("bucketing_lstm: perplexity by epoch %s, %d steps over buckets %s"
          % (", ".join("%.3f" % p for p in ppl), steps,
             sorted(mod.buckets)))
    return {"module": mod, "steps": steps, "epochs": clock.rows,
            "perplexity": ppl, "buckets_bound": sorted(mod.buckets),
            "bucket_times": None if times is None else {
                k: {"steps": v[0], "ms_per_step": 1000.0 * v[1] / v[0]}
                for k, v in sorted(times.by_bucket.items())},
            "batch_size": args.batch_size}


if __name__ == "__main__":
    main()
