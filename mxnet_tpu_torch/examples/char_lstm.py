"""The char-LSTM language model through ``Module.fit``: the port's twin
of ``example/rnn/char_lstm.py``.

    python -m mxnet_tpu_torch.examples.char_lstm [--cpu]

Trains ``models.lstm.get_symbol`` (``FusedRNNCell``: one ``RNN`` node,
cuDNN's RNN on the card) on a text file when ``--data`` names one, else
on the JAX script's synthetic periodic text, with its defaults: sequence
32, 256 hidden, 64 embedding, 2 layers, batch 32, 4 epochs, SGD (lr 0.1,
momentum 0.9, gradient clip 5) and the perplexity metric. Unlike the JAX
script, which trains on the CPU unless a device is named, the twin
trains on ``gpu(0)`` (or ``--gpus``/``--tpus``) unless ``--cpu`` is
given. ``main(argv)`` returns a dict: the module, the vocabulary size,
the steps, and per epoch the training perplexity, ms a step and tokens
a second (host clock over batches 2..n, the queue drained at both
ends), which it logs in place of the JAX script's Speedometer lines (a
Speedometer resets the metric that the epoch's perplexity is read
from).
"""
import argparse
import logging
import os

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.common import (EpochClock, card_sync,
                                             device_context)
from mxnet_tpu_torch.models import lstm as lstm_model

SYNTHETIC_TEXT = "hello tpu world. " * 4000


def load_data(path, seq_len):
    """(X, Y, vocab): the text cut into ``seq_len`` windows, Y the next
    characters."""
    if path and os.path.exists(path):
        with open(path) as f:
            text = f.read()
    else:
        logging.warning("no text file; using synthetic periodic text")
        text = SYNTHETIC_TEXT
    vocab = {c: i for i, c in enumerate(sorted(set(text)))}
    arr = np.array([vocab[c] for c in text], dtype=np.float32)
    n = (len(arr) - 1) // seq_len
    X = arr[:n * seq_len].reshape(n, seq_len)
    Y = arr[1:n * seq_len + 1].reshape(n, seq_len)
    return X, Y, vocab


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", default=None)
    parser.add_argument("--seq-len", type=int, default=32)
    parser.add_argument("--num-hidden", type=int, default=256)
    parser.add_argument("--num-embed", type=int, default=64)
    parser.add_argument("--num-layers", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-epochs", "--num-epoch", dest="num_epochs",
                        type=int, default=4)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card's id (one device)")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)
    mx.random.seed(0)      # the initializer and the shuffle

    X, Y, vocab = load_data(args.data, args.seq_len)
    net = lstm_model.get_symbol(args.seq_len, len(vocab),
                                num_hidden=args.num_hidden,
                                num_embed=args.num_embed,
                                num_layers=args.num_layers)
    it = mx.io.NDArrayIter(X, Y, batch_size=args.batch_size, shuffle=True,
                           last_batch_handle="discard")
    clock = EpochClock(card_sync(ctx),
                       work=lambda b: args.batch_size * args.seq_len)
    mod = mx.mod.Module(net, context=ctx)
    mod.fit(it, num_epoch=args.num_epochs,
            eval_metric=mx.metric.Perplexity(ignore_label=None),
            optimizer_params={"learning_rate": args.lr, "momentum": 0.9,
                              "clip_gradient": 5.0},
            batch_end_callback=clock.batch_end,
            epoch_end_callback=clock.epoch_end)
    ppl = [r["metric"] for r in clock.rows]
    steps = sum(r["batches"] for r in clock.rows)
    print("char_lstm: perplexity by epoch %s, %d steps"
          % (", ".join("%.3f" % p for p in ppl), steps))
    return {"module": mod, "vocab": len(vocab), "steps": steps,
            "batch_size": args.batch_size, "seq_len": args.seq_len,
            "epochs": clock.rows, "perplexity": ppl}


if __name__ == "__main__":
    main()
