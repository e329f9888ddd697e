"""Sort a digit sequence with a bidirectional LSTM: the port's twin of
``example/bi-lstm-sort/sort_lstm.py``.

    python -m mxnet_tpu_torch.examples.sort_lstm [--cpu]

The input is a sequence of random digits (``RandomState(0)``), the
target the same digits sorted; a ``BidirectionalCell`` of two
``LSTMCell``s (64 hidden, zero begin states from ``sym.zeros``) lets
every output position see the whole sequence. Adam (lr 0.01), Xavier,
then the JAX script's assert: per-position accuracy on the first 1,024
sequences above 0.85, through a second module bound for inference. It
trains on ``gpu(0)`` (or ``--gpus``/``--tpus``) unless ``--cpu`` is
given; ``main(argv)`` returns the accuracy.
"""
import argparse
import logging

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.common import device_context


def make_net(seq_len, vocab, num_hidden, batch_size):
    data = mx.sym.Variable("data")
    embed = mx.sym.Embedding(data, input_dim=vocab, output_dim=16,
                             name="embed")
    stack = mx.rnn.BidirectionalCell(
        mx.rnn.LSTMCell(num_hidden=num_hidden, prefix="l_"),
        mx.rnn.LSTMCell(num_hidden=num_hidden, prefix="r_"))
    # zero begin states of concrete shape keep the unrolled graph
    # shape-inferable from data and label alone (Module.fit needs that)
    begin = stack.begin_state(func=mx.sym.zeros,
                              shape=(batch_size, num_hidden))
    outputs, _ = stack.unroll(seq_len, inputs=embed, begin_state=begin,
                              merge_outputs=True, layout="NTC")
    pred = mx.sym.Reshape(outputs, shape=(-1, 2 * num_hidden))
    pred = mx.sym.FullyConnected(pred, num_hidden=vocab, name="fc")
    label = mx.sym.Reshape(mx.sym.Variable("softmax_label"), shape=(-1,))
    return mx.sym.SoftmaxOutput(pred, label=label, name="softmax")


def main(argv=None):
    parser = argparse.ArgumentParser(description="bi-LSTM sort")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--num-epoch", type=int, default=12)
    parser.add_argument("--seq-len", type=int, default=5)
    parser.add_argument("--vocab", type=int, default=10)
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card's id (one device)")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)
    mx.random.seed(0)      # the initializer and the shuffle

    rng = np.random.RandomState(0)
    n = 4096
    X = rng.randint(0, args.vocab, (n, args.seq_len)).astype(np.float32)
    Y = np.sort(X, axis=1)

    it = mx.io.NDArrayIter(X, Y, batch_size=args.batch_size, shuffle=True,
                           label_name="softmax_label")
    mod = mx.mod.Module(make_net(args.seq_len, args.vocab, 64,
                                 args.batch_size), context=ctx)
    mod.fit(it, num_epoch=args.num_epoch, optimizer="adam",
            optimizer_params={"learning_rate": 0.01},
            initializer=mx.initializer.Xavier())

    # exact-position accuracy through a module bound for inference
    mod2 = mx.mod.Module(make_net(args.seq_len, args.vocab, 64,
                                  args.batch_size), context=ctx)
    mod2.bind(data_shapes=[("data", (args.batch_size, args.seq_len))],
              label_shapes=[("softmax_label",
                             (args.batch_size, args.seq_len))],
              for_training=False)
    mod2.set_params(*mod.get_params())
    correct = total = 0
    for i in range(0, 1024, args.batch_size):
        xb = mx.nd.array(X[i:i + args.batch_size], ctx=mx.cpu())
        mod2.forward(mx.io.DataBatch(data=[xb], label=[]), is_train=False)
        pred = mod2.get_outputs()[0].asnumpy().argmax(axis=1)
        pred = pred.reshape(args.batch_size, args.seq_len)
        correct += int((pred == Y[i:i + args.batch_size]).sum())
        total += pred.size
    acc = correct / float(total)
    print("per-position sort accuracy: %.3f" % acc)
    if not acc > 0.85:
        raise AssertionError("bi-LSTM should learn to sort")
    return {"module": mod, "accuracy": acc}


if __name__ == "__main__":
    main()
