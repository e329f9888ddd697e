"""CTC sequence recognition: the port's twin of
``example/warpctc/ctc_train.py``.

    python -m mxnet_tpu_torch.examples.ctc_train [--cpu]

The JAX script's task and net: an LSTM (``mx.rnn.LSTMCell`` unrolled
over 12 frames) reads noisy glyph frames, and ``CTCLoss`` aligns the
unsegmented frame stream to a 4-digit label string, with no per-frame
labels; decoding is best path (collapse repeats, drop blanks). The data
is its synthetic OCR-like corpus (2,048 samples, ``RandomState(0)``),
Adam at lr 0.005 for 15 epochs. The JAX script's assert holds the
exact-sequence accuracy above 0.8. It trains on ``gpu(0)`` (or
``--gpus``/``--tpus``) unless ``--cpu`` is given; ``main(argv)`` returns
the accuracy, the losses by epoch, the module and the ms a step.
"""
import argparse
import logging

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.common import StepTimer, device_context


def make_net(seq_len, num_hidden, num_classes, batch_size):
    """num_classes includes the blank at index 0 (CTCLoss blank_label=
    'first' convention: labels are 1-based)."""
    data = mx.sym.Variable("data")  # (N, T, F)
    cell = mx.rnn.LSTMCell(num_hidden=num_hidden, prefix="l_")
    begin = cell.begin_state(func=mx.sym.zeros,
                             shape=(batch_size, num_hidden))
    outputs, _ = cell.unroll(seq_len, inputs=data, begin_state=begin,
                             merge_outputs=True, layout="NTC")
    pred = mx.sym.Reshape(outputs, shape=(-1, num_hidden))
    pred = mx.sym.FullyConnected(pred, num_hidden=num_classes,
                                 name="fc")
    pred = mx.sym.Reshape(pred, shape=(batch_size, seq_len,
                                       num_classes))
    label = mx.sym.Variable("label")
    loss = mx.sym.CTCLoss(mx.sym.transpose(pred, axes=(1, 0, 2)), label,
                          name="ctc")
    # expose softmax over classes for decoding alongside the loss
    return mx.sym.Group([mx.sym.MakeLoss(loss),
                         mx.sym.BlockGrad(mx.sym.softmax(pred,
                                                         axis=2))])


def sample(rng, protos, label_len, seq_len, noise=0.25):
    """Render `label_len` random digits into <= seq_len frames with
    random widths; returns (frames, 1-based labels)."""
    n_cls = len(protos)
    labels = rng.randint(0, n_cls, label_len)
    frames = []
    for d in labels:
        for _ in range(rng.randint(2, 4)):
            frames.append(protos[d])
    frames = frames[:seq_len]
    X = np.zeros((seq_len, protos.shape[1]), np.float32)
    X[:len(frames)] = np.asarray(frames)
    X += noise * rng.rand(seq_len, protos.shape[1]).astype(np.float32)
    return X, labels + 1  # 0 is CTC blank


def best_path_decode(prob):
    """Collapse repeats then drop blanks (class 0)."""
    path = prob.argmax(axis=1)
    out = []
    prev = -1
    for p in path:
        if p != prev and p != 0:
            out.append(int(p))
        prev = p
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="CTC training")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-epoch", type=int, default=15)
    parser.add_argument("--seq-len", type=int, default=12)
    parser.add_argument("--label-len", type=int, default=4)
    parser.add_argument("--classes", type=int, default=6)
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card's id (one device)")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)
    mx.random.seed(0)      # the initializer and the shuffle

    rng = np.random.RandomState(0)
    feat = 16
    protos = rng.rand(args.classes, feat).astype(np.float32)

    n = 2048
    X = np.zeros((n, args.seq_len, feat), np.float32)
    Y = np.zeros((n, args.label_len), np.float32)
    for i in range(n):
        x, lab = sample(rng, protos, args.label_len, args.seq_len)
        X[i] = x
        Y[i] = lab

    it = mx.io.NDArrayIter(X, Y, batch_size=args.batch_size,
                           shuffle=True, label_name="label")
    net = make_net(args.seq_len, 64, args.classes + 1, args.batch_size)
    mod = mx.mod.Module(net, label_names=("label",), context=ctx)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(mx.initializer.Xavier())
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 0.005})
    timer = StepTimer(ctx)
    losses = []
    for epoch in range(args.num_epoch):
        it.reset()
        tot = cnt = 0.0
        with timer:
            for b in it:
                mod.forward_backward(b)
                mod.update()
                tot += float(mod.get_outputs()[0].asnumpy().mean())
                cnt += 1
                timer.steps += 1
        losses.append(tot / cnt)
        logging.info("epoch %d  ctc loss %.4f", epoch, losses[-1])

    # exact-sequence accuracy via best-path decoding
    it.reset()
    correct = total = 0
    for b in it:
        mod.forward(b, is_train=False)
        probs = mod.get_outputs()[1].asnumpy()
        labs = b.label[0].asnumpy().astype(int)
        for i in range(probs.shape[0]):
            if best_path_decode(probs[i]) == list(labs[i]):
                correct += 1
            total += 1
        if total >= 512:
            break
    acc = correct / float(total)
    print("exact-sequence accuracy (best-path decode): %.3f" % acc)
    assert acc > 0.8, "CTC should align and recognize the sequences"
    return {"accuracy": acc, "losses": losses, "module": mod,
            "ms_per_step": timer.ms_per_step, "steps": timer.steps}


if __name__ == "__main__":
    main()
