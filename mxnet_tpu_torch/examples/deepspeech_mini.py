"""DeepSpeech-mini, conv frontend + bidirectional fused RNN + CTC: the
port's twin of ``example/speech_recognition/deepspeech_mini.py``.

    python -m mxnet_tpu_torch.examples.deepspeech_mini [--cpu]

The JAX script's acoustic model: a 3×3 convolution over the (time, mel)
"spectrogram", the ``RNN`` op (one bidirectional LSTM layer of 64; cuDNN
on the card), per-frame logits and ``CTCLoss`` with blank-first labels,
trained through ``fit`` (Adam, lr 2e-3, 25 epochs) on its synthetic
phoneme corpus (512 utterances of 2–4 phonemes held 3–6 frames under
noise; the prototype bank from ``RandomState(7)``). Greedy best-path
decoding of 128 validation utterances; the JAX script's assert holds the
exact-transcription accuracy above 0.7. It trains on ``gpu(0)`` (or
``--gpus``/``--tpus``) unless ``--cpu`` is given; ``main(argv)`` returns
the accuracy, the module and the ms a step.
"""
import argparse
import logging

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.common import (EpochClock, card_sync,
                                             device_context)

N_PHONE = 8          # phoneme classes (labels 1..8; CTC blank = 0)
N_MEL = 20           # "mel" bins
T_FRAMES = 24        # spectrogram frames per utterance
L_MAX = 4            # phonemes per utterance
HIDDEN = 64


def acoustic_model(batch):
    data = mx.sym.Variable("data")            # (N, 1, T, F)
    conv = mx.sym.Convolution(data, kernel=(3, 3), num_filter=8,
                              pad=(1, 1), name="conv1")
    conv = mx.sym.Activation(conv, act_type="relu")
    # (N, C, T, F) -> time-major frames (T, N, C*F) for the fused RNN
    seq = mx.sym.transpose(conv, axes=(2, 0, 1, 3))
    seq = mx.sym.Reshape(seq, shape=(T_FRAMES, batch, -1))
    rnn = mx.sym.RNN(data=seq,
                     parameters=mx.sym.Variable("birnn_parameters"),
                     state=mx.sym.Variable("birnn_init_h",
                                           shape=(2, batch, HIDDEN)),
                     state_cell=mx.sym.Variable("birnn_init_c",
                                                shape=(2, batch, HIDDEN)),
                     state_size=HIDDEN, num_layers=1, mode="lstm",
                     bidirectional=True, name="birnn")  # (T, N, 2H)
    feat = mx.sym.Reshape(rnn, shape=(-1, 2 * HIDDEN))
    logits = mx.sym.FullyConnected(feat, num_hidden=N_PHONE + 1,
                                   name="head")
    logits = mx.sym.Reshape(logits, shape=(T_FRAMES, batch,
                                           N_PHONE + 1))
    label = mx.sym.Variable("label")          # (N, L_MAX), 0-padded
    loss = mx.sym.CTCLoss(logits, label, name="ctc")
    softmax = mx.sym.softmax(logits, axis=-1)
    return mx.sym.Group([mx.sym.MakeLoss(loss),
                         mx.sym.BlockGrad(softmax)])


def make_corpus(n, seed):
    """Utterances of 2..L_MAX phonemes; each phoneme's spectral
    prototype held 3..6 frames + noise. The prototype bank is FIXED
    across corpora (train and validation share the same 'language')."""
    protos = np.random.RandomState(7).randn(
        N_PHONE, N_MEL).astype(np.float32) * 2.0
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 1, T_FRAMES, N_MEL), np.float32)
    y = np.zeros((n, L_MAX), np.float32)
    for i in range(n):
        L = rng.randint(2, L_MAX + 1)
        phones = rng.randint(0, N_PHONE, L)
        t = 0
        for j, ph in enumerate(phones):
            dur = rng.randint(3, 7)
            X[i, 0, t:t + dur] = protos[ph]
            t += dur
            y[i, j] = ph + 1  # CTC labels are 1-based; 0 = blank/pad
        X[i, 0] += rng.randn(T_FRAMES, N_MEL).astype(np.float32) * 0.3
    return X, y


def greedy_decode(softmax_tnc):
    """Best path: argmax per frame, collapse repeats, drop blanks."""
    path = softmax_tnc.argmax(axis=-1)  # (T, N)
    out = []
    for n in range(path.shape[1]):
        seq, prev = [], -1
        for t in range(path.shape[0]):
            c = int(path[t, n])
            if c != prev and c != 0:
                seq.append(c)
            prev = c
        out.append(seq)
    return out


class _Init(mx.initializer.Xavier):
    """The JAX script's: the fused RNN's flat parameters uniform in
    ±0.08 (numpy's global generator), its begin states 0, the rest
    Xavier."""

    def __call__(self, desc, arr):
        name = getattr(desc, "name", str(desc))
        if name.endswith("_parameters"):
            arr[:] = np.random.uniform(
                -0.08, 0.08, arr.shape).astype(np.float32)
        elif name.endswith("_init_h") or name.endswith("_init_c"):
            arr[:] = 0.0
        else:
            super().__call__(desc, arr)


def main(argv=None):
    parser = argparse.ArgumentParser(description="DeepSpeech-mini CTC")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-epoch", type=int, default=25)
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card's id (one device)")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)
    mx.random.seed(0)      # the initializer and the shuffle
    np.random.seed(0)

    X, y = make_corpus(512, seed=1)
    Xv, yv = make_corpus(128, seed=2)
    train = mx.io.NDArrayIter(X, y, batch_size=args.batch_size,
                              shuffle=True, label_name="label")
    mod = mx.mod.Module(acoustic_model(args.batch_size), context=ctx,
                        label_names=("label",),
                        fixed_param_names=["birnn_init_h",
                                           "birnn_init_c"])
    clock = EpochClock(card_sync(ctx))
    mod.fit(train, num_epoch=args.num_epoch, optimizer="adam",
            optimizer_params={"learning_rate": args.lr},
            initializer=_Init(),
            eval_metric=mx.metric.Loss(),
            batch_end_callback=[mx.callback.Speedometer(args.batch_size, 8),
                                clock.batch_end],
            epoch_end_callback=clock.epoch_end)

    # greedy-decode validation transcripts
    val = mx.io.NDArrayIter(Xv, yv, batch_size=args.batch_size,
                            label_name="label")
    correct = total = 0
    for batch in val:
        mod.forward(batch, is_train=False)
        sm = mod.get_outputs()[1].asnumpy()  # (T, N, C)
        decoded = greedy_decode(sm)
        labels = batch.label[0].asnumpy()
        for n in range(labels.shape[0] - (batch.pad or 0)):
            want = [int(v) for v in labels[n] if v > 0]
            correct += decoded[n] == want
            total += 1
    acc = correct / max(total, 1)
    print("exact-transcription accuracy: %.3f (%d utterances)"
          % (acc, total))
    assert acc > 0.7, "acoustic model failed to learn (acc %.3f)" % acc
    rows = clock.rows
    return {"accuracy": acc, "module": mod,
            "ms_per_step": sum(r["ms_per_step"] for r in rows) / len(rows),
            "steps": sum(r["batches"] for r in rows)}


if __name__ == "__main__":
    main()
