"""Char-LM training and continuous-batching decode serving, end to end:
the port's twin of ``example/rnn/decode_lm.py``.

    python -m mxnet_tpu_torch.examples.decode_lm [--cpu]

Trains the unfused char-LSTM (``mx.rnn.LSTMCell`` unrolled) through
``Module.fit`` on synthetic periodic text, adopts the trained parameters
into :class:`mxnet_tpu_torch.serving.decode.LSTMCharLM`, then checks the
JAX script's four claims:

1. **model parity** — the engine's greedy next-char predictions agree
   with the trained module's own forward argmax on at least 90% of the
   prompts;
2. **learning** — greedy decode continues the periodic text (at least
   90% of the characters);
3. **continuous batching** — concurrent requests through one
   slot-structured engine give token streams bit for bit equal to the
   same requests decoded one at a time;
4. and aggregate tokens/s beats that sequential baseline.

``--int8-weights`` serves the trained parameters through the weight-only
int8 engine (``precision="int8_weight"``): the step's argument bytes must
fall below the f32 engine's (the ratio is printed), and the parity and
continuation floors drop to 0.8 (int8 weight noise can flip near-tie
argmaxes), as in the JAX script.

Unlike the JAX script, which trains on the CPU, the twin trains and
serves on ``gpu(0)`` (or ``--gpus``/``--tpus``) unless ``--cpu`` is given.
``main(argv)`` returns a dict of the results, the streams' sha256 among
them.
"""
import argparse
import hashlib
import json
import logging

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.common import device_context
from mxnet_tpu_torch.serving.decode import DecodeEngine, LSTMCharLM


def make_net(seq_len, vocab, num_hidden, num_embed, batch_size):
    """The unfused char-LSTM graph whose parameter names
    (``embed_weight``, ``lstm_l0_{i2h,h2h}_{weight,bias}``,
    ``pred_{weight,bias}``) :meth:`LSTMCharLM.from_params` adopts."""
    data = mx.sym.Variable("data")
    embed = mx.sym.Embedding(data, input_dim=vocab, output_dim=num_embed,
                             name="embed")
    cell = mx.rnn.LSTMCell(num_hidden=num_hidden, prefix="lstm_l0_")
    # zero initial states of concrete shape keep the unrolled graph
    # shape-inferable from data and label alone (Module.fit needs that)
    begin = cell.begin_state(func=mx.sym.zeros,
                             shape=(batch_size, num_hidden))
    outputs, _ = cell.unroll(seq_len, inputs=embed, begin_state=begin,
                             merge_outputs=True, layout="NTC")
    pred = mx.sym.Reshape(outputs, shape=(-1, num_hidden))
    pred = mx.sym.FullyConnected(pred, num_hidden=vocab, name="pred")
    label = mx.sym.Reshape(mx.sym.Variable("softmax_label"), shape=(-1,))
    return mx.sym.SoftmaxOutput(pred, label=label, name="softmax")


def load_data(seq_len):
    text = "hello tpu world. " * 3000
    vocab = {c: i for i, c in enumerate(sorted(set(text)))}
    arr = np.array([vocab[c] for c in text], dtype=np.float32)
    n = (len(arr) - 1) // seq_len
    X = arr[:n * seq_len].reshape(n, seq_len)
    Y = arr[1:n * seq_len + 1].reshape(n, seq_len)
    return X, Y, vocab, text


def _check(ok, message):
    """The JAX script's ``assert``, kept under ``python -O`` too."""
    if not ok:
        raise AssertionError(message)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--seq-len", type=int, default=16)
    parser.add_argument("--num-hidden", type=int, default=64)
    parser.add_argument("--num-embed", type=int, default=32)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-epochs", type=int, default=3)
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--requests", type=int, default=8)
    parser.add_argument("--max-new", type=int, default=32)
    parser.add_argument("--int8-weights", action="store_true",
                        help="serve the trained params through the "
                        "weight-only int8 decode path "
                        "(precision='int8_weight'): asserts the step's "
                        "argument bytes shrink against f32 and that "
                        "parity and throughput survive quantization")
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card's id (one device)")
    parser.add_argument("--cpu", action="store_true",
                        help="train and serve on the CPU instead of the "
                        "card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)
    precision = "int8_weight" if args.int8_weights else None
    # int8 weight noise can flip near-tie argmaxes; the LM must still
    # clearly track the module forward and the periodic text
    parity_floor = 0.8 if args.int8_weights else 0.9

    # -- train the unfused char-LSTM through fit ------------------------
    X, Y, vocab, text = load_data(args.seq_len)
    net = make_net(args.seq_len, len(vocab), args.num_hidden,
                   args.num_embed, args.batch_size)
    it = mx.io.NDArrayIter(X, Y, batch_size=args.batch_size,
                           shuffle=True, last_batch_handle="discard")
    mod = mx.mod.Module(net, context=ctx)
    mod.fit(it, num_epoch=args.num_epochs,
            eval_metric=mx.metric.Perplexity(ignore_label=None),
            optimizer_params={"learning_rate": args.lr,
                              "momentum": 0.9, "clip_gradient": 5.0})

    # -- adopt the trained params into the decode model -----------------
    arg_params, _ = mod.get_params()
    model = LSTMCharLM.from_params(arg_params)
    _check(model.vocab_size == len(vocab), "vocab size")
    chars = {i: c for c, i in vocab.items()}
    period = text[:len("hello tpu world. ")]

    # 1. model parity: engine greedy next-char == module forward argmax
    total = args.batch_size
    Xp = X[:total]
    probs = mod.predict(
        mx.io.NDArrayIter(Xp, None, batch_size=args.batch_size)
    ).asnumpy().reshape(total, args.seq_len, len(vocab))
    eng = DecodeEngine(model, arg_params, slots=args.slots,
                       max_prefill_len=args.seq_len, precision=precision,
                       context=ctx)
    eng.warmup()
    byte_ratio = None
    if args.int8_weights:
        # the byte witness: the int8-weight step must receive fewer bytes
        # than the f32 engine's (the memory-bound decode win)
        wide = DecodeEngine(model, arg_params, slots=args.slots,
                            max_prefill_len=args.seq_len, start=False,
                            context=ctx)
        nb_i8, nb_f32 = eng.step_argument_bytes(), wide.step_argument_bytes()
        wide.release()
        _check(nb_i8 < nb_f32, "int8 step arguments %d B not below f32 %d B"
               % (nb_i8, nb_f32))
        byte_ratio = nb_f32 / float(nb_i8)
        print("int8 weights: step argument bytes %d (f32 %d, %.1fx)"
              % (nb_i8, nb_f32, byte_ratio))
    agree = 0
    for i in range(total):
        prompt = [int(v) for v in Xp[i]]
        eng_next = eng.generate(prompt, max_new_tokens=1, timeout=120)[0]
        agree += int(int(np.argmax(probs[i, -1])) == eng_next)
    _check(agree >= int(parity_floor * total),
           "engine/module argmax parity %d/%d" % (agree, total))
    print("parity: engine greedy matches module argmax on %d/%d prompts"
          % (agree, total))

    # 2. learning: greedy decode continues the periodic text
    prompt_text = (period * 3)[:args.seq_len]
    prompt = [vocab[c] for c in prompt_text]
    stream = eng.generate(prompt, max_new_tokens=args.max_new, timeout=120)
    want = "".join(period[(len(prompt_text) + i) % len(period)]
                   for i in range(args.max_new))
    got = "".join(chars[t] for t in stream)
    match = sum(a == b for a, b in zip(got, want)) / float(len(want))
    print("continuation: %r (true %r, match %.2f)" % (got, want, match))
    _check(match >= parity_floor, "LM failed to learn the periodic text")

    # 3. continuous batching: bitwise streams + tokens/sec win
    rng = np.random.RandomState(5)
    starts = rng.randint(0, len(text) - args.seq_len - 1,
                         size=args.requests)
    prompts = [[vocab[c] for c in text[s:s + args.seq_len]]
               for s in starts]
    reqs = [eng.submit(p, max_new_tokens=args.max_new, seed=i)
            for i, p in enumerate(prompts)]
    streams = [r.result(timeout=300) for r in reqs]
    cont_stats = eng.stats()["decode"]
    eng.shutdown(drain=True)
    eng.release()

    seq_eng = DecodeEngine(model, arg_params, slots=args.slots,
                           max_prefill_len=args.seq_len, precision=precision,
                           context=ctx)
    seq_eng.warmup()
    ref = [seq_eng.generate(p, max_new_tokens=args.max_new, seed=i,
                            timeout=300)
           for i, p in enumerate(prompts)]
    seq_stats = seq_eng.stats()["decode"]
    seq_eng.shutdown(drain=True)
    seq_eng.release()

    _check(streams == ref,
           "continuous-batched streams diverged from unbatched decode")
    cont_tps, seq_tps = (cont_stats["tokens_per_sec"],
                         seq_stats["tokens_per_sec"])
    print("tokens/sec: continuous %.0f (occupancy %.2f) vs sequential %.0f"
          % (cont_tps, cont_stats["avg_occupancy"], seq_tps))
    _check(cont_tps > seq_tps,
           "continuous batching did not beat sequential decode")
    digest = hashlib.sha256(json.dumps(streams).encode()).hexdigest()
    print("streams sha256: %s" % digest)
    print("decode_lm%s: all asserts passed (parity %d/%d, continuation "
          "%.2f, %.1fx throughput)"
          % (" [int8-weights]" if args.int8_weights else "", agree, total,
             match, cont_tps / seq_tps))
    return {"module": mod, "parity": agree, "prompts": total,
            "continuation": match, "streams": streams,
            "streams_sha256": digest, "continuous": cont_stats,
            "sequential": seq_stats, "step_bytes_ratio": byte_ratio}


if __name__ == "__main__":
    main()
