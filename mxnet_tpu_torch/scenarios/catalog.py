"""The seeded scenario matrix — the example/ long tail as pinned
workloads (four long-tail scenarios plus the u8/cache and sharded-cache
reference carriers), at the JAX package's own sizes, every data stream a
pure function of the scenario seed (the port's counterpart of
``mxnet_tpu/scenarios/catalog.py``).

Each scenario mirrors one example family's REAL graph and data recipe
(shrunk, never mocked); the example scripts stay the human-readable
demos, the catalog is the contract-bearing twin.  Modules, the decode
engine and the virtual cluster bind on the current context
(``mx.current_context()``: ``gpu(0)`` unless a ``with mx.cpu():`` scope
says otherwise).  Importing this module registers the matrix.
"""
import numpy as onp

import mxnet_tpu_torch as mx

from .registry import Scenario, register

__all__ = ["register_all"]


# ---------------------------------------------------------------------------
# transformer_lm — decode-engine customer, int8_weight serving mode
# (example/transformer-lm/transformer_lm_tp.py, shrunk)
# ---------------------------------------------------------------------------
_TF = dict(V=32, D=32, H=2, T=12, BLOCKS=2, B=32, N=512, EPOCHS=10)


def _tf_symbol(batch):
    V, D, H, T = _TF["V"], _TF["D"], _TF["H"], _TF["T"]
    DH = D // H

    def attention(x, name):
        x2 = mx.sym.Reshape(x, shape=(-1, D))

        def heads(proj):
            s = mx.sym.Reshape(proj, shape=(batch, T, H, DH))
            s = mx.sym.transpose(s, axes=(0, 2, 1, 3))
            return mx.sym.Reshape(s, shape=(-1, T, DH))

        q = heads(mx.sym.FullyConnected(x2, num_hidden=D,
                                        name=name + "_q"))
        k = heads(mx.sym.FullyConnected(x2, num_hidden=D,
                                        name=name + "_k"))
        v = heads(mx.sym.FullyConnected(x2, num_hidden=D,
                                        name=name + "_v"))
        scores = mx.sym.batch_dot(q, k, transpose_b=True) * (DH ** -0.5)
        mask = mx.sym.Variable("causal_mask", shape=(1, T, T))
        att = mx.sym.softmax(mx.sym.broadcast_add(scores, mask), axis=-1)
        ctx = mx.sym.batch_dot(att, v)
        ctx = mx.sym.Reshape(ctx, shape=(batch, H, T, DH))
        ctx = mx.sym.transpose(ctx, axes=(0, 2, 1, 3))
        ctx = mx.sym.Reshape(ctx, shape=(-1, D))
        out = mx.sym.FullyConnected(ctx, num_hidden=D, name=name + "_o")
        return mx.sym.Reshape(out, shape=(batch, T, D))

    def mlp(x, name):
        x2 = mx.sym.Reshape(x, shape=(-1, D))
        h = mx.sym.FullyConnected(x2, num_hidden=4 * D,
                                  name=name + "_fc1")
        h = mx.sym.Activation(h, act_type="relu")
        h = mx.sym.FullyConnected(h, num_hidden=D, name=name + "_fc2")
        return mx.sym.Reshape(h, shape=(batch, T, D))

    data = mx.sym.Variable("data")
    emb = mx.sym.Embedding(data, input_dim=V, output_dim=D, name="embed")
    pos = mx.sym.Variable("pos_embed", shape=(1, T, D))
    x = mx.sym.broadcast_add(emb, pos)
    for i in range(_TF["BLOCKS"]):
        x = x + attention(x, "blk%d_att" % i)
        x = x + mlp(x, "blk%d_mlp" % i)
    logits = mx.sym.FullyConnected(mx.sym.Reshape(x, shape=(-1, D)),
                                   num_hidden=V, name="head")
    label = mx.sym.Reshape(mx.sym.Variable("softmax_label"), shape=(-1,))
    return mx.sym.SoftmaxOutput(logits, label=label, name="softmax")


class _TFInit(mx.initializer.Xavier):
    """Xavier for projections + the causal mask / position table (the
    example's LMInit rule)."""

    def __call__(self, desc, arr):
        name = getattr(desc, "name", str(desc))
        T, D = _TF["T"], _TF["D"]
        if name == "causal_mask":
            arr[:] = onp.triu(
                onp.full((T, T), -1e9, onp.float32), k=1)[None]
        elif name == "pos_embed":
            arr[:] = 0.02 * onp.random.randn(1, T, D) \
                .astype(onp.float32)
        else:
            super().__call__(desc, arr)


def _tf_data(n, seed):
    """Successor-chain sequences: x_{t+1} = (x_t + step) mod V with a
    per-sequence step in {1,2,3} — a causal LM must read the history
    to beat the 1/3 ambiguity of the last token alone."""
    V, T = _TF["V"], _TF["T"]
    rng = onp.random.RandomState(seed)
    start = rng.randint(0, V, n)
    step = rng.randint(1, 4, n)
    t = onp.arange(T + 1)
    seq = (start[:, None] + step[:, None] * t[None, :]) % V
    return seq[:, :T].astype(onp.float32), seq[:, 1:].astype(onp.float32)


def _tf_module():
    return mx.mod.Module(_tf_symbol(_TF["B"]),
                         fixed_param_names=["causal_mask"])


def _tf_train_iter(_mod):
    X, y = _tf_data(_TF["N"], seed=1)
    return mx.io.NDArrayIter(X, y, batch_size=_TF["B"],
                             label_name="softmax_label")


def _tf_score(mod):
    Xv, yv = _tf_data(256, seed=2)
    val = mx.io.NDArrayIter(Xv, yv, batch_size=_TF["B"],
                            label_name="softmax_label")
    return dict(mod.score(val, mx.metric.Accuracy()))["accuracy"]


def _tf_serving(mod):
    """DecodeEngine parity under precision='int8_weight': engine greedy
    next-token agrees with the training module's forward argmax, and
    the int8 step program reads fewer argument bytes than f32 (the
    memory-bound decode win) — example/rnn/decode_lm.py's witness on
    the transformer customer."""
    from mxnet_tpu_torch.serving.decode import DecodeEngine, TransformerLM
    V, T, B = _TF["V"], _TF["T"], _TF["B"]
    arg_params, _ = mod.get_params()
    model = TransformerLM.from_params(arg_params, num_heads=_TF["H"])
    Xp, _ = _tf_data(B, seed=3)
    probs = mod.predict(
        mx.io.NDArrayIter(Xp, None, batch_size=B)
    ).asnumpy().reshape(B, T, V)
    ctx = mx.current_context()
    eng = DecodeEngine(model, None, slots=4, max_prefill_len=T,
                       precision="int8_weight", context=ctx)
    try:
        eng.warmup()
        wide = DecodeEngine(model, None, slots=4, max_prefill_len=T,
                            start=False, context=ctx)
        nb_i8, nb_f32 = (eng.step_argument_bytes(),
                         wide.step_argument_bytes())
        wide.release()
        agree = 0
        for i in range(B):
            prompt = [int(v) for v in Xp[i]]
            nxt = eng.generate(prompt, max_new_tokens=1, timeout=120)[0]
            agree += int(int(onp.argmax(probs[i, -1])) == nxt)
        # gateway leg (serving_gateway): the same engine behind the
        # HTTP front door streams token-for-token what the in-process
        # call emits — serving parity survives the network plane
        from mxnet_tpu_torch.gateway import GatewayClient, GatewayServer
        gw_agree, gw_n = 0, 2
        with GatewayServer(decode_backend=eng) as gw:
            cli = GatewayClient("127.0.0.1", gw.port)
            for i in range(gw_n):
                prompt = [int(v) for v in Xp[i]]
                ref = eng.generate(prompt, max_new_tokens=4, seed=i,
                                   timeout=120)
                got = list(cli.generate(prompt, max_new_tokens=4,
                                        seed=i))
                gw_agree += int(got == ref)
    finally:
        eng.shutdown(drain=True)
    # int8 weight noise can flip near-tie argmaxes; the LM must still
    # clearly track the module forward (decode_lm's int8 floor)
    ok = (agree >= int(0.8 * B) and nb_i8 < nb_f32
          and gw_agree == gw_n)
    return {"ok": ok,
            "parity": "%d/%d" % (agree, B),
            "gateway_stream_parity": "%d/%d" % (gw_agree, gw_n),
            "step_argument_bytes": {"int8": int(nb_i8),
                                    "f32": int(nb_f32)},
            "detail": "argmax parity %d/%d, gateway streams %d/%d, "
                      "int8 step args %dB < f32 %dB"
                      % (agree, B, gw_agree, gw_n, nb_i8, nb_f32)}


# ---------------------------------------------------------------------------
# bucketing_lstm — variable-length shape-bucket stress
# (example/rnn/bucketing_lstm.py, shrunk)
# ---------------------------------------------------------------------------
_BK = dict(V=24, HID=48, EMB=16, B=8, BUCKETS=(8, 16), N=320, EPOCHS=6)


def _bk_sentences(n, seed):
    """Variable-length successor chains over tokens 1..V-1 (0 is the
    pad/invalid label): lengths spread across both buckets so every
    bucket key appears in every epoch."""
    V = _BK["V"]
    rng = onp.random.RandomState(seed)
    out = []
    for _ in range(n):
        length = rng.randint(4, _BK["BUCKETS"][-1] + 1)
        start = rng.randint(1, V)
        step = rng.randint(1, 3)
        seq = (start - 1 + step * onp.arange(length)) % (V - 1) + 1
        out.append([int(v) for v in seq])
    return out


def _bk_sym_gen(seq_len):
    from mxnet_tpu_torch import rnn
    cell = rnn.FusedRNNCell(_BK["HID"], num_layers=1, mode="lstm",
                            prefix="lstm_")
    data = mx.sym.Variable("data")
    embed = mx.sym.Embedding(data, input_dim=_BK["V"],
                             output_dim=_BK["EMB"], name="embed")
    output, _ = cell.unroll(seq_len, inputs=embed, layout="NTC",
                            merge_outputs=True)
    pred = mx.sym.Reshape(output, shape=(-1, _BK["HID"]))
    pred = mx.sym.FullyConnected(pred, num_hidden=_BK["V"], name="pred")
    label = mx.sym.Reshape(mx.sym.Variable("softmax_label"), shape=(-1,))
    pred = mx.sym.SoftmaxOutput(pred, label, name="softmax")
    return pred, ("data",), ("softmax_label",)


def _bk_module():
    return mx.mod.BucketingModule(
        _bk_sym_gen, default_bucket_key=max(_BK["BUCKETS"]))


def _bk_train_iter(_mod):
    from mxnet_tpu_torch import rnn
    return rnn.BucketSentenceIter(
        _bk_sentences(_BK["N"], seed=1), _BK["B"],
        buckets=list(_BK["BUCKETS"]), invalid_label=0)


def _bk_score(mod):
    from mxnet_tpu_torch import rnn
    val = rnn.BucketSentenceIter(
        _bk_sentences(128, seed=2), _BK["B"],
        buckets=list(_BK["BUCKETS"]), invalid_label=0)
    return dict(mod.score(
        val, mx.metric.Perplexity(ignore_label=0)))["Perplexity"]


def _bk_infer_sym(seq_len):
    """Label-free serving twin of :func:`_bk_sym_gen` — same param
    names, plain softmax head (a reshaped-label SoftmaxOutput cannot
    backward-infer the label shape from data alone, so an inference
    bind must not carry it)."""
    from mxnet_tpu_torch import rnn
    cell = rnn.FusedRNNCell(_BK["HID"], num_layers=1, mode="lstm",
                            prefix="lstm_")
    data = mx.sym.Variable("data")
    embed = mx.sym.Embedding(data, input_dim=_BK["V"],
                             output_dim=_BK["EMB"], name="embed")
    output, _ = cell.unroll(seq_len, inputs=embed, layout="NTC",
                            merge_outputs=True)
    pred = mx.sym.Reshape(output, shape=(-1, _BK["HID"]))
    pred = mx.sym.FullyConnected(pred, num_hidden=_BK["V"], name="pred")
    pred = mx.sym.softmax(pred, axis=-1)
    # row-aligned serving view: one (T*V,) row per request row (the
    # Predictor contract is row-in/row-out)
    return mx.sym.Reshape(pred, shape=(-1, seq_len * _BK["V"]))


def _bk_serving(mod):
    """Predictor parity on the padded top bucket: a plain inference
    Module built from the label-free serving twin adopts the
    BucketingModule's shared params; the Predictor must serve its rows
    bitwise equal to the module's own forward — variable-length
    prompts ride in padded with the bucket's invalid label."""
    from mxnet_tpu_torch.serving import Predictor
    top, B, V = max(_BK["BUCKETS"]), _BK["B"], _BK["V"]
    smod = mx.mod.Module(_bk_infer_sym(top), data_names=("data",),
                         label_names=())
    smod.bind(data_shapes=[("data", (B, top))], for_training=False)
    arg_params, aux_params = mod.get_params()
    smod.set_params(arg_params, aux_params)
    # deterministic padded prompts across both bucket lengths
    sents = _bk_sentences(B, seed=4)
    X = onp.zeros((B, top), onp.float32)
    for i, s in enumerate(sents):
        X[i, :min(len(s), top)] = s[:top]
    ref = smod.predict(
        mx.io.NDArrayIter(X, None, batch_size=B)).asnumpy()
    pred = Predictor(smod, max_batch_size=B)
    try:
        served = onp.asarray(pred.predict(X))
    finally:
        pred.release()
    ok = served.shape == ref.shape and onp.array_equal(served, ref)
    return {"ok": bool(ok),
            "detail": "served rows %s module forward (shape %r)"
                      % ("bitwise equal" if ok else "DIVERGED",
                         tuple(served.shape))}


# ---------------------------------------------------------------------------
# nce_loss — sparse/embedding gather path, multi-input net
# (example/nce-loss/nce_embedding.py, shrunk)
# ---------------------------------------------------------------------------
_NCE = dict(VOCAB=60, DIM=12, K=6, B=64, N=4096, EPOCHS=8)


def _nce_symbol():
    vocab, dim = _NCE["VOCAB"], _NCE["DIM"]
    center = mx.sym.Variable("center")
    targets = mx.sym.Variable("targets")
    nce_label = mx.sym.Variable("nce_label")
    c = mx.sym.Embedding(center, input_dim=vocab, output_dim=dim,
                         name="embed_in")
    t = mx.sym.Embedding(targets, input_dim=vocab, output_dim=dim,
                         name="embed_out")
    ce = mx.sym.Reshape(c, shape=(-1, 1, dim))
    scores = mx.sym.sum_axis(mx.sym.broadcast_mul(ce, t), axis=2)
    return mx.sym.LogisticRegressionOutput(scores, label=nce_label,
                                           name="nce")


def _nce_arrays(n, seed):
    vocab, k = _NCE["VOCAB"], _NCE["K"]
    rng = onp.random.RandomState(seed)
    centers = rng.randint(0, vocab, n)
    block = centers // 10
    positives = block * 10 + rng.randint(0, 10, n)
    targets = onp.empty((n, 1 + k), onp.float32)
    labels = onp.zeros((n, 1 + k), onp.float32)
    targets[:, 0] = positives
    labels[:, 0] = 1.0
    targets[:, 1:] = rng.randint(0, vocab, (n, k))
    return centers.astype(onp.float32), targets, labels


def _nce_module():
    return mx.mod.Module(_nce_symbol(), data_names=("center", "targets"),
                         label_names=("nce_label",))


def _nce_train_iter(_mod):
    centers, targets, labels = _nce_arrays(_NCE["N"], seed=1)
    return mx.io.NDArrayIter(
        {"center": centers, "targets": targets},
        {"nce_label": labels}, batch_size=_NCE["B"])


def _nce_score(mod):
    """Embedding-cluster margin: mean same-block cosine minus mean
    cross-block cosine (the example's learning assert, as a score)."""
    vocab = _NCE["VOCAB"]
    E = mod.get_params()[0]["embed_in_weight"].asnumpy()
    En = E / (onp.linalg.norm(E, axis=1, keepdims=True) + 1e-8)
    sim = En @ En.T
    same = onp.mean([sim[i, j] for i in range(vocab)
                     for j in range(vocab)
                     if i != j and i // 10 == j // 10])
    cross = onp.mean([sim[i, j] for i in range(0, vocab, 7)
                      for j in range(vocab) if i // 10 != j // 10])
    return float(same - cross)


def _nce_serving(mod):
    """Predictor parity on the multi-input net: a name->array dict
    request must serve bitwise equal to the module's own forward."""
    from mxnet_tpu_torch.serving import Predictor
    B = _NCE["B"]
    centers, targets, _ = _nce_arrays(B, seed=5)
    ref = mod.predict(mx.io.NDArrayIter(
        {"center": centers, "targets": targets}, None,
        batch_size=B)).asnumpy()
    pred = Predictor(mod, max_batch_size=B)
    try:
        served = onp.asarray(pred.predict(
            {"center": centers, "targets": targets}))
    finally:
        pred.release()
    ok = onp.array_equal(served.reshape(ref.shape), ref)
    return {"ok": bool(ok),
            "detail": "multi-input dict request %s module forward"
                      % ("bitwise equal to" if ok else "DIVERGED from")}


# ---------------------------------------------------------------------------
# ssd_toy — multi-output detection head through det augment + serving
# (example/ssd/train_ssd.py, shrunk)
# ---------------------------------------------------------------------------
_SSD = dict(B=32, N=256, SIZE=32, EPOCHS=8, TOPK=5)


def _ssd_build(detector=False):
    from mxnet_tpu_torch.examples import train_ssd
    return train_ssd.build_detector() if detector \
        else train_ssd.build_ssd()[0]


def _ssd_data(n, seed):
    rng = onp.random.RandomState(seed)
    size = _SSD["SIZE"]
    imgs = rng.rand(n, 3, size, size).astype(onp.float32) * 0.2
    labels = onp.zeros((n, 1, 5), onp.float32)
    for i in range(n):
        w = rng.randint(8, 20)
        x0, y0 = rng.randint(0, size - w, 2)
        imgs[i, :, y0:y0 + w, x0:x0 + w] = 1.0
        labels[i, 0] = [0, x0 / size, y0 / size, (x0 + w) / size,
                        (y0 + w) / size]
    return imgs, labels


def _ssd_module():
    return mx.mod.Module(_ssd_build(), data_names=["data"],
                         label_names=["label"])


def _ssd_train_iter(_mod):
    imgs, labels = _ssd_data(_SSD["N"], seed=1)
    return mx.io.NDArrayIter(imgs, label=labels,
                             batch_size=_SSD["B"], label_name="label")


def _ssd_detector(mod):
    B = _SSD["B"]
    det = mx.mod.Module(_ssd_build(detector=True), data_names=["data"],
                        label_names=())
    det.bind(data_shapes=[("data", (B, 3, _SSD["SIZE"], _SSD["SIZE"]))],
             for_training=False)
    det.set_params(*mod.get_params())
    return det


def _ssd_iou(bx, gt):
    ix0, iy0 = max(bx[0], gt[0]), max(bx[1], gt[1])
    ix1, iy1 = min(bx[2], gt[2]), min(bx[3], gt[3])
    inter = max(ix1 - ix0, 0.0) * max(iy1 - iy0, 0.0)
    area = ((bx[2] - bx[0]) * (bx[3] - bx[1])
            + (gt[2] - gt[0]) * (gt[3] - gt[1]) - inter)
    return inter / area if area > 0 else 0.0


def _ssd_score(mod):
    """Proposal quality of the decoded + NMSed detections: mean over
    held-out images of the best IoU among the TOPK highest-scoring
    detections vs ground truth.  The toy head localizes well before
    its score ranking sharpens (best-of-all IoU ~0.65 while top-1
    lingers ~0.3), so best-of-top-K is the measurement that converges
    — the detector must still actually find the bright square."""
    B, K = _SSD["B"], _SSD["TOPK"]
    imgs, labels = _ssd_data(B, seed=2)
    det = _ssd_detector(mod)
    out = det.predict(
        mx.io.NDArrayIter(imgs, None, batch_size=B)).asnumpy()
    ious = []
    for i in range(B):
        dets = out[i]
        d = dets[dets[:, 0] >= 0]
        gt = labels[i, 0, 1:5]
        if not len(d):
            ious.append(0.0)
            continue
        order = onp.argsort(-d[:, 1])[:K]
        ious.append(max(_ssd_iou(d[j, 2:6], gt) for j in order))
    return float(onp.mean(ious))


def _ssd_serving(mod):
    """Predictor parity over the detection graph: the served decode +
    NMS rows must be bitwise equal to the detector module's own
    forward."""
    from mxnet_tpu_torch.serving import Predictor
    B = _SSD["B"]
    imgs, _ = _ssd_data(B, seed=6)
    det = _ssd_detector(mod)
    ref = det.predict(
        mx.io.NDArrayIter(imgs, None, batch_size=B)).asnumpy()
    pred = Predictor(det, max_batch_size=B)
    try:
        served = onp.asarray(pred.predict(imgs))
    finally:
        pred.release()
    ok = onp.array_equal(served.reshape(ref.shape), ref)
    return {"ok": bool(ok),
            "detail": "served detections %s detector forward"
                      % ("bitwise equal to" if ok else "DIVERGED from")}


# ---------------------------------------------------------------------------
# cnn_u8_cache — u8 wire + device augment + device dataset cache
# (example/image-classification/train_cifar10.py --device-augment
#  --cache-dataset, shrunk)
# ---------------------------------------------------------------------------
_CNN = dict(B=32, N=512, CLASSES=10, EPOCHS=6)


def _cnn_symbol():
    data = mx.sym.Variable("data")
    c = mx.sym.Convolution(data, kernel=(3, 3), pad=(1, 1),
                           num_filter=16, name="conv1")
    c = mx.sym.Activation(c, act_type="relu")
    c = mx.sym.Pooling(c, kernel=(2, 2), stride=(2, 2),
                       pool_type="max", name="pool1")
    c = mx.sym.Convolution(c, kernel=(3, 3), pad=(1, 1),
                           num_filter=32, name="conv2")
    c = mx.sym.Activation(c, act_type="relu")
    c = mx.sym.Pooling(c, kernel=(2, 2), stride=(2, 2),
                       pool_type="max", name="pool2")
    h = mx.sym.FullyConnected(mx.sym.Flatten(c), num_hidden=64,
                              name="fc1")
    h = mx.sym.Activation(h, act_type="relu")
    fc = mx.sym.FullyConnected(h, num_hidden=_CNN["CLASSES"],
                               name="fc2")
    return mx.sym.SoftmaxOutput(fc, name="softmax")


def _cnn_data(n, seed):
    """train_cifar10's synthetic recipe: 10 upsampled class prototypes
    plus noise — memorizable, so the accuracy floor means learning."""
    protos = onp.random.RandomState(0) \
        .rand(10, 3, 7, 7).astype(onp.float32)
    rng = onp.random.RandomState(seed)
    y = rng.randint(0, 10, n)
    up = onp.kron(protos[y], onp.ones((1, 1, 4, 4), onp.float32))
    X = up + 0.25 * rng.rand(n, 3, 28, 28).astype(onp.float32)
    return onp.clip(X, 0.0, 1.0), y.astype(onp.float32)


def _cnn_to_u8(x):
    return (onp.clip(x, 0.0, 1.0) * 255.0).round() \
        .astype(onp.uint8).transpose(0, 2, 3, 1)


def _cnn_module():
    return mx.mod.Module(_cnn_symbol())


def _cnn_train_iter(mod):
    from mxnet_tpu_torch.data import CachedDataset, DeviceAugment
    X, y = _cnn_data(_CNN["N"], seed=1)
    spec = DeviceAugment(shape=(3, 28, 28), rand_crop=True,
                         rand_mirror=True, pad=2, mean=0.0, std=1.0,
                         scale=1.0 / 255.0, seed=11)
    src = mx.io.NDArrayIter(_cnn_to_u8(X), y, batch_size=_CNN["B"])
    return CachedDataset(src, augment=spec, module=mod)


def _cnn_score(mod):
    from mxnet_tpu_torch.data import DeviceAugment, DeviceAugmentIter
    X, y = _cnn_data(256, seed=2)
    spec = DeviceAugment(shape=(3, 28, 28), rand_crop=True,
                         rand_mirror=True, pad=2, mean=0.0, std=1.0,
                         scale=1.0 / 255.0, seed=11)
    val = DeviceAugmentIter(
        mx.io.NDArrayIter(_cnn_to_u8(X), y, batch_size=_CNN["B"]),
        spec, train=False)
    return dict(mod.score(val, mx.metric.Accuracy()))["accuracy"]


def _cnn_serving(mod):
    """Predictor parity through a plain f32 inference twin (the
    trained module is bound to the u8 wire; serving consumes the f32
    NCHW view, the serve_cifar10 deployment shape)."""
    from mxnet_tpu_torch.serving import Predictor
    B = _CNN["B"]
    X, _ = _cnn_data(B, seed=7)
    # the augment's deterministic eval view: u8 wire decoded back to
    # the f32 [0, 1] range with the center crop the spec applies at
    # is_train=False
    from mxnet_tpu_torch.data import DeviceAugment
    spec = DeviceAugment(shape=(3, 28, 28), rand_crop=True,
                         rand_mirror=True, pad=2, mean=0.0, std=1.0,
                         scale=1.0 / 255.0, seed=11)
    Xe = spec.apply_host(_cnn_to_u8(X), train=False)
    smod = mx.mod.Module(_cnn_symbol())
    smod.bind(data_shapes=[("data", (B, 3, 28, 28))],
              for_training=False)
    smod.set_params(*mod.get_params())
    ref = smod.predict(
        mx.io.NDArrayIter(Xe, None, batch_size=B)).asnumpy()
    pred = Predictor(smod, max_batch_size=B)
    try:
        served = onp.asarray(pred.predict(Xe))
    finally:
        pred.release()
    ok = onp.array_equal(served.reshape(ref.shape), ref)
    return {"ok": bool(ok),
            "detail": "served rows %s f32 inference twin"
                      % ("bitwise equal to" if ok else "DIVERGED from")}


# ---------------------------------------------------------------------------
# mlp_sharded_cache — the sharded device cache tier over virtual hosts
# as a pinned workload (the JAX package's sharded-cache FC recipe)
# ---------------------------------------------------------------------------
_MLP = dict(B=32, N=256, HOSTS=4, EPOCHS=6)


def _mlp_symbol():
    net = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(net, num_hidden=32, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _mlp_arrays():
    rng = onp.random.RandomState(0)
    X = rng.rand(_MLP["N"], 16).astype(onp.float32)
    # learnable labels: argmax of a fixed random linear map, so the
    # floor measures the gathered cache rows actually training the net
    W = rng.randn(16, 10).astype(onp.float32)
    y = onp.argmax(X @ W, axis=1).astype(onp.float32)
    return X, y


def _mlp_module():
    from mxnet_tpu_torch import dist
    cluster = dist.VirtualCluster(_MLP["HOSTS"])
    return mx.mod.Module(_mlp_symbol(), context=cluster.contexts())


def _mlp_train_iter(mod):
    from mxnet_tpu_torch import dist
    from mxnet_tpu_torch.data import ShardedCachedDataset
    X, y = _mlp_arrays()
    it = mx.io.NDArrayIter(X, y, batch_size=_MLP["B"],
                           label_name="softmax_label")
    return ShardedCachedDataset(
        it, cluster=dist.VirtualCluster(_MLP["HOSTS"]), module=mod)


def _mlp_score(mod):
    """Memorization accuracy on the cached training set (random
    labels: beating 1/10 by a wide margin means the gathered cache
    rows are the real rows)."""
    X, y = _mlp_arrays()
    val = mx.io.NDArrayIter(X, y, batch_size=_MLP["B"],
                            label_name="softmax_label")
    return dict(mod.score(val, mx.metric.Accuracy()))["accuracy"]


# ---------------------------------------------------------------------------
def register_all():
    """Register the seeded matrix (module import calls this once)."""
    register(Scenario(
        name="transformer_lm",
        features=("fit", "batch_group", "precision", "serving_decode",
                  "serving_gateway", "checkpoint_resume", "telemetry",
                  "chaos"),
        make_module=_tf_module,
        make_data=_tf_train_iter,
        fit_kwargs=lambda: dict(
            optimizer="adam",
            optimizer_params={"learning_rate": 2e-3},
            initializer=_TFInit(),
            eval_metric=mx.metric.Accuracy(),
            num_epoch=_TF["EPOCHS"],
            batch_group=4,
            prefetch_to_device=2),
        score=_tf_score, floor=0.85, floor_mode="min",
        serving=_tf_serving,
        chaos_rules=("data.device_put:transient@nth=3",
                     "data.stager:transient@nth=7"),
        gauges=("train.mfu",),
        seed=7))

    register(Scenario(
        name="bucketing_lstm",
        features=("fit", "bucketing", "serving_predictor", "telemetry"),
        make_module=_bk_module,
        make_data=_bk_train_iter,
        fit_kwargs=lambda: dict(
            optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                              "clip_gradient": 5.0},
            initializer=mx.initializer.Xavier(),
            eval_metric=mx.metric.Perplexity(ignore_label=0),
            num_epoch=_BK["EPOCHS"]),
        score=_bk_score, floor=2.5, floor_mode="max",
        serving=_bk_serving,
        example=("rnn/bucketing_lstm.py",
                 ["--num-epoch", "3", "--num-hidden", "32"]),
        seed=7))

    register(Scenario(
        name="nce_loss",
        features=("fit", "batch_group", "guardian", "serving_predictor",
                  "telemetry", "chaos"),
        make_module=_nce_module,
        make_data=_nce_train_iter,
        fit_kwargs=lambda: dict(
            optimizer="adam",
            optimizer_params={"learning_rate": 0.02},
            initializer=mx.initializer.Normal(0.1),
            eval_metric=mx.metric.MSE(),
            num_epoch=_NCE["EPOCHS"],
            batch_group=4,
            prefetch_to_device=2),
        score=_nce_score, floor=0.2, floor_mode="min",
        serving=_nce_serving,
        chaos_rules=("data.device_put:transient@nth=5",),
        example=("nce-loss/nce_embedding.py", ["--num-epoch", "8"]),
        seed=7))

    register(Scenario(
        name="ssd_toy",
        features=("fit", "serving_predictor", "telemetry"),
        make_module=_ssd_module,
        make_data=_ssd_train_iter,
        fit_kwargs=lambda: dict(
            optimizer="sgd",
            optimizer_params={"learning_rate": 0.01, "momentum": 0.9},
            initializer=mx.initializer.Xavier(),
            eval_metric=mx.metric.Loss(),
            num_epoch=_SSD["EPOCHS"]),
        score=_ssd_score, floor=0.45, floor_mode="min",
        serving=_ssd_serving,
        example=("ssd/train_ssd.py",
                 ["--num-epochs", "2", "--num-examples", "128",
                  "--batch-size", "16"]),
        seed=7))

    register(Scenario(
        name="cnn_u8_cache",
        features=("fit", "device_augment", "cached_dataset",
                  "serving_predictor", "telemetry"),
        make_module=_cnn_module,
        make_data=_cnn_train_iter,
        fit_kwargs=lambda: dict(
            optimizer="sgd",
            optimizer_params={"learning_rate": 0.02, "momentum": 0.9},
            initializer=mx.initializer.Xavier(),
            num_epoch=_CNN["EPOCHS"]),
        score=_cnn_score, floor=0.9, floor_mode="min",
        serving=_cnn_serving,
        example=("image-classification/train_cifar10.py",
                 ["--num-epochs", "2", "--device-augment",
                  "--cache-dataset"]),
        seed=7))

    register(Scenario(
        name="mlp_sharded_cache",
        features=("fit", "sharded_cache", "telemetry"),
        make_module=_mlp_module,
        make_data=_mlp_train_iter,
        fit_kwargs=lambda: dict(
            optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=mx.initializer.Xavier(),
            num_epoch=_MLP["EPOCHS"]),
        score=_mlp_score, floor=0.5, floor_mode="min",
        gauges=("data.cache_shard_bytes", "data.cache_global_rows"),
        seed=3))


register_all()
