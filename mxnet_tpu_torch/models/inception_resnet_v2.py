"""Inception-ResNet-v2 (example/image-classification/symbols/
inception-resnet-v2.py), as the JAX package's
``models/inception_resnet_v2.py`` builds it: the same blocks, filter
counts, residual scalings and names, so parameters cross between the
packages by name."""
from .. import symbol as sym


def Conv(data, num_filter, kernel=(1, 1), stride=(1, 1), pad=(0, 0),
         name=None):
    conv = sym.Convolution(data=data, num_filter=num_filter,
                           kernel=kernel, stride=stride, pad=pad,
                           no_bias=True, name="%s_conv" % name)
    bn = sym.BatchNorm(data=conv, fix_gamma=False, name="%s_bn" % name)
    return sym.Activation(data=bn, act_type="relu", name="%s_relu" % name)


def _stem(data):
    x = Conv(data, 32, (3, 3), (2, 2), name="stem1")
    x = Conv(x, 32, (3, 3), name="stem2")
    x = Conv(x, 64, (3, 3), pad=(1, 1), name="stem3")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max",
                    name="stem_pool1")
    x = Conv(x, 80, (1, 1), name="stem4")
    x = Conv(x, 192, (3, 3), name="stem5")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max",
                    name="stem_pool2")
    # mixed 5b (Inception-A)
    b0 = Conv(x, 96, name="m5b_b0")
    b1 = Conv(x, 48, name="m5b_b1a")
    b1 = Conv(b1, 64, (5, 5), pad=(2, 2), name="m5b_b1b")
    b2 = Conv(x, 64, name="m5b_b2a")
    b2 = Conv(b2, 96, (3, 3), pad=(1, 1), name="m5b_b2b")
    b2 = Conv(b2, 96, (3, 3), pad=(1, 1), name="m5b_b2c")
    b3 = sym.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg", name="m5b_pool")
    b3 = Conv(b3, 64, name="m5b_b3")
    return sym.Concat(b0, b1, b2, b3, name="mixed_5b")


def _block35(x, i, scale=0.17):
    """Inception-ResNet-A: 320-channel residual block."""
    n = "b35_%d" % i
    b0 = Conv(x, 32, name=n + "_b0")
    b1 = Conv(x, 32, name=n + "_b1a")
    b1 = Conv(b1, 32, (3, 3), pad=(1, 1), name=n + "_b1b")
    b2 = Conv(x, 32, name=n + "_b2a")
    b2 = Conv(b2, 48, (3, 3), pad=(1, 1), name=n + "_b2b")
    b2 = Conv(b2, 64, (3, 3), pad=(1, 1), name=n + "_b2c")
    mixed = sym.Concat(b0, b1, b2, name=n + "_concat")
    up = sym.Convolution(mixed, num_filter=320, kernel=(1, 1),
                         name=n + "_up")
    return sym.Activation(x + up * scale, act_type="relu",
                          name=n + "_relu")


def _reduction_a(x):
    b0 = Conv(x, 384, (3, 3), (2, 2), name="redA_b0")
    b1 = Conv(x, 256, name="redA_b1a")
    b1 = Conv(b1, 256, (3, 3), pad=(1, 1), name="redA_b1b")
    b1 = Conv(b1, 384, (3, 3), (2, 2), name="redA_b1c")
    b2 = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max",
                     name="redA_pool")
    return sym.Concat(b0, b1, b2, name="reduction_a")


def _block17(x, i, scale=0.10):
    """Inception-ResNet-B: 1088-channel residual block."""
    n = "b17_%d" % i
    b0 = Conv(x, 192, name=n + "_b0")
    b1 = Conv(x, 128, name=n + "_b1a")
    b1 = Conv(b1, 160, (1, 7), pad=(0, 3), name=n + "_b1b")
    b1 = Conv(b1, 192, (7, 1), pad=(3, 0), name=n + "_b1c")
    mixed = sym.Concat(b0, b1, name=n + "_concat")
    up = sym.Convolution(mixed, num_filter=1088, kernel=(1, 1),
                         name=n + "_up")
    return sym.Activation(x + up * scale, act_type="relu",
                          name=n + "_relu")


def _reduction_b(x):
    b0 = Conv(x, 256, name="redB_b0a")
    b0 = Conv(b0, 384, (3, 3), (2, 2), name="redB_b0b")
    b1 = Conv(x, 256, name="redB_b1a")
    b1 = Conv(b1, 288, (3, 3), (2, 2), name="redB_b1b")
    b2 = Conv(x, 256, name="redB_b2a")
    b2 = Conv(b2, 288, (3, 3), pad=(1, 1), name="redB_b2b")
    b2 = Conv(b2, 320, (3, 3), (2, 2), name="redB_b2c")
    b3 = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max",
                     name="redB_pool")
    return sym.Concat(b0, b1, b2, b3, name="reduction_b")


def _block8(x, i, scale=0.20, relu=True):
    """Inception-ResNet-C: 2080-channel residual block."""
    n = "b8_%d" % i
    b0 = Conv(x, 192, name=n + "_b0")
    b1 = Conv(x, 192, name=n + "_b1a")
    b1 = Conv(b1, 224, (1, 3), pad=(0, 1), name=n + "_b1b")
    b1 = Conv(b1, 256, (3, 1), pad=(1, 0), name=n + "_b1c")
    mixed = sym.Concat(b0, b1, name=n + "_concat")
    up = sym.Convolution(mixed, num_filter=2080, kernel=(1, 1),
                         name=n + "_up")
    out = x + up * scale
    if relu:
        out = sym.Activation(out, act_type="relu", name=n + "_relu")
    return out


def get_symbol(num_classes=1000, n_a=5, n_b=10, n_c=5, **kwargs):
    """Full architecture is (n_a, n_b, n_c) = (10, 20, 10) in the paper;
    the zoo default halves the repeats like the reference script's
    trainable config — pass the paper counts for the exact model."""
    data = sym.Variable("data")
    x = _stem(data)
    for i in range(n_a):
        x = _block35(x, i)
    x = _reduction_a(x)
    for i in range(n_b):
        x = _block17(x, i)
    x = _reduction_b(x)
    for i in range(n_c - 1):
        x = _block8(x, i)
    x = _block8(x, n_c - 1, scale=1.0, relu=False)
    x = Conv(x, 1536, name="conv_final")
    x = sym.Pooling(x, kernel=(8, 8), global_pool=True, pool_type="avg",
                    name="global_pool")
    x = sym.Flatten(x, name="flatten")
    x = sym.Dropout(x, p=0.2, name="dropout")
    fc = sym.FullyConnected(x, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc, name="softmax")
