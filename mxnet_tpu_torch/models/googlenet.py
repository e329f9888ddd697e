"""GoogLeNet / Inception-v1 (example/image-classification/symbols/
googlenet.py), as the JAX package's ``models/googlenet.py`` builds it,
table-driven: the inception stages are data (Szegedy et al. 2014, table
1). The layer names are the JAX package's, so parameters cross between
the packages by name."""
from .. import symbol as sym

# (name, num_1x1, reduce_3x3, num_3x3, reduce_5x5, num_5x5, pool_proj)
# per inception block, grouped by stage; "P" entries are 3x3/s2 max-pools
_STAGES = [
    "P",
    ("in3a", 64, 96, 128, 16, 32, 32),
    ("in3b", 128, 128, 192, 32, 96, 64),
    "P",
    ("in4a", 192, 96, 208, 16, 48, 64),
    ("in4b", 160, 112, 224, 24, 64, 64),
    ("in4c", 128, 128, 256, 24, 64, 64),
    ("in4d", 112, 144, 288, 32, 64, 64),
    ("in4e", 256, 160, 320, 32, 128, 128),
    "P",
    ("in5a", 256, 160, 320, 32, 128, 128),
    ("in5b", 384, 192, 384, 48, 128, 128),
]


def _conv_relu(x, filters, kernel, name, stride=(1, 1), pad=(0, 0),
               suffix=""):
    x = sym.Convolution(data=x, num_filter=filters, kernel=kernel,
                        stride=stride, pad=pad,
                        name="conv_%s%s" % (name, suffix))
    return sym.Activation(data=x, act_type="relu",
                          name="relu_%s%s" % (name, suffix))


def _inception(x, name, n1, r3, n3, r5, n5, proj):
    """Four parallel towers concatenated on channels: 1x1 / reduced 3x3 /
    reduced 5x5 / pooled projection."""
    t1 = _conv_relu(x, n1, (1, 1), "%s_1x1" % name)
    t3 = _conv_relu(x, r3, (1, 1), "%s_3x3" % name, suffix="_reduce")
    t3 = _conv_relu(t3, n3, (3, 3), "%s_3x3" % name, pad=(1, 1))
    t5 = _conv_relu(x, r5, (1, 1), "%s_5x5" % name, suffix="_reduce")
    t5 = _conv_relu(t5, n5, (5, 5), "%s_5x5" % name, pad=(2, 2))
    tp = sym.Pooling(data=x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="max",
                     name="max_pool_%s_pool" % name)
    tp = _conv_relu(tp, proj, (1, 1), "%s_proj" % name)
    return sym.Concat(t1, t3, t5, tp, name="ch_concat_%s_chconcat" % name)


def get_symbol(num_classes=1000, **kwargs):
    x = sym.Variable("data")
    # stem: 7x7/s2 -> pool -> 1x1 -> 3x3 -> pool
    x = _conv_relu(x, 64, (7, 7), "conv1", stride=(2, 2), pad=(3, 3))
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _conv_relu(x, 64, (1, 1), "conv2")
    x = _conv_relu(x, 192, (3, 3), "conv3", pad=(1, 1))
    for entry in _STAGES:
        if entry == "P":
            x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2),
                            pool_type="max")
        else:
            x = _inception(x, entry[0], *entry[1:])
    x = sym.Pooling(x, kernel=(7, 7), stride=(1, 1), global_pool=True,
                    pool_type="avg")
    x = sym.Flatten(data=x)
    x = sym.FullyConnected(data=x, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=x, name="softmax")
