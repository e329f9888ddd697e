"""Model zoo — the symbol functions of the reference's example networks
(example/image-classification/symbols/ + example/rnn), as
``mxnet_tpu/models``: each module's ``get_symbol(num_classes, ...)``
builds the JAX package's graph on the port's ``symbol``, with the same
node names, argument names and attributes."""
from . import mlp
from . import lenet
from . import alexnet
from . import vgg
from . import resnet
from . import resnext
from . import inception_bn
from . import inception_v3
from . import googlenet
from . import inception_resnet_v2
from . import lstm

_MODELS = {
    "mlp": mlp, "lenet": lenet, "alexnet": alexnet, "vgg": vgg,
    "inception-bn": inception_bn,
    "inception-v3": inception_v3, "googlenet": googlenet,
    "inception-resnet-v2": inception_resnet_v2,
}  # resnet/resnext dispatch via the prefix loop in get_symbol


def get_symbol(name, **kwargs):
    """Look up a model by the reference's --network names.

    A ``-bf16`` suffix selects the reduced-precision symbol variant
    (the reference's ``*_fp16`` zoo scripts, in bfloat16): input cast
    down at the graph edge, logits cast back to f32 for the softmax.
    """
    if name.endswith("-bf16"):
        base = name[:-len("-bf16")]
        if not (base.startswith("resnet") and not
                base.startswith("resnext")) and base != "alexnet":
            raise ValueError(
                "no -bf16 symbol variant for %r (the reference ships "
                "fp16 scripts for resnet/alexnet only); use "
                "Module(compute_dtype='bfloat16') for any network" % base)
        kwargs.setdefault("dtype", "bfloat16")
        name = base
    for prefix, mod in (("resnext", resnext), ("resnet", resnet)):
        if name.startswith(prefix):
            num_layers = int(name[len(prefix) + 1:]) if "-" in name else 50
            return mod.get_symbol(num_layers=num_layers, **kwargs)
    return _MODELS[name].get_symbol(**kwargs)
