"""Model zoo — symbol builders, as ``mxnet_tpu/models``. The port carries
the networks of its training path: ResNet, LeNet and the MLP."""
from . import lenet
from . import mlp
from . import resnet

_MODELS = {"lenet": lenet, "mlp": mlp}


def get_symbol(name, **kwargs):
    """Look up a model by the reference's --network names (``mlp``,
    ``lenet``, ``resnet-<depth>``)."""
    if name.startswith("resnet") and not name.startswith("resnext"):
        num_layers = int(name[len("resnet") + 1:]) if "-" in name else 50
        return resnet.get_symbol(num_layers=num_layers, **kwargs)
    if name in _MODELS:
        return _MODELS[name].get_symbol(**kwargs)
    raise ValueError("model %r is not in this slice of the port (%s, "
                     "resnet-N)" % (name, ", ".join(sorted(_MODELS))))
