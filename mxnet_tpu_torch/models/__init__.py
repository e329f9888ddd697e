"""Model zoo — symbol builders, as ``mxnet_tpu/models``. This slice of the
port carries ResNet, the training path's network."""
from . import resnet


def get_symbol(name, **kwargs):
    """Look up a model by the reference's --network names
    (``resnet-<depth>``)."""
    if name.startswith("resnet") and not name.startswith("resnext"):
        num_layers = int(name[len("resnet") + 1:]) if "-" in name else 50
        return resnet.get_symbol(num_layers=num_layers, **kwargs)
    raise ValueError("model %r is not in this slice of the port (resnet-N "
                     "only)" % name)
