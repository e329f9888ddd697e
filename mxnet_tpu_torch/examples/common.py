"""What the example twins share: the device they train on."""
import torch

import mxnet_tpu_torch as mx


def device_context(args):
    """``--cpu``, else the one card named by ``--gpus``/``--tpus``
    (default 0). On the card, float32 stays float32 (TF32 off for
    convolutions and matrix products), as the JAX package's
    ``f32_precision`` asks of XLA."""
    if args.cpu:
        return mx.cpu()
    ids = [int(i) for i in (args.tpus or "0").split(",")]
    if len(ids) != 1:
        raise mx.MXNetError("the port trains on one device; multi-device "
                            "binding comes with the dist slice (got %s)"
                            % args.tpus)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return mx.gpu(ids[0])
