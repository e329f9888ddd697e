"""Example entry points of the port, twins of the JAX package's
``example/image-classification`` scripts: ``python -m
mxnet_tpu_torch.examples.train_mnist`` and ``... .train_cifar10``."""
