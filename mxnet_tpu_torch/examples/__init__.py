"""Example entry points of the port, twins of the JAX package's
``example/`` scripts (``python -m mxnet_tpu_torch.examples.<name>``):
the image-classification twins (``train_mnist``, ``train_cifar10``,
``train_imagenet``, ``benchmark_score``, ``fine_tune``), the recurrent
and decode twins (``char_lstm``, ``bucketing_lstm``, ``sort_lstm``,
``decode_lm``) and the training-API twins (``mnist_mlp``,
``custom_softmax``, ``sto_depth``, ``fgsm``, ``gan_mnist``, ``sgld``,
``autoencoder``, ``multitask``)."""
