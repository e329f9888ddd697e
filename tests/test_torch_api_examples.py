"""The training-API example twins of the PyTorch port on the CPU
(``--cpu``), in process, each passing its JAX script's own asserts with
the arguments ``tests/test_examples.py`` gives the JAX script:
``mnist_mlp`` (the written-out loop, ``Module.load``, SequentialModule),
``custom_softmax`` (``mx.operator``, ``sym.Custom``), ``sto_depth``
(``initializer.Mixed``, Adam, ``broadcast_mul``), ``fgsm``
(``inputs_need_grad``, the re-bind from the fused to the classic route),
``gan_mnist`` (two modules, input gradients), ``sgld`` (the SGLD
posterior), ``autoencoder`` (``metric.MSE``) and ``multitask``
(``sym.Group``, a custom multi-output metric)."""
import pytest
import torch

from mxnet_tpu_torch.examples import (autoencoder, custom_softmax, fgsm,
                                      gan_mnist, mnist_mlp, multitask, sgld,
                                      sto_depth)

torch.set_num_threads(2)

CASES = [
    (autoencoder, ["--num-epoch", "15"]),
    (fgsm, ["--num-epoch", "5"]),
    (multitask, ["--num-epoch", "25"]),
    (custom_softmax, ["--num-epoch", "5"]),
    (gan_mnist, ["--num-iter", "500"]),
    (sto_depth, ["--num-epoch", "12"]),
    (mnist_mlp, []),
    (sgld, ["--steps", "2000", "--burn-in", "500"]),
]


@pytest.mark.parametrize("twin,args", CASES,
                         ids=[m.__name__.rsplit(".", 1)[1] for m, _ in CASES])
def test_twin_passes_its_jax_script_asserts(twin, args):
    res = twin.main(["--cpu"] + args)
    assert res["ms_per_step"] > 0 and res["steps"] > 0


def test_fgsm_rebind_leaves_the_fused_route_with_its_parameters():
    res = fgsm.main(["--cpu", "--num-epoch", "2"])
    assert res["rebind"] == {"route_before": "MeshExecutorGroup",
                             "route_after": "DataParallelExecutorGroup",
                             "params_carried": True}


def test_mnist_mlp_sequential_stages_take_their_routes():
    res = mnist_mlp.main(["--cpu", "--num-epoch", "6"])
    first, second = res["module"]._modules
    assert type(first._exec_group).__name__ == "MeshExecutorGroup"
    assert type(second._exec_group).__name__ == "DataParallelExecutorGroup"
