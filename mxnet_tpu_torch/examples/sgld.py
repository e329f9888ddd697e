"""Stochastic gradient Langevin dynamics: the port's twin of
``example/bayesian-methods/sgld.py``.

    python -m mxnet_tpu_torch.examples.sgld [--cpu]

Bayesian linear regression with a known Gaussian posterior (the JAX
script's data, ``RandomState(0)``): the negative log posterior is a
``MakeLoss`` symbol, and ``optimizer="sgld"`` (noise of variance lr a
step, drawn from the port's key path) samples the weights. The JAX
script's asserts: after burn-in the samples' mean lies within 0.05 of
the analytic posterior mean and their total variance within a factor 3
of the posterior's (plain SGD would collapse it). It trains on ``gpu(0)``
(or ``--gpus``/``--tpus``) unless ``--cpu`` is given; ``main(argv)``
returns both numbers and the ms a step.
"""
import argparse
import logging

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.common import StepTimer, device_context


def main(argv=None):
    parser = argparse.ArgumentParser(description="SGLD posterior")
    parser.add_argument("--steps", type=int, default=4000)
    parser.add_argument("--burn-in", type=int, default=1000)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card's id (one device)")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)
    mx.random.seed(0)      # the initializer and the Langevin noise

    rng = np.random.RandomState(0)
    dim, n = 3, 512
    sigma = 0.5          # observation noise
    tau = 1.0            # prior std on w
    w_true = rng.randn(dim).astype(np.float32)
    X = rng.randn(n, dim).astype(np.float32)
    y = X @ w_true + sigma * rng.randn(n).astype(np.float32)

    # the analytic posterior N(mu, Sigma):
    # Sigma = (X^T X / sigma^2 + I/tau^2)^-1, mu = Sigma X^T y / sigma^2
    Sigma = np.linalg.inv(X.T @ X / sigma**2 + np.eye(dim) / tau**2)
    mu = Sigma @ X.T @ y / sigma**2

    # the unnormalised negative log posterior; the batch mean is scaled
    # to the whole dataset, so rescale_grad stays 1
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("label")
    pred = mx.sym.FullyConnected(data, num_hidden=1, no_bias=True,
                                 name="w")
    nll = mx.sym.mean(mx.sym.square(mx.sym.Reshape(pred, shape=(-1,))
                                    - label))
    loss = mx.sym.MakeLoss(mx.sym._mul_scalar(
        nll, scalar=n / (2.0 * sigma**2)))

    mod = mx.mod.Module(loss, label_names=("label",), context=ctx)
    mod.bind(data_shapes=[("data", (args.batch_size, dim))],
             label_shapes=[("label", (args.batch_size,))])
    mod.init_params(mx.initializer.Normal(0.5))
    # the prior enters as L2 with lambda = 1/tau^2; SGLD's update is
    # w -= lr/2 * grad(U) + N(0, lr)
    mod.init_optimizer(optimizer="sgld",
                       optimizer_params={"learning_rate": 2e-4,
                                         "wd": 1.0 / tau**2,
                                         "rescale_grad": 1.0})

    samples = []
    timer = StepTimer(ctx)
    with timer:
        for t in range(args.steps):
            idx = rng.randint(0, n, args.batch_size)
            b = mx.io.DataBatch(data=[mx.nd.array(X[idx], ctx=ctx)],
                                label=[mx.nd.array(y[idx], ctx=ctx)])
            mod.forward_backward(b)
            mod.update()
            if t >= args.burn_in and t % 2 == 0:
                samples.append(
                    mod.get_params()[0]["w_weight"].asnumpy().ravel().copy())
            if (t + 1) % 1000 == 0:
                logging.info("step %d  current w %s", t + 1,
                             np.round(samples[-1], 3) if samples else "-")
    timer.steps = args.steps

    S = np.asarray(samples)
    mean_err = np.abs(S.mean(axis=0) - mu).max()
    var_ratio = S.var(axis=0).sum() / np.trace(Sigma)
    print("posterior mean err %.4f (prior->post shrink ok), "
          "variance ratio %.2f (1.0 = exact)" % (mean_err, var_ratio))
    assert mean_err < 0.05, "SGLD mean should match analytic posterior"
    assert 0.3 < var_ratio < 3.0, \
        "SGLD spread should match the posterior (SGD would give ~0)"
    return {"mean_err": float(mean_err), "var_ratio": float(var_ratio),
            "ms_per_step": timer.ms_per_step, "steps": timer.steps}


if __name__ == "__main__":
    main()
