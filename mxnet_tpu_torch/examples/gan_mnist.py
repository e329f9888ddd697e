"""A GAN on prototype data: the port's twin of ``example/gan/gan_mnist.py``.

    python -m mxnet_tpu_torch.examples.gan_mnist [--cpu]

The generator and the discriminator are two Modules. The discriminator
(``LogisticRegressionOutput``) is bound with ``inputs_need_grad=True``
(the classic route); the generator stays on the fused route and trains
through the discriminator's input gradients,
``gen.backward(dis.get_input_grads())``, which reuse the graph of the
forward whose outputs the discriminator read, two generator steps per
discriminator step. The data are the JAX script's droplets around 10
prototype vectors (``RandomState(0)``), and its asserts check the game's
health: the generator fooled the discriminator at some point (best
D(fake) above 0.15) and its best samples lie closer to the prototypes
than 0.95 of structureless noise. It trains on ``gpu(0)`` (or
``--gpus``/``--tpus``) unless ``--cpu`` is given; ``main(argv)``
returns the health numbers and the ms an iteration.
"""
import argparse
import logging

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.common import StepTimer, device_context


def make_generator(z_dim, out_dim):
    z = mx.sym.Variable("z")
    h = mx.sym.FullyConnected(z, num_hidden=64, name="g_fc1")
    h = mx.sym.Activation(h, act_type="relu")
    h = mx.sym.FullyConnected(h, num_hidden=out_dim, name="g_fc2")
    return mx.sym.Activation(h, act_type="tanh", name="g_out")


def make_discriminator(in_dim):
    x = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(x, num_hidden=32, name="d_fc1")
    h = mx.sym.LeakyReLU(h, act_type="leaky", slope=0.2)
    h = mx.sym.FullyConnected(h, num_hidden=1, name="d_fc2")
    return mx.sym.LogisticRegressionOutput(h, name="dloss")


def main(argv=None):
    parser = argparse.ArgumentParser(description="train a toy GAN")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--num-iter", type=int, default=500)
    parser.add_argument("--z-dim", type=int, default=8)
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card's id (one device)")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)
    mx.random.seed(0)      # the initializers

    out_dim = 16
    rng = np.random.RandomState(0)
    protos = np.tanh(rng.randn(10, out_dim).astype(np.float32))

    def real_batch():
        y = rng.randint(0, 10, args.batch_size)
        return np.clip(protos[y] +
                       0.05 * rng.randn(args.batch_size,
                                        out_dim).astype(np.float32),
                       -1, 1)

    gen = mx.mod.Module(make_generator(args.z_dim, out_dim),
                        data_names=("z",), label_names=(), context=ctx)
    gen.bind(data_shapes=[("z", (args.batch_size, args.z_dim))])
    gen.init_params(mx.initializer.Xavier())
    gen.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": args.lr})

    dis = mx.mod.Module(make_discriminator(out_dim),
                        label_names=("dloss_label",), context=ctx)
    dis.bind(data_shapes=[("data", (args.batch_size, out_dim))],
             label_shapes=[("dloss_label", (args.batch_size, 1))],
             inputs_need_grad=True)
    dis.init_params(mx.initializer.Xavier())
    dis.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": args.lr})

    ones = mx.nd.array(np.ones((args.batch_size, 1), np.float32), ctx=ctx)
    zeros = mx.nd.array(np.zeros((args.batch_size, 1), np.float32), ctx=ctx)

    def noise():
        return mx.nd.array(rng.randn(args.batch_size,
                                     args.z_dim).astype(np.float32), ctx=ctx)

    def fake_proto_dist(samples=8):
        """Mean L2 from generated samples to their nearest prototype,
        over several batches (one batch is too noisy for the checks)."""
        total = 0.0
        for _ in range(samples):
            gen.forward(mx.io.DataBatch(data=[noise()], label=[]),
                        is_train=False)
            f = gen.get_outputs()[0].asnumpy()
            d = np.linalg.norm(f[:, None, :] - protos[None, :, :], axis=2)
            total += float(d.min(axis=1).mean())
        return total / samples

    dist0 = fake_proto_dist()
    d_real = d_fake = 0.0
    best_dist = float("inf")
    best_d_fake = 0.0
    timer = StepTimer(ctx)

    for it in range(args.num_iter):
        with timer:
            z = noise()
            gen.forward(mx.io.DataBatch(data=[z], label=[]), is_train=True)
            fake = gen.get_outputs()[0]

            # --- discriminator step: real->1, fake->0 ------------------
            dis.forward(mx.io.DataBatch(
                data=[mx.nd.array(real_batch(), ctx=ctx)], label=[ones]),
                is_train=True)
            d_real = float(dis.get_outputs()[0].asnumpy().mean())
            dis.backward()
            dis.update()
            dis.forward(mx.io.DataBatch(data=[fake.copy()], label=[zeros]),
                        is_train=True)
            d_fake = float(dis.get_outputs()[0].asnumpy().mean())
            dis.backward()
            dis.update()

            # --- generator: D(fake)->1 through D's input grads, twice --
            for _ in range(2):
                gen.forward(mx.io.DataBatch(data=[z], label=[]),
                            is_train=True)
                fake = gen.get_outputs()[0]
                dis.forward(mx.io.DataBatch(data=[fake], label=[ones]),
                            is_train=True)
                dis.backward()
                gen.backward(dis.get_input_grads())
                gen.update()
            timer.steps += 1

        best_d_fake = max(best_d_fake, d_fake)
        if (it + 1) % 50 == 0:
            cur = fake_proto_dist()
            best_dist = min(best_dist, cur)
            if (it + 1) % 100 == 0:
                logging.info("iter %d  D(real)=%.3f  D(fake)=%.3f  "
                             "dist=%.3f", it + 1, d_real, d_fake, cur)

    dist1 = fake_proto_dist()
    best_dist = min(best_dist, dist1)
    # the structureless baseline: tanh-squashed gaussian samples
    cand = np.tanh(rng.randn(4096, out_dim).astype(np.float32))
    baseline = float(np.linalg.norm(
        cand[:, None, :] - protos[None, :, :], axis=2).min(axis=1).mean())
    print("final D(real)=%.3f D(fake)=%.3f  fake->proto dist "
          "%.3f -> %.3f (best %.3f, random baseline %.3f)"
          % (d_real, d_fake, dist0, dist1, best_dist, baseline))
    assert best_d_fake > 0.15, "generator never fools the discriminator"
    assert best_dist < baseline * 0.95, "fakes no better than noise"
    return {"best_d_fake": best_d_fake, "best_dist": best_dist,
            "baseline": baseline, "generator": gen,
            "ms_per_step": timer.ms_per_step, "steps": timer.steps}


if __name__ == "__main__":
    main()
