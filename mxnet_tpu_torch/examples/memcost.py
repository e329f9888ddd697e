"""The memory-cost trade of rematerialisation: the port's twin of
``example/memcost/memcost.py``.

    python -m mxnet_tpu_torch.examples.memcost [--cpu] [--depth 12]
        [--width 32] [--img 64] [--batch-size 64]

The reference's memonger re-plans the graph to trade compute for memory;
the JAX package and the port do it with about √N checkpointed segments
over the symbol evaluator (``executor._build_eval_segmented``, in the
port ``torch.utils.checkpoint``), surfaced as ``Module(remat=...)``.

Part 1 measures the evaluator directly: grad(sum(loss)) over a deep conv
net, plain against segmented. Part 2 drives the same knob through
``Module(remat=None|"full")`` end to end: one SGD step (a training
forward whose outputs are read, so the module keeps its graph, the
backward from that graph, and the update). The JAX script reads XLA's
compiled temp-buffer size, which on a TPU is the activations the forward
keeps for the backward. The port measures what the card holds, with
``torch.cuda.memory_allocated`` and ``max_memory_allocated`` above the
memory allocated before the step (after ``reset_peak_memory_stats``), as
``chip_smoke.py``'s precision phase does: the bytes the forward keeps
for the backward ("held", read when the forward returns) and the step's
peak. The peak also holds cuDNN's convolution workspace and the
backward's gradient buffers, which remat does not touch (PERF.md,
Findings), so the twin holds the JAX script's 0.6 to the held bytes and
reports the peak beside them. FLOPs come from
``telemetry.ProgramCounter`` (the recompute shows there). The JAX
script's asserts: segmentation adds more than 5% FLOPs in both parts,
and on an accelerator its memory falls below 0.6 of the plain one (on
the CPU no memory is measured). It runs on ``gpu(0)`` (or ``--gpus``/
``--tpus``) unless ``--cpu`` is given; ``main(argv)`` returns the
numbers.
"""
import argparse
import logging
import os

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples.common import device_context

# MXNET_BACKWARD_DO_MIRROR=1 would promote the remat=None baseline to
# 'full' and void the comparison
os.environ.pop("MXNET_BACKWARD_DO_MIRROR", None)


def deep_net(depth, width):
    body = mx.sym.Variable("data")
    for i in range(depth):
        body = mx.sym.Convolution(body, kernel=(3, 3), pad=(1, 1),
                                  num_filter=width, name="conv%d" % i)
        body = mx.sym.Activation(body, act_type="relu")
    body = mx.sym.Pooling(body, global_pool=True, kernel=(1, 1),
                          pool_type="avg")
    body = mx.sym.FullyConnected(mx.sym.Flatten(body), num_hidden=10,
                                 name="fc")
    return mx.sym.SoftmaxOutput(body, name="softmax")


def held_and_peak(forward, backward, ctx):
    """Run ``backward(forward())``: (bytes allocated when the forward
    returned, the peak over both; each above what was held before, None
    off the card)."""
    if ctx.device_type != "gpu":
        backward(forward())
        return None, None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kept = forward()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    backward(kept)
    torch.cuda.synchronize()
    return held, torch.cuda.max_memory_allocated() - base


def evaluator_footprint(net, args, segmented, ctx):
    """(held bytes, peak bytes, FLOPs) of grad(sum(loss)) over the
    evaluator."""
    from mxnet_tpu_torch.executor import _build_eval, _build_eval_segmented
    arg_names = net.list_arguments()
    shapes, _, _ = net.infer_shape(
        data=(args.batch_size, 3, args.img, args.img),
        softmax_label=(args.batch_size,))
    rng = np.random.RandomState(0)
    dev = ctx.torch_device()
    vals = [torch.from_numpy(rng.rand(*s).astype(np.float32) * 0.1).to(dev)
            for s in shapes]
    p_idx = [i for i, n in enumerate(arg_names)
             if n not in ("data", "softmax_label")]
    ev = _build_eval_segmented(net, "full") if segmented \
        else _build_eval(net)

    def forward():
        params = [vals[i].detach().requires_grad_(True) for i in p_idx]
        v = list(vals)
        for i, p in zip(p_idx, params):
            v[i] = p
        outs, _ = ev(v, [], True)
        return outs[0].sum(), params

    def backward(kept):
        return torch.autograd.grad(*kept)

    held, peak = held_and_peak(forward, backward, ctx)
    _, count = mx.telemetry.analyze_compiled(lambda: backward(forward()))
    return held, peak, count["flops"]


def module_step_footprint(net, args, remat, ctx):
    """(held bytes, peak bytes, FLOPs) of the fused Module train step
    under remat."""
    from mxnet_tpu_torch.io import DataBatch
    mod = mx.mod.Module(net, remat=remat, context=ctx)
    mod.bind(data_shapes=[("data", (args.batch_size, 3, args.img,
                                    args.img))],
             label_shapes=[("softmax_label", (args.batch_size,))])
    mod.init_params(mx.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd")
    rng = np.random.RandomState(0)
    b = DataBatch(
        data=[mx.nd.array(rng.rand(args.batch_size, 3, args.img,
                                   args.img).astype(np.float32), ctx=ctx)],
        label=[mx.nd.array(rng.randint(0, 10, args.batch_size)
                           .astype(np.float32), ctx=ctx)])

    def forward():
        # reading the outputs runs the training forward now, and the
        # module keeps its graph; backward(out_grads=) takes the
        # gradients from that graph (SoftmaxOutput ignores the head)
        mod.forward(b, is_train=True)
        out = mod.get_outputs()[0]
        out.wait_to_read()
        return [mx.nd.ones(out.shape, ctx=ctx)]

    def backward(heads):
        mod.backward(out_grads=heads)
        mod.update()
        mod.get_outputs()[0].wait_to_read()

    backward(forward())      # the first run: allocator and algorithms
    held, peak = held_and_peak(forward, backward, ctx)
    _, count = mx.telemetry.analyze_compiled(lambda: backward(forward()))
    return held, peak, count["flops"]


def main(argv=None):
    parser = argparse.ArgumentParser(description="remat memory trade")
    parser.add_argument("--depth", type=int, default=12)
    parser.add_argument("--width", type=int, default=32)
    parser.add_argument("--img", type=int, default=64)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--tpus", "--gpus", dest="tpus", default=None,
                        help="the card to run on (one id)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = device_context(args)
    card = ctx.device_type == "gpu"

    net = deep_net(args.depth, args.width)
    held_p, mem_p, fl_p = evaluator_footprint(net, args, False, ctx)
    held_s, mem_s, fl_s = evaluator_footprint(net, args, True, ctx)
    held_none, mm_none, fl_none = module_step_footprint(net, args, None, ctx)
    held_full, mm_full, fl_full = module_step_footprint(net, args, "full",
                                                        ctx)

    def mib(b):
        return "not measured" if b is None else "%.1f MiB" % (b / 2**20)

    print("segmented remat: evaluator held %s -> %s (peak %s -> %s), "
          "recompute flops +%.0f%%; Module(remat) train step held %s -> %s "
          "(peak %s -> %s), flops %.3g -> %.3g (%s)"
          % (mib(held_p), mib(held_s), mib(mem_p), mib(mem_s),
             100.0 * (fl_s / fl_p - 1), mib(held_none), mib(held_full),
             mib(mm_none), mib(mm_full), fl_none, fl_full,
             "card" if card else "cpu"))

    assert fl_s > fl_p * 1.05, "segmentation must add recompute flops"
    assert fl_full > fl_none * 1.05, \
        "Module(remat='full') must recompute in the train step"
    if card:
        assert held_s < 0.6 * held_p, \
            "segmented remat must shrink what the evaluator keeps"
        assert held_full < 0.6 * held_none, \
            "Module(remat='full') must shrink what the train step keeps"
    return {"evaluator": (held_p, held_s, mem_p, mem_s, fl_p, fl_s),
            "module": (held_none, held_full, mm_none, mm_full, fl_none,
                       fl_full)}


if __name__ == "__main__":
    main()
