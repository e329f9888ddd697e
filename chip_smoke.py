#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (mxnet_tpu_torch) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's Triton kernels from the checkout's sources (Triton's
cache goes to the git-ignored ``build/triton``), then runs five phases,
each printing JSON lines, and fails (exit code != 0, no result line) if
any phase fails:

1. device: the card's name and power limit, torch/CUDA/Triton versions;
2. kernels: ``bn_fwd``/``bn_bwd`` against their plain PyTorch versions on
   the card at ResNet-50 shapes (batch 32) and a ragged one, in float32
   and bfloat16, with ReLU, fix_gamma and exact statistics on and off;
   repeat runs bit for bit identical; then, at every BatchNorm shape of a
   ResNet-50 step, the kernel's time, the plain version's, the time of
   the PyTorch call that computes the same function (a yardstick the port
   never calls) and the least time the card's memory rate allows;
3. main path: ResNet-50 (224², 1000 classes, batch 32, float32) through
   ``mx.mod.Module(context=mx.gpu(0))`` with SGD (lr 0.1, momentum 0.9,
   wd 1e-4, rescale 1/32): 5 forward_backward + update steps; the kernels'
   launch counts must be 51 per step each;
4. card vs CPU: one ResNet-50 forward_backward at batch 2 from identical
   weights on the card (kernels) and on the CPU (plain versions): softmax
   outputs and the gradients of fc1_weight, bn1_gamma,
   stage4_unit3_bn3_gamma and conv0_weight, and the same step on the card
   with the plain versions for scale;
5. the kernels line, the card's nvidia-smi line, and the result line.

Numerics: float32 means float32 here. TF32 is off for convolutions and
matrix products (``cudnn.allow_tf32 = False``, matmul precision
"highest"), as ``f32_precision`` requests full float32 in the JAX package.
It exits with an error, and prints no result, without a CUDA card or
outside a checkout of the repository.
"""
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores
EPS = 2e-5
BATCH = 32
STEPS = 5
BN_PER_STEP = 51               # BatchNorms in ResNet-50, 50 fused with ReLU
TOL = {
    # f32 outputs (y, dx): 1e-5 of the output's max-abs — the kernel's fma
    # and rsqrt round differently from the plain version by an ulp or two
    "f32_out": 1e-5,
    # per-channel reductions (mean, var, dβ, dγ): 1e-4 of the max-abs — the
    # two sum the same terms in another order
    "reduction": 1e-4,
    # bf16 outputs: 1 ulp of bfloat16 (2^-7 of the larger magnitude), plus
    # 1e-6 absolute for values that round to zero on one side only
    "bf16_rel": 2.0 ** -7,
    "bf16_abs": 1e-6,
    # share of elements allowed outside the tolerance: ReLU-mask flips.
    # Both sides round x·scale + shift once, so none are expected.
    "flip_fraction": 1e-6,
    # card vs CPU, ResNet-50 at batch 2, as relative L2 error
    # ‖card − cpu‖/‖cpu‖. The softmax outputs, and the gradients one
    # layer below them (fc1_weight, bn1_gamma), agree to ~1e-5; 1e-4.
    # Gradients 50 BatchNorms deep (conv0_weight) and the last unit's
    # stage4_unit3_bn3_gamma move by 1e-2 between cuDNN's and the CPU's
    # float32 convolutions, by the same amount whether the card runs the
    # kernels or the plain versions (measured on an H100); 5e-2.
    "cpu_top": 1e-4,
    "cpu_deep": 5e-2,
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_time(fn, reps=20, warm=3):
    """Median milliseconds of ``fn`` on the card (CUDA events, one pair per
    repetition, after ``warm`` untimed calls)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def bn_inputs(shape, dtype, gen):
    import torch
    C = shape[1]
    dev = "cuda"
    x = (torch.randn(shape, device=dev, generator=gen) * 2.0 + 0.5).to(dtype)
    gamma = torch.rand(C, device=dev, generator=gen) + 0.5
    beta = torch.randn(C, device=dev, generator=gen) * 0.1
    c = torch.randn(C, device=dev, generator=gen) * 0.1
    du = torch.randn(shape, device=dev, generator=gen).to(dtype)
    return x, gamma, beta, c, du


def compare_outputs(kern, plain, dtype):
    """(max abs error, elements outside tolerance) of an activation-shaped
    output."""
    import torch
    k, p = kern.float(), plain.float()
    err = (k - p).abs()
    if dtype == torch.float32:
        bad = err > TOL["f32_out"] * float(p.abs().max())
    else:
        bad = err > TOL["bf16_rel"] * torch.maximum(k.abs(), p.abs()) \
            + TOL["bf16_abs"]
    return float(err.max()), int(bad.sum())


def reduction_error(kern, plain):
    rel = float((kern - plain).abs().max()) / max(float(plain.abs().max()),
                                                  1e-30)
    return rel


def check_kernels(K):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_flags = [(True, False, False), (False, True, False)]
    full_flags = [(r, f, e) for r in (True, False) for f in (True, False)
                  for e in (True, False)]
    grid = [((BATCH, 3, 224, 224), main_flags),
            ((BATCH, 64, 112, 112), main_flags),
            ((BATCH, 256, 56, 56), full_flags),
            ((BATCH, 512, 28, 28), main_flags),
            ((BATCH, 2048, 7, 7), main_flags),
            ((5, 3, 17, 13), full_flags)]
    worst = {"bn_fwd": 0.0, "bn_bwd": 0.0}
    failures = []
    for shape, flags in grid:
        for dtype in (torch.float32, torch.bfloat16):
            for relu, fix_gamma, exact in flags:
                x, gamma, beta, c, du = bn_inputs(shape, dtype, gen)
                kf = K.bn_fwd(x, gamma, beta, c, EPS, fix_gamma, relu, exact)
                pf = K.bn_fwd_plain(x, gamma, beta, c, EPS, fix_gamma, relu,
                                    exact)
                # both backwards from the plain forward's statistics
                _, mean, _, rstd, scale, shift = pf
                kb = K.bn_bwd(du, x, rstd, mean, scale, shift, relu)
                pb = K.bn_bwd_plain(du, x, rstd, mean, scale, shift, relu)
                torch.cuda.synchronize()
                y_err, y_bad = compare_outputs(kf[0], pf[0], dtype)
                dx_err, dx_bad = compare_outputs(kb[0], pb[0], dtype)
                red = max([reduction_error(a, b)
                           for a, b in zip(kf[1:], pf[1:])] +
                          [reduction_error(a, b)
                           for a, b in zip(kb[1:], pb[1:])])
                allowed = int(TOL["flip_fraction"] * x.numel())
                row = {"phase": "kernels", "shape": list(shape),
                       "dtype": str(dtype).replace("torch.", ""),
                       "relu": relu, "fix_gamma": fix_gamma, "exact": exact,
                       "y_max_abs_err": y_err, "y_outside": y_bad,
                       "dx_max_abs_err": dx_err, "dx_outside": dx_bad,
                       "reduction_rel_err": red}
                ok = (y_bad <= allowed and dx_bad <= allowed
                      and red <= TOL["reduction"])
                row["ok"] = ok
                emit(row)
                if not ok:
                    failures.append(row)
                if dtype == torch.float32:
                    worst["bn_fwd"] = max(worst["bn_fwd"], y_err)
                    worst["bn_bwd"] = max(worst["bn_bwd"], dx_err)
    # repeat runs are bit for bit identical (no atomics)
    x, gamma, beta, c, du = bn_inputs((BATCH, 64, 112, 112), torch.float32,
                                      gen)
    a = K.bn_fwd(x, gamma, beta, c, EPS, False, True, False)
    b = K.bn_fwd(x, gamma, beta, c, EPS, False, True, False)
    ga = K.bn_bwd(du, x, a[3], a[1], a[4], a[5], True)
    gb = K.bn_bwd(du, x, a[3], a[1], a[4], a[5], True)
    same = all(torch.equal(u, v) for u, v in zip(a + ga, b + gb))
    emit({"phase": "kernels", "repeat_runs_bitwise_equal": same})
    if failures or not same:
        raise RuntimeError("kernel check failed: %d case(s) out of "
                           "tolerance, repeat-equal=%s" % (len(failures),
                                                           same))
    return worst


def resnet50_bn_shapes(mx, batch):
    """Counter of (input shape, fix_gamma, relu) over the 51 BatchNorms of
    ResNet-50 after the BN+ReLU fusion."""
    from mxnet_tpu_torch.executor import fuse_bn_relu
    sym = fuse_bn_relu(mx.models.get_symbol("resnet-50", num_classes=1000,
                                            image_shape=(3, 224, 224)))
    internals = sym.get_internals()
    _, out_shapes, _ = internals.infer_shape(data=(batch, 3, 224, 224),
                                             softmax_label=(batch,))
    shape_of = dict(zip(internals.list_outputs(), out_shapes))
    counts = {}
    for n in sym._topo():
        if n.op is None or n.op.name != "BatchNorm":
            continue
        src, oi = n.inputs[0]
        key = src.name if src.op is None else \
            "%s_%s" % (src.name, src.op.list_outputs(src.attrs)[oi])
        k = (tuple(shape_of[key]), bool(n.attrs.get("fix_gamma", True)),
             bool(n.attrs.get("_fused_relu", False)))
        counts[k] = counts.get(k, 0) + 1
    return counts


def time_kernels(K, counts):
    """Per-shape and per-step times of both kernels, their plain versions
    and the PyTorch yardsticks (float32, the main path's flags)."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1)
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0} for k in ("bn_fwd", "bn_bwd")}
    for (shape, fix_gamma, relu), n in sorted(counts.items()):
        x, gamma, beta, c, du = bn_inputs(shape, torch.float32, gen)
        numel, C = x.numel(), shape[1]
        st = K.bn_fwd(x, gamma, beta, c, EPS, fix_gamma, relu, False)
        _, mean, _, rstd, scale, shift = st
        g = torch.ones_like(gamma) if fix_gamma else gamma

        def lib_fwd():
            y = F.batch_norm(x, None, None, g, beta, training=True, eps=EPS)
            return F.relu(y, inplace=True) if relu else y

        _, smean, sinv = torch.ops.aten.native_batch_norm(
            x, g, beta, None, None, True, 0.1, EPS)

        def lib_bwd():
            return torch.ops.aten.native_batch_norm_backward(
                du, x, g, None, None, smean, sinv, True, EPS,
                [True, True, True])

        fwd = {
            "ms": cuda_time(lambda: K.bn_fwd(x, gamma, beta, c, EPS,
                                             fix_gamma, relu, False)),
            "plain_ms": cuda_time(lambda: K.bn_fwd_plain(
                x, gamma, beta, c, EPS, fix_gamma, relu, False), reps=5),
            "library_ms": cuda_time(lib_fwd),
            # read x, write y; ~7 float32 operations an element
            "bound_ms": 1e3 * max(2 * numel * 4 / HBM_BYTES_PER_S,
                                  7 * numel / F32_FLOPS_PER_S),
        }
        bwd = {
            "ms": cuda_time(lambda: K.bn_bwd(du, x, rstd, mean, scale, shift,
                                             relu)),
            "plain_ms": cuda_time(lambda: K.bn_bwd_plain(
                du, x, rstd, mean, scale, shift, relu), reps=5),
            "library_ms": cuda_time(lib_bwd),
            # read x and du, write dx; ~16 float32 operations an element
            "bound_ms": 1e3 * max(3 * numel * 4 / HBM_BYTES_PER_S,
                                  16 * numel / F32_FLOPS_PER_S),
        }
        emit({"phase": "kernel_times", "shape": list(shape),
              "fix_gamma": fix_gamma, "relu": relu, "per_step": n,
              "bn_fwd": fwd, "bn_bwd": bwd})
        for name, t in (("bn_fwd", fwd), ("bn_bwd", bwd)):
            for key in tot[name]:
                tot[name][key] += n * t[key]
        del x, du, st
    return tot


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------
def resnet50_module(mx, ctx, batch, arg_params=None, aux_params=None):
    sym = mx.models.get_symbol("resnet-50", num_classes=1000,
                               image_shape=(3, 224, 224))
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", (batch, 3, 224, 224))],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2), arg_params=arg_params,
                    aux_params=aux_params)
    return mod


def synthetic_batch(mx, ctx, batch, seed):
    import numpy as np
    rs = np.random.RandomState(seed)
    x = rs.randn(batch, 3, 224, 224).astype(np.float32)
    y = rs.randint(0, 1000, (batch,)).astype(np.float32)
    return mx.io.DataBatch([mx.nd.array(x, ctx=ctx)],
                           [mx.nd.array(y, ctx=ctx)])


def main_path(mx, K, card):
    import numpy as np
    import torch
    mx.random.seed(0)
    ctx = mx.gpu(0)
    mod = resnet50_module(mx, ctx, BATCH)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
        "rescale_grad": 1.0 / BATCH})
    batch = synthetic_batch(mx, ctx, BATCH, seed=0)
    before = {k: mod.get_params()[0][k].asnumpy()
              for k in ("conv0_weight", "fc1_weight")}
    torch.cuda.synchronize()
    K.bn_fwd.launches = 0
    K.bn_bwd.launches = 0
    step_ms = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = {"bn_fwd": K.bn_fwd.launches, "bn_bwd": K.bn_bwd.launches}
    out = mod.get_outputs()[0].asnumpy()
    args, aux = mod.get_params()
    finite = bool(np.isfinite(out).all()) and all(
        np.isfinite(v.asnumpy()).all()
        for v in list(args.values()) + list(aux.values()))
    changed = all(not np.array_equal(before[k], args[k].asnumpy())
                  for k in before)
    ms = statistics.median(step_ms[1:])
    row = {"phase": "main_path", "model": "resnet-50", "image": [3, 224, 224],
           "classes": 1000, "batch": BATCH, "dtype": "float32",
           "steps": STEPS, "step_ms": step_ms, "ms_per_step": ms,
           "img_per_s": BATCH / (ms / 1e3), "launches": launches,
           "outputs_shape": list(out.shape), "finite": finite,
           "params_changed": changed, "card": card}
    emit(row)
    want = BN_PER_STEP * STEPS
    if not (finite and changed and out.shape == (BATCH, 1000)
            and launches == {"bn_fwd": want, "bn_bwd": want}):
        raise RuntimeError("main path failed: %s" % json.dumps(row))
    return launches


def card_vs_cpu(mx, K):
    """One ResNet-50 forward_backward at batch 2 from identical weights, on
    the card (kernels) and on the CPU (plain versions). The card also runs
    it with the plain versions in place of the kernels, which shows how
    far the card's own rounding moves each gradient. bn0_gamma is reported
    and not held to a limit: its gradient is a sum that cancels to ~1e-4
    of its terms, so rounding alone moves it by several percent."""
    import numpy as np
    from mxnet_tpu_torch.ops import nn as nn_ops
    mx.random.seed(1)
    cpu_mod = resnet50_module(mx, mx.cpu(), 2)
    args, aux = cpu_mod.get_params()
    limits = {"out": TOL["cpu_top"], "fc1_weight": TOL["cpu_top"],
              "bn1_gamma": TOL["cpu_top"],
              "stage4_unit3_bn3_gamma": TOL["cpu_deep"],
              "conv0_weight": TOL["cpu_deep"], "bn0_gamma": None}

    def run(mod, ctx):
        mod.forward_backward(synthetic_batch(mx, ctx, 2, seed=5))
        grads = dict(zip(mod._param_names, mod._exec_group.grad_arrays))
        res = {k: grads[k][0].asnumpy() for k in limits if k != "out"}
        res["out"] = mod.get_outputs()[0].asnumpy()
        return res

    res = {"cpu": run(cpu_mod, mx.cpu()),
           "card": run(resnet50_module(mx, mx.gpu(0), 2, arg_params=args,
                                       aux_params=aux), mx.gpu(0))}
    nn_ops.bn_fwd, nn_ops.bn_bwd = K.bn_fwd_plain, K.bn_bwd_plain
    try:
        res["card_plain"] = run(resnet50_module(
            mx, mx.gpu(0), 2, arg_params=args, aux_params=aux), mx.gpu(0))
    finally:
        nn_ops.bn_fwd, nn_ops.bn_bwd = K.bn_fwd, K.bn_bwd

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    row = {"phase": "card_vs_cpu", "batch": 2}
    ok = True
    for k, lim in limits.items():
        a, b = res["card"][k], res["cpu"][k]
        row[k] = {"rel_l2_err": rel(a, b), "limit": lim,
                  "card_plain_vs_cpu": rel(res["card_plain"][k], b),
                  "card_vs_card_plain": rel(a, res["card_plain"][k])}
        ok = ok and bool(np.isfinite(a).all()) and \
            (lim is None or rel(a, b) <= lim)
    row["ok"] = ok
    emit(row)
    if not ok:
        raise RuntimeError("card and CPU disagree: %s" % json.dumps(row))


def main():
    t_start = time.time()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch.kernels import batchnorm as K
    except ImportError as e:
        print("chip_smoke: run from a checkout of the repository (%s)" % e,
              file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    import triton
    card = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "triton": triton.__version__,
          "python": sys.version.split()[0]})

    worst = check_kernels(K)
    totals = time_kernels(K, resnet50_bn_shapes(mx, BATCH))
    emit({"phase": "kernel_times_per_step", "batch": BATCH,
          "card": card, **totals})
    launches = main_path(mx, K, card)
    card_vs_cpu(mx, K)

    src = "mxnet_tpu_torch/kernels/batchnorm_triton.py"
    replaces = {"bn_fwd": "mxnet_tpu/ops/nn.py:460",
                "bn_bwd": "tools/bn_pallas_probe.py:76"}
    kernels = [dict(name=k, route="triton", source=src,
                    replaces=replaces[k], launches=launches[k],
                    max_abs_err=worst[k], bound_by="bytes", **totals[k])
               for k in ("bn_fwd", "bn_bwd")]
    emit({"phase": "done", "seconds": time.time() - t_start})
    print(card)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
