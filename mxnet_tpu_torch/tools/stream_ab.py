"""Device times of the streaming kernels (copy and the rtc bodies) of this
checkout against another checkout's, in turns in one process.

    python -m mxnet_tpu_torch.tools.stream_ab --other build/parent \\
        [--other-copy '{"tile_bytes": 16}'] [--rounds 5]

run from the root of this checkout, with the other one unpacked below it
(``git archive <commit> | tar -x -C build/parent``). It loads the other
checkout's ``mxnet_tpu_torch`` under another name and builds its kernels
as that checkout does. Then, on one set of tensors per kernel, it reads
the device time (``bn_probe.graph_ms``: 20 calls in one CUDA graph) of
this checkout's kernel, the other's and the PyTorch call that computes
the same function, in turns, ``rounds`` times: the copy of the copy
probe's bf16 array (``kernels.copy.copy``, with ``--other-copy`` as the
other's keyword arguments) against ``copy_``, and each of the five rtc
bodies of ``chip_smoke.py`` at 32×256×56² float32
(``kernels.rtc.rtc_kernel``) against ``torch.add`` or ``torch.square``
where one call computes it. It prints one JSON line per kernel with every
reading, the medians, whether the two checkouts' outputs agree bit for
bit, and the card's ``nvidia-smi`` line; it fails unless both copies
equal their input. It needs a CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import torch

from ..base import MXNetError
from . import bn_probe

__all__ = ["load_checkout", "main"]

_RTC_SHAPE = (32, 256, 56, 56)


def load_checkout(path, name="other_mxnet_tpu_torch"):
    """The ``mxnet_tpu_torch`` package of the checkout at ``path``,
    imported as ``name``."""
    pkg = os.path.join(os.path.abspath(path), "mxnet_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    importlib.import_module(name + ".kernels.copy")
    importlib.import_module(name + ".kernels.rtc")
    return mod


def _turns(fns, rounds):
    """``rounds`` device-time readings of each callable of ``fns`` (a
    dict), read in turns; returns {name: [ms, ...]}."""
    got = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            got[k].append(bn_probe.graph_ms([fn] * bn_probe.GRAPH_CALLS)[0])
    return got


def _row(kernel, got, card, **extra):
    med = {k: statistics.median(v) for k, v in got.items()}
    return {"kernel": kernel, "device_ms": got, "median_ms": med,
            "this_over_other": med["this"] / med["other"], "card": card,
            **extra}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--other-copy", default="{}",
                    help="JSON keyword arguments of the other's copy")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise MXNetError("stream_ab: no CUDA card")
    import chip_smoke
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import copy as C
    from mxnet_tpu_torch.kernels import rtc as R
    other = load_checkout(args.other)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(bn_probe.COPY_SHAPE, device="cuda",
                    generator=gen).to(torch.bfloat16)
    outs = {k: torch.empty_like(x) for k in ("this", "other", "library")}
    kw = json.loads(args.other_copy)
    fns = {"this": lambda: C.copy(x, outs["this"]),
           "other": lambda: other.kernels.copy.copy(x, outs["other"], **kw),
           "library": lambda: outs["library"].copy_(x)}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    exact = all(torch.equal(o.view(torch.int16), x.view(torch.int16))
                for o in outs.values())
    print(json.dumps(_row("copy", _turns(fns, args.rounds), card,
                          other_kwargs=kw, bitwise_equal=exact)),
          flush=True)
    del x, outs

    for name, ins, outs_, body, _ in chip_smoke.RTC_BODIES:
        refs = [(i, mx.nd.zeros((1,), ctx=mx.cpu())) for i in ins + outs_]
        ck_this = mx.rtc.Rtc(name, refs[:len(ins)], refs[len(ins):],
                             body)._ck
        oref = [(i, other.nd.zeros((1,), ctx=other.cpu()))
                for i in ins + outs_]
        ck_other = other.rtc.Rtc(name, oref[:len(ins)], oref[len(ins):],
                                 body)._ck
        xs = [torch.randn(_RTC_SHAPE, device="cuda", generator=gen)
              for _ in ins]
        ys = {k: [torch.empty(_RTC_SHAPE, device="cuda") for _ in outs_]
              for k in ("this", "other")}
        fns = {"this": lambda: R.rtc_kernel(ck_this, xs, ys["this"]),
               "other": lambda: other.kernels.rtc.rtc_kernel(
                   ck_other, xs, ys["other"])}
        lib = chip_smoke.rtc_library(name)
        if lib is not None:
            fns["library"] = lambda fn=lib[1]: fn(*xs)
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b)
                   for a, b in zip(ys["this"], ys["other"]))
        print(json.dumps(_row("rtc:" + name, _turns(fns, args.rounds), card,
                              library=lib and lib[0],
                              bitwise_equal_to_other=same)), flush=True)
        del xs, ys
    if not exact:
        raise MXNetError("stream_ab: a copy differs from its input")
    return 0


if __name__ == "__main__":
    sys.exit(main())
