"""Where a net's eval outputs start to depend on the batch size.

``batch_parity(mod, x, batches)`` runs the eval forward of every node of
``mod``'s bound symbol (after the BN+ReLU fusion, as the executor group
binds it) on the same rows ``x[:b]`` at each batch size ``b`` of
``batches``, on ``mod``'s parameters and device, and compares each
node's rows with those of the largest batch. It returns, per batch size,
the first node in topological order whose rows are not bit for bit
equal, that node's max abs and relative difference, and the same for the
net's outputs. A convolution or matrix product whose library picks
another algorithm at another batch size shows up as the first such node.
"""
from __future__ import annotations

import numpy as onp

from .. import ndarray as nd
from ..executor import fuse_bn_relu

__all__ = ["node_outputs", "batch_parity"]


def node_outputs(mod, x):
    """name -> numpy rows of every op node's eval outputs on ``x``, in
    topological order, on ``mod``'s parameters and device."""
    sym = fuse_bn_relu(mod.symbol).get_internals()
    args, aux = mod.get_params()
    ctx = mod._context[0]
    shapes = dict([(n, x.shape) for n in mod.data_names] +
                  [(n, (x.shape[0],)) for n in mod.label_names])
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    arrays = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in args:
            arrays[name] = args[name].copyto(ctx)
        elif name in mod.data_names:
            arrays[name] = nd.array(x, ctx=ctx)
        else:
            arrays[name] = nd.zeros(shape, ctx=ctx)
    aux_arrays = {n: aux[n].copyto(ctx) for n in sym.list_auxiliary_states()}
    ex = sym.bind(ctx, arrays, grad_req="null", aux_states=aux_arrays)
    outs = ex.forward(is_train=False)
    names = sym.list_outputs()
    inputs = set(sym.list_arguments()) | set(sym.list_auxiliary_states())
    return {n: o.asnumpy() for n, o in zip(names, outs) if n not in inputs}


def _diff(a, b):
    err = float(onp.abs(a - b).max()) if a.size else 0.0
    return err, err / max(float(onp.abs(b).max()) if b.size else 0.0, 1e-30)


def batch_parity(mod, x, batches):
    """Per batch size ``b`` (rows ``x[:b]``) against the largest: the
    first node whose rows differ and by how much, and the outputs'
    max abs / relative difference."""
    batches = sorted(batches, reverse=True)
    ref = node_outputs(mod, x[:batches[0]])
    out_name = mod.symbol.list_outputs()[0]
    rows = []
    for b in batches[1:]:
        got = node_outputs(mod, x[:b])
        first = None
        for name, val in got.items():
            if not onp.array_equal(val, ref[name][:b]):
                err, rel = _diff(val, ref[name][:b])
                first = {"node": name, "max_abs": err, "rel": rel}
                break
        err, rel = _diff(got[out_name], ref[out_name][:b])
        rows.append({"batch": b, "against": batches[0],
                     "first_differing_node": first,
                     "output_max_abs": err, "output_rel": rel,
                     "nodes": len(got)})
    return rows
