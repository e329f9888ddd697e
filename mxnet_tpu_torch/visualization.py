"""Network visualization (PyTorch counterpart of
``mxnet_tpu/visualization.py``), exported as ``mx.viz``:
``print_summary`` prints the layer table (name and op, output shape,
trainable parameters, inputs) and ``plot_network`` returns a graphviz
``Source``, or the DOT text when graphviz is not installed.
"""
from __future__ import annotations

import json

from .symbol import Symbol

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape=None, line_length=120, positions=(.44, .64,
                                                                  .74, 1.)):
    """Print the layer table; with ``shape`` (input name -> shape) it
    shows output shapes and counts the parameters."""
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be Symbol")
    show_shape = False
    shape_dict = {}
    if shape is not None:
        show_shape = True
        interals = symbol.get_internals()
        _, out_shapes, _ = interals.infer_shape(**shape)
        if out_shapes is None:
            raise ValueError("Input shape is incomplete")
        shape_dict = dict(zip(interals.list_outputs(), out_shapes))
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    aux_names = set(symbol.list_auxiliary_states())
    counted = set()  # variable node ids already attributed (weight tying)

    if positions[-1] <= 1:
        positions = [int(line_length * p) for p in positions]
    to_display = ["Layer (type)", "Output Shape", "Param #",
                  "Previous Layer"]

    def print_row(fields, positions):
        line = ""
        for i, field in enumerate(fields):
            line += str(field)
            line = line[:positions[i]]
            line += " " * (positions[i] - len(line))
        print(line)

    print("_" * line_length)
    print_row(to_display, positions)
    print("=" * line_length)

    total_params = 0

    def print_layer_summary(node, out_shape):
        op = node["op"]
        pre_node = []
        if op != "null":
            inputs = node["inputs"]
            for item in inputs:
                input_node = nodes[item[0]]
                input_name = input_node["name"]
                if input_node["op"] != "null" or item[0] in heads:
                    pre_node.append(input_name)
        nonlocal total_params
        cur_param = 0
        if op != "null":
            for item in node["inputs"]:
                input_node = nodes[item[0]]
                # trainable parameters only: skip data/labels, BN moving
                # stats (auxiliary states), and variables already counted
                # at another consumer (weight tying)
                if input_node["op"] == "null" and \
                        not input_node["name"].endswith("label") and \
                        input_node["name"] != "data" and \
                        input_node["name"] not in aux_names and \
                        item[0] not in counted:
                    # a variable's internal output is named either bare
                    # or with the _output suffix depending on position
                    vshape = shape_dict.get(input_node["name"]) or \
                        shape_dict.get(input_node["name"] + "_output")
                    if vshape:
                        counted.add(item[0])
                        n = 1
                        for d in vshape:
                            n *= int(d)
                        cur_param += n
        total_params += cur_param
        name = node["name"]
        first_connection = "" if not pre_node else pre_node[0]
        fields = ["%s(%s)" % (name, op), str(out_shape), cur_param,
                  first_connection]
        print_row(fields, positions)
        for i in range(1, len(pre_node)):
            fields = ["", "", "", pre_node[i]]
            print_row(fields, positions)

    heads = set(h[0] for h in conf["heads"])
    for node in nodes:
        out_shape = None
        op = node["op"]
        if op != "null":
            key = node["name"] + "_output"
            if show_shape and key in shape_dict:
                out_shape = shape_dict[key]
        print_layer_summary(node, out_shape)
    print("=" * line_length)
    if show_shape:
        print("Total params: {:,}".format(total_params))
        print("_" * line_length)


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """The network as a graphviz ``Source`` (DOT text without graphviz);
    ``hide_weights`` leaves out the parameter and aux variables."""
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    hidden = set()
    if hide_weights:
        for node in nodes:
            if node["op"] == "null" and (
                    node["name"].endswith("_weight")
                    or node["name"].endswith("_bias")
                    or node["name"].endswith("_gamma")
                    or node["name"].endswith("_beta")
                    or node["name"].endswith("_moving_mean")
                    or node["name"].endswith("_moving_var")):
                hidden.add(node["name"])

    lines = ["digraph %s {" % title.replace(" ", "_")]
    for i, node in enumerate(nodes):
        if node["name"] in hidden:
            continue
        label = node["name"] if node["op"] == "null" else \
            "%s\\n%s" % (node["op"], node["name"])
        shape_attr = "oval" if node["op"] == "null" else "box"
        lines.append('  n%d [label="%s", shape=%s];' % (i, label, shape_attr))
    for i, node in enumerate(nodes):
        for item in node.get("inputs", []):
            src = nodes[item[0]]
            if src["name"] in hidden:
                continue
            lines.append("  n%d -> n%d;" % (item[0], i))
    lines.append("}")
    dot_src = "\n".join(lines)
    try:
        from graphviz import Source
        return Source(dot_src, format=save_format)
    except ImportError:
        return dot_src
