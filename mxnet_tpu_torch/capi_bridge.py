"""Python side of the port's C ABI boundary (``capi/c_api.cpp`` of this
package embeds CPython and calls these; the port's counterpart of
``mxnet_tpu/capi_bridge.py``). Each function takes and returns only
simple types, NDArray/Symbol/Executor objects (opaque handles on the C
side), lists and memoryviews; the C++ layer owns handle lifetime, GIL
transitions, buffer copies and error propagation (reference:
src/c_api/c_api.cc over the C++ core; here the core the C API fronts is
the port itself). ``dev_type`` 2 is the card (``gpu``), 1 the CPU.
Arrays the ABI makes without a device (raw bytes, ``.nd`` lists, a C
custom op's buffers) are host arrays: CPU NDArrays.
"""
from __future__ import annotations

import json
import os

import numpy as onp
import torch

from . import ndarray as nd
from . import symbol as sym
from .context import Context, cpu
from .registry import get_op, list_ops

_DTYPE_CODE = {0: "float32", 1: "float64", 2: "float16", 3: "uint8",
               4: "int32", 5: "int8", 6: "int64"}
_CODE_DTYPE = {v: k for k, v in _DTYPE_CODE.items()}


def _ctx(dev_type, dev_id):
    # dev_type codes: 1=cpu, 2=gpu (the card), 3=cpu_pinned (base.h Context)
    return Context({1: "cpu", 2: "gpu", 3: "cpu_pinned"}.get(dev_type, "cpu"),
                   dev_id)


# ------------------------------------------------------------------ ndarray
def ndarray_create(shape, dev_type, dev_id, dtype_code=0):
    return nd.zeros(tuple(int(s) for s in shape), ctx=_ctx(dev_type, dev_id),
                    dtype=_DTYPE_CODE[dtype_code])


def ndarray_shape(arr):
    return [int(s) for s in arr.shape]


def ndarray_dtype_code(arr):
    return _CODE_DTYPE.get(str(onp.dtype(arr.dtype)), 0)


def ndarray_context(arr):
    code = {"cpu": 1, "tpu": 2, "gpu": 2, "cpu_pinned": 3}
    return code.get(arr.context.device_type, 1), arr.context.device_id


def ndarray_copy_from(arr, mv):
    # MUST copy out of the foreign buffer before the call returns: the
    # ABI contract is a synchronous copy (MXNDArraySyncCopyFromCPU), and a
    # copy to the card may still read its source after ``copy_`` returns
    src = onp.frombuffer(mv, dtype=arr.dtype, count=int(arr.size)).copy()
    arr._write(torch.from_numpy(src.reshape(arr.shape)))


def ndarray_copy_to(arr):
    return onp.ascontiguousarray(arr.asnumpy()).tobytes()


def ndarray_save(fname, arrs, keys):
    nd.save(fname, dict(zip(keys, arrs)) if keys else list(arrs))


def ndarray_load(fname):
    data = nd.load(fname, ctx=cpu())
    if isinstance(data, dict):
        names = list(data.keys())
        return [data[n] for n in names], names
    return list(data), []


# ------------------------------------------------------------------ invoke
def imperative_invoke(op_name, inputs, keys, vals, out=None):
    op = get_op(op_name)
    res = nd.invoke(op, list(inputs), dict(zip(keys, vals)),
                    out=list(out) if out else None)
    return list(res) if isinstance(res, (list, tuple)) else [res]


def all_op_names():
    return list_ops()


# ------------------------------------------------------------------ symbol
def symbol_create_atomic(op_name, keys, vals):
    fn = getattr(sym, op_name)
    attrs = {k: v for k, v in zip(keys, vals)}
    name = attrs.pop("name", None)
    return fn(name=name, **attrs) if name else fn(**attrs)


def symbol_compose(s, name, keys, args):
    """nnvm Symbol::Compose semantics. Atomic-head keyword names (the op's
    argument names, data/weight/...) are translated to placeholder
    variables by Symbol._compose itself (symbol.py)."""
    if keys:
        s._compose(name=name or None, **dict(zip(keys, args)))
    else:
        s._compose(*args, name=name or None)
    return s


def symbol_list(s, which):
    if which == "arguments":
        return s.list_arguments()
    if which == "outputs":
        return s.list_outputs()
    return s.list_auxiliary_states()


# ---------------------------------------------------------------- executor
def executor_bind(s, dev_type, dev_id, in_args, arg_grads, grad_reqs,
                  aux_states):
    ctx = _ctx(dev_type, dev_id)
    req_map = {0: "null", 1: "write", 2: "write", 3: "add"}
    arg_names = s.list_arguments()
    args = dict(zip(arg_names, in_args))
    grads = {n: g for n, g in zip(arg_names, arg_grads) if g is not None}
    reqs = {n: req_map[int(r)] for n, r in zip(arg_names, grad_reqs)}
    aux_names = s.list_auxiliary_states()
    return s.bind(ctx, args, args_grad=grads or None, grad_req=reqs,
                  aux_states=dict(zip(aux_names, aux_states)) or None)


def executor_forward(e, is_train):
    e.forward(is_train=bool(is_train))


def executor_backward(e, head_grads):
    e.backward(list(head_grads) if head_grads else None)


def executor_outputs(e):
    return list(e.outputs)


# ------------------------------------------------------------ predict API
class _Predictor(object):
    def __init__(self, json_str, param_blob, dev_type, dev_id,
                 input_names, input_shapes):
        import os
        import tempfile
        net = sym.load_json(json_str)
        params = {}
        if param_blob:
            fd, path = tempfile.mkstemp(suffix=".params")
            os.close(fd)
            try:
                with open(path, "wb") as f:
                    f.write(param_blob)
                loaded = nd.load(path, ctx=cpu())
            finally:
                os.unlink(path)
            for k, v in (loaded.items() if isinstance(loaded, dict) else []):
                # strip the arg:/aux: prefixes of save_checkpoint
                params[k.split(":", 1)[-1]] = v
        ctx = _ctx(dev_type, dev_id)
        shapes = dict(zip(input_names, [tuple(s) for s in input_shapes]))
        self.exe = net.simple_bind(ctx, grad_req="null", **shapes)
        for name, arr in self.exe.arg_dict.items():
            if name in params:
                params[name].copyto(arr)
        for name, arr in self.exe.aux_dict.items():
            if name in params:
                params[name].copyto(arr)
        self.input_names = list(input_names)

    def set_input(self, key, mv):
        arr = self.exe.arg_dict[key]
        ndarray_copy_from(arr, mv)

    def forward(self):
        self.exe.forward(is_train=False)

    def output_shape(self, index):
        return [int(s) for s in self.exe.outputs[index].shape]

    def output(self, index):
        return ndarray_copy_to(self.exe.outputs[index])


def pred_create(json_str, param_blob, dev_type, dev_id, input_names,
                input_shapes):
    return _Predictor(json_str, param_blob, dev_type, dev_id, input_names,
                      input_shapes)


def pred_create_partial(json_str, param_blob, dev_type, dev_id, input_names,
                        input_shapes, output_names):
    """MXPredCreatePartialOut: slice the graph at named internal outputs
    (reference c_predict_api.cc matches `name` or `name_output`)."""
    net = sym.load_json(json_str)
    internals = net.get_internals()
    available = internals.list_outputs()
    picked = []
    for want in output_names:
        if want in available:
            picked.append(internals[available.index(want)])
        elif want + "_output" in available:
            picked.append(internals[available.index(want + "_output")])
        else:
            raise ValueError("output %r not found in graph (have %s)"
                             % (want, available[:20]))
    sliced = sym.Group(picked) if len(picked) != 1 else picked[0]
    return _Predictor(sliced.tojson(), param_blob, dev_type, dev_id,
                      input_names, input_shapes)


class _NDList(object):
    """Decoded .nd file for MXNDList*: keeps per-index byte buffers alive
    so C pointers stay valid for the handle's lifetime."""

    def __init__(self, blob):
        import os
        import tempfile
        fd, path = tempfile.mkstemp(suffix=".nd")
        os.close(fd)
        try:
            with open(path, "wb") as f:
                f.write(blob)
            loaded = nd.load(path, ctx=cpu())
        finally:
            os.unlink(path)
        if isinstance(loaded, dict):
            self.keys = list(loaded.keys())
            self.arrs = [loaded[k] for k in self.keys]
        else:
            self.keys = [""] * len(loaded)
            self.arrs = list(loaded)
        self._cache = {}

    def __len__(self):
        return len(self.arrs)

    def get(self, index):
        i = int(index)
        if i not in self._cache:
            a = self.arrs[i]
            data = onp.ascontiguousarray(
                a.asnumpy().astype(onp.float32)).tobytes()
            self._cache[i] = (self.keys[i], data,
                              [int(s) for s in a.shape])
        return self._cache[i]


def ndlist_create(blob):
    return _NDList(blob)


def ndlist_get(lst, index):
    return lst.get(index)


# ------------------------------------------------------ raw-bytes ndarray
_RAW_MAGIC = b"MXTPUND1"


def ndarray_save_raw(arr):
    """Opaque single-array blob: magic | ndim | shape | dtype-code | data
    (MXNDArraySaveRawBytes; reference serializes via NDArray::Save)."""
    import struct
    shape = [int(s) for s in arr.shape]
    code = ndarray_dtype_code(arr)
    hdr = struct.pack("<8sII", _RAW_MAGIC, len(shape), code)
    hdr += struct.pack("<%dI" % len(shape), *shape)
    return hdr + ndarray_copy_to(arr)


def ndarray_load_raw(blob):
    import struct
    magic, ndim, code = struct.unpack_from("<8sII", blob, 0)
    if magic != _RAW_MAGIC:
        raise ValueError("corrupt NDArray raw-bytes blob")
    off = struct.calcsize("<8sII")
    shape = struct.unpack_from("<%dI" % ndim, blob, off)
    off += 4 * ndim
    dtype = _DTYPE_CODE[code]
    a = onp.frombuffer(blob, dtype=dtype, offset=off,
                       count=int(onp.prod(shape)) if ndim else 1)
    return nd.array(a.reshape(shape), ctx=cpu(), dtype=dtype)


# ---------------------------------------------------------------- autograd
def autograd_set_training(is_training):
    from . import autograd
    prev = autograd.is_training()
    autograd.set_is_training(bool(is_training))
    return 1 if prev else 0


def autograd_mark_variables(variables, reqs, gradients):
    from . import autograd
    req_map = {0: "null", 1: "write", 2: "inplace", 3: "add"}
    autograd.mark_variables(list(variables),
                            list(gradients),
                            [req_map[int(r)] for r in reqs])


def autograd_compute_gradient(outputs):
    from . import autograd
    autograd.compute_gradient(list(outputs))


# ------------------------------------------------------------ op reflection
_ATTR_TYPE_NAMES = {int: "int", float: "float", bool: "boolean",
                    str: "string", tuple: "Shape(tuple)",
                    list: "Shape(tuple)"}


def func_info(op_name):
    """(name, description, arg_names, arg_types, arg_descs, key_var_num_args)
    for MXFuncGetInfo / MXSymbolGetAtomicSymbolInfo.

    Mirrors the reference's dmlc::Parameter reflection
    (include/dmlc/parameter.h __FIELDS__): tensor inputs are reported as
    NDArray-or-Symbol, keyword parameters with the type names declared in
    the registry's attr_types (registry.py OpDef)."""
    op = get_op(op_name)
    args = [a for a in op.list_arguments(None)]
    doc = (op.fcompute.__doc__ or "").strip() if op.fcompute else ""
    types = ["NDArray-or-Symbol"] * len(args)
    descs = [""] * len(args)
    for attr, typ in sorted(op.attr_types.items()):
        args.append(attr)
        tname = _ATTR_TYPE_NAMES.get(typ, getattr(typ, "__name__",
                                                  str(typ)))
        required = (attr == op.variable_args or
                    attr in getattr(op, "required_attrs", ()))
        types.append("%s, %s" % (tname,
                                 "required" if required else "optional"))
        descs.append("")
    if op.variable_args and op.variable_args not in op.attr_types:
        args.append(op.variable_args)
        types.append("int, required")
        descs.append("number of variadic inputs")
    # report the queried name, not the canonical target an alias resolves
    # to (the reference registry keys aliases as distinct entries);
    # key_var_num_args names the param that carries the vararg count
    # (e.g. add_n's num_args), "" for fixed-arity ops
    return op_name, doc, args, types, descs, op.variable_args or ""


def func_describe(op_name):
    """(num_use_vars, num_scalars, num_mutate_vars, type_mask) — legacy
    NDArrayFunction view (c_api.cc:396): inputs read, outputs mutated,
    scalar params travel as string kwargs here so num_scalars is 0."""
    op = get_op(op_name)
    return (op.num_inputs(None), 0, op.num_outputs(None), 1)


def func_arity(op_name, keys, vals):
    """(num_use_vars, num_mutate_vars) resolved against the ACTUAL params,
    so vararg ops (add_n/Concat: arity carried in e.g. num_args) marshal
    the right handle counts through MXFuncInvokeEx."""
    op = get_op(op_name)
    attrs = dict(zip(keys, vals))
    return (op.num_inputs(attrs), op.num_outputs(attrs))


# ------------------------------------------------------------ symbol extras
def symbol_group(symbols):
    return sym.Group(list(symbols))


def symbol_save_file(s, fname):
    s.save(fname)


def symbol_print(s):
    return s.debug_str() if hasattr(s, "debug_str") else repr(s)


def symbol_get_name(s):
    n = s.name
    return ("", 0) if n is None else (n, 1)


def symbol_get_attr(s, key):
    v = s.attr(key)
    return ("", 0) if v is None else (str(v), 1)


def symbol_set_attr(s, key, value):
    s._set_attr(**{key: value})


def symbol_list_attr(s, shallow):
    """Flattened k,v,k,v list. Deep form prefixes keys with node names
    (reference MXSymbolListAttr over attr_dict)."""
    flat = []
    if shallow:
        head_name = s._heads[0][0].name
        for k, v in sorted(s.attr_dict().get(head_name, {}).items()):
            if not k.startswith("_"):
                flat += [str(k), str(v)]
    else:
        for node_name, attrs in sorted(s.attr_dict().items()):
            for k, v in sorted(attrs.items()):
                if not k.startswith("_"):
                    flat += ["%s$%s" % (node_name, k), str(v)]
    return flat


def symbol_get_internals(s):
    return s.get_internals()


def symbol_get_children(s):
    return s.get_children()


def symbol_get_output(s, index):
    return s[int(index)]


def symbol_infer_shape(s, keys, csr_indptr, csr_data, partial):
    """CSR-decoded arg shapes in, (arg, out, aux) shape lists out; unknown
    shapes come back as empty lists when partial."""
    shapes = []
    for i in range(len(csr_indptr) - 1):
        row = tuple(csr_data[csr_indptr[i]:csr_indptr[i + 1]])
        # ndim-0 rows are the C-API "shape unknown" convention — they must
        # stay unknown (None) so inference can fill them, not become ()
        shapes.append(row if row else None)
    if keys:
        kwargs = dict(zip(keys, shapes))
        args = ()
    else:
        kwargs = {}
        args = tuple(shapes)
    fn = s.infer_shape_partial if partial else s.infer_shape
    arg_s, out_s, aux_s = fn(*args, **kwargs)
    if arg_s is None:
        return None

    def clean(lst):
        return [list(x) if x is not None else [] for x in lst]

    complete = all(x is not None for x in arg_s)
    return clean(arg_s), clean(out_s), clean(aux_s or []), int(complete)


def symbol_infer_type(s, keys, type_codes):
    codes = [int(t) for t in type_codes]
    if keys:
        kwargs = {k: _DTYPE_CODE[c] for k, c in zip(keys, codes)}
        args = ()
    else:
        kwargs = {}
        args = tuple(_DTYPE_CODE[c] for c in codes)
    arg_t, out_t, aux_t = s.infer_type(*args, **kwargs)
    if arg_t is None:
        return None

    def enc(lst):
        return [_CODE_DTYPE.get(str(onp.dtype(t)), -1) if t is not None
                else -1 for t in lst]

    complete = all(t is not None for t in arg_t)
    return enc(arg_t), enc(out_t), enc(aux_t or []), int(complete)


# ---------------------------------------------------------- executor extras
def executor_bind_x(s, dev_type, dev_id, map_keys, map_dev_types, map_dev_ids,
                    in_args, arg_grads, grad_reqs, aux_states, shared_exec):
    """MXExecutorBindX/EX: base device + group2ctx placement map."""
    ctx = _ctx(dev_type, dev_id)
    group2ctx = {k: _ctx(t, i) for k, t, i in
                 zip(map_keys, map_dev_types, map_dev_ids)}
    req_map = {0: "null", 1: "write", 2: "write", 3: "add"}
    arg_names = s.list_arguments()
    args = dict(zip(arg_names, in_args))
    grads = {n: g for n, g in zip(arg_names, arg_grads) if g is not None}
    reqs = {n: req_map[int(r)] for n, r in zip(arg_names, grad_reqs)}
    aux_names = s.list_auxiliary_states()
    if any(c != ctx for c in group2ctx.values()):
        from .base import MXNetError
        raise MXNetError("MXExecutorBindX: placing groups on other devices "
                         "(group2ctx) is model parallelism, which the port "
                         "does not have yet")
    # shared_exec only lets the reference share memory between executors;
    # PyTorch's caching allocator reuses it without being told
    return s.bind(ctx, args, args_grad=grads or None, grad_req=reqs,
                  aux_states=dict(zip(aux_names, aux_states)) or None)


def executor_print(e):
    return e.debug_str()


def executor_set_monitor_c(e, fn_ptr, ctx_ptr):
    """Install a C monitor callback: void(*)(const char*, NDArrayHandle,
    void*). Fired via ctypes; the NDArrayHandle is a strong ref the C side
    must release with MXNDArrayFree (graph_executor.cc:760 contract)."""
    import ctypes
    cb = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_void_p,
                          ctypes.c_void_p)(fn_ptr)

    def monitor(name, arr):
        ref = ctypes.py_object(arr)
        ctypes.pythonapi.Py_IncRef(ref)
        cb(name.encode(), id(arr), ctx_ptr)

    e.set_monitor_callback(monitor)
    e._c_monitor_keepalive = cb


# -------------------------------------------------------------- data iters
def _parse_attr_str(v):
    """Typed parse of a C-API string param — same parser the op registry
    uses for attrs (registry._parse_value), so dataiter kwargs and op
    params follow one set of string-conversion rules."""
    from .registry import _parse_value
    return _parse_value(str(v))


def _dataiter_registry():
    from . import io as io_mod
    from . import image as image_mod
    reg = {
        "MNISTIter": io_mod.MNISTIter,
        "CSVIter": io_mod.CSVIter,
        "ImageRecordIter": image_mod.ImageRecordIter,
    }
    if hasattr(image_mod, "ImageDetRecordIter"):
        reg["ImageDetRecordIter"] = image_mod.ImageDetRecordIter
    return reg


def list_data_iters():
    return sorted(_dataiter_registry().keys())


def dataiter_info(name):
    import inspect
    cls = _dataiter_registry()[name]
    doc = (cls.__doc__ or "").strip()
    params = [p for p in inspect.signature(cls.__init__).parameters.values()
              if p.name not in ("self",) and p.kind is not p.VAR_KEYWORD]
    names = [p.name for p in params]
    types = ["" if p.default is inspect.Parameter.empty else repr(p.default)
             for p in params]
    return name, doc, names, types, [""] * len(names)


class _CIter(object):
    """Handle-protocol adapter: the C API drives iterators as
    Next/GetData/GetLabel/GetPad over the CURRENT batch (iter_io.h
    DataIter contract), while python iterators expose next()->DataBatch.
    Caches the current batch per Next call."""

    def __init__(self, it):
        self.it = it
        self.cur = None

    def next(self):
        try:
            self.cur = self.it.next()
            return True
        except StopIteration:
            self.cur = None
            return False

    def reset(self):
        self.it.reset()
        self.cur = None


def dataiter_create(name, keys, vals):
    cls = _dataiter_registry()[name]
    kwargs = {k: _parse_attr_str(v) for k, v in zip(keys, vals)}
    return _CIter(cls(**kwargs))


def dataiter_next(it):
    return 1 if it.next() else 0


def dataiter_before_first(it):
    it.reset()


def dataiter_getdata(it):
    return it.cur.data[0]


def dataiter_getlabel(it):
    lab = it.cur.label
    return lab[0] if lab else None


def dataiter_getindex(it):
    idx = it.cur.index
    if idx is None:
        bs = int(it.cur.data[0].shape[0])
        return list(range(bs))
    return [int(i) for i in idx]


def dataiter_getpad(it):
    return int(it.cur.pad or 0)


# ------------------------------------------------------------------ kvstore
def init_ps_env(keys, vals):
    import os
    for k, v in zip(keys, vals):
        os.environ[str(k)] = str(v)


def kvstore_create(kind):
    from . import kvstore
    return kvstore.create(kind)


def kvstore_init(kv, keys, vals):
    kv.init(list(keys), list(vals))


def kvstore_push(kv, keys, vals, priority):
    kv.push(list(keys), list(vals), priority=priority)


def kvstore_pull(kv, keys, vals, priority):
    kv.pull(list(keys), out=list(vals), priority=priority)


def kvstore_set_updater_c(kv, fn_ptr, ctx_ptr):
    """C updater trampoline: void(*)(int key, NDArrayHandle recv,
    NDArrayHandle local, void*). Handles passed in are strong refs released
    by the trampoline after the call (the C side must NOT free them —
    matching the reference's borrowed-handle updater contract)."""
    import ctypes
    cb = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p)(fn_ptr)

    def updater(key, recv, local):
        cb(int(key), id(recv), id(local), ctx_ptr)

    kv._set_updater(updater)
    kv._c_updater_keepalive = cb


def kvstore_run_server_c(kv, fn_ptr, ctx_ptr):
    import ctypes
    cb = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_char_p,
                          ctypes.c_void_p)(fn_ptr)

    def controller(head, body):
        cb(int(head), str(body).encode(), ctx_ptr)

    kv._c_controller_keepalive = cb
    # no server processes in this design (kvstore_server.py): the controller
    # is registered for command loopback and the server loop is a no-op
    kv._server_controller = controller
    from .kvstore_server import KVStoreServer
    KVStoreServer(kv).run()


def kvstore_send_command(kv, head, body):
    kv._send_command_to_servers(int(head), body)


def kvstore_num_dead_node(kv, node_id, timeout_sec):
    return int(kv.get_num_dead_node(int(node_id), timeout=int(timeout_sec)))


def kvstore_is_role(role):
    import os
    r = os.environ.get("DMLC_ROLE", "worker")
    return 1 if r == role else 0


# ----------------------------------------------------------------- recordio
def recordio_writer_create(uri):
    from . import recordio
    w = recordio.MXRecordIO(uri, "w")
    return w


def recordio_reader_create(uri):
    from . import recordio
    return recordio.MXRecordIO(uri, "r")


def recordio_read(r):
    return r.read()  # None at EOF


def recordio_seek(r, pos):
    # byte-position seek (MXRecordIOReaderSeek); MXRecordIO.seek(idx) is
    # the indexed variant, so address the stream directly
    r.handle.seek(int(pos))


# ---------------------------------------------------------------------- rtc
def rtc_create(name, input_names, output_names, inputs, outputs, kernel):
    from . import rtc
    named_in = list(zip(input_names, inputs))
    named_out = list(zip(output_names, outputs))
    return rtc.Rtc(name, named_in, named_out, kernel)


def rtc_push(r, inputs, outputs, grid_dims, block_dims):
    r.push(list(inputs), list(outputs), grid_dims, block_dims)


# ---------------------------------------------------------- custom op (C)
class _CCallbackList(object):
    """Decoded MXCallbackList: slot index -> (fn_ptr, ctx_ptr)."""

    def __init__(self, num, fn_addrs, ctx_addrs):
        self.slots = list(zip(fn_addrs[:num], ctx_addrs[:num]))

    def get(self, idx):
        if idx >= len(self.slots) or not self.slots[idx][0]:
            return None, None
        return self.slots[idx]


def _c_strlist(fn_ptr, state, functype):
    """Invoke a CustomOpListFunc and decode its NULL-terminated char**."""
    import ctypes
    fn = functype(fn_ptr)
    out = ctypes.POINTER(ctypes.c_char_p)()
    if not fn(ctypes.byref(out), state):
        raise RuntimeError("custom-op list callback failed")
    names, i = [], 0
    while out[i]:
        names.append(out[i].decode())
        i += 1
    return names


def custom_op_register_c(op_type, creator_ptr):
    """MXCustomOpRegister: wrap a C CustomOpPropCreator as a python
    CustomOpProp so C-registered ops flow through the same executor path
    as python custom ops (reference custom.cc tags: in=0 out=1 grad=2
    ograd=3 aux=4; reqs: 0 null, 1 write, 2 inplace, 3 add)."""
    import ctypes
    from . import operator as op_mod

    LIST_T = ctypes.CFUNCTYPE(ctypes.c_int,
                              ctypes.POINTER(ctypes.POINTER(ctypes.c_char_p)),
                              ctypes.c_void_p)
    SHAPE_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.POINTER(ctypes.c_uint)),
                               ctypes.c_void_p)
    FB_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int,
                            ctypes.POINTER(ctypes.c_void_p),
                            ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_int),
                            ctypes.c_int, ctypes.c_void_p)
    CREATE_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint)),
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.c_void_p, ctypes.c_void_p)

    class _CallbackListStruct(ctypes.Structure):
        _fields_ = [("num_callbacks", ctypes.c_int),
                    ("callbacks", ctypes.POINTER(ctypes.c_void_p)),
                    ("contexts", ctypes.POINTER(ctypes.c_void_p))]

    CREATOR_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_char_p),
                                 ctypes.POINTER(ctypes.c_char_p),
                                 ctypes.POINTER(_CallbackListStruct))
    creator = CREATOR_T(creator_ptr)

    # slot indices (enum CustomOpPropCallbacks / CustomOpCallbacks)
    PROP_LIST_ARG, PROP_LIST_OUT, PROP_LIST_AUX = 1, 2, 3
    PROP_INFER_SHAPE, PROP_BWD_DEP, PROP_CREATE = 4, 5, 6
    OP_FWD, OP_BWD = 1, 2
    _REQ_CODE = {"null": 0, "write": 1, "inplace": 2, "add": 3}

    def decode_cblist(cl):
        n = cl.num_callbacks
        fns = [cl.callbacks[i] or 0 for i in range(n)]
        ctxs = [cl.contexts[i] or 0 for i in range(n)]
        return _CCallbackList(n, fns, ctxs)

    def _as_nd(x):
        if isinstance(x, nd.NDArray):
            return x
        if hasattr(x, "asnumpy"):
            return nd.array(x.asnumpy(), ctx=cpu())
        return nd.array(onp.asarray(x), ctx=cpu())

    class _COp(op_mod.CustomOp):
        def __init__(self, cbl):
            self._cbl = cbl

        def _fb(self, slot, groups, reqs, is_train):
            fn_ptr, state = self._cbl.get(slot)
            if fn_ptr is None:
                raise RuntimeError("C custom op missing callback %d" % slot)
            fn = FB_T(fn_ptr)
            handles, tags = [], []
            keep = []
            for tag, arrs in groups:
                for a in arrs:
                    a_nd = _as_nd(a)
                    keep.append(a_nd)
                    handles.append(id(a_nd))
                    tags.append(tag)
            n = len(handles)
            arr_t = (ctypes.c_void_p * n)(*handles)
            tag_t = (ctypes.c_int * n)(*tags)
            req_t = (ctypes.c_int * max(len(reqs), 1))(
                *[_REQ_CODE.get(r, 1) for r in reqs] or [1])
            if not fn(n, arr_t, tag_t, req_t, int(is_train), state):
                raise RuntimeError("C custom op forward/backward failed")
            return keep, tags

        def forward(self, is_train, req, in_data, out_data, aux):
            # hand real NDArrays across the ABI; C mutates outputs in place
            in_nd = [_as_nd(x) for x in in_data]
            out_nd = [_as_nd(x) for x in out_data]
            aux_nd = [_as_nd(x) for x in aux]
            keep, _ = self._fb(OP_FWD,
                               [(0, in_nd), (1, out_nd), (4, aux_nd)],
                               list(req), is_train)
            for dst, src in zip(out_data, out_nd):
                self.assign(dst, "write", src.asnumpy())
            for dst, src in zip(aux, aux_nd):
                dst[:] = src.asnumpy()

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            in_nd = [_as_nd(x) for x in in_data]
            out_nd = [_as_nd(x) for x in out_data]
            ig_nd = [_as_nd(x) for x in in_grad]
            aux_nd = [_as_nd(x) for x in aux]
            og_nd = [_as_nd(x) for x in out_grad]
            self._fb(OP_BWD,
                     [(0, in_nd), (1, out_nd), (2, ig_nd), (4, aux_nd),
                      (3, og_nd)],
                     list(req), True)
            for dst, src in zip(in_grad, ig_nd):
                self.assign(dst, "write", src.asnumpy())

    class _CProp(op_mod.CustomOpProp):
        def __init__(self, **kwargs):
            super(_CProp, self).__init__(need_top_grad=True)
            self._kwargs = kwargs
            keys = [str(k).encode() for k in kwargs]
            vals = [str(v).encode() for v in kwargs.values()]
            cl = _CallbackListStruct()
            ok = creator(op_type.encode(), len(keys),
                         (ctypes.c_char_p * max(len(keys), 1))(*keys or
                                                               [b""]),
                         (ctypes.c_char_p * max(len(vals), 1))(*vals or
                                                               [b""]),
                         ctypes.byref(cl))
            if not ok:
                raise RuntimeError("CustomOpPropCreator failed for %s"
                                   % op_type)
            self._cbl = decode_cblist(cl)

        def _strlist(self, slot):
            fn_ptr, state = self._cbl.get(slot)
            if fn_ptr is None:
                return []
            return _c_strlist(fn_ptr, state, LIST_T)

        def list_arguments(self):
            return self._strlist(PROP_LIST_ARG) or ["data"]

        def list_outputs(self):
            return self._strlist(PROP_LIST_OUT) or ["output"]

        def list_auxiliary_states(self):
            return self._strlist(PROP_LIST_AUX)

        def infer_shape(self, in_shape):
            import ctypes as ct
            fn_ptr, state = self._cbl.get(PROP_INFER_SHAPE)
            if fn_ptr is None:
                return super(_CProp, self).infer_shape(in_shape)
            n_in = len(self.list_arguments())
            n_out = len(self.list_outputs())
            n_aux = len(self.list_auxiliary_states())
            total = n_in + n_out + n_aux
            ndims = (ct.c_int * total)(
                *([len(s) for s in in_shape] + [0] * (n_out + n_aux)))
            # per-tensor shape buffers; the callback either reads (inputs)
            # or repoints the row at its own storage (outputs)
            keep = [(ct.c_uint * max(len(s), 8))(*[int(d) for d in s])
                    for s in in_shape]
            keep += [(ct.c_uint * 8)() for _ in range(n_out + n_aux)]
            rows = (ct.POINTER(ct.c_uint) * total)(
                *[ct.cast(b, ct.POINTER(ct.c_uint)) for b in keep])
            fn = SHAPE_T(fn_ptr)
            if not fn(total, ndims, rows, state):
                raise RuntimeError("C custom op infer_shape failed")
            shapes = [tuple(int(rows[i][j]) for j in range(ndims[i]))
                      for i in range(total)]
            return (shapes[:n_in], shapes[n_in:n_in + n_out],
                    shapes[n_in + n_out:])

        def declare_backward_dependency(self, out_grad, in_data, out_data):
            import ctypes as ct
            fn_ptr, state = self._cbl.get(PROP_BWD_DEP)
            if fn_ptr is None:
                return super(_CProp, self).declare_backward_dependency(
                    out_grad, in_data, out_data)
            BWD_T = ct.CFUNCTYPE(ct.c_int, ct.POINTER(ct.c_int),
                                 ct.POINTER(ct.c_int), ct.POINTER(ct.c_int),
                                 ct.POINTER(ct.c_int),
                                 ct.POINTER(ct.POINTER(ct.c_int)),
                                 ct.c_void_p)
            fn = BWD_T(fn_ptr)
            og = (ct.c_int * max(len(out_grad), 1))(*out_grad or [0])
            ind = (ct.c_int * max(len(in_data), 1))(*in_data or [0])
            od = (ct.c_int * max(len(out_data), 1))(*out_data or [0])
            ndeps = ct.c_int(0)
            rdeps = ct.POINTER(ct.c_int)()
            if not fn(og, ind, od, ct.byref(ndeps), ct.byref(rdeps), state):
                raise RuntimeError("C custom op backward-dependency failed")
            return [int(rdeps[i]) for i in range(ndeps.value)]

        def create_operator(self, ctx, in_shapes, in_dtypes):
            import ctypes as ct
            fn_ptr, state = self._cbl.get(PROP_CREATE)
            if fn_ptr is None:
                # the reference CHECKs this callback exists (custom.cc:177)
                raise RuntimeError(
                    "C custom op %s has no CreateOperator callback"
                    % op_type)
            n = len(in_shapes)
            keep = [(ct.c_uint * max(len(s), 1))(*[int(d) for d in s])
                    for s in in_shapes]
            rows = (ct.POINTER(ct.c_uint) * max(n, 1))(
                *[ct.cast(b, ct.POINTER(ct.c_uint)) for b in keep])
            ndims = (ct.c_int * max(n, 1))(*[len(s) for s in in_shapes]
                                           or [0])
            dts = (ct.c_int * max(n, 1))(
                *[_CODE_DTYPE.get(str(onp.dtype(t)), 0) for t in in_dtypes]
                or [0])
            cl = _CallbackListStruct()
            fn = CREATE_T(fn_ptr)
            if not fn(str(ctx).encode(), n, rows, ndims, dts,
                      ct.cast(ct.byref(cl), ct.c_void_p), state):
                raise RuntimeError("C custom op create_operator failed")
            return _COp(decode_cblist(cl))

    op_mod.register(op_type)(_CProp)


# ------------------------------------------------------------------ global
def random_seed(s):
    from . import random as rnd
    rnd.seed(int(s))


def profiler_config(mode, filename):
    from . import profiler
    profiler.profiler_set_config(mode={0: "symbolic", 1: "all"}.get(mode,
                                                                    "all"),
                                 filename=filename)


def profiler_state(state):
    from . import profiler
    profiler.profiler_set_state({0: "stop", 1: "run"}.get(state, "stop"))


def profiler_dump():
    from . import profiler
    profiler.dump_profile()


def kernel_launches():
    """Launches of every hand-written kernel in this process, by name."""
    from .kernels import batchnorm as K
    from .kernels import copy as C
    from .kernels import nms as NM
    from .kernels import roi_pooling as RP
    from .kernels import rtc as R
    counts = {"bn_fwd": K.bn_fwd.launches, "bn_bwd": K.bn_bwd.launches,
              "rtc": R.rtc_kernel.launches, "copy": C.copy.launches,
              "nms_mask": NM.nms_mask.launches,
              "nms_scan": NM.nms_scan.launches,
              "roi_pool_fwd": RP.roi_pool_fwd.launches,
              "roi_pool_bwd": RP.roi_pool_bwd.launches}
    counts.update({k: getattr(K, k).launches for k in K.SPLIT_KERNELS})
    return counts


def wait_all():
    """MXNDArrayWaitAll. With ``MXNET_CAPI_LAUNCH_LOG`` naming a file, it
    then appends one JSON line of ``kernel_launches()`` there: how the
    process that started a C client reads which kernels its calls
    launched."""
    nd.waitall()
    path = os.environ.get("MXNET_CAPI_LAUNCH_LOG")
    if path:
        with open(path, "a") as f:
            f.write(json.dumps(kernel_launches()) + "\n")
