"""Checker and CUDA code generator for ``mx.rtc`` kernel bodies.

A body is the JAX package's kernel language (``mxnet_tpu/rtc.py``):
Python over ``<name>_ref`` refs, read and written whole with ``[...]``,
with ``jnp.`` calls. ``check_kernel`` parses a body once and accepts only
the subset that one fused elementwise pass over float32 arrays of one
shape computes:

* statements: ``o_ref[...] = <expr>`` into an output ref, and assignments
  to local names (plus a leading docstring);
* operators ``+ - * /``, ``**`` with an integer constant exponent 1..8,
  unary ``-``/``+``, single comparisons;
* int and float constants;
* ``jnp.exp``, ``log``, ``sqrt``, ``tanh``, ``abs``, ``maximum``,
  ``minimum`` and ``where``.

Anything else raises ``MXNetError``, whatever device the kernel is later
pushed to, so the plain version never accepts what the kernel refuses.

``a ** k`` is lowered here, for the plain version and the kernel alike,
to the square-and-multiply product that ``jax.lax.integer_pow`` computes,
so both round the same way. ``cuda_source`` turns a checked kernel into
the text of one CUDA file: the body as a device function over float
values, instantiated in the streaming engine (``csrc/stream.cuh``), which
reads every input once and writes every output once. Each float
operation is one correctly rounded intrinsic (``__fmul_rn``,
``__fadd_rn``, ...), so ``x * 2.0 + y`` rounds twice, as the plain
version's two torch ops do, and no multiply and add fuse into an fma.
The CPU tests read the generated text; nvcc builds it on the card
(``kernels/rtc.py``).
"""
from __future__ import annotations

import ast
import copy
import hashlib
import math
import textwrap

import numpy

from ..base import MXNetError

__all__ = ["CheckedKernel", "check_kernel", "cuda_source", "FUNCS",
           "MAX_POW"]

# jnp function -> (arity, CUDA spelling): the accurate library functions
# (no fast-math intrinsic), a correctly rounded sqrt, and a maximum and
# minimum that propagate NaN as jnp's do (CUDA's fmaxf/fminf do not)
FUNCS = {
    "exp": (1, "expf({0})"),
    "log": (1, "logf({0})"),
    "sqrt": (1, "__fsqrt_rn({0})"),
    "tanh": (1, "tanhf({0})"),
    "abs": (1, "fabsf({0})"),
    "maximum": (2, "mx_maximum({0}, {1})"),
    "minimum": (2, "mx_minimum({0}, {1})"),
    "where": (3, "({0} ? {1} : {2})"),
}
MAX_POW = 8
_BINOPS = {ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/"}
_CMPOPS = {ast.Lt: "<", ast.LtE: "<=", ast.Gt: ">", ast.GtE: ">=",
           ast.Eq: "==", ast.NotEq: "!="}

# value kinds of the type walk
ARRAY, SCALAR, MASK = "array", "scalar", "mask"


def _refuse(node, what):
    line = getattr(node, "lineno", None)
    where = " (line %d of the kernel source)" % line if line else ""
    raise MXNetError("rtc: %s is not supported by the port's kernel "
                     "language%s" % (what, where))


def _pow_plan(k):
    """The multiplications of ``lax.integer_pow(x, k)``: square-and-
    multiply over k's bits, as a list of (dst, a, b) over slots where slot
    0 holds x. Returns (plan, result slot)."""
    plan, base, acc, n = [], 0, None, 1
    while True:
        if k & 1:
            if acc is None:
                acc = base
            else:
                plan.append((n, acc, base))
                acc, n = n, n + 1
        k >>= 1
        if not k:
            return plan, acc
        plan.append((n, base, base))
        base, n = n, n + 1


def _lower_pow(base, k):
    """``base ** k`` as an AST of products (``base`` repeats: the plain
    version evaluates pure expressions)."""
    plan, res = _pow_plan(k)
    slots = {0: base}
    for dst, a, b in plan:
        slots[dst] = ast.BinOp(left=copy.deepcopy(slots[a]), op=ast.Mult(),
                               right=copy.deepcopy(slots[b]))
    return slots[res]


def _is_whole_ref(node):
    """``name[...]``: the only indexing the language has."""
    return (isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Name)
            and isinstance(node.slice, ast.Constant)
            and node.slice.value is Ellipsis)


def _pow_exponent(node):
    if isinstance(node, ast.Constant) and type(node.value) in (int, float) \
            and float(node.value).is_integer() \
            and 1 <= int(node.value) <= MAX_POW:
        return int(node.value)
    _refuse(node, "'**' with an exponent other than an integer constant "
            "1..%d" % MAX_POW)


class CheckedKernel(object):
    """A body that passed the checker.

    ``params`` are the ref parameter names, inputs first; ``n_in`` of them
    are inputs. ``tree`` is the function ``_kernel`` with ``**`` lowered
    and numeric constants made float, ``code`` its compiled module,
    ``source`` its text and ``digest`` the sha256 of that text."""

    def __init__(self, params, n_in, tree, stmts):
        self.params = params
        self.n_in = n_in
        self.n_out = len(params) - n_in
        self.tree = tree
        self.stmts = stmts      # [(kind, target, value kind, value)]
        self.source = ast.unparse(tree)
        self.digest = hashlib.sha256(self.source.encode()).hexdigest()
        self.code = compile(tree, "<rtc %s>" % self.digest[:12], "exec")


class _Checker(object):
    """One walk over the body: checks every node against the subset,
    types it (array / scalar constant / comparison mask) and lowers it."""

    def __init__(self, params, n_in):
        self.inputs = set(params[:n_in])
        self.outputs = set(params[n_in:])
        self.written = set()
        self.locals = {}

    def expr(self, node):
        """(kind, lowered node) of an expression."""
        if isinstance(node, ast.Constant):
            if type(node.value) not in (int, float):
                _refuse(node, "the constant %r" % (node.value,))
            return SCALAR, ast.Constant(float(node.value))
        if isinstance(node, ast.Name):
            if node.id not in self.locals:
                _refuse(node, "the name %r (a ref is read as %s[...]; "
                        "locals must be assigned first)" % (node.id, node.id))
            return self.locals[node.id], ast.Name(node.id, ast.Load())
        if isinstance(node, ast.Subscript):
            if not _is_whole_ref(node):
                _refuse(node, "indexing other than ref[...]")
            name = node.value.id
            if name in self.outputs and name not in self.written:
                _refuse(node, "reading the output ref %r before it is "
                        "written" % name)
            if name not in self.inputs and name not in self.outputs:
                _refuse(node, "the ref %r" % name)
            return ARRAY, ast.Subscript(ast.Name(name, ast.Load()),
                                        ast.Constant(Ellipsis), ast.Load())
        if isinstance(node, ast.UnaryOp) and \
                isinstance(node.op, (ast.USub, ast.UAdd)):
            kind, val = self.expr(node.operand)
            self._numeric(node, kind)
            return kind, ast.UnaryOp(type(node.op)(), val)
        if isinstance(node, ast.BinOp):
            if isinstance(node.op, ast.Pow):
                kind, base = self.expr(node.left)
                self._numeric(node, kind)
                return kind, _lower_pow(base, _pow_exponent(node.right))
            if type(node.op) not in _BINOPS:
                _refuse(node, "the operator %s" % type(node.op).__name__)
            (ka, a), (kb, b) = self.expr(node.left), self.expr(node.right)
            self._numeric(node, ka)
            self._numeric(node, kb)
            kind = ARRAY if ARRAY in (ka, kb) else SCALAR
            return kind, ast.BinOp(a, type(node.op)(), b)
        if isinstance(node, ast.Compare):
            if len(node.ops) != 1 or type(node.ops[0]) not in _CMPOPS:
                _refuse(node, "a chained or non-numeric comparison")
            (ka, a), (kb, b) = (self.expr(node.left),
                                self.expr(node.comparators[0]))
            self._numeric(node, ka)
            self._numeric(node, kb)
            if ARRAY not in (ka, kb):
                _refuse(node, "a comparison of two constants")
            return MASK, ast.Compare(a, [type(node.ops[0])()], [b])
        if isinstance(node, ast.Call):
            return self.call(node)
        _refuse(node, "the expression %s" % type(node).__name__)

    def call(self, node):
        f = node.func
        if not (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id == "jnp"):
            _refuse(node, "calling %s" % ast.unparse(f))
        if f.attr not in FUNCS:
            _refuse(node, "jnp.%s" % f.attr)
        arity = FUNCS[f.attr][0]
        if node.keywords or len(node.args) != arity:
            _refuse(node, "jnp.%s with other than %d positional argument(s)"
                    % (f.attr, arity))
        typed = [self.expr(a) for a in node.args]
        kinds = [k for k, _ in typed]
        if f.attr == "where":
            if kinds[0] != MASK:
                _refuse(node, "jnp.where with a condition that is not a "
                        "comparison")
            vals = kinds[1:]
        else:
            vals = kinds
        for k in vals:
            self._numeric(node, k)
        if ARRAY not in vals:
            _refuse(node, "jnp.%s without an array argument" % f.attr)
        call = ast.Call(ast.Attribute(ast.Name("jnp", ast.Load()), f.attr,
                                      ast.Load()),
                        [v for _, v in typed], [])
        return ARRAY, call

    @staticmethod
    def _numeric(node, kind):
        if kind == MASK:
            _refuse(node, "arithmetic on a comparison (use jnp.where)")

    def stmt(self, node):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            _refuse(node, "the statement %s" % type(node).__name__)
        target = node.targets[0]
        kind, val = self.expr(node.value)
        if isinstance(target, ast.Name):
            if target.id == "jnp" or target.id in self.inputs \
                    or target.id in self.outputs:
                _refuse(node, "assigning to the name %r" % target.id)
            self.locals[target.id] = kind
            return ("local", target.id, kind, val)
        if not _is_whole_ref(target):
            _refuse(node, "assigning to %s" % ast.unparse(target))
        name = target.value.id
        if name not in self.outputs:
            _refuse(node, "writing the ref %r, which is not an output"
                    % name)
        if kind == MASK:
            _refuse(node, "storing a comparison (use jnp.where)")
        if kind == SCALAR:
            _refuse(node, "storing a constant (as in the JAX package, the "
                    "value stored must have the ref's shape)")
        self.written.add(name)
        return ("store", name, kind, val)


def _function_def(source):
    try:
        tree = ast.parse(textwrap.dedent(source))
    except SyntaxError as e:
        raise MXNetError("invalid rtc kernel source: %s" % e)
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
    if len(tree.body) != 1 or len(fns) != 1:
        raise MXNetError("rtc: the kernel source must be one function")
    fn = fns[0]
    a = fn.args
    if a.vararg or a.kwarg or a.kwonlyargs or a.defaults or a.posonlyargs:
        _refuse(fn, "a kernel signature other than plain ref parameters")
    return fn


def check_kernel(source, n_in=None):
    """Parse and check the source of one kernel function (refs as its
    parameters, inputs first). With ``n_in`` unknown, the outputs are the
    refs the body writes, and they must be the trailing parameters.
    Raises ``MXNetError`` for anything outside the subset."""
    fn = _function_def(source)
    params = [p.arg for p in fn.args.args]
    body = list(fn.body)
    if body and isinstance(body[0], ast.Expr) and \
            isinstance(body[0].value, ast.Constant) and \
            isinstance(body[0].value.value, str):
        body = body[1:]
    if not body:
        raise MXNetError("rtc: the kernel body is empty")
    if n_in is None:
        stored = {t.value.id for s in body if isinstance(s, ast.Assign)
                  for t in s.targets if _is_whole_ref(t)}
        n_in = len(params)
        while n_in and params[n_in - 1] in stored:
            n_in -= 1
    checker = _Checker(params, n_in)
    stmts = [checker.stmt(s) for s in body]
    missing = [p for p in params[n_in:] if p not in checker.written]
    if missing or n_in == len(params):
        raise MXNetError("rtc: every output ref must be written, and there "
                         "must be one; not written: %s" % (missing or "-"))
    lowered = ast.FunctionDef(
        name="_kernel",
        args=ast.arguments(posonlyargs=[], args=[ast.arg(p) for p in params],
                           vararg=None, kwonlyargs=[], kw_defaults=[],
                           kwarg=None, defaults=[]),
        body=[ast.Assign(targets=[ast.Name(t, ast.Store()) if k == "local"
                                  else ast.Subscript(
                                      ast.Name(t, ast.Load()),
                                      ast.Constant(Ellipsis), ast.Store())],
                         value=v, lineno=0)
              for k, t, _, v in stmts],
        decorator_list=[], returns=None, type_params=[], lineno=0)
    tree = ast.fix_missing_locations(ast.Module(body=[lowered],
                                                type_ignores=[]))
    return CheckedKernel(params, n_in, tree, stmts)


# ---------------------------------------------------------------------------
# CUDA source
# ---------------------------------------------------------------------------
_C_BINOPS = {ast.Add: "__fadd_rn", ast.Sub: "__fsub_rn", ast.Mult: "__fmul_rn",
             ast.Div: "__fdiv_rn"}
# device functions a body may call, emitted where it calls them
_HELPERS = {
    "mx_maximum": "// jnp.maximum: a NaN in either argument is the result\n"
                  "__device__ __forceinline__ float mx_maximum(float a, "
                  "float b) {\n"
                  "  return a != a ? a : (b != b ? b : fmaxf(a, b));\n}\n\n",
    "mx_minimum": "// jnp.minimum: a NaN in either argument is the result\n"
                  "__device__ __forceinline__ float mx_minimum(float a, "
                  "float b) {\n"
                  "  return a != a ? a : (b != b ? b : fminf(a, b));\n}\n\n",
}
# C name prefix and type of a local of each kind
_LOCAL = {ARRAY: ("v_", "float"), SCALAR: ("s_", "double"),
          MASK: ("m_", "bool")}


def _double_literal(v):
    if math.isfinite(v):
        return repr(v)
    return "%s__longlong_as_double(0x7ff0000000000000LL)" % (
        "-" if v < 0 else "")


def _float_literal(v):
    """The float32 that the plain version makes of the Python float ``v``
    (rounded to nearest), as a C float literal."""
    with numpy.errstate(over="ignore"):
        f = numpy.float32(v)
    if numpy.isfinite(f):
        return str(f) + "f"
    return "%s__int_as_float(0x7f800000)" % ("-" if f < 0 else "")


class _Emitter(object):
    """C expressions of a checked body. Array values are float and every
    float operation is one correctly rounded intrinsic, as the plain
    version rounds each torch op once; constant (scalar) subexpressions
    are double, as Python computes them, and become float where they
    meet an array, as torch casts a Python scalar."""

    def __init__(self, ck):
        self.ref_var = {p: ("in%d" % i if i < ck.n_in
                            else "out%d" % (i - ck.n_in))
                        for i, p in enumerate(ck.params)}
        self.kinds = {}         # local name -> kind of its last value

    def expr(self, node):
        """(kind, C text) of an expression; scalar text is double."""
        if isinstance(node, ast.Constant):
            return SCALAR, _double_literal(node.value)
        if isinstance(node, ast.Name):
            kind = self.kinds[node.id]
            return kind, _LOCAL[kind][0] + node.id
        if isinstance(node, ast.Subscript):
            return ARRAY, self.ref_var[node.value.id]
        if isinstance(node, ast.UnaryOp):
            kind, val = self.expr(node.operand)
            return kind, ("(-%s)" % val if isinstance(node.op, ast.USub)
                          else val)
        if isinstance(node, ast.BinOp):
            # a lowered power arrives as nested products, emitted as they
            # stand: the same order as the plain version evaluates them
            ka, a = self.expr(node.left)
            kb, b = self.expr(node.right)
            if ARRAY not in (ka, kb):
                return SCALAR, "(%s %s %s)" % (a, _BINOPS[type(node.op)], b)
            return ARRAY, "%s(%s, %s)" % (
                _C_BINOPS[type(node.op)], self.as_float(node.left, ka, a),
                self.as_float(node.right, kb, b))
        if isinstance(node, ast.Compare):
            (ka, a), (kb, b) = (self.expr(node.left),
                                self.expr(node.comparators[0]))
            return MASK, "(%s %s %s)" % (
                self.as_float(node.left, ka, a), _CMPOPS[type(node.ops[0])],
                self.as_float(node.comparators[0], kb, b))
        if isinstance(node, ast.Call):
            args = []
            for i, arg in enumerate(node.args):
                kind, val = self.expr(arg)
                args.append(val if kind == MASK else
                            self.as_float(arg, kind, val))
            return ARRAY, FUNCS[node.func.attr][1].format(*args)
        raise AssertionError(type(node))   # the checker admits no other

    @staticmethod
    def as_float(node, kind, text):
        if kind != SCALAR:
            return text
        if isinstance(node, ast.Constant):
            return _float_literal(node.value)
        return "(float)%s" % text


def cuda_source(ck):
    """The text of one CUDA file that computes the checked kernel over
    flat float32 arrays: the body as ``Body::apply`` over float values
    (statements in the order the checker lowered them), the streaming
    engine (``csrc/stream.cuh``) instantiated with it, and the C entry
    ``mx_rtc(ins, outs, n, plan, device, stream)``, which returns the
    launch's ``cudaError_t``."""
    em = _Emitter(ck)
    lines = ["const float in%d = in[%d];" % (i, i) for i in range(ck.n_in)]
    declared = set()
    for kind, target, vkind, val in ck.stmts:
        k, text = em.expr(val)
        if kind == "local":
            em.kinds[target] = k
            prefix, ctype = _LOCAL[k]
            name = prefix + target
        else:
            name, ctype = em.ref_var[target], "float"
            text = em.as_float(val, k, text)
        lines.append("%s%s = %s;" % ("" if name in declared
                                     else ctype + " ", name, text))
        declared.add(name)
    lines += ["out[%d] = out%d;" % (j, j) for j in range(ck.n_out)]
    header = "".join("//     %s\n" % line if line else "//\n"
                     for line in ck.source.splitlines())
    helpers = "".join(_HELPERS[f] for f in sorted(_HELPERS)
                      if any(f + "(" in line for line in lines))
    return (
        "// Generated by mxnet_tpu_torch.kernels.rtc_codegen from the rtc "
        "body:\n//\n" + header +
        "//\n// Built by kernels/rtc.py with nvcc -fmad=false -prec-div=true"
        " -prec-sqrt=true.\n"
        "#include \"stream.cuh\"\n\n"
        "namespace {\n\n" + helpers +
        "struct Body {\n"
        "  static constexpr int kIn = %d;\n"
        "  static constexpr int kOut = %d;\n"
        "  static __device__ __forceinline__ void apply(const float* in, "
        "float* out) {\n" % (ck.n_in, ck.n_out) +
        "".join("    %s\n" % line for line in lines) +
        "  }\n};\n\n}  // namespace\n\n"
        "extern \"C\" int mx_rtc(const float* const* ins, float* const* "
        "outs,\n                      long long n, const long long* plan, "
        "int device,\n                      void* stream) {\n"
        "  return mxstream::launch_rtc<Body>(ins, outs, n, plan, device, "
        "stream);\n"
        "}\n")
