"""Plugin namespace (reference plugin/ directory).

- ``warpctc``: the WarpCTC op with the Baidu plugin's contract, on the
  port's CTC recursion (imported here: it registers ``mx.sym.WarpCTC``).

The JAX package's ``caffe`` and ``opencv`` plugins are not ported yet.
"""
from . import warpctc  # noqa: F401  (registers the WarpCTC op)

# an op registered at plugin-import time needs re-exposure on the sym/nd
# namespaces (they were populated at package import)
from .. import ndarray as _nd
from .. import symbol as _sym
_sym._init_symbol_module()
_nd._init_ndarray_module()
