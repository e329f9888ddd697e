"""Plugin namespace (reference plugin/ directory).

- ``warpctc``: the WarpCTC op with the Baidu plugin's contract, on the
  port's CTC recursion (imported here: it registers ``mx.sym.WarpCTC``).
- ``caffe``: ``CaffeOp``/``CaffeLoss``, Caffe layer prototxts lowered onto
  the port's symbols (no libcaffe, no protobuf).
- ``opencv``: cv-style imdecode/resize/copyMakeBorder and
  ``ImageListIter`` over the host image ops (cv2, else PIL).

The reference's ``sframe`` plugin (SFrame database iterator) has no
counterpart: it binds the proprietary SFrame C++ SDK; use ImageRecordIter
or CSVIter.
"""
from . import warpctc  # noqa: F401  (registers the WarpCTC op)
from . import opencv  # noqa: F401
from .caffe import CaffeLoss, CaffeOp  # noqa: F401

# an op registered at plugin-import time needs re-exposure on the sym/nd
# namespaces (they were populated at package import)
from .. import ndarray as _nd
from .. import symbol as _sym
_sym._init_symbol_module()
_nd._init_ndarray_module()

# reference scripts call mx.sym.CaffeOp / mx.sym.CaffeLoss (plugin/caffe
# registers them as symbols when built in)
_sym.CaffeOp = CaffeOp
_sym.CaffeLoss = CaffeLoss
