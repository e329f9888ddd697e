// C ABI boundary for mxnet_tpu_torch, the PyTorch/CUDA port
// (include/mxnet_tpu/c_api.h, the same ABI as the JAX package's library).
//
// Reference counterpart: src/c_api/c_api.cc — there, flat C functions over a
// C++ core. Here the compute core is PyTorch on the card, driven by the
// mxnet_tpu_torch Python package, so this library EMBEDS a CPython interpreter and
// fronts it with the same flat-C handle contract. Responsibilities that live
// on this side of the boundary: interpreter lifecycle, GIL management,
// opaque handle ownership (every handle is a strong PyObject ref), raw
// buffer copies across the ABI, per-thread error strings, and C-lifetime
// string/array marshalling (the MXAPIThreadLocalEntry pattern,
// src/c_api/c_api_common.h).
#include <Python.h>

#ifndef _WIN32
#include <dlfcn.h>
#endif

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include "../../include/mxnet_tpu/c_api.h"

namespace {

// ---------------------------------------------------------------- runtime
std::once_flag g_init_flag;
PyObject* g_bridge = nullptr;  // mxnet_tpu_torch.capi_bridge module

void InitRuntime() {
  bool owns_interp = false;
  if (!Py_IsInitialized()) {
#ifndef _WIN32
    // Hosts that dlopen this library WITHOUT RTLD_GLOBAL (perl XSLoader,
    // R dyn.load, MATLAB loadlibrary) leave libpython's symbols local to
    // this .so; numpy & friends' C extensions rely on process-global
    // libpython symbols and fail with "undefined symbol: PyObject_...".
    // Promote the already-mapped libpython to global scope.
    {
      char soname[64];
      snprintf(soname, sizeof(soname), "libpython%d.%d.so.1.0",
               PY_MAJOR_VERSION, PY_MINOR_VERSION);
      if (dlopen(soname, RTLD_LAZY | RTLD_GLOBAL | RTLD_NOLOAD) ==
          nullptr) {
        dlopen(soname, RTLD_LAZY | RTLD_GLOBAL);  // not yet mapped
      }
    }
#endif
    Py_InitializeEx(0);
    owns_interp = true;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  // make the package importable: MXNET_TPU_HOME, or the CWD fallback
  PyRun_SimpleString(
      "import sys, os\n"
      "home = os.environ.get('MXNET_TPU_HOME')\n"
      "for p in ([home] if home else []) + [os.getcwd()]:\n"
      "    if p and os.path.isdir(os.path.join(p, 'mxnet_tpu_torch')) "
      "and p not in sys.path:\n"
      "        sys.path.insert(0, p)\n");
  g_bridge = PyImport_ImportModule("mxnet_tpu_torch.capi_bridge");
  if (g_bridge == nullptr) {
    PyErr_Print();
  }
  PyGILState_Release(g);
  if (owns_interp) {
    // drop the GIL the init thread holds so any thread can Ensure() later
    PyEval_SaveThread();
  }
}

thread_local std::string g_last_error;

// per-thread marshalling buffers whose lifetime spans until the next call
// on the same thread (the reference's MXAPIThreadLocalEntry contract)
struct ThreadLocalStore {
  std::vector<std::string> strings;
  std::vector<const char*> cptrs;
  std::vector<mx_uint> shape;
  std::vector<NDArrayHandle> handles;
  std::string json;
  // secondary string-list returns (multi-list calls like MXFuncGetInfo);
  // the strings arena above must be FULLY populated before any cptr vector
  // is built (SSO buffers move when the arena reallocates)
  std::vector<const char*> cptrs2;
  std::vector<const char*> cptrs3;
  // CSR-style shape returns (MXSymbolInferShape): row buffers live in the
  // arena, row pointers + ndims per section (arg/out/aux)
  std::vector<std::vector<mx_uint>> shape_arena;
  std::vector<const mx_uint*> shape_rows[3];
  std::vector<mx_uint> shape_ndim[3];
  std::vector<int> type_codes[3];
  std::vector<uint64_t> index64;
  std::vector<void*> creators;
};
thread_local ThreadLocalStore g_tls;

// per-handle byte buffers whose lifetime is tied to the handle, not the
// call (MXNDArrayGetData / SaveRawBytes / RecordIO read): freed when the
// owning handle is freed. Keyed by (handle, slot) so the GetData mirror
// and the SaveRawBytes blob of the same handle don't clobber each other.
enum HandleBufSlot { kBufData = 0, kBufRaw = 1 };
std::mutex g_buf_mu;
std::unordered_map<void*, std::string> g_handle_bufs[2];

void DropHandleBuf(void* h) {
  std::lock_guard<std::mutex> lk(g_buf_mu);
  g_handle_bufs[kBufData].erase(h);
  g_handle_bufs[kBufRaw].erase(h);
}

std::string& HandleBuf(void* h, HandleBufSlot slot = kBufData) {
  std::lock_guard<std::mutex> lk(g_buf_mu);
  return g_handle_bufs[slot][h];
}

// interned op-name handles (AtomicSymbolCreator / FunctionHandle): one
// stable char* per name for the process lifetime
std::mutex g_intern_mu;
std::unordered_map<std::string, char*> g_interned;

char* InternName(const std::string& s) {
  std::lock_guard<std::mutex> lk(g_intern_mu);
  auto it = g_interned.find(s);
  if (it == g_interned.end()) {
    it = g_interned.emplace(s, ::strdup(s.c_str())).first;
  }
  return it->second;
}

class Gil {
 public:
  Gil() : state_(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

int HandleException() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  g_last_error = "unknown error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      g_last_error = PyUnicode_AsUTF8(s);
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return -1;
}

// Call bridge.<fn>(args...); returns new ref or nullptr (python error set).
PyObject* Call(const char* fn, PyObject* args) {
  if (g_bridge == nullptr) {
    Py_XDECREF(args);
    PyErr_SetString(PyExc_RuntimeError, "mxnet_tpu_torch bridge failed to import");
    return nullptr;
  }
  PyObject* f = PyObject_GetAttrString(g_bridge, fn);
  if (f == nullptr) {
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* r = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_XDECREF(args);
  return r;
}

PyObject* StrList(const char** arr, mx_uint n) {
  PyObject* l = PyList_New(n);
  for (mx_uint i = 0; i < n; ++i) {
    PyList_SetItem(l, i, PyUnicode_FromString(arr[i] ? arr[i] : ""));
  }
  return l;
}

PyObject* HandleList(NDArrayHandle* arr, mx_uint n, bool none_ok = false) {
  PyObject* l = PyList_New(n);
  for (mx_uint i = 0; i < n; ++i) {
    PyObject* o = static_cast<PyObject*>(arr ? arr[i] : nullptr);
    if (o == nullptr) {
      if (!none_ok) {
        Py_DECREF(l);
        return nullptr;
      }
      o = Py_None;
    }
    Py_INCREF(o);
    PyList_SetItem(l, i, o);
  }
  return l;
}

// copy a python list of str into TLS and expose as const char**
int ReturnStrList(PyObject* list, mx_uint* out_size,
                  const char*** out_array) {
  Py_ssize_t n = PyList_Size(list);
  g_tls.strings.clear();
  g_tls.cptrs.clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    g_tls.strings.emplace_back(PyUnicode_AsUTF8(PyList_GetItem(list, i)));
  }
  for (auto& s : g_tls.strings) g_tls.cptrs.push_back(s.c_str());
  *out_size = static_cast<mx_uint>(n);
  *out_array = g_tls.cptrs.data();
  return 0;
}

}  // namespace

#define API_BEGIN() \
  std::call_once(g_init_flag, InitRuntime); \
  Gil gil_; \
  try {
#define API_END()                                      \
  }                                                    \
  catch (...) { g_last_error = "c++ exception"; return -1; } \
  if (PyErr_Occurred()) return HandleException();      \
  return 0;

extern "C" {

const char* MXGetLastError() { return g_last_error.c_str(); }

// ------------------------------------------------------------------ global
int MXRandomSeed(int seed) {
  API_BEGIN();
  PyObject* r = Call("random_seed", Py_BuildValue("(i)", seed));
  Py_XDECREF(r);
  API_END();
}

int MXNotifyShutdown() {
  API_BEGIN();
  PyObject* r = Call("wait_all", PyTuple_New(0));
  Py_XDECREF(r);
  API_END();
}

int MXSetProfilerConfig(int mode, const char* filename) {
  API_BEGIN();
  PyObject* r = Call("profiler_config", Py_BuildValue("(is)", mode, filename));
  Py_XDECREF(r);
  API_END();
}

int MXSetProfilerState(int state) {
  API_BEGIN();
  PyObject* r = Call("profiler_state", Py_BuildValue("(i)", state));
  Py_XDECREF(r);
  API_END();
}

int MXDumpProfile() {
  API_BEGIN();
  PyObject* r = Call("profiler_dump", PyTuple_New(0));
  Py_XDECREF(r);
  API_END();
}

int MXListAllOpNames(mx_uint* out_size, const char*** out_array) {
  API_BEGIN();
  PyObject* r = Call("all_op_names", PyTuple_New(0));
  if (r) {
    ReturnStrList(r, out_size, out_array);
    Py_DECREF(r);
  }
  API_END();
}

// ----------------------------------------------------------------- ndarray
int MXNDArrayCreateNone(NDArrayHandle* out) {
  API_BEGIN();
  Py_INCREF(Py_None);
  *out = Py_None;
  API_END();
}

int MXNDArrayCreateEx(const mx_uint* shape, mx_uint ndim, int dev_type,
                      int dev_id, int delay_alloc, int dtype,
                      NDArrayHandle* out) {
  (void)delay_alloc;  // PyTorch's allocator owns allocation timing
  API_BEGIN();
  PyObject* shp = PyList_New(ndim);
  for (mx_uint i = 0; i < ndim; ++i) {
    PyList_SetItem(shp, i, PyLong_FromUnsignedLong(shape[i]));
  }
  PyObject* r = Call("ndarray_create",
                     Py_BuildValue("(Niii)", shp, dev_type, dev_id, dtype));
  if (r) *out = r;  // strong ref IS the handle
  API_END();
}

int MXNDArrayCreate(const mx_uint* shape, mx_uint ndim, int dev_type,
                    int dev_id, int delay_alloc, NDArrayHandle* out) {
  return MXNDArrayCreateEx(shape, ndim, dev_type, dev_id, delay_alloc, 0,
                           out);
}

int MXNDArrayFree(NDArrayHandle handle) {
  API_BEGIN();
  DropHandleBuf(handle);
  Py_XDECREF(static_cast<PyObject*>(handle));
  API_END();
}

int MXNDArrayGetShape(NDArrayHandle handle, mx_uint* out_dim,
                      const mx_uint** out_pdata) {
  API_BEGIN();
  PyObject* r = Call("ndarray_shape",
                     Py_BuildValue("(O)", static_cast<PyObject*>(handle)));
  if (r) {
    Py_ssize_t n = PyList_Size(r);
    g_tls.shape.clear();
    for (Py_ssize_t i = 0; i < n; ++i) {
      g_tls.shape.push_back(
          static_cast<mx_uint>(PyLong_AsLong(PyList_GetItem(r, i))));
    }
    *out_dim = static_cast<mx_uint>(n);
    *out_pdata = g_tls.shape.data();
    Py_DECREF(r);
  }
  API_END();
}

int MXNDArrayGetDType(NDArrayHandle handle, int* out_dtype) {
  API_BEGIN();
  PyObject* r = Call("ndarray_dtype_code",
                     Py_BuildValue("(O)", static_cast<PyObject*>(handle)));
  if (r) {
    *out_dtype = static_cast<int>(PyLong_AsLong(r));
    Py_DECREF(r);
  }
  API_END();
}

int MXNDArrayGetContext(NDArrayHandle handle, int* out_dev_type,
                        int* out_dev_id) {
  API_BEGIN();
  PyObject* r = Call("ndarray_context",
                     Py_BuildValue("(O)", static_cast<PyObject*>(handle)));
  if (r) {
    *out_dev_type = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(r, 0)));
    *out_dev_id = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(r, 1)));
    Py_DECREF(r);
  }
  API_END();
}

int MXNDArraySyncCopyFromCPU(NDArrayHandle handle, const void* data,
                             size_t size) {
  API_BEGIN();
  // size is in ELEMENTS (reference contract); wrap raw memory r/o
  PyObject* dt = Call("ndarray_dtype_code",
                      Py_BuildValue("(O)", static_cast<PyObject*>(handle)));
  if (dt != nullptr) {
    static const int kItem[] = {4, 8, 2, 1, 4, 1, 8};
    int code = static_cast<int>(PyLong_AsLong(dt));
    Py_DECREF(dt);
    Py_ssize_t nbytes = static_cast<Py_ssize_t>(size) * kItem[code];
    PyObject* mv = PyMemoryView_FromMemory(
        const_cast<char*>(static_cast<const char*>(data)), nbytes,
        PyBUF_READ);
    PyObject* r = Call("ndarray_copy_from",
                       Py_BuildValue("(ON)", static_cast<PyObject*>(handle),
                                     mv));
    Py_XDECREF(r);
  }
  API_END();
}

int MXNDArraySyncCopyToCPU(NDArrayHandle handle, void* data, size_t size) {
  API_BEGIN();
  PyObject* r = Call("ndarray_copy_to",
                     Py_BuildValue("(O)", static_cast<PyObject*>(handle)));
  if (r) {
    char* buf = nullptr;
    Py_ssize_t len = 0;
    PyBytes_AsStringAndSize(r, &buf, &len);
    PyObject* dt = Call("ndarray_dtype_code",
                        Py_BuildValue("(O)", static_cast<PyObject*>(handle)));
    static const int kItem[] = {4, 8, 2, 1, 4, 1, 8};
    int code = dt ? static_cast<int>(PyLong_AsLong(dt)) : 0;
    Py_XDECREF(dt);
    Py_ssize_t want = static_cast<Py_ssize_t>(size) * kItem[code];
    std::memcpy(data, buf, want < len ? want : len);
    Py_DECREF(r);
  }
  API_END();
}

int MXNDArrayWaitToRead(NDArrayHandle handle) {
  API_BEGIN();
  PyObject* r = PyObject_CallMethod(static_cast<PyObject*>(handle),
                                    "wait_to_read", nullptr);
  Py_XDECREF(r);
  API_END();
}

int MXNDArrayWaitToWrite(NDArrayHandle handle) {
  API_BEGIN();
  PyObject* r = PyObject_CallMethod(static_cast<PyObject*>(handle),
                                    "wait_to_read", nullptr);
  Py_XDECREF(r);
  API_END();
}

int MXNDArrayWaitAll() {
  API_BEGIN();
  PyObject* r = Call("wait_all", PyTuple_New(0));
  Py_XDECREF(r);
  API_END();
}

int MXNDArraySlice(NDArrayHandle handle, mx_uint begin, mx_uint end,
                   NDArrayHandle* out) {
  API_BEGIN();
  PyObject* r = PyObject_CallMethod(static_cast<PyObject*>(handle), "slice",
                                    "II", begin, end);
  if (r) *out = r;
  API_END();
}

int MXNDArrayAt(NDArrayHandle handle, mx_uint idx, NDArrayHandle* out) {
  API_BEGIN();
  PyObject* r = PyObject_CallMethod(static_cast<PyObject*>(handle), "at",
                                    "I", idx);
  if (r) *out = r;
  API_END();
}

int MXNDArrayReshape(NDArrayHandle handle, int ndim, int* dims,
                     NDArrayHandle* out) {
  API_BEGIN();
  PyObject* shp = PyTuple_New(ndim);
  for (int i = 0; i < ndim; ++i) {
    PyTuple_SetItem(shp, i, PyLong_FromLong(dims[i]));
  }
  PyObject* r = PyObject_CallMethod(static_cast<PyObject*>(handle),
                                    "reshape", "N", shp);
  if (r) *out = r;
  API_END();
}

int MXNDArraySave(const char* fname, mx_uint num_args, NDArrayHandle* args,
                  const char** keys) {
  API_BEGIN();
  PyObject* arrs = HandleList(args, num_args);
  PyObject* ks = keys ? StrList(keys, num_args) : (Py_INCREF(Py_None),
                                                   Py_None);
  PyObject* r = Call("ndarray_save", Py_BuildValue("(sNN)", fname, arrs, ks));
  Py_XDECREF(r);
  API_END();
}

int MXNDArrayLoad(const char* fname, mx_uint* out_size,
                  NDArrayHandle** out_arr, mx_uint* out_name_size,
                  const char*** out_names) {
  API_BEGIN();
  PyObject* r = Call("ndarray_load", Py_BuildValue("(s)", fname));
  if (r) {
    PyObject* arrs = PyTuple_GetItem(r, 0);
    PyObject* names = PyTuple_GetItem(r, 1);
    Py_ssize_t n = PyList_Size(arrs);
    g_tls.handles.clear();
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject* a = PyList_GetItem(arrs, i);
      Py_INCREF(a);  // caller frees via MXNDArrayFree
      g_tls.handles.push_back(a);
    }
    *out_size = static_cast<mx_uint>(n);
    *out_arr = g_tls.handles.data();
    ReturnStrList(names, out_name_size, out_names);
    Py_DECREF(r);
  }
  API_END();
}

// ------------------------------------------------------- operator invoke
int MXGetFunction(const char* name, FunctionHandle* out) {
  API_BEGIN();
  *out = InternName(name);  // interned op-name handle
  API_END();
}

int MXImperativeInvoke(AtomicSymbolCreator creator, int num_inputs,
                       NDArrayHandle* inputs, int* num_outputs,
                       NDArrayHandle** outputs, int num_params,
                       const char** param_keys, const char** param_vals) {
  API_BEGIN();
  PyObject* ins = HandleList(inputs, num_inputs);
  PyObject* ks = StrList(param_keys, num_params);
  PyObject* vs = StrList(param_vals, num_params);
  // reference contract: caller may pre-provide output arrays (in-place ops,
  // e.g. fused optimizer updates writing back into the bound weight)
  PyObject* outs_in = (*outputs != nullptr && *num_outputs > 0)
      ? HandleList(*outputs, *num_outputs)
      : (Py_INCREF(Py_None), Py_None);
  PyObject* r = Call("imperative_invoke",
                     Py_BuildValue("(sNNNN)",
                                   static_cast<const char*>(creator), ins,
                                   ks, vs, outs_in));
  if (r) {
    Py_ssize_t n = PyList_Size(r);
    g_tls.handles.clear();
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject* a = PyList_GetItem(r, i);
      Py_INCREF(a);
      g_tls.handles.push_back(a);
    }
    *num_outputs = static_cast<int>(n);
    *outputs = g_tls.handles.data();
    Py_DECREF(r);
  }
  API_END();
}

// ------------------------------------------------------------------ symbol
int MXSymbolCreateFromJSON(const char* json, SymbolHandle* out) {
  API_BEGIN();
  PyObject* sym_mod = PyImport_ImportModule("mxnet_tpu_torch.symbol");
  PyObject* r = sym_mod ? PyObject_CallMethod(sym_mod, "load_json", "s", json)
                        : nullptr;
  Py_XDECREF(sym_mod);
  if (r) *out = r;
  API_END();
}

int MXSymbolCreateFromFile(const char* fname, SymbolHandle* out) {
  API_BEGIN();
  PyObject* sym_mod = PyImport_ImportModule("mxnet_tpu_torch.symbol");
  PyObject* r = sym_mod ? PyObject_CallMethod(sym_mod, "load", "s", fname)
                        : nullptr;
  Py_XDECREF(sym_mod);
  if (r) *out = r;
  API_END();
}

int MXSymbolSaveToJSON(SymbolHandle symbol, const char** out_json) {
  API_BEGIN();
  PyObject* r = PyObject_CallMethod(static_cast<PyObject*>(symbol), "tojson",
                                    nullptr);
  if (r) {
    g_tls.json = PyUnicode_AsUTF8(r);
    *out_json = g_tls.json.c_str();
    Py_DECREF(r);
  }
  API_END();
}

int MXSymbolCreateVariable(const char* name, SymbolHandle* out) {
  API_BEGIN();
  PyObject* sym_mod = PyImport_ImportModule("mxnet_tpu_torch.symbol");
  PyObject* r = sym_mod ? PyObject_CallMethod(sym_mod, "Variable", "s", name)
                        : nullptr;
  Py_XDECREF(sym_mod);
  if (r) *out = r;
  API_END();
}

int MXSymbolCreateAtomicSymbol(AtomicSymbolCreator creator, mx_uint num_param,
                               const char** keys, const char** vals,
                               SymbolHandle* out) {
  API_BEGIN();
  PyObject* r = Call("symbol_create_atomic",
                     Py_BuildValue("(sNN)",
                                   static_cast<const char*>(creator),
                                   StrList(keys, num_param),
                                   StrList(vals, num_param)));
  if (r) *out = r;
  API_END();
}

int MXSymbolCompose(SymbolHandle sym, const char* name, mx_uint num_args,
                    const char** keys, SymbolHandle* args) {
  API_BEGIN();
  PyObject* ks = keys ? StrList(keys, num_args) : (Py_INCREF(Py_None),
                                                   Py_None);
  PyObject* r = Call("symbol_compose",
                     Py_BuildValue("(OsNN)", static_cast<PyObject*>(sym),
                                   name ? name : "", ks,
                                   HandleList(args, num_args)));
  Py_XDECREF(r);
  API_END();
}

int MXSymbolCopy(SymbolHandle symbol, SymbolHandle* out) {
  API_BEGIN();
  PyObject* copy_mod = PyImport_ImportModule("copy");
  PyObject* r = copy_mod
      ? PyObject_CallMethod(copy_mod, "deepcopy", "O",
                            static_cast<PyObject*>(symbol))
      : nullptr;
  Py_XDECREF(copy_mod);
  if (r) *out = r;
  API_END();
}

int MXSymbolFree(SymbolHandle symbol) {
  API_BEGIN();
  Py_XDECREF(static_cast<PyObject*>(symbol));
  API_END();
}

static int SymbolList(SymbolHandle symbol, const char* which,
                      mx_uint* out_size, const char*** out_str_array) {
  API_BEGIN();
  PyObject* r = Call("symbol_list",
                     Py_BuildValue("(Os)", static_cast<PyObject*>(symbol),
                                   which));
  if (r) {
    ReturnStrList(r, out_size, out_str_array);
    Py_DECREF(r);
  }
  API_END();
}

int MXSymbolListArguments(SymbolHandle symbol, mx_uint* out_size,
                          const char*** out_str_array) {
  return SymbolList(symbol, "arguments", out_size, out_str_array);
}

int MXSymbolListOutputs(SymbolHandle symbol, mx_uint* out_size,
                        const char*** out_str_array) {
  return SymbolList(symbol, "outputs", out_size, out_str_array);
}

int MXSymbolListAuxiliaryStates(SymbolHandle symbol, mx_uint* out_size,
                                const char*** out_str_array) {
  return SymbolList(symbol, "aux", out_size, out_str_array);
}

// ---------------------------------------------------------------- executor
int MXExecutorBind(SymbolHandle symbol, int dev_type, int dev_id, mx_uint len,
                   NDArrayHandle* in_args, NDArrayHandle* arg_grad_store,
                   mx_uint* grad_req_type, mx_uint aux_states_len,
                   NDArrayHandle* aux_states, ExecutorHandle* out) {
  API_BEGIN();
  PyObject* reqs = PyList_New(len);
  for (mx_uint i = 0; i < len; ++i) {
    PyList_SetItem(reqs, i,
                   PyLong_FromLong(grad_req_type ? grad_req_type[i] : 1));
  }
  PyObject* r = Call("executor_bind",
                     Py_BuildValue("(OiiNNNN)",
                                   static_cast<PyObject*>(symbol), dev_type,
                                   dev_id, HandleList(in_args, len),
                                   HandleList(arg_grad_store, len, true),
                                   reqs,
                                   HandleList(aux_states, aux_states_len)));
  if (r) *out = r;
  API_END();
}

int MXExecutorForward(ExecutorHandle handle, int is_train) {
  API_BEGIN();
  PyObject* r = Call("executor_forward",
                     Py_BuildValue("(Oi)", static_cast<PyObject*>(handle),
                                   is_train));
  Py_XDECREF(r);
  API_END();
}

int MXExecutorBackward(ExecutorHandle handle, mx_uint len,
                       NDArrayHandle* head_grads) {
  API_BEGIN();
  PyObject* grads = len ? HandleList(head_grads, len)
                        : (Py_INCREF(Py_None), Py_None);
  PyObject* r = Call("executor_backward",
                     Py_BuildValue("(ON)", static_cast<PyObject*>(handle),
                                   grads));
  Py_XDECREF(r);
  API_END();
}

int MXExecutorOutputs(ExecutorHandle handle, mx_uint* out_size,
                      NDArrayHandle** out) {
  API_BEGIN();
  PyObject* r = Call("executor_outputs",
                     Py_BuildValue("(O)", static_cast<PyObject*>(handle)));
  if (r) {
    Py_ssize_t n = PyList_Size(r);
    g_tls.handles.clear();
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject* a = PyList_GetItem(r, i);
      Py_INCREF(a);
      g_tls.handles.push_back(a);
    }
    *out_size = static_cast<mx_uint>(n);
    *out = g_tls.handles.data();
    Py_DECREF(r);
  }
  API_END();
}

int MXExecutorFree(ExecutorHandle handle) {
  API_BEGIN();
  Py_XDECREF(static_cast<PyObject*>(handle));
  API_END();
}

// ------------------------------------------------------------ predict API
int MXPredCreate(const char* symbol_json_str, const void* param_bytes,
                 int param_size, int dev_type, int dev_id,
                 mx_uint num_input_nodes, const char** input_keys,
                 const mx_uint* input_shape_indptr,
                 const mx_uint* input_shape_data, PredictorHandle* out) {
  API_BEGIN();
  PyObject* names = StrList(input_keys, num_input_nodes);
  PyObject* shapes = PyList_New(num_input_nodes);
  for (mx_uint i = 0; i < num_input_nodes; ++i) {
    mx_uint b = input_shape_indptr[i], e = input_shape_indptr[i + 1];
    PyObject* s = PyList_New(e - b);
    for (mx_uint j = b; j < e; ++j) {
      PyList_SetItem(s, j - b, PyLong_FromUnsignedLong(input_shape_data[j]));
    }
    PyList_SetItem(shapes, i, s);
  }
  PyObject* blob = PyBytes_FromStringAndSize(
      static_cast<const char*>(param_bytes), param_size);
  PyObject* r = Call("pred_create",
                     Py_BuildValue("(sNiiNN)", symbol_json_str, blob,
                                   dev_type, dev_id, names, shapes));
  if (r) *out = r;
  API_END();
}

int MXPredSetInput(PredictorHandle handle, const char* key,
                   const mx_float* data, mx_uint size) {
  API_BEGIN();
  PyObject* mv = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<mx_float*>(data)),
      static_cast<Py_ssize_t>(size) * sizeof(mx_float), PyBUF_READ);
  PyObject* r = PyObject_CallMethod(static_cast<PyObject*>(handle),
                                    "set_input", "sN", key, mv);
  Py_XDECREF(r);
  API_END();
}

int MXPredForward(PredictorHandle handle) {
  API_BEGIN();
  PyObject* r = PyObject_CallMethod(static_cast<PyObject*>(handle),
                                    "forward", nullptr);
  Py_XDECREF(r);
  API_END();
}

int MXPredGetOutputShape(PredictorHandle handle, mx_uint index,
                         mx_uint** shape_data, mx_uint* shape_ndim) {
  API_BEGIN();
  PyObject* r = PyObject_CallMethod(static_cast<PyObject*>(handle),
                                    "output_shape", "I", index);
  if (r) {
    Py_ssize_t n = PyList_Size(r);
    g_tls.shape.clear();
    for (Py_ssize_t i = 0; i < n; ++i) {
      g_tls.shape.push_back(
          static_cast<mx_uint>(PyLong_AsLong(PyList_GetItem(r, i))));
    }
    *shape_ndim = static_cast<mx_uint>(n);
    *shape_data = g_tls.shape.data();
    Py_DECREF(r);
  }
  API_END();
}

int MXPredGetOutput(PredictorHandle handle, mx_uint index, mx_float* data,
                    mx_uint size) {
  API_BEGIN();
  PyObject* r = PyObject_CallMethod(static_cast<PyObject*>(handle), "output",
                                    "I", index);
  if (r) {
    char* buf = nullptr;
    Py_ssize_t len = 0;
    PyBytes_AsStringAndSize(r, &buf, &len);
    Py_ssize_t want = static_cast<Py_ssize_t>(size) * sizeof(mx_float);
    std::memcpy(data, buf, want < len ? want : len);
    Py_DECREF(r);
  }
  API_END();
}

int MXPredFree(PredictorHandle handle) {
  API_BEGIN();
  Py_XDECREF(static_cast<PyObject*>(handle));
  API_END();
}

// ------------------------------------------------------ ndarray raw bytes
int MXNDArraySaveRawBytes(NDArrayHandle handle, size_t* out_size,
                          const char** out_buf) {
  API_BEGIN();
  PyObject* r = Call("ndarray_save_raw",
                     Py_BuildValue("(O)", static_cast<PyObject*>(handle)));
  if (r) {
    char* buf = nullptr;
    Py_ssize_t len = 0;
    PyBytes_AsStringAndSize(r, &buf, &len);
    std::string& store = HandleBuf(handle, kBufRaw);
    store.assign(buf, len);
    *out_size = static_cast<size_t>(len);
    *out_buf = store.data();
    Py_DECREF(r);
  }
  API_END();
}

int MXNDArrayLoadFromRawBytes(const void* buf, size_t size,
                              NDArrayHandle* out) {
  API_BEGIN();
  PyObject* blob = PyBytes_FromStringAndSize(static_cast<const char*>(buf),
                                             static_cast<Py_ssize_t>(size));
  PyObject* r = Call("ndarray_load_raw", Py_BuildValue("(N)", blob));
  if (r) *out = r;
  API_END();
}

int MXNDArrayGetData(NDArrayHandle handle, void** out_pdata) {
  API_BEGIN();
  PyObject* r = Call("ndarray_copy_to",
                     Py_BuildValue("(O)", static_cast<PyObject*>(handle)));
  if (r) {
    char* buf = nullptr;
    Py_ssize_t len = 0;
    PyBytes_AsStringAndSize(r, &buf, &len);
    std::string& store = HandleBuf(handle);
    store.assign(buf, len);
    *out_pdata = const_cast<char*>(store.data());
    Py_DECREF(r);
  }
  API_END();
}

// ---------------------------------------------------------------- autograd
int MXAutogradSetIsTraining(int is_training, int* prev) {
  API_BEGIN();
  PyObject* r = Call("autograd_set_training",
                     Py_BuildValue("(i)", is_training));
  if (r) {
    if (prev) *prev = static_cast<int>(PyLong_AsLong(r));
    Py_DECREF(r);
  }
  API_END();
}

int MXAutogradMarkVariables(mx_uint num_var, NDArrayHandle* var_handles,
                            mx_uint* reqs_array, NDArrayHandle* grad_handles) {
  API_BEGIN();
  PyObject* reqs = PyList_New(num_var);
  for (mx_uint i = 0; i < num_var; ++i) {
    PyList_SetItem(reqs, i, PyLong_FromUnsignedLong(reqs_array[i]));
  }
  PyObject* r = Call("autograd_mark_variables",
                     Py_BuildValue("(NNN)", HandleList(var_handles, num_var),
                                   reqs, HandleList(grad_handles, num_var)));
  Py_XDECREF(r);
  API_END();
}

int MXAutogradComputeGradient(mx_uint num_output,
                              NDArrayHandle* output_handles) {
  API_BEGIN();
  PyObject* r = Call("autograd_compute_gradient",
                     Py_BuildValue("(N)",
                                   HandleList(output_handles, num_output)));
  Py_XDECREF(r);
  API_END();
}

// -------------------------------------------------- legacy func registry
namespace {

// decode bridge func_info tuple (name, desc, args, types, descs, kvargs)
// into TLS-backed C pointers; used by MXFuncGetInfo + atomic-symbol info
int ReturnOpInfo(PyObject* r, const char** name, const char** description,
                 mx_uint* num_args, const char*** arg_names,
                 const char*** arg_type_infos,
                 const char*** arg_descriptions,
                 const char** key_var_num_args, const char** return_type) {
  PyObject* names = PyTuple_GetItem(r, 2);
  PyObject* types = PyTuple_GetItem(r, 3);
  PyObject* descs = PyTuple_GetItem(r, 4);
  Py_ssize_t n = PyList_Size(names);
  // fill the arena COMPLETELY before taking any c_str pointers
  g_tls.strings.clear();
  g_tls.strings.emplace_back(PyUnicode_AsUTF8(PyTuple_GetItem(r, 0)));
  g_tls.strings.emplace_back(PyUnicode_AsUTF8(PyTuple_GetItem(r, 1)));
  g_tls.strings.emplace_back(PyUnicode_AsUTF8(PyTuple_GetItem(r, 5)));
  for (Py_ssize_t i = 0; i < n; ++i)
    g_tls.strings.emplace_back(PyUnicode_AsUTF8(PyList_GetItem(names, i)));
  for (Py_ssize_t i = 0; i < n; ++i)
    g_tls.strings.emplace_back(PyUnicode_AsUTF8(PyList_GetItem(types, i)));
  for (Py_ssize_t i = 0; i < n; ++i)
    g_tls.strings.emplace_back(PyUnicode_AsUTF8(PyList_GetItem(descs, i)));
  g_tls.cptrs.clear();
  g_tls.cptrs2.clear();
  g_tls.cptrs3.clear();
  for (Py_ssize_t i = 0; i < n; ++i)
    g_tls.cptrs.push_back(g_tls.strings[3 + i].c_str());
  for (Py_ssize_t i = 0; i < n; ++i)
    g_tls.cptrs2.push_back(g_tls.strings[3 + n + i].c_str());
  for (Py_ssize_t i = 0; i < n; ++i)
    g_tls.cptrs3.push_back(g_tls.strings[3 + 2 * n + i].c_str());
  *name = g_tls.strings[0].c_str();
  *description = g_tls.strings[1].c_str();
  *num_args = static_cast<mx_uint>(n);
  *arg_names = g_tls.cptrs.data();
  *arg_type_infos = g_tls.cptrs2.data();
  *arg_descriptions = g_tls.cptrs3.data();
  if (key_var_num_args) *key_var_num_args = g_tls.strings[2].c_str();
  if (return_type) *return_type = "";
  return 0;
}

}  // namespace

int MXListFunctions(mx_uint* out_size, FunctionHandle** out_array) {
  API_BEGIN();
  PyObject* r = Call("all_op_names", PyTuple_New(0));
  if (r) {
    Py_ssize_t n = PyList_Size(r);
    g_tls.creators.clear();
    for (Py_ssize_t i = 0; i < n; ++i) {
      g_tls.creators.push_back(
          InternName(PyUnicode_AsUTF8(PyList_GetItem(r, i))));
    }
    *out_size = static_cast<mx_uint>(n);
    *out_array = const_cast<FunctionHandle*>(
        reinterpret_cast<const void* const*>(g_tls.creators.data()));
    Py_DECREF(r);
  }
  API_END();
}

int MXFuncGetInfo(FunctionHandle fun, const char** name,
                  const char** description, mx_uint* num_args,
                  const char*** arg_names, const char*** arg_type_infos,
                  const char*** arg_descriptions,
                  const char** return_type) {
  API_BEGIN();
  PyObject* r = Call("func_info",
                     Py_BuildValue("(s)", static_cast<const char*>(fun)));
  if (r) {
    ReturnOpInfo(r, name, description, num_args, arg_names, arg_type_infos,
                 arg_descriptions, nullptr, return_type);
    Py_DECREF(r);
  }
  API_END();
}

int MXFuncDescribe(FunctionHandle fun, mx_uint* num_use_vars,
                   mx_uint* num_scalars, mx_uint* num_mutate_vars,
                   int* type_mask) {
  API_BEGIN();
  PyObject* r = Call("func_describe",
                     Py_BuildValue("(s)", static_cast<const char*>(fun)));
  if (r) {
    *num_use_vars = static_cast<mx_uint>(
        PyLong_AsLong(PyTuple_GetItem(r, 0)));
    *num_scalars = static_cast<mx_uint>(
        PyLong_AsLong(PyTuple_GetItem(r, 1)));
    *num_mutate_vars = static_cast<mx_uint>(
        PyLong_AsLong(PyTuple_GetItem(r, 2)));
    *type_mask = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(r, 3)));
    Py_DECREF(r);
  }
  API_END();
}

int MXFuncInvokeEx(FunctionHandle fun, NDArrayHandle* use_vars,
                   mx_float* scalar_args, NDArrayHandle* mutate_vars,
                   int num_params, char** param_keys, char** param_vals) {
  (void)scalar_args;  // all params are string kwargs in this registry
  API_BEGIN();
  PyObject* ks = PyList_New(num_params);
  PyObject* vs = PyList_New(num_params);
  for (int i = 0; i < num_params; ++i) {
    PyList_SetItem(ks, i, PyUnicode_FromString(param_keys[i]));
    PyList_SetItem(vs, i, PyUnicode_FromString(param_vals[i]));
  }
  // arity resolved against the actual params (vararg ops carry their
  // input count in a param, e.g. add_n's num_args)
  PyObject* d = Call("func_arity",
                     Py_BuildValue("(sOO)", static_cast<const char*>(fun),
                                   ks, vs));
  if (d) {
    mx_uint n_use = static_cast<mx_uint>(
        PyLong_AsLong(PyTuple_GetItem(d, 0)));
    mx_uint n_mut = static_cast<mx_uint>(
        PyLong_AsLong(PyTuple_GetItem(d, 1)));
    Py_DECREF(d);
    PyObject* r = Call("imperative_invoke",
                       Py_BuildValue("(sNNNN)",
                                     static_cast<const char*>(fun),
                                     HandleList(use_vars, n_use), ks, vs,
                                     HandleList(mutate_vars, n_mut)));
    Py_XDECREF(r);
  } else {
    Py_DECREF(ks);
    Py_DECREF(vs);
  }
  API_END();
}

int MXFuncInvoke(FunctionHandle fun, NDArrayHandle* use_vars,
                 mx_float* scalar_args, NDArrayHandle* mutate_vars) {
  return MXFuncInvokeEx(fun, use_vars, scalar_args, mutate_vars, 0, nullptr,
                        nullptr);
}

int MXCustomOpRegister(const char* op_type, CustomOpPropCreator creator) {
  API_BEGIN();
  PyObject* r = Call("custom_op_register_c",
                     Py_BuildValue("(sK)", op_type,
                                   reinterpret_cast<unsigned long long>(
                                       creator)));
  Py_XDECREF(r);
  API_END();
}

// ------------------------------------------------------------ symbol extras
int MXSymbolCreateGroup(mx_uint num_symbols, SymbolHandle* symbols,
                        SymbolHandle* out) {
  API_BEGIN();
  PyObject* r = Call("symbol_group",
                     Py_BuildValue("(N)", HandleList(symbols, num_symbols)));
  if (r) *out = r;
  API_END();
}

int MXSymbolSaveToFile(SymbolHandle symbol, const char* fname) {
  API_BEGIN();
  PyObject* r = Call("symbol_save_file",
                     Py_BuildValue("(Os)", static_cast<PyObject*>(symbol),
                                   fname));
  Py_XDECREF(r);
  API_END();
}

int MXSymbolPrint(SymbolHandle symbol, const char** out_str) {
  API_BEGIN();
  PyObject* r = Call("symbol_print",
                     Py_BuildValue("(O)", static_cast<PyObject*>(symbol)));
  if (r) {
    g_tls.json = PyUnicode_AsUTF8(r);
    *out_str = g_tls.json.c_str();
    Py_DECREF(r);
  }
  API_END();
}

int MXSymbolGetName(SymbolHandle symbol, const char** out, int* success) {
  API_BEGIN();
  PyObject* r = Call("symbol_get_name",
                     Py_BuildValue("(O)", static_cast<PyObject*>(symbol)));
  if (r) {
    g_tls.json = PyUnicode_AsUTF8(PyTuple_GetItem(r, 0));
    *out = g_tls.json.c_str();
    *success = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(r, 1)));
    Py_DECREF(r);
  }
  API_END();
}

int MXSymbolGetAttr(SymbolHandle symbol, const char* key, const char** out,
                    int* success) {
  API_BEGIN();
  PyObject* r = Call("symbol_get_attr",
                     Py_BuildValue("(Os)", static_cast<PyObject*>(symbol),
                                   key));
  if (r) {
    g_tls.json = PyUnicode_AsUTF8(PyTuple_GetItem(r, 0));
    *out = g_tls.json.c_str();
    *success = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(r, 1)));
    Py_DECREF(r);
  }
  API_END();
}

int MXSymbolSetAttr(SymbolHandle symbol, const char* key, const char* value) {
  API_BEGIN();
  PyObject* r = Call("symbol_set_attr",
                     Py_BuildValue("(Oss)", static_cast<PyObject*>(symbol),
                                   key, value));
  Py_XDECREF(r);
  API_END();
}

static int SymbolListAttrImpl(SymbolHandle symbol, int shallow,
                              mx_uint* out_size, const char*** out) {
  API_BEGIN();
  PyObject* r = Call("symbol_list_attr",
                     Py_BuildValue("(Oi)", static_cast<PyObject*>(symbol),
                                   shallow));
  if (r) {
    mx_uint flat = 0;
    ReturnStrList(r, &flat, out);
    *out_size = flat / 2;  // reference returns #pairs, array is k,v,k,v
    Py_DECREF(r);
  }
  API_END();
}

int MXSymbolListAttr(SymbolHandle symbol, mx_uint* out_size,
                     const char*** out) {
  return SymbolListAttrImpl(symbol, 0, out_size, out);
}

int MXSymbolListAttrShallow(SymbolHandle symbol, mx_uint* out_size,
                            const char*** out) {
  return SymbolListAttrImpl(symbol, 1, out_size, out);
}

int MXSymbolGetInternals(SymbolHandle symbol, SymbolHandle* out) {
  API_BEGIN();
  PyObject* r = Call("symbol_get_internals",
                     Py_BuildValue("(O)", static_cast<PyObject*>(symbol)));
  if (r) *out = r;
  API_END();
}

int MXSymbolGetChildren(SymbolHandle symbol, SymbolHandle* out) {
  API_BEGIN();
  PyObject* r = Call("symbol_get_children",
                     Py_BuildValue("(O)", static_cast<PyObject*>(symbol)));
  if (r) *out = r;
  API_END();
}

int MXSymbolGetOutput(SymbolHandle symbol, mx_uint index, SymbolHandle* out) {
  API_BEGIN();
  PyObject* r = Call("symbol_get_output",
                     Py_BuildValue("(OI)", static_cast<PyObject*>(symbol),
                                   index));
  if (r) *out = r;
  API_END();
}

int MXSymbolGrad(SymbolHandle sym, mx_uint num_wrt, const char** wrt,
                 SymbolHandle* out) {
  (void)sym; (void)num_wrt; (void)wrt; (void)out;
  // unimplemented in the reference as well (c_api_symbolic.cc:545
  // LOG(FATAL)); gradients come from autograd at executor bind
  g_last_error = "MXSymbolGrad: not implemented (matches reference; "
                 "gradients are computed by the executor)";
  return -1;
}

namespace {

// decode bridge symbol_infer_shape result section into TLS slot `sec`
void FillShapeSection(PyObject* lst, int sec, mx_uint* size,
                      const mx_uint** ndim, const mx_uint*** data) {
  Py_ssize_t n = PyList_Size(lst);
  g_tls.shape_ndim[sec].clear();
  g_tls.shape_rows[sec].clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* row = PyList_GetItem(lst, i);
    Py_ssize_t d = PyList_Size(row);
    g_tls.shape_arena.emplace_back();
    std::vector<mx_uint>& buf = g_tls.shape_arena.back();
    for (Py_ssize_t j = 0; j < d; ++j) {
      buf.push_back(static_cast<mx_uint>(
          PyLong_AsLong(PyList_GetItem(row, j))));
    }
    g_tls.shape_ndim[sec].push_back(static_cast<mx_uint>(d));
    g_tls.shape_rows[sec].push_back(buf.data());
  }
  *size = static_cast<mx_uint>(n);
  *ndim = g_tls.shape_ndim[sec].data();
  *data = g_tls.shape_rows[sec].data();
}

int InferShapeImpl(SymbolHandle sym, mx_uint num_args, const char** keys,
                   const mx_uint* arg_ind_ptr, const mx_uint* arg_shape_data,
                   mx_uint* in_shape_size, const mx_uint** in_shape_ndim,
                   const mx_uint*** in_shape_data, mx_uint* out_shape_size,
                   const mx_uint** out_shape_ndim,
                   const mx_uint*** out_shape_data, mx_uint* aux_shape_size,
                   const mx_uint** aux_shape_ndim,
                   const mx_uint*** aux_shape_data, int* complete,
                   int partial) {
  API_BEGIN();
  PyObject* ks = keys ? StrList(keys, num_args)
                      : (Py_INCREF(Py_None), Py_None);
  PyObject* indptr = PyList_New(num_args + 1);
  for (mx_uint i = 0; i <= num_args; ++i) {
    PyList_SetItem(indptr, i, PyLong_FromUnsignedLong(arg_ind_ptr[i]));
  }
  mx_uint total = arg_ind_ptr[num_args];
  PyObject* flat = PyList_New(total);
  for (mx_uint i = 0; i < total; ++i) {
    PyList_SetItem(flat, i, PyLong_FromUnsignedLong(arg_shape_data[i]));
  }
  PyObject* r = Call("symbol_infer_shape",
                     Py_BuildValue("(ONNNi)", static_cast<PyObject*>(sym),
                                   ks, indptr, flat, partial));
  if (r && r != Py_None) {
    g_tls.shape_arena.clear();
    FillShapeSection(PyTuple_GetItem(r, 0), 0, in_shape_size, in_shape_ndim,
                     in_shape_data);
    FillShapeSection(PyTuple_GetItem(r, 1), 1, out_shape_size,
                     out_shape_ndim, out_shape_data);
    FillShapeSection(PyTuple_GetItem(r, 2), 2, aux_shape_size,
                     aux_shape_ndim, aux_shape_data);
    *complete = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(r, 3)));
    Py_DECREF(r);
  } else if (r == Py_None) {
    *complete = 0;
    Py_DECREF(r);
  }
  API_END();
}

}  // namespace

int MXSymbolInferShape(SymbolHandle sym, mx_uint num_args, const char** keys,
                       const mx_uint* arg_ind_ptr,
                       const mx_uint* arg_shape_data, mx_uint* in_shape_size,
                       const mx_uint** in_shape_ndim,
                       const mx_uint*** in_shape_data,
                       mx_uint* out_shape_size,
                       const mx_uint** out_shape_ndim,
                       const mx_uint*** out_shape_data,
                       mx_uint* aux_shape_size,
                       const mx_uint** aux_shape_ndim,
                       const mx_uint*** aux_shape_data, int* complete) {
  return InferShapeImpl(sym, num_args, keys, arg_ind_ptr, arg_shape_data,
                        in_shape_size, in_shape_ndim, in_shape_data,
                        out_shape_size, out_shape_ndim, out_shape_data,
                        aux_shape_size, aux_shape_ndim, aux_shape_data,
                        complete, 0);
}

int MXSymbolInferShapePartial(SymbolHandle sym, mx_uint num_args,
                              const char** keys, const mx_uint* arg_ind_ptr,
                              const mx_uint* arg_shape_data,
                              mx_uint* in_shape_size,
                              const mx_uint** in_shape_ndim,
                              const mx_uint*** in_shape_data,
                              mx_uint* out_shape_size,
                              const mx_uint** out_shape_ndim,
                              const mx_uint*** out_shape_data,
                              mx_uint* aux_shape_size,
                              const mx_uint** aux_shape_ndim,
                              const mx_uint*** aux_shape_data,
                              int* complete) {
  return InferShapeImpl(sym, num_args, keys, arg_ind_ptr, arg_shape_data,
                        in_shape_size, in_shape_ndim, in_shape_data,
                        out_shape_size, out_shape_ndim, out_shape_data,
                        aux_shape_size, aux_shape_ndim, aux_shape_data,
                        complete, 1);
}

int MXSymbolInferType(SymbolHandle sym, mx_uint num_args, const char** keys,
                      const int* arg_type_data, mx_uint* in_type_size,
                      const int** in_type_data, mx_uint* out_type_size,
                      const int** out_type_data, mx_uint* aux_type_size,
                      const int** aux_type_data, int* complete) {
  API_BEGIN();
  PyObject* ks = keys ? StrList(keys, num_args)
                      : (Py_INCREF(Py_None), Py_None);
  PyObject* codes = PyList_New(num_args);
  for (mx_uint i = 0; i < num_args; ++i) {
    PyList_SetItem(codes, i, PyLong_FromLong(arg_type_data[i]));
  }
  PyObject* r = Call("symbol_infer_type",
                     Py_BuildValue("(ONN)", static_cast<PyObject*>(sym), ks,
                                   codes));
  if (r && r != Py_None) {
    mx_uint* sizes[3] = {in_type_size, out_type_size, aux_type_size};
    const int** datas[3] = {in_type_data, out_type_data, aux_type_data};
    for (int sec = 0; sec < 3; ++sec) {
      PyObject* lst = PyTuple_GetItem(r, sec);
      Py_ssize_t n = PyList_Size(lst);
      g_tls.type_codes[sec].clear();
      for (Py_ssize_t i = 0; i < n; ++i) {
        g_tls.type_codes[sec].push_back(static_cast<int>(
            PyLong_AsLong(PyList_GetItem(lst, i))));
      }
      *sizes[sec] = static_cast<mx_uint>(n);
      *datas[sec] = g_tls.type_codes[sec].data();
    }
    *complete = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(r, 3)));
    Py_DECREF(r);
  } else if (r == Py_None) {
    *complete = 0;
    Py_DECREF(r);
  }
  API_END();
}

int MXSymbolListAtomicSymbolCreators(mx_uint* out_size,
                                     AtomicSymbolCreator** out_array) {
  API_BEGIN();
  PyObject* r = Call("all_op_names", PyTuple_New(0));
  if (r) {
    Py_ssize_t n = PyList_Size(r);
    g_tls.creators.clear();
    for (Py_ssize_t i = 0; i < n; ++i) {
      g_tls.creators.push_back(
          InternName(PyUnicode_AsUTF8(PyList_GetItem(r, i))));
    }
    *out_size = static_cast<mx_uint>(n);
    *out_array = g_tls.creators.data();
    Py_DECREF(r);
  }
  API_END();
}

int MXSymbolGetAtomicSymbolName(AtomicSymbolCreator creator,
                                const char** name) {
  API_BEGIN();
  *name = static_cast<const char*>(creator);
  API_END();
}

int MXSymbolGetAtomicSymbolInfo(AtomicSymbolCreator creator,
                                const char** name, const char** description,
                                mx_uint* num_args, const char*** arg_names,
                                const char*** arg_type_infos,
                                const char*** arg_descriptions,
                                const char** key_var_num_args,
                                const char** return_type) {
  API_BEGIN();
  PyObject* r = Call("func_info",
                     Py_BuildValue("(s)", static_cast<const char*>(creator)));
  if (r) {
    ReturnOpInfo(r, name, description, num_args, arg_names, arg_type_infos,
                 arg_descriptions, key_var_num_args, return_type);
    Py_DECREF(r);
  }
  API_END();
}

// ---------------------------------------------------------- executor extras
static int BindXImpl(SymbolHandle symbol, int dev_type, int dev_id,
                     mx_uint num_map_keys, const char** map_keys,
                     const int* map_dev_types, const int* map_dev_ids,
                     mx_uint len, NDArrayHandle* in_args,
                     NDArrayHandle* arg_grad_store, mx_uint* grad_req_type,
                     mx_uint aux_states_len, NDArrayHandle* aux_states,
                     ExecutorHandle shared_exec, ExecutorHandle* out) {
  API_BEGIN();
  PyObject* mk = map_keys ? StrList(map_keys, num_map_keys)
                          : PyList_New(0);
  PyObject* mt = PyList_New(num_map_keys);
  PyObject* mi = PyList_New(num_map_keys);
  for (mx_uint i = 0; i < num_map_keys; ++i) {
    PyList_SetItem(mt, i, PyLong_FromLong(map_dev_types[i]));
    PyList_SetItem(mi, i, PyLong_FromLong(map_dev_ids[i]));
  }
  PyObject* reqs = PyList_New(len);
  for (mx_uint i = 0; i < len; ++i) {
    PyList_SetItem(reqs, i,
                   PyLong_FromLong(grad_req_type ? grad_req_type[i] : 1));
  }
  PyObject* shared = static_cast<PyObject*>(shared_exec);
  if (shared == nullptr) shared = Py_None;
  Py_INCREF(shared);
  PyObject* r = Call("executor_bind_x",
                     Py_BuildValue("(OiiNNNNNNNN)",
                                   static_cast<PyObject*>(symbol), dev_type,
                                   dev_id, mk, mt, mi,
                                   HandleList(in_args, len),
                                   HandleList(arg_grad_store, len, true),
                                   reqs,
                                   HandleList(aux_states, aux_states_len),
                                   shared));
  if (r) *out = r;
  API_END();
}

int MXExecutorBindX(SymbolHandle symbol, int dev_type, int dev_id,
                    mx_uint num_map_keys, const char** map_keys,
                    const int* map_dev_types, const int* map_dev_ids,
                    mx_uint len, NDArrayHandle* in_args,
                    NDArrayHandle* arg_grad_store, mx_uint* grad_req_type,
                    mx_uint aux_states_len, NDArrayHandle* aux_states,
                    ExecutorHandle* out) {
  return BindXImpl(symbol, dev_type, dev_id, num_map_keys, map_keys,
                   map_dev_types, map_dev_ids, len, in_args, arg_grad_store,
                   grad_req_type, aux_states_len, aux_states, nullptr, out);
}

int MXExecutorBindEX(SymbolHandle symbol, int dev_type, int dev_id,
                     mx_uint num_map_keys, const char** map_keys,
                     const int* map_dev_types, const int* map_dev_ids,
                     mx_uint len, NDArrayHandle* in_args,
                     NDArrayHandle* arg_grad_store, mx_uint* grad_req_type,
                     mx_uint aux_states_len, NDArrayHandle* aux_states,
                     ExecutorHandle shared_exec, ExecutorHandle* out) {
  return BindXImpl(symbol, dev_type, dev_id, num_map_keys, map_keys,
                   map_dev_types, map_dev_ids, len, in_args, arg_grad_store,
                   grad_req_type, aux_states_len, aux_states, shared_exec,
                   out);
}

int MXExecutorPrint(ExecutorHandle handle, const char** out_str) {
  API_BEGIN();
  PyObject* r = Call("executor_print",
                     Py_BuildValue("(O)", static_cast<PyObject*>(handle)));
  if (r) {
    g_tls.json = PyUnicode_AsUTF8(r);
    *out_str = g_tls.json.c_str();
    Py_DECREF(r);
  }
  API_END();
}

int MXExecutorSetMonitorCallback(ExecutorHandle handle,
                                 ExecutorMonitorCallback callback,
                                 void* callback_handle) {
  API_BEGIN();
  PyObject* r = Call("executor_set_monitor_c",
                     Py_BuildValue("(OKK)", static_cast<PyObject*>(handle),
                                   reinterpret_cast<unsigned long long>(
                                       callback),
                                   reinterpret_cast<unsigned long long>(
                                       callback_handle)));
  Py_XDECREF(r);
  API_END();
}

// -------------------------------------------------------------- data iters
int MXListDataIters(mx_uint* out_size, DataIterCreator** out_array) {
  API_BEGIN();
  PyObject* r = Call("list_data_iters", PyTuple_New(0));
  if (r) {
    Py_ssize_t n = PyList_Size(r);
    g_tls.creators.clear();
    for (Py_ssize_t i = 0; i < n; ++i) {
      g_tls.creators.push_back(
          InternName(PyUnicode_AsUTF8(PyList_GetItem(r, i))));
    }
    *out_size = static_cast<mx_uint>(n);
    *out_array = g_tls.creators.data();
    Py_DECREF(r);
  }
  API_END();
}

int MXDataIterGetIterInfo(DataIterCreator creator, const char** name,
                          const char** description, mx_uint* num_args,
                          const char*** arg_names,
                          const char*** arg_type_infos,
                          const char*** arg_descriptions) {
  API_BEGIN();
  PyObject* r = Call("dataiter_info",
                     Py_BuildValue("(s)", static_cast<const char*>(creator)));
  if (r) {
    // same 5-tuple layout as func_info minus kvargs; pad for the decoder
    PyObject* empty = PyUnicode_FromString("");
    PyObject* padded = PyTuple_Pack(6, PyTuple_GetItem(r, 0),
                                    PyTuple_GetItem(r, 1),
                                    PyTuple_GetItem(r, 2),
                                    PyTuple_GetItem(r, 3),
                                    PyTuple_GetItem(r, 4), empty);
    Py_DECREF(empty);  // PyTuple_Pack took its own reference
    ReturnOpInfo(padded, name, description, num_args, arg_names,
                 arg_type_infos, arg_descriptions, nullptr, nullptr);
    Py_DECREF(padded);
    Py_DECREF(r);
  }
  API_END();
}

int MXDataIterCreateIter(DataIterCreator handle, mx_uint num_param,
                         const char** keys, const char** vals,
                         DataIterHandle* out) {
  API_BEGIN();
  PyObject* r = Call("dataiter_create",
                     Py_BuildValue("(sNN)", static_cast<const char*>(handle),
                                   StrList(keys, num_param),
                                   StrList(vals, num_param)));
  if (r) *out = r;
  API_END();
}

int MXDataIterFree(DataIterHandle handle) {
  API_BEGIN();
  Py_XDECREF(static_cast<PyObject*>(handle));
  API_END();
}

int MXDataIterNext(DataIterHandle handle, int* out) {
  API_BEGIN();
  PyObject* r = Call("dataiter_next",
                     Py_BuildValue("(O)", static_cast<PyObject*>(handle)));
  if (r) {
    *out = static_cast<int>(PyLong_AsLong(r));
    Py_DECREF(r);
  }
  API_END();
}

int MXDataIterBeforeFirst(DataIterHandle handle) {
  API_BEGIN();
  PyObject* r = Call("dataiter_before_first",
                     Py_BuildValue("(O)", static_cast<PyObject*>(handle)));
  Py_XDECREF(r);
  API_END();
}

int MXDataIterGetData(DataIterHandle handle, NDArrayHandle* out) {
  API_BEGIN();
  PyObject* r = Call("dataiter_getdata",
                     Py_BuildValue("(O)", static_cast<PyObject*>(handle)));
  if (r) *out = r;
  API_END();
}

int MXDataIterGetLabel(DataIterHandle handle, NDArrayHandle* out) {
  API_BEGIN();
  PyObject* r = Call("dataiter_getlabel",
                     Py_BuildValue("(O)", static_cast<PyObject*>(handle)));
  if (r == Py_None) {
    Py_DECREF(r);
    *out = nullptr;
  } else if (r) {
    *out = r;
  }
  API_END();
}

int MXDataIterGetIndex(DataIterHandle handle, uint64_t** out_index,
                       uint64_t* out_size) {
  API_BEGIN();
  PyObject* r = Call("dataiter_getindex",
                     Py_BuildValue("(O)", static_cast<PyObject*>(handle)));
  if (r) {
    Py_ssize_t n = PyList_Size(r);
    g_tls.index64.clear();
    for (Py_ssize_t i = 0; i < n; ++i) {
      g_tls.index64.push_back(static_cast<uint64_t>(
          PyLong_AsUnsignedLongLong(PyList_GetItem(r, i))));
    }
    *out_index = g_tls.index64.data();
    *out_size = static_cast<uint64_t>(n);
    Py_DECREF(r);
  }
  API_END();
}

int MXDataIterGetPadNum(DataIterHandle handle, int* pad) {
  API_BEGIN();
  PyObject* r = Call("dataiter_getpad",
                     Py_BuildValue("(O)", static_cast<PyObject*>(handle)));
  if (r) {
    *pad = static_cast<int>(PyLong_AsLong(r));
    Py_DECREF(r);
  }
  API_END();
}

// ------------------------------------------------------------------ kvstore
int MXInitPSEnv(mx_uint num_vars, const char** keys, const char** vals) {
  API_BEGIN();
  PyObject* r = Call("init_ps_env",
                     Py_BuildValue("(NN)", StrList(keys, num_vars),
                                   StrList(vals, num_vars)));
  Py_XDECREF(r);
  API_END();
}

int MXKVStoreCreate(const char* type, KVStoreHandle* out) {
  API_BEGIN();
  PyObject* r = Call("kvstore_create", Py_BuildValue("(s)", type));
  if (r) *out = r;
  API_END();
}

int MXKVStoreFree(KVStoreHandle handle) {
  API_BEGIN();
  Py_XDECREF(static_cast<PyObject*>(handle));
  API_END();
}

namespace {

PyObject* IntKeyList(const int* keys, mx_uint num) {
  PyObject* l = PyList_New(num);
  for (mx_uint i = 0; i < num; ++i) {
    PyList_SetItem(l, i, PyLong_FromLong(keys[i]));
  }
  return l;
}

}  // namespace

int MXKVStoreInit(KVStoreHandle handle, mx_uint num, const int* keys,
                  NDArrayHandle* vals) {
  API_BEGIN();
  PyObject* r = Call("kvstore_init",
                     Py_BuildValue("(ONN)", static_cast<PyObject*>(handle),
                                   IntKeyList(keys, num),
                                   HandleList(vals, num)));
  Py_XDECREF(r);
  API_END();
}

int MXKVStorePush(KVStoreHandle handle, mx_uint num, const int* keys,
                  NDArrayHandle* vals, int priority) {
  API_BEGIN();
  PyObject* r = Call("kvstore_push",
                     Py_BuildValue("(ONNi)", static_cast<PyObject*>(handle),
                                   IntKeyList(keys, num),
                                   HandleList(vals, num), priority));
  Py_XDECREF(r);
  API_END();
}

int MXKVStorePull(KVStoreHandle handle, mx_uint num, const int* keys,
                  NDArrayHandle* vals, int priority) {
  API_BEGIN();
  PyObject* r = Call("kvstore_pull",
                     Py_BuildValue("(ONNi)", static_cast<PyObject*>(handle),
                                   IntKeyList(keys, num),
                                   HandleList(vals, num), priority));
  Py_XDECREF(r);
  API_END();
}

int MXKVStoreSetUpdater(KVStoreHandle handle, MXKVStoreUpdater updater,
                        void* updater_handle) {
  API_BEGIN();
  PyObject* r = Call("kvstore_set_updater_c",
                     Py_BuildValue("(OKK)", static_cast<PyObject*>(handle),
                                   reinterpret_cast<unsigned long long>(
                                       updater),
                                   reinterpret_cast<unsigned long long>(
                                       updater_handle)));
  Py_XDECREF(r);
  API_END();
}

int MXKVStoreGetType(KVStoreHandle handle, const char** type) {
  API_BEGIN();
  PyObject* r = PyObject_GetAttrString(static_cast<PyObject*>(handle),
                                       "type");
  if (r) {
    g_tls.json = PyUnicode_AsUTF8(r);
    *type = g_tls.json.c_str();
    Py_DECREF(r);
  }
  API_END();
}

int MXKVStoreGetRank(KVStoreHandle handle, int* ret) {
  API_BEGIN();
  PyObject* r = PyObject_GetAttrString(static_cast<PyObject*>(handle),
                                       "rank");
  if (r) {
    *ret = static_cast<int>(PyLong_AsLong(r));
    Py_DECREF(r);
  }
  API_END();
}

int MXKVStoreGetGroupSize(KVStoreHandle handle, int* ret) {
  API_BEGIN();
  PyObject* r = PyObject_GetAttrString(static_cast<PyObject*>(handle),
                                       "num_workers");
  if (r) {
    *ret = static_cast<int>(PyLong_AsLong(r));
    Py_DECREF(r);
  }
  API_END();
}

static int KVStoreIsRole(const char* role, int* ret) {
  API_BEGIN();
  PyObject* r = Call("kvstore_is_role", Py_BuildValue("(s)", role));
  if (r) {
    *ret = static_cast<int>(PyLong_AsLong(r));
    Py_DECREF(r);
  }
  API_END();
}

int MXKVStoreIsWorkerNode(int* ret) { return KVStoreIsRole("worker", ret); }

int MXKVStoreIsServerNode(int* ret) { return KVStoreIsRole("server", ret); }

int MXKVStoreIsSchedulerNode(int* ret) {
  return KVStoreIsRole("scheduler", ret);
}

int MXKVStoreBarrier(KVStoreHandle handle) {
  API_BEGIN();
  PyObject* r = PyObject_CallMethod(static_cast<PyObject*>(handle),
                                    "barrier", nullptr);
  Py_XDECREF(r);
  API_END();
}

int MXKVStoreSetBarrierBeforeExit(KVStoreHandle handle,
                                  const int barrier_before_exit) {
  API_BEGIN();
  PyObject* r = PyObject_CallMethod(static_cast<PyObject*>(handle),
                                    "set_barrier_before_exit", "i",
                                    barrier_before_exit);
  Py_XDECREF(r);
  API_END();
}

int MXKVStoreRunServer(KVStoreHandle handle,
                       MXKVStoreServerController controller,
                       void* controller_handle) {
  API_BEGIN();
  PyObject* r = Call("kvstore_run_server_c",
                     Py_BuildValue("(OKK)", static_cast<PyObject*>(handle),
                                   reinterpret_cast<unsigned long long>(
                                       controller),
                                   reinterpret_cast<unsigned long long>(
                                       controller_handle)));
  Py_XDECREF(r);
  API_END();
}

int MXKVStoreSendCommmandToServers(KVStoreHandle handle, int cmd_id,
                                   const char* cmd_body) {
  API_BEGIN();
  PyObject* r = Call("kvstore_send_command",
                     Py_BuildValue("(Ois)", static_cast<PyObject*>(handle),
                                   cmd_id, cmd_body));
  Py_XDECREF(r);
  API_END();
}

int MXKVStoreGetNumDeadNode(KVStoreHandle handle, const int node_id,
                            int* number, const int timeout_sec) {
  API_BEGIN();
  PyObject* r = Call("kvstore_num_dead_node",
                     Py_BuildValue("(Oii)", static_cast<PyObject*>(handle),
                                   node_id, timeout_sec));
  if (r) {
    *number = static_cast<int>(PyLong_AsLong(r));
    Py_DECREF(r);
  }
  API_END();
}

// ---------------------------------------------------------------- recordio
int MXRecordIOWriterCreate(const char* uri, RecordIOHandle* out) {
  API_BEGIN();
  PyObject* r = Call("recordio_writer_create", Py_BuildValue("(s)", uri));
  if (r) *out = r;
  API_END();
}

static int RecordIOFree(RecordIOHandle handle) {
  API_BEGIN();
  PyObject* obj = static_cast<PyObject*>(handle);
  PyObject* r = PyObject_CallMethod(obj, "close", nullptr);
  Py_XDECREF(r);
  DropHandleBuf(handle);
  Py_XDECREF(obj);
  API_END();
}

int MXRecordIOWriterFree(RecordIOHandle handle) {
  return RecordIOFree(handle);
}

int MXRecordIOWriterWriteRecord(RecordIOHandle handle, const char* buf,
                                size_t size) {
  API_BEGIN();
  PyObject* blob = PyBytes_FromStringAndSize(buf,
                                             static_cast<Py_ssize_t>(size));
  PyObject* r = PyObject_CallMethod(static_cast<PyObject*>(handle), "write",
                                    "N", blob);
  Py_XDECREF(r);
  API_END();
}

int MXRecordIOWriterTell(RecordIOHandle handle, size_t* pos) {
  API_BEGIN();
  PyObject* r = PyObject_CallMethod(static_cast<PyObject*>(handle), "tell",
                                    nullptr);
  if (r) {
    *pos = static_cast<size_t>(PyLong_AsSize_t(r));
    Py_DECREF(r);
  }
  API_END();
}

int MXRecordIOReaderCreate(const char* uri, RecordIOHandle* out) {
  API_BEGIN();
  PyObject* r = Call("recordio_reader_create", Py_BuildValue("(s)", uri));
  if (r) *out = r;
  API_END();
}

int MXRecordIOReaderFree(RecordIOHandle handle) {
  return RecordIOFree(handle);
}

int MXRecordIOReaderReadRecord(RecordIOHandle handle, char const** buf,
                               size_t* size) {
  API_BEGIN();
  PyObject* r = Call("recordio_read",
                     Py_BuildValue("(O)", static_cast<PyObject*>(handle)));
  if (r == Py_None) {
    *buf = nullptr;  // end of file
    *size = 0;
    Py_DECREF(r);
  } else if (r) {
    char* data = nullptr;
    Py_ssize_t len = 0;
    PyBytes_AsStringAndSize(r, &data, &len);
    std::string& store = HandleBuf(handle);
    store.assign(data, len);
    *buf = store.data();
    *size = static_cast<size_t>(len);
    Py_DECREF(r);
  }
  API_END();
}

int MXRecordIOReaderSeek(RecordIOHandle handle, size_t pos) {
  API_BEGIN();
  PyObject* r = Call("recordio_seek",
                     Py_BuildValue("(On)", static_cast<PyObject*>(handle),
                                   static_cast<Py_ssize_t>(pos)));
  Py_XDECREF(r);
  API_END();
}

// --------------------------------------------------------------------- rtc
int MXRtcCreate(char* name, mx_uint num_input, mx_uint num_output,
                char** input_names, char** output_names,
                NDArrayHandle* inputs, NDArrayHandle* outputs, char* kernel,
                RtcHandle* out) {
  API_BEGIN();
  PyObject* r = Call(
      "rtc_create",
      Py_BuildValue("(sNNNNs)", name,
                    StrList(const_cast<const char**>(input_names), num_input),
                    StrList(const_cast<const char**>(output_names),
                            num_output),
                    HandleList(inputs, num_input),
                    HandleList(outputs, num_output), kernel));
  if (r) *out = r;
  API_END();
}

int MXRtcPush(RtcHandle handle, mx_uint num_input, mx_uint num_output,
              NDArrayHandle* inputs, NDArrayHandle* outputs, mx_uint gridDimX,
              mx_uint gridDimY, mx_uint gridDimZ, mx_uint blockDimX,
              mx_uint blockDimY, mx_uint blockDimZ) {
  API_BEGIN();
  PyObject* r = Call(
      "rtc_push",
      Py_BuildValue("(ONN(III)(III))", static_cast<PyObject*>(handle),
                    HandleList(inputs, num_input),
                    HandleList(outputs, num_output), gridDimX, gridDimY,
                    gridDimZ, blockDimX, blockDimY, blockDimZ));
  Py_XDECREF(r);
  API_END();
}

int MXRtcFree(RtcHandle handle) {
  API_BEGIN();
  Py_XDECREF(static_cast<PyObject*>(handle));
  API_END();
}

// --------------------------------------------------- predict API (extras)
int MXPredCreatePartialOut(const char* symbol_json_str,
                           const void* param_bytes, int param_size,
                           int dev_type, int dev_id, mx_uint num_input_nodes,
                           const char** input_keys,
                           const mx_uint* input_shape_indptr,
                           const mx_uint* input_shape_data,
                           mx_uint num_output_nodes, const char** output_keys,
                           PredictorHandle* out) {
  API_BEGIN();
  PyObject* names = StrList(input_keys, num_input_nodes);
  PyObject* shapes = PyList_New(num_input_nodes);
  for (mx_uint i = 0; i < num_input_nodes; ++i) {
    mx_uint b = input_shape_indptr[i], e = input_shape_indptr[i + 1];
    PyObject* s = PyList_New(e - b);
    for (mx_uint j = b; j < e; ++j) {
      PyList_SetItem(s, j - b, PyLong_FromUnsignedLong(input_shape_data[j]));
    }
    PyList_SetItem(shapes, i, s);
  }
  PyObject* blob = PyBytes_FromStringAndSize(
      static_cast<const char*>(param_bytes), param_size);
  PyObject* r = Call("pred_create_partial",
                     Py_BuildValue("(sNiiNNN)", symbol_json_str, blob,
                                   dev_type, dev_id, names, shapes,
                                   StrList(output_keys, num_output_nodes)));
  if (r) *out = r;
  API_END();
}

int MXPredPartialForward(PredictorHandle handle, int step, int* step_left) {
  API_BEGIN();
  // the forward is one call into the executor, so the first step runs
  // everything (reference runs node-by-node, c_predict_api.cc)
  if (step == 0) {
    PyObject* r = PyObject_CallMethod(static_cast<PyObject*>(handle),
                                      "forward", nullptr);
    Py_XDECREF(r);
  }
  *step_left = 0;
  API_END();
}

int MXNDListCreate(const char* nd_file_bytes, int nd_file_size,
                   NDListHandle* out, mx_uint* out_length) {
  API_BEGIN();
  PyObject* blob = PyBytes_FromStringAndSize(nd_file_bytes, nd_file_size);
  PyObject* r = Call("ndlist_create", Py_BuildValue("(N)", blob));
  if (r) {
    *out = r;
    PyObject* n = PyObject_CallMethod(r, "__len__", nullptr);
    if (n) {
      *out_length = static_cast<mx_uint>(PyLong_AsLong(n));
      Py_DECREF(n);
    }
  }
  API_END();
}

int MXNDListGet(NDListHandle handle, mx_uint index, const char** out_key,
                const mx_float** out_data, const mx_uint** out_shape,
                mx_uint* out_ndim) {
  API_BEGIN();
  PyObject* r = Call("ndlist_get",
                     Py_BuildValue("(OI)", static_cast<PyObject*>(handle),
                                   index));
  if (r) {
    // (key, data_bytes, shape); bytes buffer stays alive via the list's
    // internal cache (bridge keeps a reference per index)
    g_tls.json = PyUnicode_AsUTF8(PyTuple_GetItem(r, 0));
    *out_key = g_tls.json.c_str();
    *out_data = reinterpret_cast<const mx_float*>(
        PyBytes_AsString(PyTuple_GetItem(r, 1)));
    PyObject* shp = PyTuple_GetItem(r, 2);
    Py_ssize_t nd = PyList_Size(shp);
    g_tls.shape.clear();
    for (Py_ssize_t i = 0; i < nd; ++i) {
      g_tls.shape.push_back(static_cast<mx_uint>(
          PyLong_AsLong(PyList_GetItem(shp, i))));
    }
    *out_shape = g_tls.shape.data();
    *out_ndim = static_cast<mx_uint>(nd);
    Py_DECREF(r);
  }
  API_END();
}

int MXNDListFree(NDListHandle handle) {
  API_BEGIN();
  Py_XDECREF(static_cast<PyObject*>(handle));
  API_END();
}

}  // extern "C"
