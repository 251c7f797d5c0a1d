// C ABI shim over the tensor4all_tpu Python/XLA runtime.
//
// Native-runtime counterpart of the reference's tensor4all-capi crate
// (capi/src/lib.rs: thread-local error storage, status codes, panic
// catching at the boundary): opaque handles own CPython objects; every
// entry point grabs the GIL, converts C buffers to/from numpy, and maps
// Python exceptions to t4a_status_code + t4a_last_error_message().
//
// Works both embedded in a foreign host (Julia/C: t4a_init() boots the
// interpreter) and loaded into an existing Python process (init is a
// no-op; calls re-enter via PyGILState).

#include "include/t4a_capi.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdarg>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_last_error;

void set_error(const std::string &msg) { g_last_error = msg; }

// Fetch the pending Python exception into thread-local error storage
// and map it to an ABI status: validation failures raised by the helper
// layer (ValueError/KeyError/TypeError) become T4A_INVALID_ARGUMENT to
// match the reference's status semantics (ref capi/src/lib.rs:49);
// everything else is T4A_INTERNAL_ERROR.
t4a_status_code set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = "python error";
  if (value) {
    PyObject *s = PyObject_Str(value);
    if (s) {
      const char *c = PyUnicode_AsUTF8(s);
      if (c) msg = c;
      Py_DECREF(s);
    }
  }
  t4a_status_code code = T4A_INTERNAL_ERROR;
  if (type &&
      (PyErr_GivenExceptionMatches(type, PyExc_ValueError) ||
       PyErr_GivenExceptionMatches(type, PyExc_KeyError) ||
       PyErr_GivenExceptionMatches(type, PyExc_TypeError)))
    code = T4A_INVALID_ARGUMENT;
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  set_error(msg);
  return code;
}

struct GilGuard {
  PyGILState_STATE state;
  GilGuard() : state(PyGILState_Ensure()) {}
  ~GilGuard() { PyGILState_Release(state); }
};

bool g_we_initialized = false;

PyObject *t4a_module() {
  static PyObject *mod = nullptr;
  if (!mod) {
    mod = PyImport_ImportModule("tensor4all_tpu");
  }
  return mod;
}

PyObject *np_module() {
  static PyObject *np = nullptr;
  if (!np) np = PyImport_ImportModule("numpy");
  return np;
}

// column-major numpy f64 array from a C buffer + dims
PyObject *array_from_buffer(const double *data, size_t len,
                            const int64_t *dims, size_t rank) {
  PyObject *np = np_module();
  if (!np) return nullptr;
  PyObject *mv = PyMemoryView_FromMemory(
      reinterpret_cast<char *>(const_cast<double *>(data)),
      static_cast<Py_ssize_t>(len * sizeof(double)), PyBUF_READ);
  if (!mv) return nullptr;
  PyObject *flat =
      PyObject_CallMethod(np, "frombuffer", "Os", mv, "float64");
  Py_DECREF(mv);
  if (!flat) return nullptr;
  PyObject *shape = PyTuple_New(static_cast<Py_ssize_t>(rank));
  for (size_t k = 0; k < rank; ++k)
    PyTuple_SetItem(shape, static_cast<Py_ssize_t>(k),
                    PyLong_FromLongLong(dims[k]));
  // np.reshape accepts order positionally (ndarray.reshape does not);
  // copy() afterwards detaches from the borrowed C buffer
  PyObject *reshaped = PyObject_CallMethod(
      np, "reshape", "OOs", flat, shape, "F");
  Py_DECREF(flat);
  Py_DECREF(shape);
  if (!reshaped) return nullptr;
  PyObject *owned = PyObject_CallMethod(reshaped, "copy", nullptr);
  Py_DECREF(reshaped);
  return owned;
}

// flatten a tensor payload column-major into out
bool payload_to_buffer(PyObject *tensor, double *out, size_t len) {
  PyObject *np = np_module();
  PyObject *data = PyObject_GetAttrString(tensor, "data");
  if (!data) return false;
  PyObject *arr = PyObject_CallMethod(np, "asarray", "Os", data, "float64");
  Py_DECREF(data);
  if (!arr) return false;
  PyObject *flat = PyObject_CallMethod(arr, "flatten", "s", "F");
  Py_DECREF(arr);
  if (!flat) return false;
  PyObject *bytes = PyObject_CallMethod(flat, "tobytes", nullptr);
  Py_DECREF(flat);
  if (!bytes) return false;
  char *buf = nullptr;
  Py_ssize_t n = 0;
  if (PyBytes_AsStringAndSize(bytes, &buf, &n) != 0) {
    Py_DECREF(bytes);
    return false;
  }
  if (static_cast<size_t>(n) != len * sizeof(double)) {
    Py_DECREF(bytes);
    set_error("payload length mismatch");
    return false;
  }
  std::memcpy(out, buf, static_cast<size_t>(n));
  Py_DECREF(bytes);
  return true;
}

}  // namespace

struct t4a_index {
  PyObject *obj;
};
struct t4a_tensor {
  PyObject *obj;
};
struct t4a_tt {
  PyObject *obj;
};

extern "C" {

const char *t4a_last_error_message(void) { return g_last_error.c_str(); }

t4a_status_code t4a_init(void) {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_we_initialized = true;
    // release the GIL acquired by initialization so GilGuard can take it
    PyEval_SaveThread();
  }
  GilGuard gil;
  if (!t4a_module()) {
    return set_error_from_python();
  }
  return T4A_OK;
}

void t4a_shutdown(void) {
  // Leave the interpreter alive: JAX runtimes do not survive
  // re-initialization (matches long-lived host processes like Julia).
}

/* ------------------------------ Index ----------------------------- */

t4a_status_code t4a_index_new(int64_t dim, const char *tags,
                              t4a_index **out) {
  if (!out || dim < 0) {
    set_error("invalid argument");
    return T4A_INVALID_ARGUMENT;
  }
  GilGuard gil;
  PyObject *mod = t4a_module();
  if (!mod) {
    return set_error_from_python();
  }
  PyObject *obj = PyObject_CallMethod(mod, "Index", "Ls", (long long)dim,
                                      tags ? tags : "");
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_index{obj};
  return T4A_OK;
}

static t4a_status_code index_int_attr(const t4a_index *idx,
                                      const char *name, int64_t *out) {
  if (!idx || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *v = PyObject_GetAttrString(idx->obj, name);
  if (!v) {
    return set_error_from_python();
  }
  *out = PyLong_AsLongLong(v);
  Py_DECREF(v);
  if (PyErr_Occurred()) {
    return set_error_from_python();
  }
  return T4A_OK;
}

t4a_status_code t4a_index_dim(const t4a_index *idx, int64_t *out) {
  return index_int_attr(idx, "dim", out);
}

t4a_status_code t4a_index_plev(const t4a_index *idx, int64_t *out) {
  return index_int_attr(idx, "plev", out);
}

t4a_status_code t4a_index_id(const t4a_index *idx, uint64_t *out) {
  int64_t v = 0;
  t4a_status_code st = index_int_attr(idx, "id", &v);
  if (st == T4A_OK) *out = static_cast<uint64_t>(v);
  return st;
}

t4a_status_code t4a_index_prime(const t4a_index *idx, int64_t inc,
                                t4a_index **out) {
  if (!idx || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *obj = PyObject_CallMethod(idx->obj, "prime", "L",
                                      (long long)inc);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_index{obj};
  return T4A_OK;
}

t4a_status_code t4a_index_equal(const t4a_index *a, const t4a_index *b,
                                int *out) {
  if (!a || !b || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  int r = PyObject_RichCompareBool(a->obj, b->obj, Py_EQ);
  if (r < 0) {
    return set_error_from_python();
  }
  *out = r;
  return T4A_OK;
}

void t4a_index_free(t4a_index *idx) {
  if (!idx) return;
  GilGuard gil;
  Py_XDECREF(idx->obj);
  delete idx;
}

/* ------------------------------ Tensor ---------------------------- */

t4a_status_code t4a_tensor_new(const t4a_index *const *indices,
                               size_t rank, const double *data,
                               size_t len, t4a_tensor **out) {
  if (!out || (rank && !indices) || (len && !data)) {
    set_error("invalid argument");
    return T4A_INVALID_ARGUMENT;
  }
  GilGuard gil;
  PyObject *mod = t4a_module();
  if (!mod) {
    return set_error_from_python();
  }
  std::vector<int64_t> dims(rank);
  size_t expect = 1;
  PyObject *inds = PyTuple_New(static_cast<Py_ssize_t>(rank));
  for (size_t k = 0; k < rank; ++k) {
    PyObject *dimv = PyObject_GetAttrString(indices[k]->obj, "dim");
    dims[k] = PyLong_AsLongLong(dimv);
    Py_DECREF(dimv);
    expect *= static_cast<size_t>(dims[k]);
    Py_INCREF(indices[k]->obj);
    PyTuple_SetItem(inds, static_cast<Py_ssize_t>(k), indices[k]->obj);
  }
  if (expect != len) {
    Py_DECREF(inds);
    set_error("data length does not match index dims");
    return T4A_INVALID_ARGUMENT;
  }
  PyObject *arr = array_from_buffer(data, len, dims.data(), rank);
  if (!arr) {
    Py_DECREF(inds);
    return set_error_from_python();
  }
  PyObject *obj = PyObject_CallMethod(mod, "Tensor", "OO", inds, arr);
  Py_DECREF(inds);
  Py_DECREF(arr);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_tensor{obj};
  return T4A_OK;
}

t4a_status_code t4a_tensor_rank(const t4a_tensor *t, size_t *out) {
  if (!t || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *v = PyObject_GetAttrString(t->obj, "ndim");
  if (!v) {
    return set_error_from_python();
  }
  *out = static_cast<size_t>(PyLong_AsLongLong(v));
  Py_DECREF(v);
  return T4A_OK;
}

t4a_status_code t4a_tensor_dims(const t4a_tensor *t, int64_t *dims,
                                size_t cap) {
  if (!t || !dims) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *shape = PyObject_GetAttrString(t->obj, "shape");
  if (!shape) {
    return set_error_from_python();
  }
  Py_ssize_t n = PyTuple_Size(shape);
  if (static_cast<size_t>(n) > cap) {
    Py_DECREF(shape);
    set_error("dims buffer too small");
    return T4A_INVALID_ARGUMENT;
  }
  for (Py_ssize_t k = 0; k < n; ++k)
    dims[k] = PyLong_AsLongLong(PyTuple_GetItem(shape, k));
  Py_DECREF(shape);
  return T4A_OK;
}

t4a_status_code t4a_tensor_data(const t4a_tensor *t, double *data,
                                size_t len) {
  if (!t || !data) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  if (!payload_to_buffer(t->obj, data, len)) {
    if (PyErr_Occurred()) return set_error_from_python();
    // payload_to_buffer's length-mismatch branch set_error()s without
    // raising a Python exception; surface it as a status, never T4A_OK
    // with an unfilled output buffer.
    return T4A_INVALID_ARGUMENT;
  }
  return T4A_OK;
}

t4a_status_code t4a_tensor_norm(const t4a_tensor *t, double *out) {
  if (!t || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *v = PyObject_CallMethod(t->obj, "norm", nullptr);
  if (!v) {
    return set_error_from_python();
  }
  PyObject *f = PyNumber_Float(v);
  Py_DECREF(v);
  if (!f) {
    return set_error_from_python();
  }
  *out = PyFloat_AsDouble(f);
  Py_DECREF(f);
  return T4A_OK;
}

t4a_status_code t4a_tensor_contract(const t4a_tensor *const *tensors,
                                    size_t n, t4a_tensor **out) {
  if (!tensors || !n || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *mod = t4a_module();
  PyObject *list = PyList_New(static_cast<Py_ssize_t>(n));
  for (size_t k = 0; k < n; ++k) {
    Py_INCREF(tensors[k]->obj);
    PyList_SetItem(list, static_cast<Py_ssize_t>(k), tensors[k]->obj);
  }
  PyObject *obj = PyObject_CallMethod(mod, "contract", "O", list);
  Py_DECREF(list);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_tensor{obj};
  return T4A_OK;
}

t4a_status_code t4a_tensor_svd(const t4a_tensor *t, size_t n_left,
                               double rtol, int64_t maxdim,
                               t4a_tensor **u, t4a_tensor **s,
                               t4a_tensor **vh) {
  if (!t || !u || !s || !vh) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *mod = t4a_module();
  PyObject *helpers = PyImport_ImportModule("tensor4all_tpu.capi.helpers");
  if (!helpers) {
    return set_error_from_python();
  }
  PyObject *res = PyObject_CallMethod(
      helpers, "svd_first_n", "OndL", t->obj, (Py_ssize_t)n_left, rtol,
      (long long)maxdim);
  Py_DECREF(helpers);
  if (!res) {
    return set_error_from_python();
  }
  PyObject *pu = PyTuple_GetItem(res, 0);
  PyObject *ps = PyTuple_GetItem(res, 1);
  PyObject *pv = PyTuple_GetItem(res, 2);
  Py_INCREF(pu);
  Py_INCREF(ps);
  Py_INCREF(pv);
  Py_DECREF(res);
  *u = new t4a_tensor{pu};
  *s = new t4a_tensor{ps};
  *vh = new t4a_tensor{pv};
  return T4A_OK;
}

void t4a_tensor_free(t4a_tensor *t) {
  if (!t) return;
  GilGuard gil;
  Py_XDECREF(t->obj);
  delete t;
}

/* ------------------------------ TT + TCI -------------------------- */

t4a_status_code t4a_tt_constant(const int64_t *local_dims, size_t n,
                                double value, t4a_tt **out) {
  if (!local_dims || !n || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *ttmod = PyImport_ImportModule("tensor4all_tpu.tt");
  if (!ttmod) {
    return set_error_from_python();
  }
  PyObject *cls = PyObject_GetAttrString(ttmod, "TensorTrain");
  Py_DECREF(ttmod);
  PyObject *dims = PyList_New(static_cast<Py_ssize_t>(n));
  for (size_t k = 0; k < n; ++k)
    PyList_SetItem(dims, static_cast<Py_ssize_t>(k),
                   PyLong_FromLongLong(local_dims[k]));
  PyObject *obj = PyObject_CallMethod(cls, "constant", "Od", dims, value);
  Py_DECREF(cls);
  Py_DECREF(dims);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_tt{obj};
  return T4A_OK;
}

t4a_status_code t4a_tt_new(const double *const *cores,
                           const int64_t *shapes, size_t n,
                           t4a_tt **out) {
  if (!cores || !shapes || !n || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *ttmod = PyImport_ImportModule("tensor4all_tpu.tt");
  if (!ttmod) {
    return set_error_from_python();
  }
  PyObject *cls = PyObject_GetAttrString(ttmod, "TensorTrain");
  Py_DECREF(ttmod);
  PyObject *lst = PyList_New(static_cast<Py_ssize_t>(n));
  for (size_t k = 0; k < n; ++k) {
    const int64_t *sh = shapes + 3 * k;
    size_t len = static_cast<size_t>(sh[0]) * static_cast<size_t>(sh[1]) *
                 static_cast<size_t>(sh[2]);
    PyObject *arr = array_from_buffer(cores[k], len, sh, 3);
    if (!arr) {
      Py_DECREF(lst);
      Py_DECREF(cls);
      return set_error_from_python();
    }
    PyList_SetItem(lst, static_cast<Py_ssize_t>(k), arr);
  }
  PyObject *obj = PyObject_CallFunction(cls, "O", lst);
  Py_DECREF(cls);
  Py_DECREF(lst);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_tt{obj};
  return T4A_OK;
}

t4a_status_code t4a_tt_len(const t4a_tt *tt, size_t *out) {
  if (!tt || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  Py_ssize_t n = PyObject_Length(tt->obj);
  if (n < 0) {
    return set_error_from_python();
  }
  *out = static_cast<size_t>(n);
  return T4A_OK;
}

t4a_status_code t4a_tt_ranks(const t4a_tt *tt, int64_t *ranks,
                             size_t cap) {
  if (!tt || !ranks) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *r = PyObject_GetAttrString(tt->obj, "ranks");
  if (!r) {
    return set_error_from_python();
  }
  Py_ssize_t n = PyList_Size(r);
  if (static_cast<size_t>(n) > cap) {
    Py_DECREF(r);
    set_error("ranks buffer too small");
    return T4A_INVALID_ARGUMENT;
  }
  for (Py_ssize_t k = 0; k < n; ++k)
    ranks[k] = PyLong_AsLongLong(PyList_GetItem(r, k));
  Py_DECREF(r);
  return T4A_OK;
}

t4a_status_code t4a_tt_sum(const t4a_tt *tt, double *out) {
  if (!tt || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *v = PyObject_CallMethod(tt->obj, "sum", nullptr);
  if (!v) {
    return set_error_from_python();
  }
  PyObject *f = PyNumber_Float(v);
  Py_DECREF(v);
  if (!f) {
    return set_error_from_python();
  }
  *out = PyFloat_AsDouble(f);
  Py_DECREF(f);
  return T4A_OK;
}

t4a_status_code t4a_tt_evaluate(const t4a_tt *tt, const int64_t *idx,
                                size_t n, double *out) {
  if (!tt || !idx || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *lst = PyList_New(static_cast<Py_ssize_t>(n));
  for (size_t k = 0; k < n; ++k)
    PyList_SetItem(lst, static_cast<Py_ssize_t>(k),
                   PyLong_FromLongLong(idx[k]));
  PyObject *v = PyObject_CallMethod(tt->obj, "evaluate", "O", lst);
  Py_DECREF(lst);
  if (!v) {
    return set_error_from_python();
  }
  PyObject *f = PyNumber_Float(v);
  Py_DECREF(v);
  if (!f) {
    return set_error_from_python();
  }
  *out = PyFloat_AsDouble(f);
  Py_DECREF(f);
  return T4A_OK;
}

t4a_status_code t4a_tt_compress(const t4a_tt *tt, double tol,
                                int64_t maxdim, t4a_tt **out) {
  if (!tt || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *md = maxdim > 0 ? PyLong_FromLongLong(maxdim) : Py_None;
  if (md == Py_None) Py_INCREF(Py_None);
  PyObject *obj =
      PyObject_CallMethod(tt->obj, "compress", "dO", tol, md);
  Py_DECREF(md);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_tt{obj};
  return T4A_OK;
}

namespace {

// Python-callable wrapping the C batch callback via a capsule.
struct CallbackBox {
  t4a_batch_fn fn;
  void *user_data;
};

PyObject *callback_trampoline(PyObject *self, PyObject *args) {
  PyObject *idx_obj = nullptr;
  if (!PyArg_ParseTuple(args, "O", &idx_obj)) return nullptr;
  CallbackBox *box =
      static_cast<CallbackBox *>(PyCapsule_GetPointer(self, "t4a.cb"));
  if (!box) return nullptr;
  PyObject *np = np_module();
  PyObject *arr = PyObject_CallMethod(np, "ascontiguousarray", "Os",
                                      idx_obj, "int64");
  if (!arr) return nullptr;
  PyObject *shape = PyObject_GetAttrString(arr, "shape");
  Py_ssize_t B = PyLong_AsLongLong(PyTuple_GetItem(shape, 0));
  Py_ssize_t L = PyLong_AsLongLong(PyTuple_GetItem(shape, 1));
  Py_DECREF(shape);
  PyObject *bytes = PyObject_CallMethod(arr, "tobytes", nullptr);
  Py_DECREF(arr);
  if (!bytes) return nullptr;
  const int64_t *idx =
      reinterpret_cast<const int64_t *>(PyBytes_AsString(bytes));
  std::vector<double> out(static_cast<size_t>(B));
  int rc = box->fn(idx, static_cast<size_t>(B), static_cast<size_t>(L),
                   out.data(), box->user_data);
  Py_DECREF(bytes);
  if (rc != 0) {
    PyErr_SetString(PyExc_RuntimeError, "t4a batch callback failed");
    return nullptr;
  }
  int64_t dims[1] = {static_cast<int64_t>(B)};
  return array_from_buffer(out.data(), static_cast<size_t>(B), dims, 1);
}

PyMethodDef callback_def = {"t4a_callback", callback_trampoline,
                            METH_VARARGS, nullptr};

void capsule_destructor(PyObject *cap) {
  delete static_cast<CallbackBox *>(PyCapsule_GetPointer(cap, "t4a.cb"));
}

}  // namespace

t4a_status_code t4a_crossinterpolate2(t4a_batch_fn f, void *user_data,
                                      const int64_t *local_dims, size_t n,
                                      double tol, int64_t maxdim,
                                      int64_t max_iter, t4a_tt **out) {
  if (!f || !local_dims || !n || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *helpers = PyImport_ImportModule("tensor4all_tpu.capi.helpers");
  if (!helpers) {
    return set_error_from_python();
  }
  CallbackBox *box = new CallbackBox{f, user_data};
  PyObject *cap = PyCapsule_New(box, "t4a.cb", capsule_destructor);
  PyObject *pyfn = PyCFunction_New(&callback_def, cap);
  Py_DECREF(cap);
  PyObject *dims = PyList_New(static_cast<Py_ssize_t>(n));
  for (size_t k = 0; k < n; ++k)
    PyList_SetItem(dims, static_cast<Py_ssize_t>(k),
                   PyLong_FromLongLong(local_dims[k]));
  PyObject *res = PyObject_CallMethod(
      helpers, "crossinterpolate2_c", "OOdLL", pyfn, dims, tol,
      (long long)maxdim, (long long)max_iter);
  Py_DECREF(pyfn);
  Py_DECREF(dims);
  Py_DECREF(helpers);
  if (!res) {
    return set_error_from_python();
  }
  *out = new t4a_tt{res};
  return T4A_OK;
}

void t4a_tt_free(t4a_tt *tt) {
  if (!tt) return;
  GilGuard gil;
  Py_XDECREF(tt->obj);
  delete tt;
}

}  // extern "C"

/* ==================================================================== */
/* Extended surface (round 2): TreeTN, evaluators, QTT layouts,         */
/* quantics transform materializers, complex tensors                    */
/* (ref tensor4all-capi treetn.rs:1-2052, quanticstransform.rs:1-736)   */
/* ==================================================================== */

struct t4a_treetn {
  PyObject *obj;
};
struct t4a_treetn_evaluator {
  PyObject *obj;
};
struct t4a_qtt_layout {
  PyObject *obj;
};

namespace {

PyObject *helpers_module() {
  static PyObject *h = nullptr;
  if (!h) h = PyImport_ImportModule("tensor4all_tpu.capi.helpers");
  return h;
}

// varargs helper call; returns new ref or nullptr with error set
PyObject *call_h(const char *name, const char *fmt, ...) {
  PyObject *helpers = helpers_module();
  if (!helpers) return nullptr;
  PyObject *fn = PyObject_GetAttrString(helpers, name);
  if (!fn) return nullptr;
  va_list va;
  va_start(va, fmt);
  PyObject *args = Py_VaBuildValue(fmt, va);
  va_end(va);
  if (!args) {
    Py_DECREF(fn);
    return nullptr;
  }
  if (!PyTuple_Check(args)) {
    PyObject *t = PyTuple_Pack(1, args);
    Py_DECREF(args);
    args = t;
  }
  PyObject *res = PyObject_CallObject(fn, args);
  Py_DECREF(fn);
  Py_DECREF(args);
  return res;
}

t4a_status_code copy_string_out(PyObject *str, char *buf, size_t cap) {
  const char *c = PyUnicode_AsUTF8(str);
  if (!c) {
    return set_error_from_python();
  }
  size_t n = std::strlen(c);
  if (n + 1 > cap) {
    set_error("string buffer too small");
    return T4A_INVALID_ARGUMENT;
  }
  std::memcpy(buf, c, n + 1);
  return T4A_OK;
}

// list of index handles -> python list (borrowed handles, incref'd)
PyObject *index_list(const t4a_index *const *idxs, size_t n) {
  PyObject *lst = PyList_New(static_cast<Py_ssize_t>(n));
  for (size_t k = 0; k < n; ++k) {
    Py_INCREF(idxs[k]->obj);
    PyList_SetItem(lst, static_cast<Py_ssize_t>(k), idxs[k]->obj);
  }
  return lst;
}

}  // namespace

extern "C" {

/* ------------------------------ Index (extended) ------------------- */

t4a_status_code t4a_index_clone(const t4a_index *idx, t4a_index **out) {
  if (!idx || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  Py_INCREF(idx->obj);
  *out = new t4a_index{idx->obj};
  return T4A_OK;
}

int t4a_index_is_assigned(const t4a_index *idx) {
  return idx && idx->obj ? 1 : 0;
}

t4a_status_code t4a_index_noprime(const t4a_index *idx, t4a_index **out) {
  if (!idx || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *obj = PyObject_CallMethod(idx->obj, "noprime", nullptr);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_index{obj};
  return T4A_OK;
}

t4a_status_code t4a_index_set_plev(const t4a_index *idx, int64_t plev,
                                   t4a_index **out) {
  if (!idx || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *obj = PyObject_CallMethod(idx->obj, "set_plev", "L",
                                      (long long)plev);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_index{obj};
  return T4A_OK;
}

t4a_status_code t4a_index_tags(const t4a_index *idx, char *buf,
                               size_t cap) {
  if (!idx || !buf) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *tags = PyObject_GetAttrString(idx->obj, "tags");
  if (!tags) {
    return set_error_from_python();
  }
  PyObject *s = PyObject_Str(tags);
  Py_DECREF(tags);
  if (!s) {
    return set_error_from_python();
  }
  t4a_status_code st = copy_string_out(s, buf, cap);
  Py_DECREF(s);
  return st;
}

t4a_status_code t4a_index_has_tag(const t4a_index *idx, const char *tag,
                                  int *out) {
  if (!idx || !tag || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *tags = PyObject_GetAttrString(idx->obj, "tags");
  if (!tags) {
    return set_error_from_python();
  }
  PyObject *s = PyObject_Str(tags);
  Py_DECREF(tags);
  if (!s) {
    return set_error_from_python();
  }
  const char *c = PyUnicode_AsUTF8(s);
  *out = (c && std::strstr(c, tag)) ? 1 : 0;
  Py_DECREF(s);
  return T4A_OK;
}

t4a_status_code t4a_index_hash(const t4a_index *idx, uint64_t *out) {
  if (!idx || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  Py_hash_t h = PyObject_Hash(idx->obj);
  if (h == -1 && PyErr_Occurred()) {
    return set_error_from_python();
  }
  *out = static_cast<uint64_t>(h);
  return T4A_OK;
}

t4a_status_code t4a_index_new_with_id(int64_t dim, const char *tags,
                                      uint64_t id, int64_t plev,
                                      t4a_index **out) {
  if (!out || dim < 0) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *mod = t4a_module();
  if (!mod) {
    return set_error_from_python();
  }
  PyObject *cls = PyObject_GetAttrString(mod, "Index");
  if (!cls) {
    return set_error_from_python();
  }
  PyObject *args = Py_BuildValue("(Ls)", (long long)dim,
                                 tags ? tags : "");
  PyObject *kw = Py_BuildValue("{s:K,s:L}", "id",
                               (unsigned long long)id, "plev",
                               (long long)plev);
  PyObject *obj = PyObject_Call(cls, args, kw);
  Py_DECREF(cls);
  Py_DECREF(args);
  Py_DECREF(kw);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_index{obj};
  return T4A_OK;
}

void t4a_index_release(t4a_index *idx) { t4a_index_free(idx); }

/* ------------------------------ Tensor (extended) ------------------ */

t4a_status_code t4a_tensor_clone(const t4a_tensor *t, t4a_tensor **out) {
  if (!t || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  Py_INCREF(t->obj);
  *out = new t4a_tensor{t->obj};
  return T4A_OK;
}

int t4a_tensor_is_assigned(const t4a_tensor *t) {
  return t && t->obj ? 1 : 0;
}

t4a_status_code t4a_tensor_conj(const t4a_tensor *t, t4a_tensor **out) {
  if (!t || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *obj = PyObject_CallMethod(t->obj, "conj", nullptr);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_tensor{obj};
  return T4A_OK;
}

t4a_status_code t4a_tensor_add(const t4a_tensor *a, const t4a_tensor *b,
                               t4a_tensor **out) {
  if (!a || !b || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *obj = call_h("tensor_add", "(OO)", a->obj, b->obj);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_tensor{obj};
  return T4A_OK;
}

t4a_status_code t4a_tensor_scale(const t4a_tensor *t, double re,
                                 double im, t4a_tensor **out) {
  if (!t || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *obj = call_h("tensor_scale", "(Odd)", t->obj, re, im);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_tensor{obj};
  return T4A_OK;
}

t4a_status_code t4a_tensor_qr(const t4a_tensor *t, size_t n_left,
                              t4a_tensor **q, t4a_tensor **r) {
  if (!t || !q || !r) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *res = call_h("tensor_qr", "(On)", t->obj,
                         (Py_ssize_t)n_left);
  if (!res) {
    return set_error_from_python();
  }
  PyObject *pq = PyTuple_GetItem(res, 0);
  PyObject *pr = PyTuple_GetItem(res, 1);
  Py_INCREF(pq);
  Py_INCREF(pr);
  Py_DECREF(res);
  *q = new t4a_tensor{pq};
  *r = new t4a_tensor{pr};
  return T4A_OK;
}

t4a_status_code t4a_tensor_indices(const t4a_tensor *t,
                                   t4a_index **out, size_t cap) {
  if (!t || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *inds = PyObject_GetAttrString(t->obj, "indices");
  if (!inds) {
    return set_error_from_python();
  }
  Py_ssize_t n = PySequence_Size(inds);
  if (static_cast<size_t>(n) > cap) {
    Py_DECREF(inds);
    set_error("indices buffer too small");
    return T4A_INVALID_ARGUMENT;
  }
  for (Py_ssize_t k = 0; k < n; ++k) {
    PyObject *it = PySequence_GetItem(inds, k);  // new ref
    out[k] = reinterpret_cast<t4a_index *>(new t4a_index{it});
  }
  Py_DECREF(inds);
  return T4A_OK;
}

t4a_status_code t4a_tensor_select_indices(const t4a_tensor *t,
                                          const t4a_index *idx,
                                          int64_t value,
                                          t4a_tensor **out) {
  if (!t || !idx || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *obj = call_h("tensor_select", "(OOL)", t->obj, idx->obj,
                         (long long)value);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_tensor{obj};
  return T4A_OK;
}

/* storage introspection: the JAX runtime is dense-only (SURVEY.md design
 * stance: diag/structured fast paths are subsumed by XLA fusion) */
t4a_status_code t4a_tensor_storage_kind(const t4a_tensor *t, int *out) {
  if (!t || !out) return T4A_INVALID_ARGUMENT;
  *out = 0; /* T4A_STORAGE_DENSE */
  return T4A_OK;
}

t4a_status_code t4a_tensor_scalar_kind(const t4a_tensor *t, int *out) {
  if (!t || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *data = PyObject_GetAttrString(t->obj, "data");
  if (!data) {
    return set_error_from_python();
  }
  PyObject *dt = PyObject_GetAttrString(data, "dtype");
  Py_DECREF(data);
  PyObject *s = PyObject_Str(dt);
  Py_DECREF(dt);
  const char *c = PyUnicode_AsUTF8(s);
  *out = (c && std::strstr(c, "complex")) ? 1 : 0;
  Py_DECREF(s);
  return T4A_OK;
}

t4a_status_code t4a_tensor_payload_rank(const t4a_tensor *t,
                                        size_t *out) {
  return t4a_tensor_rank(t, out);
}

t4a_status_code t4a_tensor_payload_dims(const t4a_tensor *t,
                                        int64_t *dims, size_t cap) {
  return t4a_tensor_dims(t, dims, cap);
}

t4a_status_code t4a_tensor_payload_len(const t4a_tensor *t,
                                       size_t *out) {
  if (!t || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *data = PyObject_GetAttrString(t->obj, "data");
  if (!data) {
    return set_error_from_python();
  }
  PyObject *sz = PyObject_GetAttrString(data, "size");
  Py_DECREF(data);
  if (!sz) {
    return set_error_from_python();
  }
  *out = static_cast<size_t>(PyLong_AsLongLong(sz));
  Py_DECREF(sz);
  return T4A_OK;
}

t4a_status_code t4a_tensor_payload_strides(const t4a_tensor *t,
                                           int64_t *strides, size_t cap) {
  /* column-major strides in ELEMENTS (ref ColMajorArray interchange) */
  if (!t || !strides) return T4A_INVALID_ARGUMENT;
  int64_t dims[64];
  size_t rank = 0;
  t4a_status_code st = t4a_tensor_rank(t, &rank);
  if (st != T4A_OK) return st;
  if (rank > 64 || rank > cap) {
    set_error("strides buffer too small");
    return T4A_INVALID_ARGUMENT;
  }
  st = t4a_tensor_dims(t, dims, 64);
  if (st != T4A_OK) return st;
  int64_t acc = 1;
  for (size_t k = 0; k < rank; ++k) {
    strides[k] = acc;
    acc *= dims[k];
  }
  return T4A_OK;
}

t4a_status_code t4a_tensor_copy_payload_f64(const t4a_tensor *t,
                                            double *data, size_t len) {
  return t4a_tensor_data(t, data, len);
}

t4a_status_code t4a_tensor_new_dense_c64(const t4a_index *const *indices,
                                         size_t rank, const double *re,
                                         const double *im, size_t len,
                                         t4a_tensor **out) {
  if (!out || (rank && !indices) || (len && (!re || !im)))
    return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *inds = index_list(indices, rank);
  std::vector<int64_t> dims(rank);
  for (size_t k = 0; k < rank; ++k) {
    PyObject *d = PyObject_GetAttrString(indices[k]->obj, "dim");
    dims[k] = PyLong_AsLongLong(d);
    Py_DECREF(d);
  }
  int64_t flat_dims[1] = {static_cast<int64_t>(len)};
  PyObject *re_a = array_from_buffer(re, len, flat_dims, 1);
  PyObject *im_a = array_from_buffer(im, len, flat_dims, 1);
  PyObject *dim_list = PyList_New(static_cast<Py_ssize_t>(rank));
  for (size_t k = 0; k < rank; ++k)
    PyList_SetItem(dim_list, static_cast<Py_ssize_t>(k),
                   PyLong_FromLongLong(dims[k]));
  PyObject *obj = nullptr;
  if (re_a && im_a) {
    obj = call_h("tensor_new_c64", "(OOOO)", inds, re_a, im_a, dim_list);
  }
  Py_XDECREF(re_a);
  Py_XDECREF(im_a);
  Py_DECREF(inds);
  Py_DECREF(dim_list);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_tensor{obj};
  return T4A_OK;
}

t4a_status_code t4a_tensor_copy_payload_c64(const t4a_tensor *t,
                                            double *interleaved,
                                            size_t len) {
  /* len = element count; out buffer holds 2*len doubles (re, im) */
  if (!t || !interleaved) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *arr = call_h("tensor_payload_c64", "(O)", t->obj);
  if (!arr) {
    return set_error_from_python();
  }
  PyObject *bytes = PyObject_CallMethod(arr, "tobytes", nullptr);
  Py_DECREF(arr);
  if (!bytes) {
    return set_error_from_python();
  }
  char *buf = nullptr;
  Py_ssize_t n = 0;
  PyBytes_AsStringAndSize(bytes, &buf, &n);
  if (static_cast<size_t>(n) != 2 * len * sizeof(double)) {
    Py_DECREF(bytes);
    set_error("payload length mismatch");
    return T4A_INVALID_ARGUMENT;
  }
  std::memcpy(interleaved, buf, static_cast<size_t>(n));
  Py_DECREF(bytes);
  return T4A_OK;
}

t4a_status_code t4a_tensor_contract_many_retain(
    const t4a_tensor *const *tensors, size_t n,
    const t4a_index *const *retain, size_t n_retain, t4a_tensor **out) {
  if (!tensors || !n || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *ts = PyList_New(static_cast<Py_ssize_t>(n));
  for (size_t k = 0; k < n; ++k) {
    Py_INCREF(tensors[k]->obj);
    PyList_SetItem(ts, static_cast<Py_ssize_t>(k), tensors[k]->obj);
  }
  PyObject *ret = index_list(retain, n_retain);
  PyObject *obj = call_h("contract_many_retain", "(OO)", ts, ret);
  Py_DECREF(ts);
  Py_DECREF(ret);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_tensor{obj};
  return T4A_OK;
}

void t4a_tensor_release(t4a_tensor *t) { t4a_tensor_free(t); }
void t4a_tt_release(t4a_tt *tt) { t4a_tt_free(tt); }

t4a_status_code t4a_tt_clone(const t4a_tt *tt, t4a_tt **out) {
  if (!tt || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  Py_INCREF(tt->obj);
  *out = new t4a_tt{tt->obj};
  return T4A_OK;
}


/* ------------------------------ TreeTN ----------------------------- */

t4a_status_code t4a_treetn_new(t4a_treetn **out) {
  if (!out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *obj = call_h("treetn_new", "()");
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_treetn{obj};
  return T4A_OK;
}

void t4a_treetn_release(t4a_treetn *tn) {
  if (!tn) return;
  GilGuard gil;
  Py_XDECREF(tn->obj);
  delete tn;
}

int t4a_treetn_is_assigned(const t4a_treetn *tn) {
  return tn && tn->obj ? 1 : 0;
}

t4a_status_code t4a_treetn_clone(const t4a_treetn *tn, t4a_treetn **out) {
  if (!tn || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *obj = PyObject_CallMethod(tn->obj, "clone", nullptr);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_treetn{obj};
  return T4A_OK;
}

t4a_status_code t4a_treetn_set_tensor(t4a_treetn *tn, const char *vertex,
                                      const t4a_tensor *t) {
  if (!tn || !vertex || !t) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *r = call_h("treetn_set_tensor", "(OsO)", tn->obj, vertex,
                       t->obj);
  if (!r) {
    return set_error_from_python();
  }
  Py_DECREF(r);
  return T4A_OK;
}

t4a_status_code t4a_treetn_tensor(const t4a_treetn *tn,
                                  const char *vertex, t4a_tensor **out) {
  if (!tn || !vertex || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *obj = call_h("treetn_tensor", "(Os)", tn->obj, vertex);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_tensor{obj};
  return T4A_OK;
}

t4a_status_code t4a_treetn_num_vertices(const t4a_treetn *tn,
                                        size_t *out) {
  if (!tn || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *v = call_h("treetn_num_vertices", "(O)", tn->obj);
  if (!v) {
    return set_error_from_python();
  }
  *out = static_cast<size_t>(PyLong_AsLongLong(v));
  Py_DECREF(v);
  return T4A_OK;
}

static t4a_status_code treetn_string_query(const t4a_treetn *tn,
                                           const char *helper,
                                           const char *arg, char *buf,
                                           size_t cap) {
  if (!tn || !buf) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *s = arg ? call_h(helper, "(Os)", tn->obj, arg)
                    : call_h(helper, "(O)", tn->obj);
  if (!s) {
    return set_error_from_python();
  }
  t4a_status_code st = copy_string_out(s, buf, cap);
  Py_DECREF(s);
  return st;
}

/* newline-separated vertex names */
t4a_status_code t4a_treetn_node_names(const t4a_treetn *tn, char *buf,
                                      size_t cap) {
  return treetn_string_query(tn, "treetn_node_names", nullptr, buf, cap);
}

t4a_status_code t4a_treetn_neighbors(const t4a_treetn *tn,
                                     const char *vertex, char *buf,
                                     size_t cap) {
  return treetn_string_query(tn, "treetn_neighbors", vertex, buf, cap);
}

t4a_status_code t4a_treetn_canonical_region(const t4a_treetn *tn,
                                            char *buf, size_t cap) {
  return treetn_string_query(tn, "treetn_canonical_region", nullptr, buf,
                             cap);
}

t4a_status_code t4a_treetn_siteinds(const t4a_treetn *tn,
                                    const char *vertex, t4a_index **out,
                                    size_t cap, size_t *n_out) {
  if (!tn || !vertex || !out || !n_out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *lst = call_h("treetn_siteinds", "(Os)", tn->obj, vertex);
  if (!lst) {
    return set_error_from_python();
  }
  Py_ssize_t n = PySequence_Size(lst);
  if (static_cast<size_t>(n) > cap) {
    Py_DECREF(lst);
    set_error("siteinds buffer too small");
    return T4A_INVALID_ARGUMENT;
  }
  for (Py_ssize_t k = 0; k < n; ++k) {
    PyObject *it = PySequence_GetItem(lst, k);
    out[k] = new t4a_index{it};
  }
  *n_out = static_cast<size_t>(n);
  Py_DECREF(lst);
  return T4A_OK;
}

t4a_status_code t4a_treetn_linkind(const t4a_treetn *tn, const char *a,
                                   const char *b, t4a_index **out) {
  if (!tn || !a || !b || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *obj = call_h("treetn_linkind", "(Oss)", tn->obj, a, b);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_index{obj};
  return T4A_OK;
}

t4a_status_code t4a_treetn_orthogonalize(t4a_treetn *tn,
                                         const char *center) {
  if (!tn || !center) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *r = call_h("treetn_orthogonalize", "(Os)", tn->obj, center);
  if (!r) {
    return set_error_from_python();
  }
  Py_DECREF(r);
  return T4A_OK;
}

t4a_status_code t4a_treetn_truncate(t4a_treetn *tn, double rtol,
                                    int64_t maxdim) {
  if (!tn) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *r = call_h("treetn_truncate", "(OdL)", tn->obj, rtol,
                       (long long)maxdim);
  if (!r) {
    return set_error_from_python();
  }
  Py_DECREF(r);
  return T4A_OK;
}

t4a_status_code t4a_treetn_contract(const t4a_treetn *tn,
                                    t4a_tensor **out) {
  if (!tn || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *obj = call_h("treetn_contract", "(O)", tn->obj);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_tensor{obj};
  return T4A_OK;
}

t4a_status_code t4a_treetn_inner(const t4a_treetn *a,
                                 const t4a_treetn *b, double *re,
                                 double *im) {
  if (!a || !b || !re || !im) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *v = call_h("treetn_inner", "(OO)", a->obj, b->obj);
  if (!v) {
    return set_error_from_python();
  }
  Py_complex c = PyComplex_AsCComplex(v);
  Py_DECREF(v);
  if (PyErr_Occurred()) {
    return set_error_from_python();
  }
  *re = c.real;
  *im = c.imag;
  return T4A_OK;
}

t4a_status_code t4a_treetn_norm(const t4a_treetn *tn, double *out) {
  if (!tn || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *v = call_h("treetn_norm", "(O)", tn->obj);
  if (!v) {
    return set_error_from_python();
  }
  *out = PyFloat_AsDouble(v);
  Py_DECREF(v);
  return T4A_OK;
}

t4a_status_code t4a_treetn_scale(t4a_treetn *tn, double re, double im) {
  if (!tn) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *r = call_h("treetn_scale", "(Odd)", tn->obj, re, im);
  if (!r) {
    return set_error_from_python();
  }
  Py_DECREF(r);
  return T4A_OK;
}

t4a_status_code t4a_tensor_svd_with_policy(
    const t4a_tensor *t, size_t n_left,
    const t4a_svd_truncation_policy *policy, size_t maxdim,
    t4a_tensor **u, t4a_tensor **s, t4a_tensor **vh) {
  if (!t || !policy || !u || !s || !vh) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *res = call_h(
      "svd_with_policy", "(OndiiiL)", t->obj, (Py_ssize_t)n_left,
      policy->threshold, (int)policy->scale, (int)policy->measure,
      (int)policy->rule, (long long)maxdim);
  if (!res) {
    return set_error_from_python();
  }
  PyObject *pu = PyTuple_GetItem(res, 0);
  PyObject *ps = PyTuple_GetItem(res, 1);
  PyObject *pv = PyTuple_GetItem(res, 2);
  Py_INCREF(pu);
  Py_INCREF(ps);
  Py_INCREF(pv);
  Py_DECREF(res);
  *u = new t4a_tensor{pu};
  *s = new t4a_tensor{ps};
  *vh = new t4a_tensor{pv};
  return T4A_OK;
}

t4a_status_code t4a_treetn_orthogonalize_form(t4a_treetn *tn,
                                              const char *center,
                                              t4a_canonical_form form,
                                              int force) {
  if (!tn || !center) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *r = call_h("treetn_orthogonalize_form", "(Osii)", tn->obj,
                       center, (int)form, force);
  if (!r) {
    return set_error_from_python();
  }
  Py_DECREF(r);
  return T4A_OK;
}

t4a_status_code t4a_treetn_truncate_with_policy(
    t4a_treetn *tn, const t4a_svd_truncation_policy *policy,
    size_t maxdim) {
  if (!tn || !policy) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *r = call_h("treetn_truncate_with_policy", "(OdiiiL)", tn->obj,
                       policy->threshold, (int)policy->scale,
                       (int)policy->measure, (int)policy->rule,
                       (long long)maxdim);
  if (!r) {
    return set_error_from_python();
  }
  Py_DECREF(r);
  return T4A_OK;
}

t4a_status_code t4a_treetn_sim_linkinds(const t4a_treetn *tn,
                                        t4a_treetn **out) {
  if (!tn || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *obj = call_h("treetn_sim_linkinds", "(O)", tn->obj);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_treetn{obj};
  return T4A_OK;
}

t4a_status_code t4a_treetn_contract_networks(
    const t4a_treetn *a, const t4a_treetn *b, t4a_contract_method method,
    const t4a_svd_truncation_policy *policy, size_t maxdim,
    t4a_treetn **out) {
  if (!a || !b || !policy || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *obj = call_h("treetn_contract_networks", "(OOidiiiL)", a->obj,
                         b->obj, (int)method, policy->threshold,
                         (int)policy->scale, (int)policy->measure,
                         (int)policy->rule, (long long)maxdim);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_treetn{obj};
  return T4A_OK;
}

t4a_status_code t4a_treetn_add(const t4a_treetn *a, const t4a_treetn *b,
                               t4a_treetn **out) {
  if (!a || !b || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *obj = call_h("treetn_add", "(OO)", a->obj, b->obj);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_treetn{obj};
  return T4A_OK;
}

t4a_status_code t4a_treetn_evaluate(const t4a_treetn *tn,
                                    const t4a_index *const *indices,
                                    const int64_t *values, size_t n,
                                    double *re, double *im) {
  if (!tn || !indices || !values || !re || !im)
    return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *inds = index_list(indices, n);
  PyObject *vals = PyList_New(static_cast<Py_ssize_t>(n));
  for (size_t k = 0; k < n; ++k)
    PyList_SetItem(vals, static_cast<Py_ssize_t>(k),
                   PyLong_FromLongLong(values[k]));
  PyObject *v = call_h("treetn_evaluate", "(OOO)", tn->obj, inds, vals);
  Py_DECREF(inds);
  Py_DECREF(vals);
  if (!v) {
    return set_error_from_python();
  }
  Py_complex c = PyComplex_AsCComplex(v);
  Py_DECREF(v);
  *re = c.real;
  *im = c.imag;
  return T4A_OK;
}

static t4a_status_code treetn_from_helper_1(const char *helper,
                                            PyObject *args,
                                            t4a_treetn **out) {
  PyObject *helpers = helpers_module();
  if (!helpers) {
    return set_error_from_python();
  }
  PyObject *fn = PyObject_GetAttrString(helpers, helper);
  if (!fn) {
    return set_error_from_python();
  }
  PyObject *obj = PyObject_CallObject(fn, args);
  Py_DECREF(fn);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_treetn{obj};
  return T4A_OK;
}

/* vertex names as a newline-separated list */
t4a_status_code t4a_treetn_fuse_to(const t4a_treetn *tn,
                                   const char *vertices_nl,
                                   t4a_treetn **out) {
  if (!tn || !vertices_nl || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *names = PyUnicode_FromString(vertices_nl);
  PyObject *lst = PyObject_CallMethod(names, "split", "s", "\n");
  Py_DECREF(names);
  PyObject *args = Py_BuildValue("(OO)", tn->obj, lst);
  Py_DECREF(lst);
  t4a_status_code st = treetn_from_helper_1("treetn_fuse_to", args, out);
  Py_DECREF(args);
  return st;
}

t4a_status_code t4a_treetn_split_to(const t4a_treetn *tn,
                                    const char *vertex,
                                    const t4a_index *const *left_inds,
                                    size_t n_left, const char *left_name,
                                    const char *right_name, double rtol,
                                    int64_t maxdim, t4a_treetn **out) {
  if (!tn || !vertex || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *lst = index_list(left_inds, n_left);
  PyObject *args = Py_BuildValue("(OsOssdL)", tn->obj, vertex, lst,
                                 left_name, right_name, rtol,
                                 (long long)maxdim);
  Py_DECREF(lst);
  t4a_status_code st = treetn_from_helper_1("treetn_split_to", args, out);
  Py_DECREF(args);
  return st;
}

t4a_status_code t4a_treetn_swap_site_indices(const t4a_treetn *tn,
                                             const char *a, const char *b,
                                             double rtol, int64_t maxdim,
                                             t4a_treetn **out) {
  if (!tn || !a || !b || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *args = Py_BuildValue("(OssdL)", tn->obj, a, b, rtol,
                                 (long long)maxdim);
  t4a_status_code st =
      treetn_from_helper_1("treetn_swap_site_indices", args, out);
  Py_DECREF(args);
  return st;
}

t4a_status_code t4a_treetn_apply_operator_chain(
    const t4a_treetn *tn, const t4a_tt *mpo, const char *order_nl,
    double rtol, int64_t maxdim, t4a_treetn **out) {
  if (!tn || !mpo || !order_nl || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *names = PyUnicode_FromString(order_nl);
  PyObject *lst = PyObject_CallMethod(names, "split", "s", "\n");
  Py_DECREF(names);
  PyObject *args = Py_BuildValue("(OOOdL)", tn->obj, mpo->obj, lst, rtol,
                                 (long long)maxdim);
  Py_DECREF(lst);
  t4a_status_code st =
      treetn_from_helper_1("treetn_apply_operator_chain", args, out);
  Py_DECREF(args);
  return st;
}

t4a_status_code t4a_treetn_linsolve(const t4a_treetn *b, const t4a_tt *mpo,
                                    const char *order_nl, double a0_re,
                                    double a0_im, double a1_re,
                                    double a1_im, double rtol,
                                    int64_t maxdim, int64_t nsweeps,
                                    t4a_treetn **out) {
  if (!b || !mpo || !order_nl || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *names = PyUnicode_FromString(order_nl);
  PyObject *lst = PyObject_CallMethod(names, "split", "s", "\n");
  Py_DECREF(names);
  PyObject *args = Py_BuildValue("(OOOdddddLL)", b->obj, mpo->obj, lst,
                                 a0_re, a0_im, a1_re, a1_im, rtol,
                                 (long long)maxdim, (long long)nsweeps);
  Py_DECREF(lst);
  if (!args) {
    return set_error_from_python();
  }
  t4a_status_code st = treetn_from_helper_1("treetn_linsolve", args, out);
  Py_DECREF(args);
  return st;
}

t4a_status_code t4a_treetn_to_dense(const t4a_treetn *tn,
                                    const t4a_index *const *order,
                                    size_t n, double *data, size_t len) {
  if (!tn || !order || !data) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *inds = index_list(order, n);
  PyObject *arr = call_h("treetn_to_dense", "(OO)", tn->obj, inds);
  Py_DECREF(inds);
  if (!arr) {
    return set_error_from_python();
  }
  PyObject *flat = PyObject_CallMethod(arr, "flatten", "s", "F");
  Py_DECREF(arr);
  PyObject *bytes =
      flat ? PyObject_CallMethod(flat, "tobytes", nullptr) : nullptr;
  Py_XDECREF(flat);
  if (!bytes) {
    return set_error_from_python();
  }
  char *buf = nullptr;
  Py_ssize_t nb = 0;
  PyBytes_AsStringAndSize(bytes, &buf, &nb);
  if (static_cast<size_t>(nb) != len * sizeof(double)) {
    Py_DECREF(bytes);
    set_error("dense buffer length mismatch");
    return T4A_INVALID_ARGUMENT;
  }
  std::memcpy(data, buf, static_cast<size_t>(nb));
  Py_DECREF(bytes);
  return T4A_OK;
}

/* ------------------------- TreeTN evaluator ------------------------ */

t4a_status_code t4a_treetn_evaluator_new(const t4a_treetn *tn,
                                         const t4a_index *const *order,
                                         size_t n,
                                         t4a_treetn_evaluator **out) {
  if (!tn || !order || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *inds = index_list(order, n);
  PyObject *obj = call_h("treetn_evaluator_new", "(OO)", tn->obj, inds);
  Py_DECREF(inds);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_treetn_evaluator{obj};
  return T4A_OK;
}

int t4a_treetn_evaluator_is_assigned(const t4a_treetn_evaluator *ev) {
  return ev && ev->obj ? 1 : 0;
}

t4a_status_code t4a_treetn_evaluator_clone(const t4a_treetn_evaluator *ev,
                                           t4a_treetn_evaluator **out) {
  if (!ev || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  Py_INCREF(ev->obj);
  *out = new t4a_treetn_evaluator{ev->obj};
  return T4A_OK;
}

t4a_status_code t4a_treetn_evaluator_evaluate(
    const t4a_treetn_evaluator *ev, const int64_t *idx, size_t batch,
    size_t n_sites, double *out) {
  if (!ev || !idx || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  int64_t dims[2] = {static_cast<int64_t>(n_sites),
                     static_cast<int64_t>(batch)};
  /* build (batch, n_sites) row-major = (n_sites, batch) col-major^T */
  PyObject *np = np_module();
  PyObject *mv = PyMemoryView_FromMemory(
      reinterpret_cast<char *>(const_cast<int64_t *>(idx)),
      static_cast<Py_ssize_t>(batch * n_sites * sizeof(int64_t)),
      PyBUF_READ);
  PyObject *flat = PyObject_CallMethod(np, "frombuffer", "Os", mv,
                                       "int64");
  Py_DECREF(mv);
  if (!flat) {
    return set_error_from_python();
  }
  PyObject *shape = Py_BuildValue("(nn)", (Py_ssize_t)batch,
                                  (Py_ssize_t)n_sites);
  PyObject *mat = PyObject_CallMethod(np, "reshape", "OO", flat, shape);
  Py_DECREF(flat);
  Py_DECREF(shape);
  (void)dims;
  if (!mat) {
    return set_error_from_python();
  }
  PyObject *res = call_h("treetn_evaluator_evaluate", "(OO)", ev->obj,
                         mat);
  Py_DECREF(mat);
  if (!res) {
    return set_error_from_python();
  }
  PyObject *bytes = PyObject_CallMethod(res, "tobytes", nullptr);
  Py_DECREF(res);
  char *buf = nullptr;
  Py_ssize_t nb = 0;
  PyBytes_AsStringAndSize(bytes, &buf, &nb);
  if (static_cast<size_t>(nb) != batch * sizeof(double)) {
    Py_DECREF(bytes);
    set_error("evaluator output length mismatch");
    return T4A_INTERNAL_ERROR;
  }
  std::memcpy(out, buf, static_cast<size_t>(nb));
  Py_DECREF(bytes);
  return T4A_OK;
}

void t4a_treetn_evaluator_release(t4a_treetn_evaluator *ev) {
  if (!ev) return;
  GilGuard gil;
  Py_XDECREF(ev->obj);
  delete ev;
}

/* --------------------------- QTT layouts --------------------------- */

t4a_status_code t4a_qtt_layout_new(int64_t r, int64_t d,
                                   const char *unfolding,
                                   t4a_qtt_layout **out) {
  if (!out || !unfolding) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *obj = call_h("qtt_layout_new", "(LLs)", (long long)r,
                         (long long)d, unfolding);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_qtt_layout{obj};
  return T4A_OK;
}

t4a_status_code t4a_qtt_layout_clone(const t4a_qtt_layout *l,
                                     t4a_qtt_layout **out) {
  if (!l || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  Py_INCREF(l->obj);
  *out = new t4a_qtt_layout{l->obj};
  return T4A_OK;
}

int t4a_qtt_layout_is_assigned(const t4a_qtt_layout *l) {
  return l && l->obj ? 1 : 0;
}

void t4a_qtt_layout_release(t4a_qtt_layout *l) {
  if (!l) return;
  GilGuard gil;
  Py_XDECREF(l->obj);
  delete l;
}

/* -------------------- transform materializers ---------------------- */
/* Each returns the operator as a fused-site TT (core k has site dim
 * out*in = 4), matching the reference's materialize-to-caller design. */

static t4a_status_code qtransform_out(PyObject *obj, t4a_tt **out) {
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_tt{obj};
  return T4A_OK;
}

t4a_status_code t4a_qtransform_flip_materialize(int64_t r, t4a_tt **out) {
  if (!out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  return qtransform_out(call_h("qtransform_flip", "(L)", (long long)r),
                        out);
}

t4a_status_code t4a_qtransform_shift_materialize(int64_t r, int64_t shift,
                                                 const char *bc,
                                                 t4a_tt **out) {
  if (!out || !bc) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  return qtransform_out(
      call_h("qtransform_shift", "(LLs)", (long long)r, (long long)shift,
             bc),
      out);
}

t4a_status_code t4a_qtransform_phase_rotation_materialize(int64_t r,
                                                          double theta,
                                                          t4a_tt **out) {
  if (!out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  return qtransform_out(
      call_h("qtransform_phase_rotation", "(Ld)", (long long)r, theta),
      out);
}

t4a_status_code t4a_qtransform_cumsum_materialize(int64_t r,
                                                  t4a_tt **out) {
  if (!out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  return qtransform_out(call_h("qtransform_cumsum", "(L)", (long long)r),
                        out);
}

t4a_status_code t4a_qtransform_fourier_materialize(int64_t r, int sign,
                                                   double rtol,
                                                   int64_t maxdim,
                                                   t4a_tt **out) {
  if (!out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  return qtransform_out(
      call_h("qtransform_fourier", "(LidL)", (long long)r, sign, rtol,
             (long long)maxdim),
      out);
}

t4a_status_code t4a_qtransform_affine_materialize(
    int64_t r, int64_t a_num, int64_t a_den, int64_t b_num, int64_t b_den,
    const char *bc, t4a_tt **out) {
  if (!out || !bc) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  return qtransform_out(
      call_h("qtransform_affine", "(LLLLLs)", (long long)r,
             (long long)a_num, (long long)a_den, (long long)b_num,
             (long long)b_den, bc),
      out);
}


/* ------------------------------------------------------------------ */
/* Storage-parity surface (ref capi tensor.rs:491-960): dense design — */
/* diag/structured constructors materialize dense; axis_classes report */
/* all-dense. Aliases keep name-for-name parity with the reference.    */
/* ------------------------------------------------------------------ */
t4a_status_code t4a_tensor_new_dense_f64(const t4a_index *const *indices,
                                         size_t rank, const double *data,
                                         size_t len, t4a_tensor **out) {
  return t4a_tensor_new(indices, rank, data, len, out);
}

t4a_status_code t4a_tensor_copy_dense_f64(const t4a_tensor *t,
                                          double *data, size_t len) {
  return t4a_tensor_data(t, data, len);
}

t4a_status_code t4a_tensor_copy_dense_c64(const t4a_tensor *t,
                                          double *interleaved,
                                          size_t len) {
  return t4a_tensor_copy_payload_c64(t, interleaved, len);
}

t4a_status_code t4a_tensor_axis_classes(const t4a_tensor *t, size_t *buf,
                                        size_t buf_len, size_t *out_len) {
  if (!t || !out_len) return T4A_INVALID_ARGUMENT;
  size_t r = 0;
  t4a_status_code st = t4a_tensor_rank(t, &r);
  if (st != T4A_OK) return st;
  *out_len = r;
  if (!buf) return T4A_OK;
  if (buf_len < r) return T4A_INVALID_ARGUMENT;
  for (size_t k = 0; k < r; ++k) buf[k] = 0; /* dense-only storage */
  return T4A_OK;
}

t4a_status_code t4a_tensor_contract_retain(const t4a_tensor *a,
                                           const t4a_tensor *b,
                                           const t4a_index *const *retain,
                                           size_t n_retain,
                                           t4a_tensor **out) {
  if (!a || !b || !out) return T4A_INVALID_ARGUMENT;
  const t4a_tensor *ts[2] = {a, b};
  return t4a_tensor_contract_many_retain(ts, 2, retain, n_retain, out);
}

static PyObject *double_list(const double *data, size_t len) {
  PyObject *lst = PyList_New(static_cast<Py_ssize_t>(len));
  for (size_t k = 0; k < len; ++k)
    PyList_SetItem(lst, static_cast<Py_ssize_t>(k),
                   PyFloat_FromDouble(data[k]));
  return lst;
}

t4a_status_code t4a_tensor_new_diag_f64(size_t rank,
                                        const t4a_index *const *indices,
                                        const double *diag,
                                        size_t diag_len,
                                        t4a_tensor **out) {
  if (!out || (rank && !indices) || (diag_len && !diag))
    return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *inds = index_list(indices, rank);
  PyObject *vals = double_list(diag, diag_len);
  PyObject *obj = call_h("tensor_diag_general", "(OO)", inds, vals);
  Py_DECREF(inds);
  Py_DECREF(vals);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_tensor{obj};
  return T4A_OK;
}

t4a_status_code t4a_tensor_new_diag_c64(size_t rank,
                                        const t4a_index *const *indices,
                                        const double *diag_re,
                                        const double *diag_im,
                                        size_t diag_len,
                                        t4a_tensor **out) {
  if (!out || (rank && !indices) || (diag_len && (!diag_re || !diag_im)))
    return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *inds = index_list(indices, rank);
  PyObject *vals = PyList_New(static_cast<Py_ssize_t>(diag_len));
  for (size_t k = 0; k < diag_len; ++k)
    PyList_SetItem(vals, static_cast<Py_ssize_t>(k),
                   PyComplex_FromDoubles(diag_re[k], diag_im[k]));
  PyObject *obj = call_h("tensor_diag_general", "(OO)", inds, vals);
  Py_DECREF(inds);
  Py_DECREF(vals);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_tensor{obj};
  return T4A_OK;
}

static t4a_status_code structured_common(
    size_t rank, const t4a_index *const *indices, PyObject *payload,
    const size_t *payload_dims, size_t payload_rank,
    const size_t *axis_classes, size_t axis_classes_len,
    t4a_tensor **out) {
  PyObject *inds = index_list(indices, rank);
  PyObject *cls = PyList_New(static_cast<Py_ssize_t>(axis_classes_len));
  for (size_t k = 0; k < axis_classes_len; ++k)
    PyList_SetItem(cls, static_cast<Py_ssize_t>(k),
                   PyLong_FromSize_t(axis_classes[k]));
  PyObject *pdims = PyList_New(static_cast<Py_ssize_t>(payload_rank));
  for (size_t k = 0; k < payload_rank; ++k)
    PyList_SetItem(pdims, static_cast<Py_ssize_t>(k),
                   PyLong_FromSize_t(payload_dims[k]));
  PyObject *obj = call_h("tensor_structured", "(OOOO)", inds, cls,
                         payload, pdims);
  Py_DECREF(inds);
  Py_DECREF(cls);
  Py_DECREF(pdims);
  if (!obj) {
    return set_error_from_python();
  }
  *out = new t4a_tensor{obj};
  return T4A_OK;
}

t4a_status_code t4a_tensor_new_structured_f64(
    size_t rank, const t4a_index *const *indices, const double *data,
    size_t data_len, const size_t *payload_dims, size_t payload_rank,
    const size_t *axis_classes, size_t axis_classes_len,
    t4a_tensor **out) {
  if (!out || (rank && !indices) || (data_len && !data))
    return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *payload = double_list(data, data_len);
  t4a_status_code st = structured_common(
      rank, indices, payload, payload_dims, payload_rank, axis_classes,
      axis_classes_len, out);
  Py_DECREF(payload);
  return st;
}

t4a_status_code t4a_tensor_new_structured_c64(
    size_t rank, const t4a_index *const *indices, const double *re,
    const double *im, size_t data_len, const size_t *payload_dims,
    size_t payload_rank, const size_t *axis_classes,
    size_t axis_classes_len, t4a_tensor **out) {
  if (!out || (rank && !indices) || (data_len && (!re || !im)))
    return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *payload = PyList_New(static_cast<Py_ssize_t>(data_len));
  for (size_t k = 0; k < data_len; ++k)
    PyList_SetItem(payload, static_cast<Py_ssize_t>(k),
                   PyComplex_FromDoubles(re[k], im[k]));
  t4a_status_code st = structured_common(
      rank, indices, payload, payload_dims, payload_rank, axis_classes,
      axis_classes_len, out);
  Py_DECREF(payload);
  return st;
}

t4a_status_code t4a_treetn_partial_contract(
    const t4a_treetn *a, const t4a_treetn *b, size_t n_contract_pairs,
    const t4a_index *const *contract_left,
    const t4a_index *const *contract_right, size_t n_diagonal_pairs,
    const t4a_index *const *diagonal_left,
    const t4a_index *const *diagonal_right, t4a_treetn **out) {
  if (!a || !b || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *cl = index_list(contract_left, n_contract_pairs);
  PyObject *cr = index_list(contract_right, n_contract_pairs);
  PyObject *dl = index_list(diagonal_left, n_diagonal_pairs);
  PyObject *dr = index_list(diagonal_right, n_diagonal_pairs);
  PyObject *args = Py_BuildValue("(OOOOOO)", a->obj, b->obj, cl, cr,
                                 dl, dr);
  Py_DECREF(cl);
  Py_DECREF(cr);
  Py_DECREF(dl);
  Py_DECREF(dr);
  t4a_status_code st =
      treetn_from_helper_1("treetn_partial_contract", args, out);
  Py_DECREF(args);
  return st;
}

t4a_status_code t4a_treetn_restructure_to(
    const t4a_treetn *tn, const char *vertices_nl,
    const t4a_index *const *site_inds, const size_t *site_lens,
    size_t n_vertices, const char *edge_sources_nl,
    const char *edge_targets_nl, double rtol, int64_t maxdim,
    t4a_treetn **out) {
  if (!tn || !vertices_nl || !out) return T4A_INVALID_ARGUMENT;
  GilGuard gil;
  PyObject *names = PyUnicode_FromString(vertices_nl);
  PyObject *name_lst = PyObject_CallMethod(names, "split", "s", "\n");
  Py_DECREF(names);
  size_t total = 0;
  for (size_t k = 0; k < n_vertices; ++k) total += site_lens[k];
  PyObject *sites = index_list(site_inds, total);
  PyObject *lens = PyList_New(static_cast<Py_ssize_t>(n_vertices));
  for (size_t k = 0; k < n_vertices; ++k)
    PyList_SetItem(lens, static_cast<Py_ssize_t>(k),
                   PyLong_FromSize_t(site_lens[k]));
  PyObject *ea = PyUnicode_FromString(edge_sources_nl ? edge_sources_nl
                                                      : "");
  PyObject *ea_lst = PyObject_CallMethod(ea, "split", "s", "\n");
  Py_DECREF(ea);
  PyObject *eb = PyUnicode_FromString(edge_targets_nl ? edge_targets_nl
                                                      : "");
  PyObject *eb_lst = PyObject_CallMethod(eb, "split", "s", "\n");
  Py_DECREF(eb);
  PyObject *args = Py_BuildValue("(OOOOOOdL)", tn->obj, name_lst, sites,
                                 lens, ea_lst, eb_lst, rtol,
                                 (long long)maxdim);
  Py_DECREF(name_lst);
  Py_DECREF(sites);
  Py_DECREF(lens);
  Py_DECREF(ea_lst);
  Py_DECREF(eb_lst);
  t4a_status_code st =
      treetn_from_helper_1("treetn_restructure_to", args, out);
  Py_DECREF(args);
  return st;
}

}  // extern "C"
