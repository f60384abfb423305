// In-process C embedding API for rten_tpu_torch: the port's copy of the
// JAX package's embed_api.cpp, with the same C ABI, names and semantics
// (reference: src/wasm_api.rs:15-211, index.js): load a .rten model and run
// it from ANY language with a C FFI, inside the caller's process. The
// implementation embeds CPython (the runtime the framework's graph layer
// lives in) and drives the same Model surface the Python API exposes;
// compute runs through PyTorch on the device chosen at rten_init.
//
// Build: python -m rten_tpu_torch.native.build (produces librten_embed.so
// under rten_tpu_torch/_build/). Every entry point is GIL-safe: callers may
// invoke from any thread.
//
//   rten_init(repo_path)        — start the interpreter, import
//                                 rten_tpu_torch, read RTEN_TORCH_DEVICE
//   m  = rten_model_load_file(path) / rten_model_load(bytes, len)
//   t  = rten_tensor_f32(data, shape, ndim)   (also _i32)
//   n  = rten_model_run(m, inputs, n_in, outputs, max_out)
//   rten_tensor_ndim/shape/data_f32/data_i32, rten_tensor_free
//   rten_model_input_count/_name, _output_count/_name
//   rten_last_error()           — human-readable failure reason
//
// The device: RTEN_TORCH_DEVICE, read once by rten_init, is "cuda" (the
// default) or "cpu"; any other value, or "cuda" on a machine without a
// CUDA card, makes rten_init fail with the reason in rten_last_error().
// Nothing falls back to the CPU. Outputs come back as contiguous host numpy
// arrays (f32 for floating outputs, i32 for integer ones, as the JAX API's
// x64-off outputs): a device tensor is copied out once.

#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <string>

namespace {

// Per-thread: errors and returned-name storage must not race between
// threads (every entry point is callable from any thread).
thread_local std::string g_error;
thread_local std::string g_name_scratch;
PyThreadState *g_main_state = nullptr;
std::string g_device = "cuda";   // RTEN_TORCH_DEVICE, read once by rten_init
PyObject *g_to_host = nullptr;   // a model output -> contiguous host numpy array

// Defined in the embedded interpreter by rten_init.
const char *kHelpers =
    "import numpy as _np\n"
    "import torch as _torch\n"
    "def _rten_to_host(t):\n"
    "    if isinstance(t, _torch.Tensor):\n"
    "        t = t.detach()\n"
    "        if t.dtype in (_torch.bfloat16, _torch.float16, _torch.float64):\n"
    "            t = t.float()\n"
    "        elif t.dtype == _torch.int64:\n"
    "            t = t.to(_torch.int32)\n"
    "        t = t.cpu().numpy()\n"
    "    return _np.ascontiguousarray(t)\n";

struct Gil {
  PyGILState_STATE st;
  Gil() { st = PyGILState_Ensure(); }
  ~Gil() { PyGILState_Release(st); }
};

void set_error_from_python() {
  PyObject *type, *value, *trace;
  PyErr_Fetch(&type, &value, &trace);
  g_error = "unknown python error";
  if (value) {
    PyObject *s = PyObject_Str(value);
    if (s) {
      const char *utf8 = PyUnicode_AsUTF8(s);
      if (utf8) g_error = utf8;
      Py_DECREF(s);
    }
    PyErr_Clear();  // AsUTF8/Str may themselves have set an exception
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
}

struct Tensor {
  PyObject *array = nullptr;  // contiguous numpy array
  Py_buffer view{};
  bool has_view = false;

  ~Tensor() {
    Gil gil;
    if (has_view) PyBuffer_Release(&view);
    Py_XDECREF(array);
  }
  bool acquire_view() {
    if (has_view) return true;
    if (PyObject_GetBuffer(array, &view, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) != 0) {
      set_error_from_python();
      return false;
    }
    has_view = true;
    return true;
  }
};

struct Model {
  PyObject *model = nullptr;  // rten_tpu_torch.runtime.session.Model
  ~Model() {
    Gil gil;
    Py_XDECREF(model);
  }
};

PyObject *np_module() {
  static PyObject *np = PyImport_ImportModule("numpy");
  return np;
}

PyObject *make_array(const void *data, const int *shape, int ndim,
                     const char *dtype, size_t itemsize) {
  long total = 1;
  for (int i = 0; i < ndim; ++i) total *= shape[i];
  PyObject *np = np_module();
  if (!np) return nullptr;
  PyObject *bytes =
      PyBytes_FromStringAndSize(static_cast<const char *>(data), total * itemsize);
  if (!bytes) return nullptr;
  PyObject *flat = PyObject_CallMethod(np, "frombuffer", "Os", bytes, dtype);
  Py_DECREF(bytes);
  if (!flat) return nullptr;
  PyObject *dims = PyTuple_New(ndim);
  for (int i = 0; i < ndim; ++i)
    PyTuple_SET_ITEM(dims, i, PyLong_FromLong(shape[i]));
  PyObject *shaped = PyObject_CallMethod(flat, "reshape", "O", dims);
  Py_DECREF(flat);
  Py_DECREF(dims);
  if (!shaped) return nullptr;
  PyObject *owned = PyObject_CallMethod(shaped, "copy", nullptr);
  Py_DECREF(shaped);
  return owned;
}

// Model.<method>(arg, device=g_device); a new reference or nullptr.
PyObject *call_loader(const char *method, PyObject *arg) {
  PyObject *mod = PyImport_ImportModule("rten_tpu_torch.runtime.session");
  if (!mod) return nullptr;
  PyObject *cls = PyObject_GetAttrString(mod, "Model");
  Py_DECREF(mod);
  if (!cls) return nullptr;
  PyObject *fn = PyObject_GetAttrString(cls, method);
  Py_DECREF(cls);
  if (!fn) return nullptr;
  PyObject *args = PyTuple_Pack(1, arg);
  PyObject *kwargs = Py_BuildValue("{s:s}", "device", g_device.c_str());
  PyObject *model = (args && kwargs) ? PyObject_Call(fn, args, kwargs) : nullptr;
  Py_XDECREF(args);
  Py_XDECREF(kwargs);
  Py_DECREF(fn);
  return model;
}

// Check the device inside the interpreter (dispatch.resolve_device raises
// for "cuda" without a card) and define the output helper; 0 or -1.
int setup_device() {
  PyObject *dispatch = PyImport_ImportModule("rten_tpu_torch.kernels.dispatch");
  if (!dispatch) return -1;
  PyObject *dev = PyObject_CallMethod(dispatch, "resolve_device", "s", g_device.c_str());
  Py_DECREF(dispatch);
  if (!dev) return -1;
  Py_DECREF(dev);
  PyObject *main_mod = PyImport_AddModule("__main__");  // borrowed
  PyObject *globals = PyModule_GetDict(main_mod);       // borrowed
  PyObject *res = PyRun_String(kHelpers, Py_file_input, globals, globals);
  if (!res) return -1;
  Py_DECREF(res);
  g_to_host = PyDict_GetItemString(globals, "_rten_to_host");  // borrowed
  if (!g_to_host) {
    PyErr_SetString(PyExc_RuntimeError, "the output helper is missing");
    return -1;
  }
  Py_INCREF(g_to_host);
  return 0;
}

}  // namespace

extern "C" {

const char *rten_last_error(void) { return g_error.c_str(); }

// Start the embedded interpreter (idempotent). ``python_path`` (optional,
// may be NULL) is prepended to sys.path so rten_tpu_torch resolves — pass
// the repo/site-packages root when embedding outside an installed
// environment. Reads RTEN_TORCH_DEVICE ("cuda" by default, or "cpu").
int rten_init(const char *python_path) {
  if (Py_IsInitialized()) return 0;
  const char *env = std::getenv("RTEN_TORCH_DEVICE");
  g_device = (env && *env) ? env : "cuda";
  if (g_device != "cuda" && g_device != "cpu") {
    g_error = "RTEN_TORCH_DEVICE must be 'cuda' or 'cpu', got '" + g_device + "'";
    return -1;
  }
  Py_InitializeEx(0);
  if (python_path && *python_path) {
    PyObject *sys_path = PySys_GetObject("path");  // borrowed
    PyObject *p = PyUnicode_FromString(python_path);
    PyList_Insert(sys_path, 0, p);
    Py_DECREF(p);
  }
  PyObject *mod = PyImport_ImportModule("rten_tpu_torch.runtime.session");
  int rc = 0;
  if (!mod || setup_device() != 0) {
    set_error_from_python();
    rc = -1;
  }
  Py_XDECREF(mod);
  // Release the GIL so any thread (including this one, via Gil) can call
  // in; after a failure the interpreter stays up and the caller can retry
  // in a fresh process.
  g_main_state = PyEval_SaveThread();
  return rc;
}

void rten_shutdown(void) {
  if (!Py_IsInitialized()) return;
  if (g_main_state) PyEval_RestoreThread(g_main_state);
  Py_CLEAR(g_to_host);
  Py_FinalizeEx();
  g_main_state = nullptr;
}

void *rten_model_load(const void *data, long len) {
  Gil gil;
  PyObject *bytes = PyBytes_FromStringAndSize(static_cast<const char *>(data), len);
  PyObject *model = bytes ? call_loader("load", bytes) : nullptr;
  Py_XDECREF(bytes);
  if (!model) {
    set_error_from_python();
    return nullptr;
  }
  Model *m = new Model();
  m->model = model;
  return m;
}

void *rten_model_load_file(const char *path) {
  Gil gil;
  PyObject *p = PyUnicode_FromString(path);
  PyObject *model = p ? call_loader("load_file", p) : nullptr;
  Py_XDECREF(p);
  if (!model) {
    set_error_from_python();
    return nullptr;
  }
  Model *m = new Model();
  m->model = model;
  return m;
}

void rten_model_free(void *handle) { delete static_cast<Model *>(handle); }

static int name_count(void *handle, const char *method) {
  Gil gil;
  Model *m = static_cast<Model *>(handle);
  PyObject *names = PyObject_CallMethod(m->model, method, nullptr);
  if (!names) {
    set_error_from_python();
    return -1;
  }
  int n = static_cast<int>(PyList_Size(names));
  Py_DECREF(names);
  return n;
}

static const char *name_at(void *handle, const char *method, int i) {
  Gil gil;
  Model *m = static_cast<Model *>(handle);
  PyObject *names = PyObject_CallMethod(m->model, method, nullptr);
  if (!names) {
    set_error_from_python();
    return nullptr;
  }
  PyObject *item = PyList_GetItem(names, i);  // borrowed
  const char *utf8 = item ? PyUnicode_AsUTF8(item) : nullptr;
  if (!utf8) PyErr_Clear();
  // thread_local storage: the returned pointer stays valid until THIS
  // thread's next name_at call, regardless of other threads.
  g_name_scratch = utf8 ? utf8 : "";
  Py_DECREF(names);
  return g_name_scratch.c_str();
}

int rten_model_input_count(void *h) { return name_count(h, "input_names"); }
int rten_model_output_count(void *h) { return name_count(h, "output_names"); }
const char *rten_model_input_name(void *h, int i) { return name_at(h, "input_names", i); }
const char *rten_model_output_name(void *h, int i) { return name_at(h, "output_names", i); }

void *rten_tensor_f32(const float *data, const int *shape, int ndim) {
  Gil gil;
  PyObject *arr = make_array(data, shape, ndim, "float32", 4);
  if (!arr) {
    set_error_from_python();
    return nullptr;
  }
  Tensor *t = new Tensor();
  t->array = arr;
  return t;
}

void *rten_tensor_i32(const int *data, const int *shape, int ndim) {
  Gil gil;
  PyObject *arr = make_array(data, shape, ndim, "int32", 4);
  if (!arr) {
    set_error_from_python();
    return nullptr;
  }
  Tensor *t = new Tensor();
  t->array = arr;
  return t;
}

int rten_tensor_ndim(void *handle) {
  Gil gil;
  Tensor *t = static_cast<Tensor *>(handle);
  PyObject *shape = PyObject_GetAttrString(t->array, "shape");
  int n = static_cast<int>(PyTuple_Size(shape));
  Py_DECREF(shape);
  return n;
}

void rten_tensor_shape(void *handle, int *out) {
  Gil gil;
  Tensor *t = static_cast<Tensor *>(handle);
  PyObject *shape = PyObject_GetAttrString(t->array, "shape");
  for (int i = 0; i < PyTuple_Size(shape); ++i)
    out[i] = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(shape, i)));
  Py_DECREF(shape);
}

const float *rten_tensor_data_f32(void *handle) {
  Gil gil;
  Tensor *t = static_cast<Tensor *>(handle);
  if (!t->acquire_view()) return nullptr;
  if (!t->view.format || strcmp(t->view.format, "f") != 0) {
    g_error = "tensor is not float32";
    return nullptr;
  }
  return static_cast<const float *>(t->view.buf);
}

const int *rten_tensor_data_i32(void *handle) {
  Gil gil;
  Tensor *t = static_cast<Tensor *>(handle);
  if (!t->acquire_view()) return nullptr;
  if (!t->view.format || strcmp(t->view.format, "i") != 0) {
    g_error = "tensor is not int32";
    return nullptr;
  }
  return static_cast<const int *>(t->view.buf);
}

void rten_tensor_free(void *handle) { delete static_cast<Tensor *>(handle); }

// Run the model on ``n_in`` input tensors (positional, matching the graph's
// declared inputs). Fills up to ``max_out`` output tensor handles; returns
// the number of outputs, or -1 (see rten_last_error).
int rten_model_run(void *handle, void *const *inputs, int n_in, void **outputs,
                   int max_out) {
  Gil gil;
  Model *m = static_cast<Model *>(handle);
  PyObject *in_list = PyList_New(n_in);
  for (int i = 0; i < n_in; ++i) {
    Tensor *t = static_cast<Tensor *>(inputs[i]);
    Py_INCREF(t->array);
    PyList_SET_ITEM(in_list, i, t->array);
  }
  PyObject *outs = PyObject_CallMethod(m->model, "run", "O", in_list);
  Py_DECREF(in_list);
  if (!outs) {
    set_error_from_python();
    return -1;
  }
  int n_out = static_cast<int>(PyList_Size(outs));
  int produced = 0;
  for (int i = 0; i < n_out && i < max_out; ++i) {
    PyObject *item = PyList_GetItem(outs, i);  // borrowed (a torch tensor)
    PyObject *arr = PyObject_CallFunctionObjArgs(g_to_host, item, nullptr);
    if (!arr) {
      set_error_from_python();
      Py_DECREF(outs);
      return -1;
    }
    Tensor *t = new Tensor();
    t->array = arr;
    outputs[produced++] = t;
  }
  Py_DECREF(outs);
  return produced;
}

}  // extern "C"
